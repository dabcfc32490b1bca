// Fused IVF probe (gather + d2 score + canonical top-k) for Hopper, f32 on
// CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/ivf_probe.py fused_probe_topk
// (bodies _kernel, _probe_sims): for each query, visit its nprobe posting
// lists (cells chosen by the probe table), dequantize each cell's (cap, n)
// payload block, score every live slot with the dense_similarity algebra on
// raw rows, and keep a (value desc, id asc) top-k — the (b, nprobe·cap, n)
// candidate tensor and its scores never reach device memory.
//
// What bounds it on an H100: at the ML-1M graph build through the index
// (b = 5976 queries, nprobe = 19 of C = 77 cells, cap = 104, n = 20,
// k = 13; 9.49 M live (query, slot) pairs) the whole f32 index is 0.64 MB
// and stays in the 50 MB L2, so bytes do not bound it; the 2n-flop dot and
// 3-op epilogue per pair do: 0.41 GFLOP, ~6 µs at 67 TFLOP/s. The sums
// must stay left to right with a rounding after each multiply and add (no
// FMA, no tensor cores), so each pair costs 2n FP32 instructions and its
// row's n floats read from shared memory; what a kernel spends beyond that
// is restaging a cell once per query that probes it, per-pair norms, list
// insertion, and latency. The design:
// - query groups that share cells: a first kernel orders the queries by
//   their first-probed (nearest) cell (a counting sort in one block), and a
//   block of 8 warps owns G consecutive queries of that order (G = 8, 4, 2
//   or 1, chosen by the wrapper from b so the grid still fills the card).
//   The block marks, per cell, which of its queries probe it (one byte a
//   cell in shared memory; probe_ok == 0 entries never enter), so each cell
//   of their union is staged once per block;
// - per-slot quantities once per staging: the union's live rows are packed
//   back to back, in cell order, and staged 256 at a time, one thread a row
//   (16-byte loads where n % 4 == 0), double buffered: the dequantized row
//   (bf16 widened; int8 times its f32 scale, one rounding), for pearson its
//   mean and centered row, and its squared norm (euclidean) or its root
//   (cosine, pearson). A pair then costs the n-term dot and the epilogue;
// - warp (g, s) scores the 32-row subchunks s, s + S, … (S = 8 / G) of a
//   round, lane = row, where its query g probes the row's cell, the query
//   read from shared memory as broadcasts (80 registers a thread, three
//   blocks an SM); at G = 1 the 8 warps split one query's rows and merge
//   their lists at the end;
// - a warp-wide top-k: lane j holds the warp's j-th entry, the bar is lane
//   k−1's entry under the canonical order, and a ballot picks the rows that
//   beat it: a few go in one shuffle-up each, many (a list's first rows)
//   through a bitonic sort and merge.
// Measured on an H100 80GB HBM3 at 700 W at the shape above
// (tools/time_ivf_probe.py): ~0.15 ms for the probe kernel and ~0.01 ms for
// the order, against 0.56 ms for one warp per query restaging its own
// cells; 25× the bound, with scoring the largest share.
// Every sum runs left to right with the round-to-nearest intrinsics of
// topk_common.cuh, as kernels/ref.py::gathered_sims adds, and the canonical
// order does not depend on the order in which rows are visited (each id
// lies in one list), so values and ids are bitwise the plain version's.
// Slots at or past the cell's fill and the query's own id are never
// offered; empty slots come out as (-inf, 0). Any cap and nprobe (probe
// entries past 1024 a block go in further segments), k <= 32, and
// C <= 32768 for G > 1. The probe table must hold distinct cells per
// query, as the reference requires. Any n: up to kNarrowWidth = 104 (past
// 64 the rows stage 128 a round and the row array spills) as above; past
// it the wide route (probe_wide_kernel) takes one query a block and stages
// its union's rows in slices of kWideSlice landmarks, each row's mean and
// norm taken first over the whole row, each thread's partial dot product
// kept in a register across the slices, ascending in d.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_smem.cuh"
#include "topk_common.cuh"

namespace {

using repro::kFull;
using repro::WarpList;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kEntries = 1024;          // (query, probe) entries per segment
constexpr int kPerThread = kEntries / kThreads;
constexpr int kNarrowWidth = 104;       // probe_group_kernel's widest rows

// Row stride in floats: NP rounded so that 8 lanes reading float4s of 8
// consecutive rows hit 8 distinct 16-byte bank groups (stride = 4 mod 8).
// ROWS rows are staged a round, one a thread: all 256 threads up to
// n = 64; past it half of them, so that two rounds of rows (n <= 104:
// stride 108) stay within the shared memory a block may take.
template <int NV4>
struct Width {
  static constexpr int NP = 4 * NV4;
  static constexpr int STR = NP % 8 == 4 ? NP : NP + 4;
  static constexpr int ROWS = NV4 > 16 ? kThreads / 2 : kThreads;
  static constexpr size_t kSmem =
      sizeof(float) * 2 * ROWS * (STR + 3);  // rows, aux, ids, masks
};

// Four payload elements widened to f32 exactly: f32 as they are, bf16 by
// its bits, int8 by value.
__device__ __forceinline__ float4 widen4(float4 v) { return v; }
__device__ __forceinline__ float4 widen4(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}
__device__ __forceinline__ float4 widen4(int v) {
  return make_float4(static_cast<float>(static_cast<int8_t>(v)),
                     static_cast<float>(static_cast<int8_t>(v >> 8)),
                     static_cast<float>(static_cast<int8_t>(v >> 16)),
                     static_cast<float>(static_cast<int8_t>(v >> 24)));
}
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(int8_t x) {
  return static_cast<float>(x);
}

template <typename T> struct Vec4;  // four elements in one load
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };
template <> struct Vec4<int8_t> { using type = int; };

// One payload row of n elements into x, zero past n. ``vec``: n % 4 == 0
// and the rows 4-element aligned, so the row loads as n / 4 vectors. The
// loads are independent and issue back to back.
template <int NP, typename T>
__device__ __forceinline__ void load_row(float (&x)[NP], const T* row, int n,
                                         bool vec) {
  if (vec) {
    using V = typename Vec4<T>::type;
    const V* r = reinterpret_cast<const V*>(row);
#pragma unroll
    for (int c = 0; c < NP / 4; ++c) {
      const float4 f = 4 * c < n ? widen4(r[c]) : make_float4(0, 0, 0, 0);
      x[4 * c] = f.x;
      x[4 * c + 1] = f.y;
      x[4 * c + 2] = f.z;
      x[4 * c + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < NP; ++d) x[d] = d < n ? widen(row[d]) : 0.0f;
  }
}

// Exclusive scan of one 64-bit value per thread over the block; ``total``
// gets the block's sum. All threads must call it.
__device__ __forceinline__ long long block_scan(long long v, long long* wsum,
                                                long long& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  long long before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += wsum[w];
    total += wsum[w];
  }
  __syncthreads();  // wsum may be written again
  return before + x - v;
}

template <int NV4>
__global__ void __launch_bounds__(kThreads)
probe_group_kernel(const float* __restrict__ q, const int* __restrict__ probe,
                   const int* __restrict__ probe_ok,
                   const int* __restrict__ order,
                   const int* __restrict__ lists, const void* __restrict__ rows,
                   const float* __restrict__ scale,
                   const int* __restrict__ fill,
                   const int* __restrict__ self_ids, float* __restrict__ out_v,
                   int* __restrict__ out_i, int B, int nprobe, int C,
                   int cap, int n, int k, int measure, int payload, int G) {
  constexpr int NP = Width<NV4>::NP, STR = Width<NV4>::STR;
  constexpr int kRows = Width<NV4>::ROWS;  // staged rows per round
  extern __shared__ float4 dyn[];
  float* s_rows = reinterpret_cast<float*>(dyn);  // [2][kRows][STR]
  float* s_aux = s_rows + 2 * kRows * STR;        // [2][kRows]
  int* s_ids = reinterpret_cast<int*>(s_aux + 2 * kRows);
  int* s_mask = s_ids + 2 * kRows;
  unsigned* c_mask = reinterpret_cast<unsigned*>(s_mask + 2 * kRows);
  __shared__ int u_cell[kEntries];  // the union's cells
  __shared__ int u_pre[kEntries + 1];  // first packed row of each cell
  __shared__ unsigned char u_mask[kEntries];  // which queries probe it
  __shared__ long long wsum[kWarps];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int S = kWarps / G;
  const int g = warp % G, s = warp / G;
  const int q0 = blockIdx.x * G;
  const int gcount = min(G, B - q0);
  const bool active = g < gcount;
  const int qi = active ? (order ? order[q0 + g] : q0 + g) : 0;

  // the query: centered for pearson, zero past n (adds +0 to every sum)
  float qr[NP];
#pragma unroll
  for (int d = 0; d < NP; ++d) {
    qr[d] = active && d < n ? q[(size_t)qi * n + d] : 0.0f;
  }
  if (measure == 1) repro::center<NP>(qr, n);
  const float qn = repro::sq_norm<NP>(qr, n);
  const float q_aux = measure == 2 ? qn : __fsqrt_rn(qn);
  // the scoring loop reads the query from shared memory (one broadcast
  // float4 a step), which keeps its registers for the rows
  __shared__ float4 s_q[kWarps][NV4];
  if (lane < NV4) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int c = 0; c < NV4; ++c) {
      if (c == lane) v = make_float4(qr[4 * c], qr[4 * c + 1], qr[4 * c + 2],
                                     qr[4 * c + 3]);
    }
    s_q[warp][lane] = v;
  }
  __syncwarp();
  const int sid = active && self_ids ? self_ids[qi] : -1;
  const size_t elem = payload == 0 ? 4 : payload == 1 ? 2 : 1;
  const bool vec = n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % (4 * elem) == 0;

  WarpList list;
  // cells [c0, c1) are this thread's in the union's scan (G > 1)
  const int per = (C + kThreads - 1) / kThreads;
  const int c0 = min(tid * per, C), c1 = min(c0 + per, C);
  const int c_words = G > 1 ? (C + 3) / 4 : 0;
  auto cell_bits = [&](int c) {
    return (c_mask[c >> 2] >> ((c & 3) * 8)) & 0xffu;
  };
  const int cols = min(nprobe, kEntries / G);  // probe columns a segment
  for (int j0 = 0; j0 < nprobe; j0 += cols) {
    const int jn = min(cols, nprobe - j0);
    // the union: one entry per distinct cell with live rows (in probe
    // order at G = 1, else in cell order, each cell's byte in ``c_mask``
    // naming the queries that probe it), and its rows' offset in the
    // packed order, from one scan of (count, rows) pairs
    long long mine = 0;
    int cell[kPerThread], live[kPerThread];
    if (G == 1) {
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int j = tid * kPerThread + i;
        cell[i] = 0;
        live[i] = 0;
        if (j < jn && active) {
          const size_t at = (size_t)qi * nprobe + j0 + j;
          if (!probe_ok || probe_ok[at]) {
            cell[i] = probe[at];
            live[i] = max(min(fill[cell[i]], cap), 0);
          }
        }
        if (live[i] > 0) mine += (1LL << 32) | live[i];
      }
    } else {
      for (int w = tid; w < c_words; w += kThreads) c_mask[w] = 0;
      __syncthreads();
      for (int e = tid; e < G * jn; e += kThreads) {
        const int gg = e / jn;
        if (gg < gcount) {
          const int qq = order[q0 + gg];
          const size_t at = (size_t)qq * nprobe + j0 + (e - gg * jn);
          if (!probe_ok || probe_ok[at]) {
            const int c = probe[at];
            atomicOr(&c_mask[c >> 2], (1u << gg) << ((c & 3) * 8));
          }
        }
      }
      __syncthreads();
      for (int c = c0; c < c1; ++c) {
        if (cell_bits(c)) {
          const int l = max(min(fill[c], cap), 0);
          if (l > 0) mine += (1LL << 32) | l;
        }
      }
    }
    long long total;
    long long at = block_scan(mine, wsum, total);
    const int n_rows = static_cast<int>(total & 0xffffffffLL);
    auto put = [&](int c, int l, unsigned m) {
      const int u = static_cast<int>(at >> 32);
      u_cell[u] = c;
      u_mask[u] = static_cast<unsigned char>(m);
      u_pre[u] = static_cast<int>(at & 0xffffffffLL);
      at += (1LL << 32) | l;
    };
    if (G == 1) {
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        if (live[i] > 0) put(cell[i], live[i], 1u);
      }
    } else {
      for (int c = c0; c < c1; ++c) {
        const unsigned m = cell_bits(c);
        if (m) {
          const int l = max(min(fill[c], cap), 0);
          if (l > 0) put(c, l, m);
        }
      }
    }
    if (tid == 0) u_pre[total >> 32] = n_rows;
    __syncthreads();

    // stage packed row p = round · kRows + tid: dequantized, centered for
    // pearson, with its norm term; the cursor walks the union forward
    int cur = 0;
    auto stage = [&](int round, int buf) {
      if (tid >= kRows) return;  // wide rows: half the threads stage
      const int p = round * kRows + tid;
      const bool live = p < n_rows;
      long long slot = 0;
      int mask = 0, id = 0;
      if (live) {
        while (u_pre[cur + 1] <= p) ++cur;
        slot = static_cast<long long>(u_cell[cur]) * cap + (p - u_pre[cur]);
        mask = u_mask[cur];
        id = lists[slot];
      }
      const float sc = payload == 2 && live ? scale[slot] : 1.0f;
      float x[NP];
      if (live) {
        if (payload == 0) {
          load_row<NP>(x, static_cast<const float*>(rows) + slot * n, n, vec);
        } else if (payload == 1) {
          load_row<NP>(x, static_cast<const __nv_bfloat16*>(rows) + slot * n,
                       n, vec);
        } else {
          load_row<NP>(x, static_cast<const int8_t*>(rows) + slot * n, n,
                       vec);
#pragma unroll
          for (int d = 0; d < NP; ++d) {
            if (d < n) x[d] = __fmul_rn(x[d], sc);
          }
        }
      }
      s_mask[buf * kRows + tid] = mask;
      if (!live) return;
      if (measure == 1) repro::center<NP>(x, n);
      const float vn = repro::sq_norm<NP>(x, n);
      float4* dst = reinterpret_cast<float4*>(s_rows +
                                              (buf * kRows + tid) * STR);
#pragma unroll
      for (int c = 0; c < NV4; ++c) {
        dst[c] = make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2],
                             x[4 * c + 3]);
      }
      s_aux[buf * kRows + tid] = measure == 2 ? vn : __fsqrt_rn(vn);
      s_ids[buf * kRows + tid] = id;
    };

    // the score of this warp's query against a staged row
    auto score = [&](float z, float aux) {
      if (measure == 2) {
        const float d2 =
            fmaxf(__fadd_rn(__fsub_rn(qn, __fmul_rn(2.0f, z)), aux), 0.0f);
        return __fdiv_rn(1.0f, __fadd_rn(1.0f, __fsqrt_rn(d2)));
      }
      return __fdiv_rn(z, fmaxf(__fmul_rn(q_aux, aux), repro::kEps));
    };

    const int rounds = (n_rows + kRows - 1) / kRows;
    if (rounds > 0) stage(0, 0);
    __syncthreads();
    for (int r = 0; r < rounds; ++r) {
      const int buf = r & 1;
      if (r + 1 < rounds) stage(r + 1, buf ^ 1);
      const int subs = (min(kRows, n_rows - r * kRows) + 31) >> 5;
      for (int j = s; j < subs; j += S) {
        const int row = buf * kRows + j * 32 + lane;
        bool want = active && ((s_mask[row] >> g) & 1);
        if (!__any_sync(kFull, want)) continue;
        const int id = s_ids[row];
        want = want && id != sid;
        const float4* cr = reinterpret_cast<const float4*>(s_rows + row * STR);
        float z = 0.0f;
#pragma unroll
        for (int c = 0; c < NV4; ++c) {
          const float4 x = cr[c], y = s_q[warp][c];
          z = __fadd_rn(z, __fmul_rn(y.x, x.x));
          z = __fadd_rn(z, __fmul_rn(y.y, x.y));
          z = __fadd_rn(z, __fmul_rn(y.z, x.z));
          z = __fadd_rn(z, __fmul_rn(y.w, x.w));
        }
        list.offer(want, score(z, s_aux[row]), id, k);
      }
      __syncthreads();  // the buffer just read is staged next round
    }
    __syncthreads();  // the union is read no more: the next keys replace it
  }

  // the S warps of a query merge their lists into warp (g, 0)'s
  if (S > 1) {
    float* m_v = s_rows;
    int* m_i = reinterpret_cast<int*>(s_rows + kThreads);
    m_v[tid] = list.ev;
    m_i[tid] = list.eid;
    __syncthreads();
    if (s == 0 && active) {
      for (int t = 1; t < S; ++t) {
        const int from = (t * G + g) * 32 + lane;
        list.offer(true, m_v[from], m_i[from], k);
      }
    }
  }
  if (s == 0 && active && lane < k) {
    out_v[(size_t)qi * k + lane] = list.ev;
    out_i[(size_t)qi * k + lane] = list.ev == -INFINITY ? 0 : list.eid;
  }
}

// A payload element widened to f32: int8 times the row's scale (one
// rounding), as the plain version dequantizes.
__device__ __forceinline__ float payload_at(const void* rows, int payload,
                                            size_t at, float sc) {
  if (payload == 0) return __ldg(static_cast<const float*>(rows) + at);
  if (payload == 1) return widen(static_cast<const __nv_bfloat16*>(rows)[at]);
  return __fmul_rn(widen(static_cast<const int8_t*>(rows)[at]), sc);
}

// The wide route (n > kNarrowWidth): one query a block. The union of its
// probed cells (probe order) is packed as probe_group_kernel packs it at
// G = 1, and its live rows go kThreads a round, a thread a row. The block
// stages the round's rows in slices of kWideSlice landmarks (dequantized;
// a warp a row, coalesced), the query's centered slice beside them, and
// each thread adds the slice's terms to its row's dot product and squared
// norm, left to right; for pearson a first pass over the slices takes each
// row's mean. Each warp offers its 32 rows to its list; the 8 lists merge
// at the end.
constexpr int kWideSlice = 32;
constexpr int kWidePitch = kWideSlice + 1;  // odd: no bank conflicts
constexpr size_t kWideSmem = sizeof(float) * kThreads * kWidePitch;

__global__ void __launch_bounds__(kThreads)
probe_wide_kernel(const float* __restrict__ q, const int* __restrict__ probe,
                  const int* __restrict__ probe_ok,
                  const int* __restrict__ lists, const void* __restrict__ rows,
                  const float* __restrict__ scale,
                  const int* __restrict__ fill,
                  const int* __restrict__ self_ids, float* __restrict__ out_v,
                  int* __restrict__ out_i, int nprobe, int cap, int n, int k,
                  int measure, int payload) {
  extern __shared__ float4 dyn[];
  float* s_rows = reinterpret_cast<float*>(dyn);  // [kThreads][kWidePitch]
  __shared__ int u_cell[kEntries];
  __shared__ int u_pre[kEntries + 1];
  __shared__ long long wsum[kWarps];
  __shared__ float s_q[kWideSlice];
  __shared__ float s_qstat[3];  // the query's mean, |q|², and its root
  __shared__ float s_scale[kThreads];
  __shared__ long long s_slot[kThreads];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qi = blockIdx.x;
  const float* qrow = q + (size_t)qi * n;
  if (tid == 0) {  // the query's statistics, once
    float mean = 0.0f;
    if (measure == 1) {
      float sum = 0.0f;
      for (int d = 0; d < n; ++d) sum = __fadd_rn(sum, __ldg(qrow + d));
      mean = __fdiv_rn(sum, static_cast<float>(n));
    }
    float sq = 0.0f;
    for (int d = 0; d < n; ++d) {
      const float v = measure == 1 ? __fsub_rn(__ldg(qrow + d), mean)
                                   : __ldg(qrow + d);
      sq = __fadd_rn(sq, __fmul_rn(v, v));
    }
    s_qstat[0] = mean;
    s_qstat[1] = sq;
    s_qstat[2] = __fsqrt_rn(sq);
  }
  const int sid = self_ids ? self_ids[qi] : -1;

  WarpList list;
  for (int j0 = 0; j0 < nprobe; j0 += kEntries) {
    const int jn = min(kEntries, nprobe - j0);
    long long mine = 0;
    int cell[kPerThread], live[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int j = tid * kPerThread + i;
      cell[i] = 0;
      live[i] = 0;
      if (j < jn) {
        const size_t at = (size_t)qi * nprobe + j0 + j;
        if (!probe_ok || probe_ok[at]) {
          cell[i] = probe[at];
          live[i] = max(min(fill[cell[i]], cap), 0);
        }
      }
      if (live[i] > 0) mine += (1LL << 32) | live[i];
    }
    long long total;
    long long at = block_scan(mine, wsum, total);
    const int n_rows = static_cast<int>(total & 0xffffffffLL);
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (live[i] > 0) {
        const int u = static_cast<int>(at >> 32);
        u_cell[u] = cell[i];
        u_pre[u] = static_cast<int>(at & 0xffffffffLL);
        at += (1LL << 32) | live[i];
      }
    }
    if (tid == 0) u_pre[total >> 32] = n_rows;
    __syncthreads();

    int cur = 0;  // the cursor walks the union forward
    for (int r0 = 0; r0 < n_rows; r0 += kThreads) {  // uniform
      const int p = r0 + tid;
      const bool mine_live = p < n_rows;
      int id = 0;
      if (mine_live) {  // this thread's row: its slot, id and scale
        while (u_pre[cur + 1] <= p) ++cur;
        const long long slot =
            static_cast<long long>(u_cell[cur]) * cap + (p - u_pre[cur]);
        id = lists[slot];
        s_slot[tid] = slot;
        s_scale[tid] = payload == 2 ? scale[slot] : 1.0f;
      }
      const int count = min(kThreads, n_rows - r0);
      // pearson streams the slices twice: the row's raw sum (its mean),
      // then the centered sums; the others once
      float sum = 0.0f, mean = 0.0f, z = 0.0f, sq = 0.0f;
      for (int pass = measure == 1 ? 0 : 1; pass < 2; ++pass) {
        for (int d0 = 0; d0 < n; d0 += kWideSlice) {
          const int w = min(kWideSlice, n - d0);
          __syncthreads();  // the rows' slots are listed; the last slice read
          for (int e = tid; e < kThreads * kWideSlice; e += kThreads) {
            const int r = e / kWideSlice, d = e % kWideSlice;
            if (r < count && d < w) {
              s_rows[r * kWidePitch + d] = payload_at(
                  rows, payload, (size_t)s_slot[r] * n + d0 + d, s_scale[r]);
            }
          }
          if (tid < w) {
            const float v = __ldg(qrow + d0 + tid);
            s_q[tid] = measure == 1 ? __fsub_rn(v, s_qstat[0]) : v;
          }
          __syncthreads();
          if (!mine_live) continue;
          const float* cr = s_rows + tid * kWidePitch;
          if (pass == 0) {
            for (int d = 0; d < w; ++d) sum = __fadd_rn(sum, cr[d]);
            if (d0 + w == n) mean = __fdiv_rn(sum, static_cast<float>(n));
            continue;
          }
          for (int d = 0; d < w; ++d) {
            const float c = measure == 1 ? __fsub_rn(cr[d], mean) : cr[d];
            z = __fadd_rn(z, __fmul_rn(s_q[d], c));
            sq = __fadd_rn(sq, __fmul_rn(c, c));
          }
        }
      }
      const float aux = measure == 2 ? sq : __fsqrt_rn(sq);
      float v = -INFINITY;
      if (measure == 2) {
        const float d2 = fmaxf(
            __fadd_rn(__fsub_rn(s_qstat[1], __fmul_rn(2.0f, z)), aux), 0.0f);
        v = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fsqrt_rn(d2)));
      } else {
        v = __fdiv_rn(z, fmaxf(__fmul_rn(s_qstat[2], aux), repro::kEps));
      }
      list.offer(mine_live && id != sid, v, id, k);
    }
    __syncthreads();  // the union is read no more: the next segment's
  }

  // the 8 warps' lists merge into warp 0's
  float* m_v = s_rows;
  int* m_i = reinterpret_cast<int*>(s_rows + kThreads);
  m_v[tid] = list.ev;
  m_i[tid] = list.eid;
  __syncthreads();
  if (warp == 0) {
    for (int t = 1; t < kWarps; ++t) {
      list.offer(true, m_v[t * 32 + lane], m_i[t * 32 + lane], k);
    }
    if (lane < k) {
      out_v[(size_t)qi * k + lane] = list.ev;
      out_i[(size_t)qi * k + lane] = list.ev == -INFINITY ? 0 : list.eid;
    }
  }
}

// The queries' order for the groups: a counting sort by first-probed cell
// in one block — a histogram of the C cells, its exclusive scan, then each
// query takes the next place of its cell. The order within a cell is the
// atomics' and may change from call to call; the lists do not.
constexpr int kOrderThreads = 1024;
constexpr int kOrderCells = 32768;  // cells the counters hold (128 KB)

__global__ void __launch_bounds__(kOrderThreads)
order_kernel(const int* __restrict__ probe, int B, int nprobe, int C,
             int* __restrict__ order) {
  extern __shared__ int bins[];
  __shared__ int wsum[kOrderThreads / 32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto cell_of = [&](int i) {
    return min(max(probe[(size_t)i * nprobe], 0), C - 1);
  };
  for (int c = tid; c < C; c += kOrderThreads) bins[c] = 0;
  __syncthreads();
  // each pass loads its keys for 8 queries a thread at once
  auto keys = [&](int base, int (&key)[8]) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = base + r * kOrderThreads + tid;
      key[r] = i < B ? cell_of(i) : -1;
    }
  };
  auto count = [&](const int (&key)[8]) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (key[r] >= 0) atomicAdd(&bins[key[r]], 1);
    }
  };
  int key[8];  // the first 8192 queries' cells stay for the second pass
  keys(0, key);
  count(key);
  for (int base = 8 * kOrderThreads; base < B; base += 8 * kOrderThreads) {
    int more[8];
    keys(base, more);
    count(more);
  }
  __syncthreads();
  const int per = (C + kOrderThreads - 1) / kOrderThreads;
  const int c0 = min(tid * per, C), c1 = min(c0 + per, C);
  int sum = 0;
  for (int c = c0; c < c1; ++c) sum += bins[c];
  int x = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int at = x - sum;
  for (int w = 0; w < warp; ++w) at += wsum[w];
  for (int c = c0; c < c1; ++c) {
    const int t = bins[c];
    bins[c] = at;
    at += t;
  }
  __syncthreads();
  for (int base = 0; base < B; base += 8 * kOrderThreads) {
    if (base) keys(base, key);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (key[r] >= 0) {
        order[atomicAdd(&bins[key[r]], 1)] = base + r * kOrderThreads + tid;
      }
    }
  }
}

template <int NV4>
cudaError_t launch(const void* q, const void* probe, const void* probe_ok,
                   void* order, const void* lists, const void* rows,
                   const void* scale, const void* fill, const void* self_ids,
                   void* vals, void* ids, int B, int nprobe, int C, int cap,
                   int n, int k, int measure, int payload, int G,
                   cudaStream_t stream) {
  const size_t smem =
      Width<NV4>::kSmem + (G > 1 ? sizeof(unsigned) * ((C + 3) / 4) : 0);
  static size_t sized[repro::kMaxDevices] = {};  // the limit set so far
  cudaError_t err = repro::allow_smem(probe_group_kernel<NV4>, smem, sized);
  if (err != cudaSuccess) return err;
  if (G > 1) {
    const int cells_bytes = static_cast<int>(sizeof(int)) * C;
    static size_t order_sized[repro::kMaxDevices] = {};
    err = repro::allow_smem(order_kernel, cells_bytes, order_sized);
    if (err != cudaSuccess) return err;
    order_kernel<<<1, kOrderThreads, cells_bytes, stream>>>(
        static_cast<const int*>(probe), B, nprobe, C, static_cast<int*>(order));
  }
  const dim3 grid((B + G - 1) / G);
  probe_group_kernel<NV4><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int*>(probe),
      static_cast<const int*>(probe_ok),
      static_cast<const int*>(order), static_cast<const int*>(lists),
      rows, static_cast<const float*>(scale), static_cast<const int*>(fill),
      static_cast<const int*>(self_ids), static_cast<float*>(vals),
      static_cast<int*>(ids), B, nprobe, C, cap, n, k, measure, payload, G);
  return cudaGetLastError();
}

}  // namespace

// payload: 0 = f32 rows, 1 = bf16 rows, 2 = int8 rows with f32 scales.
// probe_ok and self_ids may be null (all probes kept, no self id). G is 1,
// 2, 4 or 8 queries a block; for G > 1 ``order`` is scratch for b int32
// that the call fills (the queries by first-probed cell, C <= 32768) before
// block i takes order[i·G .. i·G + G); for G = 1 it is null.
extern "C" int ivf_probe_f32(const void* q, const void* probe,
                             const void* probe_ok, void* order,
                             const void* lists, const void* rows,
                             const void* scale, const void* fill,
                             const void* self_ids, void* vals, void* ids,
                             int B, int nprobe, int C, int cap, int n, int k,
                             int measure, int payload, int G, void* stream) {
  if (B <= 0 || nprobe <= 0 || C <= 0 || cap <= 0 || n <= 0 ||
      k <= 0 || k > 32 || measure < 0 || measure > 2 || payload < 0 ||
      payload > 2 || (payload == 2) != (scale != nullptr) ||
      (G != 1 && G != 2 && G != 4 && G != 8) ||
      (G > 1) != (order != nullptr) || (G > 1 && C > kOrderCells)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > kNarrowWidth) {  // the wide route: one query a block, G unused
    static size_t sized[repro::kMaxDevices] = {};
    const cudaError_t err = repro::allow_smem(probe_wide_kernel, kWideSmem,
                                              sized);
    if (err != cudaSuccess) return static_cast<int>(err);
    probe_wide_kernel<<<B, kThreads, kWideSmem, s>>>(
        static_cast<const float*>(q), static_cast<const int*>(probe),
        static_cast<const int*>(probe_ok), static_cast<const int*>(lists),
        rows, static_cast<const float*>(scale), static_cast<const int*>(fill),
        static_cast<const int*>(self_ids), static_cast<float*>(vals),
        static_cast<int*>(ids), nprobe, cap, n, k, measure, payload);
    return static_cast<int>(cudaGetLastError());
  }
  const int nv4 = (n + 3) / 4;
#define REPRO_PROBE(NV4)                                                  \
  return static_cast<int>(launch<NV4>(q, probe, probe_ok, order, lists,  \
                                      rows, scale, fill, self_ids, vals,  \
                                      ids, B, nprobe, C, cap, n, k,       \
                                      measure, payload, G, s))
  if (nv4 <= 2) REPRO_PROBE(2);
  if (nv4 <= 4) REPRO_PROBE(4);
  if (nv4 <= 5) REPRO_PROBE(5);
  if (nv4 <= 8) REPRO_PROBE(8);
  if (nv4 <= 12) REPRO_PROBE(12);
  if (nv4 <= 16) REPRO_PROBE(16);
  REPRO_PROBE(26);
#undef REPRO_PROBE
}
