// Gathered-candidate scorer for Hopper, f32 on CUDA cores, in two forms.
//
// Replaces the TPU kernel src/repro/retrieval/index.py
// score_candidates_kernel (body _score_kernel, algebra _gathered_sims):
// (b, n) queries against their own gathered (b, m, n) candidate rows ->
// (b, m) d2 scores, a multiply-reduce with the dense_similarity epilogue.
// It serves the IVF search at nprobe < C with scorer="kernel" (the
// per-query form). Its shared form scores every query against one (m, n)
// candidate block: the back-patch of the bucketed and sharded fold-ins and
// of every update (each existing row against the new batch).
//
// Every score keeps the three sums of the plain version
// (kernels/ref.py::gathered_sims) — z, |q|², |c|², left to right over the
// landmark axis with a rounding after each multiply and add, pearson rows
// centered against their mean first — and its IEEE epilogue, so the two
// agree bitwise. No tensor cores and no FMA: their f32 sums have another
// order. A row's mean and norm are the same bits whoever computes them, so
// each is computed once a block and reused by every pair. Any n: the rows
// are staged in slices of kSlice landmarks and the partial sums stay in
// registers across slices, ascending in d.
//
// Per-query form — what bounds it: every candidate row is read once and
// every score written once, 4·b·m·(n+1) bytes against ~4·b·m·n FLOPs, so
// device memory (at the partial-probe block b = 256, m = 1976, n = 20:
// 42 MB, ~13 µs). Design: a block of 128 threads takes one query and a run
// of its 128-row candidate tiles; it streams (tile, slice) units through a
// ring of kStages slots with 16-byte cp.async copies (4-byte where rows are
// not 16-byte aligned), kStages − 1 units ahead of the scoring, so loads
// overlap it; a thread scores one row. A slot's row pitch is the slice's
// width rounded to an odd count of 16-byte pieces (20 floats at n = 20, 36
// past 32), so narrow rows take small slots, and the runs are as many as
// keep every block of the grid resident: the bytes in flight on an SM are
// its resident blocks' kStages − 1 slots. The query's mean and norm are
// computed once a block. Pearson needs a row's mean before its first
// centered product: with one slice it comes from the staged slot, with
// more the tile's slices stream twice (the mean pass, then the sums).
//
// Shared form — what bounds it: nothing but latency at the back-patch
// shape (C = 8192 rows, bq = 64, n = 20: 2.7 MB, ~0.8 µs of bytes, below
// the cost of one launch). Design: a block of 256 threads takes 64
// queries (rows of `q`) and walks the candidate tiles of 64; slices staged
// with 16-byte loads (odd pitch: conflict-free reads), pearson's centered;
// each query's and each candidate's mean and norm once a tile, a thread a
// row, from the staged slices (pearson streams them twice: the means
// first); a thread scores a 4 × 4 register tile of (query, candidate)
// pairs — 16 independent chains that hide the add latency; scores written
// coalesced. Large bq splits the candidate tiles over a second grid axis.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_smem.cuh"
#include "topk_common.cuh"

namespace {

constexpr int kSlice = 32;      // landmarks a staged slice
constexpr int kSliceShift = 5;  // log2(kSlice)
constexpr int kVecs = kSlice / 4;  // 16-byte pieces of a slice row
constexpr int kVecShift = 3;       // log2(kVecs)

// A row's mean (pearson; else 0) and the sum of squares of the (centered)
// row, each added left to right over the whole row, from global memory.
struct Stats {
  float mean, sq;
};

__device__ __forceinline__ Stats row_stats(const float* __restrict__ x,
                                           int n, int measure) {
  float mean = 0.0f;
  if (measure == 1) {
    float s = 0.0f;
    for (int d = 0; d < n; ++d) s = __fadd_rn(s, __ldg(x + d));
    mean = __fdiv_rn(s, static_cast<float>(n));
  }
  float sq = 0.0f;
  for (int d = 0; d < n; ++d) {
    const float v =
        measure == 1 ? __fsub_rn(__ldg(x + d), mean) : __ldg(x + d);
    sq = __fadd_rn(sq, __fmul_rn(v, v));
  }
  return {mean, sq};
}

// What the epilogue keeps of a row's |x|²: its root (cosine, pearson) or
// itself (euclidean). The root is one correctly rounded op of |x|², so
// taking it once a row gives the bits dense_epilogue takes a pair.
__device__ __forceinline__ float aux_of(float sq, int measure) {
  return measure == 2 ? sq : __fsqrt_rn(sq);
}

// repro::dense_epilogue with each row's root (or square) taken once
__device__ __forceinline__ float score(float z, float qa, float ca,
                                       int measure) {
  if (measure == 2) return repro::tile_epilogue_rooted(z, qa, ca, 2);
  return __fdiv_rn(z, fmaxf(__fmul_rn(qa, ca), repro::kEps));
}

// ------------------------------------------------------------ shared form
constexpr int kSharedThreads = 256;
constexpr int kTQ = 64, kTC = 64;  // queries, candidates of a block tile
constexpr int kRQ = 4, kRC = 4;    // a thread's register tile
constexpr int kPitch = kSlice + 1;  // staged row pitch (odd: conflict-free)
static_assert(kTQ == 16 * kRQ && kTC == 16 * kRC &&
              kSharedThreads == 256, "a 16 x 16 thread grid");

// Stage dims [d0, d0 + w) of `count` rows of src (row stride n) into dst
// (pitch kPitch), centered against each row's mean when `center`.
template <int ROWS>
__device__ __forceinline__ void stage_slice(float* dst,
                                            const float* __restrict__ src,
                                            int count, int n, int d0, int w,
                                            const float* mean, bool center,
                                            bool vec) {
  if (vec) {  // n % 4 == 0, 16-byte aligned rows: w is a multiple of 4
    for (int e = threadIdx.x; e < ROWS * kVecs; e += kSharedThreads) {
      const int r = e >> kVecShift, d = 4 * (e & (kVecs - 1));
      if (r < count && d < w) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            src + (size_t)r * n + d0 + d));
        float* o = dst + r * kPitch + d;
        if (center) {
          const float mu = mean[r];
          o[0] = __fsub_rn(v.x, mu);
          o[1] = __fsub_rn(v.y, mu);
          o[2] = __fsub_rn(v.z, mu);
          o[3] = __fsub_rn(v.w, mu);
        } else {
          o[0] = v.x;
          o[1] = v.y;
          o[2] = v.z;
          o[3] = v.w;
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * kSlice; e += kSharedThreads) {
      const int r = e >> kSliceShift, d = e & (kSlice - 1);
      if (r < count && d < w) {
        const float v = __ldg(src + (size_t)r * n + d0 + d);
        dst[r * kPitch + d] = center ? __fsub_rn(v, mean[r]) : v;
      }
    }
  }
}

// Grid: x over query tiles of kTQ, y over runs of `tps` candidate tiles.
// Thread t < kTQ owns query row t and thread kTQ + t candidate row t: each
// adds its row's sums, left to right, from the staged slices (pearson: a
// first pass over the slices for the mean, then the centered squares).
__global__ void __launch_bounds__(kSharedThreads)
shared_kernel(const float* __restrict__ q, const float* __restrict__ cand,
              float* __restrict__ out, int B, int M, int n, int measure,
              int tps, int vec) {
  __shared__ float s_q[kTQ * kPitch];
  __shared__ float s_c[kTC * kPitch];
  __shared__ float q_mean[kTQ], q_aux[kTQ], c_mean[kTC], c_aux[kTC];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kTQ;
  const int qn = min(kTQ, B - q0);
  const int t_end = min((int)blockIdx.y * tps + tps, (M + kTC - 1) / kTC);
  const float* qrows = q + (size_t)q0 * n;
  const bool owner = tid < kTQ + kTC;
  const bool owns_q = tid < kTQ;
  float* own = owns_q ? s_q + tid * kPitch : s_c + (tid - kTQ) * kPitch;
  for (int t = blockIdx.y * tps; t < t_end; ++t) {
    const int c0 = t * kTC, cn = min(kTC, M - c0);
    const float* crows = cand + (size_t)c0 * n;
    float z[kRQ][kRC];
#pragma unroll
    for (int i = 0; i < kRQ; ++i) {
#pragma unroll
      for (int j = 0; j < kRC; ++j) z[i][j] = 0.0f;
    }
    float sum = 0.0f, sq = 0.0f;  // the owned row's
    for (int pass = measure == 1 ? 0 : 1; pass < 2; ++pass) {
      const bool center = pass == 1 && measure == 1;
      for (int d0 = 0; d0 < n; d0 += kSlice) {
        const int w = min(kSlice, n - d0);
        __syncthreads();  // the last slice is read, the means written
        stage_slice<kTQ>(s_q, qrows, qn, n, d0, w, q_mean, center, vec);
        stage_slice<kTC>(s_c, crows, cn, n, d0, w, c_mean, center, vec);
        __syncthreads();
        if (pass == 0) {
          if (owner) {
            for (int d = 0; d < w; ++d) sum = __fadd_rn(sum, own[d]);
          }
          continue;
        }
        if (owner) {
          for (int d = 0; d < w; ++d) {
            sq = __fadd_rn(sq, __fmul_rn(own[d], own[d]));
          }
        }
        for (int d = 0; d < w; ++d) {
          float a[kRQ], c[kRC];
#pragma unroll
          for (int i = 0; i < kRQ; ++i) a[i] = s_q[(ty + 16 * i) * kPitch + d];
#pragma unroll
          for (int j = 0; j < kRC; ++j) c[j] = s_c[(tx + 16 * j) * kPitch + d];
#pragma unroll
          for (int i = 0; i < kRQ; ++i) {
#pragma unroll
            for (int j = 0; j < kRC; ++j) {
              z[i][j] = __fadd_rn(z[i][j], __fmul_rn(a[i], c[j]));
            }
          }
        }
      }
      if (pass == 0 && owner) {  // read after the next slice's barrier
        (owns_q ? q_mean[tid] : c_mean[tid - kTQ]) =
            __fdiv_rn(sum, static_cast<float>(n));
      }
    }
    if (owner) (owns_q ? q_aux[tid] : c_aux[tid - kTQ]) = aux_of(sq, measure);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRQ; ++i) {
      const int qi = ty + 16 * i;
      if (qi >= qn) continue;
#pragma unroll
      for (int j = 0; j < kRC; ++j) {
        const int cj = tx + 16 * j;
        if (cj < cn) {
          out[(size_t)(q0 + qi) * M + c0 + cj] =
              score(z[i][j], q_aux[qi], c_aux[cj], measure);
        }
      }
    }
  }
}

// --------------------------------------------------------- per-query form
constexpr int kRowThreads = 128;  // a thread a candidate row of the tile
constexpr int kStages = 4;        // the ring's slots

// Floats a staged row takes: the widest slice rounded up to 16-byte pieces,
// an odd count of them, so the 8 threads of a quarter warp reading their
// rows' piece p hit 8 distinct bank groups.
int row_pitch(int n) {
  const int pieces = (min(n, kSlice) + 3) / 4;
  return 4 * (pieces | 1);
}

// A slot: kRowThreads rows at `pitch`, then the query's slice.
size_t ring_bytes(int pitch) {
  return sizeof(float) * kStages * (kRowThreads * pitch + kSlice);
}

// A block's units in order: tile, pass (pearson with several slices: the
// mean pass, then the sums), slice.
struct Walk {
  int tile, pass, slice;
  __device__ __forceinline__ void next(int passes, int slices) {
    if (++slice == slices) {
      slice = 0;
      if (++pass == passes) {
        pass = 0;
        ++tile;
      }
    }
  }
};

// Grid: x over queries, y over runs of `tps` tiles of kRowThreads rows.
__global__ void __launch_bounds__(kRowThreads)
per_query_kernel(const float* __restrict__ q, const float* __restrict__ cand,
                 float* __restrict__ out, int M, int n, int measure, int tps,
                 int pitch, int vec) {
  extern __shared__ float4 ring4[];
  float* ring = reinterpret_cast<float*>(ring4);
  __shared__ float s_stats[2];  // the query's mean and root (or square)
  const int tid = threadIdx.x, qi = blockIdx.x;
  const int tiles = (M + kRowThreads - 1) / kRowThreads;
  const int t0 = blockIdx.y * tps, t_end = min(t0 + tps, tiles);
  const int slices = (n + kSlice - 1) / kSlice;
  const int passes = measure == 1 && slices > 1 ? 2 : 1;
  const int units = (t_end - t0) * passes * slices;
  const int slot_len = kRowThreads * pitch + kSlice;
  const float* qrow = q + (size_t)qi * n;
  const float* crows = cand + (size_t)qi * M * n;

  // unit `at` into slot: its rows' slice and the query's slice
  auto load_unit = [&](const Walk& at, int slot) {
    const int r0 = at.tile * kRowThreads, d0 = at.slice * kSlice;
    const int rows = min(kRowThreads, M - r0), w = min(kSlice, n - d0);
    float* dst = ring + slot * slot_len;
    const float* src = crows + (size_t)r0 * n + d0;
    if (vec) {
      for (int e = tid; e < kRowThreads * kVecs; e += kRowThreads) {
        const int r = e >> kVecShift, d = 4 * (e & (kVecs - 1));
        if (r < rows && d < w) {
          __pipeline_memcpy_async(dst + r * pitch + d,
                                  src + (size_t)r * n + d, 16);
        }
      }
    } else {
      for (int e = tid; e < kRowThreads * kSlice; e += kRowThreads) {
        const int r = e >> kSliceShift, d = e & (kSlice - 1);
        if (r < rows && d < w) {
          __pipeline_memcpy_async(dst + r * pitch + d,
                                  src + (size_t)r * n + d, 4);
        }
      }
    }
    if (tid < w) {
      __pipeline_memcpy_async(dst + kRowThreads * pitch + tid,
                              qrow + d0 + tid, 4);
    }
  };

  Walk ahead{t0, 0, 0};
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < units) load_unit(ahead, k);
    __pipeline_commit();
    ahead.next(passes, slices);
  }
  if (tid == 0) {  // the query's statistics, once, while the copies fly
    const Stats s = row_stats(qrow, n, measure);
    s_stats[0] = s.mean;
    s_stats[1] = aux_of(s.sq, measure);
  }

  float sum = 0.0f, mean = 0.0f, z = 0.0f, cn = 0.0f;
  float qmean = 0.0f, qaux = 0.0f;
  Walk at{t0, 0, 0};
  for (int u = 0; u < units; ++u) {
    __pipeline_wait_prior(kStages - 2);  // this thread's copies of unit u
    __syncthreads();  // everyone's; and the slot loaded next is read
    if (u == 0) {
      qmean = s_stats[0];
      qaux = s_stats[1];
    }
    if (u + kStages - 1 < units) {
      load_unit(ahead, (u + kStages - 1) % kStages);
    }
    __pipeline_commit();
    ahead.next(passes, slices);

    const float* slot = ring + (u % kStages) * slot_len;
    const float4* cr = reinterpret_cast<const float4*>(slot + tid * pitch);
    const float4* qs =
        reinterpret_cast<const float4*>(slot + kRowThreads * pitch);
    const int r0 = at.tile * kRowThreads;
    const int w = min(kSlice, n - at.slice * kSlice);
    const bool live = tid < M - r0;
    if (at.pass == 0 && at.slice == 0) sum = z = cn = 0.0f;
    const bool mean_pass = passes == 2 && at.pass == 0;
    if (live && (mean_pass || (measure == 1 && slices == 1))) {
      for (int p = 0; 4 * p < w; ++p) {  // the row's raw sum, left to right
        const float4 v = cr[p];
        sum = __fadd_rn(sum, v.x);
        if (4 * p + 1 < w) sum = __fadd_rn(sum, v.y);
        if (4 * p + 2 < w) sum = __fadd_rn(sum, v.z);
        if (4 * p + 3 < w) sum = __fadd_rn(sum, v.w);
      }
      if (at.slice == slices - 1) mean = __fdiv_rn(sum, static_cast<float>(n));
    }
    if (live && !mean_pass) {
      auto step = [&](float c, float a) {
        if (measure == 1) {
          a = __fsub_rn(a, qmean);
          c = __fsub_rn(c, mean);
        }
        z = __fadd_rn(z, __fmul_rn(a, c));
        cn = __fadd_rn(cn, __fmul_rn(c, c));
      };
      for (int p = 0; 4 * p < w; ++p) {
        const float4 v = cr[p], a = qs[p];
        step(v.x, a.x);
        if (4 * p + 1 < w) step(v.y, a.y);
        if (4 * p + 2 < w) step(v.z, a.z);
        if (4 * p + 3 < w) step(v.w, a.w);
      }
      if (at.slice == slices - 1) {
        out[(size_t)qi * M + r0 + tid] =
            score(z, qaux, aux_of(cn, measure), measure);
      }
    }
    at.next(passes, slices);
  }
}

int sm_count() {
  static int sms[repro::kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev >= 0 && dev < repro::kMaxDevices && sms[dev]) return sms[dev];
  int count = 0;
  if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess) {
    return 0;
  }
  if (dev >= 0 && dev < repro::kMaxDevices) sms[dev] = count;
  return count;
}

// Runs of tiles a block takes so the grid (`rows` × runs) holds about
// `resident` blocks (at least one run): (runs, tiles a run).
int2 plan_runs(int rows, int tiles, int resident) {
  const int want = max(1, min(tiles, resident / max(rows, 1)));
  const int tps = (tiles + want - 1) / want;
  return make_int2((tiles + tps - 1) / tps, tps);
}

}  // namespace

// q (B, n); cand (B, M, n), each query's own rows, or (M, n) shared by
// every query (`shared`); out (B, M).
extern "C" int score_candidates_f32(const void* q, const void* cand,
                                    void* out, int B, int M, int n,
                                    int measure, int shared, void* stream) {
  if (B <= 0 || M <= 0 || n <= 0 || measure < 0 || measure > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = n % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(cand) % 16 == 0;
  const float* qf = static_cast<const float*>(q);
  const float* cf = static_cast<const float*>(cand);
  float* of = static_cast<float*>(out);
  if (shared) {  // two blocks an SM where the query tiles are few
    const int qtiles = (B + kTQ - 1) / kTQ;
    const int2 run = plan_runs(qtiles, (M + kTC - 1) / kTC, 2 * sms);
    if (run.x > 65535) return static_cast<int>(cudaErrorInvalidValue);
    shared_kernel<<<dim3(qtiles, run.x), kSharedThreads, 0, s>>>(
        qf, cf, of, B, M, n, measure, run.y, aligned);
    return static_cast<int>(cudaGetLastError());
  }
  const int pitch = row_pitch(n);
  const size_t smem = ring_bytes(pitch);
  static size_t sized[repro::kMaxDevices] = {};
  cudaError_t err = repro::allow_smem(per_query_kernel, smem, sized);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, per_query_kernel, kRowThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int2 run = plan_runs(B, (M + kRowThreads - 1) / kRowThreads,
                             max(per_sm, 1) * sms);
  if (run.x > 65535) return static_cast<int>(cudaErrorInvalidValue);
  per_query_kernel<<<dim3(B, run.x), kRowThreads, smem, s>>>(
      qf, cf, of, M, n, measure, run.y, pitch, aligned);
  return static_cast<int>(cudaGetLastError());
}
