// Fused d2 similarity + canonical top-k for Hopper, f32 on CUDA cores.
//
// Replaces two TPU kernels of src/repro/kernels/knn_topk.py:
// - topk_sim_kernel (body _kernel, tile _tile_sims): the d2 neighbor-graph
//   build — for every query row, the top-k candidates under the measure,
//   masking candidates >= n_valid and the row itself, without ever writing
//   the (U, C) score matrix;
// - foldin_topk_kernel (body _foldin_kernel): the skinny fold-in search of
//   b new rows against all U + b rows, query i masked against candidate
//   self_offset + i.
// Both run the same three launches: a prep pass, the scan, and (when the
// candidates are split across blocks) a merge of the splits.
//
// What bounds them on an H100: operations. At the graph-build shape
// (U = C = 5976, n = 20, k = 13: 35.7 M scored pairs) the bytes are under
// 1 MB, while every score is an n-term dot product that must stay bitwise
// the plain version's (kernels/ref.py::tile_sims): left to right, a
// rounding after each multiply and each add, so no FMA and no tensor
// cores. A pair costs 2n = 40 FP32 instructions on the CUDA cores, and the
// no-FMA floor is 35.7 M × 40 / (132 SMs × 128 lanes × 1.98 GHz) ≈
// 0.043 ms, twice the 0.021 ms that counts an FMA as two operations.
//
// Design:
// - prep (topk_prep_kernel): once per call, the candidate rows are laid
//   out d-major, (n, cpad) with cpad a multiple of the candidate tile,
//   zero past C; for pearson centered, and as row n the root of the
//   squared norm (pearson) or the squared norm (euclidean) — the same
//   center / sq_norm of topk_common.cuh in the same order as the plain
//   version. No block re-centers or re-norms a candidate; cosine rows
//   arrive normalized and are only laid out;
// - register micro-tiles (topk_scan_kernel): a block's W consumer warps
//   own R queries each (staged d-major in shared memory, centered and
//   normed once); a producer warp streams the candidate tiles of the
//   block's split into a ring of STAGES slots by bulk copies counted on an
//   mbarrier a slot, and a consumer frees a slot as soon as it has read it,
//   so warps drift apart by up to STAGES tiles and nothing waits on
//   another warp's merges. A lane scores its R queries against S = 4
//   candidates of the 128-wide tile: R·S independent sums that hide the add
//   latency, from one 16-byte conflict-free candidate load and R query
//   broadcasts a d step;
// - a per-query bar instead of per-lane lists: each query's list lives in
//   its warp (repro::WarpList: lane j holds entry j), and the bar is entry
//   k−1 (-inf while the list holds fewer than k). Per 32-candidate chunk a
//   ballot lets in only the candidates that beat it in the canonical order
//   — a shuffle-up each for a few, a bitonic sort and merge for many, as
//   the first tile brings — so the lists stay exact on any input, ties
//   included; a query with no candidate over its bar in a tile costs one
//   vote. For pearson and euclidean a few operations on the exact dot show
//   most pairs to be under the bar (Cut), so their division (and root)
//   runs only for the pairs that may enter;
// - filling the card: the candidate tiles are split across blocks (a
//   second grid dimension) only as far as the resident blocks need, since
//   every split's first tile enters its lists whole; topk_merge_kernel
//   merges the splits' lists, one warp a row through the same WarpList.
//   The wrapper (kernels/knn_topk.py) picks the tile variant and the split.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/time_topk_sim.py,
// device time of the whole call): 0.140 ms (cosine), 0.211–0.222
// (pearson) and 0.167–0.170 (euclidean) at the graph-build shape, against
// 0.696–0.701, 0.843–0.862 and 0.800–0.806 for one warp a query with 32
// per-lane lists; 0.018–0.022 ms at the fold-in shape (64 × 6040),
// against 0.023–0.027. Scoring alone (every epilogue, no selection) takes
// 0.094 ms (cosine): selection is the rest — ~55 candidates a query still
// beat the bar after the first 128, each a shuffle chain in its warp.
// Empty slots come back as (-inf, 0). Query width n <= 64 and k <= 32; the
// wrapper rejects others.
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"
#include "topk_common.cuh"

namespace {

using repro::WarpList;
using repro::bulk_load;
using repro::center;
using repro::kFull;
using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::smem_addr;
using repro::sq_norm;

constexpr int kPrepThreads = 256;
// The widest rows (landmark axis n) the scan takes: its ring of STAGES
// tiles of n + 1 rows fits the 227 KB of shared memory a block may opt
// into up to n = 109 (variant 0); the paper's tables go to n = 100.
constexpr int kMaxWidth = 104;
constexpr int kMergeWarps = 8;

// The norm a kernel keeps of a row: the root of its squared norm
// (pearson) or the squared norm (euclidean).
template <int NMAX, typename Row>
__device__ __forceinline__ float row_norm(const Row& x, int n, int measure) {
  const float s = sq_norm<NMAX>(x, n);
  return measure == 1 ? __fsqrt_rn(s) : s;
}

// A column of a d-major array read as a row: x[d] is p[d * stride].
struct Strided {
  float* p;
  int stride;
  __device__ __forceinline__ float& operator[](int d) const {
    return p[d * stride];
  }
};

// The candidate rows, d-major: P[d * cpad + c] for d < n (pearson:
// centered), P[n * cpad + c] the root of the squared norm (pearson) or the
// squared norm (euclidean); zero for c >= C.
template <int NMAX>
__global__ void __launch_bounds__(kPrepThreads)
topk_prep_kernel(const float* __restrict__ cand, float* __restrict__ P,
                 int C, int cpad, int n, int measure) {
  const int c = blockIdx.x * kPrepThreads + threadIdx.x;
  if (c >= cpad) return;
  float x[NMAX];
#pragma unroll
  for (int d = 0; d < NMAX; ++d) {
    x[d] = (c < C && d < n) ? cand[(size_t)c * n + d] : 0.0f;
  }
  if (measure == 1) center<NMAX>(x, n);
#pragma unroll
  for (int d = 0; d < NMAX; ++d) {
    if (d < n) P[(size_t)d * cpad + c] = x[d];
  }
  if (measure != 0) P[(size_t)n * cpad + c] = row_norm<NMAX>(x, n, measure);
}

// A tile variant: W consumer warps a block, each scoring R queries against
// a tile of CT = 32·S candidates (S a lane), fed by one producer warp
// through a ring of STAGES tiles; MINB blocks an SM bound the registers.
template <int R_, int S_, int W_, int STAGES_, int MINB_>
struct Tile {
  static constexpr int R = R_, S = S_, W = W_, STAGES = STAGES_;
  static constexpr int MINB = MINB_;
  static constexpr int QT = R * W, CT = 32 * S, kThreads = 32 * (W + 1);
  static_assert(S % 4 == 0 && (R == 1 || R == 2 || R % 4 == 0));

  // full and empty barriers [2][STAGES] | ring [STAGES][(n + 1) CT] |
  // queries [n][QT] | query norms [QT]
  static size_t smem(int n) {
    return sizeof(uint64_t) * 2 * STAGES +
           sizeof(float) * ((size_t)STAGES * (n + 1) * CT + (size_t)n * QT +
                            QT);
  }
};

// The variants the wrapper may ask for, by index (kernels/knn_topk.py
// mirrors QT and CT in SCAN_VARIANTS).
template <class F>
cudaError_t with_tile(int variant, F&& f) {
  switch (variant) {
    case 0: return f(Tile<2, 4, 8, 4, 3>{});  // many queries
    case 1: return f(Tile<1, 4, 8, 4, 4>{});  // a fold-in batch
    default: return cudaErrorInvalidValue;
  }
}

// A query's bar (the value of entry k−1 of its list, -inf while the list
// holds fewer than k) as a scorer uses it: ``below`` says, from the exact
// dot z, the norms and a few operations, that the pair's exact score is
// under the bar, so it cannot enter the list and its exact epilogue (a
// division, for euclidean also a root) is never taken. The thresholds keep
// a margin of 2^-16 of the bar (pearson) or 10^-5 of 1 + √d² (euclidean),
// far above the few roundings between them and the exact score; a false
// "no" only costs the epilogue. Cosine's score is z itself.
template <int M>
struct Cut {
  float thr;

  __device__ __forceinline__ explicit Cut(float bar) : thr(bar) {
    if (M == 1) {  // below when z < thr·den
      thr = bar - fabsf(bar) * 0x1p-16f - 0x1p-100f;
    } else if (M == 2) {  // below when d² > thr
      const float t = (1.0f / bar - 1.0f) * 1.00001f + 1e-5f;
      thr = bar > 0.0f ? t * t : INFINITY;
    }
  }

  __device__ __forceinline__ bool below(float z, float un, float vn) const {
    if (M == 0) return z < thr;
    if (M == 1) {
      return z < __fmul_rn(thr, fmaxf(__fmul_rn(un, vn), repro::kEps));
    }
    return fmaxf(__fadd_rn(__fsub_rn(un, __fmul_rn(2.0f, z)), vn), 0.0f) >
           thr;
  }
};

// Scores of QT query rows against candidate tiles [t_begin, t_begin + tps)
// of P, folded into canonical top-k lists. Grid: x over groups of QT query
// rows, y over candidate splits of tps tiles. Output slot of (row, split):
// out[(row * gridDim.y + split) * k ...]. Consumer warp w owns queries
// w·R + [0, R): it scores them against each tile and keeps their lists in
// registers. The last warp streams the tiles into the ring (bulk copies
// counted on the slot's full barrier); a consumer frees a slot as soon as
// it has read it, so the warps drift apart by up to STAGES tiles and a
// long merge in one holds up no other.
template <class T, int M>
__global__ void __launch_bounds__(T::kThreads, T::MINB)
topk_scan_kernel(const float* __restrict__ q, const float* __restrict__ P,
                 float* __restrict__ out_v, int* __restrict__ out_i,
                 int n_rows, int cpad, int n, int k, int n_valid,
                 int self_offset, int tps, int n_tiles) {
  constexpr int R = T::R, S = T::S, QT = T::QT, CT = T::CT;
  constexpr int STAGES = T::STAGES;
  extern __shared__ float4 dyn[];
  uint64_t* full = reinterpret_cast<uint64_t*>(dyn);
  uint64_t* empty = full + STAGES;
  const int ring_len = (n + 1) * CT;
  float* ring = reinterpret_cast<float*>(empty + STAGES);
  float* qs = ring + STAGES * ring_len;
  float* qn = qs + n * QT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QT;
  const int t_begin = blockIdx.y * tps;
  const int nt = min(n_tiles - t_begin, tps);
  const int rows = M == 0 ? n : n + 1;  // staged rows of P

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), T::W);
    }
    repro::mbar_init_fence();
  }
  // the block's queries, d-major (pearson: centered), and their norms as
  // P holds them
  if (tid < QT) {
    const int row = q0 + tid;
    Strided x{qs + tid, QT};
    for (int d = 0; d < n; ++d) {
      x[d] = row < n_rows ? q[(size_t)row * n + d] : 0.0f;
    }
    if (M == 1) center<kMaxWidth>(x, n);
    qn[tid] = M == 0 ? 0.0f : row_norm<kMaxWidth>(x, n, M);
  }
  __syncthreads();

  if (warp == T::W) {  // the producer: tile i into slot i % STAGES
    for (int i = 0; i < nt; ++i) {
      const int slot = i % STAGES;
      const uint32_t fb = smem_addr(&full[slot]);
      mbar_wait(smem_addr(&empty[slot]), ((i / STAGES) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(fb, rows * CT * sizeof(float));
      __syncwarp();
      const float* src = P + (size_t)(t_begin + i) * CT;
      for (int d = lane; d < rows; d += 32) {
        bulk_load(smem_addr(ring + slot * ring_len + d * CT),
                  src + (size_t)d * cpad, CT * sizeof(float), fb);
      }
    }
    return;
  }

  // lane scores the columns g·128 + 4·lane + [0, 4) of each 4-wide group
  // g < S / 4: a chunk of 32 candidates a column slot s, ids ascending
  // with the lane
  const int qw = warp * R;
  auto col = [&](int s) { return (s / 4) * 128 + 4 * lane + s % 4; };
  WarpList list[R];

  for (int i = 0; i < nt; ++i) {
    const int slot = i % STAGES;
    mbar_wait(smem_addr(&full[slot]), (i / STAGES) & 1);
    const float* cs = ring + slot * ring_len;
    float acc[R][S];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int s = 0; s < S; ++s) acc[r][s] = 0.0f;
    }
#pragma unroll 2
    for (int d = 0; d < n; ++d) {
      float qv[R], cv[S];
      if constexpr (R % 4 == 0) {
#pragma unroll
        for (int g = 0; g < R / 4; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(
              qs + d * QT + qw + 4 * g);
          qv[4 * g] = v.x;
          qv[4 * g + 1] = v.y;
          qv[4 * g + 2] = v.z;
          qv[4 * g + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) qv[r] = qs[d * QT + qw + r];
      }
#pragma unroll
      for (int g = 0; g < S / 4; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(cs + d * CT + col(4 * g));
        cv[4 * g] = v.x;
        cv[4 * g + 1] = v.y;
        cv[4 * g + 2] = v.z;
        cv[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          acc[r][s] = __fadd_rn(acc[r][s], __fmul_rn(qv[r], cv[s]));
        }
      }
    }
    float vn[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      vn[s] = M == 0 ? 0.0f : cs[n * CT + col(s)];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&empty[slot]));  // slot read
    const int t0 = (t_begin + i) * CT;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // the pairs that may enter: valid, and not under the bar
      const Cut<M> cut(list[r].tv);
      const float un = qn[qw + r];
      const int self = self_offset >= 0 ? self_offset + q0 + qw + r : -1;
      bool need[S];
      bool some = false;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int gid = t0 + col(s);
        need[s] = gid < n_valid && gid != self &&
                  !cut.below(acc[r][s], un, vn[s]);
        some |= need[s];
      }
      if (!__any_sync(kFull, some)) continue;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float v = acc[r][s];
        if (M != 0 && __any_sync(kFull, need[s])) {
          v = repro::tile_epilogue_rooted(v, un, vn[s], M);
        }
        list[r].offer(need[s], v, t0 + col(s), k);
      }
    }
  }

  // each warp writes the lists it kept
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = q0 + qw + r;
    if (row < n_rows && lane < k) {
      const size_t slot = ((size_t)row * gridDim.y + blockIdx.y) * k + lane;
      out_v[slot] = list[r].ev;
      out_i[slot] = list[r].ev == -INFINITY ? 0 : list[r].eid;
    }
  }
}

// Merge the m = splits·k partial entries of each row into its canonical
// top-k. One warp per row.
__global__ void __launch_bounds__(kMergeWarps * 32)
topk_merge_kernel(const float* __restrict__ part_v,
                  const int* __restrict__ part_i, float* __restrict__ out_v,
                  int* __restrict__ out_i, int n_rows, int m, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // uniform across the warp
  WarpList list;
  for (int e0 = 0; e0 < m; e0 += 32) {
    const int e = e0 + lane;
    const bool have = e < m;
    list.offer(have, have ? part_v[(size_t)row * m + e] : -INFINITY,
               have ? part_i[(size_t)row * m + e] : 0, k);
  }
  if (lane < k) {
    out_v[(size_t)row * k + lane] = list.ev;
    out_i[(size_t)row * k + lane] = list.ev == -INFINITY ? 0 : list.eid;
  }
}

// The scan instantiation for a measure (0 cosine, 1 pearson, 2 euclidean).
template <class T>
auto scan_kernel(int measure) {
  return measure == 0   ? topk_scan_kernel<T, 0>
         : measure == 1 ? topk_scan_kernel<T, 1>
                        : topk_scan_kernel<T, 2>;
}

bool bad_args(int rows, int C, int n, int k, int measure) {
  return rows <= 0 || C <= 0 || n <= 0 || n > kMaxWidth || k <= 0 ||
         k > 32 || measure < 0 || measure > 2;
}

}  // namespace

// Resident blocks of the scan an SM holds at width n under the measure
// (the wrapper sizes the split from it); negative on an error. Also lets
// the scan use the shared memory of the widest rows on the current device:
// call it there before the first topk_scan_f32.
extern "C" int topk_scan_blocks_per_sm(int variant, int n, int measure) {
  int blocks = 0;
  const cudaError_t err = with_tile(variant, [&](auto tile) {
    using T = decltype(tile);
    auto kern = scan_kernel<T>(measure);
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)T::smem(kMaxWidth));
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kern, T::kThreads, T::smem(n));
  });
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// prep, scan and (splits > 1) merge of ``rows`` queries against C
// candidates. ``prep`` holds (n + 1) × cpad floats, cpad = CT·⌈C / CT⌉;
// ``part_v`` / ``part_i`` hold rows × splits × k entries (with one split
// they are ``vals`` / ``ids``). ``qt`` and ``ct`` must be the variant's.
extern "C" int topk_scan_f32(const void* q, const void* cand, void* prep,
                             void* part_v, void* part_i, void* vals,
                             void* ids, int rows, int C, int n, int k,
                             int n_valid, int self_offset, int measure,
                             int variant, int qt, int ct, int splits,
                             int tps, void* stream) {
  if (bad_args(rows, C, n, k, measure) || splits <= 0 || tps <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_tile(variant, [&](auto tile) {
    using T = decltype(tile);
    const int n_tiles = (C + T::CT - 1) / T::CT;
    if (qt != T::QT || ct != T::CT || (splits - 1) * tps >= n_tiles ||
        splits * tps < n_tiles) {
      return cudaErrorInvalidValue;
    }
    const int cpad = n_tiles * T::CT;
    float* p = static_cast<float*>(prep);
    const int pblocks = (cpad + kPrepThreads - 1) / kPrepThreads;
    if (n <= 32) {
      topk_prep_kernel<32><<<pblocks, kPrepThreads, 0, s>>>(
          static_cast<const float*>(cand), p, C, cpad, n, measure);
    } else if (n <= 64) {
      topk_prep_kernel<64><<<pblocks, kPrepThreads, 0, s>>>(
          static_cast<const float*>(cand), p, C, cpad, n, measure);
    } else {
      topk_prep_kernel<kMaxWidth><<<pblocks, kPrepThreads, 0, s>>>(
          static_cast<const float*>(cand), p, C, cpad, n, measure);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const dim3 grid((rows + T::QT - 1) / T::QT, splits);
    const auto kern = scan_kernel<T>(measure);
    kern<<<grid, T::kThreads, T::smem(n), s>>>(
        static_cast<const float*>(q), p, static_cast<float*>(part_v),
        static_cast<int*>(part_i), rows, cpad, n, k, n_valid, self_offset, tps,
        n_tiles);
    return cudaGetLastError();
  });
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  topk_merge_kernel<<<(rows + kMergeWarps - 1) / kMergeWarps,
                      kMergeWarps * 32, 0, s>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<float*>(vals), static_cast<int*>(ids), rows, splits * k, k);
  return static_cast<int>(cudaGetLastError());
}
