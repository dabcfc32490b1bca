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
//
// What bounds them on an H100: at the graph-build shape (U = C = 6040,
// n = 20, k = 13) the scores are 2·U·C·n = 1.46 GFLOP (~22 µs at the f32
// peak) while the bytes are ~1.6 MB, so operations bound it; at the
// fold-in shape (64 × 6104 × 20) the bound is under a microsecond and the
// launch overhead of the two kernels dominates.
//
// Design. The Pallas kernels walk candidate tiles in sequence and keep a
// slot-ordered best list; blocks here run in parallel, so:
// - one warp owns one query row, held in registers (pearson-centered,
//   its norm precomputed); a block of 8 warps shares each 256-candidate
//   tile in shared memory, where the candidates are centered and normed
//   once per tile;
// - every sum runs over the landmark axis left to right with a rounding
//   after each multiply and add (round-to-nearest intrinsics, never
//   contracted into an FMA), and the epilogues use the same IEEE
//   operations in the same order as the plain version
//   (kernels/ref.py::tile_sims), so the two agree bitwise — the euclidean
//   epilogue |u|² − 2z + |v|² cancels badly for near-duplicate rows, where
//   two summation orders could differ by ~1e-3;
// - each lane scores candidates lane, lane+32, ... and keeps its own
//   sorted top-KMAX (KMAX >= k, a superset of its top-k) in registers under
//   the canonical order (value desc, then id asc), so ties break to the
//   lowest id as in the reference's lax.top_k;
// - at the end the warp merges its 32 lists in k rounds of a shuffle
//   arg-max, emitting the list already in canonical order (the Pallas
//   kernel leaves slot order);
// - the fold-in search splits the candidates across blocks (a second grid
//   dimension), writes a partial canonical top-k per split, and a second
//   small kernel merges the splits with the same device functions.
// Empty slots come back as (-inf, 0). Query width n <= 64 and k <= 32
// (template sizes of the register arrays); the wrapper rejects others.
#include <cuda_runtime.h>
#include <math.h>

#include "topk_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

using repro::TopK;
using repro::center;
using repro::sq_norm;
using repro::warp_merge;

// Scores of one query row against candidate rows [c_begin, c_end), folded
// into canonical top-k lists. Grid: x over groups of kWarps query rows,
// y over candidate splits of split_len rows. Output slot of (row, split):
// out[(row * gridDim.y + split) * k ...].
template <int NMAX, int KMAX>
__global__ void __launch_bounds__(kThreads)
topk_scan_kernel(const float* __restrict__ q, const float* __restrict__ cand,
                 float* __restrict__ out_v, int* __restrict__ out_i,
                 int n_rows, int C, int n, int k, int n_valid,
                 int self_offset, int measure, int split_len, int tile) {
  extern __shared__ float smem[];
  const int stride = n | 1;  // odd row stride: conflict-free lane reads
  float* cs = smem;                  // tile × stride candidate values
  float* cnorm = smem + tile * stride;  // tile squared norms

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  const bool active = row < n_rows;  // uniform across the warp
  const int c_begin = blockIdx.y * split_len;
  const int c_end = min(C, c_begin + split_len);
  const int self_gid = self_offset >= 0 ? self_offset + row : -1;

  float qr[NMAX];
#pragma unroll
  for (int d = 0; d < NMAX; ++d) {
    qr[d] = (active && d < n) ? q[(size_t)row * n + d] : 0.0f;
  }
  if (measure == 1) center<NMAX>(qr, n);
  const float qnorm = sq_norm<NMAX>(qr, n);

  TopK<KMAX> best;
  best.init();

  for (int t0 = c_begin; t0 < c_end; t0 += tile) {
    const int tn = min(tile, c_end - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < tn * n; e += kThreads) {
      const int r = e / n, d = e - r * n;
      cs[r * stride + d] = cand[(size_t)(t0 + r) * n + d];
    }
    __syncthreads();
    if (measure != 0) {
      for (int r = threadIdx.x; r < tn; r += kThreads) {
        float* cr = cs + r * stride;
        if (measure == 1) center<NMAX>(cr, n);
        cnorm[r] = sq_norm<NMAX>(cr, n);
      }
      __syncthreads();
    }
    if (active) {
      for (int r = lane; r < tn; r += 32) {
        const float* cr = cs + r * stride;
        float z = 0.0f;
#pragma unroll
        for (int d = 0; d < NMAX; ++d) {
          if (d < n) z = __fadd_rn(z, __fmul_rn(qr[d], cr[d]));
        }
        float s = repro::tile_epilogue(
            z, qnorm, measure == 0 ? 0.0f : cnorm[r], measure);
        const int gid = t0 + r;
        if (gid >= n_valid || gid == self_gid) s = -INFINITY;
        best.offer(s, gid);
      }
    }
  }

  if (active) {
    const size_t slot = ((size_t)row * gridDim.y + blockIdx.y) * k;
    warp_merge(best, k, out_v + slot, out_i + slot);
  }
}

// Merge the m = splits·k partial entries of each row into its canonical
// top-k. One warp per row.
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ part_v,
                  const int* __restrict__ part_i, float* __restrict__ out_v,
                  int* __restrict__ out_i, int n_rows, int m, int k) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= n_rows) return;  // uniform across the warp
  TopK<KMAX> best;
  best.init();
  for (int e = lane; e < m; e += 32) {
    best.offer(part_v[(size_t)row * m + e], part_i[(size_t)row * m + e]);
  }
  warp_merge(best, k, out_v + (size_t)row * k, out_i + (size_t)row * k);
}

int tile_rows(int n) {
  // largest multiple of 32 (<= 256) whose tile and norms fit 48 KB
  const int stride = n | 1;
  int tile = (48 * 1024 / 4) / (stride + 1);
  tile = tile > 256 ? 256 : tile;
  return tile - tile % 32;
}

template <int NMAX, int KMAX>
cudaError_t launch_scan(const float* q, const float* cand, float* v, int* i,
                        int rows, int C, int n, int k, int n_valid,
                        int self_offset, int measure, int splits,
                        int split_len, cudaStream_t stream) {
  const int tile = tile_rows(n);
  const size_t smem = sizeof(float) * (size_t)tile * ((n | 1) + 1);
  dim3 grid((rows + kWarps - 1) / kWarps, splits);
  topk_scan_kernel<NMAX, KMAX><<<grid, kThreads, smem, stream>>>(
      q, cand, v, i, rows, C, n, k, n_valid, self_offset, measure, split_len,
      tile);
  return cudaGetLastError();
}

cudaError_t scan(const float* q, const float* cand, float* v, int* i,
                 int rows, int C, int n, int k, int n_valid, int self_offset,
                 int measure, int splits, int split_len,
                 cudaStream_t stream) {
  if (n <= 32 && k <= 16)
    return launch_scan<32, 16>(q, cand, v, i, rows, C, n, k, n_valid,
                               self_offset, measure, splits, split_len, stream);
  if (n <= 32)
    return launch_scan<32, 32>(q, cand, v, i, rows, C, n, k, n_valid,
                               self_offset, measure, splits, split_len, stream);
  if (k <= 16)
    return launch_scan<64, 16>(q, cand, v, i, rows, C, n, k, n_valid,
                               self_offset, measure, splits, split_len, stream);
  return launch_scan<64, 32>(q, cand, v, i, rows, C, n, k, n_valid,
                             self_offset, measure, splits, split_len, stream);
}

bool bad_args(int rows, int C, int n, int k, int measure) {
  return rows <= 0 || C <= 0 || n <= 0 || n > 64 || k <= 0 || k > 32 ||
         measure < 0 || measure > 2;
}

}  // namespace

extern "C" int topk_sim_f32(const void* rep, const void* cand, void* vals,
                            void* ids, int U, int C, int n, int k,
                            int n_valid, int self_offset, int measure,
                            void* stream) {
  if (bad_args(U, C, n, k, measure)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(scan(
      static_cast<const float*>(rep), static_cast<const float*>(cand),
      static_cast<float*>(vals), static_cast<int*>(ids), U, C, n, k, n_valid,
      self_offset, measure, 1, C, static_cast<cudaStream_t>(stream)));
}

extern "C" int foldin_topk_f32(const void* q, const void* cand,
                               void* part_vals, void* part_ids, void* vals,
                               void* ids, int B, int C, int n, int k,
                               int n_valid, int self_offset, int split,
                               int measure, void* stream) {
  if (bad_args(B, C, n, k, measure) || split <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int splits = (C + split - 1) / split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = scan(static_cast<const float*>(q),
                         static_cast<const float*>(cand),
                         static_cast<float*>(part_vals),
                         static_cast<int*>(part_ids), B, C, n, k, n_valid,
                         self_offset, measure, splits, split, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kWarps - 1) / kWarps;
  const int m = splits * k;
  if (k <= 16) {
    topk_merge_kernel<16><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(part_vals),
        static_cast<const int*>(part_ids), static_cast<float*>(vals),
        static_cast<int*>(ids), B, m, k);
  } else {
    topk_merge_kernel<32><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(part_vals),
        static_cast<const int*>(part_ids), static_cast<float*>(vals),
        static_cast<int*>(ids), B, m, k);
  }
  return static_cast<int>(cudaGetLastError());
}
