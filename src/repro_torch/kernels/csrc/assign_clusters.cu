// Lloyd assignment (nearest centroid per row) for Hopper, f32 on CUDA cores.
//
// Replaces the TPU kernel src/repro/retrieval/kmeans.py
// assign_clusters_kernel (body _assign_kernel): one (rows, C) d2 score tile
// with the graph-build epilogue of knn_topk.tile_sims, an arg-max per row
// with ties to the lowest centroid id, and only the (U,) int32 assignment
// written.
//
// What bounds it on an H100: at the k-means shape of the IVF build
// (U = 5976 rows, C = 77 centroids, n = 20) the scores are 2·U·C·n =
// 18 MFLOP (~0.3 µs at the f32 peak) and the bytes ~0.5 MB (~0.15 µs), so
// one launch is far below any bound a kernel launch can reach: launch
// latency sets its time. Nine launches run per k-means (eight Lloyd steps
// and the final assignment).
//
// Design (the shape of topk_scan_kernel in knn_topk.cu, with k = 1):
// - one warp owns one row, held in registers (pearson-centered, its squared
//   norm precomputed); a block of 8 warps shares each tile of up to 256
//   centroids in shared memory, centered and normed once per tile, so any C
//   fits;
// - each lane scores centroids lane, lane+32, ... with the f32 left-to-right
//   sums and the IEEE epilogue of repro::tile_epilogue (cosine expects rows
//   and centroids L2-normalized by the caller), keeping its best
//   (value, id) under the canonical order;
// - a shuffle arg-max merges the 32 lanes, ties to the lowest id, so the
//   result equals the plain version's arg-max (kernels/ref.py
//   ::assign_clusters_ref) bitwise.
// Row width n <= 64 (the register row); the wrapper rejects others.
#include <cuda_runtime.h>
#include <math.h>

#include "topk_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <int NMAX>
__global__ void __launch_bounds__(kThreads)
assign_kernel(const float* __restrict__ rep, const float* __restrict__ cent,
              int* __restrict__ out, int U, int C, int n, int measure,
              int tile) {
  extern __shared__ float smem[];
  const int stride = n | 1;  // odd row stride: conflict-free lane reads
  float* cs = smem;                     // tile × stride centroid values
  float* cnorm = smem + tile * stride;  // tile squared norms

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  const bool active = row < U;  // uniform across the warp

  float qr[NMAX];
#pragma unroll
  for (int d = 0; d < NMAX; ++d) {
    qr[d] = (active && d < n) ? rep[(size_t)row * n + d] : 0.0f;
  }
  if (measure == 1) repro::center<NMAX>(qr, n);
  const float qnorm = repro::sq_norm<NMAX>(qr, n);

  float best_v = -INFINITY;
  int best_i = 0;
  for (int t0 = 0; t0 < C; t0 += tile) {
    const int tn = min(tile, C - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < tn * n; e += kThreads) {
      const int r = e / n, d = e - r * n;
      cs[r * stride + d] = cent[(size_t)(t0 + r) * n + d];
    }
    __syncthreads();
    if (measure != 0) {
      for (int r = threadIdx.x; r < tn; r += kThreads) {
        float* cr = cs + r * stride;
        if (measure == 1) repro::center<NMAX>(cr, n);
        cnorm[r] = repro::sq_norm<NMAX>(cr, n);
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
        const float s = repro::tile_epilogue(
            z, qnorm, measure == 0 ? 0.0f : cnorm[r], measure);
        if (repro::better(s, t0 + r, best_v, best_i)) {
          best_v = s;
          best_i = t0 + r;
        }
      }
    }
  }
  if (!active) return;  // uniform across the warp
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(repro::kFull, best_v, off);
    const int oi = __shfl_xor_sync(repro::kFull, best_i, off);
    if (repro::better(ov, oi, best_v, best_i)) {
      best_v = ov;
      best_i = oi;
    }
  }
  if (lane == 0) out[row] = best_i;
}

int tile_rows(int n) {
  // largest multiple of 32 (<= 256) whose tile and norms fit 48 KB
  const int stride = n | 1;
  int tile = (48 * 1024 / 4) / (stride + 1);
  tile = tile > 256 ? 256 : tile;
  return tile - tile % 32;
}

}  // namespace

extern "C" int assign_clusters_f32(const void* rep, const void* cent,
                                   void* out, int U, int C, int n,
                                   int measure, void* stream) {
  if (U <= 0 || C <= 0 || n <= 0 || n > 64 || measure < 0 || measure > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile = tile_rows(n);
  const size_t smem = sizeof(float) * (size_t)tile * ((n | 1) + 1);
  const dim3 grid((U + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rep);
  const float* c = static_cast<const float*>(cent);
  int* o = static_cast<int*>(out);
  if (n <= 32) {
    assign_kernel<32><<<grid, kThreads, smem, s>>>(r, c, o, U, C, n, measure,
                                                   tile);
  } else {
    assign_kernel<64><<<grid, kThreads, smem, s>>>(r, c, o, U, C, n, measure,
                                                   tile);
  }
  return static_cast<int>(cudaGetLastError());
}
