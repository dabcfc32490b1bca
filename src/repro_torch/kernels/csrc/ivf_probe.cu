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
// k = 13) each query reads ~19·104 rows, ~0.16 MB, so the gathered bytes
// are ~0.95 GB if every probe missed the cache (~0.28 ms) — but the whole
// f32 index is 0.64 MB and stays in the 50 MB L2, so the unique bytes are
// ~1 MB and the 2·b·m·n = 0.47 GFLOP of scores (~7 µs) bound it. Per-slot
// list insertion, not the dot products, sets its time, as in topk_sim.
//
// Design:
// - one warp owns one query, held in registers (pearson-centered, squared
//   norm precomputed); 4 warps per block, each with its own 32-row staging
//   buffer in shared memory;
// - per probed cell the warp copies its live slots 32 rows at a time with
//   coalesced loads (the rows of a cell are contiguous), dequantizing on
//   the way (bf16 widened; int8 times the row's f32 scale, one rounding, as
//   the plain version); each lane then scores one staged row from shared
//   memory (odd row stride: conflict-free);
// - scores follow repro::dense_epilogue — z / max(√|q|²·√|c|², eps) for
//   cosine and centered pearson, 1/(1+√d²) for euclidean — with the f32
//   left-to-right sums of the plain version (kernels/ref.py::gathered_sims),
//   so the two agree bitwise. It is NOT the normalized-row cosine of the
//   graph-build kernels;
// - slots at or past the cell's fill, the query's own id and masked
//   (query, probe rank) pairs are never offered; each lane keeps a sorted
//   register top-KMAX under (value desc, id asc) and repro::warp_merge
//   emits the canonical list, empty slots as (-inf, 0).
// Any cap (the warp loops over slots), empty cells and k above the live
// candidates are handled; n <= 64 and k <= 32 (register arrays). The probe
// table must hold distinct cells per query, as the reference requires.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(int8_t x) {
  return static_cast<float>(x);
}

template <int NMAX, int KMAX, typename T>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const float* __restrict__ q, const int* __restrict__ probe,
             const int* __restrict__ lists, const T* __restrict__ rows,
             const float* __restrict__ scale, const int* __restrict__ fill,
             const int* __restrict__ self_ids,
             const int* __restrict__ probe_ok, float* __restrict__ out_v,
             int* __restrict__ out_i, int B, int nprobe, int cap, int n,
             int k, int measure) {
  __shared__ float stage[kWarps][32 * (NMAX + 1)];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + warp;
  if (qi >= B) return;  // uniform across the warp; only warp syncs below
  const int stride = n | 1;  // odd row stride: conflict-free lane reads
  float* st = stage[warp];

  float qr[NMAX];
#pragma unroll
  for (int d = 0; d < NMAX; ++d) {
    qr[d] = d < n ? q[(size_t)qi * n + d] : 0.0f;
  }
  if (measure == 1) repro::center<NMAX>(qr, n);
  const float qnorm = repro::sq_norm<NMAX>(qr, n);
  const int sid = self_ids[qi];

  repro::TopK<KMAX> best;
  best.init();
  for (int j = 0; j < nprobe; ++j) {
    if (probe_ok[(size_t)qi * nprobe + j] == 0) continue;  // uniform
    const int cell = probe[(size_t)qi * nprobe + j];
    const int live = min(fill[cell], cap);
    const size_t base = (size_t)cell * cap;
    for (int s0 = 0; s0 < live; s0 += 32) {
      const int rn = min(32, live - s0);
      __syncwarp();  // the previous rows are no longer read
      for (int e = lane; e < rn * n; e += 32) {
        const int r = e / n, d = e - r * n;
        float x = widen(rows[(base + s0) * n + e]);
        if (scale != nullptr) x = __fmul_rn(x, scale[base + s0 + r]);
        st[r * stride + d] = x;
      }
      __syncwarp();
      if (lane < rn) {
        const int id = lists[base + s0 + lane];
        if (id != sid) {
          const float* cr = st + lane * stride;
          const float mean = measure == 1 ? repro::row_mean<NMAX>(cr, n)
                                          : 0.0f;
          float z = 0.0f, cn = 0.0f;
#pragma unroll
          for (int d = 0; d < NMAX; ++d) {
            if (d < n) {
              const float c = measure == 1 ? __fsub_rn(cr[d], mean) : cr[d];
              z = __fadd_rn(z, __fmul_rn(qr[d], c));
              cn = __fadd_rn(cn, __fmul_rn(c, c));
            }
          }
          best.offer(repro::dense_epilogue(z, qnorm, cn, measure), id);
        }
      }
    }
  }
  repro::warp_merge(best, k, out_v + (size_t)qi * k, out_i + (size_t)qi * k);
}

template <int NMAX, int KMAX, typename T>
cudaError_t launch(const void* q, const void* probe, const void* lists,
                   const void* rows, const void* scale, const void* fill,
                   const void* self_ids, const void* probe_ok, void* vals,
                   void* ids, int B, int nprobe, int cap, int n, int k,
                   int measure, cudaStream_t stream) {
  const dim3 grid((B + kWarps - 1) / kWarps);
  probe_kernel<NMAX, KMAX, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const int*>(probe),
      static_cast<const int*>(lists), static_cast<const T*>(rows),
      static_cast<const float*>(scale), static_cast<const int*>(fill),
      static_cast<const int*>(self_ids), static_cast<const int*>(probe_ok),
      static_cast<float*>(vals), static_cast<int*>(ids), B, nprobe, cap, n, k,
      measure);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* probe, const void* lists,
                     const void* rows, const void* scale, const void* fill,
                     const void* self_ids, const void* probe_ok, void* vals,
                     void* ids, int B, int nprobe, int cap, int n, int k,
                     int measure, cudaStream_t s) {
  if (n <= 32 && k <= 16)
    return launch<32, 16, T>(q, probe, lists, rows, scale, fill, self_ids,
                             probe_ok, vals, ids, B, nprobe, cap, n, k,
                             measure, s);
  if (n <= 32)
    return launch<32, 32, T>(q, probe, lists, rows, scale, fill, self_ids,
                             probe_ok, vals, ids, B, nprobe, cap, n, k,
                             measure, s);
  if (k <= 16)
    return launch<64, 16, T>(q, probe, lists, rows, scale, fill, self_ids,
                             probe_ok, vals, ids, B, nprobe, cap, n, k,
                             measure, s);
  return launch<64, 32, T>(q, probe, lists, rows, scale, fill, self_ids,
                           probe_ok, vals, ids, B, nprobe, cap, n, k, measure,
                           s);
}

}  // namespace

// payload: 0 = f32 rows, 1 = bf16 rows, 2 = int8 rows with f32 scales.
extern "C" int ivf_probe_f32(const void* q, const void* probe,
                             const void* lists, const void* rows,
                             const void* scale, const void* fill,
                             const void* self_ids, const void* probe_ok,
                             void* vals, void* ids, int B, int nprobe,
                             int cap, int n, int k, int measure, int payload,
                             void* stream) {
  if (B <= 0 || nprobe <= 0 || cap <= 0 || n <= 0 || n > 64 || k <= 0 ||
      k > 32 || measure < 0 || measure > 2 || payload < 0 || payload > 2 ||
      (payload == 2) != (scale != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (payload == 0)
    return static_cast<int>(dispatch<float>(q, probe, lists, rows, scale,
                                            fill, self_ids, probe_ok, vals,
                                            ids, B, nprobe, cap, n, k,
                                            measure, s));
  if (payload == 1)
    return static_cast<int>(dispatch<__nv_bfloat16>(
        q, probe, lists, rows, scale, fill, self_ids, probe_ok, vals, ids, B,
        nprobe, cap, n, k, measure, s));
  return static_cast<int>(dispatch<int8_t>(q, probe, lists, rows, scale,
                                           fill, self_ids, probe_ok, vals,
                                           ids, B, nprobe, cap, n, k, measure,
                                           s));
}
