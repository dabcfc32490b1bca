// Per-query gathered-candidate scorer for Hopper, f32 on CUDA cores.
//
// Replaces the TPU kernel src/repro/retrieval/index.py
// score_candidates_kernel (body _score_kernel, algebra _gathered_sims):
// (b, n) queries against their own gathered (b, m, n) candidate rows ->
// (b, m) d2 scores, a multiply-reduce with the dense_similarity epilogue.
// It serves the IVF search at nprobe < C with scorer="kernel". Its shared
// form scores every query against one (m, n) candidate block (the
// back-patch of the fold-ins: each existing row against the new batch).
//
// What bounds it on an H100: every candidate row is read once and every
// score written once — 4·b·m·(n+1) bytes against 2·b·m·n FLOPs, 0.45 FLOP
// per byte, so device memory bounds it (at the partial-probe block
// b = 256, m = 1976, n = 20: 42 MB, ~13 µs).
//
// Design: one block of 128 threads takes 128 candidates of one query
// (grid: queries × candidate blocks). The block stages its 128 rows, which
// are contiguous in memory, into shared memory with coalesced loads (odd
// row stride, conflict-free), and the query row beside them; each thread
// then scores one candidate with the f32 left-to-right sums and the IEEE
// epilogue of repro::dense_epilogue (pearson centers both rows first), the
// order of the plain version (kernels/ref.py::gathered_sims), so the two
// agree bitwise. Scores are written coalesced. n <= 104: the staged rows
// take up to 54 KB of dynamic shared memory. In the shared form every
// block stages its candidates from the same (m, n) block, which L2 holds.
#include <cuda_runtime.h>
#include <math.h>

#include "topk_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kNMax = 104;
// the staged rows (odd stride) and the query row, at the widest rows
constexpr int kSmemMax = sizeof(float) * (kThreads * (kNMax + 1) + kNMax);

__global__ void __launch_bounds__(kThreads)
score_kernel(const float* __restrict__ q, const float* __restrict__ cand,
             float* __restrict__ out, int M, int n, int measure,
             int shared) {
  extern __shared__ float smem[];
  const int stride = n | 1;
  float* rows = smem;                  // [kThreads][stride]
  float* qs = smem + kThreads * stride;  // [n]
  const int qi = blockIdx.x;
  const int c0 = blockIdx.y * kThreads;
  const int rn = min(kThreads, M - c0);
  const float* src = cand + ((shared ? 0 : (size_t)qi * M) + c0) * n;
  for (int e = threadIdx.x; e < rn * n; e += kThreads) {
    const int r = e / n, d = e - r * n;
    rows[r * stride + d] = src[e];
  }
  if (threadIdx.x < n) qs[threadIdx.x] = q[(size_t)qi * n + threadIdx.x];
  __syncthreads();
  if (threadIdx.x >= rn) return;

  // the query row's statistics, recomputed by every thread from shared
  // memory (n <= 104 adds; cheaper than another barrier)
  const float qmean = measure == 1 ? repro::row_mean<kNMax>(qs, n) : 0.0f;
  const float* cr = rows + threadIdx.x * stride;
  const float cmean = measure == 1 ? repro::row_mean<kNMax>(cr, n) : 0.0f;
  float z = 0.0f, qn = 0.0f, cn = 0.0f;
  for (int d = 0; d < n; ++d) {
    const float a = measure == 1 ? __fsub_rn(qs[d], qmean) : qs[d];
    const float c = measure == 1 ? __fsub_rn(cr[d], cmean) : cr[d];
    z = __fadd_rn(z, __fmul_rn(a, c));
    qn = __fadd_rn(qn, __fmul_rn(a, a));
    cn = __fadd_rn(cn, __fmul_rn(c, c));
  }
  out[(size_t)qi * M + c0 + threadIdx.x] =
      repro::dense_epilogue(z, qn, cn, measure);
}

}  // namespace

extern "C" int score_candidates_f32(const void* q, const void* cand,
                                    void* out, int B, int M, int n,
                                    int measure, int shared, void* stream) {
  const int m_blocks = (M + kThreads - 1) / kThreads;
  if (B <= 0 || M <= 0 || n <= 0 || n > kNMax || measure < 0 || measure > 2 ||
      m_blocks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = sizeof(float) * (kThreads * (n | 1) + n);
  if (smem > 48 * 1024) {  // past the default limit, on this device
    const cudaError_t err = cudaFuncSetAttribute(
        score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B, m_blocks);
  score_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(cand),
      static_cast<float*>(out), M, n, measure, shared);
  return static_cast<int>(cudaGetLastError());
}
