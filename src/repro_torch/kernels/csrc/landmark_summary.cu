// Landmark summary softmax(Q̃ Kᵀ · scale) V for Hopper, f32 on CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/landmark_attention.py
// landmark_summary_kernel (body _kernel): the B̃V term of landmark
// (Nyström) attention, streamed over the sequence with flash-style running
// (max m, denominator z, accumulator acc) so the (n, S) score matrix never
// exists. Inputs are bf16 or f32, upcast to f32 on load; all arithmetic
// and the (n, D) output are f32.
//
// Batched: problem p is the stacked (N, D) landmark queries of one
// (batch, kv-head) against that head's (S, D) keys and values, so one
// launch per layer serves every (batch, kv-head) and each K/V tile is read
// from device memory once per query tile.
//
// What bounds it on an H100: at the landmark-attention shape of
// SmolLM-360M (P = 2·5 problems of N = 3·512 queries, S = 4096, D = 64)
// the work is 4·N·S·D = 1.6 GFLOP per problem (16 GFLOP a launch, ~0.24 ms
// at the f32 peak) against ~13 MB of bf16 inputs (~4 µs): operations bound
// it by far. The design keeps every operand of the two products in shared
// memory and registers, so only the f32 issue rate and shared-memory
// bandwidth set its time.
//
// Design (simple first; wgmma/TMA are a later change):
// - a block of 256 threads owns 64 query rows of one problem, held in
//   shared memory for the whole sequence; K and V tiles of 64 keys are
//   staged in shared memory one after the other;
// - scores: each thread computes a 4×4 register tile (rows ty+16i, keys
//   tx+16j), then writes dot·scale (in that order) to a shared score tile;
//   keys at or past S are masked to -inf, so any S works;
// - softmax: one warp per 8 rows takes the tile's row max with shuffles,
//   m_new = max(m_old, tile max), p = exp(s − m_new) in place, and the row
//   sum; alpha = exp(m_old − m_new), or 0 while m_old is −inf (the first
//   tile), rescales z and acc, as the reference's recurrence;
// - PV: each thread keeps a 4 × D/16 accumulator in registers (rows
//   ty+16i, columns tx+16c) and adds p·v over the tile's keys;
// - epilogue: out = acc / max(z, 1e-30).
// Head dims D ∈ {32, 64, 128, 256}; the wrapper rejects others.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 × 16
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // q tile and k tile at an odd row stride (conflict-free column reads),
  // v tile, score tile, and m / z / alpha per row
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) +
                          (size_t)kBK * D + (size_t)kBQ * (kBK + 1) +
                          3 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
summary_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, float* __restrict__ out, int N, int S,
               float scale) {
  extern __shared__ float smem[];
  constexpr int QS = D + 1;
  constexpr int PS = kBK + 1;
  constexpr int DC = D / 16;  // accumulator columns per thread
  float* qs = smem;            // kBQ × QS
  float* ks = qs + kBQ * QS;   // kBK × QS
  float* vs = ks + kBK * QS;   // kBK × D
  float* ps = vs + kBK * D;    // kBQ × PS scores, then probabilities
  float* m_s = ps + kBQ * PS;  // running max per row
  float* z_s = m_s + kBQ;      // running denominator per row
  float* a_s = z_s + kBQ;      // this tile's alpha per row

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kBQ;
  const size_t prob = blockIdx.y;
  const T* qp = q + prob * N * D;
  const T* kp = k + prob * S * D;
  const T* vp = v + prob * S * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    qs[r * QS + d] =
        row0 + r < N ? to_f32(qp[(size_t)(row0 + r) * D + d]) : 0.0f;
  }
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    z_s[tid] = 0.0f;
  }
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      const bool ok = k0 + r < S;
      const size_t off = (size_t)(k0 + r) * D + d;
      ks[r * QS + d] = ok ? to_f32(kp[off]) : 0.0f;
      vs[r * D + d] = ok ? to_f32(vp[off]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        ps[(ty + 16 * i) * PS + key] =
            k0 + key < S ? s[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    for (int rr = 0; rr < kBQ / (kThreads / 32); ++rr) {
      const int r = warp * (kBQ / (kThreads / 32)) + rr;
      float* pr = ps + r * PS;
      const float x0 = pr[lane], x1 = pr[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);  // finite: key k0 < S is live
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(kFull, sum, off);
      }
      __syncwarp();  // every lane has read m_s[r] before lane 0 writes it
      if (lane == 0) {
        const float alpha = isfinite(m_old) ? expf(m_old - m_new) : 0.0f;
        m_s[r] = m_new;
        z_s[r] = z_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pa[4], vb[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ps[(ty + 16 * i) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vb[c] = vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pa[i], vb[c], acc[i][c]);
      }
    }
  }

  float* op = out + prob * N * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (row0 + r >= N) continue;
    const float z = fmaxf(z_s[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      op[(size_t)(row0 + r) * D + tx + 16 * c] = acc[i][c] / z;
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int P,
           int N, int S, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool ready = false;  // the >48 KB opt-in, once per instantiation
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        summary_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const dim3 grid((N + kBQ - 1) / kBQ, P);
  summary_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(out), N, S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int P,
             int N, int S, int D, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, P, N, S, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, P, N, S, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, P, N, S, scale, stream);
    case 256: return launch<T, 256>(q, k, v, out, P, N, S, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32 inputs, 1 = bfloat16 inputs; out is float32.
extern "C" int landmark_summary(const void* q, const void* k, const void* v,
                                void* out, int P, int N, int S, int D,
                                int dtype, float scale, void* stream) {
  if (P <= 0 || N <= 0 || S <= 0 || P > 65535 || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? dispatch<float>(q, k, v, out, P, N, S, D, scale, s)
             : dispatch<__nv_bfloat16>(q, k, v, out, P, N, S, D, scale, s);
}
