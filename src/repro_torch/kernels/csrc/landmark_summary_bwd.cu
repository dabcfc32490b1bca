// Backward of the landmark summary O = softmax(Q̃ Kᵀ · scale) V for Hopper:
// (dQ, dK, dV) from (Q, K, V, O, dO), f32 math and outputs, bf16 or f32
// inputs.
//
// Replaces no TPU kernel: the reference trains landmark attention by
// autodiff through plain jnp (src/repro/models/layers.py landmark_attention)
// and has no custom_vjp anywhere. The port runs the forward through the
// hand-written kernel of landmark_summary.cu (which replaces
// src/repro/kernels/landmark_attention.py landmark_summary_kernel), so its
// gradient needs a kernel too: this one, behind
// kernels/landmark_attention.py::LandmarkSummary.
//
// What it computes, for each of P problems (q (n, D), k and v (S, D)):
//   P  = softmax(q kᵀ · scale)             (recomputed, never stored)
//   Δᵢ = Σ_d dOᵢ_d · Oᵢ_d
//   dV = Pᵀ dO,  dS = P ∘ (dO Vᵀ − Δ),  dQ = scale · dS K,  dK = scale · dSᵀ q
// exactly what kernels/ref.py::landmark_summary_bwd_ref computes.
//
// What bounds it on an H100 (chip_smoke.py::_bwd_bound): five products of
// 2·n·S·D a problem (q kᵀ, dO Vᵀ, Pᵀ dO, dS K, dSᵀ q), 0.0204 ms a batch
// row at SmolLM-360M's landmark shape (P = 5, n = 1536, S = 4096, D = 64)
// at the bf16 tensor-core rate; the bytes (inputs once, f32 outputs once)
// take a tenth of that.
//
// The design, simple and deterministic (no atomics; two launches of the
// same inputs give the same bits), the flash-attention-2 split in two
// passes, each a loop of scalar f32 FMAs over tiles in shared memory:
// - pass 1 (bwd_dq_kernel), a block per BQ query rows of one problem: Δ
//   from O and dO, then one sweep over the key tiles with a running row max
//   m and denominator l (the forward's online softmax) accumulating
//   dQ = Σ_j 2^(s_ij·c − m)·(dP_ij − Δᵢ)·K_j in registers, rescaled by
//   2^(m_old − m_new) as m grows, and divided by l at the end; it writes
//   each row's log-sum-exp (in log2 units, m + log2 l) and Δ for pass 2;
// - pass 2 (bwd_dkv_kernel), a block per BK keys of one problem: its K and
//   V tiles stay in shared memory while it loops over every query tile,
//   recomputes P = 2^(s·c − lse) and dS, and accumulates dV = Pᵀ dO and
//   dK = dSᵀ q in registers.
// The row statistics are recomputed here rather than saved by the forward,
// so the forward kernel stays as it was measured. Pass 1 does three
// products and pass 2 four, seven in all against the bound's five.
//
// Tiles: 256 threads as a 16 × 16 grid; a thread owns the rows
// ty + 16·a and the columns tx + 16·b of each product, so the 16 threads of
// a row are one half-warp and reduce by shuffles (a butterfly: every lane
// ends with the same bits). Rows of D floats are padded to D + 1 words and
// score tiles to BK + 16, so the reads of a half-warp fall in distinct
// banks. BQ = BK = 64 up to D = 128 (pass 2 at D = 128: 174 KB of shared
// memory), 32 at D = 256. Keys at or past S are masked (score −inf in pass
// 1; their rows of dK and dV are not written), queries at or past n read
// as zero and take P = 0 in pass 2 (lse = +inf): nothing is padded into the
// softmax.
//
// Precision: scalar f32 FMAs on the f32 values of the inputs (no tensor
// cores), exp2f of scores scaled once by c = scale·log2(e); the sums run in
// another order than the plain version's, so the bound against it is
// relative: within 1e-4 of each gradient's largest |value|
// (chip_smoke.py::BWD_REL; an H100 gave at most 3.5e-6 at every phase-16a
// shape).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_smem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

template <int D> struct BwdTiles {
  static constexpr int BQ = D == 256 ? 32 : 64;  // query rows a tile
  static constexpr int BK = BQ;                  // keys a tile
  static constexpr int LD = D + 1;               // padded row of D floats
  static constexpr int LDS = BK + 16;            // padded score row
  static constexpr int TM = BQ / 16, TN = BK / 16, TD = D / 16;
  // pass 1: Q, dO, K, V tiles and the dS tile
  static constexpr int SMEM1 =
      (2 * BQ * LD + 2 * BK * LD + BQ * LDS) * int(sizeof(float));
  // pass 2: K, V, Q, dO tiles, P and dS tiles, lse and Δ of the query tile
  static constexpr int SMEM2 =
      (2 * BK * LD + 2 * BQ * LD + 2 * BQ * LDS + 2 * BQ) * int(sizeof(float));
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// rows [r0, r0 + ROWS) of a (rows, D) matrix into a padded f32 tile; rows
// at or past `rows` read as zero
template <int D, int ROWS, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int r0, int rows) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < ROWS * D; e += kThreads) {
    const int r = e / D, col = e % D;
    const int g = r0 + r;
    dst[r * LD + col] =
        g < rows ? to_f32(src[static_cast<size_t>(g) * D + col]) : 0.0f;
  }
}

// a butterfly over the 16 lanes of a half-warp: every lane gets the same
// bits
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// pass 1: dQ, and each query row's lse (log2 units) and Δ
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ dout, float* __restrict__ dq,
                  float* __restrict__ lse, float* __restrict__ delta, int N,
                  int S, float c, float scale) {
  using L = BwdTiles<D>;
  constexpr int BQ = L::BQ, BK = L::BK, LD = L::LD, LDS = L::LDS;
  constexpr int TM = L::TM, TN = L::TN, TD = L::TD;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BQ * LD;
  float* ks = dos + BQ * LD;
  float* vs = ks + BK * LD;
  float* ss = vs + BK * LD;  // dS tile (BQ, BK)

  const int prob = blockIdx.y, q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qoff = static_cast<size_t>(prob) * N * D;
  const size_t koff = static_cast<size_t>(prob) * S * D;

  load_rows<D, BQ>(qs, q + qoff, q0, N);
  load_rows<D, BQ>(dos, dout + qoff, q0, N);
  __syncthreads();

  float dlt[TM], m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int r = ty + 16 * a;
    float s = 0.0f;
    if (q0 + r < N) {
      const float* orow = o + qoff + static_cast<size_t>(q0 + r) * D;
#pragma unroll
      for (int b = 0; b < TD; ++b) {
        const int d = tx + 16 * b;
        s = fmaf(dos[r * LD + d], orow[d], s);
      }
    }
    dlt[a] = half_warp_sum(s);
    m[a] = -INFINITY;
    l[a] = 0.0f;
#pragma unroll
    for (int b = 0; b < TD; ++b) acc[a][b] = 0.0f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the last tile's K, V and dS are read
    load_rows<D, BK>(ks, k + koff, k0, S);
    load_rows<D, BK>(vs, v + koff, k0, S);
    __syncthreads();
    float s[TM][TN], dp[TM][TN];
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b) s[a][b] = dp[a][b] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qa[TM], da[TM], kb[TN], vb[TN];
#pragma unroll
      for (int a = 0; a < TM; ++a) {
        qa[a] = qs[(ty + 16 * a) * LD + d];
        da[a] = dos[(ty + 16 * a) * LD + d];
      }
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        kb[b] = ks[(tx + 16 * b) * LD + d];
        vb[b] = vs[(tx + 16 * b) * LD + d];
      }
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) {
          s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
          dp[a][b] = fmaf(da[a], vb[b], dp[a][b]);
        }
    }
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      float mt = -INFINITY;
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        s[a][b] = k0 + tx + 16 * b < S ? s[a][b] * c : -INFINITY;
        mt = fmaxf(mt, s[a][b]);
      }
      // the tile holds key k0 < S, so the new max is finite
      const float m_new = fmaxf(m[a], half_warp_max(mt));
      const float alpha = m[a] == -INFINITY ? 0.0f : exp2f(m[a] - m_new);
      float ls = 0.0f;
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        const float p = exp2f(s[a][b] - m_new);
        ls += p;
        ss[(ty + 16 * a) * LDS + tx + 16 * b] = p * (dp[a][b] - dlt[a]);
      }
      l[a] = l[a] * alpha + half_warp_sum(ls);
      m[a] = m_new;
#pragma unroll
      for (int b = 0; b < TD; ++b) acc[a][b] *= alpha;
    }
    __syncthreads();
    for (int j = 0; j < BK; ++j) {  // acc += dS · K
      float sa[TM], kb[TD];
#pragma unroll
      for (int a = 0; a < TM; ++a) sa[a] = ss[(ty + 16 * a) * LDS + j];
#pragma unroll
      for (int b = 0; b < TD; ++b) kb[b] = ks[j * LD + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TD; ++b) acc[a][b] = fmaf(sa[a], kb[b], acc[a][b]);
    }
  }

#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int r = q0 + ty + 16 * a;
    if (r >= N) continue;
    const float inv = scale / l[a];
    float* row = dq + qoff + static_cast<size_t>(r) * D;
#pragma unroll
    for (int b = 0; b < TD; ++b) row[tx + 16 * b] = acc[a][b] * inv;
    if (tx == 0) {
      lse[static_cast<size_t>(prob) * N + r] = m[a] + log2f(l[a]);
      delta[static_cast<size_t>(prob) * N + r] = dlt[a];
    }
  }
}

// pass 2: dK and dV of BK keys, over every query tile
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int N, int S, float c,
                   float scale) {
  using L = BwdTiles<D>;
  constexpr int BQ = L::BQ, BK = L::BK, LD = L::LD, LDS = L::LDS;
  constexpr int TM = L::TM, TN = L::TN, TD = L::TD;
  constexpr int TK = BK / 16;  // key rows a thread accumulates
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BK * LD;
  float* qs = vs + BK * LD;
  float* dos = qs + BQ * LD;
  float* ps = dos + BQ * LD;  // P tile (BQ, BK)
  float* dss = ps + BQ * LDS;  // dS tile (BQ, BK)
  float* lse_s = dss + BQ * LDS;
  float* dlt_s = lse_s + BQ;

  const int prob = blockIdx.y, k0 = blockIdx.x * BK;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qoff = static_cast<size_t>(prob) * N * D;
  const size_t koff = static_cast<size_t>(prob) * S * D;
  const size_t roff = static_cast<size_t>(prob) * N;

  load_rows<D, BK>(ks, k + koff, k0, S);
  load_rows<D, BK>(vs, v + koff, k0, S);

  float dka[TK][TD], dva[TK][TD];
#pragma unroll
  for (int a = 0; a < TK; ++a)
#pragma unroll
    for (int b = 0; b < TD; ++b) dka[a][b] = dva[a][b] = 0.0f;

  for (int q0 = 0; q0 < N; q0 += BQ) {
    __syncthreads();  // the last tile's Q, dO, P and dS are read
    load_rows<D, BQ>(qs, q + qoff, q0, N);
    load_rows<D, BQ>(dos, dout + qoff, q0, N);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const bool ok = q0 + r < N;  // rows past n take P = 2^-inf = 0
      lse_s[r] = ok ? lse[roff + q0 + r] : INFINITY;
      dlt_s[r] = ok ? delta[roff + q0 + r] : 0.0f;
    }
    __syncthreads();
    float s[TM][TN], dp[TM][TN];
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b) s[a][b] = dp[a][b] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qa[TM], da[TM], kb[TN], vb[TN];
#pragma unroll
      for (int a = 0; a < TM; ++a) {
        qa[a] = qs[(ty + 16 * a) * LD + d];
        da[a] = dos[(ty + 16 * a) * LD + d];
      }
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        kb[b] = ks[(tx + 16 * b) * LD + d];
        vb[b] = vs[(tx + 16 * b) * LD + d];
      }
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) {
          s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
          dp[a][b] = fmaf(da[a], vb[b], dp[a][b]);
        }
    }
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      const int r = ty + 16 * a;
      const float lr = lse_s[r], dr = dlt_s[r];
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        const float p = exp2f(s[a][b] * c - lr);
        ps[r * LDS + tx + 16 * b] = p;
        dss[r * LDS + tx + 16 * b] = p * (dp[a][b] - dr);
      }
    }
    __syncthreads();
    for (int i = 0; i < BQ; ++i) {  // dV += Pᵀ dO, dK += dSᵀ q
      float pa[TK], sa[TK], db[TD], qb[TD];
#pragma unroll
      for (int a = 0; a < TK; ++a) {
        pa[a] = ps[i * LDS + ty + 16 * a];
        sa[a] = dss[i * LDS + ty + 16 * a];
      }
#pragma unroll
      for (int b = 0; b < TD; ++b) {
        db[b] = dos[i * LD + tx + 16 * b];
        qb[b] = qs[i * LD + tx + 16 * b];
      }
#pragma unroll
      for (int a = 0; a < TK; ++a)
#pragma unroll
        for (int b = 0; b < TD; ++b) {
          dva[a][b] = fmaf(pa[a], db[b], dva[a][b]);
          dka[a][b] = fmaf(sa[a], qb[b], dka[a][b]);
        }
    }
  }

#pragma unroll
  for (int a = 0; a < TK; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= S) continue;
    float* krow = dk + koff + static_cast<size_t>(j) * D;
    float* vrow = dv + koff + static_cast<size_t>(j) * D;
#pragma unroll
    for (int b = 0; b < TD; ++b) {
      krow[tx + 16 * b] = dka[a][b] * scale;
      vrow[tx + 16 * b] = dva[a][b];
    }
  }
}

template <int D, typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, void* dq, void* dk, void* dv, void* lse,
               void* delta, int P, int N, int S, float scale,
               cudaStream_t stream) {
  using L = BwdTiles<D>;
  static size_t sized1[repro::kMaxDevices] = {};  // the >48 KB opt-ins
  static size_t sized2[repro::kMaxDevices] = {};
  cudaError_t err = repro::allow_smem(bwd_dq_kernel<D, T>, L::SMEM1, sized1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = repro::allow_smem(bwd_dkv_kernel<D, T>, L::SMEM2, sized2);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float c = scale * kLog2e;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* dot = static_cast<const float*>(dout);
  bwd_dq_kernel<D, T><<<dim3((N + L::BQ - 1) / L::BQ, P), kThreads, L::SMEM1,
                        stream>>>(qt, kt, vt, static_cast<const float*>(o), dot,
                                  static_cast<float*>(dq),
                                  static_cast<float*>(lse),
                                  static_cast<float*>(delta), N, S, c, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkv_kernel<D, T><<<dim3((S + L::BK - 1) / L::BK, P), kThreads, L::SMEM2,
                         stream>>>(qt, kt, vt, dot,
                                   static_cast<const float*>(lse),
                                   static_cast<const float*>(delta),
                                   static_cast<float*>(dk),
                                   static_cast<float*>(dv), N, S, c, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* delta, int P, int N, int S, int D, float scale,
           void* stream) {
  if (P <= 0 || N <= 0 || S <= 0 || P > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_bwd<32, T>(q, k, v, o, dout, dq, dk, dv, lse, delta, P, N,
                               S, scale, st);
    case 64:
      return launch_bwd<64, T>(q, k, v, o, dout, dq, dk, dv, lse, delta, P, N,
                               S, scale, st);
    case 128:
      return launch_bwd<128, T>(q, k, v, o, dout, dq, dk, dv, lse, delta, P,
                                N, S, scale, st);
    case 256:
      return launch_bwd<256, T>(q, k, v, o, dout, dq, dk, dv, lse, delta, P,
                                N, S, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (P, N, D), k and v (P, S, D) of one dtype; o and dout (P, N, D) f32 →
// dq (P, N, D), dk and dv (P, S, D) f32; lse and delta (P, N) f32 scratch
// written by pass 1 and read by pass 2. Two launches.
extern "C" int landmark_summary_bwd_bf16(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* dout, void* dq, void* dk,
                                         void* dv, void* lse, void* delta,
                                         int P, int N, int S, int D,
                                         float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, delta, P, N,
                               S, D, scale, stream);
}

extern "C" int landmark_summary_bwd_f32(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, void* dq, void* dk,
                                        void* dv, void* lse, void* delta,
                                        int P, int N, int S, int D,
                                        float scale, void* stream) {
  return launch<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, P, N, S, D,
                       scale, stream);
}
