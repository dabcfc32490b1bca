// Backward of the landmark summary O = softmax(Q̃ Kᵀ · scale) V for Hopper:
// (dQ, dK, dV) from (Q, K, V, O, dO), f32 outputs, bf16 or f32 inputs.
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
// 2·n·S·D a problem (q kᵀ, dO Vᵀ, Pᵀ dO, dS K, dSᵀ q), 0.163 ms at the
// training shape of SmolLM-360M (P = 40, n = 1536, S = 4096, D = 64) at the
// bf16 tensor-core rate; the bytes (inputs once, f32 outputs once) take a
// tenth of that. Operations bound it, on the tensor cores.
//
// Every route is the flash-attention-2 backward in two passes, with no
// atomics (two launches of the same inputs give the same bits):
// - pass 1, a block per query tile of one problem: Δ from O and dO, then
//   one sweep over the key tiles with the forward's online softmax (a
//   running row max m and denominator l in log2 units, scores times
//   c = scale·log2(e)) accumulating dQ = Σ_j 2^(s_ij·c − m)·(dP_ij − Δᵢ)·K_j,
//   rescaled by 2^(m_old − m_new) as m grows and divided by l at the end;
//   it writes each row's log-sum-exp lse = m + log2 l and Δ for pass 2;
// - pass 2, a block per key tile of one problem: its K and V stay on chip
//   while it sweeps every query tile, recomputes P = 2^(s·c − lse) and dS,
//   and accumulates dV = Pᵀ dO and dK = dSᵀ q in registers.
// The row statistics are recomputed rather than saved by the forward, so
// the forward kernel stays as it was measured (pass 1 needs q kᵀ for dQ
// anyway). Keys at or past S are masked (score −inf in pass 1; their rows
// of dK and dV are not written); queries at or past n take P = 0 in pass 2
// (lse = +inf): nothing padded enters a softmax.
//
// Tensor-core routes (D ∈ {32, 64, 128}: bwd_dq_wgmma_kernel<D, F32>, then
// bwd_dkv_wgmma_kernel<D, F32>), the forward's TMA + wgmma loop turned to
// the backward, one template for both forms of the inputs. A producer warp
// streams tiles by TMA (3-D tensor maps (D, rows, terms·P), 128-byte
// swizzle, 64-byte at D = 32) through a ring of shared-memory stages with
// full/empty mbarriers; consumer warpgroups of 64 rows run wgmma with f32
// accumulators in registers. Every operand is a sum of bf16 planes, from
// the split pass split_bf16_terms (landmark_summary.cu) that the wrapper
// runs first: dO always as two, hi = bf16(dO) and lo = bf16(dO − hi);
// bf16 q, k, v as they are (one plane each, F32 = false, `tensor_core`);
// f32 q and k as three planes and v as two, x0 = bf16(x),
// x1 = bf16(x − x0), x2 = bf16(x − x0 − x1) (F32 = true, `f32_split`,
// four split passes a call). P and dS are split into hi and lo in
// registers, in the f32 accumulator layout, which is the register
// A-fragment layout of a 16-bit operand (the forward's p_hi/p_lo trick).
// - pass 1 (a consumer warpgroup owns 64 query rows; the Q planes and both
//   dO planes stay in shared memory, the K and V planes stream): S = Σ q_a
//   k_bᵀ over a + b < terms, the small products first and q0 k0 last
//   (q2k0, q1k1, q0k2, q1k0, q0k1, q0k0, as the forward's f32 loop issues
//   them); dP = dO_lo V0ᵀ (+ dO_hi V1ᵀ) + dO_hi V0ᵀ; the online softmax in
//   registers as in the forward (four threads share a row and take its max
//   by shuffles); dS = 2^(s·c − m)·(dP − Δ) split into ds_hi and ds_lo;
//   dQ += ds_hi K0 + ds_lo K0 (+ ds_hi K1), K read as the MN-major B
//   operand. bf16: 1 + 2 + 2 = 5 products; f32: 6 + 3 + 3 = 12.
// - pass 2 (a consumer warpgroup owns 64 keys; the K and V planes stay,
//   the Q planes, both dO planes and the tile's lse and Δ (cp.async.bulk)
//   stream): Sᵀ = Σ k_b q_aᵀ in the same order, dPᵀ = V0 dO_loᵀ
//   (+ V1 dO_hiᵀ) + V0 dO_hiᵀ, Pᵀ = 2^(sᵀ·c − lse) and dSᵀ = Pᵀ∘(dPᵀ − Δ)
//   each split in two; dV += p_hi dO_hi + p_hi dO_lo + p_lo dO_hi
//   (p_lo·dO_lo is ~2^-16 of the sum and dropped) and dK += ds_hi q0 +
//   ds_lo q0 (+ ds_hi q1), dO and q read as MN-major B operands.
//   bf16: 1 + 2 + 3 + 2 = 8 products; f32: 6 + 3 + 3 + 3 = 15.
// 13 bf16 products of 2·n·S·D in all on bf16 inputs, 27 on f32 inputs,
// against the bound's 5; 27 at the bf16 peak take 0.88 ms at the training
// shape.
// Why the terms: the bound against the plain version is 1e-4 of each
// gradient's largest |value| (chip_smoke.py::BWD_REL). On bf16 inputs, one
// bf16 term of P and dS gives 1.0e-3 to 4.1e-3 of it on normal inputs at
// (P, n, S, D) = (3, 70, 777, 64), (2, 256, 4096, 64), (2, 100, 300, 128),
// one term of dO 0.9e-3 to 2.4e-3 — 10–40× the bound; two terms of each
// give 2.2e-6 to 1.0e-5, 2–10% of it (kernels/ref.py::
// landmark_summary_bwd_split_ref). On f32 inputs the 27 products give
// 7.4e-6 to 1.5e-5 of each gradient's max |value| against an f64 oracle,
// 7–15% of the bound, at (n, S, D) = (70, 777, 64), (256, 2048, 64),
// (100, 300, 128) and at 4× scaled q and k (128, 1024, 64); leaving out
// K1 in dQ or q1 in dK gives 1.8e-3 to 2.6e-3, leaving out V1 in dP and
// dPᵀ 1.5e-3 to 5.5e-3, 15–55× the bound, so each second term stays
// (kernels/ref.py::landmark_summary_bwd_f32_split_ref, tests/
// test_torch_landmark_bwd_f32.py). The third terms of q and k enter only
// the scores, as in the forward.
// Tile sums (f32 form): a wgmma adds its products into the f32
// accumulator it is given, and over a long chain of them that sum comes
// out less exact than rounded f32 adds: a first version of the f32 form
// that ran dQ through one chain of 768 wgmma (pass 1, S = 4096) and dK, dV
// through 288 (pass 2, n = 1536) matched its plain-torch emulation on
// random inputs, but on the inputs of phase 16d's model its step-1
// gradients failed chip_smoke.py's rule (2× the plain pair's reversed-keys
// floor) in every group, where the emulation passed. So on f32 inputs each
// tile's products go into a fresh accumulator (12 wgmma a tile at D = 64),
// added to dQ (as acc·alpha + tile, one FMA), dK and dV in f32: the
// gradients then match the emulation's, inside the rule
// (tools/landmark_bwd_grad_error.py prints the breakdown). It costs D/2
// registers a thread, no spill. The bf16 form keeps its one chain, as it
// was measured: its two-term inputs and products bound it well above that.
// Tiles (TcTiles below): a 288-thread block (two consumer warpgroups and
// the producer warp) has 168 registers a thread, enough at D ≤ 64; at
// D = 128 one consumer warpgroup (160 threads, up to 255 registers) holds
// dK and dV, 128 registers together, beside the score tiles. The f32
// planes take 2.5× the bf16 route's shared memory: 5 planes of the
// resident tile and 5 of each stage, so at D = 64 pass 1 keeps 128 query
// rows (80 KB) and streams three 64-key stages (40 KB each), pass 2 keeps
// 128 keys (80 KB) and streams three 64-row stages (41 KB with lse and Δ);
// at D = 128 pass 1 streams 32-key stages and pass 2 32-row stages (m64n32
// score tiles, dK and dV over two k16 steps a stage). Every form stays
// under 227 KB.
//
// FMA route (D = 256, bf16 and f32 inputs: bwd_dq_kernel, then
// bwd_dkv_kernel): at D = 256 dK and dV alone would take 256 registers a
// thread on the tensor cores, more than a thread has, so the same two
// passes run as loops of scalar f32 FMAs over tiles in shared memory. 256
// threads as a 16 × 16 grid; a thread owns the rows ty + 16·a and the
// columns tx + 16·b of each product, so the 16 threads of a row are one
// half-warp and reduce by shuffles (a butterfly: every lane ends with the
// same bits). Rows of D floats are padded to D + 1 words and score tiles
// to BK + 16, so the reads of a half-warp fall in distinct banks;
// BQ = BK = 32. Pass 1 does three products and pass 2 four, on the f32
// values of the inputs: the sums run in another order than the plain
// version's, and shared-memory loads (16 for 32 FMAs) bound it.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_smem.cuh"
#include "sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------- FMA route
constexpr int kThreads = 256;

template <int D> struct BwdTiles {
  static_assert(D == 256, "the FMA route runs D = 256 only");
  static constexpr int BQ = 32;                  // query rows a tile
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

// ------------------------------------------------------ tensor-core route
using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::pack_bf16;
using repro::pin;
using repro::sm90_desc;
using repro::smem_addr;

// Tiles per head dim and form of the inputs (F32: f32 inputs as 3/3/2
// bf16 planes of q/k/v): pass 1 has WG1 consumer warpgroups of 64 query
// rows and streams key tiles of BK1 keys through ST1 stages; pass 2 has WG2
// consumer warpgroups of 64 keys and streams query tiles of BQ2 rows
// through ST2 stages. Queries are padded to ROW_PAD rows in the lse and Δ
// scratch, a multiple of every query tile.
template <int D, bool F32> struct TcTiles;
template <> struct TcTiles<32, false> {
  static constexpr int WG1 = 2, BK1 = 64, ST1 = 4, WG2 = 2, BQ2 = 64, ST2 = 4;
};
template <> struct TcTiles<64, false> {
  static constexpr int WG1 = 2, BK1 = 64, ST1 = 4, WG2 = 2, BQ2 = 64, ST2 = 3;
};
template <> struct TcTiles<128, false> {
  static constexpr int WG1 = 1, BK1 = 64, ST1 = 3, WG2 = 1, BQ2 = 64, ST2 = 3;
};
template <> struct TcTiles<32, true> {
  static constexpr int WG1 = 2, BK1 = 64, ST1 = 4, WG2 = 2, BQ2 = 64, ST2 = 4;
};
template <> struct TcTiles<64, true> {
  static constexpr int WG1 = 2, BK1 = 64, ST1 = 3, WG2 = 2, BQ2 = 64, ST2 = 3;
};
template <> struct TcTiles<128, true> {
  static constexpr int WG1 = 1, BK1 = 32, ST1 = 3, WG2 = 1, BQ2 = 32, ST2 = 3;
};
constexpr int ROW_PAD = 128;
constexpr size_t SMEM_MAX = 227 * 1024;  // a block's shared memory, bytes

// the swizzled shared-memory rows of a head dim, as TMA writes them
template <int D>
struct Swizzle {
  static constexpr int SW = D >= 64 ? 128 : 64;  // swizzle span, bytes
  static constexpr int AE = SW / 2;              // bf16 per swizzled row
  static constexpr uint32_t MODE = SW == 128 ? 1 : 2;  // descriptor swizzle
};

template <int D, bool F32>
struct TcLayout : Swizzle<D> {
  using T = TcTiles<D, F32>;
  static constexpr int QT = F32 ? 3 : 1;  // bf16 planes of q and of k
  static constexpr int VT = F32 ? 2 : 1;  // bf16 planes of v
  // pass 1: QT Q planes, dO hi, dO lo (BQ1 rows each), then ST1 stages of
  // QT K and VT V planes (BK1 rows each)
  static constexpr int BQ1 = 64 * T::WG1, BK1 = T::BK1, ST1 = T::ST1;
  static constexpr int THREADS1 = 128 * T::WG1 + 32;
  static constexpr int Q1_BYTES = BQ1 * D * 2, KV1_BYTES = BK1 * D * 2;
  static constexpr int STAGE1 = (QT + VT) * KV1_BYTES;
  static constexpr size_t SMEM1 =
      1024 + (QT + 2) * Q1_BYTES + static_cast<size_t>(ST1) * STAGE1;
  // pass 2: QT K and VT V planes (BK2 rows each), then ST2 stages of QT Q
  // planes, dO hi, dO lo (BQ2 rows each) and the rows' lse and Δ, padded
  // to 1024 bytes
  static constexpr int BK2 = 64 * T::WG2, BQ2 = T::BQ2, ST2 = T::ST2;
  static constexpr int THREADS2 = 128 * T::WG2 + 32;
  static constexpr int KV2_BYTES = BK2 * D * 2, Q2_BYTES = BQ2 * D * 2;
  static constexpr int STAT_BYTES = 2 * BQ2 * 4;
  static constexpr int STAGE2 = (QT + 2) * Q2_BYTES + 1024;
  static constexpr size_t SMEM2 =
      1024 + (QT + VT) * KV2_BYTES + static_cast<size_t>(ST2) * STAGE2;
  static_assert(ROW_PAD % BQ1 == 0 && ROW_PAD % BQ2 == 0, "row padding");
  static_assert(STAT_BYTES <= 1024, "lse and delta fit the stage's pad");
  // and the barriers' few static bytes
  static_assert(SMEM1 <= SMEM_MAX - 256 && SMEM2 <= SMEM_MAX - 256,
                "a block's shared memory");
};

// descriptor of the k16 step kk of a K-major operand: rows [r0, r0 + 64)
// (an A operand) or all rows (a B operand) of a TMA tile of `rows` rows,
// stored as D / AE column blocks of rows × SW bytes
template <int D>
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int rows, int r0,
                                            int kk) {
  using W = Swizzle<D>;
  const int cb = kk / (W::AE / 16), off = (kk % (W::AE / 16)) * 32;
  return sm90_desc(tile + (cb * rows + r0) * W::SW + off, 16, 8 * W::SW,
                   W::MODE);
}

// descriptor of the k16 step kc of an MN-major B operand: tile rows
// [16·kc, 16·kc + 16) down the reduction axis, all D columns
template <int D>
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int rows, int kc) {
  using W = Swizzle<D>;
  return sm90_desc(tile + kc * 16 * W::SW, rows * W::SW, 8 * W::SW, W::MODE);
}

// the low and high bf16 halves of a bf16x2 register, as floats
__device__ __forceinline__ float lo_f32(uint32_t h) {
  return __uint_as_float(h << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t h) {
  return __uint_as_float(h & 0xffff0000u);
}

// x (two f32) → hi = bf16(x), lo = bf16(x − hi); x − hi is exact
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - lo_f32(hi), b - hi_f32(hi));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// an m64nN f32 accumulator as hi and lo A fragments of k16 chunks: chunk kc
// takes accumulator blocks 2kc and 2kc + 1
template <int N>
__device__ __forceinline__ void fragments(const float (&x)[N / 2],
                                          uint32_t (&hi)[N / 16][4],
                                          uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      split_bf16(x[8 * kc + 2 * r], x[8 * kc + 2 * r + 1], hi[kc][r],
                 lo[kc][r]);
    }
  }
}

// acc (=) Σ a_i b_jᵀ over i + j < TERMS, the small products first and
// a_0 b_0 last: wgmma m64nN with both operands K-major in shared memory,
// plane i of A at a + i·A_PLANE (rows [r0, r0 + 64) of A_ROWS), plane j of
// B at b + j·B_PLANE (N rows)
template <int D, int N, int TERMS, int A_ROWS, int A_PLANE, int B_PLANE>
__device__ __forceinline__ void term_scores(float (&acc)[N / 2], uint32_t a,
                                            int r0, uint32_t b) {
#pragma unroll
  for (int sum = TERMS - 1; sum >= 0; --sum) {
#pragma unroll
    for (int i = sum; i >= 0; --i) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        repro::wgmma_ss<N>(acc, k_major<D>(a + i * A_PLANE, A_ROWS, r0, kk),
                           k_major<D>(b + (sum - i) * B_PLANE, N, 0, kk),
                           sum < TERMS - 1 || i < sum || kk > 0);
      }
    }
  }
}

// acc += Σ_kc ds_hi[kc] B0 + ds_lo[kc] B0 (+ ds_hi[kc] B1): the register
// A fragments of dS (m64 × ROWS) against the MN-major planes of a B tile
// of ROWS rows down the reduction axis (K in pass 1, q in pass 2), plane
// t at b + t·B_PLANE; one committed group, waited for
template <int D, int ROWS, int TERMS, int B_PLANE>
__device__ __forceinline__ void ds_products(float (&acc)[D / 2],
                                            uint32_t (&hi)[ROWS / 16][4],
                                            uint32_t (&lo)[ROWS / 16][4],
                                            uint32_t b) {
  pin(acc);
  pin(hi);
  pin(lo);
  repro::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < ROWS / 16; ++kc) {
    const uint64_t b0 = mn_major<D>(b, ROWS, kc);
    repro::wgmma_rs<D>(acc, hi[kc], b0);
    repro::wgmma_rs<D>(acc, lo[kc], b0);
    if constexpr (TERMS > 1) {
      repro::wgmma_rs<D>(acc, hi[kc], mn_major<D>(b + B_PLANE, ROWS, kc));
    }
  }
  repro::wgmma_commit();
  repro::wgmma_wait_all();
  pin(acc);
  pin(hi);
  pin(lo);
}

// pass 1: dQ, and each query row's lse (log2 units) and Δ for rows < NP
// (rows ≥ n: lse = +inf, Δ = 0)
template <int D, bool F32>
__global__ void __launch_bounds__(TcLayout<D, F32>::THREADS1, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap dmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const float* __restrict__ o,
                    const float* __restrict__ dout, float* __restrict__ dq,
                    float* __restrict__ lse, float* __restrict__ delta, int P,
                    int N, int NP, int S, float c, float scale) {
  using L = TcLayout<D, F32>;
  constexpr int BQ = L::BQ1, BK = L::BK1, STAGES = L::ST1, QT = L::QT,
                VT = L::VT;
  constexpr int CONSUMERS = BQ * 2;  // 128 threads a 64-row warpgroup
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  __shared__ __align__(8) uint64_t q_bar;

  // the Q planes, dO hi, dO lo, then the stages of K and V planes;
  // 1024-byte aligned tiles
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + (QT + 2) * L::Q1_BYTES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BQ, prob = blockIdx.y;
  const int tiles = (S + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_addr(&full_bar[s]), 1);
      mbar_init(smem_addr(&empty_bar[s]), CONSUMERS / 32);
    }
    mbar_init(smem_addr(&q_bar), 1);
    repro::mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // ---------------------------------------------------------- producer
    // plane t of problem `prob` is slice t·P + prob of its map
    if (lane == 0) {
      const uint32_t qb = smem_addr(&q_bar);
      mbar_expect_tx(qb, (QT + 2) * L::Q1_BYTES);
      for (int cb = 0; cb < D / L::AE; ++cb) {
        const uint32_t at = cb * BQ * L::SW;
        for (int a = 0; a < QT; ++a) {
          repro::tma_load_3d(q_s + a * L::Q1_BYTES + at, &qmap, qb,
                             cb * L::AE, row0, a * P + prob);
        }
        repro::tma_load_3d(q_s + QT * L::Q1_BYTES + at, &dmap, qb,
                           cb * L::AE, row0, prob);
        repro::tma_load_3d(q_s + (QT + 1) * L::Q1_BYTES + at, &dmap, qb,
                           cb * L::AE, row0, P + prob);
      }
      for (int t = 0; t < tiles; ++t) {
        const int st = t % STAGES;
        mbar_wait(smem_addr(&empty_bar[st]), ((t / STAGES) & 1) ^ 1);
        const uint32_t fb = smem_addr(&full_bar[st]);
        const uint32_t stage = kv_s + st * L::STAGE1;
        mbar_expect_tx(fb, L::STAGE1);
        for (int cb = 0; cb < D / L::AE; ++cb) {
          const uint32_t at = cb * BK * L::SW;
          for (int b = 0; b < QT; ++b) {
            repro::tma_load_3d(stage + b * L::KV1_BYTES + at, &kmap, fb,
                               cb * L::AE, t * BK, b * P + prob);
          }
          for (int b = 0; b < VT; ++b) {
            repro::tma_load_3d(stage + (QT + b) * L::KV1_BYTES + at, &vmap,
                               fb, cb * L::AE, t * BK, b * P + prob);
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = warp >> 2, gid = lane >> 2, tig = lane & 3;
  // this thread's two rows of the tile and its columns 8j + 2·tig (+1)
  const int row_a = row0 + wg * 64 + (warp & 3) * 16 + gid;
  const int row_b = row_a + 8;
  const size_t qoff = static_cast<size_t>(prob) * N * D;

  // Δ of both rows: this thread's D/4 columns, then the row's four threads
  // by a butterfly (every lane ends with the same bits)
  float dlt_a = 0.0f, dlt_b = 0.0f;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * tig;
    if (row_a < N) {
      const size_t at = qoff + static_cast<size_t>(row_a) * D + col;
      const float2 x = *reinterpret_cast<const float2*>(dout + at);
      const float2 y = *reinterpret_cast<const float2*>(o + at);
      dlt_a = fmaf(x.x, y.x, dlt_a);
      dlt_a = fmaf(x.y, y.y, dlt_a);
    }
    if (row_b < N) {
      const size_t at = qoff + static_cast<size_t>(row_b) * D + col;
      const float2 x = *reinterpret_cast<const float2*>(dout + at);
      const float2 y = *reinterpret_cast<const float2*>(o + at);
      dlt_b = fmaf(x.x, y.x, dlt_b);
      dlt_b = fmaf(x.y, y.y, dlt_b);
    }
  }
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    dlt_a += __shfl_xor_sync(0xffffffffu, dlt_a, w);
    dlt_b += __shfl_xor_sync(0xffffffffu, dlt_b, w);
  }

  float acc[D / 2];  // m64nD dQ accumulator
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max of s·c
  float l_a = 0.0f, l_b = 0.0f;            // this thread's share of l

  mbar_wait(smem_addr(&q_bar), 0);
  for (int t = 0; t < tiles; ++t) {
    const int st = t % STAGES;
    mbar_wait(smem_addr(&full_bar[st]), (t / STAGES) & 1);
    const uint32_t k_t = kv_s + st * L::STAGE1;
    const uint32_t v_t = k_t + QT * L::KV1_BYTES;
    // the A tiles' address opaque to the compiler, so their descriptors are
    // made again each tile instead of held in registers across the loop
    uint32_t a_t = q_s;
    asm volatile("" : "+r"(a_t));
    const uint32_t hi_t = a_t + QT * L::Q1_BYTES, lo_t = hi_t + L::Q1_BYTES;

    // S = Σ q_a k_bᵀ; dP = dO_lo V0ᵀ (+ dO_hi V1ᵀ) + dO_hi V0ᵀ, the small
    // products first
    float s[BK / 2], dp[BK / 2];
    repro::wgmma_fence();
    term_scores<D, BK, QT, BQ, L::Q1_BYTES, L::KV1_BYTES>(s, a_t, wg * 64,
                                                         k_t);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      repro::wgmma_ss<BK>(dp, k_major<D>(lo_t, BQ, wg * 64, kk),
                          k_major<D>(v_t, BK, 0, kk), kk > 0);
    }
    if constexpr (VT == 2) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        repro::wgmma_ss<BK>(dp, k_major<D>(hi_t, BQ, wg * 64, kk),
                            k_major<D>(v_t + L::KV1_BYTES, BK, 0, kk), 1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      repro::wgmma_ss<BK>(dp, k_major<D>(hi_t, BQ, wg * 64, kk),
                          k_major<D>(v_t, BK, 0, kk), 1);
    }
    repro::wgmma_commit();
    repro::wgmma_wait_all();
    pin(s);
    pin(dp);

    // scores in log2 units, s·c; keys ≥ S (the ragged last tile) −inf
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] *= c;
    const int live = S - t * BK;
    if (live < BK) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int col = 8 * j + 2 * tig;
        if (col >= live) s[4 * j] = s[4 * j + 2] = -INFINITY;
        if (col + 1 >= live) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
      }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, w));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, w));
    }
    // finite: every tile holds a live key
    const float new_a = fmaxf(m_a, mx_a), new_b = fmaxf(m_b, mx_b);
    const float alpha_a = m_a == -INFINITY ? 0.0f : ex2(m_a - new_a);
    const float alpha_b = m_b == -INFINITY ? 0.0f : ex2(m_b - new_b);
    m_a = new_a;
    m_b = new_b;

    // p = 2^(s·c − m) into l; dS = p·(dP − Δ) in place of s
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = ex2(s[4 * j] - new_a), p1 = ex2(s[4 * j + 1] - new_a);
      const float p2 = ex2(s[4 * j + 2] - new_b);
      const float p3 = ex2(s[4 * j + 3] - new_b);
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      s[4 * j] = p0 * (dp[4 * j] - dlt_a);
      s[4 * j + 1] = p1 * (dp[4 * j + 1] - dlt_a);
      s[4 * j + 2] = p2 * (dp[4 * j + 2] - dlt_b);
      s[4 * j + 3] = p3 * (dp[4 * j + 3] - dlt_b);
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;

    // dQ += ds_hi K0 + ds_lo K0 (+ ds_hi K1): bf16, into acc (rescaled
    // first); f32, into this tile's own sum, then acc = acc·alpha + tile
    // in f32 FMAs (Tile sums, in the opening note)
    uint32_t ds_hi[BK / 16][4], ds_lo[BK / 16][4];
    fragments<BK>(s, ds_hi, ds_lo);
    if constexpr (F32) {
      float tile[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) tile[i] = 0.0f;
      ds_products<D, BK, QT, L::KV1_BYTES>(tile, ds_hi, ds_lo, k_t);
      if (lane == 0) mbar_arrive(smem_addr(&empty_bar[st]));  // K, V read
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] = fmaf(acc[4 * j], alpha_a, tile[4 * j]);
        acc[4 * j + 1] = fmaf(acc[4 * j + 1], alpha_a, tile[4 * j + 1]);
        acc[4 * j + 2] = fmaf(acc[4 * j + 2], alpha_b, tile[4 * j + 2]);
        acc[4 * j + 3] = fmaf(acc[4 * j + 3], alpha_b, tile[4 * j + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha_a;
        acc[4 * j + 1] *= alpha_a;
        acc[4 * j + 2] *= alpha_b;
        acc[4 * j + 3] *= alpha_b;
      }
      ds_products<D, BK, QT, L::KV1_BYTES>(acc, ds_hi, ds_lo, k_t);
      if (lane == 0) mbar_arrive(smem_addr(&empty_bar[st]));  // K, V read
    }
  }

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, w);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, w);
  }
  const float inv_a = scale / l_a, inv_b = scale / l_b;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * tig;
    if (row_a < N) {
      *reinterpret_cast<float2*>(dq + qoff + static_cast<size_t>(row_a) * D +
                                 col) =
          make_float2(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
    }
    if (row_b < N) {
      *reinterpret_cast<float2*>(dq + qoff + static_cast<size_t>(row_b) * D +
                                 col) =
          make_float2(acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
    }
  }
  if (tig == 0) {
    const size_t roff = static_cast<size_t>(prob) * NP;
    if (row_a < NP) {
      lse[roff + row_a] = row_a < N ? m_a + log2f(l_a) : INFINITY;
      delta[roff + row_a] = row_a < N ? dlt_a : 0.0f;
    }
    if (row_b < NP) {
      lse[roff + row_b] = row_b < N ? m_b + log2f(l_b) : INFINITY;
      delta[roff + row_b] = row_b < N ? dlt_b : 0.0f;
    }
  }
}

// pass 2: dK and dV of BK2 keys, over every query tile
template <int D, bool F32>
__global__ void __launch_bounds__(TcLayout<D, F32>::THREADS2, 1)
bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap dmap,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int P, int N, int NP, int S,
                     float c, float scale) {
  using L = TcLayout<D, F32>;
  constexpr int BK = L::BK2, BQ = L::BQ2, STAGES = L::ST2, QT = L::QT,
                VT = L::VT;
  constexpr int CONSUMERS = BK * 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  __shared__ __align__(8) uint64_t kv_bar;

  // the K and V planes, then the stages: the Q planes, dO hi, dO lo, lse
  // and Δ of the tile's rows
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  const uint32_t st_s = k_s + (QT + VT) * L::KV2_BYTES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key0 = blockIdx.x * BK, prob = blockIdx.y;
  const int tiles = (N + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_addr(&full_bar[s]), 1);
      mbar_init(smem_addr(&empty_bar[s]), CONSUMERS / 32);
    }
    mbar_init(smem_addr(&kv_bar), 1);
    repro::mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // ---------------------------------------------------------- producer
    if (lane == 0) {
      const uint32_t kb = smem_addr(&kv_bar);
      mbar_expect_tx(kb, (QT + VT) * L::KV2_BYTES);
      for (int cb = 0; cb < D / L::AE; ++cb) {
        const uint32_t at = cb * BK * L::SW;
        for (int b = 0; b < QT; ++b) {
          repro::tma_load_3d(k_s + b * L::KV2_BYTES + at, &kmap, kb,
                             cb * L::AE, key0, b * P + prob);
        }
        for (int b = 0; b < VT; ++b) {
          repro::tma_load_3d(k_s + (QT + b) * L::KV2_BYTES + at, &vmap, kb,
                             cb * L::AE, key0, b * P + prob);
        }
      }
      const float* lse_p = lse + static_cast<size_t>(prob) * NP;
      const float* dlt_p = delta + static_cast<size_t>(prob) * NP;
      for (int t = 0; t < tiles; ++t) {
        const int st = t % STAGES;
        mbar_wait(smem_addr(&empty_bar[st]), ((t / STAGES) & 1) ^ 1);
        const uint32_t fb = smem_addr(&full_bar[st]);
        const uint32_t stage = st_s + st * L::STAGE2;
        mbar_expect_tx(fb, (QT + 2) * L::Q2_BYTES + L::STAT_BYTES);
        for (int cb = 0; cb < D / L::AE; ++cb) {
          const uint32_t at = cb * BQ * L::SW;
          for (int a = 0; a < QT; ++a) {
            repro::tma_load_3d(stage + a * L::Q2_BYTES + at, &qmap, fb,
                               cb * L::AE, t * BQ, a * P + prob);
          }
          repro::tma_load_3d(stage + QT * L::Q2_BYTES + at, &dmap, fb,
                             cb * L::AE, t * BQ, prob);
          repro::tma_load_3d(stage + (QT + 1) * L::Q2_BYTES + at, &dmap, fb,
                             cb * L::AE, t * BQ, P + prob);
        }
        const uint32_t stat = stage + (QT + 2) * L::Q2_BYTES;
        repro::bulk_load(stat, lse_p + t * BQ, BQ * 4, fb);
        repro::bulk_load(stat + BQ * 4, dlt_p + t * BQ, BQ * 4, fb);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = warp >> 2, gid = lane >> 2, tig = lane & 3;
  // this thread's two keys of the tile and its columns (queries, or D)
  // 8j + 2·tig (+1)
  const int key_a = key0 + wg * 64 + (warp & 3) * 16 + gid;
  const int key_b = key_a + 8;

  float gk[D / 2], gv[D / 2];  // m64nD dK and dV accumulators
#pragma unroll
  for (int i = 0; i < D / 2; ++i) gk[i] = gv[i] = 0.0f;

  mbar_wait(smem_addr(&kv_bar), 0);
  for (int t = 0; t < tiles; ++t) {
    const int st = t % STAGES;
    mbar_wait(smem_addr(&full_bar[st]), (t / STAGES) & 1);
    const uint32_t q_t = st_s + st * L::STAGE2;
    const uint32_t hi_t = q_t + QT * L::Q2_BYTES, lo_t = hi_t + L::Q2_BYTES;
    const float* stat = reinterpret_cast<const float*>(
        smem_raw + (lo_t + L::Q2_BYTES - raw));
    uint32_t a_t = k_s;  // made again each tile, as in pass 1
    asm volatile("" : "+r"(a_t));
    const uint32_t v_a = a_t + QT * L::KV2_BYTES;

    // Sᵀ = Σ k_b q_aᵀ; dPᵀ = V0 dO_loᵀ (+ V1 dO_hiᵀ) + V0 dO_hiᵀ
    float s[BQ / 2], dp[BQ / 2];
    repro::wgmma_fence();
    term_scores<D, BQ, QT, BK, L::KV2_BYTES, L::Q2_BYTES>(s, a_t, wg * 64,
                                                         q_t);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      repro::wgmma_ss<BQ>(dp, k_major<D>(v_a, BK, wg * 64, kk),
                          k_major<D>(lo_t, BQ, 0, kk), kk > 0);
    }
    if constexpr (VT == 2) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        repro::wgmma_ss<BQ>(dp,
                            k_major<D>(v_a + L::KV2_BYTES, BK, wg * 64, kk),
                            k_major<D>(hi_t, BQ, 0, kk), 1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      repro::wgmma_ss<BQ>(dp, k_major<D>(v_a, BK, wg * 64, kk),
                          k_major<D>(hi_t, BQ, 0, kk), 1);
    }
    repro::wgmma_commit();
    repro::wgmma_wait_all();
    pin(s);
    pin(dp);

    // Pᵀ = 2^(sᵀ·c − lse) in place of s, dSᵀ = Pᵀ·(dPᵀ − Δ) in place of
    // dp; queries ≥ n have lse = +inf, so P = 0
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int col = 8 * j + 2 * tig;
      const float2 ls = *reinterpret_cast<const float2*>(stat + col);
      const float2 dl = *reinterpret_cast<const float2*>(stat + BQ + col);
      s[4 * j] = ex2(s[4 * j] * c - ls.x);
      s[4 * j + 1] = ex2(s[4 * j + 1] * c - ls.y);
      s[4 * j + 2] = ex2(s[4 * j + 2] * c - ls.x);
      s[4 * j + 3] = ex2(s[4 * j + 3] * c - ls.y);
      dp[4 * j] = s[4 * j] * (dp[4 * j] - dl.x);
      dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - dl.y);
      dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - dl.x);
      dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - dl.y);
    }
    uint32_t p_hi[BQ / 16][4], p_lo[BQ / 16][4];
    uint32_t ds_hi[BQ / 16][4], ds_lo[BQ / 16][4];
    fragments<BQ>(s, p_hi, p_lo);
    fragments<BQ>(dp, ds_hi, ds_lo);

    // dV += p_hi dO_hi + p_hi dO_lo + p_lo dO_hi; dK += ds_hi q0 + ds_lo q0
    // (+ ds_hi q1); k16 steps of 16 queries down the tiles' rows. bf16:
    // into gv and gk, one group; f32: each into this tile's own sum, then
    // added to gv and gk in f32 (Tile sums, in the opening note)
    if constexpr (F32) {
      float tile[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) tile[i] = 0.0f;
      pin(tile);
      pin(p_hi);
      pin(p_lo);
      repro::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        const uint64_t dhi = mn_major<D>(hi_t, BQ, kc);
        repro::wgmma_rs<D>(tile, p_hi[kc], dhi);
        repro::wgmma_rs<D>(tile, p_hi[kc], mn_major<D>(lo_t, BQ, kc));
        repro::wgmma_rs<D>(tile, p_lo[kc], dhi);
      }
      repro::wgmma_commit();
      repro::wgmma_wait_all();
      pin(tile);
      pin(p_hi);
      pin(p_lo);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        gv[i] += tile[i];
        tile[i] = 0.0f;
      }
      ds_products<D, BQ, QT, L::Q2_BYTES>(tile, ds_hi, ds_lo, q_t);
      if (lane == 0) mbar_arrive(smem_addr(&empty_bar[st]));  // stage read
#pragma unroll
      for (int i = 0; i < D / 2; ++i) gk[i] += tile[i];
    } else {
      pin(gk);
      pin(gv);
      pin(p_hi);
      pin(p_lo);
      pin(ds_hi);
      pin(ds_lo);
      repro::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        const uint64_t dhi = mn_major<D>(hi_t, BQ, kc);
        repro::wgmma_rs<D>(gv, p_hi[kc], dhi);
        repro::wgmma_rs<D>(gv, p_hi[kc], mn_major<D>(lo_t, BQ, kc));
        repro::wgmma_rs<D>(gv, p_lo[kc], dhi);
        const uint64_t qb = mn_major<D>(q_t, BQ, kc);
        repro::wgmma_rs<D>(gk, ds_hi[kc], qb);
        repro::wgmma_rs<D>(gk, ds_lo[kc], qb);
      }
      repro::wgmma_commit();
      repro::wgmma_wait_all();
      pin(gk);
      pin(gv);
      pin(p_hi);
      pin(p_lo);
      pin(ds_hi);
      pin(ds_lo);
      if (lane == 0) mbar_arrive(smem_addr(&empty_bar[st]));  // stage read
    }
  }

  const size_t koff = static_cast<size_t>(prob) * S * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * tig;
    if (key_a < S) {
      const size_t at = koff + static_cast<size_t>(key_a) * D + col;
      *reinterpret_cast<float2*>(dk + at) =
          make_float2(gk[4 * j] * scale, gk[4 * j + 1] * scale);
      *reinterpret_cast<float2*>(dv + at) = make_float2(gv[4 * j],
                                                        gv[4 * j + 1]);
    }
    if (key_b < S) {
      const size_t at = koff + static_cast<size_t>(key_b) * D + col;
      *reinterpret_cast<float2*>(dk + at) =
          make_float2(gk[4 * j + 2] * scale, gk[4 * j + 3] * scale);
      *reinterpret_cast<float2*>(dv + at) = make_float2(gv[4 * j + 2],
                                                        gv[4 * j + 3]);
    }
  }
}

// q, k (QT·P slices of N or S rows) and v (VT·P slices) as bf16 planes,
// dout's two planes (2·P slices)
template <int D, bool F32>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* planes, void* dq, void* dk,
              void* dv, void* lse, void* delta, int P, int N, int NP, int S,
              float scale, cudaStream_t stream) {
  using L = TcLayout<D, F32>;
  CUtensorMap q1, d1, k1, v1, k2, v2, q2, d2;
  if (!repro::bf16_tensor_map(&q1, q, L::QT * P, N, D, L::BQ1, L::SW) ||
      !repro::bf16_tensor_map(&d1, planes, 2 * P, N, D, L::BQ1, L::SW) ||
      !repro::bf16_tensor_map(&k1, k, L::QT * P, S, D, L::BK1, L::SW) ||
      !repro::bf16_tensor_map(&v1, v, L::VT * P, S, D, L::BK1, L::SW) ||
      !repro::bf16_tensor_map(&k2, k, L::QT * P, S, D, L::BK2, L::SW) ||
      !repro::bf16_tensor_map(&v2, v, L::VT * P, S, D, L::BK2, L::SW) ||
      !repro::bf16_tensor_map(&q2, q, L::QT * P, N, D, L::BQ2, L::SW) ||
      !repro::bf16_tensor_map(&d2, planes, 2 * P, N, D, L::BQ2, L::SW)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static size_t sized1[repro::kMaxDevices] = {};  // the >48 KB opt-ins
  static size_t sized2[repro::kMaxDevices] = {};
  cudaError_t err =
      repro::allow_smem(bwd_dq_wgmma_kernel<D, F32>, L::SMEM1, sized1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = repro::allow_smem(bwd_dkv_wgmma_kernel<D, F32>, L::SMEM2, sized2);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float c = scale * kLog2e;
  bwd_dq_wgmma_kernel<D, F32><<<dim3(NP / L::BQ1, P), L::THREADS1, L::SMEM1,
                                stream>>>(
      q1, d1, k1, v1, static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<float*>(dq),
      static_cast<float*>(lse), static_cast<float*>(delta), P, N, NP, S, c,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkv_wgmma_kernel<D, F32><<<dim3((S + L::BK2 - 1) / L::BK2, P),
                                 L::THREADS2, L::SMEM2, stream>>>(
      k2, v2, q2, d2, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), P, N, NP, S, c, scale);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int P, int N, int S) {
  return P > 0 && N > 0 && S > 0 && P <= 65535;
}

template <bool F32>
int launch_tc_dim(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const void* planes, void* dq, void* dk,
                  void* dv, void* lse, void* delta, int P, int N, int NP,
                  int S, int D, float scale, void* stream) {
  if (!valid(P, N, S) || NP < N || NP % ROW_PAD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_tc<32, F32>(q, k, v, o, dout, planes, dq, dk, dv, lse,
                                delta, P, N, NP, S, scale, st);
    case 64:
      return launch_tc<64, F32>(q, k, v, o, dout, planes, dq, dk, dv, lse,
                                delta, P, N, NP, S, scale, st);
    case 128:
      return launch_tc<128, F32>(q, k, v, o, dout, planes, dq, dk, dv, lse,
                                 delta, P, N, NP, S, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// bf16 q (P, N, D), k and v (P, S, D), D ∈ {32, 64, 128}; o and dout
// (P, N, D) f32 and dout's two bf16 planes (2, P, N, D) (split_bf16_terms)
// → dq (P, N, D), dk and dv (P, S, D) f32; lse and delta (P, NP) f32
// scratch, NP = N rounded up to a multiple of 128, written by pass 1 and
// read by pass 2. All 16-byte aligned. Two launches.
extern "C" int landmark_summary_bwd_tc(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, const void* planes,
                                       void* dq, void* dk, void* dv,
                                       void* lse, void* delta, int P, int N,
                                       int NP, int S, int D, float scale,
                                       void* stream) {
  return launch_tc_dim<false>(q, k, v, o, dout, planes, dq, dk, dv, lse,
                              delta, P, N, NP, S, D, scale, stream);
}

// The f32_split route: f32 inputs as bf16 planes from split_bf16_terms, q
// (3, P, N, D), k (3, P, S, D), v (2, P, S, D), D ∈ {32, 64, 128}; the rest
// as landmark_summary_bwd_tc. Two launches.
extern "C" int landmark_summary_bwd_tc_f32(const void* q, const void* k,
                                           const void* v, const void* o,
                                           const void* dout,
                                           const void* planes, void* dq,
                                           void* dk, void* dv, void* lse,
                                           void* delta, int P, int N, int NP,
                                           int S, int D, float scale,
                                           void* stream) {
  return launch_tc_dim<true>(q, k, v, o, dout, planes, dq, dk, dv, lse,
                             delta, P, N, NP, S, D, scale, stream);
}

// The FMA route, D = 256: q (P, N, D), k and v (P, S, D) bf16 or f32; o and
// dout (P, N, D) f32 → dq (P, N, D), dk and dv (P, S, D) f32; lse and delta
// (P, N) f32 scratch written by pass 1 and read by pass 2. Two launches.
extern "C" int landmark_summary_bwd_bf16(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* dout, void* dq, void* dk,
                                         void* dv, void* lse, void* delta,
                                         int P, int N, int S, int D,
                                         float scale, void* stream) {
  if (!valid(P, N, S) || D != 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_bwd<256, __nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse,
                                        delta, P, N, S, scale,
                                        static_cast<cudaStream_t>(stream));
}

extern "C" int landmark_summary_bwd_f32(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, void* dq, void* dk,
                                        void* dv, void* lse, void* delta,
                                        int P, int N, int S, int D,
                                        float scale, void* stream) {
  if (!valid(P, N, S) || D != 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_bwd<256, float>(q, k, v, o, dout, dq, dk, dv, lse, delta, P,
                                N, S, scale,
                                static_cast<cudaStream_t>(stream));
}
