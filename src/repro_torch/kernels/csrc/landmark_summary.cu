// Landmark summary softmax(Q̃ Kᵀ · scale) V for Hopper: a TMA + wgmma flash
// loop for bf16 inputs, and an f32 CUDA-core kernel for f32 inputs.
//
// Replaces the TPU kernel src/repro/kernels/landmark_attention.py
// landmark_summary_kernel (body _kernel): the B̃V term of landmark
// (Nyström) attention, streamed over the sequence with flash-style running
// (max m, denominator z, accumulator acc) so the (n, S) score matrix never
// exists in device memory. The output is (P, n, D) f32 for P problems: one
// problem is the stacked landmark queries of one (batch, kv-head) against
// that head's (S, D) keys and values, so one launch per layer serves them
// all. Keys at or past S are masked in the kernel: any S works.
//
// What bounds it on an H100 (chip_smoke.py::_lm_bound): at the
// landmark-attention shape of SmolLM-360M (P = 2·5 problems of n = 3·512
// queries, S = 4096, D = 64, bf16 inputs) the ~16 MB moved take ~5 µs; the
// tensor-core work, q̃Kᵀ plus PV as two bf16 products (below), is
// 6·n·S·D = 24 GFLOP a launch: 0.0244 ms at 989 TFLOP/s bf16. Operations
// bound it, on the tensor cores.
//
// bf16 route (summary_wgmma_kernel), designed to that bound:
// - a block owns a 128-row query tile of one problem: two consumer
//   warpgroups of 64 rows and one producer warp (288 threads; at D = 256
//   one consumer warpgroup and 64 rows). At the 8b shape that is
//   12 × 10 = 120 blocks, one wave on 132 SMs;
// - the producer's one lane loads the Q tile once and streams K and V tiles
//   of BK keys through a ring of STAGES shared-memory buffers by TMA (3-D
//   tensor maps (D, rows, P), 128-byte swizzle, 64-byte at D = 32), with
//   full/empty mbarriers, so loads stay in flight while the consumers
//   compute. A tile never reaches into the next problem: TMA zero-fills
//   past S and past n;
// - S = Q Kᵀ by wgmma m64nBKk16 with both operands in shared memory: the
//   bf16 products are exact and the sums f32;
// - the online softmax stays in registers: four threads share a row of the
//   accumulator and take its max by shuffles; scores are scaled once by
//   c = scale·log2(e), keys ≥ S set to −inf, p = exp2(s·c − m) with m the
//   running max in those units; alpha = exp2(m_old − m_new), or 0 while
//   m_old is −inf (the reference's rule); z is summed from the f32 p;
// - PV: p is split into p_hi = bf16(p) and p_lo = bf16(p − p_hi), both fed
//   to wgmma m64nDk16 as register A operands (the f32 accumulator layout
//   of the first product is the A-fragment layout for 16-bit types) with V
//   read from shared memory as the MN-major B operand; acc is rescaled by
//   alpha first;
// - epilogue: out = acc / max(z, 1e-30) as f32, rows ≥ n masked.
// Why P is split: the bound against the plain version is rtol 1e-4, atol
// 1e-5. Rounded to one bf16 term before PV, p gives max |err| 1.6e-4 to
// 3.1e-4 on normal bf16 inputs at (n, S, D) = (256, 4096, 64),
// (64, 1024, 64), (128, 2048, 128), (16, 777, 32) — 16–31× atol; split in
// two it gives 3.0e-7 to 5.9e-7, 3–6% of it (this arithmetic emulated on
// the CPU: kernels/ref.py::landmark_summary_split_ref). The split costs a
// third product, which the bound above counts.
//
// f32 route (summary_f32_kernel): f32 q and k cannot go through bf16
// products exactly, so f32 inputs take a CUDA-core kernel: a block of 256
// threads owns 64 query rows held in shared memory; 64-key K and V tiles are
// staged one after the other; each thread computes a 4×4 register tile of
// scores, written scaled to a shared score tile (keys ≥ S are −inf); one
// warp per 8 rows takes the row max by shuffles, p = exp(s − m_new),
// alpha = exp(m_old − m_new) or 0 while m_old is −inf; each thread adds
// p·v into a 4 × D/16 register accumulator. Its bound is the f32 rate:
// 0.241 ms at the 8b shape.
//
// Head dims D ∈ {32, 64, 128, 256} on both routes; the wrapper rejects
// others. The dtype chooses the route; nothing falls back.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::pin;
using repro::sm90_desc;
using repro::smem_addr;

// ============================================================ bf16 route
constexpr float kLog2e = 1.4426950408889634f;

// Tiles per head dim: WGS consumer warpgroups of 64 query rows, BK keys a
// tile, STAGES buffers in the ring. ptxas budgets registers for whole
// warpgroups, so a 288-thread block gets 168 a thread: enough for this loop
// up to D = 128 without spills (chip_smoke.py phase 2 prints the counts).
// At D = 256 the 64 × 256 accumulator alone takes 128: one consumer
// warpgroup (160 threads, up to 255 registers each) keeps it free of
// spills, with a 32 KB Q tile and two 64 KB stages.
template <int D> struct Tiles;
template <> struct Tiles<32> {
  static constexpr int WGS = 2, BK = 128, STAGES = 3;
};
template <> struct Tiles<64> {
  static constexpr int WGS = 2, BK = 128, STAGES = 3;
};
template <> struct Tiles<128> {
  static constexpr int WGS = 2, BK = 64, STAGES = 3;
};
template <> struct Tiles<256> {
  static constexpr int WGS = 1, BK = 64, STAGES = 2;
};

template <int D>
struct Layout {
  static constexpr int BQ = 64 * Tiles<D>::WGS;  // query rows per block
  static constexpr int CONSUMERS = 128 * Tiles<D>::WGS;
  static constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
  static constexpr int BK = Tiles<D>::BK;
  static constexpr int STAGES = Tiles<D>::STAGES;
  static constexpr int SW = D >= 64 ? 128 : 64;  // swizzle span, bytes
  static constexpr int AE = SW / 2;              // bf16 per swizzled row
  static constexpr int NCB = D / AE;             // column blocks of a tile
  static constexpr uint32_t MODE = SW == 128 ? 1 : 2;  // descriptor swizzle
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;    // one K (or V) tile
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats as a bf16x2 register (round to nearest), `a` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// p (two f32) → p_hi = bf16(p), p_lo = bf16(p − p_hi); p − p_hi is exact
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(a, b);
  const float ha = __uint_as_float(hi << 16);
  const float hb = __uint_as_float(hi & 0xffff0000u);
  lo = pack_bf16(a - ha, b - hb);
}

template <int D>
__global__ void __launch_bounds__(Layout<D>::THREADS, 1)
summary_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     float* __restrict__ out, int N, int S, float c) {
  using L = Layout<D>;
  constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES, SW = L::SW,
                AE = L::AE;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  __shared__ __align__(8) uint64_t q_bar;

  // tiles start on a 1024-byte boundary: the swizzle repeats every 8 rows
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  const uint32_t k_s = q_s + L::Q_BYTES;               // STAGES K tiles
  const uint32_t v_s = k_s + STAGES * L::KV_BYTES;     // STAGES V tiles

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BQ;
  const int prob = blockIdx.y;
  const int tiles = (S + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_addr(&full_bar[s]), 1);
      mbar_init(smem_addr(&empty_bar[s]), L::CONSUMERS / 32);
    }
    mbar_init(smem_addr(&q_bar), 1);
    repro::mbar_init_fence();
  }
  __syncthreads();

  if (warp == L::CONSUMERS / 32) {
    // ---------------------------------------------------------- producer
    if (lane == 0) {
      const uint32_t qb = smem_addr(&q_bar);
      mbar_expect_tx(qb, L::Q_BYTES);
      for (int cb = 0; cb < L::NCB; ++cb) {
        repro::tma_load_3d(q_s + cb * BQ * SW, &qmap, qb, cb * AE, row0,
                           prob);
      }
      for (int t = 0; t < tiles; ++t) {
        const int st = t % STAGES;
        mbar_wait(smem_addr(&empty_bar[st]), ((t / STAGES) & 1) ^ 1);
        const uint32_t fb = smem_addr(&full_bar[st]);
        mbar_expect_tx(fb, 2 * L::KV_BYTES);
        for (int cb = 0; cb < L::NCB; ++cb) {
          repro::tma_load_3d(k_s + st * L::KV_BYTES + cb * BK * SW, &kmap, fb,
                             cb * AE, t * BK, prob);
          repro::tma_load_3d(v_s + st * L::KV_BYTES + cb * BK * SW, &vmap, fb,
                             cb * AE, t * BK, prob);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = warp >> 2;              // warpgroup: query rows 64·wg..
  const int gid = lane >> 2, tig = lane & 3;
  // this thread's two rows of the tile and its columns 8j + 2·tig (+1)
  const int row_a = row0 + wg * 64 + (warp & 3) * 16 + gid;
  const int row_b = row_a + 8;

  float o[D / 2];  // m64nD accumulator: (row_a, row_b) × D/4 columns
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max of s·c
  float z_a = 0.0f, z_b = 0.0f;            // this thread's share of z

  const uint32_t q_wg = q_s + wg * 64 * SW;
  mbar_wait(smem_addr(&q_bar), 0);

  for (int t = 0; t < tiles; ++t) {
    const int st = t % STAGES;
    mbar_wait(smem_addr(&full_bar[st]), (t / STAGES) & 1);
    const uint32_t k_t = k_s + st * L::KV_BYTES;
    const uint32_t v_t = v_s + st * L::KV_BYTES;

    // S = Q Kᵀ over D in k16 steps: column block kk / (AE/16), 32 bytes a
    // step inside it
    float s[BK / 2];
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int cb = kk / (AE / 16), off = (kk % (AE / 16)) * 32;
      const uint64_t da =
          sm90_desc(q_wg + cb * BQ * SW + off, 16, 8 * SW, L::MODE);
      const uint64_t db =
          sm90_desc(k_t + cb * BK * SW + off, 16, 8 * SW, L::MODE);
      repro::wgmma_ss<BK>(s, da, db, kk > 0);
    }
    repro::wgmma_commit();
    repro::wgmma_wait_all();
    pin(s);

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

    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[4 * j] = ex2(s[4 * j] - new_a);
      s[4 * j + 1] = ex2(s[4 * j + 1] - new_a);
      s[4 * j + 2] = ex2(s[4 * j + 2] - new_b);
      s[4 * j + 3] = ex2(s[4 * j + 3] - new_b);
      sum_a += s[4 * j] + s[4 * j + 1];
      sum_b += s[4 * j + 2] + s[4 * j + 3];
    }
    z_a = z_a * alpha_a + sum_a;
    z_b = z_b * alpha_b + sum_b;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha_a;
      o[4 * j + 1] *= alpha_a;
      o[4 * j + 2] *= alpha_b;
      o[4 * j + 3] *= alpha_b;
    }

    // p as A fragments: k16 chunk kc takes accumulator blocks 2kc, 2kc+1
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        split_bf16(s[8 * kc + 2 * r], s[8 * kc + 2 * r + 1], p_hi[kc][r],
                   p_lo[kc][r]);
      }
    }

    // O += P_hi V + P_lo V, k16 steps of 16 keys down V's rows
    pin(o);
    pin(p_hi);
    pin(p_lo);
    repro::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint64_t dv =
          sm90_desc(v_t + kc * 16 * SW, BK * SW, 8 * SW, L::MODE);
      repro::wgmma_rs<D>(o, p_hi[kc], dv);
      repro::wgmma_rs<D>(o, p_lo[kc], dv);
    }
    repro::wgmma_commit();
    repro::wgmma_wait_all();
    pin(o);
    pin(p_hi);
    pin(p_lo);
    if (lane == 0) mbar_arrive(smem_addr(&empty_bar[st]));  // K, V read
  }

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    z_a += __shfl_xor_sync(0xffffffffu, z_a, w);
    z_b += __shfl_xor_sync(0xffffffffu, z_b, w);
  }
  z_a = fmaxf(z_a, 1e-30f);
  z_b = fmaxf(z_b, 1e-30f);
  float* op = out + static_cast<size_t>(prob) * N * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * tig;
    if (row_a < N) {
      *reinterpret_cast<float2*>(op + static_cast<size_t>(row_a) * D + col) =
          make_float2(o[4 * j] / z_a, o[4 * j + 1] / z_a);
    }
    if (row_b < N) {
      *reinterpret_cast<float2*>(op + static_cast<size_t>(row_b) * D + col) =
          make_float2(o[4 * j + 2] / z_b, o[4 * j + 3] / z_b);
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links without libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (P, rows, D) bf16 tensor as a 3-D map read in (AE, box_rows, 1) boxes
template <int D>
bool tensor_map(CUtensorMap* map, const void* base, int P, int rows,
                int box_rows) {
  using L = Layout<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(P)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(L::AE),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                L::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int P,
                int N, int S, float scale, cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap qm, km, vm;
  if (!tensor_map<D>(&qm, q, P, N, L::BQ) ||
      !tensor_map<D>(&km, k, P, S, L::BK) ||
      !tensor_map<D>(&vm, v, P, S, L::BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool ready = false;  // the >48 KB opt-in, once per instantiation
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        summary_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const dim3 grid((N + L::BQ - 1) / L::BQ, P);
  summary_wgmma_kernel<D><<<grid, L::THREADS, L::SMEM, stream>>>(
      qm, km, vm, static_cast<float*>(out), N, S, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// ============================================================= f32 route
constexpr int kBQF = 64;       // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 × 16
constexpr unsigned kFull = 0xffffffffu;

template <int D>
constexpr size_t smem_bytes() {
  // q tile and k tile at an odd row stride (conflict-free column reads),
  // v tile, score tile, and m / z / alpha per row
  return sizeof(float) * ((size_t)kBQF * (D + 1) + (size_t)kBK * (D + 1) +
                          (size_t)kBK * D + (size_t)kBQF * (kBK + 1) +
                          3 * kBQF);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
summary_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   int N, int S, float scale) {
  extern __shared__ float smem[];
  constexpr int QS = D + 1;
  constexpr int PS = kBK + 1;
  constexpr int DC = D / 16;  // accumulator columns per thread
  float* qs = smem;            // kBQF × QS
  float* ks = qs + kBQF * QS;  // kBK × QS
  float* vs = ks + kBK * QS;   // kBK × D
  float* ps = vs + kBK * D;    // kBQF × PS scores, then probabilities
  float* m_s = ps + kBQF * PS;  // running max per row
  float* z_s = m_s + kBQF;      // running denominator per row
  float* a_s = z_s + kBQF;      // this tile's alpha per row

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kBQF;
  const size_t prob = blockIdx.y;
  const float* qp = q + prob * N * D;
  const float* kp = k + prob * S * D;
  const float* vp = v + prob * S * D;

  for (int e = tid; e < kBQF * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    qs[r * QS + d] = row0 + r < N ? qp[(size_t)(row0 + r) * D + d] : 0.0f;
  }
  if (tid < kBQF) {
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
      ks[r * QS + d] = ok ? kp[off] : 0.0f;
      vs[r * D + d] = ok ? vp[off] : 0.0f;
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

    for (int rr = 0; rr < kBQF / (kThreads / 32); ++rr) {
      const int r = warp * (kBQF / (kThreads / 32)) + rr;
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

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int P,
               int N, int S, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool ready = false;  // the >48 KB opt-in, once per instantiation
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        summary_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const dim3 grid((N + kBQF - 1) / kBQF, P);
  summary_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), N, S, scale);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int P, int N, int S) {
  return P > 0 && N > 0 && S > 0 && P <= 65535;
}

}  // namespace

// f32 q, k, v (P, N, D) / (P, S, D) → f32 out (P, N, D), CUDA cores.
extern "C" int landmark_summary_f32(const void* q, const void* k,
                                    const void* v, void* out, int P, int N,
                                    int S, int D, float scale, void* stream) {
  if (!valid(P, N, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_f32<32>(q, k, v, out, P, N, S, scale, st);
    case 64: return launch_f32<64>(q, k, v, out, P, N, S, scale, st);
    case 128: return launch_f32<128>(q, k, v, out, P, N, S, scale, st);
    case 256: return launch_f32<256>(q, k, v, out, P, N, S, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 q, k, v (contiguous, 16-byte aligned) → f32 out, TMA + wgmma.
extern "C" int landmark_summary_bf16(const void* q, const void* k,
                                     const void* v, void* out, int P, int N,
                                     int S, int D, float scale, void* stream) {
  if (!valid(P, N, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_bf16<32>(q, k, v, out, P, N, S, scale, st);
    case 64: return launch_bf16<64>(q, k, v, out, P, N, S, scale, st);
    case 128: return launch_bf16<128>(q, k, v, out, P, N, S, scale, st);
    case 256: return launch_bf16<256>(q, k, v, out, P, N, S, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
