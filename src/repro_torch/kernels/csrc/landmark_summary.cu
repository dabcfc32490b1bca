// Landmark summary softmax(Q̃ Kᵀ · scale) V for Hopper: one TMA + wgmma
// flash loop on bf16 terms of the inputs, for bf16 and for f32 inputs.
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
// What bounds it on an H100 (chip_smoke.py::_lm_bound): at
// the landmark-attention shape of SmolLM-360M (P = 2·5 problems of
// n = 3·512 queries, S = 4096, D = 64) the bytes moved take 5 µs (bf16
// inputs) to 28 µs (f32 inputs and their bf16 planes); the tensor-core work
// is 3 bf16 products of 2·n·S·D a problem for bf16 inputs (0.0244 ms at
// 989 TFLOP/s) and 9 for f32 inputs (0.0733 ms). Operations bound both
// routes, on the tensor cores.
//
// The loop (summary_wgmma_kernel<D, F32>), designed to that bound:
// - a block owns a 128-row query tile of one problem: two consumer
//   warpgroups of 64 rows and one producer warp (288 threads; at D = 256
//   one consumer warpgroup and 64 rows). At the 8b shape that is
//   12 × 10 = 120 blocks, one wave on 132 SMs;
// - the producer's one lane loads the Q tile once and streams K and V tiles
//   of BK keys through a ring of STAGES shared-memory buffers by TMA (3-D
//   tensor maps (D, rows, terms·P), 128-byte swizzle, 64-byte at D = 32),
//   with full/empty mbarriers, so loads stay in flight while the consumers
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
// the CPU: kernels/ref.py::landmark_summary_split_ref).
//
// bf16 route (F32 = false): q, k, v are one term each; q̃Kᵀ is one product,
// PV two (p_hi v, p_lo v).
//
// f32 route (F32 = true): f32 q, k, v cannot go through one bf16 product,
// so a split pass (split_terms_kernel) first writes q and k as three bf16
// planes each and v as two: x0 = bf16(x), x1 = bf16(x − x0),
// x2 = bf16(x − x0 − x1), each subtraction exact in f32. The loop then
// issues six products into the score accumulator, the small ones first
// and q0k0 last (q2k0, q1k1, q0k2, q1k0, q0k1, q0k0; the dropped q1k2,
// q2k1, q2k2 are ~2^-24 of the score), and three into PV (p_hi v0,
// p_lo v0, p_hi v1). Two terms of q and k give 7–17× the plain f32
// version's own error at scores 16× unit scale; three give 0.9–1.3× (the
// CPU emulation kernels/ref.py::landmark_summary_f32_split_ref against an
// f64 oracle). The planes take 3× the bf16 route's Q bytes and 2.5× its K/V
// bytes in shared memory, so the f32 route has fewer or smaller key tiles
// in its ring (Tiles below).
//
// Head dims D ∈ {32, 64, 128, 256} on both routes; the wrapper rejects
// others. The dtype chooses the route; nothing falls back.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_smem.cuh"
#include "sm90.cuh"

namespace {

using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::pack_bf16;
using repro::pin;
using repro::sm90_desc;
using repro::smem_addr;

constexpr float kLog2e = 1.4426950408889634f;

// Tiles per head dim and route: WGS consumer warpgroups of 64 query rows,
// BK keys a tile, STAGES buffers in the ring. ptxas budgets registers for
// whole warpgroups, so a 288-thread block gets 168 a thread: enough for
// this loop up to D = 128 without spills (chip_smoke.py phase 2 prints the
// counts). At D = 256 the 64 × 256 accumulator alone takes 128: one
// consumer warpgroup (160 threads, up to 255 registers each) keeps it free
// of spills. The f32 route's shared memory (three Q planes, three K and two
// V planes a stage) fits 227 KB with two 128-key stages at D = 64 (209 KB;
// 13% faster at the 8b shape than three 64-key stages, tools/
// time_landmark_summary.py on an H100), 32-key tiles at D = 128 (217 KB)
// and one 32-key stage at D = 256 (177 KB).
template <int D, bool F32> struct Tiles;
template <> struct Tiles<32, false> {
  static constexpr int WGS = 2, BK = 128, STAGES = 3;
};
template <> struct Tiles<64, false> {
  static constexpr int WGS = 2, BK = 128, STAGES = 3;
};
template <> struct Tiles<128, false> {
  static constexpr int WGS = 2, BK = 64, STAGES = 3;
};
template <> struct Tiles<256, false> {
  static constexpr int WGS = 1, BK = 64, STAGES = 2;
};
template <> struct Tiles<32, true> {
  static constexpr int WGS = 2, BK = 128, STAGES = 3;
};
template <> struct Tiles<64, true> {
  static constexpr int WGS = 2, BK = 128, STAGES = 2;
};
template <> struct Tiles<128, true> {
  static constexpr int WGS = 2, BK = 32, STAGES = 3;
};
template <> struct Tiles<256, true> {
  static constexpr int WGS = 1, BK = 32, STAGES = 1;
};

// the swizzled shared-memory rows of a head dim, as TMA writes them
template <int D>
struct Swizzle {
  static constexpr int SW = D >= 64 ? 128 : 64;  // swizzle span, bytes
  static constexpr int AE = SW / 2;              // bf16 per swizzled row
  static constexpr int NCB = D / AE;             // column blocks of a tile
  static constexpr uint32_t MODE = SW == 128 ? 1 : 2;  // descriptor swizzle
};

template <int D, bool F32>
struct Layout : Swizzle<D> {
  static constexpr int QT = F32 ? 3 : 1;  // bf16 terms of q and of k
  static constexpr int VT = F32 ? 2 : 1;  // bf16 terms of v
  static constexpr int BQ = 64 * Tiles<D, F32>::WGS;  // query rows a block
  static constexpr int CONSUMERS = 128 * Tiles<D, F32>::WGS;
  static constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
  static constexpr int BK = Tiles<D, F32>::BK;
  static constexpr int STAGES = Tiles<D, F32>::STAGES;
  static constexpr int Q_BYTES = BQ * D * 2;    // one plane of the Q tile
  static constexpr int KV_BYTES = BK * D * 2;   // one plane of a K or V tile
  static constexpr int STAGE_BYTES = (QT + VT) * KV_BYTES;
  static constexpr size_t SMEM = 1024 + QT * Q_BYTES + STAGES * STAGE_BYTES;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the low and high bf16 halves of a bf16x2 register, as floats
__device__ __forceinline__ float lo_f32(uint32_t h) {
  return __uint_as_float(h << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t h) {
  return __uint_as_float(h & 0xffff0000u);
}

// p (two f32) → p_hi = bf16(p), p_lo = bf16(p − p_hi); p − p_hi is exact
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - lo_f32(hi), b - hi_f32(hi));
}

// x (n4 float4s) → `terms` bf16 planes (terms, 4·n4): plane t holds
// bf16(x − x0 − … − x_{t−1}), every subtraction exact in f32
__global__ void split_terms_kernel(const float4* __restrict__ x,
                                   uint2* __restrict__ planes, long long n4,
                                   int terms) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n4; i += step) {
    float4 r = x[i];
    for (int t = 0; t < terms; ++t) {
      const uint32_t a = pack_bf16(r.x, r.y), b = pack_bf16(r.z, r.w);
      planes[t * n4 + i] = make_uint2(a, b);
      r.x -= lo_f32(a);
      r.y -= hi_f32(a);
      r.z -= lo_f32(b);
      r.w -= hi_f32(b);
    }
  }
}

template <int D, bool F32>
__global__ void __launch_bounds__(Layout<D, F32>::THREADS, 1)
summary_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     float* __restrict__ out, int P, int N, int S, float c) {
  using L = Layout<D, F32>;
  constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES, SW = L::SW,
                AE = L::AE, QT = L::QT, VT = L::VT;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  __shared__ __align__(8) uint64_t q_bar;

  // tiles start on a 1024-byte boundary: the swizzle repeats every 8 rows.
  // QT Q planes, then STAGES stages of QT K planes and VT V planes
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  const uint32_t kv_s = q_s + QT * L::Q_BYTES;

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
    // plane t of problem `prob` is slice t·P + prob of its tensor map
    if (lane == 0) {
      const uint32_t qb = smem_addr(&q_bar);
      mbar_expect_tx(qb, QT * L::Q_BYTES);
      for (int a = 0; a < QT; ++a) {
        for (int cb = 0; cb < L::NCB; ++cb) {
          repro::tma_load_3d(q_s + a * L::Q_BYTES + cb * BQ * SW, &qmap, qb,
                             cb * AE, row0, a * P + prob);
        }
      }
      for (int t = 0; t < tiles; ++t) {
        const int st = t % STAGES;
        mbar_wait(smem_addr(&empty_bar[st]), ((t / STAGES) & 1) ^ 1);
        const uint32_t fb = smem_addr(&full_bar[st]);
        const uint32_t stage = kv_s + st * L::STAGE_BYTES;
        mbar_expect_tx(fb, L::STAGE_BYTES);
        for (int cb = 0; cb < L::NCB; ++cb) {
          for (int b = 0; b < QT; ++b) {
            repro::tma_load_3d(stage + b * L::KV_BYTES + cb * BK * SW, &kmap,
                               fb, cb * AE, t * BK, b * P + prob);
          }
          for (int b = 0; b < VT; ++b) {
            repro::tma_load_3d(stage + (QT + b) * L::KV_BYTES + cb * BK * SW,
                               &vmap, fb, cb * AE, t * BK, b * P + prob);
          }
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
    const uint32_t k_t = kv_s + st * L::STAGE_BYTES;
    const uint32_t v_t = k_t + QT * L::KV_BYTES;
    // f32: Q's address opaque to the compiler, so the 3·D/16 descriptors
    // of its planes are made again each tile instead of held in registers
    // across the loop (at D = 64 they spilled)
    uint32_t q_t = q_wg;
    if constexpr (F32) asm volatile("" : "+r"(q_t));

    // S = Σ q_a k_bᵀ over a + b < QT, the small products first and q0 k0
    // last; each over D in k16 steps: column block kk / (AE/16), 32 bytes
    // a step inside it
    float s[BK / 2];
    repro::wgmma_fence();
#pragma unroll
    for (int sum = QT - 1; sum >= 0; --sum) {
#pragma unroll
      for (int a = sum; a >= 0; --a) {
        const int b = sum - a;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int cb = kk / (AE / 16), off = (kk % (AE / 16)) * 32;
          const uint64_t da = sm90_desc(
              q_t + a * L::Q_BYTES + cb * BQ * SW + off, 16, 8 * SW,
              L::MODE);
          const uint64_t db = sm90_desc(
              k_t + b * L::KV_BYTES + cb * BK * SW + off, 16, 8 * SW,
              L::MODE);
          repro::wgmma_ss<BK>(s, da, db,
                              sum < QT - 1 || a < sum || kk > 0);
        }
      }
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

    // O += P_hi V0 + P_lo V0 (+ P_hi V1), k16 steps of 16 keys down V's rows
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
      if constexpr (VT == 2) {
        const uint64_t dv1 = sm90_desc(v_t + L::KV_BYTES + kc * 16 * SW,
                                       BK * SW, 8 * SW, L::MODE);
        repro::wgmma_rs<D>(o, p_hi[kc], dv1);
      }
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

// a (slices, rows, D) bf16 tensor as a 3-D map read in (AE, box_rows, 1)
// boxes
template <int D>
bool tensor_map(CUtensorMap* map, const void* base, int slices, int rows,
                int box_rows) {
  using W = Swizzle<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(slices)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(W::AE),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                W::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q (QT, P, N, D), k (QT, P, S, D), v (VT, P, S, D) bf16 planes → out
template <int D, bool F32>
int launch_summary(const void* q, const void* k, const void* v, void* out,
                   int P, int N, int S, float scale, cudaStream_t stream) {
  using L = Layout<D, F32>;
  CUtensorMap qm, km, vm;
  if (!tensor_map<D>(&qm, q, L::QT * P, N, L::BQ) ||
      !tensor_map<D>(&km, k, L::QT * P, S, L::BK) ||
      !tensor_map<D>(&vm, v, L::VT * P, S, L::BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static size_t sized[repro::kMaxDevices] = {};  // the >48 KB opt-in
  const cudaError_t err =
      repro::allow_smem(summary_wgmma_kernel<D, F32>, L::SMEM, sized);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + L::BQ - 1) / L::BQ, P);
  summary_wgmma_kernel<D, F32><<<grid, L::THREADS, L::SMEM, stream>>>(
      qm, km, vm, static_cast<float*>(out), P, N, S, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <bool F32>
int launch(const void* q, const void* k, const void* v, void* out, int P,
           int N, int S, int D, float scale, void* stream) {
  if (P <= 0 || N <= 0 || S <= 0 || P > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_summary<32, F32>(q, k, v, out, P, N, S, scale, st);
    case 64: return launch_summary<64, F32>(q, k, v, out, P, N, S, scale, st);
    case 128:
      return launch_summary<128, F32>(q, k, v, out, P, N, S, scale, st);
    case 256:
      return launch_summary<256, F32>(q, k, v, out, P, N, S, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// f32 x (n floats, n a multiple of 4, 16-byte aligned) → planes
// (terms, n) bf16, terms ∈ {1, 2, 3}: the f32 route's split pass.
extern "C" int split_bf16_terms(const void* x, void* planes, long long n,
                                int terms, void* stream) {
  if (n <= 0 || n % 4 || terms < 1 || terms > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n4 = n / 4;
  const int threads = 256;
  const long long want = (n4 + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  split_terms_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<uint2*>(planes), n4, terms);
  return static_cast<int>(cudaGetLastError());
}

// f32 inputs as bf16 planes from split_bf16_terms: q and k three terms
// (3, P, N, D) / (3, P, S, D), v two (2, P, S, D) → f32 out (P, N, D).
extern "C" int landmark_summary_f32(const void* q, const void* k,
                                    const void* v, void* out, int P, int N,
                                    int S, int D, float scale, void* stream) {
  return launch<true>(q, k, v, out, P, N, S, D, scale, stream);
}

// bf16 q, k, v (contiguous, 16-byte aligned) → f32 out, TMA + wgmma.
extern "C" int landmark_summary_bf16(const void* q, const void* k,
                                     const void* v, void* out, int P, int N,
                                     int S, int D, float scale, void* stream) {
  return launch<false>(q, k, v, out, P, N, S, D, scale, stream);
}
