// Masked co-rated similarity (d1) for Hopper: a tensor-core route (bf16
// wgmma, exact on rating data) and an f32 route on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/masked_similarity.py,
// masked_similarity_kernel (body _kernel): the six co-rated moments
//   z = Σ a·b, x = Σ a²·[b≠0], y = Σ [a≠0]·b², c = Σ [a≠0]·[b≠0],
//   sx = Σ a·[b≠0], sy = Σ [a≠0]·b
// over the item axis P, then the cosine, pearson or euclidean epilogue,
// with 0 where c <= 1. A rating of 0 means "missing", so the masks are
// built on the fly from the values themselves.
//
// What bounds it on an H100: at the fit shape (A = 5976 users, B = 20
// landmarks, P = 3952 items) R is read once, 95.3 MB: 0.0284 ms at
// 3.35 TB/s. On the CUDA cores the 12·A·B·P = 5.7 GFLOP of f32 work take
// 0.0846 ms at 67 TFLOP/s, so the f32 route is bound by operations; on the
// tensor cores (bf16 products of 2·A·N·P with N = 24 + 48 + 64 per 21
// landmarks, 6.4 GFLOP at 989 TFLOP/s, 0.0065 ms) the bytes bound it. At
// web_fit's shape (A = 245,760, B = 128, P = 65,536) R is 64.4 GB, 19.2 ms;
// the products, N = 32 + 64 + 96 per 32 landmarks (the 6·B columns a row
// needs), 24.7 TFLOP, 25.0 ms; the f32 route's work 369 ms.
//
// Tensor-core route: planes_kernel, a moments kernel, then the f32
// kernel's finalize mode.
// - exactness: the guard admits, while P <= 65535, multiples of ½ with
//   |v| <= 8, and while 65535 < P <= 262143 integers with |v| <= 8. Every
//   operand a, a², [a≠0] (and the same of b) is then exact in bf16, every
//   product a multiple of ¼ (an integer) exact in f32, and every partial
//   sum, in any order, a multiple of ¼ below 64·P < 2^22 (an integer below
//   64·P < 2^24): exact in f32. So the moments equal the f32 route's bit
//   for bit, atomics in any order included, and so does the epilogue,
//   which both routes share. Ratings 1..5 with 0 for missing are such
//   values (half stars too up to 65,535 items);
// - the guard: the kernels check every value they read and raise a flag
//   in the workspace on one the route cannot hold exactly (NaN and ±inf
//   included); the finalize launch, in the same stream, reads the flag and
//   computes the f32 route instead when it is set. No host sync. P is
//   checked on the host (past 262,143 the host takes the f32 route);
// - planes_kernel writes the landmark planes [b≠0 ; b ; b²] (3 × lm
//   landmarks: lm = 21 in one 64-column atom, one zero column, or lm = 32
//   in two) once per call, as bf16 8 KB atoms of 64 items already in the
//   shared-memory layout wgmma reads (MN-major, 128-byte swizzle): 0.5 MB
//   at the fit shape, 67 MB at web_fit's;
// - per k16 step each thread reads its A fragment's eight f32 values from
//   shared memory, checks them, and forms a, [a≠0] and a² as bf16 register
//   fragments; three wgmmas with A from registers against the same B tile
//   give a²·[b≠0] (x), a·[b≠0 ; b] (sx, z) and [a≠0]·[b≠0 ; b ; b²]
//   (c, sy, y): m64n24, m64n48, m64n64 at lm = 21, m64n32, m64n64, m64n96
//   at lm = 32. R never goes to device memory in bf16;
// - the item order inside a k16 step is permuted so that a thread's four
//   values of one row (logical k 2t, 2t+1, 2t+8, 2t+9) are four adjacent
//   items: one 16-byte shared-memory read, conflict-free because the
//   chunks of rows gid and gid + 1 sit in the two halves of a 128-byte
//   line (an XOR of the chunk index with the row's parity; in the cluster
//   kernel TMA's 128-byte swizzle, with fragment row gid read from shared
//   row frag_row(gid)). The planes are written in the same order (row k
//   of a step holds item perm⁻¹(k)), so the sums are the same;
// - one N tile (B <= 21), more than 128 landmarks, or r_a rows not on 16
//   bytes: moments_wgmma_kernel. One block of two warpgroups owns 128 rows
//   of r_a and one N tile at a time; a ring of four slots of 64 items, two
//   stages loaded ahead by cp.async from all 256 threads: the planes tile
//   (8 KB) and the A tile (128 × 64 f32, 32 KB), 16-byte copies where
//   P % 4 == 0 and r_a is 16-byte aligned (P = 3952), 4-byte copies
//   otherwise; copies past A or P zero-fill. A stage's wgmmas run on while
//   the next stage is converted (wait_group 1). The (row tile, N tile,
//   stage) units are split evenly over one block per SM (stream-K), so R
//   is read once per N tile;
// - 22..128 landmarks with 16-byte rows: moments_cluster_kernel. A
//   thread-block cluster holds one block per N tile of 32 landmarks (up to
//   4); the blocks walk the same (row tile, stage) units in step, and each
//   A stage leaves HBM once: the producer warp of each block multicasts
//   its share of the stage's eight TMA boxes (32 rows × 32 items; zeros
//   past A and P) into the same slot of every block of the cluster, and
//   loads its own N tile's planes. Full and empty mbarriers a slot (four
//   slots of 48 KB): a block's copies land on every block's full barrier,
//   and each consumer warp releases a slot to every block's producer. Each
//   block checks only its share of the stage's values (the flag is the
//   cluster's: every value is checked once) and forms [a≠0] and a² in
//   bf16x2 from a. The (row tile, stage) units are split evenly over the
//   clusters that fit the card at once (stream-K: at web_fit's shape 30
//   clusters of 64 row tiles each, which walk the planes in step, so L2
//   keeps them); R is read with an evict-first L2 policy, the planes
//   evict-last. Measured (PERF.md): the blocks of a cluster each
//   convert the whole A stage, and that conversion, not HBM, sets the
//   time at 4 N tiles (bulk copies of single 256-byte rows were slower
//   still: one TMA request a row);
// - either moments kernel flushes its partial moments with f32 atomicAdd
//   into a (6, B, A) workspace when its row tile changes and at its end;
//   every partial sum is exact, so any order gives the same bits;
// - the finalize launch is the f32 kernel in finalize mode: one block per
//   32 × 32 outputs reads the six moments, applies finalize() unchanged,
//   and writes its outputs through shared memory in row order.
//
// f32 route (masked_similarity_kernel): every moment in registers, each R
// tile read from device memory once per column tile of B: one block owns a
// 32×32 output tile (256 threads, 2×2 outputs each, 24 accumulators a
// thread), streams P in 64-wide shared-memory tiles of both operands. On
// integer ratings every moment is an exact integer in f32 while
// P·25 < 2^24.
//
// Both routes apply the epilogue in the same order of operations as the
// plain version (core/similarity.py::_finalize) with round-to-nearest
// intrinsics the compiler may not contract, so cosine on integer ratings
// agrees with the plain version bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_smem.cuh"
#include "sm90.cuh"

namespace {

using repro::pack_bf16;
using repro::pin;
using repro::sm90_desc;
using repro::smem_addr;
using repro::wgmma_wait;

constexpr float kEps = 1e-8f;
constexpr int kBA = 32;   // rows of r_a per block
constexpr int kBB = 32;   // rows of r_b per block
constexpr int kBP = 64;   // items per shared-memory tile
constexpr int kThreads = 256;  // 16 x 16 threads, 2 x 2 outputs each

// tensor-core route: half stars while P < 2^16 keeps every sum below 2^22,
// integers while P < 2^18 keeps every sum below 2^24
constexpr int kHalfItems = 65535;
constexpr int kIntItems = 262143;
constexpr float kGuardMax = 8.0f;
constexpr int kWGs = 2;                  // consumer warpgroups a block
constexpr int kRows = 64 * kWGs;         // rows of r_a a block
constexpr int kTcThreads = 128 * kWGs;
constexpr int kItems = 64;               // items a stage: four k16 steps
constexpr int kLm = 21;                  // landmarks an N tile (3 · 21 ≤ 64)
constexpr int kStages = 4;
constexpr int kAhead = kStages - 2;  // stages loaded ahead of the one used
constexpr int kPlaneBytes = kItems * 128;    // bf16 planes: 64 k rows × 64 n
constexpr int kAStage = kRows * kItems * 4;  // f32 A tile, 32 KB
constexpr int kStageBytes = kPlaneBytes + kAStage;  // a multiple of 1024
constexpr size_t kTcSmem = 1024 + kStages * kStageBytes;
enum Moment { kZ = 0, kX, kY, kC, kSx, kSy };

__device__ __forceinline__ float finalize(int measure, float z, float x,
                                          float y, float c, float sx,
                                          float sy) {
  if (!(c > 1.0f)) return 0.0f;
  if (measure == 0) {  // cosine
    float den = fmaxf(__fmul_rn(__fsqrt_rn(x), __fsqrt_rn(y)), kEps);
    return __fdiv_rn(z, den);
  }
  if (measure == 1) {  // pearson
    float cc = fmaxf(c, 1.0f);
    float cov = __fsub_rn(z, __fdiv_rn(__fmul_rn(sx, sy), cc));
    float va = fmaxf(__fsub_rn(x, __fdiv_rn(__fmul_rn(sx, sx), cc)), 0.0f);
    float vb = fmaxf(__fsub_rn(y, __fdiv_rn(__fmul_rn(sy, sy), cc)), 0.0f);
    float den = fmaxf(__fmul_rn(__fsqrt_rn(va), __fsqrt_rn(vb)), kEps);
    return __fdiv_rn(cov, den);
  }
  // euclidean distance over the co-rated set
  float d2 = __fadd_rn(__fsub_rn(x, __fmul_rn(2.0f, z)), y);
  return __fsqrt_rn(fmaxf(d2, 0.0f));
}

// The f32 route, and the tensor-core route's finalize launch.
// `moments` null: the f32 route. Else the (6, B, A) moments of the
// tensor-core route: finalized here unless `*flag` is set (a value failed
// the route's guard), in which case the f32 route runs instead; `results`
// counts [finalized, f32 instead] calls.
__global__ void __launch_bounds__(kThreads)
masked_similarity_kernel(const float* __restrict__ ra,
                         const float* __restrict__ rb,
                         float* __restrict__ out, int A, int B, int P,
                         int measure, const float* __restrict__ moments,
                         const int* __restrict__ flag,
                         int* __restrict__ results) {
  // transposed tiles: [item][row]; the +1 pad keeps the transposing
  // stores free of bank conflicts
  __shared__ float as[kBP][kBA + 1];
  __shared__ float bs[kBP][kBB + 1];
  const int a0 = blockIdx.x * kBA;
  const int b0 = blockIdx.y * kBB;
  const bool first = blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0;

  if (moments != nullptr && *flag == 0) {
    // thread: row a0 + r, columns b0 + cg + 8j; as[col][row] holds the
    // tile so that the outputs leave in row order
    const int r = threadIdx.x & 31, cg = threadIdx.x >> 5;
    const size_t plane = static_cast<size_t>(A) * B;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = cg + 8 * j, gr = a0 + r, gc = b0 + col;
      float v = 0.0f;
      if (gr < A && gc < B) {
        const float* m = moments + static_cast<size_t>(gc) * A + gr;
        v = finalize(measure, m[kZ * plane], m[kX * plane], m[kY * plane],
                     m[kC * plane], m[kSx * plane], m[kSy * plane]);
      }
      as[col][r] = v;
    }
    __syncthreads();
    const int na = min(kBA, A - a0), nb = min(kBB, B - b0);
    for (int i = threadIdx.x; i < na * nb; i += kThreads) {
      const int rr = i / nb, cc = i % nb;
      out[static_cast<size_t>(a0 + rr) * B + b0 + cc] = as[cc][rr];
    }
    if (first) atomicAdd(&results[0], 1);
    return;
  }
  if (moments != nullptr && first) atomicAdd(&results[1], 1);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float z[2][2] = {}, x[2][2] = {}, y[2][2] = {};
  float c[2][2] = {}, sx[2][2] = {}, sy[2][2] = {};

  for (int p0 = 0; p0 < P; p0 += kBP) {
    // coalesced loads: consecutive threads read consecutive items of a row
    for (int e = threadIdx.x; e < kBA * kBP; e += kThreads) {
      const int r = e / kBP, p = e % kBP;
      const int gr = a0 + r, gp = p0 + p;
      as[p][r] = (gr < A && gp < P) ? ra[(size_t)gr * P + gp] : 0.0f;
    }
    for (int e = threadIdx.x; e < kBB * kBP; e += kThreads) {
      const int r = e / kBP, p = e % kBP;
      const int gr = b0 + r, gp = p0 + p;
      bs[p][r] = (gr < B && gp < P) ? rb[(size_t)gr * P + gp] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int p = 0; p < kBP; ++p) {
      float a[2], a2[2], ma[2], b[2], b2[2], mb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i] = as[p][ty + 16 * i];
        a2[i] = a[i] * a[i];
        ma[i] = a[i] != 0.0f ? 1.0f : 0.0f;
        b[i] = bs[p][tx + 16 * i];
        b2[i] = b[i] * b[i];
        mb[i] = b[i] != 0.0f ? 1.0f : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          z[i][j] = fmaf(a[i], b[j], z[i][j]);
          x[i][j] = fmaf(a2[i], mb[j], x[i][j]);
          y[i][j] = fmaf(ma[i], b2[j], y[i][j]);
          c[i][j] = fmaf(ma[i], mb[j], c[i][j]);
          sx[i][j] = fmaf(a[i], mb[j], sx[i][j]);
          sy[i][j] = fmaf(ma[i], b[j], sy[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = a0 + ty + 16 * i, col = b0 + tx + 16 * j;
      if (r < A && col < B) {
        out[(size_t)r * B + col] = finalize(measure, z[i][j], x[i][j],
                                            y[i][j], c[i][j], sx[i][j],
                                            sy[i][j]);
      }
    }
  }
}

// ------------------------------------------------------ tensor-core route
// a value the route holds exactly: with |v| ≤ 8, a multiple of ½ (HALF:
// while P <= kHalfItems) or an integer (false for NaN and ±inf)
template <bool HALF>
__device__ __forceinline__ bool exact_value(float v) {
  const float t = HALF ? __fmul_rn(v, 2.0f) : v;
  return fabsf(v) <= kGuardMax && t == rintf(t);
}
template <bool HALF>
__device__ __forceinline__ bool exact4(float4 v) {
  return exact_value<HALF>(v.x) & exact_value<HALF>(v.y) &
         exact_value<HALF>(v.z) & exact_value<HALF>(v.w);
}

// bf16x2 products and minima, round to nearest
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf16x2_min(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("min.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
constexpr uint32_t kOnes = 0x3F803F80u;  // 1.0, 1.0 in bf16

// [a≠0], [b≠0] as a bf16x2 register
__device__ __forceinline__ uint32_t pack_mask(float a, float b) {
  return (a != 0.0f ? 0x3F80u : 0u) | (b != 0.0f ? 0x3F800000u : 0u);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// shared-memory stores of this thread → visible to wgmma's operand reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void zero(float (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) r[i] = 0.0f;
}

// byte offset of bf16 (k, n) in a planes tile: 128-byte rows of 64 n,
// 16-byte chunks swizzled by k mod 8 (the layout TMA's 128-byte swizzle
// writes, MN-major)
__device__ __forceinline__ uint32_t plane_offset(int k, int n) {
  return k * 128 + ((((n >> 3) ^ (k & 7))) << 4) + (n & 7) * 2;
}

// plane_offset of column n in a tile of 64-column atoms, 8 KB apart
__device__ __forceinline__ uint32_t atom_offset(int k, int n) {
  return (n >> 6) * kPlaneBytes + plane_offset(k, n & 63);
}

// The landmark planes of every (N tile, stage), as the moments kernels
// stage them: block (ks, n) writes the tile of items 64·ks.. of landmarks
// lm·n.. (one 8 KB atom of 64 columns at lm = 21, two at lm = 32),
// [b≠0 ; b ; b²] in columns 0.., lm.., 2·lm.. (the rest zero), physical
// item p of a k16 step in its logical row
// 2·(p/4) + (p & 1) + 8·((p/2) & 1). Raises `flag` on a value the route
// cannot hold.
template <int LM, bool HALF>
__global__ void __launch_bounds__(kThreads)
planes_kernel(const float* __restrict__ rb, uint4* __restrict__ planes,
              int* __restrict__ flag, int B, int P, int k_stages) {
  // 64 columns an 8 KB atom: one at LM = 21, two at LM = 32
  constexpr int tile_bytes = (3 * LM + 63) / 64 * kPlaneBytes;
  constexpr int lm = LM;
  __shared__ __align__(16) uint8_t tile[tile_bytes];
  auto offset = [](int k, int n) {
    return tile_bytes == kPlaneBytes ? plane_offset(k, n) : atom_offset(k, n);
  };
  const int ks = blockIdx.x, n = blockIdx.y, tid = threadIdx.x;
  for (int i = tid; i < tile_bytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(tile)[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  bool ok = true;
  for (int e = tid; e < lm * kItems; e += kThreads) {
    const int l = e >> 6, item = e & 63;
    const int gl = n * lm + l, gi = ks * kItems + item;
    const float v = gl < B && gi < P ? rb[static_cast<size_t>(gl) * P + gi]
                                     : 0.0f;
    ok &= exact_value<HALF>(v);
    const int p = item & 15;
    const int k = (item & ~15) | ((p >> 2) << 1) | (p & 1) | ((p & 2) << 2);
    *reinterpret_cast<uint16_t*>(tile + offset(k, l)) =
        v != 0.0f ? 0x3F80u : 0u;
    *reinterpret_cast<__nv_bfloat16*>(tile + offset(k, lm + l)) =
        __float2bfloat16_rn(v);
    *reinterpret_cast<__nv_bfloat16*>(tile + offset(k, 2 * lm + l)) =
        __float2bfloat16_rn(__fmul_rn(v, v));
  }
  if (!ok) *flag = 1;
  __syncthreads();
  uint4* dst = planes + (static_cast<size_t>(n) * k_stages + ks) *
                            (tile_bytes / 16);
  for (int i = tid; i < tile_bytes / 16; i += kThreads) {
    dst[i] = reinterpret_cast<const uint4*>(tile)[i];
  }
}

// Stage unit u (tile = u / k_stages, stage u % k_stages; tile = m·NT + n)
// into ring slot `dst`: the N tile's planes for the stage (8 KB), then the
// A tile (128 rows × 64 items f32, row r's 16-byte chunk c at c ^ 4·(r & 1)).
template <bool VEC>
__device__ __forceinline__ void stage_unit(const float* __restrict__ ra,
                                           const uint4* __restrict__ planes,
                                           uint32_t dst, long long u,
                                           int k_stages, int n_tiles, int A,
                                           int P) {
  const long long tile = u / k_stages;
  const int ks = static_cast<int>(u - tile * k_stages);
  const int m = static_cast<int>(tile / n_tiles);
  const int n = static_cast<int>(tile - static_cast<long long>(m) * n_tiles);
  const int row0 = m * kRows, item0 = ks * kItems;
  const int tid = threadIdx.x;
  const uint4* src = planes + (static_cast<size_t>(n) * k_stages + ks) *
                                  (kPlaneBytes / 16);
#pragma unroll
  for (int i = 0; i < kPlaneBytes / 16 / kTcThreads; ++i) {
    const int q = tid + i * kTcThreads;
    cp_async16(dst + q * 16, src + q, 16);
  }
  const uint32_t a_dst = dst + kPlaneBytes;
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < kRows * 16 / kTcThreads; ++i) {
      const int q = tid + i * kTcThreads;
      const int r = q >> 4, c = q & 15;
      const int gr = row0 + r, gi = item0 + 4 * c;
      const bool live = gr < A && gi < P;
      cp_async16(a_dst + r * 256 + ((c ^ ((r & 1) << 2)) << 4),
                 live ? ra + static_cast<size_t>(gr) * P + gi : ra,
                 live ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kRows * kItems / kTcThreads; ++i) {
      const int e = tid + i * kTcThreads;
      const int r = e >> 6, it = e & 63;
      const int gr = row0 + r, gi = item0 + it;
      const bool live = gr < A && gi < P;
      cp_async4(a_dst + r * 256 + ((((it >> 2) ^ ((r & 1) << 2))) << 4) +
                    (it & 3) * 4,
                live ? ra + static_cast<size_t>(gr) * P + gi : ra,
                live ? 4 : 0);
    }
  }
}

// the shared-memory row of the A fragment row gid in the cluster kernel:
// rows gid and gid + 1 of a warp land four rows apart, so their swizzled
// chunks fall in the two halves of the 128 bytes and the 16-byte reads
// are free of conflicts
__device__ __forceinline__ int frag_row(int gid) {
  return (gid >> 1) | ((gid & 1) << 2);
}

// Partial moments of this warp's 16 rows → the (6, B, A) workspace, for
// N tiles of LM landmarks. Accumulator element 4j + e: row
// gid + 8·(e >> 1) (frag_row(gid) + 8·(e >> 1) when PERM), column
// 8j + 2·tig + (e & 1) = LM·plane + landmark of [b≠0 ; b ; b²]: a² times
// the first 8·NQ columns (x), a times the first 8·NA (sx, z), [a≠0] times
// the first 8·NM (c, sy, y).
template <int LM, int NQ, int NA, int NM, bool PERM = false>
__device__ __forceinline__ void flush(float* __restrict__ ws,
                                      const float (&acc_q)[4 * NQ],
                                      const float (&acc_a)[4 * NA],
                                      const float (&acc_m)[4 * NM],
                                      int row_base, int lm0, int A, int B) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t mstride = static_cast<size_t>(B) * A;
#pragma unroll
  for (int j = 0; j < NM; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row_base + (PERM ? frag_row(gid) : gid) + 8 * (e >> 1);
      const int col = 8 * j + 2 * tig + (e & 1);
      const int plane = col / LM, l = lm0 + col - plane * LM;
      if (row >= A || l >= B || plane > 2) continue;
      float* w = ws + static_cast<size_t>(l) * A + row;
      const float vm = acc_m[4 * j + e];
      if (vm != 0.0f) {
        atomicAdd(w + mstride * (plane == 0 ? kC : plane == 1 ? kSy : kY),
                  vm);
      }
      if (j < NA && plane < 2 && acc_a[4 * j + e] != 0.0f) {
        atomicAdd(w + mstride * (plane == 0 ? kSx : kZ), acc_a[4 * j + e]);
      }
      if (j < NQ && plane == 0 && acc_q[4 * j + e] != 0.0f) {
        atomicAdd(w + mstride * kX, acc_q[4 * j + e]);
      }
    }
  }
}

template <bool VEC, bool HALF>
__global__ void __launch_bounds__(kTcThreads, 1)
moments_wgmma_kernel(const float* __restrict__ ra,
                     const uint4* __restrict__ planes, float* __restrict__ ws,
                     int* __restrict__ flag, int A, int B, int P,
                     int k_stages, int n_tiles, long long units) {
  extern __shared__ uint8_t smem_raw[];
  // slots on a 1024-byte boundary (the planes' swizzle repeats every 8
  // rows): the planes tile, then the A tile
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint8_t* const ring_p = smem_raw + (ring - raw);

  const long long u0 = units * blockIdx.x / gridDim.x;
  const long long u1 = units * (blockIdx.x + 1) / gridDim.x;
  if (u0 >= u1) return;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // this warp's first row of the block's 128; the thread's: + gid, + gid + 8
  const int w_row = (warp >> 2) * 64 + (warp & 3) * 16;

#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (u0 + s < u1) {
      stage_unit<VEC>(ra, planes, ring + s * kStageBytes, u0 + s, k_stages,
                      n_tiles, A, P);
    }
    cp_async_commit();
  }

  float acc_q[12], acc_a[24], acc_m[32];
  zero(acc_q);
  zero(acc_a);
  zero(acc_m);
  bool ok = true;
  long long cur = u0 / k_stages;

  for (long long u = u0; u < u1; ++u) {
    const int it = static_cast<int>(u - u0);
    const uint32_t slot = ring + (it % kStages) * kStageBytes;
    cp_async_wait<kAhead - 1>();
    fence_async_shared();
    // stage `it` has landed in every thread's part; the wgmmas of stage
    // it − 2, whose slot the next load takes, are done in every warpgroup
    __syncthreads();
    if (u + kAhead < u1) {
      stage_unit<VEC>(ra, planes, ring + ((it + kAhead) % kStages) *
                                           kStageBytes,
                      u + kAhead, k_stages, n_tiles, A, P);
    }
    cp_async_commit();

    const long long tile = u / k_stages;
    if (tile != cur) {
      wgmma_wait<0>();
      pin(acc_q);
      pin(acc_a);
      pin(acc_m);
      const int m = static_cast<int>(cur / n_tiles);
      flush<kLm, 3, 6, 8>(
          ws, acc_q, acc_a, acc_m, m * kRows + w_row,
          static_cast<int>(cur - static_cast<long long>(m) * n_tiles) * kLm,
          A, B);
      zero(acc_q);
      zero(acc_a);
      zero(acc_m);
      cur = tile;
    }

    // four k16 steps: the thread's rows gid and gid + 8 of the warp's 16,
    // items 16s + 4·tig..+3 (logical k 2·tig, 2·tig+1, 2·tig+8, 2·tig+9)
    const float* at = reinterpret_cast<const float*>(
                          ring_p + (slot - ring) + kPlaneBytes) +
                      (w_row + gid) * kItems;
#pragma unroll
    for (int s = 0; s < kItems / 16; ++s) {
      const int chunk = (4 * s + tig) ^ ((gid & 1) << 2);
      const float4 x = *reinterpret_cast<const float4*>(at + chunk * 4);
      const float4 y =
          *reinterpret_cast<const float4*>(at + 8 * kItems + chunk * 4);
      ok &= exact_value<HALF>(x.x) & exact_value<HALF>(x.y) &
            exact_value<HALF>(x.z) & exact_value<HALF>(x.w) &
            exact_value<HALF>(y.x) & exact_value<HALF>(y.y) &
            exact_value<HALF>(y.z) & exact_value<HALF>(y.w);
      // A fragments: reg 0 (row gid, k 2t..2t+1), 1 (row gid+8, same k),
      // 2 (row gid, k 2t+8..2t+9), 3 (row gid+8, same k)
      const uint32_t fa[4] = {pack_bf16(x.x, x.y), pack_bf16(y.x, y.y),
                              pack_bf16(x.z, x.w), pack_bf16(y.z, y.w)};
      const uint32_t fm[4] = {pack_mask(x.x, x.y), pack_mask(y.x, y.y),
                              pack_mask(x.z, x.w), pack_mask(y.z, y.w)};
      const uint32_t fq[4] = {
          pack_bf16(__fmul_rn(x.x, x.x), __fmul_rn(x.y, x.y)),
          pack_bf16(__fmul_rn(y.x, y.x), __fmul_rn(y.y, y.y)),
          pack_bf16(__fmul_rn(x.z, x.z), __fmul_rn(x.w, x.w)),
          pack_bf16(__fmul_rn(y.z, y.z), __fmul_rn(y.w, y.w))};
      const uint64_t db =
          sm90_desc(slot + s * 16 * 128, kItems * 128, 8 * 128, 1);
      repro::wgmma_fence();
      repro::wgmma_rs<24>(acc_q, fq, db);
      repro::wgmma_rs<48>(acc_a, fa, db);
      repro::wgmma_rs<64>(acc_m, fm, db);
    }
    repro::wgmma_commit();
    // this stage's products run on while the next stage is converted
    wgmma_wait<1>();
  }

  wgmma_wait<0>();
  pin(acc_q);
  pin(acc_a);
  pin(acc_m);
  const int m = static_cast<int>(cur / n_tiles);
  flush<kLm, 3, 6, 8>(
      ws, acc_q, acc_a, acc_m, m * kRows + w_row,
      static_cast<int>(cur - static_cast<long long>(m) * n_tiles) * kLm, A,
      B);
  if (!ok) *flag = 1;
}

template <bool VEC, bool HALF>
cudaError_t launch_moments(const float* ra, const uint4* planes, float* ws,
                           int* flag, int A, int B, int P, int k_stages,
                           int n_tiles, long long units, cudaStream_t st) {
  static size_t sized[repro::kMaxDevices] = {};  // the >48 KB opt-in
  cudaError_t err =
      repro::allow_smem(moments_wgmma_kernel<VEC, HALF>, kTcSmem, sized);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(units < sms ? units : sms);
  moments_wgmma_kernel<VEC, HALF><<<grid, kTcThreads, kTcSmem, st>>>(
      ra, planes, ws, flag, A, B, P, k_stages, n_tiles, units);
  return cudaGetLastError();
}


// ------------------------------------------------ the cluster moments kernel
constexpr int kCLm = 32;  // landmarks an N tile: 3 · 32 = 96 columns
constexpr int kMaxCluster = 4;  // N tiles a cluster: up to 128 landmarks
constexpr int kCPlaneBytes = 2 * kPlaneBytes;  // two 64-column atoms
constexpr int kCThreads = kTcThreads + 32;  // two consumer warpgroups and
                                            // a producer warp
// the A tile of a stage: two halves of 32 items (128-byte rows, the
// 128-byte swizzle), each four TMA boxes of 32 rows
constexpr int kBoxRows = 32, kBoxItems = 32;
constexpr int kBoxBytes = kBoxRows * kBoxItems * 4;  // 4 KB
constexpr int kHalfBytes = kRows * kBoxItems * 4;    // 16 KB
constexpr int kBoxes = 2 * kRows / kBoxRows;         // 8 a stage
constexpr int kCStageBytes = kCPlaneBytes + 2 * kHalfBytes;  // 48 KB
constexpr int kCStages = 4;
constexpr size_t kCSmem = 1024 + kCStages * kCStageBytes;

// One cluster of `n_tiles` blocks, block rank n holding N tile n (32
// landmarks), walks the (row tile, stage) units [u0, u1) of its share.
// Slot s of the ring: the block's planes tile (16 KB), then the A tile
// (32 KB); a full and an empty mbarrier a slot. The producer warp's lane 0
// waits until every block of the cluster has released the slot, announces
// the stage's 48 KB on its own full barrier, loads its planes tile and
// multicasts its share of the stage's eight A boxes (boxes rank,
// rank + n_tiles, ...) into every block. The consumer warpgroups convert
// and multiply as moments_wgmma_kernel does (m64n32, m64n64, m64n96), one
// k16 step in flight while the next one's operands are formed, and once a
// stage's products are done release its slot to every block.
template <bool HALF>
__global__ void __launch_bounds__(kCThreads, 1)
moments_cluster_kernel(const __grid_constant__ CUtensorMap amap,
                       const uint4* __restrict__ planes,
                       float* __restrict__ ws, int* __restrict__ flag, int A,
                       int B, int k_stages, long long units) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kCStages];  // full, then empty
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint8_t* const ring_p = smem_raw + (ring - raw);
  const uint32_t full0 = smem_addr(bars), empty0 = full0 + 8 * kCStages;
  const int rank = repro::cluster_rank(), n_tiles = repro::cluster_size();
  const long long clusters = gridDim.x / n_tiles, c = blockIdx.x / n_tiles;
  const long long u0 = units * c / clusters;
  const long long n = units * (c + 1) / clusters - u0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kCStages; ++s) {
      repro::mbar_init(full0 + 8 * s, 1);
      repro::mbar_init(empty0 + 8 * s, 8 * n_tiles);  // 8 warps a block
    }
    repro::mbar_init_fence();
  }
  // every block's barriers are set before any copy or remote arrival
  repro::cluster_sync();

  if (warp == 8) {  // the producer
    if (lane == 0) {
      const uint64_t once = repro::l2_evict_first();
      const uint64_t again = repro::l2_evict_last();
      const uint16_t all = static_cast<uint16_t>((1u << n_tiles) - 1);
      for (long long j = 0; j < n; ++j) {
        const int s = static_cast<int>(j % kCStages);
        if (j >= kCStages) {
          repro::mbar_wait(empty0 + 8 * s, ((j / kCStages) - 1) & 1);
        }
        const long long m = (u0 + j) / k_stages;
        const int ks = static_cast<int>(u0 + j - m * k_stages);
        const uint32_t slot = ring + s * kCStageBytes, bar = full0 + 8 * s;
        repro::mbar_expect_tx(bar, kCStageBytes);
        repro::bulk_load_hint(
            slot,
            planes + (static_cast<size_t>(rank) * k_stages + ks) *
                         (kCPlaneBytes / 16),
            kCPlaneBytes, bar, again);
        for (int box = rank; box < kBoxes; box += n_tiles) {
          const int half = box / (kRows / kBoxRows);
          const int g = box % (kRows / kBoxRows);
          repro::tma_load_2d_multicast(
              slot + kCPlaneBytes + half * kHalfBytes + g * kBoxBytes, &amap,
              bar, ks * kItems + half * kBoxItems,
              static_cast<int>(m) * kRows + g * kBoxRows, all, once);
        }
      }
    }
  } else {  // the consumers
    const int gid = lane >> 2, tig = lane & 3;
    const int w_row = (warp >> 2) * 64 + (warp & 3) * 16;
    const int row = w_row + frag_row(gid);  // and row + 8: the same & 7
    // the (k16 step, row half) chunks j = 2·step + half of a stage this
    // block checks: every value of the stage is checked by one block
    unsigned mine = 0;
    for (int j = 0; j < 8; ++j) mine |= (j % n_tiles == rank ? 1u : 0u) << j;
    // [a≠0] from a²: a² >= ¼ (HALF) or 1 when a ≠ 0, so a²·4 (or a²)
    // capped at 1; the factor twice in bf16
    constexpr uint32_t kSquare = HALF ? 0x40804080u : kOnes;
    float acc_q[16], acc_a[32], acc_m[48];
    zero(acc_q);
    zero(acc_a);
    zero(acc_m);
    bool ok = true;
    long long cur = u0 / k_stages;
    for (long long it = 0; it < n; ++it) {
      const int s = static_cast<int>(it % kCStages);
      repro::mbar_wait(full0 + 8 * s, (it / kCStages) & 1);
      const long long tile = (u0 + it) / k_stages;
      if (tile != cur) {
        wgmma_wait<0>();
        pin(acc_q);
        pin(acc_a);
        pin(acc_m);
        flush<kCLm, 4, 8, 12, true>(ws, acc_q, acc_a, acc_m,
                                    static_cast<int>(cur) * kRows + w_row,
                                    rank * kCLm, A, B);
        zero(acc_q);
        zero(acc_a);
        zero(acc_m);
        cur = tile;
      }
      const uint32_t slot = ring + s * kCStageBytes;
      const uint8_t* at = ring_p + s * kCStageBytes + kCPlaneBytes + row * 128;
#pragma unroll
      for (int k = 0; k < kItems / 16; ++k) {
        // rows `row` and row + 8, items 16k + 4·tig..+3: chunk
        // 4·(k & 1) + tig of half k >> 1, swizzled by the row
        const int off = (k >> 1) * kHalfBytes +
                        (((4 * (k & 1) + tig) ^ (row & 7)) << 4);
        const float4 x = *reinterpret_cast<const float4*>(at + off);
        const float4 y = *reinterpret_cast<const float4*>(at + off + 8 * 128);
        if (mine & (1u << (2 * k))) ok &= exact4<HALF>(x);
        if (mine & (2u << (2 * k))) ok &= exact4<HALF>(y);
        // a; a² = a·a and [a≠0] = min(a²·4, 1) (HALF) or min(a², 1),
        // both in bf16 and exact on every value the guard admits
        const uint32_t fa[4] = {pack_bf16(x.x, x.y), pack_bf16(y.x, y.y),
                                pack_bf16(x.z, x.w), pack_bf16(y.z, y.w)};
        uint32_t fq[4], fm[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fq[i] = bf16x2_mul(fa[i], fa[i]);
          fm[i] = bf16x2_min(bf16x2_mul(fq[i], kSquare), kOnes);
        }
        const uint64_t db =
            sm90_desc(slot + k * 16 * 128, kItems * 128, 8 * 128, 1);
        repro::wgmma_fence();
        repro::wgmma_rs<32>(acc_q, fq, db);
        repro::wgmma_rs<64>(acc_a, fa, db);
        repro::wgmma_rs<96>(acc_m, fm, db);
        repro::wgmma_commit();
        wgmma_wait<1>();
      }
      // the previous stage's products are done: its slot goes back to
      // every block of the cluster
      if (it > 0) {
        __syncwarp();
        if (lane < n_tiles) {
          repro::mbar_arrive_remote(
              empty0 + 8 * static_cast<int>((it - 1) % kCStages), lane);
        }
      }
    }
    wgmma_wait<0>();
    pin(acc_q);
    pin(acc_a);
    pin(acc_m);
    if (n > 0) {
      flush<kCLm, 4, 8, 12, true>(ws, acc_q, acc_a, acc_m,
                                  static_cast<int>(cur) * kRows + w_row,
                                  rank * kCLm, A, B);
    }
    if (!ok) *flag = 1;
  }
  // no block leaves while another may still arrive on its barriers
  __syncwarp();
  repro::cluster_sync();
}

// The cluster kernel over `units` (row tile, stage) units: as many
// clusters of `n_tiles` blocks as fit the card at once.
template <bool HALF>
cudaError_t launch_cluster(const float* ra, const uint4* planes, float* ws,
                           int* flag, int A, int B, int P, int k_stages,
                           int n_tiles, long long units, cudaStream_t st) {
  static size_t sized[repro::kMaxDevices] = {};
  static int fit[repro::kMaxDevices][kMaxCluster + 1] = {};
  CUtensorMap amap;
  if (!repro::f32_tensor_map(&amap, ra, A, P, kBoxRows, kBoxItems)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err =
      repro::allow_smem(moments_cluster_kernel<HALF>, kCSmem, sized);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_tiles;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = kCSmem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int most = dev < repro::kMaxDevices ? fit[dev][n_tiles] : 0;
  if (most == 0) {
    err = cudaOccupancyMaxActiveClusters(&most, moments_cluster_kernel<HALF>,
                                         &cfg);
    if (err != cudaSuccess) return err;
    if (most <= 0) return cudaErrorInvalidConfiguration;
    if (dev < repro::kMaxDevices) fit[dev][n_tiles] = most;
  }
  const long long clusters = units < most ? units : most;
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * n_tiles));
  err = cudaLaunchKernelEx(&cfg, moments_cluster_kernel<HALF>, amap, planes,
                           ws, flag, A, B, k_stages, units);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int masked_similarity_f32(const void* ra, const void* rb,
                                     void* out, int A, int B, int P,
                                     int measure, void* stream) {
  if (A <= 0 || B <= 0 || P < 0 || measure < 0 || measure > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((A + kBA - 1) / kBA, (B + kBB - 1) / kBB);
  masked_similarity_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ra), static_cast<const float*>(rb),
      static_cast<float*>(out), A, B, P, measure, nullptr, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core route: zero the moments and the flag of `ws`, write the
// landmark planes, a moments kernel (the cluster kernel when `lm` is 32,
// else moments_wgmma_kernel with lm = 21), then the finalize launch, which
// runs the f32 route instead when the flag is set and counts into
// `results` (int[2]: finalized, f32 instead). `ws` holds the (6, B, A) f32
// moments, the guard flag, then on the next 16-byte boundary the landmark
// planes, ⌈B/lm⌉·⌈P/64⌉ tiles of 8 KB (16 KB at lm = 32). The cluster
// kernel needs P % 4 == 0, r_a on 16 bytes and 22 <= B <= 128.
extern "C" int masked_similarity_tc(const void* ra, const void* rb, void* out,
                                    void* ws, void* results, int A, int B,
                                    int P, int measure, int lm,
                                    void* stream) {
  const bool vec = P % 4 == 0 && reinterpret_cast<uintptr_t>(ra) % 16 == 0;
  const bool cluster = lm == kCLm;
  if (A <= 0 || B <= 0 || P < 0 || P > kIntItems || measure < 0 ||
      measure > 2 || (lm != kLm && lm != kCLm) ||
      (cluster && (!vec || B <= kLm || B > kCLm * kMaxCluster))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // half stars while every sum stays below 2^22, integers past it
  const bool half = P <= kHalfItems;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n_moments = static_cast<size_t>(6) * A * B;
  float* w = static_cast<float*>(ws);
  int* flag = reinterpret_cast<int*>(w + n_moments);
  uint4* planes = reinterpret_cast<uint4*>(
      static_cast<uint8_t*>(ws) + (n_moments * 4 + 16 + 15) / 16 * 16);
  cudaError_t err = cudaMemsetAsync(ws, 0, (n_moments + 1) * 4, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m_tiles = (A + kRows - 1) / kRows;
  const int n_tiles = (B + lm - 1) / lm;
  const int k_stages = (P + kItems - 1) / kItems;
  const float* a = static_cast<const float*>(ra);
  const float* b = static_cast<const float*>(rb);
  if (k_stages > 0) {
    const auto planes_of = cluster ? (half ? planes_kernel<kCLm, true>
                                           : planes_kernel<kCLm, false>)
                                   : (half ? planes_kernel<kLm, true>
                                           : planes_kernel<kLm, false>);
    planes_of<<<dim3(k_stages, n_tiles), kThreads, 0, st>>>(b, planes, flag,
                                                            B, P, k_stages);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long units = static_cast<long long>(m_tiles) * k_stages;
    const auto moments = cluster
        ? (half ? launch_cluster<true> : launch_cluster<false>)
        : vec ? (half ? launch_moments<true, true>
                      : launch_moments<true, false>)
              : (half ? launch_moments<false, true>
                      : launch_moments<false, false>);
    err = moments(a, planes, w, flag, A, B, P, k_stages, n_tiles,
                  cluster ? units : units * n_tiles, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((A + kBA - 1) / kBA, (B + kBB - 1) / kBB);
  masked_similarity_kernel<<<grid, kThreads, 0, st>>>(
      a, b, static_cast<float*>(out), A, B, P, measure, w, flag,
      static_cast<int*>(results));
  return static_cast<int>(cudaGetLastError());
}
