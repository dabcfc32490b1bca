// Masked co-rated similarity (d1) for Hopper, f32 on CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/masked_similarity.py,
// masked_similarity_kernel (body _kernel): the six co-rated moments
//   z = Σ a·b, x = Σ a²·[b≠0], y = Σ [a≠0]·b², c = Σ [a≠0]·[b≠0],
//   sx = Σ a·[b≠0], sy = Σ [a≠0]·b
// over the item axis P, then the cosine, pearson or euclidean epilogue,
// with 0 where c <= 1. A rating of 0 means "missing", so the masks are
// built on the fly from the values themselves.
//
// What bounds it on an H100: at the fit shape (A = 6040 users, B = 20
// landmarks, P = 3952 items) it moves ~96 MB (R read once) but does
// 12·A·B·P = 5.7 GFLOP of f32 FMA work, so it is bound by operations
// (~86 µs at the 67 TFLOP/s f32 peak) well before bytes (~29 µs).
// The design keeps every moment in registers and reads each R tile from
// device memory once per column tile of B: one block owns a 32×32 output
// tile (256 threads, 2×2 outputs each, 24 accumulators a thread), streams
// P in 64-wide shared-memory tiles of both operands, and applies the
// epilogue in the same order of operations as the plain version
// (core/similarity.py::_finalize) with round-to-nearest intrinsics the
// compiler may not contract. On integer ratings every moment is an exact
// integer in f32 while P·25 < 2^24, so cosine agrees with the plain
// version bitwise. bf16 tensor cores are exact on such data too and would
// move it to the memory bound; that is later work.
#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-8f;
constexpr int kBA = 32;   // rows of r_a per block
constexpr int kBB = 32;   // rows of r_b per block
constexpr int kBP = 64;   // items per shared-memory tile
constexpr int kThreads = 256;  // 16 x 16 threads, 2 x 2 outputs each

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

__global__ void __launch_bounds__(kThreads)
masked_similarity_kernel(const float* __restrict__ ra,
                         const float* __restrict__ rb,
                         float* __restrict__ out, int A, int B, int P,
                         int measure) {
  // transposed tiles: [item][row]; the +1 pad keeps the transposing
  // stores free of bank conflicts
  __shared__ float as[kBP][kBA + 1];
  __shared__ float bs[kBP][kBB + 1];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int a0 = blockIdx.x * kBA;
  const int b0 = blockIdx.y * kBB;

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
      static_cast<float*>(out), A, B, P, measure);
  return static_cast<int>(cudaGetLastError());
}
