// Fixed-order CSR segment sum for Hopper: the GNN's message passing.
//
// Replaces no TPU kernel. The reference sums messages into nodes with
// jax.ops.segment_sum (src/repro/models/gnn.py:129,134,144-145), which XLA
// lowers to a scatter-add. On the card the library's counterparts
// (index_add_, scatter_add_, and the backward of every index_select
// gather) add with atomics in an order that changes from run to run, so a
// training step built on them is not reproducible bit for bit. This kernel
// sums each segment in one fixed order instead.
//
// What it computes: out[n, c] = x[perm[lo], c] + x[perm[lo + 1], c] + ...
// for j in [indptr[n], indptr[n + 1]), added one after another from 0 —
// index order when perm is a stable argsort of the index
// (kernels/segment_sum.py::build_csr), the order of the CPU's index_add_
// and of jax.ops.segment_sum. f32: plain IEEE adds (__fadd_rn, never
// contracted). bf16: each add in f32, rounded to bf16 after every add, as
// jax.ops.segment_sum adds bf16 on the CPU (the reference's bf16 wire;
// torch's CPU index_add_ instead adds bf16 in f32 and rounds once). An
// empty segment gives 0. The plain version is
// kernels/ref.py::segment_sum_ref, and the two agree bitwise.
//
// What bounds it: bytes. Every live edge's row of x is read once and every
// output row written once, beside perm and indptr: at minibatch_lg's CSR
// by destination (54,413 live edges of 169,984, 170,496 nodes, H = 70, f32)
// ~63 MB, ~0.019 ms at 3.35 TB/s; one add per element read.
//
// Design: simple first. One thread per (node, channel) pair over the
// flattened (N, H) output, so H = 70 (not a multiple of 32) needs no
// padding and a warp's writes are contiguous; the threads of one node read
// one row of x together (contiguous channels). Offsets are 64-bit
// (row × H): past int32 at ogb_products' E × H = 4.3e9. Segments of very
// uneven length (power-law degrees) leave a long serial chain in the
// thread of a heavy node; spreading them is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segment_sum_f32_kernel(const float* __restrict__ x,
                       const int* __restrict__ perm,
                       const int* __restrict__ indptr,
                       float* __restrict__ out, long long n, int h) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n * h) return;
  const long long node = t / h;
  const int c = static_cast<int>(t - node * h);
  const int lo = __ldg(indptr + node);
  const int hi = __ldg(indptr + node + 1);
  float acc = 0.0f;
#pragma unroll 4
  for (int j = lo; j < hi; ++j) {
    const long long row = __ldg(perm + j);
    acc = __fadd_rn(acc, __ldg(x + row * h + c));
  }
  out[t] = acc;
}

__global__ void __launch_bounds__(kThreads)
segment_sum_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const int* __restrict__ perm,
                        const int* __restrict__ indptr,
                        __nv_bfloat16* __restrict__ out, long long n, int h) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n * h) return;
  const long long node = t / h;
  const int c = static_cast<int>(t - node * h);
  const int lo = __ldg(indptr + node);
  const int hi = __ldg(indptr + node + 1);
  __nv_bfloat16 acc = __float2bfloat16_rn(0.0f);
#pragma unroll 4
  for (int j = lo; j < hi; ++j) {
    const long long row = __ldg(perm + j);
    acc = __float2bfloat16_rn(__fadd_rn(__bfloat162float(acc),
                                        __bfloat162float(x[row * h + c])));
  }
  out[t] = acc;
}

unsigned blocks_for(long long n, int h) {
  return static_cast<unsigned>((n * h + kThreads - 1) / kThreads);
}

}  // namespace

// (x (E, H), perm (E_live,) int32, indptr (N + 1,) int32, out (N, H), N, H,
// stream) -> cudaGetLastError() after the launch.
extern "C" int segment_sum_f32(const void* x, const void* perm,
                               const void* indptr, void* out, long long n,
                               int h, void* stream) {
  segment_sum_f32_kernel<<<blocks_for(n, h), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(perm),
      static_cast<const int*>(indptr), static_cast<float*>(out), n, h);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int segment_sum_bf16(const void* x, const void* perm,
                                const void* indptr, void* out, long long n,
                                int h, void* stream) {
  segment_sum_bf16_kernel<<<blocks_for(n, h), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(perm),
      static_cast<const int*>(indptr), static_cast<__nv_bfloat16*>(out), n,
      h);
  return static_cast<int>(cudaGetLastError());
}
