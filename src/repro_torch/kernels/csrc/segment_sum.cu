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
// for j in [indptr[n], indptr[n + 1]), added one after another from +0 —
// index order when perm is a stable argsort of the index
// (kernels/segment_sum.py::build_csr), the order of the CPU's index_add_
// and of jax.ops.segment_sum. f32: plain IEEE adds (__fadd_rn, never
// contracted). bf16: each add in f32, rounded to bf16 after every add, as
// jax.ops.segment_sum adds bf16 on the CPU (the reference's bf16 wire;
// torch's CPU index_add_ instead adds bf16 in f32 and rounds once). An
// empty segment gives 0. The plain version is
// kernels/ref.py::segment_sum_ref, and the two agree bitwise; the schedule
// below is emulated step by step by ref.py::segment_sum_sched_ref.
//
// What bounds it: bytes. Every live edge's row of x is read once and every
// output row written once, beside perm and indptr: at minibatch_lg's CSR
// by destination (54,413 live edges of 169,984, 170,496 nodes, H = 70, f32)
// 63.9 MB, 0.0191 ms at 3.35 TB/s, of which the (N, H) output is 47.7 MB;
// one add per element read. The add order inside a segment is fixed, so
// parallelism comes only from channels, from segments, and from loads kept
// in flight: no tree, split or atomic.
//
// What held the first design (a thread per (node, channel)) back, and what
// this one does about each:
// 1. Thread count. 11.9 M threads at minibatch_lg, 161,062 of its 170,496
//    rows empty: each thread paid a 64-bit divide, two indptr loads and a
//    4-byte store, so the 47.7 MB of zeros went at the rate threads launch
//    and wait on their indptr load, not at the store rate. Here a warp
//    takes a chunk of rows (build_csr's chunk_rows: rows + light edges ≈
//    chunk_size a chunk: 32, or down to 8 where a CSR is too small to
//    give 4096 chunks), loads up to 32 rows' bounds with one coalesced load,
//    and stores each row with its lanes over the channels (lane l channel
//    l + 32 m): an empty row costs one 280-byte coalesced store at H = 70.
// 2. The dependent load chain. Each edge needs perm[j] before x[perm[j]].
//    A warp loads 32 perm entries with one coalesced load (the next 32
//    while it works on these) and broadcasts them with __shfl_sync; the
//    rows of kInflight = 8 edges are loaded into registers before any of
//    them is added, across row boundaries of the chunk (a flat walk of its
//    edges), then added in j order. The bits do not change; the latency is
//    hidden. The loads of a group have no branch among them: with a guard
//    around each (slot < cnt) the compiler let the group go one round trip
//    an edge (0.0473 ms device at minibatch_lg in chunks of 64, 0.0286
//    without the guards; NVIDIA H100 80GB HBM3, 700.00 W,
//    tools/time_segment_sum.py).
// 3. Heavy segments. A segment with more than `heavy` (HEAVY = 64) members
//    is left out of the warps' walks and summed by a whole block
//    (build_csr lists them in heavy_rows, on the device, no host sync):
//    its 8 warps stage up to 64 members' rows a stage into shared memory
//    through registers (warp w members w + 8 i, its lanes over the
//    channels), the next stage's loads in flight while the threads that
//    own the channels add the current one in j order. Registers and not
//    cp.async carry the staging because cp.async copies 4, 8 or 16 bytes:
//    a bf16 row at odd H is not 4-byte aligned.
// One launch: the heavy blocks first (blockIdx.x < heavy_blocks), then a
// warp per chunk. Offsets are 64-bit (row × H): past int32 at
// ogb_products' E × H = 4.3e9. Any H ≥ 1: channels go in slices of 32·M
// (M = min(4, ⌈H/32⌉) a lane), for the warps and the heavy blocks alike.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kInflight = 8;    // edges' rows loaded before any is added
constexpr int kRun = 32;        // rows whose bounds a warp loads at once
constexpr int kStageElems = 16 * kThreads;  // a heavy stage's buffer
constexpr int kStageRows = 64;               // members a heavy stage takes
constexpr int kHeavyBlocksMax = 132;         // one an SM

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float add(float acc, float v) {
    return __fadd_rn(acc, v);
  }
  static __device__ __forceinline__ float out(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ushort_as_bfloat16(
        __ldg(reinterpret_cast<const unsigned short*>(p))));
  }
  // the sum rounded to bf16 after every add, kept exactly in a float
  static __device__ __forceinline__ float add(float acc, float v) {
    return __bfloat162float(__float2bfloat16_rn(__fadd_rn(acc, v)));
  }
  static __device__ __forceinline__ __nv_bfloat16 out(float v) {
    return __float2bfloat16_rn(v);
  }
};

// Stores one row's slice [c0, c0 + 32 M) of channels, lane l channel
// c0 + l + 32 m, and zeroes the accumulator.
template <typename T, int M>
__device__ __forceinline__ void store_row(T* __restrict__ out, long long row,
                                          int h, int c0, int lane,
                                          float (&acc)[M]) {
  T* o = out + row * h + c0 + lane;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if (c0 + lane + 32 * m < h) o[32 * m] = Elem<T>::out(acc[m]);
    acc[m] = 0.0f;
  }
}

// The flat walk of edges [a, b): rows t .. stop - 1 of the run that starts
// at row rb (lane i holds `ends`, the end of row rb + i), every edge of
// them and no other. Each row is stored once its last edge is added (an
// empty one as 0); returns with t == stop and acc zeroed.
template <typename T, int M>
__device__ __forceinline__ void walk(const T* __restrict__ x,
                                     const int* __restrict__ perm,
                                     T* __restrict__ out, int h, int c0,
                                     int lane, long long rb, int ends, int a,
                                     int b, int& t, int stop,
                                     float (&acc)[M]) {
  int p = a + lane < b ? __ldg(perm + a + lane) : 0;
  for (int jb = a; jb < b; jb += 32) {
    const int cnt = min(32, b - jb);
    const int next = jb + 32 + lane < b ? __ldg(perm + jb + 32 + lane) : 0;
    for (int k = 0; k < cnt; k += kInflight) {
      // no branch among the loads: a slot past cnt reloads edge k's row
      // and a lane past h channel h - 1; neither is added or stored
      float v[kInflight][M];
#pragma unroll
      for (int u = 0; u < kInflight; ++u) {
        const long long row = __shfl_sync(kFull, p, k + u < cnt ? k + u : k);
#pragma unroll
        for (int m = 0; m < M; ++m)
          v[u][m] = Elem<T>::load(x + row * h + min(c0 + lane + 32 * m,
                                                    h - 1));
      }
#pragma unroll
      for (int u = 0; u < kInflight; ++u) {
        if (k + u >= cnt) break;
        const int j = jb + k + u;
        while (j >= __shfl_sync(kFull, ends, t)) {
          store_row<T, M>(out, rb + t, h, c0, lane, acc);
          ++t;
        }
#pragma unroll
        for (int m = 0; m < M; ++m) acc[m] = Elem<T>::add(acc[m], v[u][m]);
      }
    }
    p = next;
  }
  while (t < stop) {
    store_row<T, M>(out, rb + t, h, c0, lane, acc);
    ++t;
  }
}

// A warp's chunk: rows [rs, re), in runs of kRun rows, each channel slice
// in turn; rows of more than `heavy` members are skipped (a heavy block
// owns them).
template <typename T, int M>
__device__ __forceinline__ void light_chunk(const T* __restrict__ x,
                                            const int* __restrict__ perm,
                                            const int* __restrict__ indptr,
                                            T* __restrict__ out, int rs,
                                            int re, int h, int heavy,
                                            int lane) {
  for (int c0 = 0; c0 < h; c0 += 32 * M) {
    for (int rb = rs; rb < re; rb += kRun) {
      const int nr = min(kRun, re - rb);
      const int ends = lane < nr ? __ldg(indptr + rb + lane + 1) : 0;
      const int first = __ldg(indptr + rb);
      int starts = __shfl_up_sync(kFull, ends, 1);
      if (lane == 0) starts = first;
      const unsigned heavy_rows =
          __ballot_sync(kFull, lane < nr && ends - starts > heavy);
      float acc[M];
#pragma unroll
      for (int m = 0; m < M; ++m) acc[m] = 0.0f;
      int t = 0, j = first;
      while (t < nr) {
        const unsigned rest = heavy_rows >> t;
        const int stop = rest ? t + __ffs(rest) - 1 : nr;
        const int b = stop < nr ? __shfl_sync(kFull, starts, stop)
                                : __shfl_sync(kFull, ends, nr - 1);
        walk<T, M>(x, perm, out, h, c0, lane, rb, ends, j, b, t, stop, acc);
        if (stop < nr) {  // skip the heavy row
          j = __shfl_sync(kFull, ends, stop);
          t = stop + 1;
        }
      }
    }
  }
}

// A heavy stage's perm entries: lane i < kStageRows / kWarps of warp w
// holds member w + 8 i of the stage (-1 past the stage or the row).
__device__ __forceinline__ int stage_perm(const int* __restrict__ perm,
                                          int first, int hi, int rows,
                                          int warp, int lane) {
  const int r = warp + kWarps * lane;
  return (lane < kStageRows / kWarps && r < rows && first + r < hi)
             ? __ldg(perm + first + r)
             : -1;
}

// Warp w loads members w, w + 8, ... of the stage that stage_perm named,
// lane l channels l + 32 m of the slice; no branch among the loads (a
// slot without a member reads row 0, a lane past the slice channel
// cw - 1; neither is staged).
template <typename T, int M>
__device__ __forceinline__ void stage_rows(float (&v)[kStageRows / kWarps][M],
                                           int mine,
                                           const T* __restrict__ x, int h,
                                           int c0, int cw, int lane) {
#pragma unroll
  for (int i = 0; i < kStageRows / kWarps; ++i) {
    const int src = __shfl_sync(kFull, mine, i);
    const long long row = src >= 0 ? src : 0;
#pragma unroll
    for (int m = 0; m < M; ++m)
      v[i][m] = Elem<T>::load(x + row * h + c0 + min(lane + 32 * m, cw - 1));
  }
}

// A heavy row, by the whole block: each channel slice of up to 32·M
// channels in stages of `rows` members, staged through registers into one
// of two shared buffers (warp w members w + 8 i, its lanes over the
// channels); the next stage's loads (and the one after's perm entries)
// are in flight while the threads that own the slice's channels add the
// current stage in j order.
template <typename T, int M>
__device__ __forceinline__ void heavy_row(const T* __restrict__ x,
                                          const int* __restrict__ perm,
                                          const int* __restrict__ indptr,
                                          T* __restrict__ out, int row, int h,
                                          float* buf) {
  constexpr int kPer = kStageRows / kWarps;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lo = __ldg(indptr + row), hi = __ldg(indptr + row + 1);
  for (int c0 = 0; c0 < h; c0 += 32 * M) {
    const int cw = min(32 * M, h - c0);
    const int rows = min(kStageRows, kStageElems / cw);
    const int stages = (hi - lo + rows - 1) / rows;
    float v[kPer][M];
    int mine = stage_perm(perm, lo, hi, rows, warp, lane);
    stage_rows<T, M>(v, mine, x, h, c0, cw, lane);
    if (stages > 1) mine = stage_perm(perm, lo + rows, hi, rows, warp, lane);
    float acc = 0.0f;
    for (int s = 0; s < stages; ++s) {
      float* cur = buf + (s & 1) * kStageElems;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = warp + kWarps * i;
#pragma unroll
        for (int m = 0; m < M; ++m)
          if (r < rows && lane + 32 * m < cw)
            cur[r * cw + lane + 32 * m] = v[i][m];
      }
      __syncthreads();
      if (s + 1 < stages) {
        stage_rows<T, M>(v, mine, x, h, c0, cw, lane);
        if (s + 2 < stages)
          mine = stage_perm(perm, lo + (s + 2) * rows, hi, rows, warp, lane);
      }
      const int here = min(rows, hi - lo - s * rows);
      if (tid < cw) {
#pragma unroll 8
        for (int r = 0; r < here; ++r)
          acc = Elem<T>::add(acc, cur[r * cw + tid]);
      }
    }
    if (tid < cw)
      out[static_cast<long long>(row) * h + c0 + tid] = Elem<T>::out(acc);
    __syncthreads();  // the next slice or row restages buf
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ x, const int* __restrict__ perm,
                   const int* __restrict__ indptr,
                   const int* __restrict__ chunk_rows,
                   const int* __restrict__ heavy_rows, T* __restrict__ out,
                   int n, int h, int n_chunks, int n_heavy, int heavy_blocks,
                   int heavy) {
  __shared__ float buf[2 * kStageElems];
  if (static_cast<int>(blockIdx.x) < heavy_blocks) {
    for (int i = blockIdx.x; i < n_heavy; i += heavy_blocks) {
      const int row = __ldg(heavy_rows + i);
      if (row >= n) break;  // the list's unused tail
      heavy_row<T, M>(x, perm, indptr, out, row, h, buf);
    }
    return;
  }
  const int c = (blockIdx.x - heavy_blocks) * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks) return;
  light_chunk<T, M>(x, perm, indptr, out, __ldg(chunk_rows + c),
                    __ldg(chunk_rows + c + 1), h, heavy, threadIdx.x & 31);
}

template <typename T, int M>
int launch_m(const void* x, const void* perm, const void* indptr,
             const void* chunk_rows, const void* heavy_rows, void* out,
             long long n, int h, int n_chunks, int n_heavy, int heavy,
             cudaStream_t stream) {
  const int heavy_blocks = n_heavy < kHeavyBlocksMax ? n_heavy
                                                     : kHeavyBlocksMax;
  const unsigned grid = (n_chunks + kWarps - 1) / kWarps + heavy_blocks;
  if (grid == 0) return 0;
  segment_sum_kernel<T, M><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(perm),
      static_cast<const int*>(indptr), static_cast<const int*>(chunk_rows),
      static_cast<const int*>(heavy_rows), static_cast<T*>(out),
      static_cast<int>(n), h, n_chunks, n_heavy, heavy_blocks, heavy);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* perm, const void* indptr,
           const void* chunk_rows, const void* heavy_rows, void* out,
           long long n, int h, int n_chunks, int n_heavy, int heavy,
           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (h > 96 ? 4 : (h + 31) / 32) {
    case 1:
      return launch_m<T, 1>(x, perm, indptr, chunk_rows, heavy_rows, out, n,
                            h, n_chunks, n_heavy, heavy, s);
    case 2:
      return launch_m<T, 2>(x, perm, indptr, chunk_rows, heavy_rows, out, n,
                            h, n_chunks, n_heavy, heavy, s);
    case 3:
      return launch_m<T, 3>(x, perm, indptr, chunk_rows, heavy_rows, out, n,
                            h, n_chunks, n_heavy, heavy, s);
    default:
      return launch_m<T, 4>(x, perm, indptr, chunk_rows, heavy_rows, out, n,
                            h, n_chunks, n_heavy, heavy, s);
  }
}

}  // namespace

// (x (E, H), perm (E_live,) int32, indptr (N + 1,) int32, chunk_rows
// (n_chunks + 1,) int32, heavy_rows (n_heavy,) int32, out (N, H), N, H,
// n_chunks, n_heavy, heavy, stream) -> cudaGetLastError() after the launch.
extern "C" int segment_sum_f32(const void* x, const void* perm,
                               const void* indptr, const void* chunk_rows,
                               const void* heavy_rows, void* out, long long n,
                               int h, int n_chunks, int n_heavy, int heavy,
                               void* stream) {
  return launch<float>(x, perm, indptr, chunk_rows, heavy_rows, out, n, h,
                       n_chunks, n_heavy, heavy, stream);
}

extern "C" int segment_sum_bf16(const void* x, const void* perm,
                                const void* indptr, const void* chunk_rows,
                                const void* heavy_rows, void* out,
                                long long n, int h, int n_chunks, int n_heavy,
                                int heavy, void* stream) {
  return launch<__nv_bfloat16>(x, perm, indptr, chunk_rows, heavy_rows, out,
                               n, h, n_chunks, n_heavy, heavy, stream);
}
