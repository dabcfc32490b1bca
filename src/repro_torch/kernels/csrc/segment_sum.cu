// Fixed-order CSR segment sum for Hopper: the GNN's message passing and
// the backward of the recsys embedding lookups.
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
// in flight: no tree, split or atomic. A segment's sum is a chain of
// dependent adds, one a member: where one segment holds most edges (a
// Zipf head) that chain, not the bytes, is the floor.
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
//    is left out of the warps' walks (build_csr lists them in heavy_rows,
//    longest first, on the device, no host sync). The previous design
//    summed each in a block, at most 132 blocks with one stage of 64
//    members in flight: at BERT4Rec's CSR by item id one block added the
//    1,850,927-member Zipf head in 28,921 stages, a global round trip each
//    (23.6 ms). Now a heavy segment is cut into units, each a slice of
//    channels summed by one warp: 16 bytes (4 f32 or 8 bf16 channels), or 4
//    bytes (one f32 channel) for a segment of more than HUGE members, whose
//    chain is the launch's floor — its H units then run on H SMs. A unit's
//    lanes gather the slice of each member's row with cp.async (16, 8 or 4
//    bytes where the rows allow, through registers for a bf16 row at odd H)
//    into a ring of kRing stages of 1 KB in the warp's own shared memory,
//    the perm entries kRing - 1 stages ahead by cp.async too, while every
//    lane adds the oldest stage in j order (a one-channel slice four
//    members a 16-byte load). Measured at that CSR (H = 64; NVIDIA H100
//    80GB HBM3, 700.00 W, tools/segment_sum_variants.py): 16-byte slices
//    for the head 10.1 ms, one-channel slices 7.0; a ring of 3 or 6 stages
//    the same as 4; 2 KB stages 6.5 but twice as slow at FM's CSR (a third
//    of the warps fit an SM); with no row copied at all 4.7, the chain and
//    each stage's bookkeeping. Units are dealt to the heavy blocks' warps
//    round robin (unit u to block u mod B), so the longest chains start
//    first and on different SMs.
// 4. Empty rows at narrow H. FM's CSR by field id has 41.7 M rows, 40.8 M
//    of them empty: a warp a chunk of 32 rows + edges (1.38 M warps, each a
//    few dependent round trips: chunk bounds, indptr, perm, rows) and a
//    store a row with one lane a channel took 1.46 ms at H = 1 (the heavy
//    blocks alone 0.16). At H ≤ 32 a warp now copies the bounds of up to
//    kWindow rows of its chunk to shared memory at once, walks each run's
//    nonempty rows into a tile there and stores the run's (rows × H) span
//    with all 32 lanes (a stretch of runs without edges: its zeros), the
//    next nonempty run's first perm entries in flight while it walks this
//    one; a CSR of many rows takes chunks of up to chunk_size's CHUNK_MAX
//    rows + edges. Zeros are +0 either way.
// One launch: the heavy blocks first (blockIdx.x < heavy_blocks), then a
// warp per chunk. Offsets are 64-bit (row × H): past int32 at
// ogb_products' E × H = 4.3e9. Any H ≥ 1: the light walk's channels go in
// slices of 32·M (M = min(4, ⌈H/32⌉) a lane), the heavy units' in 16-byte
// slices.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_smem.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kInflight = 8;    // edges' rows loaded before any is added
constexpr int kRun = 32;        // rows whose bounds a warp loads at once
// a heavy unit's rings, in its warp's shared memory: kRing stages of
// kStageBytes of slices (kStageBytes / slot members a stage: a slot is
// kSlot bytes of channels, or kSlotHuge for a segment of more than HUGE
// members, the n_huge first of heavy_rows) and kRing stages of their
// perm entries
constexpr int kSlot = 16;
constexpr int kSlotHuge = 4;
constexpr int kStageBytes = 1024;
constexpr int kRing = 4;
constexpr int kRingBytes = kRing * kStageBytes;
// a narrow chunk's tile (kRun rows of at most kNarrow channels) and the
// bounds of a window of up to kWindow of its rows
constexpr int kNarrow = 32;     // H ≤ kNarrow: runs stored through a tile
constexpr int kWindow = 1024;
constexpr int kTileBytes = kRun * kNarrow * 4;
constexpr int kNarrowBytes = kTileBytes + ((kWindow + 1) * 4 + 15) / 16 * 16;
constexpr int kHeavyBytes = kRingBytes + kRing * (kStageBytes / kSlotHuge) * 4;
constexpr int kWarpBytes = kHeavyBytes > kNarrowBytes ? kHeavyBytes
                                                      : kNarrowBytes;
constexpr int kSmemBytes = kWarps * kWarpBytes;  // 65,664: dynamic
constexpr int kHeavyBlocksMax = 132;  // one an SM
static_assert(kStageBytes / kSlot % 32 == 0, "whole rounds of 32 lanes");

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float shared(const float* p) {
    return *p;
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
  static __device__ __forceinline__ float shared(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  // the sum rounded to bf16 after every add, kept exactly in a float
  static __device__ __forceinline__ float add(float acc, float v) {
    return __bfloat162float(__float2bfloat16_rn(__fadd_rn(acc, v)));
  }
  static __device__ __forceinline__ __nv_bfloat16 out(float v) {
    return __float2bfloat16_rn(v);
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// A warp's chunk at H > kNarrow: rows [rs, re), in runs of kRun rows, each
// channel slice in turn; rows of more than `heavy` members are skipped (a
// heavy unit owns them).
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

// The narrow walk of edges [a, b) (H ≤ kNarrow, lane l channel l): light
// rows t .. stop - 1 of the run, every edge of them and no other, added
// in j order; each nonempty row's sum goes to its row of the tile, and an
// empty row is passed over (the tile holds +0 there). `pf` holds perm
// entries a .. a + 31 when `have` (loaded with the run's bounds).
template <typename T>
__device__ __forceinline__ void walk_narrow(const T* __restrict__ x,
                                            const int* __restrict__ perm,
                                            T* __restrict__ tile, int h,
                                            int lane, int ends, int a, int b,
                                            int stop, int pf, bool have) {
  if (a >= b) return;
  // the row of edge a: the first of the run that ends past it (the rows
  // before the walk's end at or before a, the heavy row too)
  int r = __ffs(__ballot_sync(kFull, lane < stop && ends > a)) - 1;
  int end = __shfl_sync(kFull, ends, r);
  float acc = 0.0f;
  int p = have ? pf : (a + lane < b ? __ldg(perm + a + lane) : 0);
  const int ch = min(lane, h - 1);
  for (int jb = a; jb < b; jb += 32) {
    const int cnt = min(32, b - jb);
    const int next = jb + 32 + lane < b ? __ldg(perm + jb + 32 + lane) : 0;
    for (int k = 0; k < cnt; k += kInflight) {
      float v[kInflight];
#pragma unroll
      for (int u = 0; u < kInflight; ++u) {
        const long long row = __shfl_sync(kFull, p, k + u < cnt ? k + u : k);
        v[u] = Elem<T>::load(x + row * h + ch);
      }
#pragma unroll
      for (int u = 0; u < kInflight; ++u) {
        if (k + u >= cnt) break;
        const int j = jb + k + u;
        if (j >= end) {  // row r is whole: on to the row of edge j
          if (lane < h) tile[r * h + lane] = Elem<T>::out(acc);
          acc = 0.0f;
          r = __ffs(__ballot_sync(kFull, lane < stop && ends > j)) - 1;
          end = __shfl_sync(kFull, ends, r);
        }
        acc = Elem<T>::add(acc, v[u]);
      }
    }
    p = next;
  }
  if (lane < h) tile[r * h + lane] = Elem<T>::out(acc);
}

// A warp's chunk at H ≤ kNarrow: rows [rs, re), in windows of up to
// kWindow rows whose bounds it copies to shared memory at once (one round
// trip), then in runs of kRun rows. A stretch of runs without edges
// stores its (rows × H) span of zeros with all lanes; any other run
// zeroes the tile, walks its light rows into it and stores the span of
// each stretch of light rows between heavy ones (a heavy unit owns
// those). The first 32 perm entries of the next run with edges, however
// many empty runs lie between, are loaded while this one is walked.
template <typename T>
__device__ __forceinline__ void light_chunk_narrow(
    const T* __restrict__ x, const int* __restrict__ perm,
    const int* __restrict__ indptr, T* __restrict__ out, int rs, int re,
    int h, int heavy, int n_live, int lane, char* __restrict__ region) {
  T* tile = reinterpret_cast<T*>(region);
  int* sb = reinterpret_cast<int*>(region + kTileBytes);
  const T zero = Elem<T>::out(0.0f);
  for (int ws = rs; ws < re; ws += kWindow) {
    const int we = min(re, ws + kWindow);
    for (int i = lane; i <= we - ws; i += 32)
      cp_async4(sb + i, indptr + ws + i);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    const int nruns = (we - ws + kRun - 1) / kRun;  // at most 32
    auto next_run = [&](int k) {  // the first run from k with edges
      const int r = k + lane;
      const unsigned has = __ballot_sync(
          kFull, r < nruns && sb[min((r + 1) * kRun, we - ws)] >
                                  sb[r * kRun]);
      return has ? k + __ffs(has) - 1 : nruns;
    };
    auto perm_block = [&](int k) {  // its first 32 perm entries
      const int a = k < nruns ? sb[k * kRun] : n_live;
      return a + lane < n_live ? __ldg(perm + a + lane) : 0;
    };
    auto zeros = [&](int r0, int r1) {  // rows [r0, r1), every channel
      for (long long e = static_cast<long long>(r0) * h + lane;
           e < static_cast<long long>(r1) * h; e += 32)
        out[e] = zero;
    };
    int kn = next_run(0);
    int pf = perm_block(kn);
    for (int k = 0; k < nruns; ++k) {
      const int rb = ws + k * kRun;
      if (k < kn) {  // no edge up to run kn: one span of zeros
        zeros(rb, min(we, ws + kn * kRun));
        k = kn - 1;
        continue;
      }
      // the next run with edges, its perm entries in flight during this
      const int kn2 = next_run(k + 1);
      const int pf2 = perm_block(kn2);
      const int k0 = rb - ws;
      const int nr = min(kRun, we - rb);
      const int ends = lane < nr ? sb[k0 + lane + 1] : 0;
      const int first = sb[k0], last = sb[k0 + nr];
      const long long base = static_cast<long long>(rb) * h;
      int starts = __shfl_up_sync(kFull, ends, 1);
      if (lane == 0) starts = first;
      const unsigned heavy_rows =
          __ballot_sync(kFull, lane < nr && ends - starts > heavy);
      for (int e = lane; e < nr * h; e += 32) tile[e] = zero;
      __syncwarp();
      int t = 0, j = first;
      while (t < nr) {
        const unsigned rest = heavy_rows >> t;
        const int stop = rest ? t + __ffs(rest) - 1 : nr;
        const int b = stop < nr ? __shfl_sync(kFull, starts, stop) : last;
        walk_narrow<T>(x, perm, tile, h, lane, ends, j, b, stop, pf,
                       j == first);
        if (stop == nr) break;
        j = __shfl_sync(kFull, ends, stop);  // skip the heavy row
        t = stop + 1;
      }
      __syncwarp();
      t = 0;
      while (t < nr) {
        const unsigned rest = heavy_rows >> t;
        const int stop = rest ? t + __ffs(rest) - 1 : nr;
        for (int e = t * h + lane; e < stop * h; e += 32)
          out[base + e] = tile[e];
        t = stop + 1;
      }
      __syncwarp();  // the next run rezeroes the tile
      kn = kn2;
      pf = pf2;
    }
    __syncwarp();  // the next window's bounds overwrite these
  }
}

// Copies `bytes` (a multiple of g, at most 16) from src to dst: by
// cp.async in pieces of g = 16, 8 or 4 bytes, or through registers in
// 2-byte pieces (a bf16 row at odd H is not 4-byte aligned).
__device__ __forceinline__ void copy_slice(char* dst, const char* src,
                                           int bytes, int g) {
  if (g == 16) {
    cp_async16(dst, src);
  } else if (g == 8) {
    for (int o = 0; o < bytes; o += 8) cp_async8(dst + o, src + o);
  } else if (g == 4) {
    for (int o = 0; o < bytes; o += 4) cp_async4(dst + o, src + o);
  } else {
    for (int o = 0; o < bytes; o += 2)
      *reinterpret_cast<unsigned short*>(dst + o) =
          __ldg(reinterpret_cast<const unsigned short*>(src + o));
  }
}

// Adds the `here` members of a stage to acc in order, channel `ch` of
// the slot (every lane runs the chain of its channel, lanes past the
// slice repeating its last; only the slice's own lanes store): a whole
// stage with the next members' loads issued before the current ones are
// added; one f32 channel a slot (a huge segment's) four members a load.
template <typename T, int SLOT>
__device__ __forceinline__ float add_stage(const char* st, int here, int ch,
                                           float acc) {
  constexpr int kS = kStageBytes / SLOT;
  constexpr int kStep = SLOT / sizeof(T);  // a slot, in elements
  const T* s = reinterpret_cast<const T*>(st) + ch;
  if (here == kS) {
    if constexpr (SLOT == 4 && sizeof(T) == 4) {
      const float4* s4 = reinterpret_cast<const float4*>(st);
      float4 a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = s4[u];
#pragma unroll
      for (int g = 0; g < kS / 16; ++g) {
        if (g + 1 < kS / 16) {
#pragma unroll
          for (int u = 0; u < 4; ++u) b[u] = s4[4 * (g + 1) + u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc = Elem<T>::add(acc, a[u].x);
          acc = Elem<T>::add(acc, a[u].y);
          acc = Elem<T>::add(acc, a[u].z);
          acc = Elem<T>::add(acc, a[u].w);
        }
        if (g + 1 < kS / 16) {
#pragma unroll
          for (int u = 0; u < 4; ++u) a[u] = b[u];
        }
      }
    } else {
      float a[8], b[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) a[u] = Elem<T>::shared(s + u * kStep);
#pragma unroll
      for (int g = 0; g < kS / 8; ++g) {
        if (g + 1 < kS / 8) {
#pragma unroll
          for (int u = 0; u < 8; ++u)
            b[u] = Elem<T>::shared(s + (8 * (g + 1) + u) * kStep);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) acc = Elem<T>::add(acc, a[u]);
        if (g + 1 < kS / 8) {
#pragma unroll
          for (int u = 0; u < 8; ++u) a[u] = b[u];
        }
      }
    }
  } else {
    for (int r = 0; r < here; ++r)
      acc = Elem<T>::add(acc, Elem<T>::shared(s + r * kStep));
  }
  return acc;
}

// One heavy unit, by one warp: channels [c0, c0 + cw) of segment `row`
// (cw ≤ SLOT / size), its members in stages of kS = kStageBytes / SLOT.
// Iteration i waits for all but the newest kRing - 2 groups of copies,
// copies stage i's perm entries (each lane those of its own members
// lane + 32 q) to perm slot i mod kRing and stage i - kRing + 1's slices
// through them to ring slot (i - kRing + 1) mod kRing, commits them as
// one group, and adds stage i - 2 kRing + 2 from its slot: each stage is
// read after the wait that covers its copy and before its slot is
// copied over. Between the first and last few iterations every part
// applies and every stage is whole: no branch.
template <typename T, int SLOT>
__device__ __forceinline__ void heavy_unit(const T* __restrict__ x,
                                           const int* __restrict__ perm,
                                           const int* __restrict__ indptr,
                                           T* __restrict__ out, int row,
                                           int c0, int h, int g,
                                           char* __restrict__ ring,
                                           int lane) {
  constexpr int kS = kStageBytes / SLOT;
  const int lo = __ldg(indptr + row);
  const int len = __ldg(indptr + row + 1) - lo;
  const int cw = min(SLOT / static_cast<int>(sizeof(T)), h - c0);
  const int ch = min(lane, cw - 1);
  const int bytes = cw * static_cast<int>(sizeof(T));
  const long long pitch = static_cast<long long>(h) * sizeof(T);
  const int stages = (len + kS - 1) / kS;
  const char* xs = reinterpret_cast<const char*>(x + c0);
  const int* pl = perm + lo;
  int* pring = reinterpret_cast<int*>(ring + kRingBytes);
  float acc = 0.0f;
  auto perms = [&](int i) {  // stage i's perm entries
    int* pd = pring + (i % kRing) * kS;
#pragma unroll
    for (int q = 0; q < kS / 32; ++q) {
      const int r = lane + 32 * q;
      if (i * kS + r < len) cp_async4(pd + r, pl + i * kS + r);
    }
  };
  auto rows = [&](int sx) {  // stage sx's slices, through its perm entries
    const int* ps = pring + (sx % kRing) * kS;
    char* xd = ring + (sx % kRing) * kStageBytes;
#pragma unroll
    for (int q = 0; q < kS / 32; ++q) {
      const int r = lane + 32 * q;
      if (sx * kS + r < len) {
        if constexpr (SLOT == 4 && sizeof(T) == 4)
          cp_async4(xd + r * SLOT, xs + ps[r] * pitch);
        else
          copy_slice(xd + r * SLOT, xs + ps[r] * pitch, bytes, g);
      }
    }
  };
  auto stage = [&](int s) { return ring + (s % kRing) * kStageBytes; };
  const int fill = 2 * kRing - 2;  // iterations before the first add
  auto step = [&](int i) {  // any iteration, each part where it applies
    cp_async_wait<kRing - 2>();
    __syncwarp();
    if (i < stages) perms(i);
    if (i >= kRing - 1 && i - kRing + 1 < stages) rows(i - kRing + 1);
    cp_async_commit();
    const int s = i - fill;
    if (s >= 0)
      acc = add_stage<T, SLOT>(stage(s), min(kS, len - s * kS), ch, acc);
  };
  int i = 0;
  for (; i < min(fill, stages); ++i) step(i);
  for (; i < stages; ++i) {  // the steady state: every part, whole stages
    cp_async_wait<kRing - 2>();
    __syncwarp();
    perms(i);
    rows(i - kRing + 1);
    cp_async_commit();
    acc = add_stage<T, SLOT>(stage(i - fill), kS, ch, acc);
  }
  for (; i < stages + fill; ++i) step(i);
  if (lane < cw)
    out[static_cast<long long>(row) * h + c0 + lane] = Elem<T>::out(acc);
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ x, const int* __restrict__ perm,
                   const int* __restrict__ indptr,
                   const int* __restrict__ chunk_rows,
                   const int* __restrict__ heavy_rows,
                   const int* __restrict__ n_huge_p, T* __restrict__ out,
                   int n, int n_live, int h, int n_chunks, int n_heavy,
                   int heavy_blocks, int heavy, int g) {
  extern __shared__ __align__(16) char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  char* mine = smem + warp * kWarpBytes;
  if (static_cast<int>(blockIdx.x) < heavy_blocks) {
    // units: slice k of the n_huge huge segments first (kSlotHuge bytes
    // of channels each), then the other heavy segments' (kSlot bytes)
    const int size = static_cast<int>(sizeof(T));
    const int per_huge = (h * size + kSlotHuge - 1) / kSlotHuge;
    const int per = (h * size + kSlot - 1) / kSlot;
    const int n_huge = __ldg(n_huge_p);
    const long long huge_units = static_cast<long long>(n_huge) * per_huge;
    const long long units =
        huge_units + static_cast<long long>(n_heavy - n_huge) * per;
    const long long stride = static_cast<long long>(heavy_blocks) * kWarps;
    for (long long u = blockIdx.x + static_cast<long long>(heavy_blocks) *
                                        warp;
         u < units; u += stride) {
      if (u < huge_units) {
        heavy_unit<T, kSlotHuge>(
            x, perm, indptr, out, __ldg(heavy_rows + u / per_huge),
            static_cast<int>(u % per_huge) * (kSlotHuge / size), h,
            g < kSlotHuge ? g : kSlotHuge, mine, lane);
        continue;
      }
      const long long v = u - huge_units;
      const int row = __ldg(heavy_rows + n_huge + v / per);
      if (row >= n) break;  // the list's unused tail, and every later unit
      heavy_unit<T, kSlot>(x, perm, indptr, out, row,
                           static_cast<int>(v % per) * (kSlot / size), h, g,
                           mine, lane);
    }
    return;
  }
  const int c = (blockIdx.x - heavy_blocks) * kWarps + warp;
  if (c >= n_chunks) return;
  const int rs = __ldg(chunk_rows + c), re = __ldg(chunk_rows + c + 1);
  if (M == 1 && h <= kNarrow)
    light_chunk_narrow<T>(x, perm, indptr, out, rs, re, h, heavy, n_live,
                          lane, mine);
  else
    light_chunk<T, M>(x, perm, indptr, out, rs, re, h, heavy, lane);
}

template <typename T, int M>
int launch_m(const void* x, const void* perm, const void* indptr,
             const void* chunk_rows, const void* heavy_rows,
             const void* n_huge, void* out, long long n, int n_live, int h,
             int n_chunks, int n_heavy, int heavy, cudaStream_t stream) {
  static size_t sized[repro::kMaxDevices] = {};  // the >48 KB opt-in
  const cudaError_t err =
      repro::allow_smem(segment_sum_kernel<T, M>, kSmemBytes, sized);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the heavy units' blocks: one a unit's warps' worth, at most one an
  // SM, and never more than the list has slots
  const long long per_huge =
      (static_cast<long long>(h) * sizeof(T) + kSlotHuge - 1) / kSlotHuge;
  long long heavy_blocks = (n_heavy * per_huge + kWarps - 1) / kWarps;
  if (heavy_blocks > n_heavy) heavy_blocks = n_heavy;
  if (heavy_blocks > kHeavyBlocksMax) heavy_blocks = kHeavyBlocksMax;
  // the widest cp.async piece that every row's slice start allows
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  const long long pitch = static_cast<long long>(h) * sizeof(T);
  int g = kSlot;
  while (g > 2 && (pitch % g != 0 || base % g != 0)) g >>= 1;
  const unsigned grid =
      (n_chunks + kWarps - 1) / kWarps + static_cast<unsigned>(heavy_blocks);
  if (grid == 0) return 0;
  segment_sum_kernel<T, M><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(perm),
      static_cast<const int*>(indptr), static_cast<const int*>(chunk_rows),
      static_cast<const int*>(heavy_rows), static_cast<const int*>(n_huge),
      static_cast<T*>(out), static_cast<int>(n), n_live, h, n_chunks,
      n_heavy, static_cast<int>(heavy_blocks), heavy, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* perm, const void* indptr,
           const void* chunk_rows, const void* heavy_rows, const void* n_huge,
           void* out, long long n, int n_live, int h, int n_chunks,
           int n_heavy, int heavy, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (h > 96 ? 4 : (h + 31) / 32) {
    case 1:
      return launch_m<T, 1>(x, perm, indptr, chunk_rows, heavy_rows, n_huge,
                            out, n, n_live, h, n_chunks, n_heavy, heavy, s);
    case 2:
      return launch_m<T, 2>(x, perm, indptr, chunk_rows, heavy_rows, n_huge,
                            out, n, n_live, h, n_chunks, n_heavy, heavy, s);
    case 3:
      return launch_m<T, 3>(x, perm, indptr, chunk_rows, heavy_rows, n_huge,
                            out, n, n_live, h, n_chunks, n_heavy, heavy, s);
    default:
      return launch_m<T, 4>(x, perm, indptr, chunk_rows, heavy_rows, n_huge,
                            out, n, n_live, h, n_chunks, n_heavy, heavy, s);
  }
}

}  // namespace

// (x (E, H), perm (E_live,) int32, indptr (N + 1,) int32, chunk_rows
// (n_chunks + 1,) int32, heavy_rows (n_heavy,) int32, n_huge (1,) int32,
// out (N, H), N, E_live, H, n_chunks, n_heavy, heavy, stream) ->
// cudaGetLastError() after the launch.
extern "C" int segment_sum_f32(const void* x, const void* perm,
                               const void* indptr, const void* chunk_rows,
                               const void* heavy_rows, const void* n_huge,
                               void* out, long long n, int n_live, int h,
                               int n_chunks, int n_heavy, int heavy,
                               void* stream) {
  return launch<float>(x, perm, indptr, chunk_rows, heavy_rows, n_huge, out,
                       n, n_live, h, n_chunks, n_heavy, heavy, stream);
}

extern "C" int segment_sum_bf16(const void* x, const void* perm,
                                const void* indptr, const void* chunk_rows,
                                const void* heavy_rows, const void* n_huge,
                                void* out, long long n, int n_live, int h,
                                int n_chunks, int n_heavy, int heavy,
                                void* stream) {
  return launch<__nv_bfloat16>(x, perm, indptr, chunk_rows, heavy_rows,
                               n_huge, out, n, n_live, h, n_chunks, n_heavy,
                               heavy, stream);
}
