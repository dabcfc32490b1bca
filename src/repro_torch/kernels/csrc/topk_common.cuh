// Device code shared by the port's scoring kernels (knn_topk.cu,
// ivf_probe.cu, assign_clusters.cu): the canonical order, a warp-wide
// top-k list (lane j holds entry j), and the left-to-right
// row reductions that keep every kernel bitwise equal to its plain version
// (kernels/ref.py).
//
// Every sum here runs over the landmark axis left to right with a rounding
// after each multiply and add (round-to-nearest intrinsics, which the
// compiler never contracts into an FMA), in the same order as the plain
// versions' loops.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace repro {

constexpr float kEps = 1e-8f;
constexpr unsigned kFull = 0xffffffffu;

// The canonical order of every list: value descending, then id ascending.
__device__ __forceinline__ bool better(float v, int id, float w, int jd) {
  return v > w || (v == w && id < jd);
}

// One compare-exchange of a warp-wide bitonic network: this lane and lane
// ^ stride swap entries unless this lane already holds the better one
// (``keep_better``) or the worse one.
__device__ __forceinline__ void exchange(float& v, int& id, int stride,
                                         bool keep_better) {
  const float ov = __shfl_xor_sync(kFull, v, stride);
  const int oi = __shfl_xor_sync(kFull, id, stride);
  if (keep_better ? better(ov, oi, v, id) : better(v, id, ov, oi)) {
    v = ov;
    id = oi;
  }
}

constexpr int kBatch = 6;  // offers at least this many: sort and merge

// The warp's list: lane j holds entry j in canonical order (32 entries,
// empty ones (-inf, 0)), and (tv, ti) is entry k−1, the bar a candidate
// must clear. Offers every lane's (v, id) where ``want``; all 32 lanes
// must call it. A few candidates go in one by one (a shuffle-up each);
// many (a list's first rows) are sorted by a bitonic network and merged
// into the list by another. Both keep the list's top 32, of which the
// top k is what the kernel writes.
struct WarpList {
  float ev = -INFINITY, tv = -INFINITY;
  int eid = 0, ti = 0;

  __device__ __forceinline__ void offer(bool want, float v, int id, int k) {
    const int lane = threadIdx.x & 31;
    want = want && better(v, id, tv, ti);
    unsigned bal = __ballot_sync(kFull, want);
    if (__popc(bal) >= kBatch) {
      // non-candidates rank below every entry, the empty ones included
      float cv = want ? v : -INFINITY;
      int ci = want ? id : 0x7fffffff;
#pragma unroll
      for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          exchange(cv, ci, stride,
                   ((lane & stride) == 0) == ((lane & size) == 0));
        }
      }
      // the list descending, the candidates reversed ascending: the better
      // of each pair is a bitonic sequence holding the top 32
      const float rv = __shfl_sync(kFull, cv, 31 - lane);
      const int ri = __shfl_sync(kFull, ci, 31 - lane);
      if (better(rv, ri, ev, eid)) {
        ev = rv;
        eid = ri;
      }
#pragma unroll
      for (int stride = 16; stride > 0; stride >>= 1) {
        exchange(ev, eid, stride, (lane & stride) == 0);
      }
      tv = __shfl_sync(kFull, ev, k - 1);
      ti = __shfl_sync(kFull, eid, k - 1);
      return;
    }
    if (!bal) return;
    // one by one against the bar of the ballot: a candidate that a later
    // one pushed below entry k−1 only fills a slot past k
    do {
      const int src = __ffs(bal) - 1;
      bal &= bal - 1;
      const float cv = __shfl_sync(kFull, v, src);
      const int ci = __shfl_sync(kFull, id, src);
      const float pv = __shfl_up_sync(kFull, ev, 1);
      const int pi = __shfl_up_sync(kFull, eid, 1);
      const bool above = lane > 0 && better(cv, ci, pv, pi);
      const bool here = better(cv, ci, ev, eid);
      ev = above ? pv : (here ? cv : ev);
      eid = above ? pi : (here ? ci : eid);
    } while (bal);
    tv = __shfl_sync(kFull, ev, k - 1);
    ti = __shfl_sync(kFull, eid, k - 1);
  }
};

// The mean of one row of n <= NMAX values (a register array or a
// shared-memory row): a left-to-right sum over a true division by n.
template <int NMAX, typename Row>
__device__ __forceinline__ float row_mean(const Row& x, int n) {
  float s = 0.0f;
#pragma unroll
  for (int d = 0; d < NMAX; ++d) {
    if (d < n) s = __fadd_rn(s, x[d]);
  }
  return __fdiv_rn(s, static_cast<float>(n));
}

// Pearson centering of one row in place. The loops are unrolled with
// constant indices so a register row stays in registers.
template <int NMAX, typename Row>
__device__ __forceinline__ void center(Row& x, int n) {
  const float mean = row_mean<NMAX>(x, n);
#pragma unroll
  for (int d = 0; d < NMAX; ++d) {
    if (d < n) x[d] = __fsub_rn(x[d], mean);
  }
}

// Σ x[d]² over n <= NMAX values, added left to right.
template <int NMAX, typename Row>
__device__ __forceinline__ float sq_norm(const Row& x, int n) {
  float s = 0.0f;
#pragma unroll
  for (int d = 0; d < NMAX; ++d) {
    if (d < n) s = __fadd_rn(s, __fmul_rn(x[d], x[d]));
  }
  return s;
}

// The d2 epilogue of the graph-build tiles with pearson's norms as their
// roots: pearson z / max(ru·rv, eps) where ru = √|u|², rv = √|v|² (a kernel
// takes each root once per row); cosine and euclidean as tile_epilogue.
__device__ __forceinline__ float tile_epilogue_rooted(float z, float un,
                                                      float vn, int measure) {
  if (measure == 0) return z;
  if (measure == 1) return __fdiv_rn(z, fmaxf(__fmul_rn(un, vn), kEps));
  const float d2 = fmaxf(__fadd_rn(__fsub_rn(un, __fmul_rn(2.0f, z)), vn),
                         0.0f);
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, __fsqrt_rn(d2)));
}

// The d2 epilogue of the graph-build tiles (plain version:
// kernels/ref.py::tile_sims): cosine on caller-normalized rows is the raw
// dot z; pearson z / max(√|u|²·√|v|², eps) on centered rows; euclidean
// 1 / (1 + √max(|u|² − 2z + |v|², 0)). ``un``/``vn`` are squared norms.
__device__ __forceinline__ float tile_epilogue(float z, float un, float vn,
                                               int measure) {
  if (measure == 1) return tile_epilogue_rooted(z, __fsqrt_rn(un),
                                                __fsqrt_rn(vn), 1);
  return tile_epilogue_rooted(z, un, vn, measure);
}

// The ``dense_similarity`` epilogue on raw rows (plain version:
// kernels/ref.py::gathered_sims): cosine and pearson (rows centered by the
// caller) z / max(√|u|²·√|v|², eps); euclidean as above. This cosine is
// NOT the normalized-row dot of tile_epilogue: the two round differently.
__device__ __forceinline__ float dense_epilogue(float z, float un, float vn,
                                                int measure) {
  if (measure == 2) return tile_epilogue(z, un, vn, 2);
  return __fdiv_rn(z, fmaxf(__fmul_rn(__fsqrt_rn(un), __fsqrt_rn(vn)),
                            kEps));
}

}  // namespace repro
