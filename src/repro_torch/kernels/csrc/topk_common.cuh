// Device code shared by the port's scoring kernels (knn_topk.cu,
// ivf_probe.cu, assign_clusters.cu): the canonical order, a lane's
// register-resident top-k list and its warp merge, and the left-to-right
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

// A lane's best KMAX entries, sorted canonically. KMAX >= k, so the top k
// of the union of the 32 lanes' lists is the top k of all candidates. Every
// index is a compile-time constant (insertion is a select network), so the
// lists stay in registers.
template <int KMAX>
struct TopK {
  float v[KMAX];
  int id[KMAX];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      v[j] = -INFINITY;
      id[j] = 0;
    }
  }

  __device__ __forceinline__ void offer(float nv, int nid) {
    if (!better(nv, nid, v[KMAX - 1], id[KMAX - 1])) return;
    // slot j takes old j-1 if the new entry outranks it, else the new
    // entry if it outranks old j, else keeps old j; walking down reads
    // only slots not yet written
#pragma unroll
    for (int j = KMAX - 1; j > 0; --j) {
      const bool above = better(nv, nid, v[j - 1], id[j - 1]);
      const bool here = better(nv, nid, v[j], id[j]);
      v[j] = above ? v[j - 1] : (here ? nv : v[j]);
      id[j] = above ? id[j - 1] : (here ? nid : id[j]);
    }
    if (better(nv, nid, v[0], id[0])) {
      v[0] = nv;
      id[0] = nid;
    }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int j = 0; j < KMAX - 1; ++j) {
      v[j] = v[j + 1];
      id[j] = id[j + 1];
    }
    v[KMAX - 1] = -INFINITY;
    id[KMAX - 1] = 0;
  }
};

// k rounds of a warp-wide arg-max over the 32 list heads; the lane holding
// the winner pops it. Empty slots come out as (-inf, 0). All 32 lanes must
// call this.
template <int KMAX>
__device__ __forceinline__ void warp_merge(TopK<KMAX>& t, int k,
                                           float* out_v, int* out_i) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < k; ++r) {
    float bv = t.v[0];
    int bi = t.id[0];
    int bl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      const int ol = __shfl_xor_sync(kFull, bl, off);
      if (better(ov, oi, bv, bi) || (ov == bv && oi == bi && ol < bl)) {
        bv = ov;
        bi = oi;
        bl = ol;
      }
    }
    if (lane == 0) {
      out_v[r] = bv;
      out_i[r] = bv == -INFINITY ? 0 : bi;  // empty slot
    }
    if (lane == bl) t.pop();
  }
}

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

// The d2 epilogue of the graph-build tiles (plain version:
// kernels/ref.py::tile_sims): cosine on caller-normalized rows is the raw
// dot z; pearson z / max(√|u|²·√|v|², eps) on centered rows; euclidean
// 1 / (1 + √max(|u|² − 2z + |v|², 0)). ``un``/``vn`` are squared norms.
__device__ __forceinline__ float tile_epilogue(float z, float un, float vn,
                                               int measure) {
  if (measure == 0) return z;
  if (measure == 1) {
    return __fdiv_rn(z, fmaxf(__fmul_rn(__fsqrt_rn(un), __fsqrt_rn(vn)),
                              kEps));
  }
  const float d2 = fmaxf(__fadd_rn(__fsub_rn(un, __fmul_rn(2.0f, z)), vn),
                         0.0f);
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, __fsqrt_rn(d2)));
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
