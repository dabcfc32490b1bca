// k-means (Lloyd) for Hopper in one launch, f32 on the CUDA cores.
//
// Replaces the TPU kernel src/repro/retrieval/kmeans.py
// assign_clusters_kernel (body _assign_kernel: one (rows, C) d2 score tile
// with the graph-build epilogue of knn_topk.tile_sims and an arg-max per
// row, ties to the lowest centroid id) together with the Lloyd loop the
// reference jits around it (kmeans: jax.ops.segment_sum of the member rows
// and their count, the mean, empty cells keeping their centroid).
//
// What bounds it on an H100: at the IVF build's shape (U = 5976 rows,
// C = 77 cells, n = 20, 8 steps) one assignment is 2·U·C·n = 18 MFLOP
// (~0.27 µs at the f32 peak) and the whole call nine of them (~2.5 µs)
// over ~0.5 MB of rows: far below what one launch costs. What remains is
// latency: 17 grid barriers (~0.75 µs each), two dependent round trips
// through L2 a step (~1-1.5 µs each here), and each cell's sum, which adds
// its members one after another to keep the reference's order.
//
// Design: one cooperative launch runs every phase, one block on each SM,
// and the grid synchronizes between phases with grid.sync(). (One cluster
// of 16 blocks with barrier.cluster was 3.5-4x slower: its assignment
// runs on 16 SMs.)
// 0. prepare: each block prepares its own contiguous range of rows and of
//    starting centroids as the scores take them (cosine divided by
//    max(√Σx², eps) when `normalize`, pearson centered; the sums left to
//    right, the divisions spread over the threads), with each one's
//    epilogue value (pearson's root of the squared norm, euclidean's
//    squared norm); the centroids zero-padded to `cstride`.
// 1. assignment: each block owns a contiguous range of rows and stages the
//    prepared centroids in shared memory (tiles of `tile`, so any C fits)
//    while its rows' loads are in flight. P adjacent lanes share a row,
//    each scoring every P-th centroid, two at a time, with the f32
//    left-to-right sums (over a fixed register width: zero padding adds
//    +0 terms, which can change a score's sign of zero and never its
//    order) and the IEEE epilogue of repro::tile_epilogue; a shuffle
//    arg-max per row, ties to the lowest id. Intermediate steps assign the
//    rows below n_valid, the last step all U.
// 2. update: a block takes a cell. Per window of the assignment vector
//    each thread reads a run of 16, a block-wide prefix of the runs' hits
//    lists the cell's members in ascending row order, the block stages
//    their raw rows a dim a column, and warp 0's lanes (one a dim) add them
//    in that order with __fadd_rn from +0.0: the order of
//    jax.ops.segment_sum and of CPU index_add_. The mean is an IEEE
//    division by the exact count, which warp 0 prepares for the next
//    assignment; an empty cell keeps its centroid; rows >= n_valid take
//    no part.
// Nothing is atomic, so two launches agree bit for bit, and the plain
// version (kernels/ref.py::kmeans_lloyd_ref) repeats the arithmetic op for
// op. Row widths n <= 104 take the register widths 8, 20, 32, 64, 104 (at
// 104 the register row takes 104 of the 128 registers a thread has at 512
// threads, so the assignment spills: right, and slower). Wider rows take
// the wide route (lloyd_wide_kernel), the same phases and grid barriers
// with no array sized by n:
// 0. a thread prepares a row (or a centroid) from global memory, its sums
//    left to right as above; the centroids keep stride n;
// 1. 64 rows a pass, 8 lanes a row, each lane scoring 8 of a 64-centroid
//    tile: rows and centroids staged in slices of kWideSlice landmarks, the
//    8 partial dot products kept in registers across the slices,
//    ascending in d (exactly n terms: the plain version's sums);
// 2. a block takes a cell, lists its members in row order per window as
//    above, and a thread a dim (kThreads dims a pass) adds the members'
//    values in that order from global memory; thread 0 then takes the new
//    centroid's mean and norm and the block writes its prepared row.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "topk_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 12288;  // floats: rows, a centroid tile or members
constexpr int kWindow = 8192;  // assignments a window (16 a thread)
constexpr int kGather = 8;     // member values a thread loads at once
constexpr size_t kSmemBytes =
    sizeof(float) * kStage + sizeof(int) * (kWindow + kWarps);
constexpr int kNarrowWidth = 104;  // the widest register row
constexpr int kWideSlice = 32;     // the wide route's landmarks a slice
constexpr int kWidePitch = kWideSlice + 1;
constexpr int kWideRows = 64, kWideParts = 8;  // rows a pass, lanes a row
constexpr int kWideTile = 64;  // centroids a tile (8 a lane)
static_assert(kWideRows * kWideParts == kThreads &&
              2 * kWideRows * kWidePitch + kWideTile <= kStage);

struct Lloyd {
  const float* rep;   // (U, n) raw rows
  const float* init;  // (C, n) starting centroids
  float* cent;        // (C, n) out: the centroids, updated in place
  int* assign;        // (U,) out: the last step's assignment
  float* prep;        // (U, n) scratch: the rows as the scores take them
  float* pval;        // (U,) scratch: their epilogue values
  float* cprep;       // (C, cstride) scratch: the centroids, zero past n
  float* cval;        // (C,) scratch: their epilogue values
  int U, C, n, iters, n_valid, measure, normalize;
  int cstride;        // the register width, ≡ 4 mod 8: float4 reads
  int tile;           // centroids a staged tile
  int column;         // staged members a dim (≡ 4 mod 8)
};

// The contiguous range [r0, r0 + count) of `rows` that this block owns.
__device__ __forceinline__ int2 block_rows(int rows) {
  const int per = (rows + gridDim.x - 1) / gridDim.x;
  const int r0 = min(rows, (int)blockIdx.x * per);
  return make_int2(r0, min(rows, r0 + per) - r0);
}

// Exclusive prefix over the block of each thread's `v`; `total` gets the
// sum. `sums` holds kWarps ints; the caller syncs before reusing it.
__device__ __forceinline__ int block_scan(int v, int* sums, int& total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(repro::kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = sums[w];
    before += w < warp ? t : 0;
    total += t;
  }
  return before + x - v;
}

// Prepares `count` rows staged in shared memory (stride rs) as the scores
// take them — pearson centered, cosine divided by max(√Σx², eps) when the
// kernel normalizes — into dst (row stride dstride, zero past n), and each
// row's epilogue value into val: pearson's root of the squared norm,
// euclidean's squared norm. Sums run left to right; a thread a row takes
// the sums, the block's threads the divisions. `div` holds count floats.
template <int NMAX>
__device__ void prepare_staged(const Lloyd& a, float* xs, int rs, int count,
                               float* div, float* dst, int dstride,
                               float* val) {
  for (int r = threadIdx.x; r < count; r += kThreads) {
    float* x = xs + r * rs;
    if (a.measure == 1) repro::center<NMAX>(x, a.n);
    const float sq = repro::sq_norm<NMAX>(x, a.n);
    div[r] = fmaxf(__fsqrt_rn(sq), repro::kEps);
    val[r] = a.measure == 1 ? __fsqrt_rn(sq) : sq;
  }
  __syncthreads();
  const bool divide = a.measure == 0 && a.normalize;
#pragma unroll 4
  for (int e = threadIdx.x; e < count * dstride; e += kThreads) {
    const int r = e / dstride, d = e - r * dstride;
    float x = d < a.n ? xs[r * rs + d] : 0.0f;
    if (divide && d < a.n) x = __fdiv_rn(x, div[r]);
    dst[e] = x;
  }
}

// Stages `count` rows of src (n floats each, contiguous) in shared memory
// at an odd stride (a thread a row reads without conflicts) and prepares
// them into dst.
template <int NMAX>
__device__ void prepare_rows(const Lloyd& a, const float* src, int count,
                             float* dst, int dstride, float* val,
                             float* stage) {
  const int n = a.n, rs = n | 1;
  const int chunk = kStage / (rs + 1);
  float* div = stage + chunk * rs;
  for (int c0 = 0; c0 < count; c0 += chunk) {  // uniform across the block
    const int cn = min(chunk, count - c0);
    __syncthreads();  // the previous chunk is written out
#pragma unroll 4
    for (int e = threadIdx.x; e < cn * n; e += kThreads) {
      const int r = e / n;
      stage[r * rs + e - r * n] = __ldg(src + (size_t)c0 * n + e);
    }
    __syncthreads();
    prepare_staged<NMAX>(a, stage, rs, cn, div,
                         dst + (size_t)c0 * dstride, dstride, val + c0);
  }
}

// Phase 0: each block prepares its own rows and its own starting
// centroids; the centroids are copied to the output.
template <int NMAX>
__device__ void prepare_all(const Lloyd& a, float* stage) {
  const int2 rows = block_rows(a.U);
  prepare_rows<NMAX>(a, a.rep + (size_t)rows.x * a.n, rows.y,
                     a.prep + (size_t)rows.x * a.n, a.n, a.pval + rows.x,
                     stage);
  const int2 cells = block_rows(a.C);
  prepare_rows<NMAX>(a, a.init + (size_t)cells.x * a.n, cells.y,
                     a.cprep + (size_t)cells.x * a.cstride, a.cstride,
                     a.cval + cells.x, stage);
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < a.C * a.n;
       i += stride) {
    a.cent[i] = __ldg(a.init + i);
  }
}

// Phase 1 over rows [0, rows): each row's nearest centroid. P adjacent
// lanes share a row, each scoring every P-th centroid, two at a time,
// against the prepared centroids staged in shared memory.
template <int NMAX>
__device__ void assign_rows(const Lloyd& a, float* stage, int rows) {
  const int2 own = block_rows(rows);
  int parts = 1;  // a power of two, so a row's lanes are in one warp
  while (parts < 32 && own.y * 2 * parts <= kThreads) parts *= 2;
  const int pass = kThreads / parts;  // rows a pass
  const int part = threadIdx.x & (parts - 1);
  const int S4 = a.cstride / 4;
  float4* c4 = reinterpret_cast<float4*>(stage);
  float* cval = stage + a.tile * a.cstride;
  const int tiles = (a.C + a.tile - 1) / a.tile;
  for (int i0 = 0; i0 < own.y; i0 += pass) {  // uniform across the block
    const int i = i0 + threadIdx.x / parts;
    const bool active = i < own.y;
    const size_t row = own.x + i;
    float q[NMAX];  // zero past n, as the staged centroids; in flight
#pragma unroll      // while the tile is staged
    for (int d = 0; d < NMAX; ++d) {
      q[d] = (active && d < a.n) ? __ldcg(a.prep + row * a.n + d) : 0.0f;
    }
    const float qval = active ? __ldcg(a.pval + row) : 0.0f;
    float best_v = -INFINITY;
    int best_i = 0;
    for (int t = 0; t < tiles; ++t) {
      const int t0 = t * a.tile;
      const int tn = min(a.tile, a.C - t0);
      if (tiles > 1 || i0 == 0) {  // one tile stays staged for every pass
        __syncthreads();  // the previous tile is no longer read
        const float4* src = reinterpret_cast<const float4*>(
            a.cprep + (size_t)t0 * a.cstride);
#pragma unroll 4
        for (int e = threadIdx.x; e < tn * S4; e += kThreads) {
          c4[e] = __ldcg(src + e);
        }
        for (int r = threadIdx.x; r < tn; r += kThreads) {
          cval[r] = __ldcg(a.cval + t0 + r);
        }
        __syncthreads();
      }
      if (!active) continue;
      for (int j = part; j < tn; j += 2 * parts) {
        const int j2 = j + parts;
        const bool two = j2 < tn;
        const float4* x0 = c4 + j * S4;
        const float4* x1 = c4 + (two ? j2 : j) * S4;
        float z0 = 0.0f, z1 = 0.0f;
#pragma unroll
        for (int v = 0; v < NMAX / 4; ++v) {  // zero past n: +0 terms
          const float4 u = x0[v], w = x1[v];
          z0 = __fadd_rn(z0, __fmul_rn(q[4 * v], u.x));
          z1 = __fadd_rn(z1, __fmul_rn(q[4 * v], w.x));
          z0 = __fadd_rn(z0, __fmul_rn(q[4 * v + 1], u.y));
          z1 = __fadd_rn(z1, __fmul_rn(q[4 * v + 1], w.y));
          z0 = __fadd_rn(z0, __fmul_rn(q[4 * v + 2], u.z));
          z1 = __fadd_rn(z1, __fmul_rn(q[4 * v + 2], w.z));
          z0 = __fadd_rn(z0, __fmul_rn(q[4 * v + 3], u.w));
          z1 = __fadd_rn(z1, __fmul_rn(q[4 * v + 3], w.w));
        }
        const float s0 = repro::tile_epilogue_rooted(z0, qval, cval[j],
                                                     a.measure);
        if (repro::better(s0, t0 + j, best_v, best_i)) {
          best_v = s0;
          best_i = t0 + j;
        }
        if (two) {
          const float s1 = repro::tile_epilogue_rooted(z1, qval, cval[j2],
                                                       a.measure);
          if (repro::better(s1, t0 + j2, best_v, best_i)) {
            best_v = s1;
            best_i = t0 + j2;
          }
        }
      }
    }
    for (int off = parts >> 1; off > 0; off >>= 1) {  // within the group
      const float ov = __shfl_xor_sync(repro::kFull, best_v, off);
      const int oi = __shfl_xor_sync(repro::kFull, best_i, off);
      if (repro::better(ov, oi, best_v, best_i)) {
        best_v = ov;
        best_i = oi;
      }
    }
    if (active && part == 0) a.assign[row] = best_i;
  }
}

// Phase 2: each cell's mean over its members in ascending row order. A
// block takes a cell. Per window of the assignment vector each thread
// reads a run of 16, a block-wide prefix of the runs' hits lists the
// members in row order, the block stages their raw rows a dim a column,
// and warp 0's lanes (one a dim) add them in that order, four a read. The
// block then prepares the new centroid for the next assignment.
template <int NMAX>
__device__ void update_cells(const Lloyd& a, float* stage, int* window,
                             int* sums) {
  constexpr int kDims = (NMAX + 31) / 32;  // dims a lane adds
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = a.n, M = a.column;
  for (int c = blockIdx.x; c < a.C; c += gridDim.x) {  // uniform
    float s[kDims];
#pragma unroll
    for (int h = 0; h < kDims; ++h) s[h] = 0.0f;
    int members = 0;
    for (int w0 = 0; w0 < a.n_valid; w0 += kWindow) {
      const int wn = min(kWindow, a.n_valid - w0);
      __syncthreads();  // the previous window and stage are no longer read
      const int4* src = reinterpret_cast<const int4*>(a.assign + w0);
#pragma unroll 4
      for (int i = threadIdx.x; i < wn / 4; i += kThreads) {
        reinterpret_cast<int4*>(window)[i] = __ldcg(src + i);
      }
      for (int i = (wn & ~3) + threadIdx.x; i < wn; i += kThreads) {
        window[i] = __ldcg(a.assign + w0 + i);
      }
      __syncthreads();
      const int run = ((wn + kThreads - 1) / kThreads + 3) & ~3;  // <= 16
      const int b0 = min(wn, (int)threadIdx.x * run);
      const int b1 = min(wn, b0 + run);
      int mine[16];
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const int4 v = b0 + 4 * k4 < b1
                           ? reinterpret_cast<const int4*>(window + b0)[k4]
                           : make_int4(-1, -1, -1, -1);
        mine[4 * k4] = v.x;
        mine[4 * k4 + 1] = v.y;
        mine[4 * k4 + 2] = v.z;
        mine[4 * k4 + 3] = v.w;
      }
      int hits = 0;
#pragma unroll
      for (int k = 0; k < 16; ++k) hits += (b0 + k < b1 && mine[k] == c);
      int total;
      int j = block_scan(hits, sums, total);  // syncs: every run is read
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (b0 + k < b1 && mine[k] == c) window[j++] = w0 + b0 + k;
      }
      for (int base = 0; base < total; base += M) {  // uniform
        const int m = min(M, total - base);
        __syncthreads();  // the ids are listed, the last round is added
        // every id and row value of a batch is read before it is stored
        // (a store to shared memory would otherwise hold back the next id)
        for (int e0 = threadIdx.x; e0 < m * n; e0 += kGather * kThreads) {
          float v[kGather];
          int at[kGather];
#pragma unroll
          for (int u = 0; u < kGather; ++u) {
            const int e = e0 + u * kThreads;
            const int k = e / n, d = e - k * n;
            at[u] = d * M + k;
            v[u] = e < m * n ? __ldg(a.rep + (size_t)window[base + k] * n + d)
                             : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kGather; ++u) {
            if (e0 + u * kThreads < m * n) stage[at[u]] = v[u];
          }
        }
        __syncthreads();
        if (warp == 0) {
#pragma unroll
          for (int h = 0; h < kDims; ++h) {
            const int d = lane + 32 * h;
            if (d >= n) continue;
            const float* col = stage + d * M;
            int k = 0;
#pragma unroll 4
            for (; k + 4 <= m; k += 4) {
              const float4 v = *reinterpret_cast<const float4*>(col + k);
              s[h] = __fadd_rn(s[h], v.x);
              s[h] = __fadd_rn(s[h], v.y);
              s[h] = __fadd_rn(s[h], v.z);
              s[h] = __fadd_rn(s[h], v.w);
            }
            for (; k < m; ++k) s[h] = __fadd_rn(s[h], col[k]);
          }
        }
        members += m;
      }
    }
    // an empty cell keeps its centroid; warp 0 writes the new one and
    // prepares it for the next assignment in the stage, which only its own
    // chain read since the last gather
    if (members == 0 || warp != 0) continue;
    const float cnt = static_cast<float>(members);
    float* x = stage;
    __syncwarp();
#pragma unroll
    for (int h = 0; h < kDims; ++h) {
      const int d = lane + 32 * h;
      if (d < n) {
        x[d] = __fdiv_rn(s[h], cnt);
        a.cent[(size_t)c * n + d] = x[d];
      }
    }
    __syncwarp();
    float div = 1.0f;
    if (lane == 0) {
      if (a.measure == 1) repro::center<NMAX>(x, n);
      const float sq = repro::sq_norm<NMAX>(x, n);
      div = fmaxf(__fsqrt_rn(sq), repro::kEps);
      a.cval[c] = a.measure == 1 ? __fsqrt_rn(sq) : sq;
    }
    __syncwarp();
    div = __shfl_sync(repro::kFull, div, 0);
    const bool divide = a.measure == 0 && a.normalize;
    for (int d = lane; d < a.cstride; d += 32) {
      float v = d < n ? x[d] : 0.0f;
      if (divide && d < n) v = __fdiv_rn(v, div);
      a.cprep[(size_t)c * a.cstride + d] = v;
    }
  }
}

// ---------------------------------------------------------- wide route
// Prepares `count` rows of src (n floats each) from global memory, a thread
// a row, into dst (row stride dstride, zero past n) and each row's
// epilogue value into val: prepare_staged's arithmetic in its order.
__device__ void prepare_wide(const Lloyd& a, const float* src, int count,
                             float* dst, int dstride, float* val) {
  const int n = a.n;
  const bool divide = a.measure == 0 && a.normalize;
  for (int r = threadIdx.x; r < count; r += kThreads) {
    const float* x = src + (size_t)r * n;
    float mean = 0.0f;
    if (a.measure == 1) {
      float sum = 0.0f;
      for (int d = 0; d < n; ++d) sum = __fadd_rn(sum, __ldg(x + d));
      mean = __fdiv_rn(sum, static_cast<float>(n));
    }
    float sq = 0.0f;
    for (int d = 0; d < n; ++d) {
      const float v = a.measure == 1 ? __fsub_rn(__ldg(x + d), mean)
                                     : __ldg(x + d);
      sq = __fadd_rn(sq, __fmul_rn(v, v));
    }
    const float div = fmaxf(__fsqrt_rn(sq), repro::kEps);
    val[r] = a.measure == 1 ? __fsqrt_rn(sq) : sq;
    float* out = dst + (size_t)r * dstride;
    for (int d = 0; d < dstride; ++d) {
      float v = 0.0f;
      if (d < n) {
        v = a.measure == 1 ? __fsub_rn(__ldg(x + d), mean) : __ldg(x + d);
        if (divide) v = __fdiv_rn(v, div);
      }
      out[d] = v;
    }
  }
}

__device__ void prepare_all_wide(const Lloyd& a) {
  const int2 rows = block_rows(a.U);
  prepare_wide(a, a.rep + (size_t)rows.x * a.n, rows.y,
               a.prep + (size_t)rows.x * a.n, a.n, a.pval + rows.x);
  const int2 cells = block_rows(a.C);
  prepare_wide(a, a.init + (size_t)cells.x * a.n, cells.y,
               a.cprep + (size_t)cells.x * a.cstride, a.cstride,
               a.cval + cells.x);
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < a.C * a.n;
       i += stride) {
    a.cent[i] = __ldg(a.init + i);
  }
}

// Phase 1 over rows [0, rows), wide: kWideRows rows a pass, kWideParts
// lanes a row; lane `part` scores centroids part + 8·j of each tile of
// kWideTile. Rows and centroids are staged a slice at a time and each
// lane's 8 dot products carry across the slices.
__device__ void assign_wide(const Lloyd& a, float* stage, int rows) {
  const int2 own = block_rows(rows);
  const int tid = threadIdx.x;
  const int part = tid & (kWideParts - 1), rl = tid / kWideParts;
  constexpr int kPer = kWideTile / kWideParts;
  float* sr = stage;                           // [kWideRows][kWidePitch]
  float* sc = stage + kWideRows * kWidePitch;  // [kWideTile][kWidePitch]
  float* cv = sc + kWideTile * kWidePitch;     // [kWideTile]
  for (int i0 = 0; i0 < own.y; i0 += kWideRows) {  // uniform across the block
    const int rn = min(kWideRows, own.y - i0);
    const bool active = rl < rn;
    const size_t row = own.x + i0 + rl;
    const float qval = active ? __ldcg(a.pval + row) : 0.0f;
    float best_v = -INFINITY;
    int best_i = 0;
    for (int t0 = 0; t0 < a.C; t0 += kWideTile) {
      const int tn = min(kWideTile, a.C - t0);
      float z[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) z[j] = 0.0f;
      for (int d0 = 0; d0 < a.n; d0 += kWideSlice) {
        const int w = min(kWideSlice, a.n - d0);
        __syncthreads();  // the last slice (and tile values) are read
        for (int e = tid; e < kWideRows * kWideSlice; e += kThreads) {
          const int r = e / kWideSlice, d = e % kWideSlice;
          if (d < w && r < rn) {
            sr[r * kWidePitch + d] =
                __ldcg(a.prep + (own.x + i0 + r) * (size_t)a.n + d0 + d);
          }
          if (d < w && r < tn) {
            sc[r * kWidePitch + d] =
                __ldcg(a.cprep + (size_t)(t0 + r) * a.cstride + d0 + d);
          }
        }
        if (d0 == 0) {
          for (int r = tid; r < tn; r += kThreads) {
            cv[r] = __ldcg(a.cval + t0 + r);
          }
        }
        __syncthreads();
        const float* x = sr + rl * kWidePitch;
        for (int d = 0; d < w; ++d) {
          const float u = x[d];
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            z[j] = __fadd_rn(z[j],
                             __fmul_rn(u, sc[(part + kWideParts * j) *
                                                 kWidePitch + d]));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = part + kWideParts * j;
        if (active && c < tn) {
          const float v = repro::tile_epilogue_rooted(z[j], qval, cv[c],
                                                      a.measure);
          if (repro::better(v, t0 + c, best_v, best_i)) {
            best_v = v;
            best_i = t0 + c;
          }
        }
      }
    }
    for (int off = kWideParts >> 1; off > 0; off >>= 1) {  // within the row
      const float ov = __shfl_xor_sync(repro::kFull, best_v, off);
      const int oi = __shfl_xor_sync(repro::kFull, best_i, off);
      if (repro::better(ov, oi, best_v, best_i)) {
        best_v = ov;
        best_i = oi;
      }
    }
    if (active && part == 0) a.assign[row] = best_i;
  }
}

// Phase 2, wide: each cell's mean over its members in ascending row order,
// a thread a dim. The members are listed per window as update_cells lists
// them; each pass over kThreads dims lists them again.
__device__ void update_wide(const Lloyd& a, int* window, int* sums) {
  __shared__ float s_prep[2];  // the new centroid's mean and divisor
  const int n = a.n;
  for (int c = blockIdx.x; c < a.C; c += gridDim.x) {  // uniform
    int members = 0;
    for (int dc = 0; dc < n; dc += kThreads) {  // uniform
      const int d = dc + threadIdx.x;
      float s = 0.0f;
      members = 0;
      for (int w0 = 0; w0 < a.n_valid; w0 += kWindow) {
        const int wn = min(kWindow, a.n_valid - w0);
        __syncthreads();  // the previous window is no longer read
        for (int i = threadIdx.x; i < wn; i += kThreads) {
          window[i] = __ldcg(a.assign + w0 + i);
        }
        __syncthreads();
        const int run = ((wn + kThreads - 1) / kThreads + 3) & ~3;  // <= 16
        const int b0 = min(wn, (int)threadIdx.x * run);
        const int b1 = min(wn, b0 + run);
        int mine[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          mine[k] = b0 + k < b1 ? window[b0 + k] : -1;
        }
        int hits = 0;
#pragma unroll
        for (int k = 0; k < 16; ++k) hits += mine[k] == c;
        int total;
        int j = block_scan(hits, sums, total);  // syncs: every run is read
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          if (mine[k] == c) window[j++] = w0 + b0 + k;
        }
        __syncthreads();  // the members are listed
        if (d < n) {
          for (int m = 0; m < total; ++m) {
            s = __fadd_rn(s, __ldg(a.rep + (size_t)window[m] * n + d));
          }
        }
        members += total;
      }
      if (members > 0 && d < n) {
        a.cent[(size_t)c * n + d] = __fdiv_rn(s, static_cast<float>(members));
      }
    }
    // an empty cell keeps its centroid; else prepare the new one for the
    // next assignment
    if (members == 0) continue;
    __syncthreads();  // the block's writes of the centroid are visible
    const float* x = a.cent + (size_t)c * n;
    if (threadIdx.x == 0) {
      float mean = 0.0f;
      if (a.measure == 1) {
        float sum = 0.0f;
        for (int d = 0; d < n; ++d) sum = __fadd_rn(sum, __ldcg(x + d));
        mean = __fdiv_rn(sum, static_cast<float>(n));
      }
      float sq = 0.0f;
      for (int d = 0; d < n; ++d) {
        const float v = a.measure == 1 ? __fsub_rn(__ldcg(x + d), mean)
                                       : __ldcg(x + d);
        sq = __fadd_rn(sq, __fmul_rn(v, v));
      }
      a.cval[c] = a.measure == 1 ? __fsqrt_rn(sq) : sq;
      s_prep[0] = mean;
      s_prep[1] = fmaxf(__fsqrt_rn(sq), repro::kEps);
    }
    __syncthreads();
    const bool divide = a.measure == 0 && a.normalize;
    for (int d = threadIdx.x; d < a.cstride; d += kThreads) {
      float v = 0.0f;
      if (d < n) {
        v = __ldcg(x + d);
        if (a.measure == 1) v = __fsub_rn(v, s_prep[0]);
        if (divide) v = __fdiv_rn(v, s_prep[1]);
      }
      a.cprep[(size_t)c * a.cstride + d] = v;
    }
    __syncthreads();  // s_prep is read before the next cell writes it
  }
}

__global__ void __launch_bounds__(kThreads, 1)
lloyd_wide_kernel(const Lloyd a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  int* window = reinterpret_cast<int*>(stage + kStage);
  int* sums = window + kWindow;
  prepare_all_wide(a);
  grid.sync();
  for (int step = 0; step < a.iters; ++step) {
    assign_wide(a, stage, a.n_valid);
    grid.sync();
    update_wide(a, window, sums);
    grid.sync();
  }
  assign_wide(a, stage, a.U);
}

// Every block waits for all the others between phases (grid.sync(): a
// block's writes before it are visible to every block after it); data
// another block wrote is read with __ldcg, past the SM's L1.
template <int NMAX>
__global__ void __launch_bounds__(kThreads, 1) lloyd_kernel(const Lloyd a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  int* window = reinterpret_cast<int*>(stage + kStage);
  int* sums = window + kWindow;
  prepare_all<NMAX>(a, stage);
  grid.sync();
  for (int step = 0; step < a.iters; ++step) {
    assign_rows<NMAX>(a, stage, a.n_valid);
    grid.sync();
    update_cells<NMAX>(a, stage, window, sums);
    grid.sync();
  }
  assign_rows<NMAX>(a, stage, a.U);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Lloyd& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, kSmemBytes);
  }
  if (err != cudaSuccess) return err;
  // every block must be resident at once; a grid the card cannot hold is
  // refused, never launched smaller
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sms);  // one resident block per SM
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

// normalize: cosine rows and centroids are L2-normalized here (else by the
// caller).
// cscratch holds C·(cstride + 1) floats: the padded centroids, then their
// epilogue values; cstride is the register width up to n = 104 (≡ 4 mod 8,
// <= 108) and n past it (kernels/assign_clusters.py::centroid_stride).
extern "C" int kmeans_lloyd_f32(const void* rep, const void* init,
                                void* cent, void* assign, void* prep,
                                void* pval, void* cscratch, int U, int C,
                                int n, int iters, int n_valid, int measure,
                                int normalize, void* stream) {
  if (U <= 0 || C <= 0 || n <= 0 || iters < 0 || n_valid < 0 ||
      n_valid > U || measure < 0 || measure > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > kNarrowWidth) {  // the wide route: centroid stride n
    float* cs = static_cast<float*>(cscratch);
    const Lloyd a{static_cast<const float*>(rep),
                  static_cast<const float*>(init),
                  static_cast<float*>(cent),
                  static_cast<int*>(assign),
                  static_cast<float*>(prep),
                  static_cast<float*>(pval),
                  cs,
                  cs + (size_t)C * n,
                  U, C, n, iters, n_valid, measure, normalize, n, 0, 0};
    return static_cast<int>(launch(lloyd_wide_kernel, a, s));
  }
  // the register row's width, and the staged centroids' stride: at least
  // that width (float4 reads), ≡ 4 mod 8 (no bank conflicts)
  const int width =
      n <= 8 ? 8 : n <= 20 ? 20 : n <= 32 ? 32 : n <= 64 ? 64 : 104;
  const int cstride = width % 8 ? width : width + 4;
  float* cs = static_cast<float*>(cscratch);
  const Lloyd a{static_cast<const float*>(rep),
                static_cast<const float*>(init),
                static_cast<float*>(cent),
                static_cast<int*>(assign),
                static_cast<float*>(prep),
                static_cast<float*>(pval),
                cs,
                cs + (size_t)C * cstride,
                U, C, n, iters, n_valid, measure, normalize, cstride,
                kStage / (cstride + 1),
                (kStage / n - 4) / 8 * 8 + 4};
  cudaError_t err;
  switch (width) {
    case 8:
      err = launch(lloyd_kernel<8>, a, s);
      break;
    case 20:
      err = launch(lloyd_kernel<20>, a, s);
      break;
    case 32:
      err = launch(lloyd_kernel<32>, a, s);
      break;
    case 64:
      err = launch(lloyd_kernel<64>, a, s);
      break;
    default:
      err = launch(lloyd_kernel<104>, a, s);
  }
  return static_cast<int>(err);
}
