// B4 knn_window: the windowed (distance, id) k-best of the block-pruned
// boundary rescan. For row tile t of the chunk and each of its rows, scan
// the columns [wstart[t] * col_tile, (wstart[t] + n_win_tiles) * col_tile)
// in ascending column tiles and keep the row's k lex-smallest
// (distance, column id) pairs; empty slots are (+inf, -1), columns at or
// past n are masked (+inf) and never enter.
//
// Replaces the TPU kernel hdbscan_tpu/ops/pallas_knn.py knn_window_fused_pallas
// (_fused_window_kernel with _dot_dist_tile and _fused_merge_tile), and the
// per-column-tile guarded top_k merge of the XLA chunk
// ops/blockscan._knn_window_merge_chunk, which computes the same k-best in
// the tile-shape-selected distance form (the metric code picks the form).
//
// The tile guard is the reference's, at its grain: a (row tile x column
// tile) block merges only if some row of the row tile has a distance
// strictly below min(its running k-th, bnd[row]); then EVERY row of the
// tile merges the whole column tile. A per-row guard would admit other
// elements equal to the bound and change which id wins a tie at the k-th
// slot, so the block first decides with __syncthreads_or (pass 1, which
// stops at the first sub-tile holding a candidate) and only then merges
// (pass 2, the distances recomputed).
//
// Design: one CUDA block per row tile, one thread per row; the row's sorted
// k-list lives in registers (k bucketed to a compile-time KB in {16, 32,
// 128}; local memory at 128). Columns are staged through shared memory in
// sub-tiles. A column enters only if strictly closer than the row's k-th;
// ids arrive in ascending order, so that is the lex k-best (as K2).
//
// Bound on this card: operations. Every scanned pair costs one distance
// (about 3d + 3 FP32 operations and a sqrt), twice for column tiles that
// merge; device-memory traffic is one read of each window's columns per
// row tile (L2-resident at these widths) plus the (rows, k) output.
//
// Wide mode (k or d past 128, both contracts): the same two passes over
// sub-tiles of WIDE_COLS columns whose distances go through distance.cuh's
// chunked feature loop, the k-list in the slot's output row (lexlist.cuh's
// lex_insert_mem) with the same admission, so the lists are the same.
#include <cstdint>

#include "distance.cuh"
#include "lexlist.cuh"

#define WINDOW_MAX_THREADS 512

template <int DMAX, int KB>
__global__ void __launch_bounds__(WINDOW_MAX_THREADS)
knn_window_kernel(const float* __restrict__ x, int n, int d,
                  const int32_t* __restrict__ ids,
                  const int32_t* __restrict__ wstart,
                  const float* __restrict__ bnd, int k, int metric,
                  int col_tile, int n_win_tiles, int sub,
                  float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* xs = smem;          // sub * d features
  float* ns = xs + sub * d;  // sub norms (dot form)

  const int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row = ids[slot];
  float xr[DMAX];
#pragma unroll
  for (int f = 0; f < DMAX; ++f) xr[f] = f < d ? x[row * d + f] : 0.0f;
  const float xr_sq = sq_norm<DMAX>(xr, d);
  const float bound = bnd[slot];

  float bd[KB];
  int32_t bi[KB];
#pragma unroll
  for (int s = 0; s < KB; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = -1;
  }
  float worst = CUDART_INF_F;  // bd[k - 1]

  const int64_t win0 = (int64_t)wstart[blockIdx.x] * col_tile;
  for (int j = 0; j < n_win_tiles; ++j) {
    const int64_t base = win0 + (int64_t)j * col_tile;
    const int64_t stop = min(base + col_tile, (int64_t)n);  // masked past n
    // Pass 1: does any row of the tile hold a candidate?
    const float thr = fminf(worst, bound);
    bool any = false;
    for (int64_t c0 = base; c0 < stop && !any; c0 += sub) {
      const int len = (int)min((int64_t)sub, stop - c0);
      for (int t = threadIdx.x; t < len * d; t += blockDim.x) xs[t] = x[c0 * d + t];
      __syncthreads();
      if (metric == METRIC_EUCLID_DOT) {
        for (int t = threadIdx.x; t < len; t += blockDim.x) ns[t] = sq_norm<DMAX>(xs + t * d, d);
        __syncthreads();
      }
      bool mine = false;
      for (int t = 0; t < len && !mine; ++t) {
        mine = pair_distance<DMAX>(xr, xr_sq, xs + t * d, ns[t], d, metric) < thr;
      }
      any = __syncthreads_or(mine);
    }
    if (!any) continue;
    // Pass 2: every row merges the whole column tile.
    for (int64_t c0 = base; c0 < stop; c0 += sub) {
      const int len = (int)min((int64_t)sub, stop - c0);
      for (int t = threadIdx.x; t < len * d; t += blockDim.x) xs[t] = x[c0 * d + t];
      __syncthreads();
      if (metric == METRIC_EUCLID_DOT) {
        for (int t = threadIdx.x; t < len; t += blockDim.x) ns[t] = sq_norm<DMAX>(xs + t * d, d);
        __syncthreads();
      }
      for (int t = 0; t < len; ++t) {
        const float dist = pair_distance<DMAX>(xr, xr_sq, xs + t * d, ns[t], d, metric);
        if (!(dist < worst)) continue;
        const int32_t id = (int32_t)(c0 + t);
        // Insert after every entry <= dist; slots at or past k are ignored.
#pragma unroll
        for (int s = KB - 1; s >= 0; --s) {
          if (s < k) {
            const float prev = s > 0 ? bd[s > 0 ? s - 1 : 0] : -CUDART_INF_F;
            if (prev > dist) {
              bd[s] = prev;
              bi[s] = bi[s > 0 ? s - 1 : 0];
            } else if (dist < bd[s]) {
              bd[s] = dist;
              bi[s] = id;
            }
            if (s == k - 1) worst = bd[s];
          }
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int s = 0; s < KB; ++s) {
    if (s < k) {
      out_d[slot * k + s] = bd[s];
      out_i[slot * k + s] = bi[s];
    }
  }
}

__global__ void __launch_bounds__(WINDOW_MAX_THREADS)
knn_window_wide_kernel(const float* __restrict__ x, int n, int d,
                       const int32_t* __restrict__ ids,
                       const int32_t* __restrict__ wstart,
                       const float* __restrict__ bnd, int k, int metric,
                       int col_tile, int n_win_tiles, float* __restrict__ out_d,
                       int32_t* __restrict__ out_i) {
  extern __shared__ float smem[];  // wide_smem_floats(blockDim.x)
  const int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float* row = x + (int64_t)ids[slot] * d;
  const float row_sq = dot_form(metric) ? sq_norm_ptr(row, d) : 0.0f;
  const float bound = bnd[slot];
  float* bd = out_d + slot * k;
  int32_t* bi = out_i + slot * k;
  for (int s = 0; s < k; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = -1;
  }
  float worst = CUDART_INF_F;  // bd[k - 1]
  const auto col = [=](int64_t c0) {
    return [=](int t) { return x + (c0 + t) * d; };
  };
  const int64_t win0 = (int64_t)wstart[blockIdx.x] * col_tile;
  for (int j = 0; j < n_win_tiles; ++j) {
    const int64_t base = win0 + (int64_t)j * col_tile;
    const int64_t stop = min(base + col_tile, (int64_t)n);  // masked past n
    // Pass 1: does any row of the tile hold a candidate?
    const float thr = fminf(worst, bound);
    bool any = false;
    for (int64_t c0 = base; c0 < stop && !any; c0 += WIDE_COLS) {
      const int len = (int)min((int64_t)WIDE_COLS, stop - c0);
      float dist[WIDE_COLS];
      wide_distances(row, row_sq, col(c0), len, d, metric, smem, dist);
      bool mine = false;
#pragma unroll
      for (int t = 0; t < WIDE_COLS; ++t) mine |= t < len && dist[t] < thr;
      any = __syncthreads_or(mine);
    }
    if (!any) continue;
    // Pass 2: every row merges the whole column tile.
    for (int64_t c0 = base; c0 < stop; c0 += WIDE_COLS) {
      const int len = (int)min((int64_t)WIDE_COLS, stop - c0);
      float dist[WIDE_COLS];
      wide_distances(row, row_sq, col(c0), len, d, metric, smem, dist);
#pragma unroll
      for (int t = 0; t < WIDE_COLS; ++t) {
        if (t < len && dist[t] < worst) {
          lex_insert_mem(bd, bi, k, dist[t], (int32_t)(c0 + t));
          worst = bd[k - 1];
        }
      }
    }
  }
}

template <int DMAX, int KB>
static cudaError_t launch(const float* x, int n, int d, const int32_t* ids,
                          const int32_t* wstart, const float* bnd, int tiles,
                          int row_tile, int k, int metric, int col_tile,
                          int n_win_tiles, float* out_d, int32_t* out_i,
                          cudaStream_t stream) {
  const int sub = column_tile(d, 0);
  const size_t smem = (size_t)sub * (d + 1) * sizeof(float);
  knn_window_kernel<DMAX, KB><<<tiles, row_tile, smem, stream>>>(
      x, n, d, ids, wstart, bnd, k, metric, col_tile, n_win_tiles, sub, out_d, out_i);
  return cudaGetLastError();
}

template <int DMAX>
static cudaError_t launch_k(const float* x, int n, int d, const int32_t* ids,
                            const int32_t* wstart, const float* bnd, int tiles,
                            int row_tile, int k, int metric, int col_tile,
                            int n_win_tiles, float* od, int32_t* oi, cudaStream_t s) {
  if (k <= 16)
    return launch<DMAX, 16>(x, n, d, ids, wstart, bnd, tiles, row_tile, k, metric,
                            col_tile, n_win_tiles, od, oi, s);
  if (k <= 32)
    return launch<DMAX, 32>(x, n, d, ids, wstart, bnd, tiles, row_tile, k, metric,
                            col_tile, n_win_tiles, od, oi, s);
  if (k <= 128)
    return launch<DMAX, 128>(x, n, d, ids, wstart, bnd, tiles, row_tile, k, metric,
                             col_tile, n_win_tiles, od, oi, s);
  return cudaErrorInvalidValue;
}

// x: (>= n, d) float32 block-sorted points; ids (tiles * row_tile) int32 row
// positions in x; wstart (tiles) int32 window origins in column tiles; bnd
// (tiles * row_tile) float32 priming bounds; out (tiles * row_tile, k).
extern "C" int knn_window_launch(const void* x, int n, int d, const void* ids,
                                 const void* wstart, const void* bnd, int tiles,
                                 int row_tile, int k, int metric, int col_tile,
                                 int n_win_tiles, void* out_d, void* out_i,
                                 void* stream) {
  auto* xf = (const float*)x;
  auto* idp = (const int32_t*)ids;
  auto* wsp = (const int32_t*)wstart;
  auto* bp = (const float*)bnd;
  auto* od = (float*)out_d;
  auto* oi = (int32_t*)out_i;
  auto s = (cudaStream_t)stream;
  if (tiles <= 0) return 0;
  if (k < 1 || row_tile < 1 || row_tile > WINDOW_MAX_THREADS || col_tile < 1 ||
      n_win_tiles < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  if (k > 128 || d > 128) {
    knn_window_wide_kernel<<<tiles, row_tile, wide_smem_floats(row_tile) * sizeof(float), s>>>(
        xf, n, d, idp, wsp, bp, k, metric, col_tile, n_win_tiles, od, oi);
    return (int)cudaGetLastError();
  }
  if (d <= 4)
    return launch_k<4>(xf, n, d, idp, wsp, bp, tiles, row_tile, k, metric, col_tile,
                       n_win_tiles, od, oi, s);
  if (d <= 8)
    return launch_k<8>(xf, n, d, idp, wsp, bp, tiles, row_tile, k, metric, col_tile,
                       n_win_tiles, od, oi, s);
  if (d <= 32)
    return launch_k<32>(xf, n, d, idp, wsp, bp, tiles, row_tile, k, metric, col_tile,
                        n_win_tiles, od, oi, s);
  if (d <= 128)
    return launch_k<128>(xf, n, d, idp, wsp, bp, tiles, row_tile, k, metric, col_tile,
                         n_win_tiles, od, oi, s);
  return (int)cudaErrorInvalidValue;
}
