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
// slot, so the block first decides (pass 1, which stops as soon as one row
// of the tile holds a candidate) and only then merges (pass 2, the
// distances recomputed).
//
// Bound on this card: operations. Every scanned pair costs one distance on
// the FP32 pipes (3d operations in the diff form, 2d + 3 in the dot form;
// -fmad=false issues multiplies and adds separately, so the floor is half
// the FMA rate), once in pass 1 up to the first candidate and again in
// pass 2 for a column tile that merges; a root only for an admitted pair.
// Device-memory traffic is one read of each window's columns per row tile
// (L2-resident at these widths) plus the (rows, k) output.
//
// Design: the k-best body of knn_kbest.cu, through the header it shares
// (kbest.cuh: scan_tile, list_insert, admit_bound, stage_tile).
// - One block per row tile, as before: the guard needs all of a tile's
//   rows, so a tile is never split across blocks (splitting the window
//   would reorder the guards). A thread holds R rows (2 at d <= 32, 1
//   above: the rows_per_thread rule of knn_kbest.cu), so a 512-row tile
//   takes 256 threads at d <= 32. The rows' features take DMAX registers
//   each, so d rounds up to 4, 8, 16, 32 or 128: at d = 10 the 32-bucket
//   took 165 registers (one block an SM), the 16-bucket takes 128 (two).
// - Columns are staged in shared memory a sub-tile at a time and read as
//   float4 for a thread's R rows, one feature guard per float4 group
//   (distance.cuh column_values), two columns a step at d <= 32.
// - Lists in shared memory, k slots a row interleaved thread by thread,
//   inserts by bisection moving KB_SHIFT entries at a time (list_insert).
//   Columns arrive in ascending id, so K2's rule (strictly below the k-th,
//   after every equal distance) is the lex k-best as it stands. Where a
//   tile's lists pass WIN_LIST_BYTES (k > 16 at 512 rows) they lie in the
//   slots' own output rows in device memory instead, with the same insert.
// - Pass 1 runs on squared values under admit_bound(min(k-th, bnd)),
//   confirmed by the exact rooted `< thr` before it marks a row; one warp
//   vote a step ends a warp's scan at its first candidate, and a flag in
//   shared memory ends the other warps' within 16 steps. Pass 2 admits as
//   K2 does (squared bound, root, strict test, one vote a step). At a
//   3d-shaped chunk pass 1 is about a third of the time: a full scan of
//   each tile whose guard does not fire (the decision needs every pair),
//   and the leading columns of the others again in pass 2 (PERF.md §6).
//
// Wide mode (k or d past 128, both contracts): the same two passes over
// sub-tiles of WIDE_COLS columns whose distances go through distance.cuh's
// chunked feature loop, the k-list in the slot's output row (lexlist.cuh's
// lex_insert_mem) with the same admission, so the lists are the same.
#include <cstdint>

#include "distance.cuh"
#include "kbest.cuh"
#include "lexlist.cuh"

#define WINDOW_MAX_THREADS 512
// Column sub-tile: at most this many bytes of features and norms a block.
constexpr int WIN_TILE_BYTES = 24 * 1024;
// Shared memory a tile's lists may take; past it they lie in device memory.
constexpr long WIN_LIST_BYTES = 64 * 1024;
// Steps of a pass-1 scan between two reads of the block's flag.
constexpr int WIN_FLAG_STEPS = 16;

// Rows a thread holds: 2 at d <= 32, 1 above.
__host__ __device__ constexpr int window_rows_per_thread(int d) { return d <= 32 ? 2 : 1; }

// Pass 1's bound for a row whose guard threshold is thr (min of its k-th
// and its bnd): every candidate strictly below thr lies below it. A row
// whose threshold is not positive (a padding row: -inf) takes thr itself,
// which no squared value passes.
__device__ __forceinline__ float probe_bound(float thr, bool root) {
  return (root && thr > 0.0f) ? admit_bound(thr, true) : thr;
}

// Pass 1 over one staged sub-tile: whether one of the thread's R rows has a
// column strictly below its threshold thr (squared values under pth first,
// then the exact rooted test). A warp stops at its first candidate and sets
// the block's flag; it also stops when another warp has set it.
template <int DMAX, int R, int CODE>
__device__ __forceinline__ bool probe_tile(const float (&xr)[R][DMAX], const float (&xsq)[R],
                                           const float* xs, const float* ns, int dp, int d,
                                           int len, bool root, const float (&thr)[R],
                                           const float (&pth)[R], volatile int* flag) {
  constexpr int C = cols_per_step(DMAX);
  bool mine = false;
  for (int t0 = 0, step = 1; t0 < len; t0 += C, ++step) {
    const int cols = min(C, len - t0);
    float v[C][R];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      column_values<DMAX, R, CODE>(xr, xsq, xs + (t0 + (c < cols ? c : 0)) * dp,
                                   ns[t0 + (c < cols ? c : 0)], d, v[c]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (c < cols && v[c][r] < pth[r]) mine |= (root ? sqrtf(v[c][r]) : v[c][r]) < thr[r];
      }
    }
    if (__any_sync(0xffffffffu, mine)) {
      if (mine) *flag = 1;
      break;
    }
    if (step % WIN_FLAG_STEPS == 0 && __any_sync(0xffffffffu, *flag != 0)) break;
  }
  return mine;
}

// One block per row tile; a thread holds rows threadIdx.x + r * blockDim.x
// (r < R) of the tile's rt. `code` is 4/5 (squared euclidean; `root` takes
// sqrtf of an admitted candidate for codes 0/1) or 2/3. Lists in shared
// memory unless `mem_lists`, then in the output rows.
template <int DMAX, int R>
__global__ void __launch_bounds__(WINDOW_MAX_THREADS / R)
knn_window_kernel(const float* __restrict__ x, int n, int d,
                  const int32_t* __restrict__ ids,
                  const int32_t* __restrict__ wstart,
                  const float* __restrict__ bnd, int rt, int k, int code, bool root,
                  int col_tile, int n_win_tiles, int tile, bool mem_lists,
                  float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  const int dp = (d + 3) & ~3;
  const int threads = blockDim.x;
  float* xs = reinterpret_cast<float*>(smem4);  // tile x dp features
  float* ns = xs + tile * dp;                    // tile norms (dot form)
  volatile int* flag = reinterpret_cast<int*>(ns + tile);
  float* lists = ns + tile + 4;                  // R x k x threads distances, then ids
  const int64_t slot0 = (int64_t)blockIdx.x * rt;
  float* ld;
  int32_t* li;
  int stride;
  if (mem_lists) {
    ld = out_d + (slot0 + threadIdx.x) * k;
    li = out_i + (slot0 + threadIdx.x) * k;
    stride = 1;
  } else {
    ld = lists + threadIdx.x;
    li = reinterpret_cast<int32_t*>(lists + R * k * threads) + threadIdx.x;
    stride = threads;
  }
  const int row_step = k * threads;

  float xr[R][DMAX];
  float xsq[R], w[R], th[R], bound[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = threadIdx.x + r * threads;
    const bool ok = row < rt;
    const int64_t p = ok ? ids[slot0 + row] : 0;
#pragma unroll
    for (int f = 0; f < DMAX; ++f) xr[r][f] = (ok && f < d) ? x[p * d + f] : 0.0f;
    xsq[r] = sq_norm<DMAX>(xr[r], d);
    w[r] = CUDART_INF_F;
    th[r] = ok ? CUDART_INF_F : -CUDART_INF_F;  // a padding row admits nothing
    bound[r] = ok ? bnd[slot0 + row] : -CUDART_INF_F;
    if (ok) {
      for (int s = 0; s < k; ++s) {
        ld[r * row_step + s * stride] = CUDART_INF_F;
        li[r * row_step + s * stride] = -1;
      }
    }
  }

  const int64_t win0 = (int64_t)wstart[blockIdx.x] * col_tile;
  for (int j = 0; j < n_win_tiles; ++j) {
    const int64_t base = win0 + (int64_t)j * col_tile;
    const int64_t stop = min(base + col_tile, (int64_t)n);  // masked past n
    // Pass 1: does any row of the tile hold a candidate?
    float thr[R], pth[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      thr[r] = fminf(w[r], bound[r]);
      pth[r] = probe_bound(thr[r], root);
    }
    if (threadIdx.x == 0) *flag = 0;
    bool any = false;
    for (int64_t c0 = base; c0 < stop && !any; c0 += tile) {
      const int len = (int)min((int64_t)tile, stop - c0);
      stage_tile(x, c0, len, d, dp, code, xs, ns, threads);
      bool mine;
      switch (code) {  // uniform
        case METRIC_EUCLID_DIFF_SQ:
          mine = probe_tile<DMAX, R, METRIC_EUCLID_DIFF_SQ>(xr, xsq, xs, ns, dp, d, len, root,
                                                            thr, pth, flag);
          break;
        case METRIC_EUCLID_DOT_SQ:
          mine = probe_tile<DMAX, R, METRIC_EUCLID_DOT_SQ>(xr, xsq, xs, ns, dp, d, len, root,
                                                           thr, pth, flag);
          break;
        case METRIC_MANHATTAN:
          mine = probe_tile<DMAX, R, METRIC_MANHATTAN>(xr, xsq, xs, ns, dp, d, len, root, thr,
                                                       pth, flag);
          break;
        default:
          mine = probe_tile<DMAX, R, METRIC_SUPREMUM>(xr, xsq, xs, ns, dp, d, len, root, thr,
                                                      pth, flag);
          break;
      }
      any = __syncthreads_or(mine);
    }
    if (!any) continue;
    // Pass 2: every row merges the whole column tile.
    for (int64_t c0 = base; c0 < stop; c0 += tile) {
      const int len = (int)min((int64_t)tile, stop - c0);
      stage_tile(x, c0, len, d, dp, code, xs, ns, threads);
      const int32_t id0 = (int32_t)c0;
      switch (code) {
        case METRIC_EUCLID_DIFF_SQ:
          scan_tile<DMAX, R, METRIC_EUCLID_DIFF_SQ, true>(xr, xsq, xs, ns, dp, d, len, id0,
                                                          root, k, ld, li, stride, row_step,
                                                          w, th);
          break;
        case METRIC_EUCLID_DOT_SQ:
          scan_tile<DMAX, R, METRIC_EUCLID_DOT_SQ, true>(xr, xsq, xs, ns, dp, d, len, id0,
                                                         root, k, ld, li, stride, row_step,
                                                         w, th);
          break;
        case METRIC_MANHATTAN:
          scan_tile<DMAX, R, METRIC_MANHATTAN, true>(xr, xsq, xs, ns, dp, d, len, id0, root,
                                                     k, ld, li, stride, row_step, w, th);
          break;
        default:
          scan_tile<DMAX, R, METRIC_SUPREMUM, true>(xr, xsq, xs, ns, dp, d, len, id0, root,
                                                    k, ld, li, stride, row_step, w, th);
          break;
      }
      __syncthreads();
    }
  }
  if (mem_lists) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = threadIdx.x + r * threads;
    if (row >= rt) continue;
    const int64_t o = (slot0 + row) * k;
    for (int s = 0; s < k; ++s) {
      out_d[o + s] = ld[r * row_step + s * stride];
      out_i[o + s] = li[r * row_step + s * stride];
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


// Launch shape of a row tile of rt rows, d features and k slots: rows a
// thread, threads, column sub-tile, list placement, dynamic shared memory.
struct WinPlan {
  int r, threads, tile;
  bool mem_lists;
  size_t smem;
};

static WinPlan win_plan(int rt, int d, int k) {
  WinPlan p;
  p.r = window_rows_per_thread(d);
  p.threads = ((rt + p.r - 1) / p.r + 31) / 32 * 32;
  const int dp = (d + 3) & ~3;
  const int tile = (WIN_TILE_BYTES / 4) / (dp + 1);
  p.tile = tile > 512 ? 512 : (tile / 32) * 32;
  const size_t list_bytes = (size_t)p.r * p.threads * k * 8;
  p.mem_lists = list_bytes > (size_t)WIN_LIST_BYTES;
  p.smem = ((size_t)p.tile * (dp + 1) + 4) * sizeof(float) + (p.mem_lists ? 0 : list_bytes);
  return p;
}

template <int DMAX, int R>
static cudaError_t launch(const float* x, int n, int d, const int32_t* ids,
                          const int32_t* wstart, const float* bnd, int tiles, int rt, int k,
                          int code, bool root, int col_tile, int n_win_tiles, const WinPlan& p,
                          float* od, int32_t* oi, cudaStream_t stream) {
  auto kern = knn_window_kernel<DMAX, R>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  kern<<<tiles, p.threads, p.smem, stream>>>(x, n, d, ids, wstart, bnd, rt, k, code, root,
                                             col_tile, n_win_tiles, p.tile, p.mem_lists, od,
                                             oi);
  return cudaGetLastError();
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
      n_win_tiles < 1 || d < 1 || metric < METRIC_EUCLID_DIFF || metric > METRIC_SUPREMUM)
    return (int)cudaErrorInvalidValue;
  if (k > 128 || d > 128) {
    knn_window_wide_kernel<<<tiles, row_tile, wide_smem_floats(row_tile) * sizeof(float), s>>>(
        xf, n, d, idp, wsp, bp, k, metric, col_tile, n_win_tiles, od, oi);
    return (int)cudaGetLastError();
  }
  // The euclidean codes run on squared distances; roots only for admitted pairs.
  const bool root = metric == METRIC_EUCLID_DIFF || metric == METRIC_EUCLID_DOT;
  const int code = metric == METRIC_EUCLID_DIFF ? METRIC_EUCLID_DIFF_SQ
                   : metric == METRIC_EUCLID_DOT ? METRIC_EUCLID_DOT_SQ
                                                 : metric;
  const WinPlan p = win_plan(row_tile, d, k);
  const int rt = row_tile, nw = n_win_tiles;
  if (d <= 4)
    return (int)launch<4, 2>(xf, n, d, idp, wsp, bp, tiles, rt, k, code, root, col_tile, nw, p,
                             od, oi, s);
  if (d <= 8)
    return (int)launch<8, 2>(xf, n, d, idp, wsp, bp, tiles, rt, k, code, root, col_tile, nw, p,
                             od, oi, s);
  if (d <= 16)
    return (int)launch<16, 2>(xf, n, d, idp, wsp, bp, tiles, rt, k, code, root, col_tile, nw,
                              p, od, oi, s);
  if (d <= 32)
    return (int)launch<32, 2>(xf, n, d, idp, wsp, bp, tiles, rt, k, code, root, col_tile, nw,
                              p, od, oi, s);
  return (int)launch<128, 1>(xf, n, d, idp, wsp, bp, tiles, rt, k, code, root, col_tile, nw, p,
                             od, oi, s);
}
