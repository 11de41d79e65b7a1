// K2 knn_kbest: the k nearest columns of every query row, as (distance, id)
// in lexicographic order (ascending distance, ties to the lower id); and B3
// knn_smallest, the same selection on squared euclidean distances with no
// ids.
//
// Replaces the TPU kernels hdbscan_tpu/ops/pallas_knn.py knn_fused_pallas
// (_fused_knn_kernel, merge in ops/lexmerge.merge_tile_contiguous) and
// knn_smallest_pallas (_knn_kernel), and the XLA scan ops/tiled._knn_core_scan
// that computes the same k-best with the tile-shape-selected distance form.
//
// One body, three entry points:
//   knn_kbest_launch        square: every row of x against every row of x;
//   knn_kbest_panel_launch  rectangular: queries q against a column panel x
//                           whose ids start at id_offset (the ring scan of
//                           parallel/ring.py runs one per visiting panel);
//   knn_smallest_launch     square, metric codes 4/5 (no root), no ids;
// and knn_kbest_merge_launch, the span merge pass on its own: a row's
// lists from launches over ascending column ranges merged into one (the
// wrapper's decomposition where the reference's column tiles hold NaN
// columns; ops/cuda_knn.py).
//
// The rule that fixes every bit: a row's list takes a column only when it
// is strictly closer than the current k-th entry, and places it after every
// entry of equal distance. Over ascending ids that is the (distance, id) lex
// k-best; for B3 it keeps the k smallest values with their multiplicity,
// equal values (+0 and -0) in column order. Slots never filled stay
// (+inf, -1).
//
// Bound on this card: operations. Every query x column pair is evaluated on
// the FP32 pipes (3d operations in the diff form, 2d + 3 in the dot form and
// at cosine, whose division counts as one;
// -fmad=false issues multiplies and adds separately, so the floor is half
// the FMA rate); a row admits about k (1 + ln(columns / k)) of them.
// Device-memory traffic is O(columns d) per block plus the (rows, k) lists.
//
// Design:
// (a) Column splits. The grid's second axis cuts the columns into `splits`
//     contiguous spans where row blocks alone are fewer than
//     KB_TARGET_BLOCKS (spans of at least KB_MIN_SPAN columns). Each span's
//     lists go to scratch the wrapper allocates, and a second pass merges a
//     row's lists in split order with the same rule: split s's entries
//     follow every entry of splits < s, and within a list equal distances
//     are in id (column) order, so the merge is the single pass's list,
//     bit for bit. Sentinels (+inf) never pass the strict test. The target
//     is low (about four blocks an SM) because every span starts with empty
//     lists: a warp takes the insert path on nearly every column until its
//     lists tighten, about 32 k (1 + ln(span / 32 k)) columns a row slot.
// (b) Register micro-tiles. A thread holds R rows' features and admission
//     bounds in registers and reads a column's features as float4 from
//     shared memory once for its R rows (distance.cuh column_values, one
//     feature guard per float4 group, features in ascending order), two
//     columns a step at d <= 32 (one above: at d = 90 two took 27% longer;
//     PERF.md §6). The admission test is a predicate; the insert runs
//     only when a warp vote says some lane admits. R = 2 at d <= 32, 1
//     above, halved while a block's lists would pass KB_LIST_BYTES.
//     What limits the loop is latency, so the design keeps warps resident:
//     the lists (k slots a row, no bucket) lie in shared memory, slot-major
//     and interleaved thread by thread so that a warp's accesses never
//     share a bank. An insert finds its slot by bisection and moves the
//     entries behind it KB_SHIFT at a time, so it waits on about log2(k) +
//     (k - slot) / KB_SHIFT loads in turn: a row admits about
//     k (1 + ln(columns / k)) candidates, and at k = 127 a one-by-one
//     shift made the inserts most of the time (PERF.md §6). Lists in
//     registers do not fit: at R = 2, k = 15 a build with them took 255
//     registers and spilled (PERF.md §6), and R = 4 or 8 with lists in
//     shared memory leaves 1-2 blocks an SM. B3 holds distances only (a
//     compile-time flag).
// (c) A root only for a candidate that can enter. The euclidean codes run on
//     squared distances v: a row's bound is the float after fl(w * w), w
//     its k-th distance, which every v with sqrtf(v) < w lies below
//     (sqrtf is correctly rounded and monotone); a candidate under the
//     bound takes sqrtf and enters iff sqrtf(v) < w, the rooted test
//     itself, so the admitted set is exactly the old one. (segmin.cu's
//     sq_threshold, the exact least such bound, costs two roots an insert;
//     PERF.md §6 times it beside this.) The list keeps roots, so two v with
//     one root still tie by id; the bound moves only after an insert.
//
// The scan and list code (scan_tile, list_insert, admit_bound, stage_tile)
// lives in kbest.cuh, which B4's window kernel (knn_window.cu) shares.
//
// Wide mode (K2 and the rectangular entry only; B3 keeps the reference's
// k, d <= 128): past k = 128 or d = 128 one kernel takes over whose
// distances go through distance.cuh's chunked feature loop and whose k-list
// lives in the row's output (lexlist.cuh's lex_insert_mem), one row a
// thread, with the same admission and insert, so the lists are the same.
#include <cstdint>

#include "distance.cuh"
#include "kbest.cuh"
#include "lexlist.cuh"

constexpr int KB_THREADS = 128;
constexpr int MERGE_THREADS = 64;
constexpr int WIDE_THREADS = 128;
// Launch shape: about this many blocks, columns split no finer than this.
constexpr int KB_TARGET_BLOCKS = 512;
constexpr int KB_MIN_SPAN = 1024;
// Column tile: at most this many bytes of features and norms a block.
constexpr int KB_TILE_BYTES = 24 * 1024;
// Shared memory one block's lists may take: with the tile, about four
// blocks (16 warps) an SM. At 64 KB, K2 at k = 31 kept 2 rows a thread, two
// blocks an SM, and ran 16% slower (PERF.md §6).
constexpr long KB_LIST_BYTES = 32 * 1024;
// Rows a thread holds: 2 at d <= 32, 1 above, halved while the block's
// lists (K2: (distance, id) slots; B3: distances) would pass KB_LIST_BYTES.
__host__ __device__ constexpr int rows_per_thread(int d, int k, bool ids) {
  int r = d <= 32 ? 2 : 1;
  while (r > 1 && (long)r * k * KB_THREADS * (ids ? 8 : 4) > KB_LIST_BYTES) r /= 2;
  return r;
}

// Where slot s of row i of split y goes: the output (row-major (rows, k))
// or, with splits, the scratch ([split][slot][row], coalesced).
struct Out {
  float* d;
  int32_t* i;
  int64_t split_stride;
  int64_t row_stride, slot_stride;
};

// Grid (row blocks, splits); split y scans columns [y * span, (y+1) * span).
// `code` is 4/5 (squared euclidean; `root` takes sqrtf of an admitted
// candidate for codes 0/1), 2/3 or 6 (cosine, ids only).
template <int DMAX, int R, bool IDS>
__global__ void __launch_bounds__(KB_THREADS)
knn_kbest_kernel(const float* __restrict__ q, int nq, const float* __restrict__ x, int nx,
                 int d, int k, int code, bool root, int id_offset, int span, int tile,
                 Out out) {
  extern __shared__ float4 smem4[];
  const int dp = (d + 3) & ~3;
  float* xs = reinterpret_cast<float*>(smem4);  // tile x dp features
  float* ns = xs + tile * dp;                    // tile norms (dot form)
  float* lists = ns + tile;                      // R x k x KB_THREADS distances, then ids
  float* ld = lists + threadIdx.x;
  int32_t* li =
      IDS ? reinterpret_cast<int32_t*>(lists + R * k * KB_THREADS) + threadIdx.x : nullptr;

  const int row0 = blockIdx.x * (KB_THREADS * R) + threadIdx.x;
  float xr[R][DMAX];
  float xsq[R], w[R], th[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r * KB_THREADS;
    const bool ok = i < nq;
#pragma unroll
    for (int f = 0; f < DMAX; ++f) xr[r][f] = (ok && f < d) ? q[(int64_t)i * d + f] : 0.0f;
    xsq[r] = norm_slot(sq_norm<DMAX>(xr[r], d), code);
    w[r] = CUDART_INF_F;
    th[r] = ok ? CUDART_INF_F : -CUDART_INF_F;  // a padding row admits nothing
    for (int s = 0; s < k; ++s) {
      ld[(r * k + s) * KB_THREADS] = CUDART_INF_F;
      if (IDS) li[(r * k + s) * KB_THREADS] = -1;
    }
  }

  const int c_begin = blockIdx.y * span;
  const int c_end = min(nx, c_begin + span);
  for (int c0 = c_begin; c0 < c_end; c0 += tile) {
    const int len = min(tile, c_end - c0);
    stage_tile(x, c0, len, d, dp, code, xs, ns, KB_THREADS);
    const int32_t id0 = id_offset + c0;
    switch (code) {  // uniform: the metric picks the tile loop, not each pair's code
      case METRIC_EUCLID_DIFF_SQ:
        scan_tile<DMAX, R, METRIC_EUCLID_DIFF_SQ, IDS>(xr, xsq, xs, ns, dp, d, len, id0, root,
                                                       k, ld, li, KB_THREADS, k * KB_THREADS, w, th);
        break;
      case METRIC_EUCLID_DOT_SQ:
        scan_tile<DMAX, R, METRIC_EUCLID_DOT_SQ, IDS>(xr, xsq, xs, ns, dp, d, len, id0, root,
                                                      k, ld, li, KB_THREADS, k * KB_THREADS, w, th);
        break;
      case METRIC_COSINE:
        if constexpr (IDS) {  // B3 takes the euclidean codes only
          scan_tile<DMAX, R, METRIC_COSINE, IDS>(xr, xsq, xs, ns, dp, d, len, id0, root, k, ld,
                                                 li, KB_THREADS, k * KB_THREADS, w, th);
        }
        break;
      default:
        if constexpr (IDS) {
          if (code == METRIC_MANHATTAN) {
            scan_tile<DMAX, R, METRIC_MANHATTAN, IDS>(xr, xsq, xs, ns, dp, d, len, id0, root,
                                                      k, ld, li, KB_THREADS, k * KB_THREADS, w, th);
          } else {
            scan_tile<DMAX, R, METRIC_SUPREMUM, IDS>(xr, xsq, xs, ns, dp, d, len, id0, root,
                                                     k, ld, li, KB_THREADS, k * KB_THREADS, w, th);
          }
        }
        break;
    }
    __syncthreads();
  }

  const int64_t base = blockIdx.y * out.split_stride;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r * KB_THREADS;
    if (i >= nq) continue;
    for (int s = 0; s < k; ++s) {
      const int64_t o = base + i * out.row_stride + s * out.slot_stride;
      out.d[o] = ld[(r * k + s) * KB_THREADS];
      if (IDS) out.i[o] = li[(r * k + s) * KB_THREADS];
    }
  }
}

// A row's split lists (scratch [split][slot][row]) merged in split order
// with the list rule into its output row; the list lives in shared memory,
// interleaved thread by thread.
template <bool IDS>
__global__ void __launch_bounds__(MERGE_THREADS)
knn_kbest_merge_kernel(const float* __restrict__ pd, const int32_t* __restrict__ pi,
                       int splits, int nq, int k, float* __restrict__ out_d,
                       int32_t* __restrict__ out_i) {
  extern __shared__ float msm[];  // MERGE_THREADS x k distances, then ids
  float* ld = msm + threadIdx.x;
  int32_t* li =
      IDS ? reinterpret_cast<int32_t*>(msm + k * MERGE_THREADS) + threadIdx.x : nullptr;
  const int i = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (i >= nq) return;
  const int64_t slot = nq, split = (int64_t)k * nq;
  for (int s = 0; s < k; ++s) {
    ld[s * MERGE_THREADS] = pd[i + s * slot];
    if (IDS) li[s * MERGE_THREADS] = pi[i + s * slot];
  }
  float worst = ld[(k - 1) * MERGE_THREADS];
  for (int y = 1; y < splits; ++y) {
    for (int s = 0; s < k; ++s) {
      const int64_t o = y * split + s * slot + i;
      const float dist = pd[o];
      if (!(dist < worst)) break;  // a split's list ascends: no later entry enters
      list_insert<IDS>(ld, li, MERGE_THREADS, k, dist, IDS ? pi[o] : 0);
      worst = ld[(k - 1) * MERGE_THREADS];
    }
  }
  for (int s = 0; s < k; ++s) {
    out_d[(int64_t)i * k + s] = ld[s * MERGE_THREADS];
    if (IDS) out_i[(int64_t)i * k + s] = li[s * MERGE_THREADS];
  }
}

__global__ void __launch_bounds__(WIDE_THREADS)
knn_kbest_wide_kernel(const float* __restrict__ q, int nq, const float* __restrict__ x,
                      int nx, int d, int k, int metric, int id_offset,
                      float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  extern __shared__ float smem[];  // wide_smem_floats(blockDim.x)
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool row_ok = i < nq;
  const float* row = row_ok ? q + (int64_t)i * d : nullptr;
  const float row_sq =
      (row_ok && uses_norms(metric)) ? norm_slot(sq_norm_ptr(row, d), metric) : 0.0f;
  float* bd = out_d + (int64_t)(row_ok ? i : 0) * k;
  int32_t* bi = out_i + (int64_t)(row_ok ? i : 0) * k;
  if (row_ok) {
    for (int s = 0; s < k; ++s) {
      bd[s] = CUDART_INF_F;
      bi[s] = -1;
    }
  }
  float worst = CUDART_INF_F;  // bd[k - 1]
  for (int c0 = 0; c0 < nx; c0 += WIDE_COLS) {
    const int len = min(WIDE_COLS, nx - c0);
    float dist[WIDE_COLS];
    wide_distances(row, row_sq, [=](int t) { return x + (int64_t)(c0 + t) * d; }, len, d,
                   metric, smem, dist);
    if (!row_ok) continue;
#pragma unroll
    for (int t = 0; t < WIDE_COLS; ++t) {
      if (t < len && dist[t] < worst) {
        lex_insert_mem(bd, bi, k, dist[t], id_offset + c0 + t);
        worst = bd[k - 1];
      }
    }
  }
}


// Launch shape: rows a thread, row blocks, splits, column span, tile, and
// the block's dynamic shared memory.
struct Plan {
  int rb, blocks, splits, span, tile;
  size_t smem;
};

static Plan plan(int nq, int nx, int d, int k, bool ids) {
  Plan p;
  p.rb = rows_per_thread(d, k, ids);
  const int rows = KB_THREADS * p.rb;
  p.blocks = max(1, (nq + rows - 1) / rows);
  int splits = (KB_TARGET_BLOCKS + p.blocks - 1) / p.blocks;
  splits = min(splits, max(1, nx / KB_MIN_SPAN));
  p.splits = max(1, splits);
  p.span = (nx + p.splits - 1) / p.splits;
  const int dp = (d + 3) & ~3;
  const int tile = (KB_TILE_BYTES / 4) / (dp + 1);
  p.tile = tile > 512 ? 512 : (tile / 32) * 32;
  p.smem = ((size_t)p.tile * (dp + 1) + (size_t)p.rb * k * KB_THREADS * (ids ? 2 : 1)) *
           sizeof(float);
  return p;
}

template <int DMAX, int R, bool IDS>
static cudaError_t launch(const float* q, int nq, const float* x, int nx, int d, int k,
                          int code, bool root, int id_offset, const Plan& p, const Out& out,
                          cudaStream_t stream) {
  auto kern = knn_kbest_kernel<DMAX, R, IDS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(p.blocks, p.splits), KB_THREADS, p.smem, stream>>>(
      q, nq, x, nx, d, k, code, root, id_offset, p.span, p.tile, out);
  return cudaGetLastError();
}

template <int DMAX, bool IDS>
static cudaError_t launch_r(const float* q, int nq, const float* x, int nx, int d, int k,
                            int code, bool root, int off, const Plan& p, const Out& out,
                            cudaStream_t s) {
  if constexpr (DMAX <= 32) {
    if (p.rb == 2) return launch<DMAX, 2, IDS>(q, nq, x, nx, d, k, code, root, off, p, out, s);
  }
  if (p.rb == 1) return launch<DMAX, 1, IDS>(q, nq, x, nx, d, k, code, root, off, p, out, s);
  return cudaErrorInvalidValue;
}

template <bool IDS>
static cudaError_t launch_d(const float* q, int nq, const float* x, int nx, int d, int k,
                            int code, bool root, int off, const Plan& p, const Out& out,
                            cudaStream_t s) {
  if (d <= 4) return launch_r<4, IDS>(q, nq, x, nx, d, k, code, root, off, p, out, s);
  if (d <= 8) return launch_r<8, IDS>(q, nq, x, nx, d, k, code, root, off, p, out, s);
  if (d <= 32) return launch_r<32, IDS>(q, nq, x, nx, d, k, code, root, off, p, out, s);
  return launch_r<128, IDS>(q, nq, x, nx, d, k, code, root, off, p, out, s);
}

template <bool IDS>
static cudaError_t merge(const float* pd, const int32_t* pi, int splits, int nq, int k,
                         float* od, int32_t* oi, cudaStream_t s) {
  auto kern = knn_kbest_merge_kernel<IDS>;
  const size_t smem = (size_t)MERGE_THREADS * k * (IDS ? 2 : 1) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(nq + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS, smem, s>>>(pd, pi, splits,
                                                                            nq, k, od, oi);
  return cudaGetLastError();
}

static bool wide(int d, int k) { return k > 128 || d > 128; }

static int dispatch(const void* q, int nq, const void* x, int nx, int d, int k, int metric,
                    int id_offset, int splits, void* scratch_d, void* scratch_i, void* out_d,
                    void* out_i, void* stream) {
  auto* qf = (const float*)q;
  auto* xf = (const float*)x;
  auto* od = (float*)out_d;
  auto* oi = (int32_t*)out_i;
  auto s = (cudaStream_t)stream;
  if (nq <= 0) return 0;
  const bool ids = oi != nullptr;
  if (k < 1 || nx < 0 || d < 1 || metric < METRIC_EUCLID_DIFF ||
      metric > (ids ? METRIC_COSINE : METRIC_EUCLID_DOT_SQ)) {
    return (int)cudaErrorInvalidValue;
  }
  if (wide(d, k)) {
    if (!ids || splits != 1) return (int)cudaErrorInvalidValue;  // B3 has no wide mode
    const int blocks = (nq + WIDE_THREADS - 1) / WIDE_THREADS;
    const size_t smem = wide_smem_floats(WIDE_THREADS) * sizeof(float);
    knn_kbest_wide_kernel<<<blocks, WIDE_THREADS, smem, s>>>(qf, nq, xf, nx, d, k, metric,
                                                             id_offset, od, oi);
    return (int)cudaGetLastError();
  }
  const Plan p = plan(nq, nx, d, k, ids);
  if (splits != p.splits ||
      (p.splits > 1 && (scratch_d == nullptr || (ids && scratch_i == nullptr)))) {
    return (int)cudaErrorInvalidValue;
  }
  // The euclidean codes run on squared distances; roots only for admitted pairs.
  const bool root = metric == METRIC_EUCLID_DIFF || metric == METRIC_EUCLID_DOT;
  const int code = metric == METRIC_EUCLID_DIFF ? METRIC_EUCLID_DIFF_SQ
                   : metric == METRIC_EUCLID_DOT ? METRIC_EUCLID_DOT_SQ
                                                 : metric;
  auto* sd = (float*)scratch_d;
  auto* si = (int32_t*)scratch_i;
  const Out out = p.splits > 1 ? Out{sd, si, (int64_t)k * nq, 1, nq} : Out{od, oi, 0, k, 1};
  cudaError_t err = ids ? launch_d<true>(qf, nq, xf, nx, d, k, code, root, id_offset, p, out, s)
                        : launch_d<false>(qf, nq, xf, nx, d, k, code, root, id_offset, p, out, s);
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  err = ids ? merge<true>(sd, si, p.splits, nq, k, od, oi, s)
            : merge<false>(sd, si, p.splits, nq, k, od, oi, s);
  return (int)err;
}

// Column splits a launch of nq query rows, nx columns, d features and k
// slots takes (ids: K2 and B2; else B3): the wrapper allocates splits x nq
// x k scratch slots when it is above 1.
extern "C" int knn_kbest_splits(int nq, int nx, int d, int k, int ids) {
  if (nq <= 0 || k < 1 || d < 1 || wide(d, k)) return 1;
  return plan(nq, nx, d, k, ids != 0).splits;
}

// Row blocks of such a launch (the wide mode's: WIDE_THREADS rows a block),
// for reports of the grid's size.
extern "C" int knn_kbest_row_blocks(int nq, int nx, int d, int k, int ids) {
  if (nq <= 0) return 0;
  if (k < 1 || d < 1 || wide(d, k)) return (nq + WIDE_THREADS - 1) / WIDE_THREADS;
  return plan(nq, nx, d, k, ids != 0).blocks;
}

extern "C" int knn_kbest_launch(const void* x, int n, int d, int k, int metric, int splits,
                                void* scratch_d, void* scratch_i, void* out_d, void* out_i,
                                void* stream) {
  return dispatch(x, n, x, n, d, k, metric, 0, splits, scratch_d, scratch_i, out_d, out_i,
                  stream);
}

extern "C" int knn_kbest_panel_launch(const void* q, int nq, const void* x, int nx, int d,
                                      int k, int metric, int id_offset, int splits,
                                      void* scratch_d, void* scratch_i, void* out_d,
                                      void* out_i, void* stream) {
  return dispatch(q, nq, x, nx, d, k, metric, id_offset, splits, scratch_d, scratch_i, out_d,
                  out_i, stream);
}

// Lists of nq rows from `splits` launches over ascending column ranges
// (pd/pi [split][slot][row], k slots each, ascending, (+inf, -1) padded)
// merged row by row into (nq, k) output rows, with the list rule: the
// lex k-best of their union.
extern "C" int knn_kbest_merge_launch(const void* pd, const void* pi, int splits, int nq,
                                      int k, void* out_d, void* out_i, void* stream) {
  if (nq <= 0) return 0;
  if (k < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  return (int)merge<true>((const float*)pd, (const int32_t*)pi, splits, nq, k,
                          (float*)out_d, (int32_t*)out_i, (cudaStream_t)stream);
}

extern "C" int knn_smallest_launch(const void* x, int n, int d, int k, int metric, int splits,
                                   void* scratch_d, void* out_d, void* stream) {
  if (metric != METRIC_EUCLID_DIFF_SQ && metric != METRIC_EUCLID_DOT_SQ) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch(x, n, x, n, d, k, metric, 0, splits, scratch_d, nullptr, out_d, nullptr,
                  stream);
}
