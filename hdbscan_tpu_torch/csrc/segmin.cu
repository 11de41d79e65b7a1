// K1 segmin and B9 segmin_panel: per-row minimum outgoing
// mutual-reachability edge of one Borůvka round.
//
// Replaces the TPU kernels hdbscan_tpu/ops/pallas_segmin.py
// min_outgoing_pallas (_segmin_kernel, square launch) and min_outgoing_panel
// (the same _segmin_kernel launched on a rectangle). For every row i of the
// row set:
//   best_w[i] = min over valid columns j with comp_c[j] != comp_r[i] of
//               max(dist(i, j), core_r[i], core_c[j]),
//   best_j[i] = the lowest such column index j reaching the minimum,
// and (+inf, -1) where no such j exists or row i is not valid. Rows and
// columns carry separate point, core, label and validity arrays; the square
// launch passes the same arrays twice, the panel launch (the per-shard step
// of parallel/shard.shard_boruvka_mst) a resident row shard and a visiting
// column panel, and then best_j is local to the panel.
//
// Bound on this card: operations. A round evaluates every row x column
// pair (3d float operations for the diff form, 2d + 3 for the dot form);
// device-memory traffic is O(columns d) per block and stays in L2.
//
// Design (one body for both launches):
// (a) Column splits. The grid's second axis cuts the columns into `splits`
//     contiguous spans, so a 65,536-row panel fills the card as a
//     245,057-row square does. Each (row block, span) block keeps each row's
//     first minimum over its span with a strict `<` in ascending j and
//     writes a partial (w, j); a second small pass combines a row's
//     partials in ascending span order with the same strict `<`. That is
//     the sequential scan's result, value bits included (a zero weight
//     keeps the bits of the first column reaching it, as torch.min does).
// (b) Register micro-tiles. A thread holds RB rows in registers (RB = 8 at
//     d <= 8, 2 at d <= 32, 1 at d <= 128), so one shared-memory read of a
//     column's features (float4 loads) and of its (core, label, norm)
//     serves RB rows. The label and core tests are predicates; a warp
//     skips a column when none of its rows can take it, and enters the
//     update only when one does (__any_sync), so the common path has no
//     divergent branch.
// (c) The root only where a pair can win. A pair is out when its core
//     bound max(core_r, core_c) >= bw. Otherwise it wins iff
//     sqrtf(d2) < bw, i.e. d2 < T(bw), T the least float whose sqrtf is
//     >= bw (sqrtf is correctly rounded and monotone; T is found by
//     stepping from bw*bw, once per new bw). Only a winner takes
//     w = fmaxf(sqrtf(d2), m), the old arithmetic, so its bits are
//     unchanged. Manhattan and supremum have no root: T = bw.
// Invalid columns (rows) carry core +inf, so their core bound never beats
// bw: no separate validity test. Past d = 128 the body runs its wide mode:
// one row a thread, distances through distance.cuh's chunked feature loop.
#include <cstdint>

#include "distance.cuh"

constexpr int SEG_THREADS = 128;
// Launch shape: about this many blocks, columns split no finer than this.
constexpr int SEG_TARGET_BLOCKS = 2048;
constexpr int SEG_MIN_SPAN = 1024;
// Wide mode: the (core, label) pairs after the chunked loop's floats, 8-byte aligned.
constexpr int SEG_WIDE_META = (wide_smem_floats(SEG_THREADS) + 1) & ~1;

// Rows a thread holds in registers at feature count d (0: the wide mode).
static int rows_per_thread(int d) {
  if (d <= 8) return 8;
  if (d <= 32) return 2;
  return 1;
}

// The least float T with sqrtf(T) >= bw (bw >= 0): sqrtf(d2) < bw iff d2 < T.
__device__ __forceinline__ float sq_threshold(float bw) {
  if (!(bw < CUDART_INF_F)) return CUDART_INF_F;
  float t = bw * bw;
  while (sqrtf(t) < bw) t = nextafterf(t, CUDART_INF_F);
  while (t > 0.0f) {
    const float p = nextafterf(t, 0.0f);
    if (sqrtf(p) < bw) break;
    t = p;
  }
  return t;
}

// One row's running minimum over its span (start: (+inf, +inf, -1)).
struct RowBest {
  float bw;   // best weight
  float th;   // the value a pair's v must stay below to win
  int32_t bj;
};

__device__ __forceinline__ RowBest row_start() { return {CUDART_INF_F, CUDART_INF_F, -1}; }

// Row b takes column j: value v (squared for the euclidean codes), core
// bound m; the caller has checked that it wins.
__device__ __forceinline__ void take(RowBest& b, float v, float m, int32_t j, bool root) {
  b.bw = fmaxf(root ? sqrtf(v) : v, m);
  b.bj = j;
  b.th = root ? sq_threshold(b.bw) : b.bw;
}

// Column j with value v, core bound m and label kc against a row with label
// kr (the wide mode's per-pair form of the test scan_columns splits up).
__device__ __forceinline__ void consider(RowBest& b, float v, float m, int32_t kc,
                                         int32_t kr, int32_t j, bool root) {
  if ((kc != kr) & (m < b.bw) & (v < b.th)) take(b, v, m, j, root);
}

// One tile's columns (features xs at stride dp, (core, label, norm) in meta)
// against a thread's RB rows. The tests are predicates and each of the two
// branches is taken or skipped by the whole warp (__any_sync): a column no
// row of the warp can take costs its core and label tests only, and a row's
// update (the rare winner) is the only divergent code.
template <int DMAX, int RB, int CODE>
__device__ __forceinline__ void scan_columns(const float (&xr)[RB][DMAX],
                                             const float (&xsq)[RB], const float (&cr)[RB],
                                             const int32_t (&kr)[RB], const float* xs,
                                             const float4* meta, int dp, int d, int c0,
                                             int len, RowBest (&best)[RB]) {
  constexpr bool root = CODE == METRIC_EUCLID_DIFF_SQ || CODE == METRIC_EUCLID_DOT_SQ;
  for (int t = 0; t < len; ++t) {
    const float4 mt = meta[t];
    const int32_t kc = __float_as_int(mt.y);
    bool ok[RB];
    bool want = false;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      ok[r] = (kc != kr[r]) & (fmaxf(cr[r], mt.x) < best[r].bw);
      want |= ok[r];
    }
    if (!__any_sync(0xffffffffu, want)) continue;
    float v[RB];
    column_values<DMAX, RB, CODE>(xr, xsq, xs + t * dp, mt.z, d, v);
    bool hit = false;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      ok[r] &= v[r] < best[r].th;
      hit |= ok[r];
    }
    if (__any_sync(0xffffffffu, hit)) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (ok[r]) take(best[r], v[r], fmaxf(cr[r], mt.x), c0 + t, root);
      }
    }
  }
}

struct Side {  // one side's arrays: points, core, label, validity
  const float* x;
  const float* core;
  const int32_t* comp;
  const uint8_t* valid;
  int n;
};

// Register mode (d <= DMAX <= 128): columns in tiles of `tile` through
// shared memory, features at a float4-aligned stride, then (core, label,
// norm) per column.
template <int DMAX, int RB>
__device__ __forceinline__ void scan_registers(const Side& rs, const Side& cs, int d,
                                               int code, int c_begin, int c_end,
                                               int tile, RowBest (&best)[RB]) {
  extern __shared__ float4 smem4[];
  const int dp = (d + 3) & ~3;
  float* xs = reinterpret_cast<float*>(smem4);  // tile x dp features
  float4* meta = smem4 + tile * dp / 4;          // (core, label, norm, -)
  const bool dot = code == METRIC_EUCLID_DOT_SQ;

  const int row0 = blockIdx.x * (SEG_THREADS * RB) + threadIdx.x;
  float xr[RB][DMAX];
  float xsq[RB], cr[RB];
  int32_t kr[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int i = row0 + r * SEG_THREADS;
    const bool ok = i < rs.n && rs.valid[i] != 0;
#pragma unroll
    for (int f = 0; f < DMAX; ++f) xr[r][f] = (ok && f < d) ? rs.x[(int64_t)i * d + f] : 0.0f;
    xsq[r] = sq_norm<DMAX>(xr[r], d);
    cr[r] = ok ? rs.core[i] : CUDART_INF_F;  // an invalid row never takes a column
    kr[r] = ok ? rs.comp[i] : 0;
  }

  for (int c0 = c_begin; c0 < c_end; c0 += tile) {
    const int len = min(tile, c_end - c0);
    for (int e = threadIdx.x; e < len * d; e += blockDim.x) {
      const int t = e / d;
      xs[t * dp + (e - t * d)] = cs.x[(int64_t)c0 * d + e];
    }
    for (int t = threadIdx.x; t < len; t += blockDim.x) {
      const int j = c0 + t;
      const float cc = cs.valid[j] != 0 ? cs.core[j] : CUDART_INF_F;
      meta[t] = make_float4(cc, __int_as_float(cs.comp[j]), 0.0f, 0.0f);
    }
    __syncthreads();
    if (dot) {
      for (int t = threadIdx.x; t < len; t += blockDim.x) {
        const float* xc = xs + t * dp;
        float acc = xc[0] * xc[0];
        for (int f = 1; f < d; ++f) acc = acc + xc[f] * xc[f];
        meta[t].z = acc;
      }
      __syncthreads();
    }
    switch (code) {  // uniform: the metric picks the tile loop, not each pair's code
      case METRIC_EUCLID_DIFF_SQ:
        scan_columns<DMAX, RB, METRIC_EUCLID_DIFF_SQ>(xr, xsq, cr, kr, xs, meta, dp, d, c0,
                                                      len, best);
        break;
      case METRIC_EUCLID_DOT_SQ:
        scan_columns<DMAX, RB, METRIC_EUCLID_DOT_SQ>(xr, xsq, cr, kr, xs, meta, dp, d, c0,
                                                     len, best);
        break;
      case METRIC_MANHATTAN:
        scan_columns<DMAX, RB, METRIC_MANHATTAN>(xr, xsq, cr, kr, xs, meta, dp, d, c0, len,
                                                 best);
        break;
      default:
        scan_columns<DMAX, RB, METRIC_SUPREMUM>(xr, xsq, cr, kr, xs, meta, dp, d, c0, len,
                                                best);
        break;
    }
    __syncthreads();
  }
}

// Wide mode (d > 128): one row a thread, sub-tiles of WIDE_COLS columns
// through the chunked feature loop.
__device__ __forceinline__ void scan_wide(const Side& rs, const Side& cs, int d, int code,
                                          int c_begin, int c_end, RowBest& best) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // wide_smem_floats(SEG_THREADS)
  float2* meta = reinterpret_cast<float2*>(ws + SEG_WIDE_META);  // (core, label)
  const bool root = code == METRIC_EUCLID_DIFF_SQ || code == METRIC_EUCLID_DOT_SQ;
  const int i = blockIdx.x * SEG_THREADS + threadIdx.x;
  const bool ok = i < rs.n && rs.valid[i] != 0;
  const float* row = ok ? rs.x + (int64_t)i * d : nullptr;
  const float xsq = (ok && dot_form(code)) ? sq_norm_ptr(row, d) : 0.0f;
  const float cr = ok ? rs.core[i] : CUDART_INF_F;
  const int32_t kr = ok ? rs.comp[i] : 0;
  for (int c0 = c_begin; c0 < c_end; c0 += WIDE_COLS) {
    const int len = min(WIDE_COLS, c_end - c0);
    __syncthreads();  // the previous sub-tile's labels are read
    for (int t = threadIdx.x; t < len; t += blockDim.x) {
      const int j = c0 + t;
      meta[t] = make_float2(cs.valid[j] != 0 ? cs.core[j] : CUDART_INF_F,
                            __int_as_float(cs.comp[j]));
    }
    float v[WIDE_COLS];
    const float* xc = cs.x;
    wide_distances(row, xsq, [=](int t) { return xc + (int64_t)(c0 + t) * d; }, len, d,
                   code, ws, v);
#pragma unroll
    for (int t = 0; t < WIDE_COLS; ++t) {
      if (t < len) {
        const float2 mt = meta[t];
        consider(best, v[t], fmaxf(cr, mt.x), __float_as_int(mt.y), kr, c0 + t, root);
      }
    }
  }
}

// Grid (row blocks, splits); split s scans columns [s * span, (s+1) * span)
// and writes its partials at part_w/part_j[s * nr + i].
template <int DMAX, int RB>
__global__ void __launch_bounds__(SEG_THREADS)
segmin_kernel(Side rs, Side cs, int d, int code, int span, int tile,
              float* __restrict__ part_w, int32_t* __restrict__ part_j) {
  const int c_begin = blockIdx.y * span;
  const int c_end = min(cs.n, c_begin + span);
  const int64_t out = (int64_t)blockIdx.y * rs.n;
  if constexpr (DMAX > 0) {
    RowBest best[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) best[r] = row_start();
    scan_registers<DMAX, RB>(rs, cs, d, code, c_begin, c_end, tile, best);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int i = blockIdx.x * (SEG_THREADS * RB) + r * SEG_THREADS + threadIdx.x;
      if (i < rs.n) {
        part_w[out + i] = best[r].bw;
        part_j[out + i] = best[r].bj;
      }
    }
  } else {
    RowBest best = row_start();
    scan_wide(rs, cs, d, code, c_begin, c_end, best);
    const int i = blockIdx.x * SEG_THREADS + threadIdx.x;
    if (i < rs.n) {
      part_w[out + i] = best.bw;
      part_j[out + i] = best.bj;
    }
  }
}

// A row's partials in ascending span order, strict `<`: the first minimum.
__global__ void segmin_combine_kernel(const float* __restrict__ part_w,
                                      const int32_t* __restrict__ part_j, int splits,
                                      int nr, float* __restrict__ best_w,
                                      int32_t* __restrict__ best_j) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nr) return;
  float bw = CUDART_INF_F;
  int32_t bj = -1;
  for (int s = 0; s < splits; ++s) {
    const float w = part_w[(int64_t)s * nr + i];
    if (w < bw) {
      bw = w;
      bj = part_j[(int64_t)s * nr + i];
    }
  }
  best_w[i] = bw;
  best_j[i] = bj;
}

// Launch shape: row blocks, splits, column span.
struct Plan {
  int rb, blocks, splits, span;
};

static Plan plan(int nr, int nc, int d) {
  Plan p;
  p.rb = rows_per_thread(d);
  const int rows = SEG_THREADS * p.rb;
  p.blocks = (nr + rows - 1) / rows;
  int splits = (SEG_TARGET_BLOCKS + p.blocks - 1) / p.blocks;
  splits = min(splits, max(1, nc / SEG_MIN_SPAN));
  p.splits = max(1, splits);
  p.span = (nc + p.splits - 1) / p.splits;
  return p;
}

template <int DMAX, int RB>
static cudaError_t launch(const Side& rs, const Side& cs, int d, int code, const Plan& p,
                          float* pw, int32_t* pj, cudaStream_t stream) {
  int tile = 0;
  size_t smem;
  if (DMAX > 0) {
    const int dp = (d + 3) & ~3;
    tile = (48 * 1024 / 4) / (dp + 4);
    tile = tile > 512 ? 512 : (tile / 32) * 32;
    smem = (size_t)tile * (dp + 4) * sizeof(float);
  } else {
    smem = (SEG_WIDE_META + 2 * WIDE_COLS) * sizeof(float);
  }
  const dim3 grid(p.blocks, p.splits);
  segmin_kernel<DMAX, RB><<<grid, SEG_THREADS, smem, stream>>>(rs, cs, d, code, p.span, tile,
                                                                pw, pj);
  return cudaGetLastError();
}

static int dispatch(const Side& rs, const Side& cs, int d, int metric, int splits,
                    void* scratch_w, void* scratch_j, void* best_w, void* best_j,
                    void* stream) {
  auto s = (cudaStream_t)stream;
  if (rs.n <= 0) return 0;
  if (cs.n < 0 || d < 1 || metric < METRIC_EUCLID_DIFF || metric > METRIC_SUPREMUM) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan p = plan(rs.n, cs.n, d);
  if (splits != p.splits || (p.splits > 1 && (scratch_w == nullptr || scratch_j == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  // The euclidean codes run on squared distances; roots only for winners.
  const int code = metric == METRIC_EUCLID_DIFF ? METRIC_EUCLID_DIFF_SQ
                   : metric == METRIC_EUCLID_DOT ? METRIC_EUCLID_DOT_SQ
                                                 : metric;
  auto* pw = (float*)(p.splits > 1 ? scratch_w : best_w);
  auto* pj = (int32_t*)(p.splits > 1 ? scratch_j : best_j);
  cudaError_t err;
  if (d <= 4) err = launch<4, 8>(rs, cs, d, code, p, pw, pj, s);
  else if (d <= 8) err = launch<8, 8>(rs, cs, d, code, p, pw, pj, s);
  else if (d <= 32) err = launch<32, 2>(rs, cs, d, code, p, pw, pj, s);
  else if (d <= 128) err = launch<128, 1>(rs, cs, d, code, p, pw, pj, s);
  else err = launch<0, 1>(rs, cs, d, code, p, pw, pj, s);
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  segmin_combine_kernel<<<(rs.n + 255) / 256, 256, 0, s>>>(pw, pj, p.splits, rs.n,
                                                           (float*)best_w, (int32_t*)best_j);
  return (int)cudaGetLastError();
}

// Column splits a launch of nr rows, nc columns and d features takes: the
// wrapper allocates splits x nr partials when it is above 1.
extern "C" int segmin_splits(int nr, int nc, int d) {
  return nr <= 0 ? 1 : plan(nr, nc, d).splits;
}

extern "C" int segmin_launch(const void* x, const void* core, const void* comp,
                             const void* valid, int n, int d, int metric, int splits,
                             void* scratch_w, void* scratch_j, void* best_w,
                             void* best_j, void* stream) {
  const Side side{(const float*)x, (const float*)core, (const int32_t*)comp,
                  (const uint8_t*)valid, n};
  return dispatch(side, side, d, metric, splits, scratch_w, scratch_j, best_w, best_j,
                  stream);
}

extern "C" int segmin_panel_launch(const void* rows, const void* core_r,
                                   const void* comp_r, const void* valid_r, int nr,
                                   const void* panel, const void* core_c,
                                   const void* comp_c, const void* valid_c, int nc,
                                   int d, int metric, int splits, void* scratch_w,
                                   void* scratch_j, void* best_w, void* best_j,
                                   void* stream) {
  const Side rs{(const float*)rows, (const float*)core_r, (const int32_t*)comp_r,
                (const uint8_t*)valid_r, nr};
  const Side cs{(const float*)panel, (const float*)core_c, (const int32_t*)comp_c,
                (const uint8_t*)valid_c, nc};
  return dispatch(rs, cs, d, metric, splits, scratch_w, scratch_j, best_w, best_j, stream);
}
