// B7 forest_rescan_topk and B8 forest_min_outgoing: two reductions of one
// rp-forest candidate panel.
//
// Replace the TPU kernels hdbscan_tpu/ops/pallas_forest.py
// forest_rescan_topk (_rescan_topk_kernel -> rescan_topk_values, rows_dist)
// and forest_min_outgoing (_cand_minout_kernel -> cand_minout_values). Query
// row i owns the C candidate ids cids[i, :] (the neighbors of its
// neighbors); slots equal to `sentinel` are empty.
//
// B7: the k lex-best (distance, id) pairs among the row's finite
// candidates, copies of one (distance, id) pair counted once, ascending;
// unused slots (+inf, LEX_ID_MAX) -- the TPU kernel's output contract
// (lexmerge.topk_tile_candidates). Distances at f32 in the caller's metric
// and form; in bf16 mode (mu != null) query and candidate are centred on
// the row's centre mu[i] (computed by the wrapper), rounded to bfloat16,
// and the cross term accumulates their exact products in float32 beside
// float32 norms of the centred, unrounded operands.
//
// B8: the Borůvka segment-min over the same panel: the minimum of
// max(dist, core_q[i], core[c]) over candidates c in another component
// (comp[c] != comp_q[i]), the first minimal panel column on ties, (+inf,
// -1) where there is none. Float32 distances only.
//
// Design: one thread per query row walks its candidates in panel order and
// gathers each candidate's coordinates from `data` by id itself, so the
// (m, C, d) coordinate panel the TPU wrapper materialises is never built.
// B7 keeps a k-list in registers: a candidate enters only if it lex-
// precedes the current k-th and is not already in the list (copies of an
// id carry the same distance).
//
// Bound on this card: bytes. Each candidate costs a 4-byte id and d
// scattered 4-byte coordinate reads (mostly L2 hits: neighbors of
// neighbors are few distinct points) for about 3d float operations.
//
// Wide mode (B7 past k = 128 or d = 128, f32 only, as bf16 runs inside the
// reference's fused gate; B8 past d = 128): the same walk with both points
// read through pointers in the same feature order (distance.cuh's
// pair_distance_ptr), B7's k-list in the row's output (lexlist.cuh).
#include <cstdint>

#include "distance.cuh"
#include "lexlist.cuh"

constexpr int RESCAN_ROWS = 128;

// The row's point (centred and rounded in bf16 mode) and its norm.
template <int DMAX>
__device__ __forceinline__ float load_point(const float* __restrict__ src,
                                            const float* __restrict__ mur,
                                            int d, float (&x)[DMAX]) {
#pragma unroll
  for (int f = 0; f < DMAX; ++f) {
    float v = f < d ? src[f] : 0.0f;
    if (mur != nullptr && f < d) v = v - mur[f];
    x[f] = v;
  }
  const float sq = sq_norm<DMAX>(x, d);
  if (mur != nullptr) {
#pragma unroll
    for (int f = 0; f < DMAX; ++f) x[f] = bf16_round(x[f]);
  }
  return sq;
}

template <int DMAX, int KB>
__global__ void rescan_topk_kernel(const float* __restrict__ q,
                                   const float* __restrict__ data,
                                   const int32_t* __restrict__ cids, int m,
                                   int C, int d, int k, int metric,
                                   int sentinel, const float* __restrict__ mu,
                                   float* __restrict__ out_d,
                                   int32_t* __restrict__ out_i) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  const float* mur = mu != nullptr ? mu + (int64_t)row * d : nullptr;
  const int code = mu != nullptr ? METRIC_EUCLID_DOT : metric;
  float xr[DMAX], xc[DMAX];
  const float xr_sq = load_point<DMAX>(q + (int64_t)row * d, mur, d, xr);

  float bd[KB];
  int32_t bi[KB];
#pragma unroll
  for (int s = 0; s < KB; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = LEX_ID_MAX;
  }
  float wd = CUDART_INF_F;  // slot k - 1
  int32_t wi = LEX_ID_MAX;
  const int32_t* ids = cids + (int64_t)row * C;
  for (int c = 0; c < C; ++c) {
    const int32_t cid = ids[c];
    if (cid == sentinel) continue;
    const float xc_sq = load_point<DMAX>(data + (int64_t)cid * d, mur, d, xc);
    const float dist = pair_distance<DMAX>(xr, xr_sq, xc, xc_sq, d, code);
    if (!(dist < CUDART_INF_F) || !lex_less(dist, cid, wd, wi)) continue;
    bool dup = false;
#pragma unroll
    for (int s = 0; s < KB; ++s) dup |= s < k && bi[s] == cid && bd[s] == dist;
    if (dup) continue;
    lex_insert<KB>(bd, bi, k, dist, cid);
#pragma unroll
    for (int s = 0; s < KB; ++s) {
      if (s == k - 1) {
        wd = bd[s];
        wi = bi[s];
      }
    }
  }
  const int64_t o = (int64_t)row * k;
#pragma unroll
  for (int s = 0; s < KB; ++s) {
    if (s < k) {
      out_d[o + s] = bd[s];
      out_i[o + s] = bi[s];
    }
  }
}

template <int DMAX>
__global__ void min_outgoing_kernel(const float* __restrict__ q,
                                    const float* __restrict__ data,
                                    const int32_t* __restrict__ cids, int m,
                                    int C, int d, int metric, int sentinel,
                                    const float* __restrict__ core_q,
                                    const float* __restrict__ core,
                                    const int32_t* __restrict__ comp_q,
                                    const int32_t* __restrict__ comp,
                                    float* __restrict__ out_w,
                                    int32_t* __restrict__ out_j) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  float xr[DMAX], xc[DMAX];
  const float xr_sq = load_point<DMAX>(q + (int64_t)row * d, nullptr, d, xr);
  const float cq = core_q[row];
  const int32_t gq = comp_q[row];
  float bw = CUDART_INF_F;
  int32_t bj = -1;
  const int32_t* ids = cids + (int64_t)row * C;
  for (int c = 0; c < C; ++c) {
    const int32_t cid = ids[c];
    if (cid == sentinel || comp[cid] == gq) continue;
    const float xc_sq = load_point<DMAX>(data + (int64_t)cid * d, nullptr, d, xc);
    const float dist = pair_distance<DMAX>(xr, xr_sq, xc, xc_sq, d, metric);
    const float w = fmaxf(dist, fmaxf(cq, core[cid]));
    if (w < bw) {
      bw = w;
      bj = cid;
    }
  }
  out_w[row] = bw;
  out_j[row] = bw < CUDART_INF_F ? bj : -1;
}

__global__ void rescan_topk_wide_kernel(const float* __restrict__ q,
                                        const float* __restrict__ data,
                                        const int32_t* __restrict__ cids, int m, int C,
                                        int d, int k, int metric, int sentinel,
                                        float* __restrict__ out_d,
                                        int32_t* __restrict__ out_i) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  const float* xr = q + (int64_t)row * d;
  const bool dot = dot_form(metric);
  const float xr_sq = dot ? sq_norm_ptr(xr, d) : 0.0f;
  float* bd = out_d + (int64_t)row * k;
  int32_t* bi = out_i + (int64_t)row * k;
  for (int s = 0; s < k; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = LEX_ID_MAX;
  }
  float wd = CUDART_INF_F;  // slot k - 1
  int32_t wi = LEX_ID_MAX;
  const int32_t* ids = cids + (int64_t)row * C;
  for (int c = 0; c < C; ++c) {
    const int32_t cid = ids[c];
    if (cid == sentinel) continue;
    const float* xc = data + (int64_t)cid * d;
    const float dist = pair_distance_ptr(xr, xr_sq, xc, dot ? sq_norm_ptr(xc, d) : 0.0f, d,
                                         metric);
    if (!(dist < CUDART_INF_F) || !lex_less(dist, cid, wd, wi)) continue;
    bool dup = false;
    for (int s = 0; s < k && !dup; ++s) dup = bi[s] == cid && bd[s] == dist;
    if (dup) continue;
    lex_insert_mem(bd, bi, k, dist, cid);
    wd = bd[k - 1];
    wi = bi[k - 1];
  }
}

__global__ void min_outgoing_wide_kernel(const float* __restrict__ q,
                                         const float* __restrict__ data,
                                         const int32_t* __restrict__ cids, int m, int C,
                                         int d, int metric, int sentinel,
                                         const float* __restrict__ core_q,
                                         const float* __restrict__ core,
                                         const int32_t* __restrict__ comp_q,
                                         const int32_t* __restrict__ comp,
                                         float* __restrict__ out_w,
                                         int32_t* __restrict__ out_j) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  const float* xr = q + (int64_t)row * d;
  const bool dot = dot_form(metric);
  const float xr_sq = dot ? sq_norm_ptr(xr, d) : 0.0f;
  const float cq = core_q[row];
  const int32_t gq = comp_q[row];
  float bw = CUDART_INF_F;
  int32_t bj = -1;
  const int32_t* ids = cids + (int64_t)row * C;
  for (int c = 0; c < C; ++c) {
    const int32_t cid = ids[c];
    if (cid == sentinel || comp[cid] == gq) continue;
    const float* xc = data + (int64_t)cid * d;
    const float dist = pair_distance_ptr(xr, xr_sq, xc, dot ? sq_norm_ptr(xc, d) : 0.0f, d,
                                         metric);
    const float w = fmaxf(dist, fmaxf(cq, core[cid]));
    if (w < bw) {
      bw = w;
      bj = cid;
    }
  }
  out_w[row] = bw;
  out_j[row] = bw < CUDART_INF_F ? bj : -1;
}

template <int DMAX, int KB>
static cudaError_t launch_topk(const float* q, const float* data, const int32_t* cids,
                               int m, int C, int d, int k, int metric, int sentinel,
                               const float* mu, float* od, int32_t* oi, cudaStream_t s) {
  const int blocks = (m + RESCAN_ROWS - 1) / RESCAN_ROWS;
  rescan_topk_kernel<DMAX, KB><<<blocks, RESCAN_ROWS, 0, s>>>(
      q, data, cids, m, C, d, k, metric, sentinel, mu, od, oi);
  return cudaGetLastError();
}

template <int DMAX>
static cudaError_t launch_topk_k(const float* q, const float* data, const int32_t* cids,
                                 int m, int C, int d, int k, int metric, int sentinel,
                                 const float* mu, float* od, int32_t* oi, cudaStream_t s) {
  if (k <= 16) return launch_topk<DMAX, 16>(q, data, cids, m, C, d, k, metric, sentinel, mu, od, oi, s);
  if (k <= 32) return launch_topk<DMAX, 32>(q, data, cids, m, C, d, k, metric, sentinel, mu, od, oi, s);
  if (k <= 128) return launch_topk<DMAX, 128>(q, data, cids, m, C, d, k, metric, sentinel, mu, od, oi, s);
  return cudaErrorInvalidValue;
}

extern "C" int forest_rescan_topk_launch(const void* q, const void* data, const void* cids,
                                         int m, int C, int d, int k, int metric,
                                         int sentinel, const void* mu, void* out_d,
                                         void* out_i, void* stream) {
  auto* qq = (const float*)q;
  auto* x = (const float*)data;
  auto* ids = (const int32_t*)cids;
  auto* mm = (const float*)mu;
  auto* od = (float*)out_d;
  auto* oi = (int32_t*)out_i;
  auto s = (cudaStream_t)stream;
  if (m <= 0) return 0;
  if (k < 1 || C < 0 || d < 1) return (int)cudaErrorInvalidValue;
  if (k > 128 || d > 128) {
    if (mm != nullptr) return (int)cudaErrorInvalidValue;  // bf16 stays within 128
    rescan_topk_wide_kernel<<<(m + RESCAN_ROWS - 1) / RESCAN_ROWS, RESCAN_ROWS, 0, s>>>(
        qq, x, ids, m, C, d, k, metric, sentinel, od, oi);
    return (int)cudaGetLastError();
  }
  if (d <= 4) return launch_topk_k<4>(qq, x, ids, m, C, d, k, metric, sentinel, mm, od, oi, s);
  if (d <= 8) return launch_topk_k<8>(qq, x, ids, m, C, d, k, metric, sentinel, mm, od, oi, s);
  if (d <= 32) return launch_topk_k<32>(qq, x, ids, m, C, d, k, metric, sentinel, mm, od, oi, s);
  if (d <= 128) return launch_topk_k<128>(qq, x, ids, m, C, d, k, metric, sentinel, mm, od, oi, s);
  return (int)cudaErrorInvalidValue;
}

template <int DMAX>
static cudaError_t launch_minout(const float* q, const float* data, const int32_t* cids,
                                 int m, int C, int d, int metric, int sentinel,
                                 const float* core_q, const float* core,
                                 const int32_t* comp_q, const int32_t* comp,
                                 float* ow, int32_t* oj, cudaStream_t s) {
  const int blocks = (m + RESCAN_ROWS - 1) / RESCAN_ROWS;
  min_outgoing_kernel<DMAX><<<blocks, RESCAN_ROWS, 0, s>>>(
      q, data, cids, m, C, d, metric, sentinel, core_q, core, comp_q, comp, ow, oj);
  return cudaGetLastError();
}

extern "C" int forest_min_outgoing_launch(const void* q, const void* data, const void* cids,
                                          int m, int C, int d, int metric, int sentinel,
                                          const void* core_q, const void* core,
                                          const void* comp_q, const void* comp,
                                          void* out_w, void* out_j, void* stream) {
  auto* qq = (const float*)q;
  auto* x = (const float*)data;
  auto* ids = (const int32_t*)cids;
  auto* cq = (const float*)core_q;
  auto* cc = (const float*)core;
  auto* gq = (const int32_t*)comp_q;
  auto* gc = (const int32_t*)comp;
  auto* ow = (float*)out_w;
  auto* oj = (int32_t*)out_j;
  auto s = (cudaStream_t)stream;
  if (m <= 0) return 0;
  if (C < 0 || d < 1) return (int)cudaErrorInvalidValue;
  if (d > 128) {
    min_outgoing_wide_kernel<<<(m + RESCAN_ROWS - 1) / RESCAN_ROWS, RESCAN_ROWS, 0, s>>>(
        qq, x, ids, m, C, d, metric, sentinel, cq, cc, gq, gc, ow, oj);
    return (int)cudaGetLastError();
  }
  if (d <= 4) return launch_minout<4>(qq, x, ids, m, C, d, metric, sentinel, cq, cc, gq, gc, ow, oj, s);
  if (d <= 8) return launch_minout<8>(qq, x, ids, m, C, d, metric, sentinel, cq, cc, gq, gc, ow, oj, s);
  if (d <= 32) return launch_minout<32>(qq, x, ids, m, C, d, metric, sentinel, cq, cc, gq, gc, ow, oj, s);
  if (d <= 128) return launch_minout<128>(qq, x, ids, m, C, d, metric, sentinel, cq, cc, gq, gc, ow, oj, s);
  return (int)cudaErrorInvalidValue;
}
