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
// -1) where there is none. Distances at f32, or in B7's bf16 mode (the same
// row centres).
//
// Both gather each candidate's coordinates from `data` by id, so the
// (m, C, d) coordinate panel the TPU wrapper materialises is never built.
//
// Cosine (code 6; pearson's rows come centred) takes no root and can be
// slightly negative; a zero-norm point's cosine is NaN. NaN follows the
// plain versions (lexmerge.topk_tile_candidates, cand_minout_values), whose
// minima propagate it: B7 gives a row with a NaN candidate an empty list
// (every extraction pass meets a NaN minimum and takes nothing), and B8
// gives it the weight NaN at its first NaN candidate (torch.maximum keeps
// the NaN, torch.amin and argmin meet it first). B8 at cosine therefore
// reads every outgoing candidate: its bound (below) would skip one.
//
// Bound on this card: bytes, the candidate ids. Each candidate costs a
// 4-byte id and d scattered 4-byte coordinate reads (mostly L2 hits:
// neighbors of neighbors are few distinct points) for about 3d float
// operations. What the bound does not count is the list: a row admits
// about k (1 + ln(C' / k)) of its C' distinct candidates, each an insert
// that waits on the one before.
//
// B7's design. The rescan chunk holds max(64, 2^24 / (k^2 d)) rows, so the
// rows of a launch shrink as 1/k^2 while each row's candidates grow as
// k^2: at k = 129 and d = 3 a chunk is 336 rows of 16,641 candidates.
// (a) A warp per row, its lanes striding over the row's candidates, 32 a
//     step. Where the row blocks (RESCAN_WARPS rows each) are fewer than
//     RESCAN_TARGET_BLOCKS (about four an SM), the candidates are cut into
//     contiguous spans over a second grid axis (spans of at least
//     RESCAN_MIN_SPAN candidates), each span keeping its own list in
//     scratch the wrapper allocates; a second pass merges a row's span
//     lists. The contract is a function of the set of distinct pairs, so
//     any partition and any insertion order give the same list; the merge
//     drops a pair two spans both hold like any other copy. (132 and 2,112
//     target blocks were 1.2-2.1x slower at k = 63 and 129; PERF.md §6.)
// (b) The warp inserts together: every lane compares its slots with the
//     candidate in lex (distance, id) order, a ballot counts the slots
//     below it (its rank), and the duplicate test is part of the same
//     pass: a copy is equal in lex order, so it sits exactly at the rank.
//     The entries from the rank on move one slot back, 32 at a time, one
//     a lane. Candidates do not arrive in id order, so the test is lex,
//     not K2's "after every equal distance"; and a warp owns the list, so
//     the rank comes from one ballot rather than kbest.cuh's one-thread
//     bisection (list_insert): of that header B7 shares admit_bound only.
//     (The two inserts live in warplist.cuh, which B5 shares.)
//     The lanes' candidates under
//     the admission bound are inserted in lane order, each re-tested
//     against the list its predecessor left. At k <= 32 the list lives in
//     registers, slot l in lane l (lane_lex_insert: one ballot, one
//     shuffle), and a lane drops a candidate whose id the list already
//     holds before the insert: neighbors of neighbors repeat the row's
//     true neighbors many times over, and without that test the copies'
//     rank passes made the 3b launch slower than one thread a row. Above
//     k = 32 the list lies in shared memory (warp_lex_insert), up to
//     RESCAN_LIST_BYTES a block (k <= 1,024 at four rows a block); past
//     that in its own output or scratch row in device memory, with the
//     same insert (it measured 2-10% slower than shared memory at k = 63
//     and 129; PERF.md §6).
// (c) A root only for a candidate that can enter: the rooted codes run on
//     squared values v, and a candidate enters when sqrtf(v) is at most the
//     k-th distance w (equal distances enter when the id is lower), so the
//     bound is admit_bound at the float after w (nextafterf(w, +inf)),
//     under which every v with sqrtf(v) <= w lies; the exact lex test
//     follows the root. bf16 mode computes its rooted value as before.
// (d) Every k and d through this body. At d <= 32 a lane holds the query
//     row (and the bf16 centre) in registers; above, the warp stages it in
//     shared memory (up to RESCAN_ROW_BYTES a block, d <= 1,024; past that
//     f32 rows are read from device memory), and the distance takes a
//     runtime feature loop in the same order, so the bits do not depend on
//     the route.
//
// B8's design, after B7's (a): a warp a row, eight rows a block, the lanes
// striding over the row's candidates 32 a step, so the id loads coalesce.
// A candidate's component is read before its coordinates: in later Borůvka
// rounds most candidates lie in the row's own component and cost an id and
// a component load. Each lane keeps its running (w, column) minimum with a
// strict `<` over its ascending columns; a 5-step shuffle reduction takes
// the lex minimum of (w, column), which is the first minimal column. Where
// the row blocks are fewer than MINOUT_TARGET_BLOCKS, the candidates are cut
// into spans over a second grid axis, as B7's are, and a second pass takes
// each row's minimum over its spans in ascending span order (the lex
// minimum does not depend on the partition). After each step the warp
// shares its least weight: a later step's columns are higher, so a later
// candidate must fall below it to win; the warp stops once it reaches the
// row's own core distance (no weight is below that), and reads a
// candidate's coordinates only where its cores leave it below. The
// distance is B7's cand_value (features in ascending order, no FMA) with
// the root after, so the bits are the plain version's; at d <= 32 the
// query row lies in
// registers, above it is read where it lies (f32) or staged centred and
// rounded in shared memory (bf16).
#include <climits>
#include <cstdint>

#include "distance.cuh"
#include "kbest.cuh"
#include "lexlist.cuh"
#include "warplist.cuh"

// B8 launch shape: rows (warps) a block, about this many blocks, and spans
// no shorter than this.
constexpr int MINOUT_WARPS = 8;
constexpr int MINOUT_THREADS = MINOUT_WARPS * 32;
constexpr int MINOUT_TARGET_BLOCKS = 528;
constexpr int MINOUT_MIN_SPAN = 256;
// B7 launch shape: rows (warps) a block, about this many blocks, spans no
// shorter than this, and the shared memory a block's lists and staged query
// rows may take.
constexpr int RESCAN_WARPS = 4;
constexpr int RESCAN_THREADS = RESCAN_WARPS * 32;
constexpr int RESCAN_TARGET_BLOCKS = 528;
constexpr int RESCAN_MIN_SPAN = 256;
constexpr long RESCAN_LIST_BYTES = 32 * 1024;
constexpr long RESCAN_ROW_BYTES = 16 * 1024;

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


// ---- B7 ------------------------------------------------------------------

// The scan's (squared for the rooted codes) value of one candidate at xc
// for the query row xr (registers, DMAX > 0; or behind a pointer, DMAX ==
// 0, any d) with norm slot xr_sq (rooted at cosine); in bf16 mode (code 5)
// the candidate is centred on mr, its norm taken unrounded, the cross term
// from its bf16 rounding. Features in ascending order, as load_point and
// pair_distance.
template <int DMAX, int CODE, bool BF16, class Row>
__device__ __forceinline__ float cand_value(const Row& xr, float xr_sq, const Row& mr,
                                            const float* __restrict__ xc, int d) {
  float acc = 0.0f, sq = 0.0f;
  auto step = [&](int f) {
    float c = xc[f];
    if (BF16) {
      c = c - mr[f];
      sq = f == 0 ? c * c : sq + c * c;
      c = bf16_round(c);
    } else if (CODE == METRIC_EUCLID_DOT_SQ || CODE == METRIC_COSINE) {
      sq = f == 0 ? c * c : sq + c * c;
    }
    if (CODE == METRIC_EUCLID_DIFF_SQ) {
      const float t = xr[f] - c;
      acc = f == 0 ? t * t : acc + t * t;
    } else if (CODE == METRIC_EUCLID_DOT_SQ || CODE == METRIC_COSINE) {
      acc = f == 0 ? xr[f] * c : acc + xr[f] * c;
    } else {
      const float a = fabsf(xr[f] - c);
      acc = f == 0 ? a : CODE == METRIC_MANHATTAN ? acc + a : fmaxf(acc, a);
    }
  };
  if constexpr (DMAX > 0) {
#pragma unroll
    for (int f = 0; f < DMAX; ++f) {
      if (f < d) step(f);
    }
  } else {
    for (int f = 0; f < d; ++f) step(f);
  }
  if (CODE == METRIC_EUCLID_DOT_SQ) acc = fmaxf((xr_sq + sq) - 2.0f * acc, 0.0f);
  if (CODE == METRIC_COSINE) acc = cosine_value(acc, xr_sq, sqrtf(sq));
  return acc;
}

// A warp's scan of candidates [c_begin, c_end) of its row into the list
// (ld, li): 32 candidates a step, one a lane; those under the admission
// bound are inserted in lane order, each re-tested first. REG (k <= 32):
// the list lives in the lanes' registers while the scan runs and is
// written to (ld, li) at its end. Returns whether a candidate's value was
// NaN (the caller then empties the row's list).
template <int DMAX, int CODE, bool BF16, bool REG, class Row>
__device__ __forceinline__ bool rescan_span(const Row& xr, float xr_sq, const Row& mr,
                                            const float* __restrict__ data,
                                            const int32_t* __restrict__ ids, int c_begin,
                                            int c_end, int d, int k, bool root, int sentinel,
                                            float* ld, int32_t* li) {
  const int lane = threadIdx.x & 31;
  float wd = CUDART_INF_F, th = CUDART_INF_F;  // slot k - 1 and the bound under it
  int32_t wi = LEX_ID_MAX;
  float ed = CUDART_INF_F;  // REG: slot `lane`
  int32_t ei = LEX_ID_MAX;
  bool nan_seen = false;  // warp-uniform
  for (int c0 = c_begin; c0 < c_end; c0 += 32) {
    const int c = c0 + lane;
    const int32_t cid = c < c_end ? ids[c] : sentinel;
    float v = CUDART_INF_F;
    if (cid != sentinel) v = cand_value<DMAX, CODE, BF16>(xr, xr_sq, mr, data + (int64_t)cid * d, d);
    nan_seen |= __any_sync(0xffffffffu, isnan(v));
    // A copy of a listed id is the listed pair: it cannot enter (k <= 32).
    bool hit = v < th;
    if constexpr (REG) {
      for (int s = 0; s < k; ++s) hit &= __shfl_sync(0xffffffffu, ei, s) != cid;
    }
    unsigned mask = __ballot_sync(0xffffffffu, hit);
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const float vs = __shfl_sync(0xffffffffu, v, src);
      const int32_t is = __shfl_sync(0xffffffffu, cid, src);
      if (!(vs < th)) continue;
      const float dist = root ? sqrtf(vs) : vs;
      if (!lex_less(dist, is, wd, wi)) continue;
      if constexpr (REG) {
        if (!lane_lex_insert(ed, ei, k, dist, is)) continue;
        wd = __shfl_sync(0xffffffffu, ed, k - 1);
        wi = __shfl_sync(0xffffffffu, ei, k - 1);
      } else {
        if (!warp_lex_insert(ld, li, k, dist, is)) continue;
        wd = ld[k - 1];
        wi = li[k - 1];
      }
      th = admit_bound(nextafterf(wd, CUDART_INF_F), root);
    }
  }
  if constexpr (REG) {
    if (lane < k) {
      ld[lane] = ed;
      li[lane] = ei;
    }
  }
  return nan_seen;
}

// Grid (row blocks, spans): warp w of block x scans row x * RESCAN_WARPS + w
// over span y's candidates [y * span, (y + 1) * span) and writes its list to
// dst row (y * m + row) (the output when there is one span, else the span
// scratch). `code` is 4/5 (squared euclidean; `root` takes sqrtf of an
// admitted candidate), 2/3 or 6; mu != null is bf16 mode (code 5). A row
// with a NaN candidate writes an empty list, and into span scratch a NaN
// in its slot 0, which the merge pass reads as "the row is empty".
template <int DMAX>
__global__ void __launch_bounds__(RESCAN_THREADS)
rescan_topk_kernel(const float* __restrict__ q, const float* __restrict__ data,
                   const int32_t* __restrict__ cids, int m, int C, int d, int k, int code,
                   bool root, int sentinel, const float* __restrict__ mu, int span,
                   bool mem_lists, bool stage_rows, float* __restrict__ dst_d,
                   int32_t* __restrict__ dst_i) {
  extern __shared__ float rsm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * RESCAN_WARPS + warp;
  if (row >= m) return;  // the warp's own work only: no block barrier follows
  const int64_t o = ((int64_t)blockIdx.y * m + row) * k;
  float* ld = mem_lists ? dst_d + o : rsm + warp * k;
  int32_t* li = mem_lists ? dst_i + o
                          : reinterpret_cast<int32_t*>(rsm + RESCAN_WARPS * k) + warp * k;
  for (int s = lane; s < k; s += 32) {
    ld[s] = CUDART_INF_F;
    li[s] = LEX_ID_MAX;
  }
  const int c_begin = blockIdx.y * span;
  const int c_end = min(C, c_begin + span);
  const int32_t* ids = cids + (int64_t)row * C;
  const bool bf16 = mu != nullptr;
  const float* qr = q + (int64_t)row * d;
  const float* mur = bf16 ? mu + (int64_t)row * d : nullptr;

#define RESCAN_SPAN(CODE_, BF16_, REG_)                                                        \
  nan_row = rescan_span<DMAX, CODE_, BF16_, REG_>(xr, xr_sq, mr, data, ids, c_begin, c_end, d, \
                                                  k, root, sentinel, ld, li)
#define RESCAN_LIST(REG_)                                                                      \
  if (bf16) {                                                                                  \
    RESCAN_SPAN(METRIC_EUCLID_DOT_SQ, true, REG_);                                             \
  } else {                                                                                     \
    switch (code) {                                                                            \
      case METRIC_EUCLID_DIFF_SQ: RESCAN_SPAN(METRIC_EUCLID_DIFF_SQ, false, REG_); break;      \
      case METRIC_EUCLID_DOT_SQ: RESCAN_SPAN(METRIC_EUCLID_DOT_SQ, false, REG_); break;        \
      case METRIC_MANHATTAN: RESCAN_SPAN(METRIC_MANHATTAN, false, REG_); break;                \
      case METRIC_COSINE: RESCAN_SPAN(METRIC_COSINE, false, REG_); break;                      \
      default: RESCAN_SPAN(METRIC_SUPREMUM, false, REG_); break;                               \
    }                                                                                          \
  }
#define RESCAN_CODES()                                                                         \
  if (k <= 32) {                                                                               \
    RESCAN_LIST(true)                                                                          \
  } else {                                                                                     \
    RESCAN_LIST(false)                                                                         \
  }

  bool nan_row = false;
  if constexpr (DMAX > 0) {
    float xr[DMAX], mr[DMAX];
    const float xr_sq = norm_slot(load_point<DMAX>(qr, mur, d, xr), code);
#pragma unroll
    for (int f = 0; f < DMAX; ++f) mr[f] = (bf16 && f < d) ? mur[f] : 0.0f;
    __syncwarp();  // the list's initial slots
    RESCAN_CODES();
  } else {
    // The query row (centred, then rounded, in bf16 mode) and the centre in
    // shared memory behind the lists; past the budget (f32 only) the row is
    // read where it lies.
    const float* xr = qr;
    const float* mr = mur;
    if (stage_rows) {
      float* rows = rsm + (mem_lists ? 0 : 2 * RESCAN_WARPS * k);
      float* xs = rows + warp * d;
      float* ms = rows + (RESCAN_WARPS + warp) * d;
      for (int f = lane; f < d; f += 32) {
        float v = qr[f];
        if (bf16) {
          ms[f] = mur[f];
          v = v - mur[f];
        }
        xs[f] = v;
      }
      xr = xs;
      mr = ms;
    }
    __syncwarp();
    const float xr_sq = norm_slot(sq_norm_ptr(xr, d), code);
    if (bf16) {
      __syncwarp();  // every lane has read the unrounded row
      for (int f = lane; f < d; f += 32) const_cast<float*>(xr)[f] = bf16_round(xr[f]);
      __syncwarp();
    }
    RESCAN_CODES();
  }
#undef RESCAN_CODES
#undef RESCAN_LIST
#undef RESCAN_SPAN
  if (nan_row) {
    __syncwarp();
    for (int s = lane; s < k; s += 32) {
      ld[s] = CUDART_INF_F;
      li[s] = LEX_ID_MAX;
    }
    __syncwarp();
    if (gridDim.y > 1 && lane == 0) ld[0] = CUDART_NAN_F;
  }
  if (mem_lists) return;
  __syncwarp();
  for (int s = lane; s < k; s += 32) {
    dst_d[o + s] = ld[s];
    dst_i[o + s] = li[s];
  }
}

// A row's span lists (scratch [span][row][slot], each ascending) merged into
// its output row, a warp a row: span 0's list as it stands, then each later
// span's entries in order until one no longer lex-precedes the k-th (a
// list ascends, so none after it enters), inserted like candidates. A span
// whose slot 0 is NaN met a NaN candidate: the row's list is empty.
__global__ void __launch_bounds__(RESCAN_THREADS)
rescan_merge_kernel(const float* __restrict__ pd, const int32_t* __restrict__ pi, int splits,
                    int m, int k, bool mem_lists, float* __restrict__ out_d,
                    int32_t* __restrict__ out_i) {
  extern __shared__ float rsm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * RESCAN_WARPS + warp;
  if (row >= m) return;
  const int64_t o = (int64_t)row * k;
  bool nan_row = false;
  for (int y = 0; y < splits; ++y) nan_row |= isnan(pd[((int64_t)y * m + row) * k]);
  if (nan_row) {
    for (int s = lane; s < k; s += 32) {
      out_d[o + s] = CUDART_INF_F;
      out_i[o + s] = LEX_ID_MAX;
    }
    return;
  }
  float* ld = mem_lists ? out_d + o : rsm + warp * k;
  int32_t* li = mem_lists ? out_i + o
                          : reinterpret_cast<int32_t*>(rsm + RESCAN_WARPS * k) + warp * k;
  for (int s = lane; s < k; s += 32) {
    ld[s] = pd[o + s];
    li[s] = pi[o + s];
  }
  __syncwarp();
  float wd = ld[k - 1];
  int32_t wi = li[k - 1];
  for (int y = 1; y < splits; ++y) {
    const int64_t base = ((int64_t)y * m + row) * k;
    bool more = true;
    for (int s0 = 0; s0 < k && more; s0 += 32) {
      const int s = s0 + lane;
      float e = CUDART_INF_F;
      int32_t ei = LEX_ID_MAX;
      if (s < k) {
        e = pd[base + s];
        ei = pi[base + s];
      }
      unsigned mask = __ballot_sync(0xffffffffu, lex_less(e, ei, wd, wi));
      more = mask == 0xffffffffu;
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const float es = __shfl_sync(0xffffffffu, e, src);
        const int32_t is = __shfl_sync(0xffffffffu, ei, src);
        if (lex_less(es, is, wd, wi) && warp_lex_insert(ld, li, k, es, is)) {
          wd = ld[k - 1];
          wi = li[k - 1];
        }
      }
    }
  }
  if (mem_lists) return;
  __syncwarp();
  for (int s = lane; s < k; s += 32) {
    out_d[o + s] = ld[s];
    out_i[o + s] = li[s];
  }
}

// ---- B8 ------------------------------------------------------------------

// A warp's scan of candidates [c_begin, c_end) of its row, 32 a step, one a
// lane: the lane's running minimum (bw, bc) of w = max(dist, core_q,
// core[cid]) over candidates in another component, its columns ascending
// and a strict `<`, so each lane keeps its first minimal column (a NaN w,
// which the max keeps, beats every number: the lane keeps its first NaN).
// After each step the warp takes the least of its lanes' minima (`bound`):
// a later step's columns are all higher, so only a w below it can still
// win. Every w is at least core_q, and at least max(core_q, core[cid])
// before the distance: the warp stops once the bound reaches core_q, and a
// candidate whose cores already reach the bound is left before its
// coordinates are read. Cosine keeps no bound: a NaN there would be missed.
// The component test comes first.
template <int DMAX, int CODE, bool BF16, class Row>
__device__ __forceinline__ void minout_span(const Row& xr, float xr_sq, const Row& mr,
                                            const float* __restrict__ data,
                                            const int32_t* __restrict__ ids, int c_begin,
                                            int c_end, int d, bool root, int sentinel, float cq,
                                            int32_t gq, const float* __restrict__ core,
                                            const int32_t* __restrict__ comp, float& bw,
                                            int& bc) {
  constexpr bool prune = CODE != METRIC_COSINE;
  float bound = CUDART_INF_F;  // warp-uniform
  for (int c0 = c_begin; c0 < c_end && (!prune || cq < bound); c0 += 32) {
    const int c = c0 + (threadIdx.x & 31);
    const int32_t cid = c < c_end ? ids[c] : sentinel;
    if (cid != sentinel && comp[cid] != gq) {
      const float floor_w = fmaxf(cq, core[cid]);
      if (!prune || floor_w < bound) {
        const float v =
            cand_value<DMAX, CODE, BF16>(xr, xr_sq, mr, data + (int64_t)cid * d, d);
        const float dist = root ? sqrtf(v) : v;
        const float w = isnan(dist) ? dist : fmaxf(dist, floor_w);
        if (isnan(w) ? !isnan(bw) : w < bw) {
          bw = w;
          bc = c;
        }
      }
    }
    // Weights of the pruned metrics are not negative, so their bits order
    // as unsigned integers (a -0 weight only leaves the bound higher, which
    // prunes less).
    if (prune) bound = __uint_as_float(__reduce_min_sync(0xffffffffu, __float_as_uint(bw)));
  }
}

// Whether the minimum (ow, oc) precedes (bw, bc): a NaN weight first (the
// lower column among NaNs), then the lex (w, column) order.
__device__ __forceinline__ bool minout_before(float ow, int oc, float bw, int bc) {
  if (isnan(ow)) return !isnan(bw) || oc < bc;
  return !isnan(bw) && (ow < bw || (ow == bw && oc < bc));
}

// Grid (row blocks, spans): warp w of block x takes row x * MINOUT_WARPS + w
// over span y's candidates [y * span, (y + 1) * span). The lanes' minima
// meet in a shuffle reduction under the (w, column) lex order, so the row's
// first minimal column wins whatever lane holds it. One span: the row's (w,
// id) is written; several: the span's (w, column) goes to the scratch row
// (y * m + row) for min_outgoing_combine_kernel. `code` is 4/5 (squared
// euclidean, `root` takes the root), 2/3 or 6; mu != null is bf16 mode (code 5).
template <int DMAX>
__global__ void __launch_bounds__(MINOUT_THREADS)
min_outgoing_kernel(const float* __restrict__ q, const float* __restrict__ data,
                    const int32_t* __restrict__ cids, int m, int C, int d, int code, bool root,
                    int sentinel, const float* __restrict__ mu, const float* __restrict__ core_q,
                    const float* __restrict__ core, const int32_t* __restrict__ comp_q,
                    const int32_t* __restrict__ comp, int span, float* __restrict__ pw,
                    int32_t* __restrict__ pc, float* __restrict__ out_w,
                    int32_t* __restrict__ out_j) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * MINOUT_WARPS + warp;
  if (row >= m) return;  // the warp's own work only: no block barrier follows
  const int c_begin = blockIdx.y * span;
  const int c_end = min(C, c_begin + span);
  const int32_t* ids = cids + (int64_t)row * C;
  const bool bf16 = mu != nullptr;
  const float* qr = q + (int64_t)row * d;
  const float* mur = bf16 ? mu + (int64_t)row * d : nullptr;
  const float cq = core_q[row];
  const int32_t gq = comp_q[row];
  float bw = CUDART_INF_F;
  int bc = INT_MAX;

#define MINOUT_SPAN(CODE_, BF16_)                                                              \
  minout_span<DMAX, CODE_, BF16_>(xr, xr_sq, mr, data, ids, c_begin, c_end, d, root, sentinel, \
                                  cq, gq, core, comp, bw, bc)
#define MINOUT_CODES()                                                                         \
  if (bf16) {                                                                                  \
    MINOUT_SPAN(METRIC_EUCLID_DOT_SQ, true);                                                   \
  } else {                                                                                     \
    switch (code) {                                                                            \
      case METRIC_EUCLID_DIFF_SQ: MINOUT_SPAN(METRIC_EUCLID_DIFF_SQ, false); break;            \
      case METRIC_EUCLID_DOT_SQ: MINOUT_SPAN(METRIC_EUCLID_DOT_SQ, false); break;              \
      case METRIC_MANHATTAN: MINOUT_SPAN(METRIC_MANHATTAN, false); break;                      \
      case METRIC_COSINE: MINOUT_SPAN(METRIC_COSINE, false); break;                            \
      default: MINOUT_SPAN(METRIC_SUPREMUM, false); break;                                     \
    }                                                                                          \
  }

  if constexpr (DMAX > 0) {
    float xr[DMAX], mr[DMAX];
    const float xr_sq = norm_slot(load_point<DMAX>(qr, mur, d, xr), code);
#pragma unroll
    for (int f = 0; f < DMAX; ++f) mr[f] = (bf16 && f < d) ? mur[f] : 0.0f;
    MINOUT_CODES();
  } else {
    // Past d = 32: f32 reads the query row where it lies; bf16 (d <= 128)
    // stages it centred and rounded, and the centre, in shared memory.
    __shared__ float rows[2][MINOUT_WARPS][128];
    const float* xr = qr;
    const float* mr = mur;
    if (bf16) {
      float* xs = rows[0][warp];
      float* ms = rows[1][warp];
      for (int f = lane; f < d; f += 32) {
        ms[f] = mur[f];
        xs[f] = qr[f] - mur[f];
      }
      __syncwarp();
      xr = xs;
      mr = ms;
    }
    const float xr_sq = norm_slot(sq_norm_ptr(xr, d), code);
    if (bf16) {
      __syncwarp();  // every lane has read the unrounded row
      for (int f = lane; f < d; f += 32) rows[0][warp][f] = bf16_round(xr[f]);
      __syncwarp();
    }
    MINOUT_CODES();
  }
#undef MINOUT_CODES
#undef MINOUT_SPAN
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ow = __shfl_xor_sync(0xffffffffu, bw, off);
    const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
    if (minout_before(ow, oc, bw, bc)) {
      bw = ow;
      bc = oc;
    }
  }
  if (lane != 0) return;
  if (gridDim.y == 1) {
    out_w[row] = bw;
    out_j[row] = isinf(bw) ? -1 : ids[bc];
  } else {
    pw[(int64_t)blockIdx.y * m + row] = bw;
    pc[(int64_t)blockIdx.y * m + row] = bc;
  }
}

// The spans' minima of a row, a thread a row, in ascending span order with
// the strict `<` (a later span's columns are higher); the first NaN span's
// minimum beats every number.
__global__ void min_outgoing_combine_kernel(const float* __restrict__ pw,
                                            const int32_t* __restrict__ pc,
                                            const int32_t* __restrict__ cids, int splits, int m,
                                            int C, float* __restrict__ out_w,
                                            int32_t* __restrict__ out_j) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  float bw = CUDART_INF_F;
  int bc = INT_MAX;
  for (int y = 0; y < splits; ++y) {
    const float w = pw[(int64_t)y * m + row];
    if (isnan(w) ? !isnan(bw) : w < bw) {
      bw = w;
      bc = pc[(int64_t)y * m + row];
    }
  }
  out_w[row] = bw;
  out_j[row] = isinf(bw) ? -1 : cids[(int64_t)row * C + bc];
}


// B7 launch shape: row blocks, spans, span length, list and row placement,
// and the dynamic shared memory of the scan (the merge's is the lists').
struct RescanPlan {
  int blocks, splits, span;
  bool mem_lists, stage_rows;
  size_t smem, merge_smem;
};

static RescanPlan rescan_plan(int m, int C, int d, int k, bool bf16) {
  RescanPlan p;
  p.blocks = max(1, (m + RESCAN_WARPS - 1) / RESCAN_WARPS);
  int splits = (RESCAN_TARGET_BLOCKS + p.blocks - 1) / p.blocks;
  splits = min(splits, max(1, C / RESCAN_MIN_SPAN));
  p.splits = max(1, splits);
  p.span = (C + p.splits - 1) / p.splits;
  const size_t list_bytes = (size_t)RESCAN_WARPS * k * 8;
  p.mem_lists = list_bytes > (size_t)RESCAN_LIST_BYTES;
  const size_t row_bytes = (size_t)2 * RESCAN_WARPS * d * sizeof(float);
  p.stage_rows = d > 32 && (bf16 || row_bytes <= (size_t)RESCAN_ROW_BYTES);
  p.merge_smem = p.mem_lists ? 0 : list_bytes;
  p.smem = p.merge_smem + (p.stage_rows ? row_bytes : 0);
  return p;
}

template <int DMAX>
static cudaError_t launch_topk(const float* q, const float* data, const int32_t* cids, int m,
                               int C, int d, int k, int code, bool root, int sentinel,
                               const float* mu, const RescanPlan& p, float* dd, int32_t* di,
                               cudaStream_t s) {
  auto kern = rescan_topk_kernel<DMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(p.blocks, p.splits), RESCAN_THREADS, p.smem, s>>>(
      q, data, cids, m, C, d, k, code, root, sentinel, mu, p.span, p.mem_lists, p.stage_rows,
      dd, di);
  return cudaGetLastError();
}

// Spans of a B7 launch of m rows, C candidates, d features and k slots
// (bf16: mu given): the wrapper allocates splits x m x k scratch slots
// when it is above 1.
extern "C" int forest_rescan_splits(int m, int C, int d, int k, int bf16) {
  if (m <= 0 || k < 1 || d < 1 || C < 0) return 1;
  return rescan_plan(m, C, d, k, bf16 != 0).splits;
}

// Blocks of the scan's grid (row blocks x spans), for reports of its size.
extern "C" int forest_rescan_blocks(int m, int C, int d, int k, int bf16) {
  if (m <= 0 || k < 1 || d < 1 || C < 0) return 0;
  const RescanPlan p = rescan_plan(m, C, d, k, bf16 != 0);
  return p.blocks * p.splits;
}

extern "C" int forest_rescan_topk_launch(const void* q, const void* data, const void* cids,
                                         int m, int C, int d, int k, int metric,
                                         int sentinel, const void* mu, int splits,
                                         void* scratch_d, void* scratch_i, void* out_d,
                                         void* out_i, void* stream) {
  auto* qq = (const float*)q;
  auto* x = (const float*)data;
  auto* ids = (const int32_t*)cids;
  auto* mm = (const float*)mu;
  auto* od = (float*)out_d;
  auto* oi = (int32_t*)out_i;
  auto s = (cudaStream_t)stream;
  if (m <= 0) return 0;
  if (k < 1 || C < 0 || d < 1 || metric < METRIC_EUCLID_DIFF ||
      (metric > METRIC_SUPREMUM && metric != METRIC_COSINE))
    return (int)cudaErrorInvalidValue;
  if (mm != nullptr && (k > 128 || d > 128 || metric > METRIC_EUCLID_DOT))
    return (int)cudaErrorInvalidValue;  // bf16 stays within 128, euclidean (either form)
  const RescanPlan p = rescan_plan(m, C, d, k, mm != nullptr);
  if (splits != p.splits || (p.splits > 1 && (scratch_d == nullptr || scratch_i == nullptr)))
    return (int)cudaErrorInvalidValue;
  // The euclidean codes run on squared values; roots only for admitted pairs.
  const bool root = metric == METRIC_EUCLID_DIFF || metric == METRIC_EUCLID_DOT;
  const int code = metric == METRIC_EUCLID_DIFF ? METRIC_EUCLID_DIFF_SQ
                   : metric == METRIC_EUCLID_DOT ? METRIC_EUCLID_DOT_SQ
                                                 : metric;
  float* dd = p.splits > 1 ? (float*)scratch_d : od;
  int32_t* di = p.splits > 1 ? (int32_t*)scratch_i : oi;
  cudaError_t err;
  if (d <= 4) {
    err = launch_topk<4>(qq, x, ids, m, C, d, k, code, root, sentinel, mm, p, dd, di, s);
  } else if (d <= 8) {
    err = launch_topk<8>(qq, x, ids, m, C, d, k, code, root, sentinel, mm, p, dd, di, s);
  } else if (d <= 32) {
    err = launch_topk<32>(qq, x, ids, m, C, d, k, code, root, sentinel, mm, p, dd, di, s);
  } else {
    err = launch_topk<0>(qq, x, ids, m, C, d, k, code, root, sentinel, mm, p, dd, di, s);
  }
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  err = cudaFuncSetAttribute(rescan_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p.merge_smem);
  if (err != cudaSuccess) return (int)err;
  rescan_merge_kernel<<<p.blocks, RESCAN_THREADS, p.merge_smem, s>>>(dd, di, p.splits, m, k,
                                                                     p.mem_lists, od, oi);
  return (int)cudaGetLastError();
}

// B8 launch shape: row blocks of MINOUT_WARPS rows; where they are fewer
// than MINOUT_TARGET_BLOCKS (about four an SM), each row's candidates are
// cut into spans of at least MINOUT_MIN_SPAN over a second grid axis.
static int minout_splits(int m, int C) {
  const int blocks = max(1, (m + MINOUT_WARPS - 1) / MINOUT_WARPS);
  const int splits = min((MINOUT_TARGET_BLOCKS + blocks - 1) / blocks, C / MINOUT_MIN_SPAN);
  return max(1, splits);
}

// Spans of a B8 launch of m rows and C candidates: the wrapper allocates
// splits x m (w, column) scratch slots when it is above 1.
extern "C" int forest_minout_splits(int m, int C) {
  if (m <= 0 || C < 0) return 1;
  return minout_splits(m, C);
}

template <int DMAX>
static cudaError_t launch_minout(const float* q, const float* data, const int32_t* cids, int m,
                                 int C, int d, int code, bool root, int sentinel,
                                 const float* mu, const float* core_q, const float* core,
                                 const int32_t* comp_q, const int32_t* comp, int splits,
                                 float* pw, int32_t* pc, float* ow, int32_t* oj,
                                 cudaStream_t s) {
  const int blocks = (m + MINOUT_WARPS - 1) / MINOUT_WARPS;
  const int span = splits > 1 ? (C + splits - 1) / splits : C;
  min_outgoing_kernel<DMAX><<<dim3(blocks, splits), MINOUT_THREADS, 0, s>>>(
      q, data, cids, m, C, d, code, root, sentinel, mu, core_q, core, comp_q, comp, span, pw,
      pc, ow, oj);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  min_outgoing_combine_kernel<<<(m + 255) / 256, 256, 0, s>>>(pw, pc, cids, splits, m, C, ow,
                                                               oj);
  return cudaGetLastError();
}

extern "C" int forest_min_outgoing_launch(const void* q, const void* data, const void* cids,
                                          int m, int C, int d, int metric, int sentinel,
                                          const void* mu, const void* core_q, const void* core,
                                          const void* comp_q, const void* comp, int splits,
                                          void* scratch_w, void* scratch_c, void* out_w,
                                          void* out_j, void* stream) {
  auto* qq = (const float*)q;
  auto* x = (const float*)data;
  auto* ids = (const int32_t*)cids;
  auto* mm = (const float*)mu;
  auto* cq = (const float*)core_q;
  auto* cc = (const float*)core;
  auto* gq = (const int32_t*)comp_q;
  auto* gc = (const int32_t*)comp;
  auto* pw = (float*)scratch_w;
  auto* pc = (int32_t*)scratch_c;
  auto* ow = (float*)out_w;
  auto* oj = (int32_t*)out_j;
  auto s = (cudaStream_t)stream;
  if (m <= 0) return 0;
  if (C < 0 || d < 1 || metric < METRIC_EUCLID_DIFF ||
      (metric > METRIC_SUPREMUM && metric != METRIC_COSINE))
    return (int)cudaErrorInvalidValue;
  if (mm != nullptr && (d > 128 || metric > METRIC_EUCLID_DOT))
    return (int)cudaErrorInvalidValue;  // bf16 stays within 128, euclidean (either form)
  if (splits != minout_splits(m, C) || (splits > 1 && (pw == nullptr || pc == nullptr)))
    return (int)cudaErrorInvalidValue;
  // The euclidean codes run on squared values and take the root after.
  const bool root = metric == METRIC_EUCLID_DIFF || metric == METRIC_EUCLID_DOT;
  const int code = metric == METRIC_EUCLID_DIFF ? METRIC_EUCLID_DIFF_SQ
                   : metric == METRIC_EUCLID_DOT ? METRIC_EUCLID_DOT_SQ
                                                 : metric;
#define MINOUT_LAUNCH(DMAX_)                                                                  \
  launch_minout<DMAX_>(qq, x, ids, m, C, d, code, root, sentinel, mm, cq, cc, gq, gc, splits, \
                       pw, pc, ow, oj, s)
  cudaError_t err;
  if (d <= 4) {
    err = MINOUT_LAUNCH(4);
  } else if (d <= 8) {
    err = MINOUT_LAUNCH(8);
  } else if (d <= 32) {
    err = MINOUT_LAUNCH(32);
  } else {
    err = MINOUT_LAUNCH(0);
  }
#undef MINOUT_LAUNCH
  return (int)err;
}
