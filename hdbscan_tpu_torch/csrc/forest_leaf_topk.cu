// B5 forest_leaf_topk: the dense k-NN of every rp-forest leaf against
// itself, for a batch of leaves.
//
// Replaces the TPU kernel hdbscan_tpu/ops/pallas_forest.py forest_leaf_topk
// (_leaf_topk_kernel -> leaf_topk_values, dist_tile). For leaf b and slot r
// (point members[b, r]) it returns the kk nearest columns of the leaf whose
// mask is set: selected in lax.top_k order (ascending distance, ties to the
// lower column POSITION), positions mapped to global ids through members,
// +inf slots to the sentinel, then sorted by (distance, id) -- the
// reference's lexsort epilogue. Output (B, L, kk) float32 / int32.
//
// Distances: at f32 the caller's metric and euclidean form (the one the
// reference picks for the real (L, L, d) leaf shape), in the plain
// version's operation order (distance.cuh); cosine (pearson's rows come
// centred) can be slightly negative, and a zero-norm point's cosine is NaN,
// which enters no list (the plain version's lex_kbest). In bf16 mode (mu != null) the
// operands are centred on the leaf's centre mu[b] (computed by the
// wrapper, the mean of the leaf's real members), rounded to bfloat16, and
// the cross term accumulates their products in float32 (each product is
// exact there) beside float32 norms of the centred, unrounded operands:
// the dot form's squared code on those operands.
//
// Bound on this card: operations. L^2 pair distances per leaf (about 3d
// float operations each) against B L (d + kk) words of device-memory
// traffic. What the bound does not count is the list: over a leaf's
// L ~ 1,000 positions a slot admits about kk (1 + ln(L / kk)) of them
// (~80 at kk 15; at kk 129 of 188, nearly every one), each an insert that
// waits on the one before.
//
// Design: a warp a slot, the lanes striding over the leaf's positions.
// K2's body (kbest.cuh: a thread a slot, R slots behind one vote) was
// built first: at leaf scale a large share of the pairs enter, so a warp
// took the insert path on nearly every step for a few lanes at a time,
// and the position spans that filled the card restarted every span's
// list; its scan ran 0.69 ms at the 3b batch (PERF.md §6).
// (a) A block of LEAF_WARPS warps takes LEAF_WARPS consecutive slots of
//     one leaf and stages the leaf's columns, gathered through members, in
//     shared-memory tiles (a masked column staged so that no slot can take
//     it: +inf features, or a +inf norm in the dot form). Each warp holds
//     its slot's point in registers and takes 32 positions a step, one a
//     lane (distance.cuh column_values: float4 reads, features in
//     ascending order), a root only for a candidate under the bound (the
//     float after fl(w * w), w the float after slot kk - 1's distance, as
//     kbest.cuh's admit_bound). The batch's slots give the card its blocks:
//     4,320 at the 3b batch, so no span split is needed.
// (b) Order. A leaf lists its points along the tree's last projection, so
//     a scan from position 0 approaches a slot's own neighbourhood step by
//     step and keeps admitting (162 inserts a slot at the 3b shape against
//     54 from the slot's own step; PERF.md §6). Each warp starts at the step
//     holding its slot and goes round the leaf (tiles likewise, from the
//     block's own). The test is therefore lex (distance, position), B7's:
//     a candidate enters iff it lex-precedes slot kk - 1, under a bound at
//     the float after that slot's distance, and the lex kk-best of a set
//     does not depend on the order it is met in: ascending distance, ties
//     to the lower position, lax.top_k's order.
// (c) Inserts. Each lane roots its own candidate at once. The list lies in
//     registers at kk <= 32 (slot l in lane l), in shared memory up to
//     LEAF_LIST_BYTES a block (kk <= 1,536), past that in the slot's output
//     row. A step with few candidates inserts them in lane order, each
//     re-tested against the list its predecessor left, with B7's warp
//     inserts (warplist.cuh: one ballot and one shuffle an insert in
//     registers); a step with LEAF_MERGE_MIN or more (the slot's own step
//     has 32) merges them into a register list at once: a bitonic sort of
//     the lanes' candidates and a bitonic merge with the list. Inserts were
//     three quarters of build 4's scan at 3b (PERF.md §6).
// (d) The epilogue maps positions to ids and writes each entry at its rank
//     in (distance, id) order, counted over the list (entries equal in
//     both keep their slot order), so no sort runs; a list in the output
//     row is sorted there by one lane.
// (e) Wide d (past 128, f32 only: bf16 runs inside the reference's fused
//     gate): the same scan with no tile, each lane's column read from
//     device memory and its distance taken by distance.cuh's pointer loop
//     in the same feature order.
#include <cstdint>

#include "distance.cuh"
#include "lexlist.cuh"
#include "warplist.cuh"

constexpr int LEAF_WARPS = 8;
constexpr int LEAF_THREADS = LEAF_WARPS * 32;
// Column tile: at most this many bytes of features and norms a block.
constexpr int LEAF_TILE_BYTES = 24 * 1024;
// Where a block's lists lie: registers at kk <= 32, shared memory while
// LEAF_WARPS kk-slot lists stay within LEAF_LIST_BYTES, else the slots'
// output rows.
constexpr int LEAF_LISTS_REGISTERS = 0;
constexpr int LEAF_LISTS_SHARED = 1;
constexpr int LEAF_LISTS_DEVICE = 2;
constexpr long LEAF_LIST_BYTES = 96 * 1024;

struct LeafArgs {
  const float* data;
  int d;
  const int32_t* members;
  const uint8_t* mask;
  int L, kk, metric, sentinel;
  const float* mu;
  int row_blocks, tile, lists;
  float* out_d;
  int32_t* out_i;
};

// The float after x (x itself at +inf): nextafterf(x, +inf) by one integer
// step, up for a positive pattern, down for a negative one (cosine
// distances can be negative), -0 to the least positive float.
__device__ __forceinline__ float next_up(float x) {
  const int b = __float_as_int(x);
  if (!(x < CUDART_INF_F)) return x;
  return __int_as_float(b >= 0 ? b + 1 : b == INT32_MIN ? 1 : b - 1);
}

// The bound under which every candidate that can enter a list whose slot
// kk - 1 holds distance wd lies: kbest.cuh's admit_bound at the float
// after wd (a candidate at wd's distance with a lower position still
// enters), with nextafterf's value by an integer add.
__device__ __forceinline__ float leaf_bound(float wd, bool root) {
  const float w = next_up(wd);
  return root ? next_up(w * w) : w;
}

// Lex compare-exchange with the lane `j` away: keep the lesser pair where
// keep_min, else the greater.
__device__ __forceinline__ void lex_exchange(float& d, int32_t& p, int j, bool keep_min) {
  const float od = __shfl_xor_sync(0xffffffffu, d, j);
  const int32_t op = __shfl_xor_sync(0xffffffffu, p, j);
  if (keep_min ? lex_less(od, op, d, p) : lex_less(d, p, od, op)) {
    d = od;
    p = op;
  }
}

// Merge the step's candidates (d, p) (one a lane, (+inf, LEX_ID_MAX) where
// none) into the register list (ed, ei): the candidates sorted across the
// lanes by a bitonic network, reversed against the list so that lane l's
// lesser pair of the two makes a bitonic sequence of the 32 least, which a
// last bitonic merge sorts. Slot l stays in lane l; the entries in lanes
// kk and up were all met, so the first kk are the lex kk-best of all.
__device__ __forceinline__ void merge_step(float d, int32_t p, float& ed, int32_t& ei) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      lex_exchange(d, p, j, ((lane & k) == 0) == ((lane & j) == 0));
    }
  }
  const float rd = __shfl_sync(0xffffffffu, d, 31 - lane);
  const int32_t rp = __shfl_sync(0xffffffffu, p, 31 - lane);
  if (lex_less(rd, rp, ed, ei)) {
    ed = rd;
    ei = rp;
  }
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) lex_exchange(ed, ei, j, (lane & j) == 0);
}

// Steps whose candidates number at least this many merge them at once
// (merge_step) into a register list; fewer are inserted one by one.
constexpr int LEAF_MERGE_MIN = 8;

// One step's candidates: lane l's value v (squared for the rooted codes)
// at position p0 + l. A candidate is a value under the bound th whose
// (distance, position) lex-precedes slot kk - 1, (wd, wi) (REG: the list
// in the lanes' (ed, ei); else at (ld, li)); each lane takes its root at
// once. Many candidates are merged at once; few are inserted in lane
// order, each re-tested against the list its predecessor left.
template <bool REG>
__device__ __forceinline__ void admit_step(float v, int p0, bool root, int kk, float& wd,
                                           int32_t& wi, float& th, float& ed, int32_t& ei,
                                           float* ld, int32_t* li) {
  const int lane = threadIdx.x & 31;
  const float dist = v < th ? (root ? sqrtf(v) : v) : CUDART_INF_F;
  const bool cand = v < th && lex_less(dist, p0 + lane, wd, wi);
  unsigned mask = __ballot_sync(0xffffffffu, cand);
  if (!mask) return;
  if constexpr (REG) {
    if (__popc(mask) >= LEAF_MERGE_MIN) {
      merge_step(cand ? dist : CUDART_INF_F, cand ? p0 + lane : LEX_ID_MAX, ed, ei);
      mask = 0;
    }
  }
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float ds = __shfl_sync(0xffffffffu, dist, src);
    if (!lex_less(ds, p0 + src, wd, wi)) continue;
    if constexpr (REG) {
      lane_lex_insert(ed, ei, kk, ds, p0 + src);
      wd = __shfl_sync(0xffffffffu, ed, kk - 1);
      wi = __shfl_sync(0xffffffffu, ei, kk - 1);
    } else {
      warp_lex_insert(ld, li, kk, ds, p0 + src);
      wd = ld[kk - 1];
      wi = li[kk - 1];
    }
  }
  if constexpr (REG) {
    wd = __shfl_sync(0xffffffffu, ed, kk - 1);
    wi = __shfl_sync(0xffffffffu, ei, kk - 1);
  }
  th = leaf_bound(wd, root);
}

// The epilogue of a warp's list of (distance, position): positions to ids
// through the leaf's members, unfilled slots to the sentinel, each entry
// written at its (distance, id) rank of the output row (od, oi).
template <bool REG>
__device__ __forceinline__ void leaf_epilogue(float ed, int32_t ei, float* ld, int32_t* li,
                                              int lists, int kk, const int32_t* mem,
                                              int sentinel, float* od, int32_t* oi) {
  const int lane = threadIdx.x & 31;
  if constexpr (REG) {
    const float dv = lane < kk ? ed : CUDART_INF_F;
    const int32_t iv = (lane < kk && ei != LEX_ID_MAX) ? mem[ei] : sentinel;
    int rank = 0;
    for (int j = 0; j < kk; ++j) {
      const float dj = __shfl_sync(0xffffffffu, dv, j);
      const int32_t ij = __shfl_sync(0xffffffffu, iv, j);
      rank += lex_less(dj, ij, dv, iv) || (dj == dv && ij == iv && j < lane);
    }
    if (lane < kk) {
      od[rank] = dv;
      oi[rank] = iv;
    }
  } else {
    for (int s = lane; s < kk; s += 32) li[s] = li[s] != LEX_ID_MAX ? mem[li[s]] : sentinel;
    __syncwarp();
    if (lists == LEAF_LISTS_DEVICE) {  // the list is the output row: sort it there
      if (lane == 0) lex_sort_mem(ld, li, kk);
      return;
    }
    for (int s = lane; s < kk; s += 32) {
      const float dv = ld[s];
      const int32_t iv = li[s];
      int rank = 0;
      for (int j = 0; j < kk; ++j) {
        const float dj = ld[j];
        const int32_t ij = li[j];
        rank += lex_less(dj, ij, dv, iv) || (dj == dv && ij == iv && j < s);
      }
      od[rank] = dv;
      oi[rank] = iv;
    }
  }
}

// A warp's list: the block's shared memory or the slot's output row (the
// registers need no place), emptied.
__device__ __forceinline__ void leaf_list(const LeafArgs& a, float* smem_lists, int64_t row,
                                          float*& ld, int32_t*& li) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (a.lists == LEAF_LISTS_REGISTERS) return;
  if (a.lists == LEAF_LISTS_DEVICE) {
    ld = a.out_d + row * a.kk;
    li = a.out_i + row * a.kk;
  } else {
    ld = smem_lists + warp * a.kk;
    li = reinterpret_cast<int32_t*>(smem_lists + LEAF_WARPS * a.kk) + warp * a.kk;
  }
  for (int s = lane; s < a.kk; s += 32) {
    ld[s] = CUDART_INF_F;
    li[s] = LEX_ID_MAX;
  }
  __syncwarp();
}

// One staged tile (positions c0 .. c0 + len) for the warp's slot r, CODE
// fixed: 32 positions a step, from the step holding r (or the tile's edge
// nearest r) round the tile.
template <int DMAX, int CODE, bool REG>
__device__ __forceinline__ void scan_leaf_tile(const float (&xr)[1][DMAX],
                                               const float (&xsq)[1], const float* xs,
                                               const float* ns, int dp, int d, int len, int c0,
                                               int r, bool root, int kk, float& wd, int32_t& wi,
                                               float& th, float& ed, int32_t& ei, float* ld,
                                               int32_t* li) {
  const int lane = threadIdx.x & 31;
  const int steps = (len + 31) / 32;
  const int first = min(max(r - c0, 0), len - 1) / 32;
  for (int i = 0; i < steps; ++i) {
    const int t0 = (first + i < steps ? first + i : first + i - steps) * 32;
    const int t = t0 + lane;
    float v[1] = {CUDART_INF_F};
    if (t < len) column_values<DMAX, 1, CODE>(xr, xsq, xs + t * dp, ns[t], d, v);
    admit_step<REG>(v[0], c0 + t0, root, kk, wd, wi, th, ed, ei, ld, li);
  }
}

// Grid (B * row_blocks): warp w of block x takes slot (x % row_blocks) *
// LEAF_WARPS + w of leaf x / row_blocks. `code` is 4/5 (squared euclidean;
// `root` takes sqrtf of an admitted candidate for codes 0/1), 2/3 or 6.
template <int DMAX, bool REG>
__global__ void __launch_bounds__(LEAF_THREADS)
leaf_topk_kernel(LeafArgs a, int code, bool root) {
  extern __shared__ float4 smem4[];
  const int d = a.d, L = a.L, kk = a.kk;
  const int dp = (d + 3) & ~3;
  float* xs = reinterpret_cast<float*>(smem4);  // tile x dp features
  float* ns = xs + a.tile * dp;                  // tile norms (dot form)
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / a.row_blocks;
  const int r = (blockIdx.x - b * a.row_blocks) * LEAF_WARPS + warp;
  const bool row_ok = r < L;  // warp-uniform
  const int32_t* mem = a.members + (int64_t)b * L;
  const uint8_t* msk = a.mask + (int64_t)b * L;
  const bool bf16 = a.mu != nullptr;
  const float* mub = bf16 ? a.mu + (int64_t)b * d : nullptr;
  const bool normed = uses_norms(code);
  const int64_t row = (int64_t)b * L + r;

  float xr[1][DMAX], xsq[1];
  const int32_t rid = row_ok ? mem[r] : 0;
#pragma unroll
  for (int f = 0; f < DMAX; ++f) {
    float v = (row_ok && f < d) ? a.data[(int64_t)rid * d + f] : 0.0f;
    if (bf16 && f < d) v = v - mub[f];
    xr[0][f] = v;
  }
  xsq[0] = norm_slot(sq_norm<DMAX>(xr[0], d), code);
  if (bf16) {
#pragma unroll
    for (int f = 0; f < DMAX; ++f) xr[0][f] = bf16_round(xr[0][f]);
  }
  float* ld = nullptr;
  int32_t* li = nullptr;
  if (row_ok) leaf_list(a, ns + a.tile, row, ld, li);
  float wd = CUDART_INF_F, th = CUDART_INF_F, ed = CUDART_INF_F;
  int32_t wi = LEX_ID_MAX, ei = LEX_ID_MAX;

  // Tiles from the one holding the block's first slot round the leaf.
  const int tiles = (L + a.tile - 1) / a.tile;
  const int own = min((blockIdx.x - b * a.row_blocks) * LEAF_WARPS, L - 1) / a.tile;
  for (int ti = 0; ti < tiles; ++ti) {
    const int c0 = (own + ti < tiles ? own + ti : own + ti - tiles) * a.tile;
    const int len = min(a.tile, L - c0);
    for (int t = threadIdx.x; t < len; t += LEAF_THREADS) {
      const float* src = a.data + (int64_t)mem[c0 + t] * d;
      const bool off = !normed && !msk[c0 + t];  // no slot takes a masked column
      for (int f = 0; f < d; ++f) {
        float v = src[f];
        if (bf16) v = v - mub[f];
        xs[t * dp + f] = off ? CUDART_INF_F : v;
      }
    }
    if (normed) {
      __syncthreads();
      for (int t = threadIdx.x; t < len; t += LEAF_THREADS) {
        float* xc = xs + t * dp;
        float acc = xc[0] * xc[0];
        for (int f = 1; f < d; ++f) acc = acc + xc[f] * xc[f];
        // A masked column's norm slot makes its value +inf (dot form) or
        // NaN (cosine): no slot takes it.
        ns[t] = msk[c0 + t] ? norm_slot(acc, code)
                            : code == METRIC_COSINE ? CUDART_NAN_F : CUDART_INF_F;
        if (bf16) {
          for (int f = 0; f < d; ++f) xc[f] = bf16_round(xc[f]);
        }
      }
    }
    __syncthreads();
    if (row_ok) {
      switch (code) {  // uniform: the metric picks the tile loop
        case METRIC_EUCLID_DIFF_SQ:
          scan_leaf_tile<DMAX, METRIC_EUCLID_DIFF_SQ, REG>(xr, xsq, xs, ns, dp, d, len, c0, r,
                                                           root, kk, wd, wi, th, ed, ei, ld, li);
          break;
        case METRIC_EUCLID_DOT_SQ:
          scan_leaf_tile<DMAX, METRIC_EUCLID_DOT_SQ, REG>(xr, xsq, xs, ns, dp, d, len, c0, r,
                                                          root, kk, wd, wi, th, ed, ei, ld, li);
          break;
        case METRIC_MANHATTAN:
          scan_leaf_tile<DMAX, METRIC_MANHATTAN, REG>(xr, xsq, xs, ns, dp, d, len, c0, r, root,
                                                      kk, wd, wi, th, ed, ei, ld, li);
          break;
        case METRIC_COSINE:
          scan_leaf_tile<DMAX, METRIC_COSINE, REG>(xr, xsq, xs, ns, dp, d, len, c0, r, root, kk,
                                                   wd, wi, th, ed, ei, ld, li);
          break;
        default:
          scan_leaf_tile<DMAX, METRIC_SUPREMUM, REG>(xr, xsq, xs, ns, dp, d, len, c0, r, root,
                                                     kk, wd, wi, th, ed, ei, ld, li);
          break;
      }
    }
    __syncthreads();
  }
  if (row_ok) {
    leaf_epilogue<REG>(ed, ei, ld, li, a.lists, kk, mem, a.sentinel, a.out_d + row * kk,
                       a.out_i + row * kk);
  }
}

// Wide d: no tile; lane l's column is read from device memory and its
// rooted distance taken by pair_distance_ptr (features in ascending order).
template <bool REG>
__global__ void __launch_bounds__(LEAF_THREADS) leaf_topk_wide_kernel(LeafArgs a) {
  extern __shared__ float lsm[];
  const int d = a.d, L = a.L, kk = a.kk, lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / a.row_blocks;
  const int r = (blockIdx.x - b * a.row_blocks) * LEAF_WARPS + warp;
  if (r >= L) return;  // the warp's own work only: no block barrier follows
  const int32_t* mem = a.members + (int64_t)b * L;
  const uint8_t* msk = a.mask + (int64_t)b * L;
  const int64_t row = (int64_t)b * L + r;
  const bool normed = uses_norms(a.metric);
  const float* xr = a.data + (int64_t)mem[r] * d;
  const float xr_sq = normed ? norm_slot(sq_norm_ptr(xr, d), a.metric) : 0.0f;
  float* ld = nullptr;
  int32_t* li = nullptr;
  leaf_list(a, lsm, row, ld, li);
  float wd = CUDART_INF_F, th = CUDART_INF_F, ed = CUDART_INF_F;
  int32_t wi = LEX_ID_MAX, ei = LEX_ID_MAX;
  const int steps = (L + 31) / 32;
  for (int i = 0; i < steps; ++i) {  // from the step holding r round the leaf
    const int t0 = (r / 32 + i < steps ? r / 32 + i : r / 32 + i - steps) * 32;
    const int t = t0 + lane;
    float v = CUDART_INF_F;
    if (t < L && msk[t]) {
      const float* xc = a.data + (int64_t)mem[t] * d;
      v = pair_distance_ptr(xr, xr_sq, xc, normed ? norm_slot(sq_norm_ptr(xc, d), a.metric) : 0.0f,
                            d, a.metric);
    }
    admit_step<REG>(v, t0, false, kk, wd, wi, th, ed, ei, ld, li);
  }
  leaf_epilogue<REG>(ed, ei, ld, li, a.lists, kk, mem, a.sentinel, a.out_d + row * kk,
                     a.out_i + row * kk);
}

template <class Kernel, class... Args>
static cudaError_t start(Kernel kern, unsigned blocks, size_t smem, cudaStream_t s,
                         Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<blocks, LEAF_THREADS, smem, s>>>(args...);
  return cudaGetLastError();
}

template <int DMAX>
static cudaError_t launch(const LeafArgs& a, unsigned blocks, int code, bool root, size_t smem,
                          cudaStream_t s) {
  if (a.lists == LEAF_LISTS_REGISTERS) {
    return start(leaf_topk_kernel<DMAX, true>, blocks, smem, s, a, code, root);
  }
  return start(leaf_topk_kernel<DMAX, false>, blocks, smem, s, a, code, root);
}

// Blocks of a launch on B leaves of L slots (a warp a slot, LEAF_WARPS
// slots a block, no block shared by two leaves), for reports of its size.
extern "C" int forest_leaf_blocks(int B, int L) {
  if (B <= 0 || L <= 0) return 0;
  return B * ((L + LEAF_WARPS - 1) / LEAF_WARPS);
}

extern "C" int forest_leaf_topk_launch(const void* data, int d, const void* members,
                                       const void* mask, int B, int L, int kk, int metric,
                                       int sentinel, const void* mu, void* out_d, void* out_i,
                                       void* stream) {
  auto s = (cudaStream_t)stream;
  if (B <= 0 || L <= 0) return 0;
  if (kk < 1 || kk > L || d < 1 || metric < METRIC_EUCLID_DIFF ||
      (metric > METRIC_SUPREMUM && metric != METRIC_COSINE)) {
    return (int)cudaErrorInvalidValue;
  }
  const int lists = kk <= 32 ? LEAF_LISTS_REGISTERS
                    : (long)LEAF_WARPS * kk * 8 <= LEAF_LIST_BYTES ? LEAF_LISTS_SHARED
                                                                   : LEAF_LISTS_DEVICE;
  const int row_blocks = (L + LEAF_WARPS - 1) / LEAF_WARPS;
  if ((long)B * row_blocks > 2147483647L) return (int)cudaErrorInvalidValue;
  const bool wide = d > 128;
  if (mu != nullptr && (wide || kk > 128 || metric > METRIC_EUCLID_DOT)) {
    return (int)cudaErrorInvalidValue;  // bf16 stays within the fused gate, euclidean
  }
  const size_t list_bytes = lists == LEAF_LISTS_SHARED ? (size_t)LEAF_WARPS * kk * 8 : 0;
  const int dp = (d + 3) & ~3;
  int tile = 0;
  if (!wide) {
    tile = (LEAF_TILE_BYTES / 4) / (dp + 1);
    tile = tile > 1024 ? 1024 : (tile / 32) * 32;
  }
  LeafArgs a{(const float*)data, d, (const int32_t*)members, (const uint8_t*)mask, L, kk,
             metric, sentinel, (const float*)mu, row_blocks, tile, lists, (float*)out_d,
             (int32_t*)out_i};
  const unsigned blocks = (unsigned)(B * row_blocks);
  if (wide) {
    if (lists == LEAF_LISTS_REGISTERS) {
      return (int)start(leaf_topk_wide_kernel<true>, blocks, 0, s, a);
    }
    return (int)start(leaf_topk_wide_kernel<false>, blocks, list_bytes, s, a);
  }
  // bf16 runs the dot form's squared code on its centred, rounded operands.
  const int code = mu != nullptr ? METRIC_EUCLID_DOT_SQ
                   : metric == METRIC_EUCLID_DIFF ? METRIC_EUCLID_DIFF_SQ
                   : metric == METRIC_EUCLID_DOT  ? METRIC_EUCLID_DOT_SQ
                                                  : metric;
  const bool root = mu != nullptr || metric == METRIC_EUCLID_DIFF || metric == METRIC_EUCLID_DOT;
  const size_t smem = (size_t)tile * (dp + 1) * sizeof(float) + list_bytes;
  cudaError_t err;
  if (d <= 4) {
    err = launch<4>(a, blocks, code, root, smem, s);
  } else if (d <= 8) {
    err = launch<8>(a, blocks, code, root, smem, s);
  } else if (d <= 32) {
    err = launch<32>(a, blocks, code, root, smem, s);
  } else {
    err = launch<128>(a, blocks, code, root, smem, s);
  }
  return (int)err;
}
