// B6 forest_merge: the cross-tree fold of per-tree k-best lists.
//
// Replaces the TPU kernel hdbscan_tpu/ops/pallas_forest.py
// forest_merge_pallas (_tree_merge_kernel -> lexmerge.merge_tile_candidates).
// Input: T lists per row, (T, n, kk) float32 / int32, each ascending in the
// (distance, id) lex order with (+inf, sentinel) tails; ids, the sentinel
// among them, are non-negative (the narrow mode compares them unsigned).
// Output (n, kk): the trees folded in order t = 0 .. T - 1 into a running
// list R, which starts as kk slots of (+inf, sentinel):
//   - tree t's entry (d, id) is dropped when R holds id at a distance <= d,
//     or when it repeats the entry before it in its own list;
//   - an entry enters only with a finite distance;
//   - the new R is the kk lex-smallest of R and the entries that survive.
// So R may end up holding one id twice (a later tree's copy at a smaller
// distance enters beside the earlier one), as the reference's fold does. A
// global dedup of the concatenated lists is not this function: in bf16 mode
// B5 centres each leaf on its own mean, so one pair's copies in two trees
// carry two distances, and the dedup keeps only the smaller.
//
// Each surviving entry's slot in the new R is its rank: the R entries
// lex-below it plus the survivors before it in its own list. An R entry's
// slot is its own index plus the survivors lex-below it; no survivor equals
// an R entry, so a survivor with rank r_j in R lies below R[i] exactly when
// r_j <= i, and the R entries fill the slots no survivor takes, in order.
//
// Design, kk <= 32: a segment of W lanes (W the power of two >= kk) owns a
// row, 32 / W rows a warp (two at the fits' kk = 15), slot j in lane j;
// R lives in registers. Tree t's slice of a row is contiguous, so a warp
// reads its rows' entries in one coalesced load (tree t + 1's is in flight
// while tree t merges). The drop test and each entry's rank in R come from
// one shuffle round a slot of R's finite prefix, each a 64-bit compare of
// (distance key, id); a ballot gives the survivors before each entry; the
// survivors' slots form a mask (one __reduce_or_sync) and go through a
// per-warp shared buffer, and slot j of the new R that no survivor took is
// R slot j less the survivors below j, one shuffle away. After the last
// tree one coalesced store.
//
// kk > 32 (wide): a warp a row, R, the compacted survivors S and the new R
// in shared memory (24 kk bytes a warp), or, past MERGE_SMEM_BYTES a block,
// in a scratch slice of device memory a warp slot that the wrapper
// allocates, the grid then striding over the rows. The tree's entries go
// 32 at a time: the drop test and rank scan R's prefix up to the chunk's
// largest distance (broadcast reads), survivors go to S at their index and
// to the new R at their rank; each R entry's count of survivors below it
// comes by bisection in S.
//
// Nothing is sized by T. Bound on this card: bytes, T n kk entries read and
// n kk written, 8 bytes each; the shuffle rounds (about kk a tree a warp)
// are the work beside them.
#include <algorithm>
#include <cstdint>

#include "lexlist.cuh"

constexpr int MERGE_WARPS = 8;
constexpr int MERGE_THREADS = MERGE_WARPS * 32;
// Wide mode: shared memory a block's lists may take, and the grid's blocks
// when the lists lie in device memory.
constexpr long MERGE_SMEM_BYTES = 96 * 1024;
constexpr int MERGE_MEM_BLOCKS = 264;

__device__ __forceinline__ float2 pack(float d, int32_t i) {
  return make_float2(d, __int_as_float(i));
}

// An order-preserving unsigned key of a distance (-0 folded into +0): the
// keys of two distances compare as the distances do, so (key, id) as one
// 64-bit integer compares in the (distance, id) lex order.
__device__ __forceinline__ uint32_t dkey(float d) {
  const uint32_t b = __float_as_uint(d + 0.0f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

template <int W>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_narrow_kernel(const float* __restrict__ sd, const int32_t* __restrict__ si, int T, int n,
                    int kk, int sentinel, float* __restrict__ od, int32_t* __restrict__ oi) {
  constexpr int G = 32 / W;  // rows a warp
  constexpr unsigned WMASK = W == 32 ? 0xffffffffu : (1u << W) - 1;
  __shared__ float2 buf[MERGE_WARPS][32];
  const unsigned full = 0xffffffffu;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int seg = lane / W, j = lane % W, base = seg * W;
  const int row = (blockIdx.x * MERGE_WARPS + warp) * G + seg;
  const bool live = row < n && j < kk;
  const unsigned below = (WMASK << base) & ((1u << lane) - 1);  // this row's lanes before j
  const int64_t plane = (int64_t)n * kk;
  const int64_t at = (int64_t)row * kk + j;
  float rd = CUDART_INF_F;  // R slot j
  int32_t ri = sentinel;
  float td = CUDART_INF_F;  // tree t's entry j
  int32_t ti = sentinel;
  if (live) {
    td = sd[at];
    ti = si[at];
  }
  for (int t = 0; t < T; ++t) {
    float nd = CUDART_INF_F;
    int32_t ni = sentinel;
    if (live && t + 1 < T) {
      nd = sd[(t + 1) * plane + at];
      ni = si[(t + 1) * plane + at];
    }
    // R's finite prefix (its other slots are (+inf, sentinel), below no
    // finite entry and holding no real id): the drop test and the rank.
    const int lim = __reduce_max_sync(full, (live && rd < CUDART_INF_F) ? j + 1 : 0);
    const uint32_t rh = dkey(rd), th = dkey(td);
    const uint64_t tk = ((uint64_t)th << 32) | (uint32_t)ti;
    bool drop = false;
    int rank = 0;
    for (int s = 0; s < lim; ++s) {
      const uint32_t bh = __shfl_sync(full, rh, s, W);
      const int32_t bi = __shfl_sync(full, ri, s, W);
      drop |= bi == ti && bh <= th;
      rank += (((uint64_t)bh << 32) | (uint32_t)bi) < tk;
    }
    const float pd = __shfl_up_sync(full, td, 1, W);
    const int32_t pi = __shfl_up_sync(full, ti, 1, W);
    const bool copy = j > 0 && pd == td && pi == ti;
    const bool surv = live && fabsf(td) < CUDART_INF_F && !drop && !copy;
    const int pos = rank + __popc(__ballot_sync(full, surv) & below);
    const unsigned occ =
        (__reduce_or_sync(full, surv && pos < kk ? 1u << (base + pos) : 0u) >> base) & WMASK;
    // Slot j of the new R: a survivor's (from the buffer) where one took it,
    // else R slot j - (survivors below j), which moved up past them.
    const int src = j - __popc(occ & ((1u << j) - 1));
    const float md = __shfl_sync(full, rd, src, W);
    const int32_t mi = __shfl_sync(full, ri, src, W);
    float2* b = buf[warp] + base;
    __syncwarp();  // the last tree's reads of the buffer are done
    if (surv && pos < kk) b[pos] = pack(td, ti);
    __syncwarp();
    if (live) {
      const bool taken = (occ >> j) & 1u;
      const float2 e = taken ? b[j] : make_float2(md, __int_as_float(mi));
      rd = e.x;
      ri = __float_as_int(e.y);
    }
    td = nd;
    ti = ni;
  }
  if (live) {
    od[at] = rd;
    oi[at] = ri;
  }
}

// Grid-stride over rows, a warp a row; `lists` is the warp's 3 kk slots
// (R, S, new R) in shared memory, or the warp slot's in `scratch`.
__global__ void __launch_bounds__(MERGE_THREADS)
merge_wide_kernel(const float* __restrict__ sd, const int32_t* __restrict__ si, int T, int n,
                  int kk, int sentinel, float2* __restrict__ scratch,
                  float* __restrict__ od, int32_t* __restrict__ oi) {
  extern __shared__ float2 msm[];
  const unsigned full = 0xffffffffu;
  const int wpb = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1;
  const int slot = blockIdx.x * wpb + warp;
  float2* lists = scratch != nullptr ? scratch + (int64_t)slot * 3 * kk : msm + warp * 3 * kk;
  for (int row = slot; row < n; row += gridDim.x * wpb) {
    float2* R = lists;
    float2* S = lists + kk;
    float2* N = lists + 2 * kk;
    for (int s = lane; s < kk; s += 32) R[s] = pack(CUDART_INF_F, sentinel);
    __syncwarp();
    int rfin = 0;  // R's finite prefix
    for (int t = 0; t < T; ++t) {
      const float* td_ = sd + ((int64_t)t * n + row) * kk;
      const int32_t* ti_ = si + ((int64_t)t * n + row) * kk;
      int ns = 0;  // survivors so far
      float lastd = CUDART_INF_F;  // the previous chunk's last entry
      int32_t lasti = sentinel;
      for (int c0 = 0; c0 < kk; c0 += 32) {
        const int j = c0 + lane;
        float d = CUDART_INF_F;
        int32_t id = sentinel;
        if (j < kk) {
          d = td_[j];
          id = ti_[j];
        }
        float pd = __shfl_up_sync(full, d, 1);
        int32_t pi = __shfl_up_sync(full, id, 1);
        if (lane == 0) {
          pd = lastd;
          pi = lasti;
        }
        lastd = __shfl_sync(full, d, 31);
        lasti = __shfl_sync(full, id, 31);
        const bool fin = j < kk && fabsf(d) < CUDART_INF_F;
        const bool copy = j > 0 && pd == d && pi == id;
        const unsigned fm = __ballot_sync(full, fin);
        bool drop = false;
        int rank = 0;
        if (fm != 0) {
          // The list ascends: its last finite entry is the chunk's largest.
          const float dmax = __shfl_sync(full, d, 31 - __clz(fm));
          for (int s = 0; s < rfin; ++s) {
            const float2 e = R[s];
            if (e.x > dmax) break;
            const int32_t ei = __float_as_int(e.y);
            drop |= ei == id && e.x <= d;
            rank += lex_less(e.x, ei, d, id);
          }
        }
        const bool surv = fin && !drop && !copy;
        const unsigned sb = __ballot_sync(full, surv);
        const int sj = ns + __popc(sb & lt);
        const int pos = rank + sj;
        if (surv && sj < kk) S[sj] = pack(d, id);
        if (surv && pos < kk) N[pos] = pack(d, id);
        ns += __popc(sb);
      }
      __syncwarp();
      const int nsk = min(ns, kk);
      for (int i = lane; i < kk; i += 32) {
        const float2 e = R[i];
        const int32_t ei = __float_as_int(e.y);
        int lo = 0, hi = nsk;  // survivors lex-below R[i]
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          const float2 x = S[mid];
          if (lex_less(x.x, __float_as_int(x.y), e.x, ei)) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        if (i + lo < kk) N[i + lo] = e;
      }
      __syncwarp();
      float2* old = R;
      R = N;
      N = old;
      rfin = min(kk, rfin + ns);
    }
    const int64_t o = (int64_t)row * kk;
    for (int s = lane; s < kk; s += 32) {
      const float2 e = R[s];
      od[o + s] = e.x;
      oi[o + s] = __float_as_int(e.y);
    }
    __syncwarp();
  }
}

// Wide-mode launch shape: warps a block and, when the lists lie in device
// memory, the grid's blocks (0 when they fit in shared memory).
static void wide_plan(int n, int kk, int* wpb, int* mem_blocks) {
  const long per_warp = 24L * kk;
  const long fit = MERGE_SMEM_BYTES / per_warp;
  *wpb = fit >= 1 ? (int)std::min(fit, (long)MERGE_WARPS) : MERGE_WARPS;
  *mem_blocks = fit >= 1 ? 0 : std::min(MERGE_MEM_BLOCKS, (n + MERGE_WARPS - 1) / MERGE_WARPS);
}

// Warp slots whose 3 kk-slot lists (8 bytes a slot) the wrapper allocates
// in device memory for a launch on n rows at kk; 0 when none is needed.
extern "C" int forest_merge_slots(int n, int kk) {
  if (n <= 0 || kk <= 32) return 0;
  int wpb, mem_blocks;
  wide_plan(n, kk, &wpb, &mem_blocks);
  return mem_blocks * MERGE_WARPS;
}

template <int W>
static cudaError_t launch_narrow(const float* sd, const int32_t* si, int T, int n, int kk,
                                 int sentinel, float* od, int32_t* oi, cudaStream_t s) {
  const int rows = MERGE_WARPS * (32 / W);
  merge_narrow_kernel<W><<<(n + rows - 1) / rows, MERGE_THREADS, 0, s>>>(sd, si, T, n, kk,
                                                                          sentinel, od, oi);
  return cudaGetLastError();
}

extern "C" int forest_merge_launch(const void* sd, const void* si, int T, int n, int kk,
                                   int sentinel, void* scratch, void* od, void* oi,
                                   void* stream) {
  auto* d = (const float*)sd;
  auto* i = (const int32_t*)si;
  auto* outd = (float*)od;
  auto* outi = (int32_t*)oi;
  auto s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (T < 1 || kk < 1) return (int)cudaErrorInvalidValue;
  if (kk <= 2) return (int)launch_narrow<2>(d, i, T, n, kk, sentinel, outd, outi, s);
  if (kk <= 4) return (int)launch_narrow<4>(d, i, T, n, kk, sentinel, outd, outi, s);
  if (kk <= 8) return (int)launch_narrow<8>(d, i, T, n, kk, sentinel, outd, outi, s);
  if (kk <= 16) return (int)launch_narrow<16>(d, i, T, n, kk, sentinel, outd, outi, s);
  if (kk <= 32) return (int)launch_narrow<32>(d, i, T, n, kk, sentinel, outd, outi, s);
  int wpb, mem_blocks;
  wide_plan(n, kk, &wpb, &mem_blocks);
  if (mem_blocks > 0) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    merge_wide_kernel<<<mem_blocks, MERGE_THREADS, 0, s>>>(d, i, T, n, kk, sentinel,
                                                            (float2*)scratch, outd, outi);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)wpb * 24 * kk;
  cudaError_t err = cudaFuncSetAttribute(merge_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  merge_wide_kernel<<<(n + wpb - 1) / wpb, wpb * 32, smem, s>>>(d, i, T, n, kk, sentinel,
                                                                nullptr, outd, outi);
  return (int)cudaGetLastError();
}
