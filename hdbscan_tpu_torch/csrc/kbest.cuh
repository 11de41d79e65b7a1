// The k-best scan body shared by the k-NN kernels: K2/B2/B3
// (knn_kbest.cu) and B4 (knn_window.cu).
//
// A thread holds R rows in registers and scans a column tile staged in
// shared memory, C columns a step (cols_per_step), each column's features
// read once as float4 for its R rows (distance.cuh column_values). A row's
// list has k (distance, id) slots, ascending; slot s of row r lies at
// ld[r * row_step + s * stride] (li likewise), so the caller places it:
// interleaved thread by thread in shared memory (stride = threads), or in
// the row's own output in device memory (stride 1).
//
// The rule that fixes every bit: a list takes a column only when it is
// strictly closer than the current k-th entry, and places it after every
// entry of equal distance. Over ascending ids that is the (distance, id)
// lex k-best.
//
// The euclidean codes run on squared distances (codes 4/5): a row's
// admission bound is the float after fl(w * w), w its k-th distance, which
// every v with sqrtf(v) < w lies below (admit_bound); a candidate under
// the bound takes sqrtf and enters iff sqrtf(v) < w, the rooted test
// itself. The insert finds its slot by bisection and moves the entries
// behind it KB_SHIFT at a time (list_insert).
#pragma once

#include <cstdint>

#include "distance.cuh"

// Columns a thread takes per step of its scan (one vote for all of them):
// two independent sums where the rows' features leave the registers for
// them (d <= 32), one above.
__host__ __device__ constexpr int cols_per_step(int dmax) { return dmax <= 32 ? 2 : 1; }

// Admission bound for a list whose k-th distance is w: every candidate that
// can enter lies below it. For the rooted codes the candidate is a squared
// distance v and enters iff sqrtf(v) < w; sqrtf is correctly rounded and
// monotone, so that implies v < w * w (exactly), below the float after
// fl(w * w). The caller confirms sqrtf(v) < w before inserting.
__device__ __forceinline__ float admit_bound(float w, bool root) {
  return root ? nextafterf(w * w, CUDART_INF_F) : w;
}

// Entries an insert moves per batch: the batch's loads are independent.
constexpr int KB_SHIFT = 8;

// Insert (dist, id) into a k-slot list whose slot s lies at ld[s * stride]
// (li[s * stride]), after every entry <= dist; the last slot falls off. The
// caller has checked that dist is below slot k - 1. The place is found by
// bisection and the entries behind it move KB_SHIFT at a time, so an insert
// waits on about log2(k) + (k - place) / KB_SHIFT loads in turn, not on
// k - place of them.
template <bool IDS>
__device__ __forceinline__ void list_insert(float* ld, int32_t* li, int stride, int k,
                                            float dist, int32_t id) {
  int lo = 0, hi = k - 1;  // the first slot whose entry is above dist
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ld[mid * stride] > dist) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  for (int s = k - 1; s > lo; s -= KB_SHIFT) {
    float bd[KB_SHIFT];
    int32_t bi[KB_SHIFT];
#pragma unroll
    for (int u = 0; u < KB_SHIFT; ++u) {
      if (s - 1 - u >= lo) {
        bd[u] = ld[(s - 1 - u) * stride];
        if (IDS) bi[u] = li[(s - 1 - u) * stride];
      }
    }
#pragma unroll
    for (int u = 0; u < KB_SHIFT; ++u) {
      if (s - 1 - u >= lo) {
        ld[(s - u) * stride] = bd[u];
        if (IDS) li[(s - u) * stride] = bi[u];
      }
    }
  }
  ld[lo * stride] = dist;
  if (IDS) li[lo * stride] = id;
}

// Row r's candidate (squared for the rooted codes) v from column id: enters
// the list (ld, li; slot stride `stride`) when its distance is below the
// k-th, w; w and the admission bound th follow the list.
template <bool IDS>
__device__ __forceinline__ void admit(float* ld, int32_t* li, int stride, int k, float v,
                                      int32_t id, bool root, float& w, float& th) {
  const float dist = root ? sqrtf(v) : v;
  if (dist < w) {
    list_insert<IDS>(ld, li, stride, k, dist, id);
    w = ld[(k - 1) * stride];
    th = admit_bound(w, root);
  }
}

// One tile's columns (features xs at stride dp, norms ns, ids from id0)
// against a thread's R rows, C columns a step. Row r's list starts at
// ld/li + r * row_step, its slots `stride` apart; w and th hold each row's
// k-th distance and admission bound. Within a step a row takes its columns
// in ascending id, each tested against the bound its predecessor left.
template <int DMAX, int R, int CODE, bool IDS>
__device__ __forceinline__ void scan_tile(const float (&xr)[R][DMAX], const float (&xsq)[R],
                                          const float* xs, const float* ns, int dp, int d,
                                          int len, int32_t id0, bool root, int k, float* ld,
                                          int32_t* li, int stride, int row_step,
                                          float (&w)[R], float (&th)[R]) {
  constexpr int C = cols_per_step(DMAX);
  for (int t0 = 0; t0 < len; t0 += C) {
    const int cols = min(C, len - t0);
    float v[C][R];
    bool hit = false;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int t = t0 + (c < cols ? c : 0);
      column_values<DMAX, R, CODE>(xr, xsq, xs + t * dp, ns[t], d, v[c]);
#pragma unroll
      for (int r = 0; r < R; ++r) hit |= (c < cols) & (v[c][r] < th[r]);
    }
    if (__any_sync(0xffffffffu, hit)) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float* lr = ld + r * row_step;
        int32_t* lir = IDS ? li + r * row_step : nullptr;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (c < cols && v[c][r] < th[r]) admit<IDS>(lr, lir, stride, k, v[c][r],
                                                      id0 + t0 + c, root, w[r], th[r]);
        }
      }
    }
  }
}

// Stage columns [c0, c0 + len) of the row-major (., d) points x into the
// tile xs (stride dp, float4-aligned rows); in the dot form (code 5) and at
// cosine (code 6) their norm slots go to ns, in sq_norm's order. Every thread of the block calls it;
// it synchronises. nthreads is the block's thread count: K2 passes its
// compile-time KB_THREADS, since a runtime stride (blockDim.x) here made K2
// and B3 4-10% slower (PERF.md §6).
__device__ __forceinline__ void stage_tile(const float* __restrict__ x, int64_t c0, int len,
                                           int d, int dp, int code, float* xs, float* ns,
                                           int nthreads) {
  for (int e = threadIdx.x; e < len * d; e += nthreads) {
    const int t = e / d;
    xs[t * dp + (e - t * d)] = x[c0 * d + e];
  }
  __syncthreads();
  if (uses_norms(code)) {
    for (int t = threadIdx.x; t < len; t += nthreads) {
      const float* xc = xs + t * dp;
      float acc = xc[0] * xc[0];
      for (int f = 1; f < d; ++f) acc = acc + xc[f] * xc[f];
      ns[t] = norm_slot(acc, code);
    }
    __syncthreads();
  }
}
