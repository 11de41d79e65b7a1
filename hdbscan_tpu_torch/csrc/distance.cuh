// Per-pair distance arithmetic shared by the segment-min and k-NN kernels.
//
// The order of operations is the plain PyTorch version's
// (hdbscan_tpu_torch/core/distances.py): features accumulate one at a time
// in ascending order, with separate multiplies and adds. Built with
// -fmad=false, nvcc keeps every a*b+c as two roundings, so kernel and plain
// version agree bitwise; sqrtf stays IEEE-rounded (no fast math). The
// register forms below take d <= DMAX <= 128; the wide mode (further down)
// takes any d in chunks, with the same sums.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

// Metric codes, shared with the Python wrappers (ops/cuda_build.METRIC_CODES).
enum : int {
  METRIC_EUCLID_DIFF = 0,  // sqrt(sum (x_f - y_f)^2)
  METRIC_EUCLID_DOT = 1,   // sqrt(max((|x|^2 + |y|^2) - 2 x.y, 0))
  METRIC_MANHATTAN = 2,    // sum |x_f - y_f|
  METRIC_SUPREMUM = 3,     // max |x_f - y_f|
  METRIC_EUCLID_DIFF_SQ = 4,  // sum (x_f - y_f)^2, no root (B3)
  METRIC_EUCLID_DOT_SQ = 5,   // max((|x|^2 + |y|^2) - 2 x.y, 0), no root (B3)
};

// Whether a metric code takes the dot form's per-column norms.
__host__ __device__ __forceinline__ bool dot_form(int metric) {
  return metric == METRIC_EUCLID_DOT || metric == METRIC_EUCLID_DOT_SQ;
}

// Squared norm in the dot form's order.
template <int DMAX>
__device__ __forceinline__ float sq_norm(const float* x, int d) {
  float acc = x[0] * x[0];
#pragma unroll
  for (int f = 1; f < DMAX; ++f) {
    if (f < d) acc = acc + x[f] * x[f];
  }
  return acc;
}

// Distance between a row held in registers (xr, norm xr_sq) and a column in
// shared memory (xc, norm xc_sq; the norms are used by the dot form only).
template <int DMAX>
__device__ __forceinline__ float pair_distance(
    const float (&xr)[DMAX], float xr_sq, const float* xc, float xc_sq, int d,
    int metric) {
  if (metric == METRIC_EUCLID_DIFF || metric == METRIC_EUCLID_DIFF_SQ) {
    float t = xr[0] - xc[0];
    float acc = t * t;
#pragma unroll
    for (int f = 1; f < DMAX; ++f) {
      if (f < d) {
        t = xr[f] - xc[f];
        acc = acc + t * t;
      }
    }
    return metric == METRIC_EUCLID_DIFF ? sqrtf(acc) : acc;
  }
  if (dot_form(metric)) {
    float cross = xr[0] * xc[0];
#pragma unroll
    for (int f = 1; f < DMAX; ++f) {
      if (f < d) cross = cross + xr[f] * xc[f];
    }
    const float d2 = fmaxf((xr_sq + xc_sq) - 2.0f * cross, 0.0f);
    return metric == METRIC_EUCLID_DOT ? sqrtf(d2) : d2;
  }
  float acc = fabsf(xr[0] - xc[0]);
#pragma unroll
  for (int f = 1; f < DMAX; ++f) {
    if (f < d) {
      float a = fabsf(xr[f] - xc[f]);
      acc = metric == METRIC_MANHATTAN ? acc + a : fmaxf(acc, a);
    }
  }
  return acc;
}

// ---- Register micro-tiles: RB rows a thread against one column ----------
//
// The segment-min and k-best bodies hold RB rows of a thread in registers
// and read each column's features once from shared memory for all RB
// rows. The euclidean codes run on squared distances (codes 4/5); each
// body takes a root only for a pair under its own bound on what can win
// (see their headers).

// One feature f of one column (value c) into the RB rows' values.
template <int DMAX, int RB, int CODE>
__device__ __forceinline__ void feature_step(const float (&xr)[RB][DMAX], int f, float c,
                                             float (&v)[RB]) {
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (CODE == METRIC_EUCLID_DIFF_SQ) {
      const float t = xr[r][f] - c;
      v[r] = f == 0 ? t * t : v[r] + t * t;
    } else if (CODE == METRIC_EUCLID_DOT_SQ) {
      v[r] = f == 0 ? xr[r][f] * c : v[r] + xr[r][f] * c;
    } else {
      const float a = fabsf(xr[r][f] - c);
      v[r] = f == 0 ? a : CODE == METRIC_MANHATTAN ? v[r] + a : fmaxf(v[r], a);
    }
  }
}

// Values of one column (features xc, float4-aligned; norm xc_sq) for the RB
// rows of a thread: squared euclidean (codes 4/5) or manhattan/supremum.
// Features go in float4 groups; only the last, partial group tests each
// feature against d (a uniform branch per group, not per feature).
template <int DMAX, int RB, int CODE>
__device__ __forceinline__ void column_values(const float (&xr)[RB][DMAX],
                                              const float (&xsq)[RB],
                                              const float* xc, float xc_sq, int d,
                                              float (&v)[RB]) {
#pragma unroll
  for (int f4 = 0; f4 < DMAX; f4 += 4) {
    if (f4 < d) {
      const float4 c4 = *reinterpret_cast<const float4*>(xc + f4);
      const float c[4] = {c4.x, c4.y, c4.z, c4.w};
      if (f4 + 4 <= d) {
#pragma unroll
        for (int u = 0; u < 4; ++u) feature_step<DMAX, RB, CODE>(xr, f4 + u, c[u], v);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (f4 + u < d) feature_step<DMAX, RB, CODE>(xr, f4 + u, c[u], v);
        }
      }
    }
  }
  if (CODE == METRIC_EUCLID_DOT_SQ) {
#pragma unroll
    for (int r = 0; r < RB; ++r) v[r] = fmaxf((xsq[r] + xc_sq) - 2.0f * v[r], 0.0f);
  }
}

// The same distances with both points behind pointers, for any d (a
// runtime loop in the same order): the wide mode of the gather kernels
// (B7, B8), whose columns are each thread's own candidates.
__device__ __forceinline__ float sq_norm_ptr(const float* x, int d) {
  float acc = x[0] * x[0];
  for (int f = 1; f < d; ++f) acc = acc + x[f] * x[f];
  return acc;
}

__device__ __forceinline__ float pair_distance_ptr(const float* xr, float xr_sq,
                                                   const float* xc, float xc_sq,
                                                   int d, int metric) {
  if (metric == METRIC_EUCLID_DIFF || metric == METRIC_EUCLID_DIFF_SQ) {
    float t = xr[0] - xc[0];
    float acc = t * t;
    for (int f = 1; f < d; ++f) {
      t = xr[f] - xc[f];
      acc = acc + t * t;
    }
    return metric == METRIC_EUCLID_DIFF ? sqrtf(acc) : acc;
  }
  if (dot_form(metric)) {
    float cross = xr[0] * xc[0];
    for (int f = 1; f < d; ++f) cross = cross + xr[f] * xc[f];
    const float d2 = fmaxf((xr_sq + xc_sq) - 2.0f * cross, 0.0f);
    return metric == METRIC_EUCLID_DOT ? sqrtf(d2) : d2;
  }
  float acc = fabsf(xr[0] - xc[0]);
  for (int f = 1; f < d; ++f) {
    const float a = fabsf(xr[f] - xc[f]);
    acc = metric == METRIC_MANHATTAN ? acc + a : fmaxf(acc, a);
  }
  return acc;
}

// ---- Wide mode: any d, features in chunks ---------------------------------
//
// The register kernels hold a row in DMAX <= 128 registers and a column
// tile with all its features in shared memory. Past d = 128 (and past
// k = 128, whose lists leave registers; lexlist.cuh) the tile kernels run
// their wide mode: the distances of a block's rows to a sub-tile of
// WIDE_COLS columns go through in chunks of WIDE_CHUNK features. The block
// stages each thread's row chunk and the columns' chunk in shared memory,
// and each thread carries one accumulator per column across the chunks.
// Features still accumulate one at a time in ascending order with separate
// multiplies and adds, and the dot form's norms come from the same chunks in
// the same order, so every sum is the plain version's, bitwise, whatever d.
constexpr int WIDE_COLS = 32;   // columns per sub-tile (accumulators a thread carries)
constexpr int WIDE_CHUNK = 16;  // features per chunk
constexpr int WIDE_STRIDE = WIDE_CHUNK + 1;  // padded rows: no bank conflicts

// Shared-memory floats wide_distances uses for a block of `threads` rows:
// the columns' chunk, their norms, and the rows' chunks.
__host__ __device__ constexpr int wide_smem_floats(int threads) {
  return WIDE_COLS * WIDE_STRIDE + WIDE_COLS + threads * WIDE_STRIDE;
}

enum : int { WIDE_DIFF = 0, WIDE_DOT = 1, WIDE_MANHATTAN = 2, WIDE_SUPREMUM = 3 };

template <int FAMILY>
__device__ __forceinline__ float wide_term(float x, float c) {
  if (FAMILY == WIDE_DIFF) {
    const float u = x - c;
    return u * u;
  }
  if (FAMILY == WIDE_DOT) return x * c;
  return fabsf(x - c);
}

// One chunk's contribution to the WIDE_COLS accumulators (columns past the
// sub-tile's length hold zeros and are ignored by the caller). `first`: the
// chunk holds feature 0, whose term starts each sum.
template <int FAMILY>
__device__ __forceinline__ void wide_chunk(float (&acc)[WIDE_COLS], const float* rs,
                                           const float* cs, int fl, bool first) {
  int f = 0;
  if (first) {
    const float x = rs[0];
#pragma unroll
    for (int t = 0; t < WIDE_COLS; ++t) acc[t] = wide_term<FAMILY>(x, cs[t * WIDE_STRIDE]);
    f = 1;
  }
  for (; f < fl; ++f) {
    const float x = rs[f];
#pragma unroll
    for (int t = 0; t < WIDE_COLS; ++t) {
      const float term = wide_term<FAMILY>(x, cs[t * WIDE_STRIDE + f]);
      acc[t] = FAMILY == WIDE_SUPREMUM ? fmaxf(acc[t], term) : acc[t] + term;
    }
  }
}

// Distances (by metric code, roots included for codes 0/1) of the calling
// thread's row `row` (nullptr: a padding thread; its values are unused) to
// the columns col(0), ..., col(len - 1), len <= WIDE_COLS, into dist[0..len).
// Every thread of the block must call it (it synchronises); `smem` holds
// wide_smem_floats(blockDim.x) floats. `row_sq` is the row's norm (dot
// form; from sq_norm_ptr).
template <class ColPtr>
__device__ __forceinline__ void wide_distances(const float* row, float row_sq,
                                               ColPtr col, int len, int d,
                                               int metric, float* smem,
                                               float (&dist)[WIDE_COLS]) {
  float* cs = smem;                            // WIDE_COLS x WIDE_STRIDE
  float* ns = cs + WIDE_COLS * WIDE_STRIDE;    // WIDE_COLS norms
  float* rs = ns + WIDE_COLS + threadIdx.x * WIDE_STRIDE;  // this thread's row chunk
  const bool dot = dot_form(metric);
  const int family = (metric == METRIC_EUCLID_DIFF || metric == METRIC_EUCLID_DIFF_SQ)
                         ? WIDE_DIFF
                         : dot ? WIDE_DOT
                               : metric == METRIC_MANHATTAN ? WIDE_MANHATTAN
                                                            : WIDE_SUPREMUM;
  float cnorm = 0.0f;  // thread t < len: column t's norm
  for (int f0 = 0; f0 < d; f0 += WIDE_CHUNK) {
    const int fl = min(WIDE_CHUNK, d - f0);
    __syncthreads();  // the previous chunk (or call) is consumed
    for (int e = threadIdx.x; e < WIDE_COLS * WIDE_CHUNK; e += blockDim.x) {
      const int t = e / WIDE_CHUNK, f = e - t * WIDE_CHUNK;
      cs[t * WIDE_STRIDE + f] = (t < len && f < fl) ? col(t)[f0 + f] : 0.0f;
    }
    for (int f = 0; f < fl; ++f) rs[f] = row != nullptr ? row[f0 + f] : 0.0f;
    __syncthreads();
    if (dot && threadIdx.x < len) {
      const float* c = cs + threadIdx.x * WIDE_STRIDE;
      for (int f = 0; f < fl; ++f) {
        cnorm = (f0 == 0 && f == 0) ? c[0] * c[0] : cnorm + c[f] * c[f];
      }
    }
    const bool first = f0 == 0;
    switch (family) {
      case WIDE_DIFF: wide_chunk<WIDE_DIFF>(dist, rs, cs, fl, first); break;
      case WIDE_DOT: wide_chunk<WIDE_DOT>(dist, rs, cs, fl, first); break;
      case WIDE_MANHATTAN: wide_chunk<WIDE_MANHATTAN>(dist, rs, cs, fl, first); break;
      default: wide_chunk<WIDE_SUPREMUM>(dist, rs, cs, fl, first); break;
    }
  }
  if (dot && threadIdx.x < len) ns[threadIdx.x] = cnorm;
  __syncthreads();
  const bool root = metric == METRIC_EUCLID_DIFF || metric == METRIC_EUCLID_DOT;
#pragma unroll
  for (int t = 0; t < WIDE_COLS; ++t) {
    float v = dist[t];
    if (dot) v = fmaxf((row_sq + (t < len ? ns[t] : 0.0f)) - 2.0f * v, 0.0f);
    dist[t] = root ? sqrtf(v) : v;
  }
}

// Column tile width for a feature count: the tile (features, norm, and the
// per-kernel extras) stays within the default 48 KB of shared memory.
__host__ __forceinline__ int column_tile(int d, int extra_words) {
  int t = (48 * 1024 / 4) / (d + 1 + extra_words);
  t = t > 512 ? 512 : t;
  return (t / 32) * 32;
}
