// Per-pair distance arithmetic shared by the segment-min and k-NN kernels.
//
// The order of operations is the plain PyTorch version's
// (hdbscan_tpu_torch/core/distances.py): features accumulate one at a time
// in ascending order, with separate multiplies and adds. Built with
// -fmad=false, nvcc keeps every a*b+c as two roundings, so kernel and plain
// version agree bitwise; sqrtf stays IEEE-rounded (no fast math).
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

// Column tile width for a feature count: the tile (features, norm, and the
// per-kernel extras) stays within the default 48 KB of shared memory.
__host__ __forceinline__ int column_tile(int d, int extra_words) {
  int t = (48 * 1024 / 4) / (d + 1 + extra_words);
  t = t > 512 ? 512 : t;
  return (t / 32) * 32;
}
