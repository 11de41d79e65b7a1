// K1 segmin: per-row minimum outgoing mutual-reachability edge of one
// Borůvka round.
//
// Replaces the TPU kernel hdbscan_tpu/ops/pallas_segmin.py
// min_outgoing_pallas (_segmin_kernel). For every row i:
//   best_w[i] = min over valid j with comp[j] != comp[i] of
//               max(dist(i, j), core[i], core[j]),
//   best_j[i] = the lowest such j reaching the minimum,
// and (+inf, -1) where no such j exists or row i is not valid.
//
// Design: one thread per row holds its point in registers and the running
// (bw, bj); the block walks the columns in ascending tiles staged through
// shared memory (features, dot-form norm, core, comp, valid), so each
// column is read from device memory once per block. The strict `<` update
// over ascending j is what makes the lowest j win, as the reference's
// first-hit argmin plus strict cross-tile update does.
//
// Bound on this card: operations. Every round evaluates all n^2 pairs
// (about 3d + 6 float operations each, plus one sqrt) on the FP32 pipes;
// device-memory traffic is O(n d) per block and stays in L2. Shared-memory
// reads are broadcasts (all threads of a warp read the same column).
#include <cstdint>

#include "distance.cuh"

template <int DMAX>
__global__ void segmin_kernel(const float* __restrict__ x,
                              const float* __restrict__ core,
                              const int32_t* __restrict__ comp,
                              const uint8_t* __restrict__ valid, int n, int d,
                              int metric, int tile, float* __restrict__ best_w,
                              int32_t* __restrict__ best_j) {
  extern __shared__ float smem[];
  float* xs = smem;                      // tile * d features
  float* ns = xs + tile * d;             // tile norms (dot form)
  float* cs = ns + tile;                 // tile core distances
  int32_t* ks = (int32_t*)(cs + tile);   // tile labels, -1 = not valid

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool row_ok = i < n && valid[i] != 0;
  float xr[DMAX];
#pragma unroll
  for (int f = 0; f < DMAX; ++f) xr[f] = (row_ok && f < d) ? x[(int64_t)i * d + f] : 0.0f;
  const float xr_sq = sq_norm<DMAX>(xr, d);
  const float cr = row_ok ? core[i] : 0.0f;
  const int32_t kr = row_ok ? comp[i] : -1;

  float bw = CUDART_INF_F;
  int32_t bj = -1;
  for (int c0 = 0; c0 < n; c0 += tile) {
    const int len = min(tile, n - c0);
    for (int t = threadIdx.x; t < len * d; t += blockDim.x) {
      xs[t] = x[(int64_t)c0 * d + t];
    }
    for (int t = threadIdx.x; t < len; t += blockDim.x) {
      cs[t] = core[c0 + t];
      ks[t] = valid[c0 + t] != 0 ? comp[c0 + t] : -1;
    }
    __syncthreads();
    if (metric == METRIC_EUCLID_DOT) {
      for (int t = threadIdx.x; t < len; t += blockDim.x) {
        const float* xc = xs + t * d;
        float acc = xc[0] * xc[0];
        for (int f = 1; f < d; ++f) acc = acc + xc[f] * xc[f];
        ns[t] = acc;
      }
      __syncthreads();
    }
    if (row_ok) {
      for (int t = 0; t < len; ++t) {
        const int32_t kc = ks[t];
        if (kc < 0 || kc == kr) continue;
        const float dist = pair_distance<DMAX>(xr, xr_sq, xs + t * d, ns[t], d, metric);
        const float w = fmaxf(dist, fmaxf(cr, cs[t]));
        if (w < bw) {
          bw = w;
          bj = c0 + t;
        }
      }
    }
    __syncthreads();
  }
  if (i < n) {
    best_w[i] = bw;
    best_j[i] = bj;
  }
}

template <int DMAX>
static cudaError_t launch(const float* x, const float* core, const int32_t* comp,
                          const uint8_t* valid, int n, int d, int metric,
                          float* best_w, int32_t* best_j, cudaStream_t stream) {
  const int threads = 256;
  const int tile = column_tile(d, 3);
  const size_t smem = (size_t)tile * (d + 3) * sizeof(float);
  const int blocks = (n + threads - 1) / threads;
  segmin_kernel<DMAX><<<blocks, threads, smem, stream>>>(
      x, core, comp, valid, n, d, metric, tile, best_w, best_j);
  return cudaGetLastError();
}

extern "C" int segmin_launch(const void* x, const void* core, const void* comp,
                             const void* valid, int n, int d, int metric,
                             void* best_w, void* best_j, void* stream) {
  auto* xf = (const float*)x;
  auto* cf = (const float*)core;
  auto* kf = (const int32_t*)comp;
  auto* vf = (const uint8_t*)valid;
  auto* bw = (float*)best_w;
  auto* bj = (int32_t*)best_j;
  auto s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (d <= 4) return launch<4>(xf, cf, kf, vf, n, d, metric, bw, bj, s);
  if (d <= 8) return launch<8>(xf, cf, kf, vf, n, d, metric, bw, bj, s);
  if (d <= 32) return launch<32>(xf, cf, kf, vf, n, d, metric, bw, bj, s);
  if (d <= 128) return launch<128>(xf, cf, kf, vf, n, d, metric, bw, bj, s);
  return (int)cudaErrorInvalidValue;
}
