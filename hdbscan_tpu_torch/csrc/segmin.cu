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
// Design: one thread per row holds its point in registers and the running
// (bw, bj); the block walks the columns in ascending tiles staged through
// shared memory (features, dot-form norm, core, comp, valid), so each
// column is read from device memory once per block. The strict `<` update
// over ascending j is what makes the lowest j win, as the reference's
// first-hit argmin plus strict cross-tile update does.
//
// Bound on this card: operations. Every round evaluates all row x column
// pairs (about 3d + 6 float operations each, plus one sqrt) on the FP32
// pipes; device-memory traffic is O(columns d) per block and stays in L2.
// Shared-memory reads are broadcasts (all threads of a warp read the same
// column).
#include <cstdint>

#include "distance.cuh"

template <int DMAX>
__global__ void segmin_kernel(const float* __restrict__ xr_g,
                              const float* __restrict__ core_r,
                              const int32_t* __restrict__ comp_r,
                              const uint8_t* __restrict__ valid_r, int nr,
                              const float* __restrict__ xc_g,
                              const float* __restrict__ core_c,
                              const int32_t* __restrict__ comp_c,
                              const uint8_t* __restrict__ valid_c, int nc,
                              int d, int metric, int tile,
                              float* __restrict__ best_w,
                              int32_t* __restrict__ best_j) {
  extern __shared__ float smem[];
  float* xs = smem;                      // tile * d features
  float* ns = xs + tile * d;             // tile norms (dot form)
  float* cs = ns + tile;                 // tile core distances
  int32_t* ks = (int32_t*)(cs + tile);   // tile labels, -1 = not valid

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool row_ok = i < nr && valid_r[i] != 0;
  float xr[DMAX];
#pragma unroll
  for (int f = 0; f < DMAX; ++f) xr[f] = (row_ok && f < d) ? xr_g[(int64_t)i * d + f] : 0.0f;
  const float xr_sq = sq_norm<DMAX>(xr, d);
  const float cr = row_ok ? core_r[i] : 0.0f;
  const int32_t kr = row_ok ? comp_r[i] : -1;

  float bw = CUDART_INF_F;
  int32_t bj = -1;
  for (int c0 = 0; c0 < nc; c0 += tile) {
    const int len = min(tile, nc - c0);
    for (int t = threadIdx.x; t < len * d; t += blockDim.x) {
      xs[t] = xc_g[(int64_t)c0 * d + t];
    }
    for (int t = threadIdx.x; t < len; t += blockDim.x) {
      cs[t] = core_c[c0 + t];
      ks[t] = valid_c[c0 + t] != 0 ? comp_c[c0 + t] : -1;
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
  if (i < nr) {
    best_w[i] = bw;
    best_j[i] = bj;
  }
}

template <int DMAX>
static cudaError_t launch(const float* xr, const float* cr, const int32_t* kr,
                          const uint8_t* vr, int nr, const float* xc,
                          const float* cc, const int32_t* kc, const uint8_t* vc,
                          int nc, int d, int metric, float* best_w,
                          int32_t* best_j, cudaStream_t stream) {
  const int threads = 256;
  const int tile = column_tile(d, 3);
  const size_t smem = (size_t)tile * (d + 3) * sizeof(float);
  const int blocks = (nr + threads - 1) / threads;
  segmin_kernel<DMAX><<<blocks, threads, smem, stream>>>(
      xr, cr, kr, vr, nr, xc, cc, kc, vc, nc, d, metric, tile, best_w, best_j);
  return cudaGetLastError();
}

static int dispatch(const void* rows, const void* core_r, const void* comp_r,
                    const void* valid_r, int nr, const void* panel,
                    const void* core_c, const void* comp_c, const void* valid_c,
                    int nc, int d, int metric, void* best_w, void* best_j,
                    void* stream) {
  auto* xr = (const float*)rows;
  auto* cr = (const float*)core_r;
  auto* kr = (const int32_t*)comp_r;
  auto* vr = (const uint8_t*)valid_r;
  auto* xc = (const float*)panel;
  auto* cc = (const float*)core_c;
  auto* kc = (const int32_t*)comp_c;
  auto* vc = (const uint8_t*)valid_c;
  auto* bw = (float*)best_w;
  auto* bj = (int32_t*)best_j;
  auto s = (cudaStream_t)stream;
  if (nr <= 0) return 0;
  if (nc < 0) return (int)cudaErrorInvalidValue;
  if (d <= 4) return launch<4>(xr, cr, kr, vr, nr, xc, cc, kc, vc, nc, d, metric, bw, bj, s);
  if (d <= 8) return launch<8>(xr, cr, kr, vr, nr, xc, cc, kc, vc, nc, d, metric, bw, bj, s);
  if (d <= 32) return launch<32>(xr, cr, kr, vr, nr, xc, cc, kc, vc, nc, d, metric, bw, bj, s);
  if (d <= 128) return launch<128>(xr, cr, kr, vr, nr, xc, cc, kc, vc, nc, d, metric, bw, bj, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int segmin_launch(const void* x, const void* core, const void* comp,
                             const void* valid, int n, int d, int metric,
                             void* best_w, void* best_j, void* stream) {
  return dispatch(x, core, comp, valid, n, x, core, comp, valid, n, d, metric,
                  best_w, best_j, stream);
}

extern "C" int segmin_panel_launch(const void* rows, const void* core_r,
                                   const void* comp_r, const void* valid_r, int nr,
                                   const void* panel, const void* core_c,
                                   const void* comp_c, const void* valid_c, int nc,
                                   int d, int metric, void* best_w, void* best_j,
                                   void* stream) {
  return dispatch(rows, core_r, comp_r, valid_r, nr, panel, core_c, comp_c,
                  valid_c, nc, d, metric, best_w, best_j, stream);
}
