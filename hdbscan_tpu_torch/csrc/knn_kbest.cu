// K2 knn_kbest: the k nearest columns of every query row, as (distance, id)
// in lexicographic order (ascending distance, ties to the lower id); and B3
// knn_smallest, the same selection on squared euclidean distances with no
// ids written.
//
// Replaces the TPU kernels hdbscan_tpu/ops/pallas_knn.py knn_fused_pallas
// (_fused_knn_kernel, merge in ops/lexmerge.merge_tile_contiguous) and
// knn_smallest_pallas (_knn_kernel), and the XLA scan ops/tiled._knn_core_scan
// that computes the same k-best with the tile-shape-selected distance form.
//
// One kernel, three entry points:
//   knn_kbest_launch        square: every row of x against every row of x;
//   knn_kbest_panel_launch  rectangular: queries q against a column panel x
//                           whose ids start at id_offset (the ring scan of
//                           parallel/ring.py runs one per visiting panel);
//   knn_smallest_launch     square, metric codes 4/5 (no root), no ids.
// B3 is a mode of this kernel and not a second body: inserting a candidate
// only when it is strictly closer than the current k-th and after every
// entry of equal value keeps exactly the k smallest values with their
// multiplicity, which is all B3 returns, whatever the column order.
//
// Design: one thread per query row keeps its sorted k-list in registers (k
// is bucketed to a compile-time KB in {16, 32, 128}; only the first k slots
// are used; at KB = 128 the list spills to local memory) and walks the
// columns in ascending tiles staged through shared memory. A candidate
// enters only if its distance is strictly below the current k-th distance;
// inserted after every entry of equal distance. Because ids arrive in
// ascending order, that is exactly the (distance, id) lex k-best, whatever
// the tiling. Slots never filled stay (+inf, -1).
//
// Bound on this card: operations. All query x column pair distances are
// evaluated on the FP32 pipes (about 3d + 3 operations each, plus a sqrt
// unless squared); insertions are rare once the lists have tightened.
// Device-memory traffic is O(columns d) per block plus the (rows, k) output.
//
// Wide mode (K2 and the rectangular entry only; B3 keeps the reference's
// k, d <= 128): past k = 128 or d = 128 one kernel takes over whose
// distances go through distance.cuh's chunked feature loop and whose k-list
// lives in the row's output (lexlist.cuh's lex_insert_mem), with the same
// admission and insert, so the lists are the same.
#include <cstdint>

#include "distance.cuh"
#include "lexlist.cuh"

constexpr int WIDE_THREADS = 128;

template <int DMAX, int KB>
__global__ void knn_kbest_kernel(const float* __restrict__ q, int nq,
                                 const float* __restrict__ x, int nx, int d,
                                 int k, int metric, int id_offset, int tile,
                                 float* __restrict__ out_d,
                                 int32_t* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* xs = smem;           // tile * d features
  float* ns = xs + tile * d;  // tile norms (dot form)

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool row_ok = i < nq;
  float xr[DMAX];
#pragma unroll
  for (int f = 0; f < DMAX; ++f) xr[f] = (row_ok && f < d) ? q[(int64_t)i * d + f] : 0.0f;
  const float xr_sq = sq_norm<DMAX>(xr, d);

  float bd[KB];
  int32_t bi[KB];
#pragma unroll
  for (int t = 0; t < KB; ++t) {
    bd[t] = CUDART_INF_F;
    bi[t] = -1;
  }
  float worst = CUDART_INF_F;  // bd[k - 1]

  for (int c0 = 0; c0 < nx; c0 += tile) {
    const int len = min(tile, nx - c0);
    for (int t = threadIdx.x; t < len * d; t += blockDim.x) {
      xs[t] = x[(int64_t)c0 * d + t];
    }
    __syncthreads();
    if (dot_form(metric)) {
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
        const float dist = pair_distance<DMAX>(xr, xr_sq, xs + t * d, ns[t], d, metric);
        if (!(dist < worst)) continue;
        const int32_t id = id_offset + c0 + t;
        // Insert after every entry <= dist; slots at or past k are ignored.
#pragma unroll
        for (int s = KB - 1; s >= 0; --s) {
          if (s < k) {
            const float prev = s > 0 ? bd[s - 1] : -CUDART_INF_F;
            if (prev > dist) {
              bd[s] = prev;
              bi[s] = bi[s - 1 < 0 ? 0 : s - 1];
            } else if (dist < bd[s]) {
              bd[s] = dist;
              bi[s] = id;
            }
            if (s == k - 1) worst = bd[s];
          }
        }
      }
    }
    __syncthreads();
  }
  if (row_ok) {
#pragma unroll
    for (int s = 0; s < KB; ++s) {
      if (s < k) {
        out_d[(int64_t)i * k + s] = bd[s];
        if (out_i != nullptr) out_i[(int64_t)i * k + s] = bi[s];
      }
    }
  }
}

__global__ void __launch_bounds__(WIDE_THREADS)
knn_kbest_wide_kernel(const float* __restrict__ q, int nq, const float* __restrict__ x,
                      int nx, int d, int k, int metric, int id_offset,
                      float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  extern __shared__ float smem[];  // wide_smem_floats(blockDim.x)
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool row_ok = i < nq;
  const float* row = row_ok ? q + (int64_t)i * d : nullptr;
  const float row_sq = (row_ok && dot_form(metric)) ? sq_norm_ptr(row, d) : 0.0f;
  float* bd = out_d + (int64_t)(row_ok ? i : 0) * k;
  int32_t* bi = out_i + (int64_t)(row_ok ? i : 0) * k;
  if (row_ok) {
    for (int s = 0; s < k; ++s) {
      bd[s] = CUDART_INF_F;
      bi[s] = -1;
    }
  }
  float worst = CUDART_INF_F;  // bd[k - 1]
  for (int c0 = 0; c0 < nx; c0 += WIDE_COLS) {
    const int len = min(WIDE_COLS, nx - c0);
    float dist[WIDE_COLS];
    wide_distances(row, row_sq, [=](int t) { return x + (int64_t)(c0 + t) * d; }, len, d,
                   metric, smem, dist);
    if (!row_ok) continue;
#pragma unroll
    for (int t = 0; t < WIDE_COLS; ++t) {
      if (t < len && dist[t] < worst) {
        lex_insert_mem(bd, bi, k, dist[t], id_offset + c0 + t);
        worst = bd[k - 1];
      }
    }
  }
}

template <int DMAX, int KB>
static cudaError_t launch(const float* q, int nq, const float* x, int nx, int d,
                          int k, int metric, int id_offset, float* out_d,
                          int32_t* out_i, cudaStream_t stream) {
  const int threads = KB > 32 ? 128 : 256;
  const int tile = column_tile(d, 0);
  const size_t smem = (size_t)tile * (d + 1) * sizeof(float);
  const int blocks = (nq + threads - 1) / threads;
  knn_kbest_kernel<DMAX, KB><<<blocks, threads, smem, stream>>>(
      q, nq, x, nx, d, k, metric, id_offset, tile, out_d, out_i);
  return cudaGetLastError();
}

template <int DMAX>
static cudaError_t launch_k(const float* q, int nq, const float* x, int nx, int d,
                            int k, int metric, int off, float* out_d,
                            int32_t* out_i, cudaStream_t s) {
  if (k <= 16) return launch<DMAX, 16>(q, nq, x, nx, d, k, metric, off, out_d, out_i, s);
  if (k <= 32) return launch<DMAX, 32>(q, nq, x, nx, d, k, metric, off, out_d, out_i, s);
  if (k <= 128) return launch<DMAX, 128>(q, nq, x, nx, d, k, metric, off, out_d, out_i, s);
  return cudaErrorInvalidValue;
}

static int dispatch(const void* q, int nq, const void* x, int nx, int d, int k,
                    int metric, int id_offset, void* out_d, void* out_i,
                    void* stream) {
  auto* qf = (const float*)q;
  auto* xf = (const float*)x;
  auto* od = (float*)out_d;
  auto* oi = (int32_t*)out_i;
  auto s = (cudaStream_t)stream;
  if (nq <= 0) return 0;
  if (k < 1 || nx < 0 || d < 1) return (int)cudaErrorInvalidValue;
  if (k > 128 || d > 128) {
    if (oi == nullptr) return (int)cudaErrorInvalidValue;  // B3 has no wide mode
    const int blocks = (nq + WIDE_THREADS - 1) / WIDE_THREADS;
    const size_t smem = wide_smem_floats(WIDE_THREADS) * sizeof(float);
    knn_kbest_wide_kernel<<<blocks, WIDE_THREADS, smem, s>>>(
        qf, nq, xf, nx, d, k, metric, id_offset, od, oi);
    return (int)cudaGetLastError();
  }
  if (d <= 4) return launch_k<4>(qf, nq, xf, nx, d, k, metric, id_offset, od, oi, s);
  if (d <= 8) return launch_k<8>(qf, nq, xf, nx, d, k, metric, id_offset, od, oi, s);
  if (d <= 32) return launch_k<32>(qf, nq, xf, nx, d, k, metric, id_offset, od, oi, s);
  if (d <= 128) return launch_k<128>(qf, nq, xf, nx, d, k, metric, id_offset, od, oi, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int knn_kbest_launch(const void* x, int n, int d, int k, int metric,
                                void* out_d, void* out_i, void* stream) {
  return dispatch(x, n, x, n, d, k, metric, 0, out_d, out_i, stream);
}

extern "C" int knn_kbest_panel_launch(const void* q, int nq, const void* x, int nx,
                                      int d, int k, int metric, int id_offset,
                                      void* out_d, void* out_i, void* stream) {
  return dispatch(q, nq, x, nx, d, k, metric, id_offset, out_d, out_i, stream);
}

extern "C" int knn_smallest_launch(const void* x, int n, int d, int k, int metric,
                                   void* out_d, void* stream) {
  if (metric != METRIC_EUCLID_DIFF_SQ && metric != METRIC_EUCLID_DOT_SQ) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch(x, n, x, n, d, k, metric, 0, out_d, nullptr, stream);
}
