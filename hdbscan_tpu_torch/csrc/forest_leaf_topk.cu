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
// version's operation order (distance.cuh). In bf16 mode (mu != null) the
// operands are centred on the leaf's centre mu[b] (computed by the
// wrapper, the mean of the leaf's real members), rounded to bfloat16, and
// the cross term accumulates their products in float32 (each product is
// exact there) beside float32 norms of the centred, unrounded operands.
//
// Design: grid (leaves, row blocks of 128). A thread owns one leaf slot,
// keeps its point in registers and a kk-list of (distance, position) in
// registers, and walks the leaf's columns in ascending position through
// shared-memory tiles (gathered through members). A column enters only if
// it is strictly closer than the current kk-th: with positions ascending,
// that is lax.top_k's preference for the lower position. The (B, L, L)
// distance block is never written.
//
// Bound on this card: operations. L^2 pair distances per leaf (about 3d
// float operations and one sqrt each) against B L (d + kk) words of
// device-memory traffic.
//
// Wide mode (kk or d past 128; f32 only, as bf16 runs inside the
// reference's fused gate): the leaf's columns in sub-tiles of WIDE_COLS
// through distance.cuh's chunked feature loop, the (distance, position)
// list in the slot's output row (lexlist.cuh), the same epilogue there.
#include <cstdint>

#include "distance.cuh"
#include "lexlist.cuh"

constexpr int LEAF_ROWS = 128;

template <int DMAX, int KB>
__global__ void leaf_topk_kernel(const float* __restrict__ data, int d,
                                 const int32_t* __restrict__ members,
                                 const uint8_t* __restrict__ mask, int L,
                                 int kk, int metric, int sentinel,
                                 const float* __restrict__ mu, int tile,
                                 float* __restrict__ out_d,
                                 int32_t* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* xs = smem;           // tile * d column coordinates
  float* ns = xs + tile * d;  // tile column norms (dot form, bf16 mode)
  float* ms = ns + tile;      // tile column mask, 1 or 0

  const int b = blockIdx.x;
  const int r = blockIdx.y * blockDim.x + threadIdx.x;
  const bool row_ok = r < L;
  const int32_t* mem = members + (int64_t)b * L;
  const uint8_t* msk = mask + (int64_t)b * L;
  const bool bf16 = mu != nullptr;
  const float* mub = bf16 ? mu + (int64_t)b * d : nullptr;
  const int code = bf16 ? METRIC_EUCLID_DOT : metric;
  const bool norms = code == METRIC_EUCLID_DOT;

  float xr[DMAX];
  const int32_t rid = row_ok ? mem[r] : 0;
#pragma unroll
  for (int f = 0; f < DMAX; ++f) {
    float v = (row_ok && f < d) ? data[(int64_t)rid * d + f] : 0.0f;
    if (bf16 && f < d) v = v - mub[f];
    xr[f] = v;
  }
  const float xr_sq = sq_norm<DMAX>(xr, d);
  if (bf16) {
#pragma unroll
    for (int f = 0; f < DMAX; ++f) xr[f] = bf16_round(xr[f]);
  }

  float bd[KB];
  int32_t bp[KB];  // column positions while scanning
#pragma unroll
  for (int s = 0; s < KB; ++s) {
    bd[s] = CUDART_INF_F;
    bp[s] = -1;
  }
  float worst = CUDART_INF_F;

  for (int c0 = 0; c0 < L; c0 += tile) {
    const int len = min(tile, L - c0);
    for (int t = threadIdx.x; t < len * d; t += blockDim.x) {
      const int col = t / d, f = t - col * d;
      float v = data[(int64_t)mem[c0 + col] * d + f];
      if (bf16) v = v - mub[f];
      xs[t] = v;
    }
    for (int t = threadIdx.x; t < len; t += blockDim.x) ms[t] = msk[c0 + t] ? 1.0f : 0.0f;
    __syncthreads();
    if (norms) {
      for (int t = threadIdx.x; t < len; t += blockDim.x) {
        const float* xc = xs + t * d;
        float acc = xc[0] * xc[0];
        for (int f = 1; f < d; ++f) acc = acc + xc[f] * xc[f];
        ns[t] = acc;
      }
      __syncthreads();
    }
    if (bf16) {
      for (int t = threadIdx.x; t < len * d; t += blockDim.x) xs[t] = bf16_round(xs[t]);
      __syncthreads();
    }
    if (row_ok) {
      for (int t = 0; t < len; ++t) {
        if (ms[t] == 0.0f) continue;
        const float dist = pair_distance<DMAX>(xr, xr_sq, xs + t * d, ns[t], d, code);
        if (!(dist < worst)) continue;
        lex_insert<KB>(bd, bp, kk, dist, c0 + t);
#pragma unroll
        for (int s = 0; s < KB; ++s) {
          if (s == kk - 1) worst = bd[s];
        }
      }
    }
    __syncthreads();
  }
  if (!row_ok) return;
  // Epilogue: positions -> global ids, +inf -> sentinel, then (d, id) order.
  int32_t bi[KB];
#pragma unroll
  for (int s = 0; s < KB; ++s) {
    if (s < kk) {
      bi[s] = (bp[s] >= 0 && bd[s] < CUDART_INF_F) ? mem[bp[s]] : sentinel;
    } else {
      bd[s] = CUDART_INF_F;
      bi[s] = LEX_ID_MAX;
    }
  }
  lex_sort<KB>(bd, bi);
  const int64_t o = ((int64_t)b * L + r) * kk;
#pragma unroll
  for (int s = 0; s < KB; ++s) {
    if (s < kk) {
      out_d[o + s] = bd[s];
      out_i[o + s] = bi[s];
    }
  }
}

__global__ void leaf_topk_wide_kernel(const float* __restrict__ data, int d,
                                      const int32_t* __restrict__ members,
                                      const uint8_t* __restrict__ mask, int L, int kk,
                                      int metric, int sentinel, float* __restrict__ out_d,
                                      int32_t* __restrict__ out_i) {
  extern __shared__ float smem[];  // wide_smem_floats(blockDim.x)
  const int b = blockIdx.x;
  const int r = blockIdx.y * blockDim.x + threadIdx.x;
  const bool row_ok = r < L;
  const int32_t* mem = members + (int64_t)b * L;
  const uint8_t* msk = mask + (int64_t)b * L;
  const float* row = row_ok ? data + (int64_t)mem[r] * d : nullptr;
  const float row_sq = (row_ok && dot_form(metric)) ? sq_norm_ptr(row, d) : 0.0f;
  const int64_t o = ((int64_t)b * L + (row_ok ? r : 0)) * kk;
  float* bd = out_d + o;
  int32_t* bp = out_i + o;  // column positions while scanning
  if (row_ok) {
    for (int s = 0; s < kk; ++s) {
      bd[s] = CUDART_INF_F;
      bp[s] = -1;
    }
  }
  float worst = CUDART_INF_F;
  for (int c0 = 0; c0 < L; c0 += WIDE_COLS) {
    const int len = min(WIDE_COLS, L - c0);
    float dist[WIDE_COLS];
    wide_distances(row, row_sq, [=](int t) { return data + (int64_t)mem[c0 + t] * d; }, len,
                   d, metric, smem, dist);
    if (!row_ok) continue;
#pragma unroll
    for (int t = 0; t < WIDE_COLS; ++t) {
      if (t < len && msk[c0 + t] && dist[t] < worst) {
        lex_insert_mem(bd, bp, kk, dist[t], c0 + t);
        worst = bd[kk - 1];
      }
    }
  }
  if (!row_ok) return;
  // Epilogue: positions -> global ids, +inf -> sentinel, then (d, id) order.
  for (int s = 0; s < kk; ++s) {
    bp[s] = (bp[s] >= 0 && bd[s] < CUDART_INF_F) ? mem[bp[s]] : sentinel;
  }
  lex_sort_mem(bd, bp, kk);
}

template <int DMAX, int KB>
static cudaError_t launch(const float* data, int d, const int32_t* members,
                          const uint8_t* mask, int B, int L, int kk, int metric,
                          int sentinel, const float* mu, float* out_d,
                          int32_t* out_i, cudaStream_t stream) {
  const int tile = column_tile(d, 1);
  const size_t smem = (size_t)tile * (d + 2) * sizeof(float);
  const dim3 grid(B, (L + LEAF_ROWS - 1) / LEAF_ROWS);
  leaf_topk_kernel<DMAX, KB><<<grid, LEAF_ROWS, smem, stream>>>(
      data, d, members, mask, L, kk, metric, sentinel, mu, tile, out_d, out_i);
  return cudaGetLastError();
}

template <int DMAX>
static cudaError_t launch_k(const float* data, int d, const int32_t* members,
                            const uint8_t* mask, int B, int L, int kk,
                            int metric, int sentinel, const float* mu,
                            float* out_d, int32_t* out_i, cudaStream_t s) {
  if (kk <= 16)
    return launch<DMAX, 16>(data, d, members, mask, B, L, kk, metric, sentinel, mu, out_d, out_i, s);
  if (kk <= 32)
    return launch<DMAX, 32>(data, d, members, mask, B, L, kk, metric, sentinel, mu, out_d, out_i, s);
  if (kk <= 128)
    return launch<DMAX, 128>(data, d, members, mask, B, L, kk, metric, sentinel, mu, out_d, out_i, s);
  return cudaErrorInvalidValue;
}

extern "C" int forest_leaf_topk_launch(const void* data, int d, const void* members,
                                       const void* mask, int B, int L, int kk,
                                       int metric, int sentinel, const void* mu,
                                       void* out_d, void* out_i, void* stream) {
  auto* x = (const float*)data;
  auto* mem = (const int32_t*)members;
  auto* msk = (const uint8_t*)mask;
  auto* m = (const float*)mu;
  auto* od = (float*)out_d;
  auto* oi = (int32_t*)out_i;
  auto s = (cudaStream_t)stream;
  if (B <= 0 || L <= 0) return 0;
  if (kk < 1 || kk > L || d < 1 || (L + LEAF_ROWS - 1) / LEAF_ROWS > 65535)
    return (int)cudaErrorInvalidValue;
  if (kk > 128 || d > 128) {
    if (m != nullptr) return (int)cudaErrorInvalidValue;  // bf16 stays within 128
    const dim3 grid(B, (L + LEAF_ROWS - 1) / LEAF_ROWS);
    const size_t smem = wide_smem_floats(LEAF_ROWS) * sizeof(float);
    leaf_topk_wide_kernel<<<grid, LEAF_ROWS, smem, s>>>(
        x, d, mem, msk, L, kk, metric, sentinel, od, oi);
    return (int)cudaGetLastError();
  }
  if (d <= 4) return launch_k<4>(x, d, mem, msk, B, L, kk, metric, sentinel, m, od, oi, s);
  if (d <= 8) return launch_k<8>(x, d, mem, msk, B, L, kk, metric, sentinel, m, od, oi, s);
  if (d <= 32) return launch_k<32>(x, d, mem, msk, B, L, kk, metric, sentinel, m, od, oi, s);
  if (d <= 128) return launch_k<128>(x, d, mem, msk, B, L, kk, metric, sentinel, m, od, oi, s);
  return (int)cudaErrorInvalidValue;
}
