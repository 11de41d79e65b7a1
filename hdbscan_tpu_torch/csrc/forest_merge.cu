// B6 forest_merge: the cross-tree merge of per-tree k-best lists.
//
// Replaces the TPU kernel hdbscan_tpu/ops/pallas_forest.py
// forest_merge_pallas (_tree_merge_kernel -> lexmerge.merge_tile_candidates).
// Input: T lists per row, (T, n, kk) float32 / int32, each ascending in the
// (distance, id) lex order with (+inf, sentinel) tails. Output (n, kk): the
// kk lex-smallest entries over all trees with duplicate ids dropped, empty
// slots (+inf, sentinel) -- the reference's dedup lex merge of the
// concatenated lists. Copies of one id from different trees carry bitwise
// equal distances (the same two points through the same arithmetic), so
// the first copy the merge meets is the one to keep.
//
// Design: one thread per row runs a T-way merge of the sorted lists: it
// emits the lex-smallest head, skips an id it has already emitted (a scan
// of its own output row), and stops after kk emissions. Nothing in it is
// sized by kk, so the same kernel takes every kk (no separate wide mode).
//
// Bound on this card: bytes. It reads T n kk entries and writes n kk,
// with a few comparisons per entry.
#include <cstdint>

#include "lexlist.cuh"

constexpr int MERGE_ROWS = 128;
constexpr int MERGE_MAX_TREES = 64;

__global__ void forest_merge_kernel(const float* __restrict__ sd,
                                    const int32_t* __restrict__ si, int T,
                                    int n, int kk, int sentinel,
                                    float* __restrict__ od,
                                    int32_t* __restrict__ oi) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  int p[MERGE_MAX_TREES];
  for (int t = 0; t < T; ++t) p[t] = 0;
  float* rd = od + (int64_t)row * kk;
  int32_t* ri = oi + (int64_t)row * kk;
  int cnt = 0;
  while (cnt < kk) {
    int bt = -1;
    float hd = CUDART_INF_F;
    int32_t hi = LEX_ID_MAX;
    for (int t = 0; t < T; ++t) {
      if (p[t] >= kk) continue;
      const int64_t at = ((int64_t)t * n + row) * kk + p[t];
      const float d = sd[at];
      const int32_t i = si[at];
      if (bt < 0 || lex_less(d, i, hd, hi)) {
        bt = t;
        hd = d;
        hi = i;
      }
    }
    if (bt < 0) break;
    ++p[bt];
    if (hi != sentinel) {
      bool dup = false;
      for (int s = 0; s < cnt; ++s) dup |= ri[s] == hi;
      if (dup) continue;
    }
    rd[cnt] = hd;
    ri[cnt] = hi;
    ++cnt;
  }
  for (; cnt < kk; ++cnt) {
    rd[cnt] = CUDART_INF_F;
    ri[cnt] = sentinel;
  }
}

extern "C" int forest_merge_launch(const void* sd, const void* si, int T, int n,
                                   int kk, int sentinel, void* od, void* oi,
                                   void* stream) {
  if (n <= 0) return 0;
  if (T < 1 || T > MERGE_MAX_TREES || kk < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n + MERGE_ROWS - 1) / MERGE_ROWS;
  forest_merge_kernel<<<blocks, MERGE_ROWS, 0, (cudaStream_t)stream>>>(
      (const float*)sd, (const int32_t*)si, T, n, kk, sentinel, (float*)od,
      (int32_t*)oi);
  return (int)cudaGetLastError();
}
