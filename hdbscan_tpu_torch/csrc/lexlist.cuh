// Per-thread (distance, id) lists shared by the rp-forest kernels.
//
// The order is the repo-wide lexicographic one (hdbscan_tpu_torch/ops/
// lexmerge.py): ascending distance, ties to the lower id. Lists live in
// arrays of a compile-time size KB whose loops are fully unrolled, so the
// entries stay in registers at small KB; only the first `k` slots are used.
// A list wider than the register kernels' KB = 128 (the kernels' wide mode)
// lives in device memory instead: in the kernel's own output row, which the
// wrapper allocates, with the same admission and insert (lex_insert_mem).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <math_constants.h>

// int32 "no id" of the sentinel convention's scratch lists (lexmerge.ID_MAX).
#define LEX_ID_MAX 2147483647

__device__ __forceinline__ bool lex_less(float d0, int32_t i0, float d1, int32_t i1) {
  return d0 < d1 || (d0 == d1 && i0 < i1);
}

// Round a float to the nearest bfloat16 (ties to even) and back: what
// torch's .to(torch.bfloat16).to(torch.float32) computes.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Insert (dist, id) into the lex-ascending list (bd, bi) of k slots, after
// every entry that lex-precedes it; the last slot falls off. The caller has
// checked that (dist, id) lex-precedes slot k - 1.
template <int KB>
__device__ __forceinline__ void lex_insert(float (&bd)[KB], int32_t (&bi)[KB],
                                           int k, float dist, int32_t id) {
#pragma unroll
  for (int s = KB - 1; s >= 0; --s) {
    if (s < k) {
      const float pd = s > 0 ? bd[s > 0 ? s - 1 : 0] : -CUDART_INF_F;
      const int32_t pi = s > 0 ? bi[s > 0 ? s - 1 : 0] : -1;
      if (s > 0 && lex_less(dist, id, pd, pi)) {
        bd[s] = pd;
        bi[s] = pi;
      } else if (lex_less(dist, id, bd[s], bi[s])) {
        bd[s] = dist;
        bi[s] = id;
      }
    }
  }
}

// Sort a KB-slot list into lex order: odd-even transposition, KB phases,
// every compare-exchange on a fixed pair of slots (registers, no spills).
template <int KB>
__device__ __forceinline__ void lex_sort(float (&bd)[KB], int32_t (&bi)[KB]) {
#pragma unroll 1
  for (int p = 0; p < (KB + 1) / 2; ++p) {
#pragma unroll
    for (int s = 0; s + 1 < KB; s += 2) {
      if (lex_less(bd[s + 1], bi[s + 1], bd[s], bi[s])) {
        const float td = bd[s];
        const int32_t ti = bi[s];
        bd[s] = bd[s + 1];
        bi[s] = bi[s + 1];
        bd[s + 1] = td;
        bi[s + 1] = ti;
      }
    }
#pragma unroll
    for (int s = 1; s + 1 < KB; s += 2) {
      if (lex_less(bd[s + 1], bi[s + 1], bd[s], bi[s])) {
        const float td = bd[s];
        const int32_t ti = bi[s];
        bd[s] = bd[s + 1];
        bi[s] = bi[s + 1];
        bd[s + 1] = td;
        bi[s + 1] = ti;
      }
    }
  }
}

// ---- Lists past 128 slots, in device memory ------------------------------

// lex_insert on a k-slot list at (bd, bi) in device memory (each thread its
// own row): insert (dist, id) after every entry that lex-precedes it, the
// last slot falls off. The caller has checked that (dist, id) lex-precedes
// slot k - 1.
__device__ __forceinline__ void lex_insert_mem(float* bd, int32_t* bi, int k,
                                               float dist, int32_t id) {
  int s = k - 1;
  while (s > 0) {
    const float pd = bd[s - 1];
    const int32_t pi = bi[s - 1];
    if (!lex_less(dist, id, pd, pi)) break;
    bd[s] = pd;
    bi[s] = pi;
    --s;
  }
  bd[s] = dist;
  bi[s] = id;
}

// Sort a k-slot list in device memory into lex order (insertion sort: the
// wide lists come in distance order, so only runs of equal distance move).
__device__ __forceinline__ void lex_sort_mem(float* bd, int32_t* bi, int k) {
  for (int s = 1; s < k; ++s) {
    const float dv = bd[s];
    const int32_t iv = bi[s];
    int t = s;
    while (t > 0 && lex_less(dv, iv, bd[t - 1], bi[t - 1])) {
      bd[t] = bd[t - 1];
      bi[t] = bi[t - 1];
      --t;
    }
    bd[t] = dv;
    bi[t] = iv;
  }
}
