// Warp-cooperative (distance, id) lists: one list a warp, the lanes
// inserting together. Shared by B7 (forest_rescan.cu) and B5
// (forest_leaf_topk.cu). The order is lexmerge's: ascending distance, ties
// to the lower id.
#pragma once

#include <cstdint>

#include "lexlist.cuh"

// Insert (dist, id) into the row's lex-ascending list of k slots at (ld, li)
// (shared or device memory), the warp together; every lane passes the same
// (dist, id). Lane l handles slots l, l + 32, ...: a ballot of "slot below
// the candidate" counts the rank, a copy of the candidate is the entry at
// the rank, and the entries from the rank on move one slot back, 32 at a
// time, the last falling off. Returns whether it entered (a warp-uniform
// value); the caller has checked that it lex-precedes slot k - 1.
__device__ __forceinline__ bool warp_lex_insert(float* ld, int32_t* li, int k, float dist,
                                                int32_t id) {
  const int lane = threadIdx.x & 31;
  int pos = 0;
  bool dup = false;
  for (int s0 = 0; s0 < k; s0 += 32) {
    const int s = s0 + lane;
    bool less = false, eq = false;
    if (s < k) {
      const float e = ld[s];
      const int32_t ei = li[s];
      less = lex_less(e, ei, dist, id);
      eq = e == dist && ei == id;
    }
    const unsigned below = __ballot_sync(0xffffffffu, less);
    pos += __popc(below);
    dup |= __any_sync(0xffffffffu, eq);
    if (below != 0xffffffffu) break;  // the first slot not below lies here
  }
  if (dup || pos >= k) return false;
  for (int s0 = (k - 1) & ~31; s0 >= (pos & ~31); s0 -= 32) {
    const int s = s0 + lane;
    const bool move = s > pos && s < k;
    float pd = 0.0f;
    int32_t pi = 0;
    if (move) {
      pd = ld[s - 1];
      pi = li[s - 1];
    }
    __syncwarp();
    if (move) {
      ld[s] = pd;
      li[s] = pi;
    } else if (s == pos) {
      ld[s] = dist;
      li[s] = id;
    }
    __syncwarp();
  }
  return true;
}

// The same insert for a list of k <= 32 slots held in registers, slot l in
// lane l's (ed, ei): the rank by one ballot, the shift by one shuffle.
__device__ __forceinline__ bool lane_lex_insert(float& ed, int32_t& ei, int k, float dist,
                                                int32_t id) {
  const int lane = threadIdx.x & 31;
  const bool live = lane < k;
  const int pos = __popc(__ballot_sync(0xffffffffu, live && lex_less(ed, ei, dist, id)));
  const bool dup = __any_sync(0xffffffffu, live && ed == dist && ei == id);
  if (dup || pos >= k) return false;
  const float ud = __shfl_up_sync(0xffffffffu, ed, 1);
  const int32_t ui = __shfl_up_sync(0xffffffffu, ei, 1);
  if (lane > pos) {
    ed = ud;
    ei = ui;
  } else if (lane == pos) {
    ed = dist;
    ei = id;
  }
  return true;
}
