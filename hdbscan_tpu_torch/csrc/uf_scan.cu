// K3 uf_scan: Kruskal union-find over a lexsorted edge list, emitting the
// union event stream (ra[e], rb[e]); step e merged two trees iff ra != rb.
//
// Counterpart of the lax.scan in hdbscan_tpu/core/mst_device.py _uf_scan
// (not a Pallas kernel: PyTorch has no device scan). The contract is the
// sequential one: step e finds ra = root(u_e) and rb = root(v_e), emits
// them, then hangs root rb under root ra (par[rb] = ra, no union by size).
// Self-loops (the +inf padding rows are (0, 0)), duplicate edges and cycle
// edges fall out as ra == rb. Which vertex is a root depends only on the
// links, never on how paths are compressed, so any structure that keeps
// every vertex's root gives the same stream.
//
// Bound on this card: latency, not bytes or operations. The bytes (read 2m
// ids, write 2m event ids) take microseconds at the memory rate; what
// costs is the chain of decisions, each edge's roots depending on every
// earlier union.
//
// Design: a batched replay in one persistent block of UF_THREADS threads.
// The edges are cut into batches of UF_THREADS consecutive edges, one edge
// a thread (1,024: batches of 2,048 and 4,096 ran the 1M x 8 pool 1.5%
// and 9% slower, Skin's within 2%; PERF.md §6); for each batch:
//  1. Frozen finds. Every thread finds, in the global parent array par (in
//     L2: 1 MB at 245k vertices), the batch-start roots of its edge's two
//     endpoints, both chains' loads issued together. No union happens in
//     this phase, so the concurrent path halving only shortcuts vertices
//     to ancestors and no root changes.
//  2. Compaction. The batch's distinct roots (at most 2 * UF_THREADS) get
//     local ids: the slots of an open-addressing hash table in shared
//     memory (UF_SLOTS, so it is at most half full), claimed by atomicCAS.
//     A root met twice, or both ends of a self-loop, map to one slot.
//  3. Replay. One warp replays the batch in edge order over the local ids,
//     32 edges at a time. The global forest at step e is the batch-start
//     forest plus links between batch-start roots, so root(u_e) is the
//     local root of u_e's batch-start root: the replay is exact. For a
//     group of 32 edges each lane finds its edge's group-start local roots
//     in the shared-memory parent array lpar; then the group's links are
//     applied in order from the lanes' registers: the pairs of UF_ROUND
//     consecutive steps are broadcast by shuffle together, each is brought
//     to its own step by the round's earlier links, and every later lane
//     whose root is a step's b takes its a. So the dependent chain is one
//     shuffle round and about UF_ROUND compare-selects per UF_ROUND edges,
//     where the one-thread scan this replaces waited on several L2 round
//     trips an edge. A group whose edges all join no two trees at its
//     start (padding self-loops) skips the steps (a ballot). Each lane also
//     carries its roots after the group and points its endpoints and their
//     group-start roots at them, which covers every link of the group and
//     keeps the local chains one level deep where a slot comes back group
//     after group (PERF.md §6 times writing each link at its step instead).
//  4. Apply. Every endpoint and every batch-start root is pointed at its
//     root after the batch (par[x] = that root, the same value whichever
//     thread writes it), so the batch's own links are one level deep.
// The phases are separated by __syncthreads, which also makes phase 4's
// writes to par visible to the next batch's phase 1 (one block: one SM).
// A caller may pass `prof` (UF_PROF_SLOTS int64) to read each phase's
// cycles and the finds' hop counts (kernel_bench.py ufscan). At the Skin
// pool the replay takes ~80% of the block's cycles, ~61 an edge: a group's
// finds, emission and writes cost about as much as its steps, and rounds
// of 1, 2 or 8 steps ran slower than 4 (PERF.md §6). The replay's own
// floor, its dependent shared-memory loads and shuffle rounds, is timed
// on the card by uf_probe_launch and counted in `prof` (chip_smoke.py).
#include <cstdint>

#include <cuda_runtime.h>

constexpr int UF_THREADS = 1024;  // also the edges of a batch
constexpr int UF_LOG2_SLOTS = 12;
constexpr int UF_SLOTS = 1 << UF_LOG2_SLOTS;  // 4 x the batch
constexpr int UF_CHAINS = 2;  // a thread's edge's two endpoints
constexpr int UF_EMPTY = -1;
constexpr unsigned UF_FULL = 0xffffffffu;
// Steps of the replay broadcast together (a divisor of 32).
constexpr int UF_ROUND = 4;

// prof slots: cycles of phases 1-4 (block thread 0's clock), finds and hops
// of phase 1, the most load rounds one thread's finds took, batches, replay
// steps (edges that joined two trees at their group's start), the replay's
// find rounds (each group's most in a lane, summed), its groups of 32 edges
// and its shuffle rounds (32 / UF_ROUND a group that steps): the replay's
// dependent chain is a shared-memory load a group, two a find round and a
// shuffle a shuffle round.
enum : int {
  UF_PROF_FIND_CYCLES = 0,
  UF_PROF_COMPACT_CYCLES = 1,
  UF_PROF_REPLAY_CYCLES = 2,
  UF_PROF_APPLY_CYCLES = 3,
  UF_PROF_FINDS = 4,
  UF_PROF_HOPS = 5,
  UF_PROF_MAX_ROUNDS = 6,
  UF_PROF_BATCHES = 7,
  UF_PROF_STEPS = 8,
  UF_PROF_REPLAY_FIND_ROUNDS = 9,
  UF_PROF_GROUPS = 10,
  UF_PROF_SHUFFLE_ROUNDS = 11,
  UF_PROF_SLOTS = 12,
};

// Roots of the chains x[c] in the global forest (x[c] < 0: no chain), with
// path halving; every round issues the loads of all live chains together.
template <bool PROF>
__device__ __forceinline__ void find_roots(int32_t* par, int (&x)[UF_CHAINS],
                                           long long& hops, int& rounds) {
  int p[UF_CHAINS];
#pragma unroll
  for (int c = 0; c < UF_CHAINS; ++c) p[c] = x[c] >= 0 ? par[x[c]] : x[c];
  while (true) {
    bool more = false;
#pragma unroll
    for (int c = 0; c < UF_CHAINS; ++c) more |= p[c] != x[c];
    if (!more) break;
    if (PROF) ++rounds;
    int g[UF_CHAINS];
#pragma unroll
    for (int c = 0; c < UF_CHAINS; ++c) g[c] = p[c] != x[c] ? par[p[c]] : x[c];
#pragma unroll
    for (int c = 0; c < UF_CHAINS; ++c) {
      if (p[c] != x[c]) {
        if (g[c] == p[c]) {  // p is the root
          if (PROF) hops += 1;
          x[c] = p[c];
        } else {  // halve: x -> its grandparent
          if (PROF) hops += 2;
          par[x[c]] = g[c];
          x[c] = g[c];
          p[c] = par[g[c]];
        }
      }
    }
  }
}

// Local root of slot x in lpar, with path halving.
__device__ __forceinline__ int local_root(int32_t* lpar, int x) {
  while (true) {
    const int p = lpar[x];
    if (p == x) return x;
    const int g = lpar[p];
    if (g == p) return p;
    lpar[x] = g;
    x = g;
  }
}

// The slot of vertex r in the table (claimed if r is new).
__device__ __forceinline__ int slot_of(volatile int32_t* key, int32_t* lpar, int r) {
  constexpr unsigned mask = UF_SLOTS - 1u;
  unsigned h = ((unsigned)r * 2654435769u) >> (32 - UF_LOG2_SLOTS);
  while (true) {
    const int k = key[h];
    if (k == r) return (int)h;
    if (k == UF_EMPTY) {
      const int prev = atomicCAS((int*)&key[h], UF_EMPTY, r);
      if (prev == UF_EMPTY) {
        lpar[h] = (int)h;
        return (int)h;
      }
      if (prev == r) return (int)h;
    }
    h = (h + 1u) & mask;
  }
}

// Phase 3 for one batch: warp 0 replays its `cnt` edges (slots lu, lv of
// their batch-start roots), emitting ra/rb from `base`. Adds to `steps` the
// edges that joined two trees at their group's start, to `rounds` each
// group's most find rounds in a lane, to `groups` its groups and to
// `shuffles` its shuffle rounds.
__device__ __forceinline__ void replay(const int32_t* key, int32_t* lpar, const int32_t* lu,
                                       const int32_t* lv, int cnt, int64_t base,
                                       int32_t* __restrict__ ra_out,
                                       int32_t* __restrict__ rb_out, long long& steps,
                                       long long& rounds, long long& groups,
                                       long long& shuffles) {
  const int lane = threadIdx.x & 31;
  for (int g0 = 0; g0 < cnt; g0 += 32) {
    const int el = g0 + lane;
    const bool ok = el < cnt;
    const int a = ok ? lu[el] : -1;
    const int b = ok ? lv[el] : -1;
    int ra0 = a, rb0 = b;  // group-start local roots
    int iters = 0;
    if (ok) {
      while (true) {  // both finds in one loop, as the reference's _find2
        const int pa = lpar[ra0], pb = lpar[rb0];
        const bool da = pa == ra0, db = pb == rb0;
        if (da && db) break;
        ++iters;
        const int ga = da ? ra0 : lpar[pa];
        const int gb = db ? rb0 : lpar[pb];
        if (!da) {
          if (ga != pa) lpar[ra0] = ga;
          ra0 = ga;
        }
        if (!db) {
          if (gb != pb) lpar[rb0] = gb;
          rb0 = gb;
        }
      }
    }
    rounds += __reduce_max_sync(UF_FULL, iters);
    ++groups;
    // ea/eb: this lane's roots at its own step (links of earlier lanes);
    // fa/fb: its roots after the group (every link).
    int ea = ra0, eb = rb0, fa = ra0, fb = rb0;
    const unsigned cand = __ballot_sync(UF_FULL, ok && ra0 != rb0);
    steps += __popc(cand);
    if (cand) {
      shuffles += 32 / UF_ROUND;
      // UF_ROUND steps a round: their pairs are broadcast together and each
      // is brought to its own step by the round's earlier links (in order);
      // a link hangs pb under pa, a no-op where pa == pb (a non-merge, or a
      // lane past cnt: -1).
#pragma unroll
      for (int i0 = 0; i0 < 32; i0 += UF_ROUND) {
        int pa[UF_ROUND], pb[UF_ROUND];
#pragma unroll
        for (int j = 0; j < UF_ROUND; ++j) {
          pa[j] = __shfl_sync(UF_FULL, ea, i0 + j);
          pb[j] = __shfl_sync(UF_FULL, eb, i0 + j);
        }
#pragma unroll
        for (int j = 1; j < UF_ROUND; ++j) {
#pragma unroll
          for (int q = 0; q < j; ++q) {
            pa[j] = pa[j] == pb[q] ? pa[q] : pa[j];
            pb[j] = pb[j] == pb[q] ? pa[q] : pb[j];
          }
        }
#pragma unroll
        for (int q = 0; q < UF_ROUND; ++q) {
          const bool later = lane > i0 + q;
          ea = (later && ea == pb[q]) ? pa[q] : ea;
          eb = (later && eb == pb[q]) ? pa[q] : eb;
          fa = fa == pb[q] ? pa[q] : fa;
          fb = fb == pb[q] ? pa[q] : fb;
        }
      }
    }
    if (ok) {
      ra_out[base + el] = key[ea];
      rb_out[base + el] = key[eb];
      // Every slot written here gets its root after the group (the same
      // value whichever lane writes it), so the group's own links and the
      // lanes' entry slots are one level deep.
      lpar[ra0] = fa;
      lpar[rb0] = fb;
      lpar[a] = fa;
      lpar[b] = fb;
    }
    __syncwarp();
  }
}

template <bool PROF>
__global__ void __launch_bounds__(UF_THREADS, 1)
uf_scan_kernel(const int32_t* __restrict__ su, const int32_t* __restrict__ sv, int m,
               int32_t* par, int32_t* __restrict__ ra_out, int32_t* __restrict__ rb_out,
               long long* __restrict__ prof) {
  __shared__ int32_t key[UF_SLOTS];   // slot -> vertex (UF_EMPTY: free)
  __shared__ int32_t lpar[UF_SLOTS];  // slot -> local parent slot
  __shared__ int32_t lu[UF_THREADS];  // edge -> slot of its u's batch-start root
  __shared__ int32_t lv[UF_THREADS];  // edge -> slot of its v's batch-start root
  volatile int32_t* vkey = key;       // the table, read while it is being claimed
  __shared__ unsigned long long sprof[UF_PROF_SLOTS];
  const int tid = threadIdx.x;
  if (PROF && tid < UF_PROF_SLOTS) sprof[tid] = 0;
  long long hops = 0, cyc[4] = {0, 0, 0, 0}, steps = 0, lrounds = 0, batches = 0;
  long long groups = 0, shuffles = 0;
  int rounds = 0, finds = 0;

  for (int64_t base = 0; base < m; base += UF_THREADS) {
    const int cnt = m - base < UF_THREADS ? (int)(m - base) : UF_THREADS;
    long long t0 = PROF ? clock64() : 0;
    for (int i = tid; i < UF_SLOTS; i += UF_THREADS) key[i] = UF_EMPTY;
    // 1. batch-start roots of this thread's edge's endpoints.
    const bool ok = tid < cnt;
    const int eu = ok ? su[base + tid] : -1;
    const int ev = ok ? sv[base + tid] : -1;
    int x[UF_CHAINS] = {eu, ev};
    if (PROF) finds += ok ? 2 : 0;
    find_roots<PROF>(par, x, hops, rounds);
    __syncthreads();
    long long t1 = PROF ? clock64() : 0;
    // 2. local ids.
    int sl[UF_CHAINS];
#pragma unroll
    for (int c = 0; c < UF_CHAINS; ++c) sl[c] = ok ? slot_of(vkey, lpar, x[c]) : -1;
    if (ok) {
      lu[tid] = sl[0];
      lv[tid] = sl[1];
    }
    __syncthreads();
    long long t2 = PROF ? clock64() : 0;
    // 3. the replay.
    if (tid < 32) replay(key, lpar, lu, lv, cnt, base, ra_out, rb_out, steps, lrounds, groups,
                       shuffles);
    __syncthreads();
    long long t3 = PROF ? clock64() : 0;
    // 4. endpoints and batch-start roots to their roots after the batch.
    if (ok) {
      const int fu = key[local_root(lpar, sl[0])];
      const int fv = key[local_root(lpar, sl[1])];
      par[x[0]] = fu;
      par[eu] = fu;
      par[x[1]] = fv;
      par[ev] = fv;
    }
    __syncthreads();
    if (PROF && tid == 0) {
      const long long t4 = clock64();
      cyc[0] += t1 - t0;
      cyc[1] += t2 - t1;
      cyc[2] += t3 - t2;
      cyc[3] += t4 - t3;
      ++batches;
    }
  }
  if (PROF) {
    atomicAdd(&sprof[UF_PROF_FINDS], (unsigned long long)finds);
    atomicAdd(&sprof[UF_PROF_HOPS], (unsigned long long)hops);
    atomicMax(&sprof[UF_PROF_MAX_ROUNDS], (unsigned long long)rounds);
    if (tid == 0) {
      for (int p = 0; p < 4; ++p) sprof[p] = (unsigned long long)cyc[p];
      sprof[UF_PROF_BATCHES] = (unsigned long long)batches;
      sprof[UF_PROF_STEPS] = (unsigned long long)steps;
      sprof[UF_PROF_REPLAY_FIND_ROUNDS] = (unsigned long long)lrounds;
      sprof[UF_PROF_GROUPS] = (unsigned long long)groups;
      sprof[UF_PROF_SHUFFLE_ROUNDS] = (unsigned long long)shuffles;
    }
    __syncthreads();
    if (tid < UF_PROF_SLOTS) prof[tid] = (long long)sprof[tid];
  }
}

// su, sv: (m,) endpoints in scan order; par: (max(n, 1),) int32 scratch
// holding 0..n-1 (the caller's); ra, rb: (m,) outputs. prof: null, or
// UF_PROF_SLOTS int64 to fill.
extern "C" int uf_scan_launch(const void* su, const void* sv, int m, int n, void* par,
                              void* ra, void* rb, void* prof, void* stream) {
  (void)n;
  if (m <= 0) return 0;
  auto s = (cudaStream_t)stream;
  if (prof != nullptr) {
    uf_scan_kernel<true><<<1, UF_THREADS, 0, s>>>(
        (const int32_t*)su, (const int32_t*)sv, m, (int32_t*)par, (int32_t*)ra, (int32_t*)rb,
        (long long*)prof);
  } else {
    uf_scan_kernel<false><<<1, UF_THREADS, 0, s>>>(
        (const int32_t*)su, (const int32_t*)sv, m, (int32_t*)par, (int32_t*)ra, (int32_t*)rb,
        nullptr);
  }
  return (int)cudaGetLastError();
}

// The replay's latency units, for its floor (not on the fit's path): one
// warp runs `steps` dependent rounds of one kind, the index of each round
// the value the round before returned. kind 0: a shuffle (the replay's
// step rounds); kind 1: a shared-memory load (its finds in lpar). The
// caller times two step counts and takes the difference a step.
__global__ void uf_probe_kernel(int steps, int kind, int32_t* out) {
  __shared__ int32_t next[32];
  const int lane = threadIdx.x;
  next[lane] = (lane + 1) & 31;
  __syncwarp();
  volatile int32_t* vnext = next;
  int x = (lane + 1) & 31;
  if (kind == 0) {
    for (int i = 0; i < steps; ++i) x = __shfl_sync(UF_FULL, x, x);
  } else {
    for (int i = 0; i < steps; ++i) x = vnext[x];
  }
  out[lane] = x;
}

// out: 32 int32 (the chains' ends, kept so that no round is dropped).
extern "C" int uf_probe_launch(int steps, int kind, void* out, void* stream) {
  if (steps < 0 || kind < 0 || kind > 1) return (int)cudaErrorInvalidValue;
  uf_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(steps, kind, (int32_t*)out);
  return (int)cudaGetLastError();
}
