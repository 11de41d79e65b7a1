"""Configuration: the reference's flag vocabulary as a dataclass.

Mirrors ``Main.checkInputParameters`` / ``HDBSCANStarParameters``
(``main/Main.java:417-528,620-638``): ``file=``, ``clusterName=``,
``constraints=``, ``minPts=``, ``k=`` (sample fraction), ``processing_units=``
(per-partition block capacity), ``minClSize=``, ``compact=``,
``dist_function=`` in {euclidean, cosine, pearson, manhattan, supremum}.
Defaults match the reference (Euclidean, non-compact, ``main/Main.java:419-420``).
The reference shadows argv with hard-coded args (``main/Main.java:71``) —
treated as a bug; ``from_args`` really parses.

The PyTorch port's copy of ``hdbscan_tpu/config.py``: the same fields, flag
vocabulary and eager validation, so both packages run one configuration
(``HDBSCANParams.from_dict(dataclasses.asdict(params))`` carries a
reference instance across). Fields that only select reference engines
(``scan_backend``, ``fit_sharding``, ``knn_index``, ...) keep their
vocabulary here; the port's entry points raise ``NotImplementedError`` for
the values whose engine is not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

from hdbscan_tpu_torch.core.distances import METRICS


@dataclass
class HDBSCANParams:
    input_file: str = ""
    min_points: int = 4
    min_cluster_size: int = 4
    processing_units: int = 50  # per-block capacity ("subset fits one worker")
    k: float = 0.2  # stratified sample fraction per oversized subset
    dist_function: str = "euclidean"
    compact_hierarchy: bool = False
    constraints_file: str | None = None
    cluster_name: str = "local"  # Spark master analog; kept for CLI parity
    out_dir: str | None = None
    self_edges: bool = True
    seed: int = 0
    #: Approximation variant for oversized subsets (BASELINE.md columns):
    #: "db" = recursive sampling + data bubbles (the reference's live pipeline);
    #: "rs" = simple recursive sampling (cluster the sample points directly,
    #: the paper's RS baseline — quoted-numbers-only in the reference).
    variant: str = "db"
    #: Harvest exact inter-subset MST "glue" edges with per-level tiled
    #: Borůvka rounds, and re-weight sample-derived inter-edges with true
    #: point-space distances (the reference carries the bubble-corrected
    #: dmreach into the global merge, ``main/Main.java:248-265``, whose
    #: sample-spacing-scale weights fragment the global tree). Set False for
    #: reference-faithful edge pooling.
    exact_inter_edges: bool = True
    #: Compute core distances GLOBALLY (one tiled O(n^2 d) device pass)
    #: instead of per-block. Per-block core distances inflate at partition
    #: boundaries (a point's true neighbors may sit in another block), which
    #: distorts MRD edge weights and noise exit levels and makes quality
    #: depend on where the partitioner cut — the reference's dead exact path
    #: broadcasts the whole dataset for the same reason
    #: (``mappers/CoreDistanceMapper.java:57-112``). Set False for
    #: reference-faithful per-subset core distances (``mappers/FirstStep``).
    global_core_distances: bool = True
    #: Post-merge refinement rounds for the distributed pipeline: seed tiled
    #: Borůvka with the condensed tree's leaf clusters (every point's deepest
    #: cluster), harvest the exact minimum MRD edges between them (true MST
    #: edges by the cut property), rebuild the tree, repeat. Repairs the
    #: saddle edges the per-partition pooling carried at slightly-too-heavy
    #: weights — on lattice-valued data one displaced saddle edge moves a
    #: whole region into a later merge wave and flips the flat cut. 0
    #: disables (reference-faithful: the reference never refines).
    refine_iterations: int = 1
    #: FLAT-CUT-level refinement rounds (r5): after the tree is built, seed
    #: tiled Borůvka with the flat labels (noise points as singleton
    #: components), harvest the exact min MRD edges crossing that partition,
    #: rebuild, repeat until labels stop changing or the budget runs out.
    #: This repairs pool incompleteness at the TOP of the tree — the
    #: measured source of the cross-draw flat-cut spread on lattice data
    #: (draws' pools miss different top-structure MST edges; leaf-cluster
    #: refinement is too fine to see them). Measured on the Skin 45-seed
    #: protocol (seed_sweep45_skin_r5.jsonl): draws converge onto the
    #: exact tree's reading (ARI 0.6925 vs single-draw mean 0.595 std
    #: 0.035). Applies to the global-core (non-boundary) pipeline; 0
    #: disables (reference behavior — the reference never refines).
    refine_flat_iterations: int = 0
    #: Boundary-aware hybrid quality mode (sub-quadratic at DB quality).
    #: When > 0: the fraction of each final block treated as "boundary" —
    #: points whose seam margin (distance to the nearest other-subset sample
    #: minus distance to their own, recorded at every level's assignment) is
    #: smallest. Only those m = boundary_quality·n points pay exact global
    #: core distances (one O(m·n·d) scan) and host the inter-block Borůvka
    #: glue + refinement (O(m²·d) per round); interior points keep per-block
    #: cores (their k-NN ball is inside their block by construction), and the
    #: whole pooled edge set is re-weighted to mutual reachability under the
    #: hybrid core vector. Supersedes ``global_core_distances`` and the
    #: per-level full-set glue scans, replacing every O(n²·d) quality pass —
    #: the scale mode for the paper's 8-11.6M-row datasets (BASELINE.md).
    boundary_quality: float = 0.0
    #: Block-adjacency-aware candidate columns for the boundary phase
    #: (``ops/blockscan.py``): each boundary point's exact-core rescan and
    #: the inter-block glue/refinement rounds scan only the blocks its k-NN
    #: ball (bounded by the per-block core distance) or the per-component
    #: edge bounds can reach — O(m · seam-degree · cap) instead of O(m·n)
    #: and O(m²) — with exactness preserved by conservative f64
    #: centroid/radius bounds (same results as the full sweeps; pinned by
    #: tests/unit/test_blockscan.py). Auto-falls back to the full sweeps on
    #: non-triangle-inequality metrics (cosine/pearson). Set False to force
    #: the full sweeps everywhere.
    boundary_block_pruning: bool = True
    #: Boundary-mode at-risk criterion multiplier: a point joins the exact
    #: core rescan when its seam margin <= boundary_alpha * per-block core
    #: (margin upper-bounds the seam distance, the per-block core
    #: upper-bounds the k-NN ball radius, so 1.0 captures every point whose
    #: ball can cross a seam — the measured-correct default; see
    #: models/mr_hdbscan._BOUNDARY_ALPHA provenance).
    boundary_alpha: float = 1.0
    #: Hard cap on the boundary-set fraction (non-pruned path only; the
    #: block-pruned path has no cap — its rescan cost scales with candidate
    #: windows, not m). The adaptive at-risk criterion is open-ended by
    #: design; past ~half the dataset the non-pruned O(m·n·d) rescan
    #: approaches the full exact scan the mode exists to avoid, so selection
    #: truncates (most-at-risk first, floor preserved) and warns. Promoted
    #: from a module constant (VERDICT r4 weak #6) so a user who accepts the
    #: ~n² cost can buy the cap back without editing source.
    boundary_max_frac: float = 0.5
    #: Glue-set deep-crossing criterion: rows with margin <=
    #: glue_alpha * core join the per-block lowest-margin floor as
    #: candidate hosts of inter-block MST edges (the min-MRD pair is not
    #: necessarily the geometrically closest pair). Measured at 1M sep-7:
    #: floor alone drops vs-exact fidelity 0.95 -> 0.90.
    glue_alpha: float = 0.5
    #: Cap on the glue set as a multiple of the per-block floor set
    #: (smallest margins kept first). Glue/refine round cost scales with
    #: the SQUARE of this factor when rounds go dense; measured at 4M
    #: sep-7: factor 3 scores ARI-vs-truth 0.9558, factor 6 scores 0.9535
    #: at ~1.1x the wall (r4 — growing the deep tier PARTIALLY is not a
    #: quality lever; the 0.9754 high-water mark needs the whole tier,
    #: see glue_row_budget = -1 below).
    glue_max_factor: int = 3
    #: Optional row-count TARGET for the glue/refine subset — the exact-tree
    #: FIDELITY knob. When > 0 and the factor-capped set is below it, the
    #: glue set grows with further at-risk rows (deep-crossing first, then
    #: ascending seam margin) until the budget or the at-risk pool runs out.
    #: -1 = the whole deep-crossing tier with no at-risk filler and no cap
    #: (glue = floor ∪ {margin <= glue_alpha*core}) — the 4M sep-7 quality
    #: high-water composition (see models/mr_hdbscan._select_boundary).
    #: Measured at 1M sep-7 (boundary_eval_r4.jsonl): glue_rows=1048576
    #: lifts ARI-vs-exact 0.9058 -> 0.9507 (the r2 fidelity level) at 2x the
    #: boundary wall and slightly LOWER ARI-vs-truth (0.9459 -> 0.9266 —
    #: the floor-glue tree's deviations from exact act as regularization at
    #: overlapping-cluster difficulty). Default 0 = factor-capped only:
    #: better truth, better wall; set a budget when the contract is
    #: "approximate the exact tree", not "maximize ground-truth ARI".
    glue_row_budget: int = 0
    #: Consensus across sample draws (``models/consensus.py``): > 1 runs the
    #: distributed pipeline that many times with distinct seeds and returns
    #: the evidence-accumulation consensus of the flat cuts — the stabilizer
    #: for lattice-valued data whose flat cut is bimodal across draws (Skin:
    #: per-draw ARI std 0.034 vs the paper's 0.002; the spread is structural,
    #: not fixable by refinement — ROADMAP r3). 1 = single draw (reference
    #: behavior).
    consensus_draws: int = 1
    #: Collapse duplicate rows into weighted unique points before the exact
    #: pipeline (``core/dedup.py``). Semantics-preserving (a duplicate group
    #: is a zero-extent bubble; the member-weighted tree equals the full-row
    #: tree) while the O(n^2 d) device scans shrink to unique-count scale —
    #: 4.8x fewer rows (23x less scan work) on the lattice-valued north-star
    #: set. Off by default for strict row-level reference parity.
    dedup_points: bool = False
    #: Cap on samples drawn per oversized subset (``k`` gives the fraction;
    #: this bounds the absolute count). The bubble model holds a dense
    #: (m, m) corrected-distance matrix plus ~6 same-shape temps on device:
    #: 16384 ≈ 1 GB per matrix ≈ 8 GB peak — the single-chip HBM budget.
    #: At 4M+ points an uncapped k=0.01 draw (40k+ samples, pow2-padded to
    #: 65536) compiles a 17 GB matrix and OOMs a 15.75 GB chip; the cap
    #: trades first-level partition granularity (more recursion levels)
    #: for bounded memory. The reference has the same cliff un-handled: its
    #: sampleByKeyExact fraction is unbounded per worker. The sample axis is
    #: pow2-PADDED on device, so the effective cap is rounded DOWN to a
    #: power of two (a non-pow2 value would silently bound memory at up to
    #: 2x the configured footprint).
    max_samples: int = 16384
    #: Reproduce the reference's LIVE integer-math CF behaviors instead of
    #: the correct double math (``core/compat.py``): CombineStep's
    #: mean-of-per-dim-sqrt extent and collapsed nnDist exponent
    #: (``CombineStep.java:28,42-57``) and the bubble core-distance walk with
    #: its stale shared ``indexBubbles`` buffer, i-vs-index confusion and
    #: integer-division exponents (``HdbscanDataBubbles.java:75-146``). For
    #: output parity with a reference RUN rather than with the paper. Off by
    #: default (SURVEY.md §7 parity-vs-bug decisions).
    compat_cf_int_math: bool = False
    #: Device backend for the exact k-NN scans (``ops/tiled`` core distances
    #: and the boundary-mode window-merge rescan in ``ops/blockscan``):
    #: "auto" (default) picks the Pallas distance kernel + XLA top_k on TPU
    #: and the guarded XLA scan elsewhere; "xla" forces the guarded XLA
    #: scan; "pallas" forces the distance-only Pallas kernel (raises when
    #: ineligible); "fused" selects neighbors on-chip next to the distance
    #: tiles (``ops/pallas_knn.knn_core_distances_fused`` — the r6
    #: selection-bound fix, see utils/flops.py docstring) and silently
    #: falls back to the guarded XLA scan when the shape/metric/platform is
    #: ineligible, so the knob is safe under every parameterization.
    knn_backend: str = "auto"
    #: Distance-tile precision of the FUSED forest-query program
    #: (``knn_backend="fused"`` + ``knn_index="rpforest"``,
    #: ``ops/pallas_forest``): "f32" (default) is bitwise identical to the
    #: unfused engine; "bf16" computes the leaf/rescan distance tiles from
    #: bf16 MXU operands with f32 accumulation and re-distances the
    #: surviving k-best exactly in f32 (``pallas_forest.refine_f32``) —
    #: euclidean only, quality pinned by the recall/ARI gate in
    #: tests/unit/test_pallas_forest.py. Every other path ignores the knob
    #: and stays f32-exact.
    knn_precision: str = "f32"
    #: Neighbor-graph TIER for the core-distance scans — orthogonal to
    #: ``knn_backend`` (which picks the kernel evaluating distance tiles):
    #: "exact" (default) runs the O(n² d) scans bitwise-unchanged,
    #: "rpforest" runs the sub-quadratic random-projection-forest engine
    #: (``ops/rpforest.py`` — T trees, per-leaf dense k-NN, multi-tree lex
    #: merge, neighbor-of-neighbor rescan; README "Approximate neighbors"),
    #: "auto" picks rpforest at ``n >= knn_index_threshold`` points.
    knn_index: str = "exact"
    #: The ``knn_index="auto"`` flip point (points). Below it fits stay
    #: bitwise-exact; at/above it the rp-forest engine runs (measured >= 3x
    #: core-distance win already at 200k on CPU, BENCH_r06.json).
    knn_index_threshold: int = 262144
    #: Random-projection trees per forest. More trees raise recall at
    #: linear build/query cost; 4 trees + 1 rescan round measured >= 0.95
    #: mean recall@16 across the tier-1 sweep datasets.
    rpf_trees: int = 4
    #: Leaf capacity of each tree (points). Per-leaf scan work is
    #: O(n · leaf_size · d) per tree; internally clamped to >= 2k + 2 so
    #: every leaf can supply a full candidate list.
    rpf_leaf_size: int = 1024
    #: Neighbor-of-neighbor rescan rounds after the multi-tree merge
    #: (cross-leaf recall repair, PANDA-style). 0 disables.
    rpf_rescan_rounds: int = 1
    #: Scale-out engine for the exact-path scans (core distances, Borůvka
    #: rounds, the mr-hdbscan glue + boundary rescan): "host" keeps the
    #: column-replicated scans (each device holds a full data copy; the
    #: pre-ring behavior), "ring" shards rows AND columns over the mesh and
    #: circulates column panels via ``lax.ppermute`` (``parallel/ring.py``
    #: — per-device HBM drops to O(n/devices · d), neighbor exchange
    #: overlaps compute), "auto" (default) picks ring on multi-device TPU
    #: meshes and host elsewhere. Outputs are bitwise identical across
    #: backends (ring parity tests, tests/unit/test_ring.py).
    scan_backend: str = "auto"
    #: End-to-end partition tier (``parallel/shard.py``): "replicated" keeps
    #: the existing engines (some phase somewhere holds a full point-set copy
    #: per device — the pre-shard behavior), "sharded" runs ONE partitioned
    #: program — row-sharded core distances (ring k-NN or the per-shard
    #: rp-forest build + ring-circulated candidate-panel exchange) feeding
    #: fully row-sharded Borůvka rounds. With ``mst_backend="host"`` the
    #: rounds contract on host (per-round edge all-gather); with
    #: ``mst_backend="device"``/"auto" the whole contraction cascade runs
    #: in-jit (scatter-min tie-break, cross-device panel reduction,
    #: pointer-doubling collapse inside one ``while_loop``) and the fit makes
    #: exactly ONE host sync — the final edge fetch feeding the device merge
    #: forest. Per-device HBM stays O(n/devices · d) in every phase — the
    #: program the ``--assert-not-replicated`` gate certifies. The MR
    #: pipeline honors the tier too: global cores (weighted dedup scan
    #: included), the boundary rescan, and every Borůvka glue harvest route
    #: through the sharded scanners (block pruning is disabled under sharded
    #: — its windowed scans keep replicated geometry panels). "auto"
    #: (default) picks sharded on multi-device TPU meshes and replicated
    #: elsewhere. With ``knn_index="exact"`` the sharded fit is bitwise
    #: identical to the replicated one (forced-8-device parity tests).
    fit_sharding: str = "auto"
    #: Host finalize engine for the condensed-tree tail (``core/tree.py`` vs
    #: ``core/tree_vec.py``): "reference" keeps the per-node Python
    #: condense/EOM/label walk (the parity oracle), "vectorized" runs the
    #: array-level engine (pointer-jumped chain/exit propagation +
    #: ``np.add.at`` segment-sum stabilities — bitwise-identical outputs),
    #: "auto" (default) picks vectorized whenever the inputs support it
    #: (integral point weights; ``tree_vec.supports_inputs``) and falls back
    #: to reference otherwise. Applies to every finalize call site, including
    #: the per-iteration rebuilds of the refine/refine_flat loops.
    tree_backend: str = "auto"
    #: MST -> merge-forest engine for the exact path (``core/mst_device.py``):
    #: "host" keeps the per-round host contraction glue plus the sequential
    #: host forest builder (the parity oracle), "device" runs every Borůvka
    #: round in one jitted program and builds the merge forest from a single
    #: device union-find scan — exactly ONE host sync per fit (trace event
    #: ``host_sync``), "auto" (default) picks device at/above
    #: ``core/mst_device.MST_DEVICE_THRESHOLD`` vertices when the edge pool
    #: is eligible (``mst_device.supports_inputs`` — no near-tied-but-unequal
    #: weights, integral point weights) and host otherwise. Device output is
    #: bitwise-identical to host on every MergeForest/CondensedTree field;
    #: ineligible pools fall back to the host builder (flagged in the trace).
    mst_backend: str = "auto"
    #: Persistent XLA compilation cache: "auto" (default) enables it at the
    #: default directory (``utils/cache.py`` — ``$JAX_COMPILATION_CACHE_DIR``
    #: or ``~/.cache/hdbscan_tpu_xla``), "off" disables it, any other value
    #: is used as the cache directory path. Cache hits vs fresh compiles are
    #: recorded in the run report (``utils/telemetry.cache_hit_counter``).
    compile_cache: str = "auto"
    #: Serving k-NN engine for ``serve/predict`` (the ``predict``/``serve``
    #: CLI commands): "xla" runs the guarded tiled scan, "fused" the Pallas
    #: fused-selection kernel (falls back to xla when the shape/metric/
    #: platform is ineligible — same safety contract as ``knn_backend``),
    #: "rpforest" queries the model artifact's random-projection-forest
    #: index (requires a model saved from a ``knn_index=rpforest`` fit —
    #: approximate neighbors, O(trees · leaf_size) per query instead of
    #: O(n)), "auto" (default) picks fused on eligible TPU shapes.
    predict_backend: str = "auto"
    #: Largest serving bucket: query batches pad into power-of-two buckets
    #: up to this many rows (floor 8) and larger requests chunk. Every
    #: bucket is AOT-warmed at server start, so steady-state serving
    #: recompiles nothing.
    predict_max_batch: int = 256
    #: Streaming ingest (``serve --ingest`` / ``hdbscan_tpu/stream``):
    #: near-duplicate absorb slack — an arriving point is folded into its
    #: cluster's bubble summary when its attachment mutual-reachability
    #: level is within ``(1 + frac)`` of the cluster's ``eps_min`` density
    #: level (0 absorbs only probability-1.0 rows + exact duplicates).
    stream_absorb_eps_frac: float = 0.25
    #: Drift statistic over the streaming GLOSH-score histogram vs the
    #: fit-time baseline: "psi" (Population Stability Index) or "ks"
    #: (Kolmogorov-Smirnov distance over the same bins).
    stream_drift_stat: str = "psi"
    #: Drift flag level for ``stream_drift_stat`` (and the assignment-rate
    #: PSI). The baseline histogram is the *training rows'* GLOSH scores,
    #: and fresh in-distribution draws score systematically higher than the
    #: rows the model was fit on, so the textbook PSI scale (0.2 =
    #: significant) does not transfer: in-distribution streams read ~0.3-0.5
    #: here while genuine shift reads an order of magnitude above (see
    #: tests/e2e/test_stream_e2e.py). 2.0 separates the two regimes.
    stream_drift_threshold: float = 2.0
    #: Novel-row budget: a background re-fit also triggers once this many
    #: non-absorbed rows are buffered, drift or not.
    stream_refit_budget: int = 2048
    #: What happens when a re-fit publishes an artifact: "auto" hot-swaps it
    #: in (blue/green), "manual" stages it for an operator ``POST /swap``.
    stream_reload: str = "auto"
    #: Bound on the serving micro-batcher's request queue (``serve`` CLI /
    #: ``ClusterServer``): a submit arriving with this many requests already
    #: queued is refused with HTTP 503 + Retry-After (load shedding) instead
    #: of queueing unboundedly — under sustained overload the server sheds
    #: rather than growing an unservable backlog. 0 = unbounded (the
    #: pre-fault-layer behavior).
    serve_queue_bound: int = 1024
    #: Server-wide default request deadline in milliseconds (0 = none; the
    #: ``X-Deadline-Ms`` request header overrides per request). A request
    #: past its deadline fails fast with HTTP 504 — at enqueue or at batch
    #: assembly — instead of occupying a batch slot.
    serve_deadline_ms: float = 0.0
    #: Fault-injection spec for the chaos harness (``hdbscan_tpu/fault``):
    #: ``site:key=val,...;site2:...`` clauses (see fault/inject.py for the
    #: grammar and site names). "" = no injection; the
    #: ``HDBSCAN_TPU_FAULTS`` environment variable is the fallback source.
    fault_spec: str = ""
    #: Consecutive refit/swap failures that trip the refit circuit breaker
    #: open (the server then degrades to serving the pinned generation).
    circuit_failures: int = 3
    #: Seconds an open refit circuit waits before allowing a half-open
    #: trial re-fit.
    circuit_reset_s: float = 30.0
    #: Crash-safe stream durability (``stream/wal.StreamJournal``): journal
    #: directory for the fsync'd ingest WAL + periodic state snapshots.
    #: "" disables (ingest state is lost on crash, the pre-WAL behavior).
    stream_wal_dir: str = ""
    #: Ingest WAL appends between state snapshots (each snapshot truncates
    #: the WAL, bounding recovery replay).
    stream_snapshot_every: int = 64
    #: Online hierarchy maintenance (``hdbscan_tpu/incremental``): "off"
    #: (default) keeps the buffering behavior — novel rows buffer until a full
    #: background re-fit; "incremental" maintains the mutual-reachability
    #: MST in place per novel point (bounded rp-forest candidate query,
    #: cuSLINK-style cycle-edge replacement) and republishes the model via
    #: a cheap handle refresh, demoting the full re-fit to the
    #: circuit-gated fallback. Euclidean metric only.
    stream_maintain: str = "off"
    #: Per-point maintenance wall budget in milliseconds; an insert over
    #: budget is *counted* (``hdbscan_tpu_maintain_total{outcome=
    #: "over_budget"}``) but never changes state, so WAL replay stays a
    #: deterministic fold. 0 = unbounded.
    maintain_budget_ms: float = 0.0
    #: Dirty-work ceiling for one maintenance step, as the fraction of MST
    #: edges (and merge-forest nodes) the splice/finalize would have to
    #: reprocess. Above it the step raises ``MaintainFallback`` and the
    #: server falls back to the full re-fit. 1.0 = never refuse.
    maintain_dirty_max_frac: float = 1.0
    #: Inserts between maintained-model refreshes: the MST splice, the
    #: dirty-subtree finalize, and the blue/green handle refresh run every
    #: this many absorbed novel points (per-insert work stays O(candidates)
    #: regardless).
    maintain_refresh_every: int = 64
    #: Replica subprocesses behind the ``fleet`` CLI router
    #: (``hdbscan_tpu/fleet``): each is a full ``serve`` process sharing the
    #: model artifact / ``--model-dir``; the router spawns, health-checks,
    #: and routes across them.
    fleet_replicas: int = 2
    #: Fleet routing policy: "consistent_hash" pins a tenant (or body
    #: digest) to a stable replica via an md5 ring; "least_loaded" picks the
    #: replica with the fewest in-flight proxied requests.
    fleet_policy: str = "least_loaded"
    #: Fleet health-probe period in seconds — also the bound within which a
    #: dead replica stops receiving traffic, and the Retry-After hint when
    #: every replica is down.
    fleet_health_interval_s: float = 0.5
    #: SIGTERM drain bound for the fleet: a replica still alive this many
    #: seconds after the router forwards SIGTERM is SIGKILLed and the
    #: router exits nonzero.
    fleet_drain_s: float = 10.0
    #: Multi-tenant serving (``--tenants-dir``): max AOT-warmed tenant
    #: Predictors resident per replica; the coldest is evicted (with a
    #: ``tenant_evict`` trace event) when a miss would exceed it.
    tenant_lru_size: int = 8
    #: Per-tenant sustained request quota in requests/second (token bucket,
    #: burst = max(1, quota)); an over-quota request is refused with HTTP
    #: 429 + Retry-After. 0 = unlimited.
    tenant_quota_rps: float = 0.0
    #: Fleet autoscaler (``fleet/controlplane.py``): when enabled the
    #: ``fleet`` CLI runs the hysteresis loop over the router's queue-depth
    #: and p99 signals, scaling between the min/max bounds with
    #: warm-standby adds and drain-first removes.
    fleet_autoscale: bool = False
    #: Autoscaler lower bound on the replica set (>= 1).
    fleet_min_replicas: int = 1
    #: Autoscaler upper bound on the replica set (>= min).
    fleet_max_replicas: int = 4
    #: Per-up-replica in-flight requests above which an autoscaler tick
    #: votes scale-up (hysteresis: 2 consecutive votes scale).
    fleet_scale_high_load: float = 4.0
    #: Per-up-replica in-flight requests below which a tick votes
    #: scale-down (5 consecutive idle votes scale; must be < high).
    fleet_scale_low_load: float = 0.5
    #: Rolling fleet p99 (seconds) above which a tick votes scale-up and
    #: vetoes scale-down. 0 disables the latency signal.
    fleet_scale_p99_s: float = 0.0
    #: Hold after any scale operation before the next decision, so the
    #: fleet re-equilibrates on the new topology.
    fleet_scale_cooldown_s: float = 2.0
    #: Per-host zero-copy artifact store (``fleet/artifacts.py``):
    #: "shared" loads tenant artifacts through the digest-keyed mmap spool
    #: (one resident copy per host, shared across replicas); "off"
    #: (default) keeps private per-registry loads.
    fleet_artifact_store: str = "off"
    #: Fit-as-a-service worker pool size (``fleet/jobs.py``): concurrent
    #: background fits a scheduler runs.
    fit_job_workers: int = 2
    #: Bound on queued-but-not-running fit jobs; an overflowing submit is
    #: refused with HTTP 503 semantics.
    fit_job_queue_bound: int = 16
    #: Sustained per-tenant fit-job rate (token bucket, burst 1); an
    #: over-quota submit is refused with HTTP 429 + Retry-After.
    #: 0 = unlimited.
    fit_job_quota_rps: float = 0.0
    #: Minimum spacing between emitted ``heartbeat`` trace events per
    #: progress task (``hdbscan_tpu/obs`` — Borůvka rounds, ring panel
    #: sweeps, rpforest tree builds, refits). Beats arriving faster are
    #: throttled; the liveness clock still refreshes on every beat.
    heartbeat_s: float = 1.0
    #: Hang-watchdog stall budget in seconds: with fit/refit tasks active
    #: and no heartbeat for this long, a watchdog thread dumps every Python
    #: thread's stack to the trace (``watchdog_stall``) and stderr, and
    #: bumps ``hdbscan_tpu_watchdog_stalls_total``. 0 (default) disables
    #: the watchdog thread.
    watchdog_s: float = 0.0
    #: Bound on the Tracer's in-memory event list (0 = unbounded). Sinks
    #: (the on-disk JSONL trace) always see every event; the bound only
    #: rings the in-memory view so a long-running ``serve --ingest``
    #: process — one predict_batch + stream_ingest + request_span per
    #: request, forever — cannot grow without limit. Dropped events are
    #: counted (``Tracer.events_dropped``) and noted in the summary.
    trace_max_events: int = 100_000
    #: Straggler trip ratio for the per-device timeline recorder
    #: (``hdbscan_tpu/obs/timeline.py``): a device whose per-round wall is
    #: >= this multiple of the round's median wall counts as slow. Must be
    #: >= 1.
    obs_skew_threshold: float = 2.0
    #: Consecutive slow rounds before a ``straggler_flag`` event fires (and
    #: ``hdbscan_tpu_straggler_flags_total{device}`` increments). Must be
    #: >= 1.
    obs_straggler_rounds: int = 3
    #: JSONL trace-file rotation bound in bytes (``JsonlSink``): when the
    #: next line would push ``trace.jsonl`` past this size it moves to
    #: ``trace.jsonl.1`` and a fresh file opens (seq continues; at most two
    #: files ever exist). 0 disables rotation. Default 256 MiB.
    trace_rotate_bytes: int = 268_435_456
    # Output file names derived from the input path (main/Main.java:516-526):

    def __post_init__(self):
        if self.dist_function not in METRICS:
            raise ValueError(
                f"dist_function must be one of {METRICS}, got {self.dist_function!r}"
            )
        if self.min_points < 1 or self.min_cluster_size < 1:
            raise ValueError("minPts and minClSize must be >= 1")
        if not (0.0 < self.k <= 1.0):
            raise ValueError("k (sample fraction) must be in (0, 1]")
        if self.processing_units < 1:
            raise ValueError("processing_units must be >= 1")
        if self.max_samples < 2:
            raise ValueError("max_samples must be >= 2")
        if self.variant not in ("db", "rs"):
            raise ValueError(f"variant must be 'db' or 'rs', got {self.variant!r}")
        if not (0.0 <= self.boundary_quality < 1.0):
            raise ValueError("boundary_quality must be in [0, 1)")
        if self.boundary_alpha <= 0 or self.glue_alpha < 0:
            raise ValueError("boundary_alpha must be > 0, glue_alpha >= 0")
        if not (0.0 < self.boundary_max_frac <= 1.0):
            raise ValueError("boundary_max_frac must be in (0, 1]")
        if self.glue_max_factor < 1:
            raise ValueError("glue_max_factor must be >= 1")
        if self.glue_row_budget < -1:
            raise ValueError("glue_row_budget must be >= 0, or -1 for the "
                             "uncapped deep-crossing tier")
        if self.consensus_draws < 1:
            raise ValueError("consensus_draws must be >= 1")
        if self.scan_backend not in ("auto", "host", "ring"):
            raise ValueError(
                "scan_backend must be 'auto', 'host' or 'ring', "
                f"got {self.scan_backend!r}"
            )
        if self.fit_sharding not in ("auto", "replicated", "sharded"):
            raise ValueError(
                "fit_sharding must be 'auto', 'replicated' or 'sharded', "
                f"got {self.fit_sharding!r}"
            )
        if self.tree_backend not in ("auto", "reference", "vectorized"):
            raise ValueError(
                "tree_backend must be 'auto', 'reference' or 'vectorized', "
                f"got {self.tree_backend!r}"
            )
        if self.mst_backend not in ("auto", "host", "device"):
            raise ValueError(
                "mst_backend must be 'auto', 'host' or 'device', "
                f"got {self.mst_backend!r}"
            )
        if not self.compile_cache:
            raise ValueError(
                "compile_cache must be 'auto', 'off' or a directory path"
            )
        if self.knn_backend not in ("auto", "xla", "pallas", "fused"):
            raise ValueError(
                "knn_backend must be 'auto', 'xla', 'pallas' or 'fused', "
                f"got {self.knn_backend!r}"
            )
        if self.knn_precision not in ("f32", "bf16"):
            raise ValueError(
                "knn_precision must be 'f32' or 'bf16', "
                f"got {self.knn_precision!r}"
            )
        if self.predict_backend not in ("auto", "xla", "fused", "rpforest"):
            raise ValueError(
                "predict_backend must be 'auto', 'xla', 'fused' or "
                f"'rpforest', got {self.predict_backend!r}"
            )
        if self.knn_index not in ("auto", "exact", "rpforest"):
            raise ValueError(
                "knn_index must be 'auto', 'exact' or 'rpforest', "
                f"got {self.knn_index!r}"
            )
        if self.knn_index_threshold < 1:
            raise ValueError("knn_index_threshold must be >= 1")
        if self.rpf_trees < 1:
            raise ValueError("rpf_trees must be >= 1")
        if self.rpf_leaf_size < 4:
            raise ValueError("rpf_leaf_size must be >= 4")
        if self.rpf_rescan_rounds < 0:
            raise ValueError("rpf_rescan_rounds must be >= 0")
        if self.predict_max_batch < 1:
            raise ValueError("predict_max_batch must be >= 1")
        if self.stream_absorb_eps_frac < 0:
            raise ValueError(
                "stream_absorb_eps_frac must be >= 0, "
                f"got {self.stream_absorb_eps_frac!r}"
            )
        if self.stream_drift_stat not in ("psi", "ks"):
            raise ValueError(
                "stream_drift_stat must be 'psi' or 'ks', "
                f"got {self.stream_drift_stat!r}"
            )
        if not self.stream_drift_threshold > 0:
            raise ValueError(
                "stream_drift_threshold must be > 0, "
                f"got {self.stream_drift_threshold!r}"
            )
        if self.stream_refit_budget < 1:
            raise ValueError(
                "stream_refit_budget must be >= 1, "
                f"got {self.stream_refit_budget!r}"
            )
        if self.stream_reload not in ("auto", "manual"):
            raise ValueError(
                "stream_reload must be 'auto' or 'manual', "
                f"got {self.stream_reload!r}"
            )
        if self.serve_queue_bound < 0:
            raise ValueError(
                "serve_queue_bound must be >= 0 (0 = unbounded), "
                f"got {self.serve_queue_bound!r}"
            )
        if self.serve_deadline_ms < 0:
            raise ValueError(
                "serve_deadline_ms must be >= 0 (0 = no deadline), "
                f"got {self.serve_deadline_ms!r}"
            )
        if self.fault_spec:
            from hdbscan_tpu_torch.fault.inject import parse_spec

            parse_spec(self.fault_spec)  # bad specs fail here
        if self.circuit_failures < 1:
            raise ValueError(
                f"circuit_failures must be >= 1, got {self.circuit_failures!r}"
            )
        if not self.circuit_reset_s > 0:
            raise ValueError(
                f"circuit_reset_s must be > 0, got {self.circuit_reset_s!r}"
            )
        if self.stream_snapshot_every < 1:
            raise ValueError(
                "stream_snapshot_every must be >= 1, "
                f"got {self.stream_snapshot_every!r}"
            )
        if self.stream_maintain not in ("off", "incremental"):
            raise ValueError(
                "stream_maintain must be 'off' or 'incremental', "
                f"got {self.stream_maintain!r}"
            )
        if self.maintain_budget_ms < 0:
            raise ValueError(
                "maintain_budget_ms must be >= 0 (0 = unbounded), "
                f"got {self.maintain_budget_ms!r}"
            )
        if not (0.0 < self.maintain_dirty_max_frac <= 1.0):
            raise ValueError(
                "maintain_dirty_max_frac must be in (0, 1], "
                f"got {self.maintain_dirty_max_frac!r}"
            )
        if self.maintain_refresh_every < 1:
            raise ValueError(
                "maintain_refresh_every must be >= 1, "
                f"got {self.maintain_refresh_every!r}"
            )
        if self.fleet_replicas < 1:
            raise ValueError(
                f"fleet_replicas must be >= 1, got {self.fleet_replicas!r}"
            )
        if self.fleet_policy not in ("consistent_hash", "least_loaded"):
            raise ValueError(
                "fleet_policy must be 'consistent_hash' or 'least_loaded', "
                f"got {self.fleet_policy!r}"
            )
        if not self.fleet_health_interval_s > 0:
            raise ValueError(
                "fleet_health_interval_s must be > 0, "
                f"got {self.fleet_health_interval_s!r}"
            )
        if not self.fleet_drain_s > 0:
            raise ValueError(
                f"fleet_drain_s must be > 0, got {self.fleet_drain_s!r}"
            )
        if self.tenant_lru_size < 1:
            raise ValueError(
                f"tenant_lru_size must be >= 1, got {self.tenant_lru_size!r}"
            )
        if self.tenant_quota_rps < 0:
            raise ValueError(
                "tenant_quota_rps must be >= 0 (0 = unlimited), "
                f"got {self.tenant_quota_rps!r}"
            )
        if self.fleet_min_replicas < 1:
            raise ValueError(
                f"fleet_min_replicas must be >= 1, got {self.fleet_min_replicas!r}"
            )
        if self.fleet_max_replicas < self.fleet_min_replicas:
            raise ValueError(
                "fleet_max_replicas must be >= fleet_min_replicas "
                f"({self.fleet_min_replicas}), got {self.fleet_max_replicas!r}"
            )
        if not self.fleet_scale_high_load > self.fleet_scale_low_load:
            raise ValueError(
                "fleet_scale_high_load must exceed fleet_scale_low_load, "
                f"got {self.fleet_scale_high_load!r} <= "
                f"{self.fleet_scale_low_load!r}"
            )
        if self.fleet_scale_p99_s < 0:
            raise ValueError(
                "fleet_scale_p99_s must be >= 0 (0 = latency signal off), "
                f"got {self.fleet_scale_p99_s!r}"
            )
        if self.fleet_scale_cooldown_s < 0:
            raise ValueError(
                "fleet_scale_cooldown_s must be >= 0, "
                f"got {self.fleet_scale_cooldown_s!r}"
            )
        if self.fleet_artifact_store not in ("shared", "off"):
            raise ValueError(
                "fleet_artifact_store must be 'shared' or 'off', "
                f"got {self.fleet_artifact_store!r}"
            )
        if self.fit_job_workers < 1:
            raise ValueError(
                f"fit_job_workers must be >= 1, got {self.fit_job_workers!r}"
            )
        if self.fit_job_queue_bound < 1:
            raise ValueError(
                "fit_job_queue_bound must be >= 1, "
                f"got {self.fit_job_queue_bound!r}"
            )
        if self.fit_job_quota_rps < 0:
            raise ValueError(
                "fit_job_quota_rps must be >= 0 (0 = unlimited), "
                f"got {self.fit_job_quota_rps!r}"
            )
        if not self.heartbeat_s > 0:
            raise ValueError(
                f"heartbeat_s must be > 0, got {self.heartbeat_s!r}"
            )
        if self.watchdog_s < 0:
            raise ValueError(
                "watchdog_s must be >= 0 (0 = watchdog off), "
                f"got {self.watchdog_s!r}"
            )
        if not self.obs_skew_threshold >= 1.0:
            raise ValueError(
                "obs_skew_threshold must be >= 1.0, "
                f"got {self.obs_skew_threshold!r}"
            )
        if self.obs_straggler_rounds < 1:
            raise ValueError(
                "obs_straggler_rounds must be >= 1, "
                f"got {self.obs_straggler_rounds!r}"
            )
        if self.trace_rotate_bytes < 0:
            raise ValueError(
                "trace_rotate_bytes must be >= 0 (0 = rotation off), "
                f"got {self.trace_rotate_bytes!r}"
            )
        if self.trace_max_events < 0:
            raise ValueError(
                "trace_max_events must be >= 0 (0 = unbounded), "
                f"got {self.trace_max_events!r}"
            )
        if self.boundary_quality > 0 and self.dedup_points:
            raise ValueError(
                "boundary_quality and dedup_points are mutually exclusive "
                "(dedup requires global core distances; boundary mode "
                "replaces them)"
            )

    @property
    def base_name(self) -> str:
        stem = os.path.basename(self.input_file) or "output"
        return os.path.splitext(stem)[0]

    def output_path(self, kind: str) -> str:
        """The 5 canonical outputs (main/Main.java:534-614): hierarchy, tree,
        partition, outlier_scores, visualization."""
        suffix = {
            "hierarchy": "_hierarchy.csv",
            "tree": "_tree.csv",
            "partition": "_partition.csv",
            "outlier_scores": "_outlier_scores.csv",
            "visualization": "_visualization.vis",
        }[kind]
        out_dir = self.out_dir or os.path.dirname(self.input_file) or "."
        return os.path.join(out_dir, self.base_name + suffix)

    @classmethod
    def from_args(cls, argv: list[str]) -> "HDBSCANParams":
        """Parse the reference's ``key=value`` flag strings."""
        kwargs = {}
        for arg in argv:
            if "=" not in arg:
                raise ValueError(f"malformed flag {arg!r}; expected key=value")
            key, _, value = arg.partition("=")
            if key not in FLAG_FIELDS:
                raise ValueError(f"unknown flag {key!r}")
            field, conv = FLAG_FIELDS[key]
            kwargs[field] = conv(value)
        return cls(**kwargs)

    def replace(self, **kw) -> "HDBSCANParams":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "HDBSCANParams":
        """Build from a field dict (``dataclasses.asdict`` of either package's
        params); unknown keys raise, like an unknown flag."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - names)
        if unknown:
            raise ValueError(f"unknown HDBSCANParams fields {unknown}")
        return cls(**d)


def _bool(s: str) -> bool:
    return s.lower() == "true"


#: CLI flag -> (dataclass field, converter). Module-level so harnesses that
#: need the flag->field correspondence (e.g. benchmarks/boundary_eval.py
#: override echoing) share one copy instead of re-declaring it.
FLAG_FIELDS = {
    "file": ("input_file", str),
    "minPts": ("min_points", int),
    "minClSize": ("min_cluster_size", int),
    "processing_units": ("processing_units", int),
    "k": ("k", float),
    "dist_function": ("dist_function", str),
    "compact": ("compact_hierarchy", _bool),
    "constraints": ("constraints_file", str),
    "clusterName": ("cluster_name", str),
    "out_dir": ("out_dir", str),
    "seed": ("seed", int),
    "variant": ("variant", str),
    "dedup": ("dedup_points", _bool),
    "exact_inter_edges": ("exact_inter_edges", _bool),
    "global_cores": ("global_core_distances", _bool),
    "refine": ("refine_iterations", int),
    "refine_flat": ("refine_flat_iterations", int),
    "boundary": ("boundary_quality", float),
    "boundary_alpha": ("boundary_alpha", float),
    "boundary_max_frac": ("boundary_max_frac", float),
    "glue_alpha": ("glue_alpha", float),
    "glue_factor": ("glue_max_factor", int),
    "glue_rows": ("glue_row_budget", int),
    "consensus": ("consensus_draws", int),
    "block_pruning": ("boundary_block_pruning", _bool),
    "knn_backend": ("knn_backend", str),
    "knn_precision": ("knn_precision", str),
    "knn_index": ("knn_index", str),
    "knn_index_threshold": ("knn_index_threshold", int),
    "rpf_trees": ("rpf_trees", int),
    "rpf_leaf_size": ("rpf_leaf_size", int),
    "rpf_rescan": ("rpf_rescan_rounds", int),
    "scan_backend": ("scan_backend", str),
    "fit_sharding": ("fit_sharding", str),
    "tree_backend": ("tree_backend", str),
    "mst_backend": ("mst_backend", str),
    "compile_cache": ("compile_cache", str),
    "predict_backend": ("predict_backend", str),
    "predict_batch": ("predict_max_batch", int),
    "absorb_eps": ("stream_absorb_eps_frac", float),
    "drift_stat": ("stream_drift_stat", str),
    "drift_threshold": ("stream_drift_threshold", float),
    "refit_budget": ("stream_refit_budget", int),
    "stream_reload": ("stream_reload", str),
    "queue_bound": ("serve_queue_bound", int),
    "deadline_ms": ("serve_deadline_ms", float),
    "faults": ("fault_spec", str),
    "circuit_failures": ("circuit_failures", int),
    "circuit_reset": ("circuit_reset_s", float),
    "wal_dir": ("stream_wal_dir", str),
    "snapshot_every": ("stream_snapshot_every", int),
    "maintain": ("stream_maintain", str),
    "maintain_budget": ("maintain_budget_ms", float),
    "maintain_dirty_frac": ("maintain_dirty_max_frac", float),
    "maintain_refresh": ("maintain_refresh_every", int),
    "fleet_replicas": ("fleet_replicas", int),
    "fleet_policy": ("fleet_policy", str),
    "fleet_health_interval": ("fleet_health_interval_s", float),
    "fleet_drain": ("fleet_drain_s", float),
    "tenant_lru": ("tenant_lru_size", int),
    "tenant_quota": ("tenant_quota_rps", float),
    "autoscale": ("fleet_autoscale", _bool),
    "fleet_min": ("fleet_min_replicas", int),
    "fleet_max": ("fleet_max_replicas", int),
    "scale_high_load": ("fleet_scale_high_load", float),
    "scale_low_load": ("fleet_scale_low_load", float),
    "scale_p99": ("fleet_scale_p99_s", float),
    "scale_cooldown": ("fleet_scale_cooldown_s", float),
    "artifact_store": ("fleet_artifact_store", str),
    "fit_workers": ("fit_job_workers", int),
    "fit_queue_bound": ("fit_job_queue_bound", int),
    "fit_quota": ("fit_job_quota_rps", float),
    "heartbeat": ("heartbeat_s", float),
    "watchdog": ("watchdog_s", float),
    "trace_max_events": ("trace_max_events", int),
    "skew_threshold": ("obs_skew_threshold", float),
    "straggler_rounds": ("obs_straggler_rounds", int),
    "trace_rotate_bytes": ("trace_rotate_bytes", int),
    "max_samples": ("max_samples", int),
    "compat_cf": ("compat_cf_int_math", _bool),
}
