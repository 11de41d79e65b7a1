"""MR-HDBSCAN* — recursive sampling with data bubbles on the card, the port
of ``models/mr_hdbscan.py``.

Per level, subsets that fit ``processing_units`` run the exact block
program in batches (``parallel/blocks``); an oversized subset is sampled
(numpy RNG, the reference's draws), its points are assigned to their
nearest sample and clustered in one of the two variants
(``HDBSCANParams.variant``): ``db`` (default) summarizes the points into
data bubbles (``core/bubbles``) and clusters the bubbles
(``models/bubble_hdbscan``); ``rs`` clusters the sample points themselves
(:func:`_fit_samples_rs`). Each point's next-level subset is its
bubble's (or sample's) flat cluster, force-split into capacity-sized
groups along the MST when the model finds a single cluster, and
positionally chunked (with chain edges) when even that cannot split it.
MST edges crossing groups join the edge pool as sample-point edges. The
pooled edges then run through the shared finalize tail
(``models/_finalize``).

Two modes, as in the reference:

- default: global core distances (one k-best pass, ``ops/tiled``), a
  per-level exact glue harvest (Borůvka rounds of the segment-min kernel,
  ``ops/tiled.boruvka_glue_edges``), the pool re-weighted to exact float64
  mutual reachability, ``refine_iterations`` rounds over the leaf
  clusters, and optional ``refine_flat_iterations`` over the flat cut;
- boundary (``boundary_quality > 0``): per-block core distances, seam
  margins per level, then the boundary set's exact cores — through the
  block-pruned window rescan (kernel B4, ``ops/blockscan``) with the pruned
  glue and refine rounds over the glue set, or, with
  ``boundary_block_pruning=False`` or a metric without the triangle
  inequality (cosine, pearson), through the rows scan against every column
  (``ops/tiled.knn_core_distances_rows``: the rectangular k-best kernel, or
  the forest's B5-B7 at ``knn_index=rpforest``) with the segment-min glue
  and refine rounds over the whole boundary set.

Around the level loop: ``dedup_points`` runs the pipeline over weighted
unique points (``core/dedup``: weighted global cores, Gumbel top-k
sampling by multiplicity, weighted bubbles, heavy groups expanded before
the finalize); ``checkpoint_dir`` saves the level-loop state after every level
and resumes the newest matching checkpoint (``utils/checkpoint``, the
reference's format); ``consensus_draws > 1`` runs that many draws and
returns their consensus (``models/consensus``); ``compat_cf_int_math``
takes the Java code's CF and bubble core arithmetic (``core/compat``).

``dtype`` is the working type of the block programs, the bubbles, the RS
sample block and the sample assignment (the reference's JAX default type:
float32 on a TPU, float64 under ``jax_enable_x64``); the scans, seam
margins, block geometry and the boundary rows scan run in float32 whatever
it is, as in the reference.

Over a mesh (``parallel/mesh.Mesh``), in the reference's order: the
engine (``models/exact._engine``: ``fit_sharding=sharded``, else
``scan_backend=ring``, else the host scanner) takes the global cores
(``parallel/shard.shard_core_distances``, the ring k-NN scan, or at
``knn_index=rpforest`` the sharded forest or the forest over the mesh),
every glue and refine harvest (the sharded or ring Borůvka scanners, B9),
and the boundary rows (``shard_core_distances_rows`` /
``ring_knn_core_distances_rows``); the block batches split over the
shards (``parallel/blocks.run_packed_blocks(batch_pad=D)``), and a sharded
boundary fit takes the full-sweep (unpruned) glue. Sampling, bubbles and
the finalize run on the mesh's first shard's device.

The observability layer (``hdbscan_tpu_torch/obs``) audits the reference's
phases (``global_cores``, ``glue_harvest``, ``block_fit``) and beats
``mr_levels`` once a level, the frozen-point fraction as its progress.
"""

from __future__ import annotations

import math
import time
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from hdbscan_tpu_torch import obs
from hdbscan_tpu_torch.config import HDBSCANParams
from hdbscan_tpu_torch.core import tree as tree_mod
from hdbscan_tpu_torch.core.bubbles import bubble_stats, bubble_stats_weighted
from hdbscan_tpu_torch.core.distances import rowwise_distance_np
from hdbscan_tpu_torch.models.bubble_hdbscan import fit_bubbles
from hdbscan_tpu_torch.ops import cuda_build
from hdbscan_tpu_torch.parallel.blocks import (
    _next_pow2,
    nearest_sample_assign,
    pack_blocks,
    run_packed_blocks,
    seam_margins,
)


@dataclass
class LevelStats:
    """Per-level trace record."""

    level: int
    n_active: int
    n_small_subsets: int
    n_large_subsets: int
    n_processed: int
    n_bubbles: int
    n_inter_edges: int
    forced_splits: int
    wall_s: float = 0.0


@dataclass
class MRHDBSCANResult:
    labels: np.ndarray
    tree: tree_mod.CondensedTree
    core_distances: np.ndarray
    outlier_scores: np.ndarray
    infinite_stability: bool
    n_levels: int
    n_edges: int
    levels: list = field(default_factory=list)
    #: (u, v, w) pooled edge set, kept when fit(keep_edge_pool=True). With
    #: ``dedup_points`` the ids (and ``levels`` counters) live in unique-
    #: vertex space; translate rows via ``dedup_inverse`` (row -> vertex).
    edge_pool: tuple | None = None
    #: row -> unique-vertex index map when the run deduplicated (else None).
    dedup_inverse: np.ndarray | None = None
    #: Set by ``models/consensus.fit``: provenance of a consensus result.
    #: ``labels`` are the consensus cut and ``outlier_scores`` the
    #: across-draw mean; ``tree``, ``core_distances`` and the files derived
    #: from the hierarchy describe the representative draw, and
    #: ``models/hdbscan.write_outputs`` writes this dict beside the files.
    consensus_info: dict | None = None

    def to_cluster_model(self, data: np.ndarray, params, *, device=None):
        """Serving artifact for this fit (``serve/artifact.ClusterModel``);
        consensus results persist the representative draw's tree with the
        consensus flat labels (the provenance split of ``write_outputs``).
        ``device`` builds the serving forest of an rp-forest fit."""
        from hdbscan_tpu_torch.serve.artifact import ClusterModel

        return ClusterModel.from_fit_result(self, data, params, device=device)


#: Adaptive boundary criterion: a point's per-block core is damaged iff its
#: k-NN ball reaches across a seam, i.e. margin <= ALPHA * core.
_BOUNDARY_ALPHA = 1.0

#: Glue-set criterion: rows within this fraction of their ball radius of a
#: seam can host the minimum inter-block MRD edge.
_GLUE_ALPHA = 0.5

#: Cap on the glue set as a multiple of the floor set.
_GLUE_MAX_FACTOR = 3


def _select_boundary(
    margin: np.ndarray,
    subset: np.ndarray,
    q: float,
    core: np.ndarray | None = None,
    min_per_block: int = 32,
    max_frac: float | None = None,
    return_floor: bool = False,
    alpha: float = _BOUNDARY_ALPHA,
    glue_alpha: float = _GLUE_ALPHA,
    glue_max_factor: int = _GLUE_MAX_FACTOR,
    glue_row_budget: int = 0,
):
    """Boundary-point ids: the adaptive at-risk set (``margin <= alpha *
    core``) plus, per final block, the lowest-``q``-fraction margins
    (floored at ``min_per_block``), capped at ``max_frac`` of the points.
    ``return_floor`` also returns the glue/refine rows: the floor plus the
    deep-crossing then at-risk rows up to max(``glue_max_factor`` x floor,
    ``glue_row_budget``) rows (floor plus the whole deep tier when the
    budget is -1), always a subset of the selection."""
    if max_frac is None:
        max_frac = HDBSCANParams.__dataclass_fields__["boundary_max_frac"].default
    n = len(margin)
    _, inv = np.unique(subset, return_inverse=True)
    counts = np.bincount(inv)
    take = np.maximum(np.minimum(counts, min_per_block), np.ceil(q * counts).astype(np.int64))
    order = np.lexsort((margin, inv))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n) - np.repeat(starts, counts)
    sel = rank < take[inv]
    floor_ids = None
    if return_floor:
        floor = sel
        if core is not None:
            deep = margin <= glue_alpha * core
            at_risk = margin <= alpha * core
            if glue_row_budget < 0:
                extra = np.nonzero(deep & ~floor)[0]
            else:
                budget = max(
                    (glue_max_factor - 1) * int(floor.sum()),
                    glue_row_budget - int(floor.sum()),
                )
                extra = np.nonzero((deep | at_risk) & ~floor)[0]
                if len(extra) > budget:
                    order = np.lexsort((margin[extra], ~deep[extra]))
                    extra = extra[order[:budget]]
            floor = floor.copy()
            floor[extra] = True
        floor_ids = np.nonzero(floor)[0]
    if core is not None:
        adaptive = margin <= alpha * core
        max_n = int(np.ceil(max_frac * n))
        if int((sel | adaptive).sum()) > max_n:
            import warnings

            extras = np.nonzero(adaptive & ~sel)[0]
            budget = max(0, max_n - int(sel.sum()))
            score = margin[extras] - alpha * core[extras]
            keep = extras[np.argsort(score, kind="stable")[:budget]]
            sel = sel.copy()
            sel[keep] = True
            warnings.warn(
                f"boundary set capped at {max_frac:.0%} of points "
                f"({int(adaptive.sum())} at-risk by the margin<=core "
                "criterion); quality may degrade toward the fixed-fraction "
                "mode — at this seam density the exact or fullq path is "
                "the better tool",
                stacklevel=3,
            )
        else:
            sel = sel | adaptive
    if return_floor and core is not None:
        sel = sel.copy()
        sel[floor_ids] = True
    ids = np.nonzero(sel)[0]
    if return_floor:
        return ids, floor_ids
    return ids


def _same_flat_partition(a: np.ndarray, b: np.ndarray) -> bool:
    """True iff two flat labelings are the same partition up to cluster
    renumbering; noise (label 0) is pinned."""
    if np.array_equal(a, b):
        return True
    if not np.array_equal(a == 0, b == 0):
        return False
    m = a != 0
    if not m.any():
        return True
    pairs = np.unique(np.stack([a[m], b[m]]), axis=1)
    return pairs.shape[1] == len(np.unique(pairs[0])) == len(np.unique(pairs[1]))


def _reweight_pool(u, v, w, data, core, metric: str, chunk: int = 1 << 20) -> np.ndarray:
    """Every pooled edge re-weighted to exact float64 mutual reachability
    max(d(u, v), core_u, core_v), chunked on the host."""
    out = np.empty_like(w)
    for lo in range(0, len(u), chunk):
        sl = slice(lo, lo + chunk)
        d = rowwise_distance_np(data[u[sl]], data[v[sl]], metric)
        out[sl] = np.maximum(d, np.maximum(core[u[sl]], core[v[sl]]))
    return out


def _group_by_subset(subset_ids: np.ndarray, active: np.ndarray) -> list[np.ndarray]:
    """Active point ids grouped by subset id."""
    ids = np.nonzero(active)[0]
    if len(ids) == 0:
        return []
    keys = subset_ids[ids]
    order = np.argsort(keys, kind="stable")
    ids = ids[order]
    keys = keys[order]
    cuts = np.nonzero(np.diff(keys))[0] + 1
    return np.split(ids, cuts)


def _bubble_groups_from_labels(labels: np.ndarray) -> np.ndarray:
    """Flat bubble labels renumbered to dense 0..g-1 group ids."""
    _, groups = np.unique(labels, return_inverse=True)
    return groups


def _forced_split_groups(n_b: np.ndarray, u: np.ndarray, v: np.ndarray, capacity: int):
    """Capacity-bounded bubble groups along a DFS of the bubble MST (for a
    subset the bubble model refuses to split)."""
    m = len(n_b)
    adj: list[list[int]] = [[] for _ in range(m)]
    for a, b in zip(u, v):
        adj[int(a)].append(int(b))
        adj[int(b)].append(int(a))
    order = []
    seen = np.zeros(m, bool)
    for start in range(m):
        if seen[start]:
            continue
        stack = [start]
        seen[start] = True
        while stack:
            x = stack.pop()
            order.append(x)
            for y in adj[x]:
                if not seen[y]:
                    seen[y] = True
                    stack.append(y)
    groups = np.zeros(m, np.int64)
    g, acc = 0, 0.0
    for x in order:
        if acc > 0 and acc + n_b[x] > capacity:
            g += 1
            acc = 0.0
        groups[x] = g
        acc += float(n_b[x])
    return groups


def _rs_device_block(x: torch.Tensor, num_valid: int, min_pts: int, metric: str):
    """The RS sample program over padded points (the first ``num_valid``
    real): distances -> core -> MRD -> Borůvka. Returns (dist, u, v, w,
    mask, core) as tensors; ``dist`` stays for the reassignment."""
    from hdbscan_tpu_torch.core.distances import self_distance_matrix
    from hdbscan_tpu_torch.core.knn import core_distances_from_matrix
    from hdbscan_tpu_torch.models.bubble_hdbscan import _bubble_device_block_given_core

    valid = torch.arange(x.shape[0], device=x.device) < num_valid
    dist = self_distance_matrix(x, metric)
    core = core_distances_from_matrix(dist, min_pts, valid)
    return _bubble_device_block_given_core(dist, core, num_valid)


def _fit_samples_rs(samp_data: np.ndarray, min_pts: int, min_cluster_size: int, metric: str,
                    *, device, dtype):
    """RS local model: exact HDBSCAN* on the sample points themselves (the
    paper's recursive-sampling baseline): noise samples take their nearest
    non-noise sample's cluster, and sample-MST edges crossing flat clusters
    become the inter-partition candidate edges. Returns (labels, (u, v, w),
    (iu, iv, iw)) in local sample indices."""
    from hdbscan_tpu_torch.models.bubble_hdbscan import _bubble_reassign_block, _fetch_edges

    s = len(samp_data)
    s_pad = max(128, _next_pow2(s))
    x = np.zeros((s_pad, samp_data.shape[1]), np.float64)
    x[:s] = samp_data
    x = torch.as_tensor(x.astype(dtype), device=device)
    dist, u_d, v_d, w_d, mask_d, core_d = _rs_device_block(x, s, min_pts, metric)
    u, v, w, mask = _fetch_edges(u_d, v_d, w_d, mask_d)
    core_h = core_d[:s].cpu().numpy().astype(np.float64)
    _, labels = tree_mod.extract_clusters(s, u, v, w, min_cluster_size, self_levels=core_h)
    labels_p = torch.zeros(s_pad, dtype=torch.int64, device=device)
    labels_p[:s] = torch.as_tensor(labels, dtype=torch.int64, device=device)
    new, cross = _bubble_reassign_block(dist, labels_p, u_d, v_d, mask_d, s)
    cross = cross[mask]
    return new[:s], (u, v, w), (u[cross], v[cross], w[cross])


def fit(
    data: np.ndarray,
    params: HDBSCANParams | None = None,
    *,
    device=None,
    dtype=np.float32,
    mesh=None,
    max_levels: int = 64,
    checkpoint_dir: str | None = None,
    trace=None,
    keep_edge_pool: bool = False,
) -> MRHDBSCANResult:
    """Run the MR-HDBSCAN* pipeline.

    Runs on the card unless ``device`` names another (``"cpu"`` runs every
    kernel's plain PyTorch version); raises when no card is present and no
    device is named. ``mesh`` (``parallel/mesh.get_mesh``): the mesh the
    sharded and ring engines and the block batches run over (module
    docstring; ``device`` defaults to its first shard's); without one, a
    sharded or ring engine runs over every visible card, or one shard on
    ``device`` when that is not a card. ``dtype``: working type of the
    block programs, bubbles and sample assignment (module docstring).
    ``checkpoint_dir``: the loop
    state is written there after every level and the newest matching
    checkpoint resumed (``utils/checkpoint``; ignored, with a warning, under
    ``consensus_draws > 1``). With ``params.dedup_points`` the pipeline runs
    over weighted unique points and the result is broadcast back to rows;
    ``consensus_draws > 1`` runs that many draws (``models/consensus``).
    ``trace``: optional ``trace(stage, **fields)`` callable receiving the
    reference's stage events (``level``, ``dedup``,
    ``resume_from_checkpoint``, ``consensus_draw``, ``consensus``,
    ``boundary_select``, ``boundary_cores``, ``boundary_reweight``,
    ``boundary_phase``, ``glue_round``, ``knn_probe_scan``,
    ``knn_window_scan``, ``refine``, ``refine_flat``, ``tree_*``) plus
    ``global_cores``, ``block_fit`` and ``level_stages`` (each level's
    glue, block-fit, sample-assignment, bubble and seam-margin walls).
    """
    from hdbscan_tpu_torch.models.exact import _engine

    params = params or HDBSCANParams()
    if device is None and mesh is not None:
        device = mesh.root
    device = cuda_build.resolve_device(device)
    if params.consensus_draws > 1:
        # consensus.fit re-enters here with consensus_draws=1 a draw, on
        # this device and type.
        if checkpoint_dir is not None:
            import warnings

            warnings.warn(
                "checkpoint_dir is ignored under consensus_draws > 1: "
                "consensus draws re-run from scratch on failure",
                stacklevel=2,
            )
        from hdbscan_tpu_torch.models import consensus

        return consensus.fit(data, params, device=device, dtype=dtype, mesh=mesh,
                             max_levels=max_levels, trace=trace,
                             keep_edge_pool=keep_edge_pool)
    engine, mesh, _ = _engine(params.fit_sharding, params.scan_backend, mesh, device)
    kw = dict(device=device, dtype=dtype, mesh=mesh, engine=engine, max_levels=max_levels,
              checkpoint_dir=checkpoint_dir, trace=trace, keep_edge_pool=keep_edge_pool)
    if not params.dedup_points:
        return _fit_rows(data, params, **kw)
    if not params.global_core_distances:
        raise ValueError("dedup_points requires global_core_distances")
    from hdbscan_tpu_torch.core.dedup import deduplicate

    data = np.ascontiguousarray(np.asarray(data, np.float64))
    uniq, counts, inverse = deduplicate(data)
    if trace is not None:
        trace("dedup", rows=len(data), unique=len(uniq))
    res = _fit_rows(uniq, params, weights=counts, constraint_index_map=inverse, **kw)
    return MRHDBSCANResult(
        labels=res.labels[inverse], tree=res.tree,
        core_distances=res.core_distances[inverse],
        outlier_scores=res.outlier_scores[inverse], infinite_stability=res.infinite_stability,
        n_levels=res.n_levels, n_edges=res.n_edges, levels=res.levels,
        edge_pool=res.edge_pool, dedup_inverse=inverse,
    )


def _fit_rows(data, params, *, device, dtype, mesh, engine, max_levels, checkpoint_dir, trace,
              keep_edge_pool, weights=None, constraint_index_map=None):
    """The level loop, boundary phase and refinement rounds over (possibly
    weighted) vertex rows; ``engine`` and ``mesh`` are
    ``models/exact._engine``'s, every scan below getting the engine as
    literal knobs."""
    from hdbscan_tpu_torch.models.exact import _KNOBS

    knobs = dict(_KNOBS[engine], mesh=mesh)
    n_dev = 1 if mesh is None else len(mesh.devices)
    data = np.ascontiguousarray(np.asarray(data, np.float64))
    n, d = data.shape
    if n == 0:
        raise ValueError("empty dataset")
    rng = np.random.default_rng(params.seed)
    cap = params.processing_units
    metric = params.dist_function
    tdtype = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32

    subset = np.zeros(n, np.int64)
    processed = np.zeros(n, bool)
    core = np.full(n, np.inf)
    boundary_q = params.boundary_quality
    boundary = boundary_q > 0
    global_core = params.global_core_distances and not boundary
    bmargin = np.full(n, np.inf) if boundary else None
    # Globally unique id of the block each point was frozen in (subset ids
    # restart every level; the boundary phase needs the final partition).
    final_block = np.full(n, -1, np.int64)
    block_counter = 0
    pool_u: list[np.ndarray] = []
    pool_v: list[np.ndarray] = []
    pool_w: list[np.ndarray] = []
    level_stats: list[LevelStats] = []
    start_level = 0
    resumed = False
    if checkpoint_dir is not None:
        from hdbscan_tpu_torch.utils import checkpoint as ckpt_mod

        ckpt_digest = ckpt_mod._data_digest(data)
        state = ckpt_mod.load_latest(checkpoint_dir, params, n, ckpt_digest)
        if state is not None:
            resumed = True
            start_level = state["level"] + 1
            subset, processed, core = state["subset"], state["processed"], state["core"]
            pool_u, pool_v, pool_w = [state["pool_u"]], [state["pool_v"]], [state["pool_w"]]
            rng.bit_generator.state = state["rng_state"]
            level_stats = [LevelStats(**st) for st in state["level_stats"]]
            if boundary and state.get("bmargin") is not None:
                bmargin = state["bmargin"]
            if state.get("final_block") is not None:
                final_block = state["final_block"]
                block_counter = int(final_block.max()) + 1
            if trace is not None:
                trace("resume_from_checkpoint", level=state["level"])
    if global_core and not resumed:
        # One pass over the whole set; a resumed run restores the cores
        # from its checkpoint instead.
        t0 = time.monotonic()
        # The ring scan audits itself (``ring_knn_scan``), as the reference's does.
        audit = (obs.mem_phase("global_cores") if weights is not None or engine != "ring"
                 else nullcontext())
        with audit:
            if weights is not None:
                from hdbscan_tpu_torch.core.dedup import global_weighted_core_distances

                core = global_weighted_core_distances(
                    data, weights, params.min_points, metric, trace=trace, mesh=mesh,
                    fit_sharding=knobs["fit_sharding"], device=device,
                )
            else:
                from hdbscan_tpu_torch.core.knn import resolve_index_for

                index, index_opts = resolve_index_for(params, n)
                scan = dict(index=index, index_opts=index_opts, trace=trace)
                if engine == "sharded":
                    from hdbscan_tpu_torch.parallel.shard import shard_core_distances

                    core = shard_core_distances(data, params.min_points, metric, mesh=mesh,
                                                knn_backend=params.knn_backend, **scan)
                elif engine == "ring":
                    from hdbscan_tpu_torch.parallel.ring import ring_knn_core_distances

                    core, _ = ring_knn_core_distances(data, params.min_points, metric,
                                                      fetch_knn=False, mesh=mesh,
                                                      knn_backend=params.knn_backend, **scan)
                else:
                    from hdbscan_tpu_torch.ops.tiled import knn_core_distances

                    core, _ = knn_core_distances(data, params.min_points, metric, fetch_knn=False,
                                                 backend=params.knn_backend, device=device, **scan)
        if trace is not None:
            trace("global_cores", n=n, wall_s=round(time.monotonic() - t0, 6))

    for level in range(start_level, max_levels):
        if processed.all():
            break
        t0 = time.monotonic()
        groups = _group_by_subset(subset, ~processed)
        small = [g for g in groups if len(g) <= cap]
        large = [g for g in groups if len(g) > cap]
        n_active = int((~processed).sum())
        n_proc = n_bub = n_inter = forced = 0
        # Per-stage walls of the level (trace event ``level_stages``); every
        # stage ends in a host fetch, so the host clock sees device time.
        walls = dict.fromkeys(("glue", "blocks", "assign", "bubbles", "margins"), 0.0)
        mark = time.monotonic()

        def lap(stage):
            nonlocal mark
            now = time.monotonic()
            walls[stage] += now - mark
            mark = now

        if params.exact_inter_edges and len(groups) >= 2 and not boundary:
            # Per-level glue harvest: Borůvka rounds seeded with the current
            # subsets, run to connectivity — every edge a true MST edge of
            # the active set.
            from hdbscan_tpu_torch.ops.tiled import boruvka_glue_edges

            act = np.nonzero(~processed)[0]
            with obs.mem_phase("glue_harvest"):
                gu_l, gv_l, gw_l = boruvka_glue_edges(
                    data[act], subset[act], metric, core=core[act] if global_core else None,
                    trace=trace, device=device, **knobs,
                )
            pool_u.append(act[gu_l])
            pool_v.append(act[gv_l])
            pool_w.append(gw_l)
            n_inter += len(gu_l)
            lap("glue")

        mark = time.monotonic()
        if small:
            # Pow2 size classes: a 100-point subset must not pay for a
            # capacity-sized matrix.
            buckets: dict[int, list[np.ndarray]] = {}
            for g in small:
                buckets.setdefault(max(128, _next_pow2(len(g))), []).append(g)
            for cap_b in sorted(buckets):
                group = buckets[cap_b]
                packed = pack_blocks(data, group, cap_b, core=core if global_core else None)
                with obs.mem_phase("block_fit"):
                    u, v, w, core_b = run_packed_blocks(
                        packed, params.min_points, metric, device=device, mesh=mesh,
                        batch_pad=n_dev, dtype=dtype, trace=trace,
                    )
                pool_u.append(u)
                pool_v.append(v)
                pool_w.append(w)
                if not global_core:
                    for i, ids in enumerate(group):
                        core[ids] = core_b[i, : len(ids)]
            for g in small:
                final_block[g] = block_counter
                block_counter += 1
            done = np.concatenate(small)
            processed[done] = True
            n_proc = len(done)
            lap("blocks")

        next_id = 0
        for ids in large:
            size = len(ids)
            forced_before = forced
            cap_s = 1 << (params.max_samples.bit_length() - 1)
            s_count = min(size, max(2, math.ceil(params.k * size)), cap_s)
            if weights is not None and s_count < size:
                # Weighted draw ∝ multiplicity (Gumbel top-k: sampling
                # without replacement with p ∝ w), as rows would be drawn;
                # argpartition's order is the bubble order.
                keys = np.log(weights[ids]) + rng.gumbel(size=size)
                samp_local = np.argpartition(-keys, s_count - 1)[:s_count]
            else:
                samp_local = rng.choice(size, s_count, replace=False)
            samples_global = ids[samp_local]
            mark = time.monotonic()
            assign = nearest_sample_assign(data[ids], data[samples_global], metric,
                                           device=device, dtype=dtype)
            lap("assign")
            if params.variant == "rs":
                # RS: cluster the sample points directly (no summarization);
                # group sizes count members, not vertices, under dedup.
                labels_s, (mu, mv, mw), inter = _fit_samples_rs(
                    data[samples_global], params.min_points, params.min_cluster_size, metric,
                    device=device, dtype=dtype,
                )
                weights_s = np.bincount(
                    assign, weights=weights[ids] if weights is not None else None,
                    minlength=s_count,
                ).astype(np.float64)
            else:
                s_pad = _next_pow2(s_count)
                if params.compat_cf_int_math:
                    from hdbscan_tpu_torch.core.compat import combinestep_bubble_stats

                    rep, extent, nn_dist, n_b = combinestep_bubble_stats(
                        data[ids], assign, s_pad,
                        weights=weights[ids] if weights is not None else None,
                    )
                    rep = torch.as_tensor(rep, dtype=tdtype, device=device)
                else:
                    pts = torch.as_tensor(data[ids], dtype=tdtype, device=device)
                    asg = torch.as_tensor(assign.astype(np.int64), device=device)
                    if weights is not None:
                        w_t = torch.as_tensor(weights[ids], dtype=tdtype, device=device)
                        rep, extent, nn_dist, n_b = bubble_stats_weighted(pts, asg, w_t, s_pad)
                    else:
                        rep, extent, nn_dist, n_b = bubble_stats(pts, asg, s_pad)
                model = fit_bubbles(rep, extent, nn_dist, n_b, params.min_points,
                                    params.min_cluster_size, metric, num_valid=s_count,
                                    compat_cf_int_math=params.compat_cf_int_math)
                labels_s = model.labels
                mu, mv, mw = model.mst
                inter = model.inter_edges
                weights_s = model.weights
            n_bub += s_count
            lap("bubbles")

            bubble_groups = _bubble_groups_from_labels(labels_s)
            if bubble_groups.max() == 0:
                # Single flat cluster: force-split along the bubble (or
                # sample) MST and recompute which edges cross the groups.
                bubble_groups = _forced_split_groups(weights_s, mu, mv, cap)
                forced += 1
                cross = bubble_groups[mu] != bubble_groups[mv]
                iu, iv, iw = mu[cross], mv[cross], mw[cross]
            else:
                iu, iv, iw = inter

            su, sv = samples_global[iu], samples_global[iv]
            if params.exact_inter_edges and len(iu):
                # The true point-space distance between the sample
                # endpoints, clamped to mutual reachability under global
                # cores.
                iw = rowwise_distance_np(data[su], data[sv], metric)
                if global_core:
                    iw = np.maximum(iw, np.maximum(core[su], core[sv]))
            pool_u.append(su)
            pool_v.append(sv)
            pool_w.append(iw)
            n_inter += len(iu)

            pt_groups = bubble_groups[assign]
            degenerate = np.bincount(pt_groups).max() >= size
            if boundary and not degenerate:
                # Running min of each point's margin to this level's seams.
                mark = time.monotonic()
                marg = seam_margins(data[ids], data[samples_global], bubble_groups, metric,
                                    device=device)
                bmargin[ids] = np.minimum(bmargin[ids], marg)
                lap("margins")
            if degenerate:
                # Every point lands in one group (e.g. identical points):
                # positional chunks chained by explicit edges.
                pt_groups = np.arange(size) // cap
                if forced == forced_before:
                    forced += 1
                heads = ids[np.arange(cap, size, cap)]
                tails = ids[np.arange(cap, size, cap) - 1]
                cw = rowwise_distance_np(data[tails], data[heads], metric)
                if global_core:
                    cw = np.maximum(cw, np.maximum(core[tails], core[heads]))
                pool_u.append(tails)
                pool_v.append(heads)
                pool_w.append(cw)
                if boundary:
                    bmargin[tails] = 0.0
                    bmargin[heads] = 0.0
            subset[ids] = next_id + pt_groups
            next_id += int(pt_groups.max()) + 1

        stats = LevelStats(
            level=level, n_active=n_active, n_small_subsets=len(small),
            n_large_subsets=len(large), n_processed=n_proc, n_bubbles=n_bub,
            n_inter_edges=n_inter, forced_splits=forced, wall_s=time.monotonic() - t0,
        )
        level_stats.append(stats)
        # Liveness and progress for the watchdog: the frozen-point fraction
        # is monotone across levels (points only ever freeze).
        obs.beat("mr_levels", int(processed.sum()), total=n)
        if trace is not None:
            trace("level", **{k: getattr(stats, k) for k in stats.__dataclass_fields__})
            trace("level_stages", level=level, **{f"{k}_s": round(v, 6) for k, v in walls.items()})
        if checkpoint_dir is not None:
            from dataclasses import asdict

            cu = np.concatenate(pool_u) if pool_u else np.zeros(0, np.int64)
            cv = np.concatenate(pool_v) if pool_v else np.zeros(0, np.int64)
            cw = np.concatenate(pool_w) if pool_w else np.zeros(0, np.float64)
            pool_u, pool_v, pool_w = [cu], [cv], [cw]
            ckpt_mod.save_level(
                checkpoint_dir, level, params, ckpt_digest, subset, processed, core, cu, cv, cw,
                rng.bit_generator.state, [asdict(st) for st in level_stats], bmargin=bmargin,
                final_block=final_block,
            )
    else:
        if not processed.all():
            raise RuntimeError(
                f"recursive sampling did not converge in {max_levels} levels; "
                f"{int((~processed).sum())} points unprocessed"
            )

    u = np.concatenate(pool_u) if pool_u else np.zeros(0, np.int64)
    v = np.concatenate(pool_v) if pool_v else np.zeros(0, np.int64)
    w = np.concatenate(pool_w) if pool_w else np.zeros(0, np.float64)
    if global_core and len(w):
        # Exact float64 mutual reachability for every pooled weight (tie
        # determinism: scan weights carry float32 jitter).
        w = _reweight_pool(u, v, w, data, core, metric)

    bset = None
    bset_knn = None
    geom_bset = None
    if boundary and n > cap:
        from hdbscan_tpu_torch.core.knn import resolve_index_for
        from hdbscan_tpu_torch.ops.blockscan import (
            PRUNABLE_METRICS,
            BlockGeometry,
            boruvka_glue_edges_blockpruned,
            knn_rows_blockpruned,
        )
        from hdbscan_tpu_torch.ops.tiled import boruvka_glue_edges, knn_core_distances_rows
        from hdbscan_tpu_torch.utils.flops import counter as flops_counter
        from hdbscan_tpu_torch.utils.flops import phase_stats

        # Block pruning needs a triangle-inequality metric; without it the
        # rescan scans every column and the glue and refine rounds keep the
        # whole boundary set. Its windowed scans hold one device's copy of
        # the geometry, so the sharded engine takes the full sweep.
        pruned = (params.boundary_block_pruning and metric in PRUNABLE_METRICS
                  and engine != "sharded")
        # 1) The boundary set (final_block: subset ids collide across levels).
        t0 = time.monotonic()
        sel = _select_boundary(
            bmargin, final_block, boundary_q, core=core,
            max_frac=1.0 if pruned else params.boundary_max_frac, return_floor=pruned,
            alpha=params.boundary_alpha, glue_alpha=params.glue_alpha,
            glue_max_factor=params.glue_max_factor, glue_row_budget=params.glue_row_budget,
        )
        bset, bset_glue_sel = sel if pruned else (sel, sel)
        if trace is not None:
            trace("boundary_select", m=len(bset), m_glue=len(bset_glue_sel),
                  frac=round(len(bset) / n, 4), pruned=pruned,
                  wall_s=round(time.monotonic() - t0, 3))
        # 2) Exact cores of the boundary rows: the pruned window rescan,
        #    whose neighbour lists (glue rows only) seed the glue's edge
        #    bounds, or the rows scan against every column.
        t0 = time.monotonic()
        fsnap = flops_counter.snapshot()
        index, index_opts = resolve_index_for(params, n)
        if pruned:
            bset_pos = np.full(n, -1, np.int64)
            bset_pos[bset] = np.arange(len(bset))
            sel_pos = bset_pos[bset_glue_sel]
            geom_blocks = BlockGeometry.build(data, final_block, metric, device=device)
            core_b, knn_d_g, knn_j_gl = knn_rows_blockpruned(
                geom_blocks, bset, core[bset], params.min_points, neighbor_rows=sel_pos,
                backend=params.knn_backend, index=index, index_opts=index_opts, trace=trace,
            )
            del geom_blocks
            glue_pos = np.full(n, -1, np.int64)
            glue_pos[bset_glue_sel] = np.arange(len(bset_glue_sel))
            knn_j_g = np.where(knn_j_gl >= 0, glue_pos[np.maximum(knn_j_gl, 0)], -1)
            bset_knn = (knn_d_g, knn_j_g)
        elif engine == "sharded":
            from hdbscan_tpu_torch.parallel.shard import shard_core_distances_rows

            core_b = shard_core_distances_rows(
                data, bset, params.min_points, metric, mesh=mesh, trace=trace, index=index,
                index_opts=index_opts,
            )
        elif engine == "ring":
            from hdbscan_tpu_torch.parallel.ring import ring_knn_core_distances_rows

            core_b = ring_knn_core_distances_rows(
                data, bset, params.min_points, metric, mesh=mesh, trace=trace, index=index,
                index_opts=index_opts,
            )
        else:
            core_b = knn_core_distances_rows(
                data, bset, params.min_points, metric, backend=params.knn_backend,
                index=index, index_opts=index_opts, trace=trace, device=device,
            )
        core[bset] = np.minimum(core[bset], core_b)
        if trace is not None:
            wall = time.monotonic() - t0
            trace("boundary_cores", wall_s=round(wall, 3), **phase_stats(fsnap, wall))
        # 3) The whole pool re-weighted under the hybrid core vector.
        t0 = time.monotonic()
        w = _reweight_pool(u, v, w, data, core, metric)
        if trace is not None:
            trace("boundary_reweight", edges=len(w), wall_s=round(time.monotonic() - t0, 3))
        # 4) Inter-block glue over the glue set (block-pruned, or Borůvka
        #    rounds of the segment-min kernel over the whole boundary set).
        t0 = time.monotonic()
        fsnap = flops_counter.snapshot()
        bset_g = bset_glue_sel
        if len(np.unique(final_block[bset_g])) >= 2:
            if pruned:
                geom_bset = BlockGeometry.build(data[bset_g], final_block[bset_g], metric,
                                                device=device)
                gu, gv, gw = boruvka_glue_edges_blockpruned(
                    data[bset_g], final_block[bset_g], core[bset_g], metric,
                    knn_d=bset_knn[0], knn_j=bset_knn[1], geom=geom_bset, trace=trace,
                    scan_backend=knobs["scan_backend"], mesh=mesh,
                )
            else:
                gu, gv, gw = boruvka_glue_edges(
                    data[bset_g], final_block[bset_g], metric, core=core[bset_g],
                    trace=trace, device=device, **knobs,
                )
            gw = _reweight_pool(bset_g[gu], bset_g[gv], gw, data, core, metric)
            u = np.concatenate([u, bset_g[gu]])
            v = np.concatenate([v, bset_g[gv]])
            w = np.concatenate([w, gw])
        if trace is not None:
            wall = time.monotonic() - t0
            trace("boundary_phase", m=len(bset), m_glue=len(bset_g),
                  frac=round(len(bset) / n, 4),
                  n_blocks=int(len(np.unique(final_block[bset_g]))),
                  wall_s=round(wall, 3), **phase_stats(fsnap, wall))

    from hdbscan_tpu_torch.models._finalize import finalize_clustering

    def build_tree(u_, v_, w_):
        if not global_core and len(w_):
            # Without global cores the glue/refine harvests emit plain
            # distances: clamp the pool to mutual reachability.
            w_ = np.maximum(w_, np.maximum(core[u_], core[v_]))
        # Weighted vertices heavy enough to pass minClusterSize dissolve
        # like their rows: expanded into unit pseudo-leaves first.
        if weights is not None:
            from hdbscan_tpu_torch.core.dedup import expand_heavy_groups

            u2, v2, w2, core2, weights2 = expand_heavy_groups(
                u_, v_, w_, core, weights, params.min_cluster_size
            )
        else:
            u2, v2, w2, core2, weights2 = u_, v_, w_, core, None
        n2 = n if weights2 is None else len(weights2)
        tree, labels, scores, infinite = finalize_clustering(
            n2, u2, v2, w2, core2, params, point_weights=weights2,
            constraint_index_map=constraint_index_map, trace=trace, device=device,
        )
        # Pseudo-leaves alias their base vertex: slice back to vertex space.
        return tree, labels[:n], scores[:n], infinite

    tree, labels, scores, infinite = build_tree(u, v, w)

    # Refinement: exact minimum MRD edges between the tree's leaf clusters.
    if params.exact_inter_edges or bset is not None:
        from hdbscan_tpu_torch.ops.tiled import boruvka_glue_edges
        from hdbscan_tpu_torch.utils.flops import counter as flops_counter
        from hdbscan_tpu_torch.utils.flops import phase_stats

        for _ in range(params.refine_iterations):
            t0 = time.monotonic()
            fsnap = flops_counter.snapshot()
            groups_r = tree.point_last_cluster[:n]
            if bset is not None:
                bset_g = bset_glue_sel
                if len(np.unique(groups_r[bset_g])) < 2:
                    break
                if bset_knn is not None:
                    from hdbscan_tpu_torch.ops.blockscan import boruvka_glue_edges_blockpruned

                    ru, rv, rw = boruvka_glue_edges_blockpruned(
                        data[bset_g], final_block[bset_g], core[bset_g], metric,
                        knn_d=bset_knn[0], knn_j=bset_knn[1], init_comp=groups_r[bset_g],
                        geom=geom_bset, trace=trace, scan_backend=knobs["scan_backend"],
                        device=device, mesh=mesh,
                    )
                else:
                    ru, rv, rw = boruvka_glue_edges(
                        data[bset_g], groups_r[bset_g], metric, core=core[bset_g],
                        trace=trace, device=device, **knobs,
                    )
                ru, rv = bset_g[ru], bset_g[rv]
            else:
                if len(np.unique(groups_r)) < 2:
                    break
                ru, rv, rw = boruvka_glue_edges(
                    data, groups_r, metric, core=core if global_core else None,
                    trace=trace, device=device, **knobs,
                )
            if len(ru) == 0:
                break
            if global_core or bset is not None:
                rw = _reweight_pool(ru, rv, rw, data, core, metric)
            u = np.concatenate([u, ru])
            v = np.concatenate([v, rv])
            w = np.concatenate([w, rw])
            tree, labels, scores, infinite = build_tree(u, v, w)
            if trace is not None:
                wall = time.monotonic() - t0
                trace("refine", new_edges=len(ru), wall_s=round(wall, 3),
                      **phase_stats(fsnap, wall))

    # Flat-cut refinement (global-core path only): exact minimum MRD edges
    # crossing the flat partition (noise as singletons) until it is fixed.
    if global_core and bset is None and params.refine_flat_iterations > 0:
        from hdbscan_tpu_torch.ops.tiled import boruvka_glue_edges
        from hdbscan_tpu_torch.utils.flops import counter as flops_counter
        from hdbscan_tpu_torch.utils.flops import phase_stats

        for _ in range(params.refine_flat_iterations):
            t0 = time.monotonic()
            fsnap = flops_counter.snapshot()
            g = labels[:n].copy()
            noise = g == 0
            g[noise] = np.arange(int(noise.sum())) + g.max() + 1
            if len(np.unique(g)) < 2:
                break
            ru, rv, rw = boruvka_glue_edges(
                data, g, metric, core=core, trace=trace, device=device, **knobs,
            )
            if len(ru) == 0:
                break
            rw = _reweight_pool(ru, rv, rw, data, core, metric)
            u = np.concatenate([u, ru])
            v = np.concatenate([v, rv])
            w = np.concatenate([w, rw])
            prev = labels
            tree, labels, scores, infinite = build_tree(u, v, w)
            converged = _same_flat_partition(labels, prev)
            if trace is not None:
                wall = time.monotonic() - t0
                trace("refine_flat", new_edges=len(ru),
                      changed=0 if converged else int((labels != prev).sum()),
                      wall_s=round(wall, 3), **phase_stats(fsnap, wall))
            if converged:
                break

    return MRHDBSCANResult(
        labels=labels, tree=tree, core_distances=core, outlier_scores=scores,
        infinite_stability=infinite, n_levels=len(level_stats), n_edges=len(u),
        levels=level_stats, edge_pool=(u, v, w) if keep_edge_pool else None,
    )
