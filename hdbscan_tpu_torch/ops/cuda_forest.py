"""The rp-forest query kernels on the card, and their plain versions — the
port of ``hdbscan_tpu/ops/pallas_forest.py``.

Four kernels (``csrc/forest_leaf_topk.cu``, ``csrc/forest_merge.cu``,
``csrc/forest_rescan.cu``; see their headers for the designs):

* B5 :func:`forest_leaf_topk` — per leaf, the dense leaf x leaf distances
  and every slot's kk nearest columns in ``lax.top_k`` order, ids through
  the leaf's members, then sorted by (distance, id): a warp a slot over
  the gathered leaf, with B7's warp inserts;
* B6 :func:`forest_merge` — the trees' lists folded in tree order into
  running lists under the (distance, id) order, a tree's entry dropped where
  the running list already holds its id at a distance no larger (so one id
  may stand twice: the reference's fold, not a dedup of the concatenation);
* B7 :func:`forest_rescan_topk` — per query row, the k lex-best distinct
  ids of its own candidate panel (the rescan rounds): a warp a row, the
  candidates cut into spans over a second grid axis where the rows alone
  leave the card short of blocks (the wrapper allocates the spans'
  scratch; :func:`rescan_splits`), the lists merged by a second pass;
* B8 :func:`forest_min_outgoing` — the same panel reduced to a Borůvka
  segment-min of mutual reachability, a warp a row, spans over a second
  grid axis as B7's (no fit path calls it; the reference keeps it as the
  panel's second program entry).

Each wrapper runs its plain PyTorch version (``*_plain``, same signature
and output) for a CPU tensor and launches its kernel for a CUDA tensor,
raising on what the kernel does not take; nothing else picks the route.
The kernels take every k and d and B6 every tree count: past 128 (the
reference's fused gate) B8 runs its wide mode (f32), B5 past d = 128 a scan
with no staged tile, B6 and B7 the same kernel (B5's to B7's launches past
128 still count under ``<name>_wide``).
At f32 the plain versions repeat the kernels' arithmetic (features one at
a time, no FMA, correctly rounded roots), so the two agree bitwise.

bf16 mode (B5, B7, B8; euclidean only): operands centred, rounded to bfloat16,
the cross term accumulated in float32 from their exact products beside
float32 norms of the centred, unrounded operands. The centre is the port's
own, computed by the wrapper and shared by kernel and plain version: for
B5 the mean of the leaf's real members (:func:`leaf_centres`), for B7 and
B8 the mean of the query rows' tile of :data:`RESCAN_ROW_TILE` consecutive rows
(:func:`row_tile_centres`). The reference averages over its TPU blocks
(the leaf zero-padded to 128 rows; 8-row tiles zero-padded), so bf16 is
held to it only by recall and ARI.

``ops/rpforest.forest_knn_shards`` and ``rescan_round_shards`` drive the
kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hdbscan_tpu_torch.core.distances import (
    _sq_norms,
    euclidean_form,
    pairwise_distance,
    sqrt_rn,
)
from hdbscan_tpu_torch.ops import cuda_build
from hdbscan_tpu_torch.ops.lexmerge import (
    dedup_lex_merge,
    lex_kbest,
    lexsort_rows,
    merge_tile_candidates,
    topk_tile_candidates,
)

#: Metrics of the fused family off the card (the reference's; pearson is
#: excluded there and runs the unfused route). On the card the kernels
#: take every metric, pearson as cosine over rows centred once
#: (``cuda_build.kernel_points``), the arithmetic of the unfused route.
FUSED_METRICS = ("euclidean", "manhattan", "supremum", "cosine")

#: The reference's fused forest gate: k and d within its 128 lanes. The
#: kernels take every k and d (past 128 in their wide mode, f32 only); bf16
#: runs only inside the gate, so its over-provisioned width stays within it.
LANES = 128
#: Query rows per bf16 centring tile of the rescan (the reference's row
#: tile of its rescan kernel).
RESCAN_ROW_TILE = 8


def euclid_form(r: int, c: int, d: int) -> str:
    """The euclidean form the reference's unfused scan takes at the real
    (r, c, d) shape; the kernels use it whatever their tiling."""
    return euclidean_form(r, c, d)


def fused_forest_eligible(n: int, d: int, k: int, metric: str, dtype) -> bool:
    """Whether ``knn_backend="fused"`` takes the fused route off the card:
    a fused metric, k and d within the kernels' bounds, float32 (the
    reference's gate without its TPU and interpreter clauses)."""
    return (
        metric in FUSED_METRICS
        and k <= LANES
        and d <= LANES
        and np.dtype(dtype) == np.float32
    )


def check_card_shape(d: int, k: int, metric: str, dtype, precision: str = "f32") -> None:
    """What the kernels take on the card (any k >= 1 and d >= 1, float32,
    every metric; bf16 tiles at euclidean only, as in the reference); raises
    naming the limit. The card has no unfused path to fall back to."""
    cuda_build.metric_code("cosine" if metric == "pearson" else metric, "diff")
    if precision == "bf16" and metric != "euclidean":
        raise ValueError("bf16 distance tiles support euclidean only")
    if np.dtype(dtype) != np.float32:
        raise ValueError(f"the forest kernels compute in float32, got dtype {dtype}")
    if k < 1 or d < 1:
        raise ValueError(f"the forest kernels need k >= 1 and d >= 1, got k={k}, d={d}")


def _check_bf16_width(name: str, k: int, d: int) -> None:
    """bf16 tiles exist only inside the fused gate (the wide modes are f32)."""
    if k > LANES or d > LANES:
        raise ValueError(f"{name}: bf16 tiles need k and d <= {LANES}, got k={k}, d={d}")


# ---------------------------------------------------------------------------
# Plain distance tiles and the kernels' value functions.


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _bf16_dist(xc: torch.Tensor, yc: torch.Tensor) -> torch.Tensor:
    """(..., r, c) distances of centred row sets: bf16-rounded cross term
    accumulated in float32, float32 norms of the unrounded operands."""
    nr, nc = _sq_norms(xc), _sq_norms(yc)
    xb, yb = _bf16(xc), _bf16(yc)
    cross = xb[..., :, None, 0] * yb[..., None, :, 0]
    for f in range(1, xc.shape[-1]):
        cross = cross + xb[..., :, None, f] * yb[..., None, :, f]
    d2 = (nr[..., :, None] + nc[..., None, :]) - 2.0 * cross
    return sqrt_rn(torch.clamp_min(d2, 0.0))


def leaf_centres(pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, d) bf16 centres of a leaf batch: the mean of each leaf's real
    members (``mask``)."""
    w = mask.to(pts.dtype)
    return (pts * w[..., None]).sum(dim=-2) / w.sum(dim=-1, keepdim=True)


def row_tile_centres(q: torch.Tensor) -> torch.Tensor:
    """(m, d) bf16 centres of the rescan's query rows: each row gets the
    mean of its tile of :data:`RESCAN_ROW_TILE` consecutive rows (the last
    tile over the rows it has)."""
    m, d = q.shape
    tiles = -(-m // RESCAN_ROW_TILE)
    pad = torch.zeros((tiles * RESCAN_ROW_TILE, d), dtype=q.dtype, device=q.device)
    pad[:m] = q
    count = torch.full((tiles, 1), float(RESCAN_ROW_TILE), dtype=q.dtype, device=q.device)
    count[-1] = m - (tiles - 1) * RESCAN_ROW_TILE
    mu = pad.reshape(tiles, RESCAN_ROW_TILE, d).sum(dim=1) / count
    return mu.repeat_interleave(RESCAN_ROW_TILE, dim=0)[:m]


def dist_tile(xr, xc, metric: str, *, form: str | None, precision: str, mu=None):
    """(..., r, c) distance tile. f32: the metric in the given euclidean
    form; bf16 (euclidean): centred on ``mu`` (..., d)."""
    if precision == "bf16":
        if metric != "euclidean":
            raise ValueError("bf16 distance tiles support euclidean only")
        return _bf16_dist(xr - mu[..., None, :], xc - mu[..., None, :])
    return pairwise_distance(xr, xc, metric, form)


def rows_dist(q, cpts, metric: str, *, precision: str, mu=None):
    """(m, C) distances of each query row to its own candidate panel row
    (``cpts`` (m, C, d)); the form is the reference's for a (1, C, d)
    tile. bf16 (euclidean): both centred on the row's ``mu`` (m, d)."""
    if precision == "bf16":
        if metric != "euclidean":
            raise ValueError("bf16 distance tiles support euclidean only")
        return _bf16_dist((q - mu)[:, None, :], cpts - mu[:, None, :])[:, 0, :]
    c, d = cpts.shape[1], cpts.shape[2]
    form = euclid_form(1, c, d) if metric == "euclidean" else None
    return pairwise_distance(q[:, None, :], cpts, metric, form)[:, 0, :]


def leaf_topk_values(pts, ids, colmask, kk: int, *, metric: str, form: str | None,
                     precision: str, sentinel: int, mu=None):
    """A leaf batch ``pts`` (B, L, d) -> ((B, L, kk) d, (B, L, kk) id): each
    slot's kk nearest unmasked columns in ``lax.top_k`` order (ascending
    distance, the lower position on ties), ids through ``ids`` (B, L),
    +inf -> ``sentinel``, then sorted by (distance, id)."""
    b, ell = ids.shape
    inf = torch.tensor(float("inf"), dtype=pts.dtype, device=pts.device)
    dist = dist_tile(pts, pts, metric, form=form, precision=precision, mu=mu)
    dist = torch.where(colmask[:, None, :], dist, inf)
    # lex_kbest orders by (distance, column position), as top_k does.
    nd, pos = lex_kbest(dist.reshape(b * ell, ell), kk)
    nd, pos = nd.reshape(b, ell, kk), pos.reshape(b, ell, kk)
    gid = torch.gather(ids[:, None, :].expand(b, ell, ell), 2, pos.clamp_min(0).long())
    ni = torch.where((pos < 0) | torch.isinf(nd), sentinel, gid).to(torch.int32)
    order = lexsort_rows(nd, ni)
    return torch.gather(nd, -1, order), torch.gather(ni, -1, order)


def rescan_topk_values(q, cpts, cids, k: int, *, metric: str, precision: str,
                       sentinel: int, mu=None):
    """Candidate-panel reduction: ((m, k) d, (m, k) id), the k lex-best
    distinct finite candidates, (+inf, ``lexmerge.ID_MAX``) in unused
    slots."""
    dist = rows_dist(q, cpts, metric, precision=precision, mu=mu)
    dist = torch.where(cids == sentinel, torch.tensor(float("inf"), device=q.device), dist)
    return topk_tile_candidates(dist, cids, k)


def cand_minout_values(q, cpts, cids, core_q, core_c, comp_q, comp_c, *,
                       metric: str, sentinel: int, precision: str = "f32", mu=None):
    """Candidate-panel Borůvka reduction: per row the minimum of
    max(d, core_q, core_c) over candidates in another component, ((m,) w,
    (m,) id), the first minimal panel column on ties, (+inf, -1) where
    there is none. bf16 (euclidean): distances centred on ``mu``."""
    dist = rows_dist(q, cpts, metric, precision=precision, mu=mu)
    w = torch.maximum(dist, torch.maximum(core_q[:, None], core_c))
    out = (comp_q[:, None] != comp_c) & (cids != sentinel)
    w = torch.where(out, w, torch.tensor(float("inf"), device=q.device))
    bw = torch.amin(w, dim=1)
    a = torch.argmin(w, dim=1)
    bj = torch.gather(cids, 1, a[:, None])[:, 0]
    return bw, torch.where(torch.isinf(bw), -1, bj).to(torch.int32)


def refine_f32(data, best_d, best_i, metric: str, sentinel: int):
    """Exact float32 re-distance of the surviving lists (the bf16 regime's
    second half), re-sorted by (distance, id)."""
    rows = best_i.shape[0]
    pts = data[best_i.clamp(0, sentinel - 1).long()]
    dist = rows_dist(data[:rows], pts, metric, precision="f32")
    dist = torch.where(best_i == sentinel, torch.tensor(float("inf"), device=data.device), dist)
    order = lexsort_rows(dist, best_i)
    return torch.gather(dist, -1, order), torch.gather(best_i, -1, order)


# ---------------------------------------------------------------------------
# Plain versions and kernel wrappers.


def _check_ids(ids, n: int, name: str, sentinel: int | None = None) -> None:
    """Ids a kernel indexes ``data`` with must lie in [0, n) (or equal
    ``sentinel``, an empty slot): one device reduction, read once."""
    bad = (ids < 0) | (ids >= n)
    if sentinel is not None:
        bad &= ids != sentinel
    if bool(bad.any()):
        raise ValueError(f"{name}: ids outside [0, {n})")


def forest_leaf_topk_plain(data, members, mask, kk: int, metric: str = "euclidean",
                           form: str | None = "diff", precision: str = "f32",
                           sentinel: int = 0):
    """Plain version of B5 (see :func:`forest_leaf_topk`)."""
    pts = data[members.long()]
    mu = leaf_centres(pts, mask) if precision == "bf16" else None
    return leaf_topk_values(pts, members, mask, kk, metric=metric, form=form,
                            precision=precision, sentinel=sentinel, mu=mu)


def forest_leaf_topk(data, members, mask, kk: int, metric: str = "euclidean",
                     form: str | None = "diff", precision: str = "f32",
                     sentinel: int = 0):
    """B5: the leaf scan of a leaf batch. ``data`` (N, d) float32,
    ``members`` (B, L) int32 global ids, ``mask`` (B, L) bool column mask.
    Returns (B, L, kk) float32 distances and int32 ids, ascending by
    (distance, id), (+inf, ``sentinel``) where a slot has fewer than kk
    columns.

    On the card (``csrc/forest_leaf_topk.cu``; its header has the design)
    a warp takes a slot, its lanes striding over the leaf's columns
    gathered through ``members`` from the slot's own position round the
    leaf; its list lies in registers, shared memory or the slot's output
    row as kk grows. One launch is counted a call."""
    if data.device.type == "cpu":
        return forest_leaf_topk_plain(data, members, mask, kk, metric, form, precision, sentinel)
    dev = cuda_build.launch_device("forest_leaf_topk", data, members, mask)
    b, ell = members.shape
    d = data.shape[1]
    check_card_shape(d, kk, metric, np.float32, precision)
    data, metric = cuda_build.kernel_points(data, metric)
    if data.dtype != torch.float32 or members.dtype != torch.int32 or mask.dtype != torch.bool:
        raise ValueError("forest_leaf_topk: data float32, members int32, mask bool")
    if data.dim() != 2 or mask.shape != members.shape:
        raise ValueError("forest_leaf_topk: data (N, d), members and mask (B, L)")
    if not 1 <= kk <= ell:
        raise ValueError(f"forest_leaf_topk: 1 <= kk <= leaf width {ell}, got {kk}")
    _check_ids(members, data.shape[0], "forest_leaf_topk members")
    mu = None
    if precision == "bf16":
        if metric != "euclidean":
            raise ValueError("bf16 distance tiles support euclidean only")
        _check_bf16_width("forest_leaf_topk", kk, d)
        mu = leaf_centres(data[members.long()], mask).contiguous()
    code = cuda_build.metric_code(metric, form)
    data, members = data.contiguous(), members.contiguous()
    mask_u8 = mask.to(torch.uint8).contiguous()
    out_d = torch.empty((b, ell, kk), dtype=torch.float32, device=data.device)
    out_i = torch.empty((b, ell, kk), dtype=torch.int32, device=data.device)
    cuda_build.launch(
        "forest_leaf_topk", dev, data.data_ptr(), d, members.data_ptr(), mask_u8.data_ptr(),
        b, ell, kk, code, sentinel, 0 if mu is None else mu.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), wide=max(kk, d) > cuda_build.WIDE,
    )
    return out_d, out_i


def leaf_blocks(b: int, ell: int) -> int:
    """Blocks of a B5 launch on b leaves of width ell (``forest_leaf_blocks``
    of the kernel), for reports."""
    fn = cuda_build.function("forest_leaf_topk.cu", "forest_leaf_blocks", [ctypes.c_int] * 2)
    return fn(b, ell)


def forest_merge_plain(stack_d, stack_i, kk: int, sentinel: int):
    """Plain version of B6 (see :func:`forest_merge`): the trees folded one
    at a time into running lists (``lexmerge.merge_tile_candidates``)."""
    n = stack_d.shape[1]
    bd = torch.full((n, kk), float("inf"), dtype=stack_d.dtype, device=stack_d.device)
    bi = torch.full((n, kk), sentinel, dtype=torch.int32, device=stack_d.device)
    for t in range(stack_d.shape[0]):
        bd, bi = merge_tile_candidates(bd, bi, stack_d[t], stack_i[t], kk)
    return bd, bi


def forest_merge(stack_d, stack_i, kk: int, sentinel: int):
    """B6: (T, n, kk) per-tree lists, each ascending by (distance, id) with
    (+inf, ``sentinel``) tails -> (n, kk) lists: the trees folded in order
    into running lists that start as (+inf, ``sentinel``). Tree t's entry
    is dropped where the running list holds its id at a distance no larger
    (or it repeats the entry before it); a finite survivor enters among the
    kk lex-smallest. A later tree's copy of an id at a smaller distance so
    stands beside the earlier copy, as in the reference.

    On the card (``csrc/forest_merge.cu``; its header has the design) a
    segment of lanes takes a row at kk <= 32 (two rows a warp at kk <= 16),
    the running list in registers; past 32 a warp a row with the lists in
    shared memory, or past its budget in scratch allocated here. Any number
    of trees; one launch is counted a call."""
    if stack_d.device.type == "cpu":
        return forest_merge_plain(stack_d, stack_i, kk, sentinel)
    dev = cuda_build.launch_device("forest_merge", stack_d, stack_i)
    trees, n, width = stack_d.shape
    if stack_i.shape != stack_d.shape or width != kk:
        raise ValueError(f"forest_merge: stacks must be (T, n, {kk}), got {tuple(stack_d.shape)}")
    if stack_d.dtype != torch.float32 or stack_i.dtype != torch.int32:
        raise ValueError("forest_merge: float32 distances, int32 ids")
    if trees < 1 or kk < 1:
        raise ValueError(f"forest_merge needs trees >= 1 and kk >= 1, got {trees}, {kk}")
    stack_d, stack_i = stack_d.contiguous(), stack_i.contiguous()
    out_d = torch.empty((n, kk), dtype=torch.float32, device=stack_d.device)
    out_i = torch.empty((n, kk), dtype=torch.int32, device=stack_d.device)
    slots = merge_slots(n, kk)  # each 3 lists of kk (distance, id) pairs
    scratch = torch.empty(slots * 6 * kk, dtype=torch.float32, device=stack_d.device)
    cuda_build.launch(
        "forest_merge", dev, stack_d.data_ptr(), stack_i.data_ptr(), trees, n, kk, sentinel,
        scratch.data_ptr() if slots else 0, out_d.data_ptr(), out_i.data_ptr(),
        wide=kk > cuda_build.WIDE,
    )
    return out_d, out_i


def merge_slots(n: int, kk: int) -> int:
    """Warp slots whose lists a B6 launch on n rows at kk keeps in device
    memory (``forest_merge_slots`` of the kernel; 0 where they fit in
    shared memory)."""
    fn = cuda_build.function("forest_merge.cu", "forest_merge_slots", [ctypes.c_int] * 2)
    return fn(n, kk)


def _to_sentinel(nd, ni, sentinel):
    return nd, torch.where(torch.isinf(nd), sentinel, ni).to(torch.int32)


def forest_rescan_topk_plain(q, data, cids, k: int, metric: str = "euclidean",
                             precision: str = "f32", sentinel: int = 0):
    """Plain version of B7 (see :func:`forest_rescan_topk`)."""
    mu = row_tile_centres(q) if precision == "bf16" else None
    cpts = data[cids.clamp(0, sentinel - 1).long()]
    nd, ni = rescan_topk_values(q, cpts, cids, k, metric=metric, precision=precision,
                                sentinel=sentinel, mu=mu)
    return _to_sentinel(nd, ni, sentinel)


def forest_rescan_topk(q, data, cids, k: int, metric: str = "euclidean",
                       precision: str = "f32", sentinel: int = 0):
    """B7: query rows ``q`` (m, d) against their candidate ids ``cids``
    (m, C) int32 into ``data`` (N, d) (``sentinel`` marks an empty slot) ->
    (m, k) lex k-best distinct (distance, id), (+inf, ``sentinel``) in
    unused slots.

    On the card (``csrc/forest_rescan.cu``; its header has the design) a
    warp takes a row, its lanes striding over the candidates; where the
    row blocks (four rows each) are fewer than about four an SM, each row's
    candidates are cut into :func:`rescan_splits` spans, each span's list
    goes to scratch allocated here, and a second pass of the same launch
    merges them (the contract is a function of the set of distinct pairs,
    so the partition does not change the result). Lists lie in registers
    at k <= 32, in shared memory up to k = 1,024, in device memory above;
    one launch is counted a call."""
    if q.device.type == "cpu":
        return forest_rescan_topk_plain(q, data, cids, k, metric, precision, sentinel)
    dev = cuda_build.launch_device("forest_rescan_topk", q, data, cids)
    m, d = q.shape
    c = cids.shape[1]
    check_card_shape(d, k, metric, np.float32, precision)
    q, _ = cuda_build.kernel_points(q, metric)
    data, metric = cuda_build.kernel_points(data, metric)
    if q.dtype != torch.float32 or data.dtype != torch.float32 or cids.dtype != torch.int32:
        raise ValueError("forest_rescan_topk: q and data float32, cids int32")
    if data.dim() != 2 or data.shape[1] != d or cids.shape != (m, c):
        raise ValueError("forest_rescan_topk: q (m, d), data (N, d), cids (m, C)")
    _check_ids(cids, data.shape[0], "forest_rescan_topk cids", sentinel)
    mu = None
    if precision == "bf16":
        if metric != "euclidean":
            raise ValueError("bf16 distance tiles support euclidean only")
        _check_bf16_width("forest_rescan_topk", k, d)
        mu = row_tile_centres(q).contiguous()
    code = cuda_build.metric_code(metric, euclid_form(1, c, d) if metric == "euclidean" else None)
    q, data, cids = q.contiguous(), data.contiguous(), cids.contiguous()
    out_d = torch.empty((m, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=q.device)
    splits = rescan_splits(m, c, d, k, mu is not None)
    sd = si = None
    if splits > 1:
        sd = torch.empty(splits * m * k, dtype=torch.float32, device=q.device)
        si = torch.empty(splits * m * k, dtype=torch.int32, device=q.device)
    cuda_build.launch(
        "forest_rescan_topk", dev, q.data_ptr(), data.data_ptr(), cids.data_ptr(), m, c, d, k,
        code, sentinel, 0 if mu is None else mu.data_ptr(), splits,
        0 if sd is None else sd.data_ptr(), 0 if si is None else si.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), wide=max(k, d) > cuda_build.WIDE,
    )
    return _to_sentinel(out_d, out_i, sentinel)


def rescan_splits(m: int, c: int, d: int, k: int, bf16: bool = False) -> int:
    """Candidate spans a B7 launch of m rows, c candidates, d features and k
    slots cuts each row into (``forest_rescan_splits`` of the kernel; the
    launch's grid is :func:`rescan_blocks`)."""
    fn = cuda_build.function("forest_rescan.cu", "forest_rescan_splits", [ctypes.c_int] * 5)
    return fn(m, c, d, k, int(bf16))


def rescan_blocks(m: int, c: int, d: int, k: int, bf16: bool = False) -> int:
    """Blocks of a B7 launch's scan grid: row blocks of four rows times
    spans."""
    fn = cuda_build.function("forest_rescan.cu", "forest_rescan_blocks", [ctypes.c_int] * 5)
    return fn(m, c, d, k, int(bf16))


def forest_min_outgoing_plain(q, data, cids, core_q, core, comp_q, comp,
                              metric: str = "euclidean", sentinel: int = 0,
                              precision: str = "f32"):
    """Plain version of B8 (see :func:`forest_min_outgoing`)."""
    mu = row_tile_centres(q) if precision == "bf16" else None
    at = cids.clamp(0, sentinel - 1).long()
    return cand_minout_values(q, data[at], cids, core_q, core[at], comp_q, comp[at],
                              metric=metric, sentinel=sentinel, precision=precision, mu=mu)


def forest_min_outgoing(q, data, cids, core_q, core, comp_q, comp,
                        metric: str = "euclidean", sentinel: int = 0, precision: str = "f32"):
    """B8: query rows ``q`` (m, d) with core ``core_q`` and component
    ``comp_q`` against their candidate ids ``cids`` (m, C) into ``data``
    (N, d), ``core`` (N,), ``comp`` (N,) -> ((m,) float32 w, (m,) int32 id)
    of the minimum mutual-reachability edge to another component, the first
    minimal panel column on ties, (+inf, -1) where there is none. f32, or
    bf16 distances (euclidean) centred as B7's.

    On the card (``csrc/forest_rescan.cu``; its header has the design) a
    warp takes a row, its lanes striding over the candidates, the
    component test before the coordinates; where the row blocks are fewer
    than about four an SM, the candidates are cut into
    :func:`minout_splits` spans, each span's minimum goes to scratch
    allocated here, and a second pass of the same launch takes each row's
    minimum over its spans. One launch is counted a call."""
    if q.device.type == "cpu":
        return forest_min_outgoing_plain(q, data, cids, core_q, core, comp_q, comp,
                                         metric, sentinel, precision)
    args = (q, data, cids, core_q, core, comp_q, comp)
    dev = cuda_build.launch_device("forest_min_outgoing", *args)
    m, d = q.shape
    c = cids.shape[1]
    check_card_shape(d, 1, metric, np.float32, precision)
    q, _ = cuda_build.kernel_points(q, metric)
    data, metric = cuda_build.kernel_points(data, metric)
    args = (q, data, *args[2:])
    if any(t.dtype != torch.float32 for t in (q, data, core_q, core)):
        raise ValueError("forest_min_outgoing: q, data, core_q and core must be float32")
    if any(t.dtype != torch.int32 for t in (cids, comp_q, comp)):
        raise ValueError("forest_min_outgoing: cids, comp_q and comp must be int32")
    n = data.shape[0]
    if (data.dim() != 2 or data.shape[1] != d or cids.shape != (m, c)
            or core_q.shape != (m,) or comp_q.shape != (m,)
            or core.shape != (n,) or comp.shape != (n,)):
        raise ValueError("forest_min_outgoing: q (m, d), data (N, d), cids (m, C), "
                         "core_q and comp_q (m,), core and comp (N,)")
    _check_ids(cids, n, "forest_min_outgoing cids", sentinel)
    mu = None
    if precision == "bf16":
        if metric != "euclidean":
            raise ValueError("bf16 distance tiles support euclidean only")
        _check_bf16_width("forest_min_outgoing", 1, d)
        mu = row_tile_centres(q).contiguous()
    code = cuda_build.metric_code(metric, euclid_form(1, c, d) if metric == "euclidean" else None)
    args = [t.contiguous() for t in args]
    out_w = torch.empty(m, dtype=torch.float32, device=q.device)
    out_j = torch.empty(m, dtype=torch.int32, device=q.device)
    splits = minout_splits(m, c)
    nscratch = splits * m if splits > 1 else 0  # each span's (w, column) a row
    pw = torch.empty(nscratch, dtype=torch.float32, device=q.device)
    pc = torch.empty(nscratch, dtype=torch.int32, device=q.device)
    cuda_build.launch(
        "forest_min_outgoing", dev, args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(),
        m, c, d, code, sentinel, 0 if mu is None else mu.data_ptr(), args[3].data_ptr(),
        args[4].data_ptr(), args[5].data_ptr(), args[6].data_ptr(), splits,
        pw.data_ptr() if nscratch else 0, pc.data_ptr() if nscratch else 0,
        out_w.data_ptr(), out_j.data_ptr(), wide=d > cuda_build.WIDE,
    )
    return out_w, out_j


def minout_splits(m: int, c: int) -> int:
    """Candidate spans a B8 launch of m rows and c candidates cuts each row
    into (``forest_minout_splits`` of the kernel)."""
    fn = cuda_build.function("forest_rescan.cu", "forest_minout_splits", [ctypes.c_int] * 2)
    return fn(m, c)
