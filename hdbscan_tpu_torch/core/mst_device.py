"""Device-resident MST -> merge-forest engine — the port of
``core/mst_device.py`` (``mst_backend=device``).

Shape of the engine, as in the reference:

- Borůvka rounds on the device (:func:`boruvka_mst_device`): every round is
  one segment-min kernel launch (``ops/cuda_segmin``), then the label-space
  contraction (:func:`_contract_round`, a cascade of ``scatter_reduce``
  minima) and the pointer-doubling collapse (:func:`_collapse_labels`).
  PyTorch has no device ``while_loop``, so a Python loop drives the rounds
  and reads one (components, edges added) scalar pair per round; those
  reads are counted (``round_syncs``). The MST edges stay on the device.
- The union-find event scan (:func:`forest_events_device`): three stable
  sorts put the edges in (w, u, v) order, then the ``uf_scan`` kernel
  replays Kruskal's unions and emits the event stream (ra, rb).
- One bulk fetch, then the vectorized host reconstruction
  (:func:`assemble_merge_forest`, numpy, a copy of the reference's).

Label space is the reference's: component labels are representative vertex
ids < n; segment reductions run over (n + 1)-slot buffers whose last slot
takes what JAX's ``mode="drop"`` scatters would drop.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hdbscan_tpu_torch.core.tree import TIE_RTOL, MergeForest
from hdbscan_tpu_torch.ops import cuda_build
from hdbscan_tpu_torch.utils import tracing

__all__ = [
    "supports_inputs",
    "resolve_mst_backend",
    "forest_events_device",
    "assemble_merge_forest",
    "build_merge_forest_device",
    "boruvka_mst_device",
    "assert_rounds_converged",
]

#: Round cap of the Borůvka loop. Borůvka at least halves the component
#: count every productive round, so hitting it means a broken contraction.
DEFAULT_MAX_ROUNDS = 64

_INT32_MAX = torch.iinfo(torch.int32).max


def _ties_exact(w, tie_rtol: float = TIE_RTOL) -> bool:
    """No near-tied-but-unequal pair among the (finite) weights."""
    w = np.asarray(w, np.float64)
    w = w[np.isfinite(w)]
    if w.size < 2:
        return True
    sw = np.sort(w)
    a, b = sw[:-1], sw[1:]
    gap = b - a
    near = gap <= tie_rtol * np.maximum(np.abs(a), np.abs(b))
    return not bool(np.any(near & (gap != 0)))


def supports_inputs(w, point_weights=None, tie_rtol: float = TIE_RTOL) -> bool:
    """Host-side predicate: the device forest equals the host builder's.

    True iff no two distinct edge weights are near-tied within ``tie_rtol``
    and point weights sum exactly in any order (integral, total < 2**53).
    """
    if not _ties_exact(w, tie_rtol):
        return False
    if point_weights is not None:
        pw = np.asarray(point_weights, np.float64)
        if pw.size and (
            bool(np.any(pw != np.floor(pw))) or float(np.sum(pw)) >= 2**53
        ):
            return False
    return True


def resolve_mst_backend(params=None, n: int | None = None,
                        mst_backend: str | None = None) -> str:
    """The MST engine a fit runs: "device" for ``auto`` and ``device`` at any
    n (the reference's 65,536-vertex threshold saved XLA compiles, which
    eager PyTorch does not pay), "host" when asked for."""
    backend = mst_backend or getattr(params, "mst_backend", "auto")
    if backend not in ("auto", "host", "device"):
        raise ValueError(f"mst_backend must be auto | host | device, got {backend!r}")
    return "host" if backend == "host" else "device"


# ---------------------------------------------------------------------------
# Union-find event scan (kernel K3 and its plain version)
# ---------------------------------------------------------------------------


def uf_scan_plain(su: torch.Tensor, sv: torch.Tensor, n: int):
    """Plain version of the ``uf_scan`` kernel, on host copies: per step the
    two roots (ra, rb), then ``par[rb] = ra`` (a step merged two trees iff
    ra != rb). Finds halve paths; roots depend only on the links, so the
    stream equals the reference's ``_uf_scan``."""
    su_h = su.cpu().tolist()
    sv_h = sv.cpu().tolist()
    par = list(range(n))
    ra = [0] * len(su_h)
    rb = [0] * len(su_h)
    for e, (ue, ve) in enumerate(zip(su_h, sv_h)):
        a = ue
        while par[a] != a:
            par[a] = par[par[a]]
            a = par[a]
        b = ve
        while par[b] != b:
            par[b] = par[par[b]]
            b = par[b]
        par[ue] = a
        par[ve] = b
        par[b] = a
        ra[e], rb[e] = a, b
    return (
        torch.tensor(ra, dtype=torch.int32, device=su.device),
        torch.tensor(rb, dtype=torch.int32, device=su.device),
    )


def uf_scan(su: torch.Tensor, sv: torch.Tensor, n: int):
    """Union-find event scan over (w, u, v)-sorted int32 endpoints: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if su.device.type == "cpu":
        return uf_scan_plain(su, sv, n)
    return uf_scan_launch(su, sv, n)


#: ``prof`` slots of ``csrc/uf_scan.cu`` (its ``UF_PROF_*``).
UF_PROF_FIELDS = ("find_cycles", "compact_cycles", "replay_cycles", "apply_cycles", "finds",
                  "hops", "max_find_rounds", "batches", "replay_steps", "replay_find_rounds",
                  "replay_groups", "replay_shuffle_rounds")


def uf_scan_launch(su: torch.Tensor, sv: torch.Tensor, n: int,
                   prof: torch.Tensor | None = None):
    """Launch the ``uf_scan`` kernel (one block replaying 1,024 edges at a
    time; ``csrc/uf_scan.cu`` has the design). ``prof``, an int64 CUDA
    tensor of ``len(UF_PROF_FIELDS)``, receives the phases' cycles and the
    finds' hop counts."""
    if su.dtype != torch.int32 or sv.dtype != torch.int32 or su.shape != sv.shape:
        raise ValueError("uf_scan: endpoints must be int32 vectors of one length")
    if prof is not None and (prof.dtype != torch.int64 or prof.numel() != len(UF_PROF_FIELDS)):
        raise ValueError(f"uf_scan: prof must hold {len(UF_PROF_FIELDS)} int64")
    dev = cuda_build.launch_device("uf_scan", su, sv, *([] if prof is None else [prof]))
    su, sv = su.contiguous(), sv.contiguous()
    m = su.shape[0]
    par = torch.arange(max(n, 1), dtype=torch.int32, device=su.device)
    ra = torch.empty(m, dtype=torch.int32, device=su.device)
    rb = torch.empty(m, dtype=torch.int32, device=su.device)
    cuda_build.launch(
        "uf_scan", dev, su.data_ptr(), sv.data_ptr(), m, n, par.data_ptr(),
        ra.data_ptr(), rb.data_ptr(), 0 if prof is None else prof.data_ptr(),
    )
    return ra, rb


def forest_events_device(u, v, w, n: int):
    """Edge pool -> union event stream, on the pool's device.

    Sorts into the canonical (w, u, v) order with three stable passes from
    the least-significant key up (``np.lexsort``'s order), then runs the
    union-find scan. Padding rows (+inf weight, self-loops) sort last and
    fall out as non-merges. Returns {"sw", "ra", "rb"} device tensors.
    """
    o = torch.sort(v.to(torch.int32), stable=True).indices
    o = o[torch.sort(u[o].to(torch.int32), stable=True).indices]
    order = o[torch.sort(w[o], stable=True).indices]
    su = u[order].to(torch.int32)
    sv = v[order].to(torch.int32)
    ra, rb = uf_scan(su, sv, n)
    return {"sw": w[order], "ra": ra, "rb": rb}


# ---------------------------------------------------------------------------
# Host stage: vectorized reconstruction from the fetched event records
# (numpy; a copy of the reference's)
# ---------------------------------------------------------------------------


def _doubling_rounds(size: int) -> int:
    return max(1, int(math.ceil(math.log2(max(size, 2)))) + 1)


def _merge_tops(n: int, t: int, ra_m, rb_m):
    """Per-merge child tops (ta, tb) from the union event stream (see the
    reference's ``_merge_tops``: a 2t-row (value, time) sweep)."""
    if t == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    rows = 2 * t
    vals = np.empty(rows, np.int64)
    vals[0::2] = ra_m
    vals[1::2] = rb_m
    payload = np.full(rows, -1, np.int64)
    payload[0::2] = np.arange(t)
    ordk = np.argsort(vals * rows + np.arange(rows), kind="stable")
    base = vals[ordk] * np.int64(t + 2)
    runmax = np.maximum.accumulate(base + payload[ordk] + 1)
    prevmax = np.empty_like(runmax)
    prevmax[0] = -1
    prevmax[1:] = np.where(base[1:] == base[:-1], runmax[:-1], -1)
    fused = (np.arange(rows) % 2 == 0)[ordk]
    last = np.empty(rows, np.int64)
    last[ordk] = np.where(fused, prevmax, runmax) - base - 1
    ta = np.where(last[0::2] >= 0, n + last[0::2], ra_m)
    tb = np.where(last[1::2] >= 0, n + last[1::2], rb_m)
    return ta, tb


def assemble_merge_forest(
    n: int, out: dict, point_weights=None, build_children: bool = True
) -> MergeForest | None:
    """Fetched event stream {"sw", "ra", "rb"} (numpy) -> host ``MergeForest``.

    Vectorized numpy only. Returns ``None`` when the sorted weights fail the
    exact-tie gate — the caller then builds the forest on the host.
    ``build_children=False`` skips the Python ``children`` lists (the
    vectorized tree engine reads ``kids_csr``).
    """
    sw = np.asarray(out["sw"], np.float64)
    if not _ties_exact(sw):
        return None
    ra_all = np.asarray(out["ra"], np.int64)
    rb_all = np.asarray(out["rb"], np.int64)
    mi = np.nonzero(ra_all != rb_all)[0]  # merge steps joined two roots
    t = len(mi)
    dist = sw[mi]  # node k's weight: merges are numbered in step order
    ra_m = ra_all[mi]
    rb_m = rb_all[mi]
    nid = n + np.arange(t, dtype=np.int64)
    el_n = n + t
    el = np.arange(el_n, dtype=np.int64)
    ta, tb = _merge_tops(n, t, ra_m, rb_m)

    # Absorption by exact equality: child node's weight equals the merge's.
    safe_ta = np.clip(ta - n, 0, max(t - 1, 0))
    safe_tb = np.clip(tb - n, 0, max(t - 1, 0))
    absorb_a = (ta >= n) & (dist[safe_ta] == dist) if t else np.zeros(0, bool)
    absorb_b = (tb >= n) & (dist[safe_tb] == dist) if t else np.zeros(0, bool)

    par_el = np.full(el_n, -1, np.int64)
    par_el[ta] = nid
    par_el[tb] = nid
    absorbed = np.zeros(el_n, bool)
    absorbed[ta[absorb_a]] = True
    absorbed[tb[absorb_b]] = True

    # One global Euler tour: en(x) = 2x, ex(x) = 2x + 1; a node's entry leads
    # to its a-child, roots chain in ascending order, and one
    # distance-to-terminal list ranking orders every slot of every tree.
    slots = 2 * el_n
    s = np.empty(slots, np.int32)
    s[0::2] = np.arange(1, slots, 2, dtype=np.int32)  # childless: en -> ex
    s[2 * nid] = 2 * ta
    s[2 * ta + 1] = 2 * tb
    s[2 * tb + 1] = 2 * nid + 1
    roots_el = np.nonzero(par_el < 0)[0]
    s[2 * roots_el[:-1] + 1] = 2 * roots_el[1:]
    term = 2 * roots_el[-1] + 1
    s[term] = term
    nxt = s
    dd = (nxt != np.arange(slots, dtype=np.int32)).astype(np.int32)
    for _ in range(_doubling_rounds(slots)):
        dd = dd + dd[nxt]  # terminal keeps dd 0, so no mask needed
        nxt = nxt[nxt]
    rk = slots - dd  # int32: ascending along the tour, unique

    # Owner of a kid = nearest non-absorbed ancestor (pointer doubling).
    g = np.where(absorbed, par_el, el).astype(np.int32)
    for _ in range(_doubling_rounds(el_n)):
        g2 = g[g]
        if np.array_equal(g2, g):
            break
        g = g2
    is_kid = (par_el >= 0) & ~absorbed
    owner = np.where(par_el >= 0, g[np.clip(par_el, 0, None)].astype(np.int64), -1)

    # Kid lists: within one owner, DFS preorder = ascending entry rank.
    big = np.int64(slots + 1)
    ckey = np.where(
        is_kid, owner * big + rk[2 * el].astype(np.int64), np.iinfo(np.int64).max
    )
    kid_flat = np.argsort(ckey, kind="stable")[: int(is_kid.sum())]
    kid_count = np.zeros(max(t, 1), np.int64)
    np.add.at(kid_count, owner[is_kid] - n, 1)
    kid_count = kid_count[:t]

    # Sizes: a node's subtree leaves occupy the open rank interval
    # (rk[en], rk[ex]); prefix sums over the tour-ordered leaf weights.
    pw = (
        np.ones(n, np.float64)
        if point_weights is None
        else np.asarray(point_weights, np.float64)
    )
    lr = rk[0: 2 * n: 2]
    lord = np.argsort(lr, kind="stable")
    cum = np.zeros(n + 1, np.float64)
    np.cumsum(pw[lord], out=cum[1:])
    lr_sorted = lr[lord]
    node_sizes = (
        cum[np.searchsorted(lr_sorted, rk[2 * nid + 1])]
        - cum[np.searchsorted(lr_sorted, rk[2 * nid])]
    )
    sizes = np.concatenate([pw, node_sizes])

    children = None
    absorbed_nodes = absorbed[n:]
    if build_children:
        flat_list = kid_flat.tolist()
        offs = np.zeros(t + 1, np.int64)
        np.cumsum(kid_count, out=offs[1:])
        children = [
            flat_list[offs[k]: offs[k + 1]] if not absorbed_nodes[k] else None
            for k in range(t)
        ]

    # Roots: the parentless elements, ascending.
    roots = [int(r) for r in roots_el]

    return MergeForest(
        n_points=n,
        children=children,
        dist=dist,
        roots=roots,
        sizes=sizes,
        kids_csr=(kid_flat, kid_count),
    )


def build_merge_forest_device(
    n: int,
    u,
    v,
    w,
    point_weights=None,
    trace=None,
    build_children: bool = True,
    *,
    device=None,
) -> MergeForest | None:
    """Device twin of ``core/tree.build_merge_forest`` for a host edge pool:
    the (w, u, v) sort and the union-find scan (kernel K3) on ``device``,
    one fetch, then :func:`assemble_merge_forest` on the host.

    Returns ``None`` — the caller then builds the forest on the host — for
    a trivial pool, for non-integral point weights, when the weights fail
    the exact-tie gate, for a float64 pool whose weights are not
    exactly float32-representable (the card sorts and carries float32
    weights, and a rounded weight would no longer give the host builder's
    forest), and for a pool with a weight that is not finite: the scan
    takes a +inf edge for inert padding (the exact fit's buffer tail), where
    the host builder merges at +inf, as a pool around a zero-norm point at
    cosine needs. Emits ``host_sync`` and ``tree_build_device``.
    """
    import time

    m = int(np.shape(u)[0])
    if m == 0 or n == 0:
        return None
    if point_weights is not None and not supports_inputs([], point_weights):
        return None
    w = np.asarray(w)
    if w.dtype == np.float64 and not np.array_equal(w, w.astype(np.float32).astype(np.float64)):
        return None
    if not np.all(np.isfinite(w)):
        return None
    from hdbscan_tpu_torch import obs

    dev = cuda_build.resolve_device(device)
    t0 = time.monotonic()
    with obs.mem_phase("tree_build_device"):
        out = forest_events_device(
            torch.as_tensor(np.asarray(u, np.int32), device=dev),
            torch.as_tensor(np.asarray(v, np.int32), device=dev),
            torch.as_tensor(w.astype(np.float32), device=dev),
            n,
        )
        build_wall = time.monotonic() - t0
        t0 = time.monotonic()
        fetched = {k: t.cpu().numpy() for k, t in out.items()}
        sync_wall = time.monotonic() - t0
    tl = obs.timeline()
    if tl is not None:
        # One device, no panel traffic: the only host segment is the one
        # fetch and the whole device wall attributes to compute.
        tl.record_round("tree_build_device", 0, [(dev.index or 0, build_wall)],
                        fetch_s=sync_wall, trace=trace)
    if trace is not None:
        trace(
            "host_sync",
            arrays=len(fetched),
            bytes=int(sum(a.nbytes for a in fetched.values())),
            wall_s=round(sync_wall, 6),
        )
    t0 = time.monotonic()
    forest = assemble_merge_forest(
        n, fetched, point_weights=point_weights, build_children=build_children
    )
    if trace is not None:
        trace(
            "tree_build_device",
            n=n,
            edges=m,
            nodes=-1 if forest is None else len(forest.dist),
            backend="device",
            fallback=forest is None,
            wall_s=round(build_wall + (time.monotonic() - t0), 6),
        )
    return forest


# ---------------------------------------------------------------------------
# Device Borůvka rounds
# ---------------------------------------------------------------------------


def _seg_min_into(n: int, idx, val, fill):
    """(n,) segment minimum of ``val`` by label ``idx``; label n is dropped
    (the (n + 1)-th slot takes the writes JAX's ``mode="drop"`` discards)."""
    buf = torch.full((n + 1,), fill, dtype=val.dtype, device=val.device)
    buf.scatter_reduce_(0, idx.to(torch.int64), val, "amin", include_self=True)
    return buf[:n]


def _collapse_labels(comp, valid, has_edge, tgt_comp, n: int):
    """Pointer-doubling collapse over per-label winners (the reference's
    ``_collapse_labels``): every label lands on its group's cycle and the
    cycle minimum becomes the group root.

    Returns (emit_mask(n,), rep(n,), n_comp, edges_added) with
    ``emit_mask`` in ascending-label order (the host's emission order);
    the two counts are 0-d device tensors.
    """
    labels = torch.arange(n, dtype=torch.int32, device=comp.device)
    s = torch.where(has_edge, tgt_comp, labels)
    mn = labels
    for _ in range(_doubling_rounds(n)):
        mn, s = torch.minimum(mn, mn[s]), s[s]
    rep = mn[s]
    is_root = rep == labels
    active = torch.zeros(n + 1, dtype=torch.bool, device=comp.device)
    active[torch.where(valid, comp, n).to(torch.int64)] = True
    active = active[:n]
    emit_mask = active & ~is_root & has_edge
    n_comp = torch.sum(active & is_root)
    return emit_mask, rep, n_comp, torch.sum(emit_mask)


def _contract_round(comp, bw, bj, valid, n: int):
    """One Borůvka contraction in label space (the reference's
    ``_contract_round``). Winner per component: minimum by (w, lo, hi) then
    lowest row id, found with a weight scatter-min followed by int32
    scatter-mins over the rows still tied at each stage.

    Returns (emit_mask(n,), win_row(n,), rep(n,), n_comp, edges_added).
    """
    n_pad = comp.shape[0]
    rows = torch.arange(n_pad, dtype=torch.int32, device=comp.device)
    bj_c = torch.clamp(bj, 0, n_pad - 1)
    cross = valid & (bj >= 0) & (comp != comp[bj_c])
    lab = torch.where(cross, comp, n)
    comp_c = torch.clamp(comp, 0, n - 1)

    wmin = _seg_min_into(n, lab, bw, float("inf"))
    tied = cross & (bw == wmin[comp_c])

    def seg_min(mask, val):
        return _seg_min_into(n, torch.where(mask, lab, n), val, _INT32_MAX)

    lo = torch.minimum(rows, bj_c)
    hi = torch.maximum(rows, bj_c)
    lo_min = seg_min(tied, lo)
    tied = tied & (lo == lo_min[comp_c])
    hi_min = seg_min(tied, hi)
    tied = tied & (hi == hi_min[comp_c])
    row_min = seg_min(tied, rows)
    has_edge = row_min < _INT32_MAX
    win_row = torch.where(has_edge, row_min, 0)

    tgt_comp = comp[torch.clamp(bj[win_row], 0, n_pad - 1)]
    emit_mask, rep, n_comp, added = _collapse_labels(
        comp, valid, has_edge, tgt_comp, n
    )
    return emit_mask, win_row, rep, n_comp, added


def assert_rounds_converged(
    rounds: int,
    count: int,
    n: int,
    *,
    max_rounds: int = DEFAULT_MAX_ROUNDS,
    stat_comp=None,
    stat_edges=None,
    where: str = "boruvka_mst_device",
) -> None:
    """Raise if the Borůvka loop stopped at its round cap with components
    still merging (a contraction/scan defect or NaN weights, never input
    size). A clean exit is ``count == n - 1`` or a last round that added no
    edges (disconnected data)."""
    if rounds < max_rounds or count >= max(n - 1, 0):
        return
    survivors = None
    tail = ""
    if stat_comp is not None:
        survivors = int(np.asarray(stat_comp)[max_rounds - 1])
    if stat_edges is not None:
        stat_edges = np.asarray(stat_edges)
        if int(stat_edges[max_rounds - 1]) == 0:
            return  # saturated (disconnected input), not capped mid-merge
        show = min(4, max_rounds)
        comps = (
            np.asarray(stat_comp)[-show:].tolist() if stat_comp is not None else "?"
        )
        tail = (
            f"; last {show} rounds: components={comps}, "
            f"edges_added={stat_edges[-show:].tolist()}"
        )
    surviving = (
        f"{survivors} components still unmerged"
        if survivors is not None
        else f"{max(n - count, 1)} components still unmerged (from edge count)"
    )
    raise RuntimeError(
        f"{where}: Borůvka round cap hit without convergence — "
        f"{rounds} rounds (max_rounds={max_rounds}) emitted {count} of "
        f"{max(n - 1, 0)} spanning edges with {surviving} and the loop "
        f"was still merging{tail}."
    )


def boruvka_mst_device(
    data,
    core,
    metric: str = "euclidean",
    row_tile: int = 1024,
    col_tile: int = 8192,
    dtype=np.float32,
    max_rounds: int = DEFAULT_MAX_ROUNDS,
    device=None,
    trace=None,
):
    """Device-resident Borůvka MST over mutual reachability.

    ``data`` (n, d) and ``core`` (n,) host arrays, cast to ``dtype`` as the
    reference does. Edges are emitted into fixed (n - 1,) buffers (weights
    +inf, endpoints 0 where unused, so the tail passes through
    :func:`forest_events_device` as inert self-loops). Returns a dict of
    device tensors {"u", "v", "w"} plus host values "count", "rounds",
    "round_syncs" and the per-round (max_rounds,) "stat_comp"/"stat_edges".
    Each round is a ``boruvka.round`` span (``utils/tracing.span``),
    device-timed up to the round's one read; ``trace`` receives it as an
    ``mst_round`` event (round, components, edges_added, its wall).
    """
    from hdbscan_tpu_torch import obs
    from hdbscan_tpu_torch.ops.cuda_segmin import min_outgoing_all_rows

    with obs.mem_phase("boruvka_rounds_device"):
        dev = cuda_build.resolve_device(device)
        n = len(data)
        data_t = torch.as_tensor(np.asarray(data, dtype), device=dev)
        core_t = torch.as_tensor(np.asarray(core, dtype), device=dev)
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        buf = max(n - 1, 1)
        comp = torch.arange(n, dtype=torch.int32, device=dev)
        # One extra slot takes the writes of non-emitting labels.
        eu = torch.zeros(buf + 1, dtype=torch.int32, device=dev)
        ev = torch.zeros(buf + 1, dtype=torch.int32, device=dev)
        ew = torch.full((buf + 1,), float("inf"), dtype=data_t.dtype, device=dev)
        stat_comp = np.zeros(max_rounds, np.int32)
        stat_edges = np.zeros(max_rounds, np.int32)
        count = 0
        n_comp = n
        rounds = 0
        syncs = 0
        progress = True
        while rounds < max_rounds and n_comp > 1 and progress:
            with tracing.span("boruvka.round", hook=trace, stage="mst_round", device=dev,
                              round=rounds) as sp:
                bw, bj = min_outgoing_all_rows(
                    data_t, core_t, comp, valid, metric, row_tile, col_tile
                )
                emit_mask, win_row, rep, n_comp_t, added_t = _contract_round(
                    comp, bw, bj, valid, n
                )
                pos = count + torch.cumsum(emit_mask.to(torch.int32), 0) - 1
                slot = torch.where(emit_mask, pos, buf).to(torch.int64)
                wr = torch.clamp(win_row, 0, n - 1)
                eu[slot] = wr
                ev[slot] = torch.clamp(bj[wr], 0, n - 1)
                ew[slot] = bw[wr]
                comp = rep[comp]
                sp.device_stop()
                # The round's one device->host read: it drives the loop.
                n_comp, added = torch.stack([n_comp_t, added_t]).tolist()
                sp.set(components=n_comp, edges_added=added)
            syncs += 1
            stat_comp[rounds] = n_comp
            stat_edges[rounds] = added
            count += added
            progress = added > 0
            rounds += 1
        return {
            "u": eu[:buf],
            "v": ev[:buf],
            "w": ew[:buf],
            "count": count,
            "rounds": rounds,
            "round_syncs": syncs,
            "stat_comp": stat_comp,
            "stat_edges": stat_edges,
        }
