"""The sharded exact fit — the port of ``parallel/shard.py``'s exact tier:
ring core distances and the sharded device Borůvka rounds.

The reference runs every sharded Borůvka round inside one ``shard_map``
``while_loop`` (``_shard_mst_fn``). The port runs the same rounds as a host
loop over a single-process mesh (``parallel/mesh.Mesh``), one scalar read
per round driving it, as the single-device ``boruvka_mst_device`` does. A
round:

1. scan — every shard ``me`` keeps its row shard, core distances and
   labels resident and scans the panels in ring order ``(me - s) % D``
   through the panel segment-min kernel (``ops/cuda_segmin.
   min_outgoing_panel``, B9); a panel-local winner becomes global as
   ``where(pj >= 0, pj + off, 0)`` and enters under the explicit (w, j)
   lexicographic update, so the arrival order cannot change the winner;
2. reduction — each shard's scatter-min partials over the (n,) label space
   are min-reduced across shards on the first shard's device, in the key
   order of ``core/mst_device._contract_round``: weight, then lo, hi and
   row over the rows still tied, then the winner's target column;
3. contraction — ``core/mst_device._collapse_labels`` (the same
   pointer-doubling collapse) and the slot emission into edge buffers in
   ascending-label order with +inf self-loop padding, so the edges equal the
   single-device engine's slot for slot; the new labels go back to every
   shard's device.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP
entry: the host-round sharded scanner :class:`ShardBoruvkaScanner` (A3,
A9), the sharded rp-forest ``shard_forest_core_distances`` (A9), and the
reference's partition-rule table (a JAX sharding device with no torch
counterpart: a shard's tensors lie on its device).
"""

from __future__ import annotations

import numpy as np
import torch

from hdbscan_tpu_torch.core.distances import euclidean_form
from hdbscan_tpu_torch.parallel.mesh import device_count, get_mesh
from hdbscan_tpu_torch.parallel.ring import _ring_geometry, _shard_rows

#: Valid ``fit_sharding`` values (``config.HDBSCANParams.fit_sharding``).
FIT_SHARDINGS = ("auto", "replicated", "sharded")

_INT32_MAX = torch.iinfo(torch.int32).max


def resolve_fit_sharding(fit_sharding: str, mesh) -> str:
    """Map the ``fit_sharding`` knob to the program: "replicated" and
    "sharded" are literal; "auto" picks the sharded program only on a mesh
    of two or more distinct CUDA devices (the reference's multi-device TPU
    rule), so one card and CPU meshes keep the single-device fit."""
    if fit_sharding not in FIT_SHARDINGS:
        raise ValueError(
            f"unknown fit_sharding {fit_sharding!r}: auto | replicated | sharded"
        )
    if fit_sharding != "auto":
        return fit_sharding
    if mesh is None:
        return "replicated"
    cards = mesh.distinct()
    if len(cards) > 1 and all(d.type == "cuda" for d in cards):
        return "sharded"
    return "replicated"


def shard_core_distances(
    data: np.ndarray,
    min_pts: int,
    metric: str = "euclidean",
    *,
    row_tile: int = 1024,
    col_tile: int = 8192,
    dtype=np.float32,
    mesh=None,
    trace=None,
    knn_backend: str = "auto",
    index: str = "exact",
    index_opts: dict | None = None,
) -> np.ndarray:
    """Core distances under the sharded program, (n,) float64: the ring
    k-NN scan with only the k-th column fetched."""
    from hdbscan_tpu_torch.parallel.ring import ring_knn_core_distances

    if index == "rpforest":
        return shard_forest_core_distances()
    core, _ = ring_knn_core_distances(
        data, min_pts, metric, row_tile=row_tile, col_tile=col_tile, dtype=dtype,
        fetch_knn=False, mesh=mesh, trace=trace, knn_backend=knn_backend, index=index,
    )
    return core


def shard_forest_core_distances(*args, **kwargs):
    """The row-sharded rp-forest build and panel exchange."""
    raise NotImplementedError(
        "the mesh-sharded rp-forest (shard_forest_core_distances, "
        "fit_sharding=sharded with knn_index=rpforest) is not ported yet (ROADMAP A9)"
    )


class ShardBoruvkaScanner:
    """The sharded Borůvka scanner with per-round host contraction."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the sharded host-round Borůvka scanner (ShardBoruvkaScanner) is not "
            "ported yet (ROADMAP A3, A9)"
        )


def _reduce(parts, root, devices):
    """Elementwise minimum of per-shard partials on the first shard's
    device, handed back to every distinct device of the mesh."""
    out = None
    for p in parts:
        p = p.to(root)
        out = p if out is None else torch.minimum(out, p)
    return {dev: out.to(dev) for dev in devices}


def shard_boruvka_mst(
    data: np.ndarray,
    core: np.ndarray,
    metric: str = "euclidean",
    row_tile: int = 1024,
    col_tile: int = 8192,
    dtype=np.float32,
    mesh=None,
    max_rounds: int = 64,
    trace=None,
):
    """Every sharded Borůvka round over ``mesh`` (module docstring).

    Returns a dict shaped like ``core/mst_device.boruvka_mst_device``'s:
    "u", "v", "w" are lists of per-shard tensors, shard ``s`` holding
    positions ``[s * shard, (s + 1) * shard)`` of the (n - 1,) edge buffers
    on its device (concatenated in shard order they are the single-device
    buffers, +inf self-loops past the count); host values "count",
    "rounds", "round_syncs", "stat_comp", "stat_edges", "shard". ``trace``
    gets one ``mst_round`` event per round, marked ``sharded``.
    """
    from hdbscan_tpu_torch.core.mst_device import _collapse_labels, _seg_min_into
    from hdbscan_tpu_torch.ops.cuda_segmin import min_outgoing_panel

    n, d = np.shape(data)
    mesh = mesh if mesh is not None else get_mesh()
    n_dev = device_count(mesh)
    devs = mesh.devices
    root = mesh.root
    distinct = mesh.distinct()
    row_tile, col_tile, shard, _ = _ring_geometry(n, n_dev, row_tile, col_tile)
    form = euclidean_form(row_tile, col_tile, d) if metric == "euclidean" else None
    parts = _shard_rows(n, shard, n_dev)
    live = [s for s in range(n_dev) if parts[s][1] > 0]
    x = np.asarray(data, dtype)
    c = np.asarray(core, dtype)
    rows = [torch.as_tensor(x[o : o + m], device=devs[s]) for s, (o, m) in enumerate(parts)]
    cores = [torch.as_tensor(c[o : o + m], device=devs[s]) for s, (o, m) in enumerate(parts)]
    valid = [torch.ones(m, dtype=torch.bool, device=devs[s]) for s, (_, m) in enumerate(parts)]
    gid = [torch.arange(o, o + m, dtype=torch.int32, device=devs[s])
           for s, (o, m) in enumerate(parts)]

    buf = max(n - 1, 1)
    eu = torch.zeros(buf + 1, dtype=torch.int32, device=root)
    ev = torch.zeros(buf + 1, dtype=torch.int32, device=root)
    ew = torch.full((buf + 1,), float("inf"), dtype=rows[0].dtype, device=root)
    comp = torch.arange(n, dtype=torch.int32, device=root)
    valid_all = torch.ones(n, dtype=torch.bool, device=root)
    stat_comp = np.zeros(max_rounds, np.int32)
    stat_edges = np.zeros(max_rounds, np.int32)
    count = rounds = syncs = 0
    n_comp = n
    progress = True
    while rounds < max_rounds and n_comp > 1 and progress:
        comp_on = {dev: comp.to(dev) for dev in distinct}
        # 1. scan: each shard against the panels in ring order.
        st = {}
        for me in live:
            dev, (off_me, m) = devs[me], parts[me]
            labels = comp_on[dev]
            kr = labels[off_me : off_me + m]
            bw = torch.full((m,), float("inf"), dtype=rows[me].dtype, device=dev)
            bj = torch.full((m,), -1, dtype=torch.int32, device=dev)
            for step in range(n_dev):
                src = (me - step) % n_dev
                off, cnt = parts[src]
                if cnt == 0:
                    continue
                pw, pj = min_outgoing_panel(
                    rows[me], cores[me], kr, valid[me],
                    rows[src].to(dev), cores[src].to(dev), labels[off : off + cnt],
                    valid[src].to(dev), metric, row_tile, col_tile, form=form, col_offset=off,
                )
                tj = torch.where(pj >= 0, pj + off, 0)
                upd = (pw < bw) | ((pw == bw) & (tj < bj))
                bw = torch.where(upd, pw, bw)
                bj = torch.where(upd, tj, bj)
            bj_c = torch.clamp(bj, 0, n - 1)
            cross = valid[me] & (bj >= 0) & (kr != labels[bj_c.long()])
            st[me] = dict(
                dev=dev, bw=bw, bj_c=bj_c, cross=cross, lab=torch.where(cross, kr, n),
                kr_c=torch.clamp(kr, 0, n - 1), row=gid[me],
                lo=torch.minimum(gid[me], bj_c), hi=torch.maximum(gid[me], bj_c),
            )

        # 2. cross-shard reduction in the contraction's key order.
        def seg_min(key, fill, mask=None):
            """Per-shard scatter-min of ``key`` by label (rows outside
            ``mask`` dropped), reduced across shards."""
            return _reduce(
                [_seg_min_into(n, s["lab"] if mask is None else
                               torch.where(mask(s), s["lab"], n), s[key], fill)
                 for s in st.values()],
                root, distinct,
            )

        def at_label(red, s):
            return red[s["dev"]][s["kr_c"]]

        wmin = seg_min("bw", float("inf"))
        for s in st.values():
            s["tied"] = s["cross"] & (s["bw"] == at_label(wmin, s))
        for key in ("lo", "hi"):
            best = seg_min(key, _INT32_MAX, lambda s: s["tied"])
            for s in st.values():
                s["tied"] = s["tied"] & (s[key] == at_label(best, s))
        row_min = seg_min("row", _INT32_MAX, lambda s: s["tied"])
        bj_win = seg_min("bj_c", _INT32_MAX,
                         lambda s: s["tied"] & (s["row"] == at_label(row_min, s)))[root]

        # 3. contraction and emission on the first shard's device.
        row_min = row_min[root]
        has_edge = row_min < _INT32_MAX
        win_row = torch.where(has_edge, row_min, 0)
        bjw_c = torch.clamp(bj_win, 0, n - 1)
        emit_mask, rep, n_comp_t, added_t = _collapse_labels(
            comp, valid_all, has_edge, comp[bjw_c.long()], n
        )
        pos = count + torch.cumsum(emit_mask.to(torch.int32), 0) - 1
        slot = torch.where(emit_mask, pos, buf).to(torch.int64)
        eu[slot] = torch.clamp(win_row, 0, n - 1)
        ev[slot] = bjw_c
        ew[slot] = wmin[root]
        comp = rep[comp.long()]
        # The round's one device->host read: it drives the loop.
        n_comp, added = torch.stack([n_comp_t, added_t]).tolist()
        syncs += 1
        stat_comp[rounds] = n_comp
        stat_edges[rounds] = added
        count += added
        progress = added > 0
        if trace is not None:
            trace("mst_round", round=rounds, components=n_comp, edges_added=added,
                  sharded=True)
        rounds += 1

    def split(t):
        return [t[min(o, buf) : min(o + shard, buf)].to(devs[s])
                for s, (o, _) in enumerate(parts)]

    return {
        "u": split(eu), "v": split(ev), "w": split(ew),
        "count": count, "rounds": rounds, "round_syncs": syncs,
        "stat_comp": stat_comp, "stat_edges": stat_edges, "shard": shard,
    }
