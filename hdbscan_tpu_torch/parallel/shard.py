"""The sharded exact fit — the port of ``parallel/shard.py``'s exact tier:
ring core distances, the sharded device Borůvka rounds and the host-round
sharded scanner.

The reference runs every sharded Borůvka round inside one ``shard_map``
``while_loop`` (``_shard_mst_fn``). The port runs the same rounds as a host
loop over a single-process mesh (``parallel/mesh.Mesh``), one scalar read
per round driving it, as the single-device ``boruvka_mst_device`` does. A
round:

1. scan (:meth:`_Shards.scan`) — every shard ``me`` keeps its row shard,
   core distances and labels resident and scans the panels in ring order
   ``(me - s) % D`` through the panel segment-min kernel
   (``ops/cuda_segmin.min_outgoing_panel``, B9); a panel-local winner
   becomes global and enters under the explicit (w, j) lexicographic
   update, so the arrival order cannot change the winner;
2. reduction (:meth:`_Shards.winners`) — each shard's scatter-min partials
   over the label space are min-reduced across shards on the first
   shard's device, key by key: weight, then lo and hi over the rows still
   tied (the key of ``utils/unionfind.contract_min_edges`` and of
   ``core/mst_device._contract_round``, whose row and target follow from
   (lo, hi): the edge leaves the component from its in-component end);
3. contraction — ``core/mst_device._collapse_labels`` (the same
   pointer-doubling collapse) and the slot emission into edge buffers in
   ascending-label order with +inf self-loop padding, so the edges equal the
   single-device engine's slot for slot; the new labels go back to every
   shard's device.

:class:`ShardBoruvkaScanner` (``mst_backend=host`` under
``fit_sharding=sharded``) runs step 1 alone per round and hands the (n,)
per-point winners to the host contraction; ``parallel/ring.
RingBoruvkaScanner`` runs steps 1 and 2 over the dense component labels.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP
entry: the sharded rp-forest ``shard_forest_core_distances`` (A9). The
reference's partition-rule table is a JAX sharding device with no torch
counterpart: a shard's tensors lie on its device.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hdbscan_tpu_torch.core.distances import euclidean_form
from hdbscan_tpu_torch.parallel.mesh import device_count, fetch, get_mesh, spans_cards
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
    return "sharded" if spans_cards(mesh) else "replicated"


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


class _Shards:
    """The row shards of one Borůvka run over ``mesh``: each shard's points,
    core distances and global row ids on its device, and the per-round
    panel scan and per-component reduction that every sharded Borůvka engine
    shares (:class:`ShardBoruvkaScanner`, ``parallel/ring.
    RingBoruvkaScanner`` and :func:`shard_boruvka_mst`)."""

    def __init__(self, data, core, metric, row_tile, col_tile, dtype, mesh):
        self.n, self.d = np.shape(data)
        self.metric = metric
        self.mesh = mesh if mesh is not None else get_mesh()
        self.n_dev = device_count(self.mesh)
        self.devs = self.mesh.devices
        self.root = self.mesh.root
        self.distinct = self.mesh.distinct()
        self.row_tile, self.col_tile, self.shard, self.n_pad = _ring_geometry(
            self.n, self.n_dev, row_tile, col_tile
        )
        self.form = (euclidean_form(self.row_tile, self.col_tile, self.d)
                     if metric == "euclidean" else None)
        self.parts = _shard_rows(self.n, self.shard, self.n_dev)
        self.live = [s for s in range(self.n_dev) if self.parts[s][1] > 0]
        x = np.asarray(data, dtype)
        c = np.asarray(core, dtype)
        on = list(zip(self.parts, self.devs))
        self.rows = [torch.as_tensor(x[o : o + m], device=dev) for (o, m), dev in on]
        self.cores = [torch.as_tensor(c[o : o + m], device=dev) for (o, m), dev in on]
        self.valid = [torch.ones(m, dtype=torch.bool, device=dev) for (_, m), dev in on]
        self.gid = [torch.arange(o, o + m, dtype=torch.int32, device=dev) for (o, m), dev in on]

    def put_labels(self, labels) -> dict:
        """An (n,) int32 label vector (host array or tensor) on every
        distinct device of the mesh."""
        t = torch.as_tensor(labels)
        return {dev: t.to(dev) for dev in self.distinct}

    def scan(self, labels_on: dict) -> dict:
        """One round's panel scan: every shard ``me`` against the panels in
        ring order ``(me - s) % D`` through the panel segment-min kernel
        (B9), each panel-local winner made global and entered under the
        explicit (w, j) lexicographic update, so the arrival order cannot
        change it. Returns {shard: ((m,) best_w, (m,) int32 best_j)} with
        global column ids, (+inf, -1) where no outgoing edge exists."""
        from hdbscan_tpu_torch.ops.cuda_segmin import min_outgoing_panel

        out = {}
        for me in self.live:
            dev, (off_me, m) = self.devs[me], self.parts[me]
            labels = labels_on[dev]
            kr = labels[off_me : off_me + m]
            bw = torch.full((m,), float("inf"), dtype=self.rows[me].dtype, device=dev)
            bj = torch.full((m,), -1, dtype=torch.int32, device=dev)
            for step in range(self.n_dev):
                src = (me - step) % self.n_dev
                off, cnt = self.parts[src]
                if cnt == 0:
                    continue
                pw, pj = min_outgoing_panel(
                    self.rows[me], self.cores[me], kr, self.valid[me],
                    self.rows[src].to(dev), self.cores[src].to(dev), labels[off : off + cnt],
                    self.valid[src].to(dev), self.metric, self.row_tile, self.col_tile,
                    form=self.form, col_offset=off,
                )
                tj = torch.where(pj >= 0, pj + off, 0)
                upd = (pw < bw) | ((pw == bw) & (tj < bj))
                bw = torch.where(upd, pw, bw)
                bj = torch.where(upd, tj, bj)
            out[me] = (bw, bj)
        return out

    def winners(self, cands: dict, labels_on: dict, n_seg: int):
        """Per-component winners of one round's candidates: the minimum by
        the shared key (w, lo = min(i, j), hi = max(i, j)) of
        ``utils/unionfind.contract_min_edges``, each shard's scatter-min
        partials over the ``n_seg`` labels min-reduced across shards on the
        first shard's device, key by key. Returns (w, lo, hi) (n_seg,) on
        that device, (+inf, INT32_MAX, INT32_MAX) for a label without a
        candidate, and the number of candidates (a 0-d tensor)."""
        from hdbscan_tpu_torch.core.mst_device import _seg_min_into

        st = []
        for me, (bw, bj) in cands.items():
            dev, (off, m) = self.devs[me], self.parts[me]
            has = bj >= 0
            lab = torch.where(has, labels_on[dev][off : off + m], n_seg)
            bj_c = torch.where(has, bj, 0)
            st.append(dict(dev=dev, has=has, lab=lab, w=bw,
                           kr_c=torch.clamp(lab, 0, n_seg - 1),
                           lo=torch.minimum(self.gid[me], bj_c),
                           hi=torch.maximum(self.gid[me], bj_c)))

        def seg_min(key, fill):
            return _reduce([_seg_min_into(n_seg, s["lab"], s[key], fill) for s in st],
                           self.root, self.distinct)

        w = seg_min("w", float("inf"))
        for s in st:
            s["lab"] = torch.where(s["w"] == w[s["dev"]][s["kr_c"]], s["lab"], n_seg)
        lo = seg_min("lo", _INT32_MAX)
        for s in st:
            s["lab"] = torch.where(s["lo"] == lo[s["dev"]][s["kr_c"]], s["lab"], n_seg)
        hi = seg_min("hi", _INT32_MAX)
        n_cand = sum(s["has"].sum().to(self.root) for s in st)
        return w[self.root], lo[self.root], hi[self.root], n_cand

    def close(self) -> None:
        """Drop the shards' device tensors now."""
        self.rows = self.cores = self.valid = self.gid = []


class ShardBoruvkaScanner:
    """Fully row-sharded drop-in for ``ops/tiled.BoruvkaScanner`` (the
    reference's ``ShardBoruvkaScanner``): the same ``min_outgoing(comp) ->
    (best_w, best_j)`` contract and the same per-point arrays, but points,
    cores and labels live per shard on the mesh (``mesh=None``: every
    visible card) and each round is :meth:`_Shards.scan`, B9 per shard and
    visiting panel. The (n,) winners come back to the host contraction
    every round. ``trace`` gets one ``shard_boruvka_scan`` event per round
    (with per-shard ``ring_device_wall`` events)."""

    def __init__(self, data: np.ndarray, core: np.ndarray, metric: str = "euclidean",
                 row_tile: int = 1024, col_tile: int = 8192, dtype=np.float32,
                 mesh=None, trace=None):
        self._sh = _Shards(data, core, metric, row_tile, col_tile, dtype, mesh)
        self.n, self.d, self.n_dev = self._sh.n, self._sh.d, self._sh.n_dev
        self.trace = trace
        self._itemsize = np.dtype(dtype).itemsize
        self._round = 0
        self.walls = (0.0, 0.0)  # the last round's (scan s, fetch s)

    def close(self) -> None:
        """Release the scanner's device row shards now."""
        self._sh.close()

    def min_outgoing(self, comp: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Per-point (best_w float64, best_j int64): the minimum outgoing
        mutual-reachability edge of every point's component seen from that
        point, (w, j)-lex, (+inf, -1) where none."""
        from hdbscan_tpu_torch.parallel.ring import _emit_ring_trace, _per_device_walls
        from hdbscan_tpu_torch.utils.flops import counter as _flops

        sh = self._sh
        _flops.add_scan(sh.n_pad, sh.n_pad, self.d, row_tile=sh.row_tile)
        comp = np.asarray(comp)
        t_up = time.monotonic()
        labels_on = sh.put_labels(comp.astype(np.int32))
        t0 = time.monotonic()
        upload_s = t0 - t_up
        cands = sh.scan(labels_on)
        walls = _per_device_walls(sh.mesh, t0)
        wall = time.monotonic() - t0
        t_f = time.monotonic()
        bw = fetch([cands[s][0] for s in sh.live]).astype(np.float64)
        bj = fetch([cands[s][1] for s in sh.live]).astype(np.int64)
        fetch_s = time.monotonic() - t_f
        self.walls = (wall, fetch_s)
        # Two panels per hand-over: the row shard with its cores, and the
        # int32 component labels.
        comm_bytes = (self.n_dev - 1) * sh.shard * ((self.d + 1) * self._itemsize + 4)
        _emit_ring_trace(
            self.trace, "shard_boruvka_scan", wall, walls, self.n_dev, self._round,
            n_comp=int(len(np.unique(comp))), candidates=int(np.sum(bj >= 0)),
            upload_s=round(upload_s, 6), fetch_s=round(fetch_s, 6), comm_bytes=comm_bytes,
        )
        self._round += 1
        return bw, bj


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
    from hdbscan_tpu_torch.core.mst_device import _collapse_labels

    sh = _Shards(data, core, metric, row_tile, col_tile, dtype, mesh)
    n, root = sh.n, sh.root
    buf = max(n - 1, 1)
    eu = torch.zeros(buf + 1, dtype=torch.int32, device=root)
    ev = torch.zeros(buf + 1, dtype=torch.int32, device=root)
    ew = torch.full((buf + 1,), float("inf"), dtype=sh.rows[0].dtype, device=root)
    comp = torch.arange(n, dtype=torch.int32, device=root)
    label_ids = torch.arange(n, dtype=torch.int32, device=root)
    valid_all = torch.ones(n, dtype=torch.bool, device=root)
    stat_comp = np.zeros(max_rounds, np.int32)
    stat_edges = np.zeros(max_rounds, np.int32)
    count = rounds = syncs = 0
    n_comp = n
    progress = True
    while rounds < max_rounds and n_comp > 1 and progress:
        labels_on = sh.put_labels(comp)
        # 1. scan: each shard against the panels in ring order; 2. the
        # per-component (w, lo, hi) reduction across shards.
        w, lo, hi, _ = sh.winners(sh.scan(labels_on), labels_on, n)
        # 3. contraction and emission on the first shard's device: a
        # label's winning edge leaves from its in-component endpoint.
        has_edge = lo < _INT32_MAX
        lo_c, hi_c = torch.clamp(lo, 0, n - 1), torch.clamp(hi, 0, n - 1)
        win_row = torch.where(comp[lo_c.long()] == label_ids, lo_c, hi_c)
        win_j = lo_c + hi_c - win_row
        emit_mask, rep, n_comp_t, added_t = _collapse_labels(
            comp, valid_all, has_edge, comp[win_j.long()], n
        )
        pos = count + torch.cumsum(emit_mask.to(torch.int32), 0) - 1
        slot = torch.where(emit_mask, pos, buf).to(torch.int64)
        eu[slot] = win_row
        ev[slot] = win_j
        ew[slot] = w
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
        return [t[min(o, buf) : min(o + sh.shard, buf)].to(dev)
                for (o, _), dev in zip(sh.parts, sh.devs)]

    return {
        "u": split(eu), "v": split(ev), "w": split(ew),
        "count": count, "rounds": rounds, "round_syncs": syncs,
        "stat_comp": stat_comp, "stat_edges": stat_edges, "shard": sh.shard,
    }
