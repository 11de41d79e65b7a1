"""Block-adjacency-aware windowed scans — the port of ``ops/blockscan.py``
(the sub-quadratic boundary phase of MR boundary mode).

A point's k-NN ball has a known radius bound (its per-block core
distance), so a block whose nearest possible member lies beyond it (by the
triangle inequality on f64 centroids and radii) cannot hold a neighbour.
The host computes candidate (row, block) pairs, coalesces them into
fixed-width column windows on a block-sorted device copy
(:class:`BlockGeometry`), flattens the work to row tiles that carry their
own window origin (:func:`_tiled_window_jobs`), and merges per-row results
on the device. Both scans keep the reference's schedule — jobs, tiles,
chunks, pad tiles writing to the dummy row m — because the tile guard's
grain decides which id wins an exact tie:

- :func:`knn_rows_blockpruned`: exact core distances (and neighbour lists)
  of selected rows. Every rescan chunk runs the B4 kernel
  (``ops/cuda_knn_window``). ``backend="fused"`` is the fused TPU kernel's
  contract (dot form, the priming bound gathered once per chunk);
  every other backend is the XLA chunk's (the tile-shape form, the bound
  re-gathered per tile job). The port has no XLA, so one kernel serves
  both.
- :func:`boruvka_glue_edges_blockpruned`: exact inter-block Borůvka glue
  whose window scans (``_min_out_window_merge_chunk``) run as plain
  PyTorch ops on the device, and whose dense fallback rounds run the
  segment-min kernel (``ops/tiled.BoruvkaScanner``), or under
  ``scan_backend=ring`` the ring scanner's panel kernel over a mesh.

Where the reference's tile loop is sequential (a row can sit in several
tiles of one chunk), the port runs tiles in *waves*: a tile's wave is one
past the last wave that touched any of its rows (the dummy row included),
so tiles of one wave share no row and every row sees its tiles in the
reference's order. The fused contract's merges need no waves: with its
bound fixed for the chunk, the dedup merge of a row's lists is a k-best of
their union, which any grouping reproduces.

Triangle-inequality metrics only (euclidean / manhattan / supremum).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from hdbscan_tpu_torch.core.distances import euclidean_form, pairwise_distance
from hdbscan_tpu_torch.ops.lexmerge import merge_sorted_dedup, merge_sorted_k, topk_lex

#: Metrics whose triangle inequality makes the centroid/radius bound valid.
PRUNABLE_METRICS = ("euclidean", "manhattan", "supremum")

#: Relative slack on every exclusion bound (device scans run in f32, the
#: bounds in f64: a candidate kept too generously costs columns, one
#: excluded wrongly costs exactness).
_BOUND_RTOL = 1e-4
_BOUND_ATOL = 1e-9

#: Fraction of available RAM the (m, G) centroid-distance cache may claim,
#: after a per-row reserve for the phase's later host temporaries.
_CACHE_RAM_FRACTION = 0.25
_CACHE_ROW_RESERVE_BYTES = 64


def _chunked_centroid_distances(
    rows: np.ndarray, centroids: np.ndarray, metric: str, chunk: int = 1 << 16
) -> np.ndarray:
    """(m, G) f64 row -> block-centroid distances on the host."""
    m, _ = rows.shape
    g = len(centroids)
    out = np.empty((m, g), np.float64)
    if metric == "euclidean":
        c2 = np.einsum("gd,gd->g", centroids, centroids)
        for lo in range(0, m, chunk):
            r = rows[lo : lo + chunk]
            d2 = np.einsum("md,md->m", r, r)[:, None] + c2[None, :] - 2.0 * (r @ centroids.T)
            np.sqrt(np.maximum(d2, 0.0), out=out[lo : lo + chunk])
        return out
    red = np.sum if metric == "manhattan" else np.max
    for lo in range(0, m, max(1, chunk // 8)):
        r = rows[lo : lo + max(1, chunk // 8)]
        out[lo : lo + len(r)] = red(np.abs(r[:, None, :] - centroids[None, :, :]), axis=2)
    return out


def _available_ram() -> int | None:
    """Free physical memory in bytes, or None where the OS does not say."""
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        return None


@dataclass
class BlockGeometry:
    """Block-sorted device copy of a dataset plus per-block f64 geometry.

    ``perm`` sorts rows by block; ``starts/ends`` are each block's span in
    sorted space; ``centroid/radius`` bound every member
    (``d(x, centroid) <= radius``); ``win_start`` is each block's
    column-window origin and ``win_tiles`` the shared window width in
    column tiles. ``data_sorted`` is (n_pad, d) float32 on the device (zero
    rows past n, masked by ``valid_sorted``).
    """

    metric: str
    col_tile: int
    n: int
    n_pad: int
    perm: np.ndarray
    inv_perm: np.ndarray
    block_ids: np.ndarray
    starts: np.ndarray
    ends: np.ndarray
    centroid: np.ndarray
    radius: np.ndarray
    win_start: np.ndarray
    win_tiles: int
    data_sorted: torch.Tensor
    valid_sorted: torch.Tensor
    data_host: np.ndarray

    @staticmethod
    def build(data: np.ndarray, block_of: np.ndarray, metric: str = "euclidean",
              col_tile: int = 8192, *, device=None) -> "BlockGeometry":
        if metric not in PRUNABLE_METRICS:
            raise ValueError(f"block pruning needs a triangle-inequality metric, got {metric!r}")
        from hdbscan_tpu_torch.core.distances import rowwise_distance_np

        data = np.ascontiguousarray(np.asarray(data, np.float64))
        n = len(data)
        block_of = np.asarray(block_of)
        perm = np.argsort(block_of, kind="stable")
        inv_perm = np.empty(n, np.int64)
        inv_perm[perm] = np.arange(n)
        uniq, first = np.unique(block_of[perm], return_index=True)
        starts = first
        ends = np.concatenate([first[1:], [n]])
        g = len(uniq)
        d = data.shape[1]
        centroid = np.empty((g, d), np.float64)
        radius = np.empty(g, np.float64)
        data_s = data[perm]
        for i in range(g):
            seg = data_s[starts[i] : ends[i]]
            c = seg.mean(axis=0)
            centroid[i] = c
            radius[i] = rowwise_distance_np(seg, np.broadcast_to(c, seg.shape), metric).max()

        col_tile = 1 << max(7, (min(col_tile, max(n, 128)) - 1).bit_length())
        n_pad = -(-n // col_tile) * col_tile
        n_tiles = n_pad // col_tile
        span_tiles = (ends - 1) // col_tile - starts // col_tile + 1
        win_tiles = min(n_tiles, 1 << int(span_tiles.max() - 1).bit_length())
        win_start = np.minimum(starts // col_tile, n_tiles - win_tiles) * col_tile
        win_start = np.maximum(win_start, 0)

        from hdbscan_tpu_torch.ops.cuda_build import resolve_device

        device = resolve_device(device)
        padded = np.zeros((n_pad, d), np.float32)
        padded[:n] = data_s
        return BlockGeometry(
            metric=metric, col_tile=col_tile, n=n, n_pad=n_pad, perm=perm,
            inv_perm=inv_perm, block_ids=uniq, starts=starts, ends=ends,
            centroid=centroid, radius=radius, win_start=win_start, win_tiles=win_tiles,
            data_sorted=torch.as_tensor(padded, device=device),
            valid_sorted=torch.arange(n_pad, device=device) < n,
            data_host=data,
        )

    @property
    def device(self) -> torch.device:
        return self.data_sorted.device

    def candidate_pairs(self, rows, ub, chunk: int = 1 << 16, exclude=None, dc_rows=None):
        """(row_idx, block_idx) pairs whose block can intersect the row's
        ball (``d(row, c_B) - r_B <= ub`` with f64 slack), minus the
        ``exclude`` (m, P) blocks already probed; ``dc_rows`` a cached
        (m, G) centroid-distance matrix (f32: distance-proportional slack)."""
        dc_rtol = 1e-6 if dc_rows is not None and dc_rows.dtype != np.float64 else 0.0
        prs, pbs = [], []
        for lo in range(0, len(rows), chunk):
            r = rows[lo : lo + chunk]
            if dc_rows is not None:
                dc = dc_rows[lo : lo + len(r)]
            else:
                dc = _chunked_centroid_distances(r, self.centroid, self.metric)
            keep = (
                dc * (1 - dc_rtol) - self.radius[None, :]
                <= ub[lo : lo + chunk, None] * (1 + _BOUND_RTOL) + _BOUND_ATOL
            )
            pr, pb = np.nonzero(keep)
            if exclude is not None:
                probed = (exclude[lo + pr] == pb[:, None]).any(axis=1)
                pr, pb = pr[~probed], pb[~probed]
            prs.append(pr + lo)
            pbs.append(pb)
        return np.concatenate(prs), np.concatenate(pbs)

    def centroid_distance_cache(self, rows: np.ndarray) -> np.ndarray | None:
        """(m, G) f32 centroid-distance cache, or None past the RAM budget
        (``_CACHE_RAM_FRACTION`` of free memory after an m-proportional
        reserve; 1 GiB when the OS does not report it)."""
        m, g = len(rows), len(self.block_ids)
        budget = 1 << 30
        avail = _available_ram()
        if avail is not None:
            free = max(avail - m * _CACHE_ROW_RESERVE_BYTES, 0)
            budget = max(min(budget, free), int(free * _CACHE_RAM_FRACTION))
        if m * g * 4 > budget:
            return None
        out = np.empty((m, g), np.float32)
        chunk = 1 << 16
        for lo in range(0, m, chunk):
            out[lo : lo + chunk] = _chunked_centroid_distances(
                rows[lo : lo + chunk], self.centroid, self.metric
            )
        return out

    def block_of_rows(self, row_ids: np.ndarray) -> np.ndarray:
        """(m,) dense block index of each row (by sorted-space span)."""
        return np.searchsorted(self.starts, self.inv_perm[row_ids], side="right") - 1

    def probe_pairs(self, rows, n_probe: int, chunk: int = 1 << 16, dc_rows=None,
                    self_blocks=None):
        """Each row's ``n_probe`` nearest blocks by centroid lower bound
        (the own block forced in when ``self_blocks`` is given). Returns
        (pair_rows, pair_blocks, probe (m, n_probe))."""
        p = min(n_probe, len(self.block_ids))
        probes = np.empty((len(rows), p), np.int64)
        for lo in range(0, len(rows), chunk):
            r = rows[lo : lo + chunk]
            if dc_rows is not None:
                dc = dc_rows[lo : lo + len(r)]
            else:
                dc = _chunked_centroid_distances(r, self.centroid, self.metric)
            lb = dc - self.radius[None, :]
            if self_blocks is not None:
                np.put_along_axis(lb, self_blocks[lo : lo + len(r), None], -np.inf, axis=1)
            probes[lo : lo + len(r)] = np.argpartition(lb, p - 1, axis=1)[:, :p]
        return np.repeat(np.arange(len(rows)), p), probes.reshape(-1), probes


def _window_jobs(geom: BlockGeometry, pair_rows: np.ndarray, pair_blocks: np.ndarray):
    """Candidate pairs coalesced into [(col_start, unique row indices)],
    one job per window, sorted by window."""
    if len(pair_rows) == 0:
        return []
    ws = geom.win_start[pair_blocks]
    order = np.lexsort((pair_rows, ws))
    ws, rs = ws[order], pair_rows[order]
    cuts = np.nonzero(np.diff(ws))[0] + 1
    return [(int(seg_w[0]), np.unique(seg_r))
            for seg_r, seg_w in zip(np.split(rs, cuts), np.split(ws, cuts))]


#: Per-chunk row-slot budget of the window scans.
_BATCH_SLOT_BUDGET = 1 << 21

#: Minimum chunk length (tiles): shorter tails are padded with dummy tiles.
_MIN_CHUNK_TILES = 64


def _tiled_window_jobs(jobs, to_sorted_pos, row_tile: int, *, dummy: int, slot_budget=None):
    """Flatten window jobs to row-tile granularity, in descending pow2
    chunks of at least ``_MIN_CHUNK_TILES`` tiles (pad tiles scan the
    dummy row ``dummy``). Yields (metas, ids (T, row_tile) int32 sorted
    positions, col_starts (T,), locs (T, row_tile) int32 local row ids,
    n_real) lazily, one chunk at a time; a job crossing a chunk boundary
    is split across yields."""
    metas = []
    t_total = 0
    for col_start, ridx in jobs:
        t = -(-len(ridx) // row_tile)
        metas.append((col_start, ridx, t_total, t))
        t_total += t
    max_chunk = max(1, (slot_budget or _BATCH_SLOT_BUDGET) // row_tile)
    min_chunk = min(_MIN_CHUNK_TILES, max_chunk)
    lo = 0
    mi = 0
    while lo < t_total:
        rem = t_total - lo
        take = min(max_chunk, max(min_chunk, 1 << (rem - 1).bit_length()))
        n_real = min(take, rem)
        ids = np.zeros((take, row_tile), np.int32)
        locs = np.full((take, row_tile), dummy, np.int32)
        starts = np.zeros(take, np.int32)
        chunk_metas = []
        while mi < len(metas):
            col_start, ridx, t_lo, t_n = metas[mi]
            if t_lo >= lo + n_real:
                break
            a = max(t_lo, lo)
            b = min(t_lo + t_n, lo + n_real)
            row_a = (a - t_lo) * row_tile
            row_b = min((b - t_lo) * row_tile, len(ridx))
            if row_b > row_a:
                seg = to_sorted_pos(ridx[row_a:row_b])
                flat = ids[a - lo : b - lo].reshape(-1)
                flat[: len(seg)] = seg
                lflat = locs[a - lo : b - lo].reshape(-1)
                lflat[: len(seg)] = ridx[row_a:row_b]
                starts[a - lo : b - lo] = col_start
                chunk_metas.append((ridx[row_a:row_b], a - lo, b - a))
            if t_lo + t_n <= lo + n_real:
                mi += 1
            else:
                break
        yield chunk_metas, ids, starts, locs, n_real
        lo += n_real


def _prestage_chunks(chunks, stage_fn):
    """Stage chunk t+1's device operands (``stage_fn(ids, starts, locs,
    n_real)``) before chunk t is dispatched; yields (metas, staged, n_slots,
    n_real)."""
    prev = None
    for metas, ids, starts, locs, n_real in chunks:
        item = (metas, stage_fn(ids, starts, locs, n_real), ids.shape[0], n_real)
        if prev is not None:
            yield prev
        prev = item
    if prev is not None:
        yield prev


def _tile_waves(locs: np.ndarray, n_real: int) -> list[np.ndarray]:
    """The chunk's tiles in waves: a real tile's wave is one past the last
    wave holding any of its rows, so no two tiles of a wave share a row and
    each row meets its tiles in chunk order. The whole pad tiles past
    ``n_real`` (dummy row only) follow one per wave."""
    last = np.full(int(locs.max()) + 1, -1, np.int64)
    level = np.empty(n_real, np.int64)
    for t in range(n_real):
        lv = int(last[locs[t]].max()) + 1
        level[t] = lv
        last[locs[t]] = lv
    order = np.argsort(level, kind="stable")
    cuts = np.nonzero(np.diff(level[order]))[0] + 1
    return np.split(order, cuts) + [np.array([t]) for t in range(n_real, len(locs))]


def _run_waves(waves, n_real: int, step, dummy_state) -> None:
    """Run ``step(wave)`` over the waves in order. The whole pad tiles at
    the end scan one window for the dummy row alone: once one of them
    leaves the dummy's state (``dummy_state()``) unchanged, every later one
    sees the same inputs and changes nothing, so the rest are skipped."""
    for wave in waves:
        if wave[0] < n_real:
            step(wave)
            continue
        before = dummy_state()
        step(wave)
        if all(torch.equal(a, b) for a, b in zip(before, dummy_state())):
            break


#: Synchronise the device every N chunks (bounds the queue of enqueued work).
_MERGE_SYNC_EVERY = 8

#: Row-slot cap per fused window chunk.
_FUSED_SLOT_BUDGET = 1 << 19


def _merge_rows(best_d, best_i, locs, nd, ni, k: int) -> None:
    """Fold every slot's list (``nd``/``ni`` (S, k), row ``locs`` (S,))
    into the (m + 1, k) buffers with one dedup merge per row (windows
    overlap, so a column can reach a row twice and must not take two
    slots). A row's lists are padded with empty lists to the largest
    occurrence count and merged at once: the k-best of their union equals
    the sequential merges."""
    rows, inv, counts = torch.unique(locs, return_inverse=True, return_counts=True)
    occ = int(counts.max())
    order = torch.argsort(inv, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(inv)
    rank[order] = torch.arange(len(inv), device=inv.device) - starts[inv[order]]
    wide_d = torch.full((len(rows), occ, k), float("inf"), dtype=nd.dtype, device=nd.device)
    wide_i = torch.full((len(rows), occ, k), -1, dtype=ni.dtype, device=nd.device)
    wide_d[inv, rank] = nd
    wide_i[inv, rank] = ni
    md, mi = merge_sorted_dedup(
        best_d[rows], best_i[rows], wide_d.reshape(len(rows), -1),
        wide_i.reshape(len(rows), -1), k,
    )
    best_d[rows] = md
    best_i[rows] = mi


def _knn_window_merge_chunk(best_d, best_i, ids, locs, waves, n_real: int, data, n: int,
                            start_tiles, k: int, metric: str, form, col_tile: int,
                            n_win_tiles: int):
    """The XLA chunk's contract: scan every row tile's window with the
    bound re-gathered per tile job (after the tiles before it merged), and
    dedup-merge into the (m + 1, k) buffers in place. ``waves``: the
    chunk's tile waves (:func:`_tile_waves`), run in order."""
    from hdbscan_tpu_torch.ops.cuda_knn_window import knn_window

    dummy = best_d.shape[0] - 1

    def step(wave):
        w = torch.as_tensor(wave, device=ids.device)
        loc = locs[w]
        bnd = best_d[:, k - 1][loc]
        nd, ni = knn_window(data, n, ids[w], start_tiles[w], bnd, k, col_tile,
                            n_win_tiles, metric, form)
        loc = loc.reshape(-1)
        md, mi = merge_sorted_dedup(best_d[loc], best_i[loc], nd.reshape(-1, k),
                                   ni.reshape(-1, k), k)
        best_d[loc] = md
        best_i[loc] = mi

    _run_waves(waves, n_real, step, lambda: (best_d[dummy].clone(), best_i[dummy].clone()))


def _knn_window_merge_chunk_fused(best_d, best_i, ids, locs, n_real: int, data, n: int,
                                  start_tiles, k: int, col_tile: int, n_win_tiles: int):
    """The fused kernel's contract (euclidean, dot form): the bound
    gathered once per chunk, one kernel launch, then the dedup merges.

    The chunk's whole pad tiles (past ``n_real``) scan one window for one
    row under one bound, so they give identical lists whose repeated merge
    is idempotent: one of them is scanned and merged. A tile's pad slots
    likewise repeat one list; the dummy row merges one list per tile."""
    from hdbscan_tpu_torch.ops.cuda_knn_window import knn_window

    dummy = best_d.shape[0] - 1
    t_used = min(len(ids), n_real + 1)
    ids, locs, start_tiles = ids[:t_used], locs[:t_used], start_tiles[:t_used]
    bnd = best_d[:, k - 1][locs]
    nd, ni = knn_window(data, n, ids, start_tiles, bnd, k, col_tile, n_win_tiles,
                        "euclidean", "dot")
    real = locs != dummy
    _merge_rows(best_d, best_i, locs[real], nd[real], ni[real], k)
    pad = ~real
    has_pad = pad.any(dim=1)
    if bool(has_pad.any()):
        first = torch.argmax(pad.to(torch.int32), dim=1)
        t_pad = torch.nonzero(has_pad)[:, 0]
        lists_d = nd[t_pad, first[t_pad]].reshape(1, -1)
        lists_i = ni[t_pad, first[t_pad]].reshape(1, -1)
        md, mi = merge_sorted_dedup(best_d[dummy:], best_i[dummy:], lists_d, lists_i, k)
        best_d[dummy:] = md
        best_i[dummy:] = mi


#: Foreign candidate edges retained per row across glue rounds.
_CAND_F = 8

#: Seam-probe rows per geometric-bound component and round.
_SEAM_PROBE_ROWS = 8

#: Glue window scan: tiles per step so one (tiles, row_tile, col_tile)
#: weight block stays under this many elements.
_GLUE_BLOCK_ELEMS = 1 << 26


def _min_out_window_merge_chunk(cand_w, cand_i, ids, locs, waves, n_real: int, data, core,
                                comp_sorted, comp_local, valid, col_starts, f: int,
                                metric: str, col_tile: int, n_win_tiles: int) -> None:
    """Scan a chunk of row tiles for their top-``f`` foreign MRD edges and
    merge them into the (m + 1, f) candidate buffers in place (plain
    PyTorch ops; the reference's XLA chunk of the same name).

    Per tile job, in order (waves): the row's stored candidates whose
    target has since joined its component go stale (+inf), the bound is
    the worst remaining one, each window column tile merges (top-f plus a
    stable 2f merge) only where some row of the tile has an edge strictly
    below min(its running f-th, bound), and the tile's lists dedup-merge
    into the buffers."""
    rt = ids.shape[1]
    d = data.shape[1]
    form = euclidean_form(rt, col_tile, d)
    dev = data.device
    inf = torch.tensor(float("inf"), dtype=data.dtype, device=dev)
    ar = torch.arange(col_tile, device=dev)
    group = max(1, _GLUE_BLOCK_ELEMS // (rt * col_tile))
    dummy = cand_w.shape[0] - 1

    def step(wave):
        for g0 in range(0, len(wave), group):
            w_idx = torch.as_tensor(wave[g0 : g0 + group], device=dev)
            loc = locs[w_idx]
            cur_w = cand_w[loc]
            cur_i = cand_i[loc]
            row_comp = comp_local[loc]
            tgt_comp = comp_sorted[torch.clamp(cur_i, min=0).long()]
            stale = (cur_i >= 0) & (tgt_comp == row_comp[..., None])
            cur_w = torch.where(stale, inf, cur_w)
            bnd = torch.amax(cur_w, dim=-1)

            tids = ids[w_idx].long()
            x, c, kk = data[tids], core[tids], comp_sorted[tids]
            bw = torch.full(cur_w.shape, float("inf"), dtype=data.dtype, device=dev)
            bi = torch.full(cur_i.shape, -1, dtype=torch.int32, device=dev)
            for j in range(n_win_tiles):
                base = col_starts[w_idx].long() + j * col_tile
                cols = base[:, None] + ar
                dmat = pairwise_distance(x, data[cols], metric, form)
                wt = torch.maximum(dmat, torch.maximum(c[..., None], core[cols][:, None, :]))
                out = (kk[..., None] != comp_sorted[cols][:, None, :]) & valid[cols][:, None, :]
                wt = torch.where(out, wt, inf)
                bound = torch.minimum(bw[..., f - 1], bnd)
                guard = (wt < bound[..., None]).flatten(1).any(dim=1)
                nv, npos = topk_lex(wt, f)
                ni = (npos + base[:, None, None]).to(torch.int32)
                mw, mi = merge_sorted_k(bw, bi, nv, ni, f)
                bw = torch.where(guard[:, None, None], mw, bw)
                bi = torch.where(guard[:, None, None], mi, bi)
            mw, mi = merge_sorted_dedup(cur_w, cur_i, bw, bi, f)
            cand_w[loc] = mw
            cand_i[loc] = mi

    _run_waves(waves, n_real, step, lambda: (cand_w[dummy].clone(), cand_i[dummy].clone()))


def _cand_best(cand_w, cand_i, comp_local, comp_sorted):
    """Per-row best still-foreign candidate: ((m+1,) w, (m+1,) sorted id),
    (inf, -1) where every candidate went stale or none was scanned."""
    tgt = comp_sorted[torch.clamp(cand_i, min=0).long()]
    ok = (cand_i >= 0) & (tgt != comp_local[:, None])
    w = torch.where(ok, cand_w, torch.tensor(float("inf"), dtype=cand_w.dtype, device=cand_w.device))
    a = torch.argmin(w, dim=1, keepdim=True)
    bw = torch.gather(w, 1, a)[:, 0]
    bi = torch.gather(cand_i, 1, a)[:, 0]
    return bw, torch.where(torch.isfinite(bw), bi, -1)


def _cand_comp_min(cand_w, cand_i, comp_local, comp_sorted, n_seg: int):
    """Per-component minimum of still-foreign candidate weights, (n_seg + 1,)
    (slot n_seg takes the pad dummy)."""
    bw, _ = _cand_best(cand_w, cand_i, comp_local, comp_sorted)
    seg = torch.where(comp_local >= 0, comp_local, n_seg).long()
    out = torch.full((n_seg + 1,), float("inf"), dtype=bw.dtype, device=bw.device)
    return out.scatter_reduce_(0, seg, bw, "amin", include_self=True)


#: Blocks probed per row in the first phase of the two-phase rescan.
_KNN_PROBE_BLOCKS = 2


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def knn_rows_blockpruned(
    geom: BlockGeometry,
    row_ids: np.ndarray,
    ub: np.ndarray,
    min_pts: int,
    return_neighbors: bool = False,
    row_tile: int = 512,
    neighbor_rows: np.ndarray | None = None,
    probe_blocks: int = _KNN_PROBE_BLOCKS,
    backend: str = "xla",
    trace=None,
    index: str = "exact",
    index_opts: dict | None = None,
):
    """Exact core distances of selected rows via block-candidate windows.

    ``ub`` (each row's per-block core distance) bounds its k-NN ball;
    blocks outside it are excluded by f64 geometry and the surviving
    windows are scanned exactly by the B4 kernel, the per-row results
    merging on the device. Two phases when ``probe_blocks`` > 0: each row's
    nearest blocks first (their k-th tightens the bound), then the
    remaining candidate windows. Returns ``core`` (m,); with
    ``neighbor_rows`` (local indices) or ``return_neighbors`` also those
    rows' (r, k) ascending neighbour distances and GLOBAL ids.

    ``backend="fused"`` (euclidean, k <= 128, d <= 128) takes the fused
    kernel's contract, any other the XLA chunk's (see the module
    docstring). ``trace`` gets one ``knn_probe_scan`` / ``knn_window_scan``
    event per phase. ``index="rpforest"`` slices the rows out of one forest
    pass over the whole dataset instead (``ops/rpforest``).
    """
    m = len(row_ids)
    k = max(min_pts - 1, 1)
    dev = geom.device
    if return_neighbors and neighbor_rows is None:
        neighbor_rows = np.arange(m)
    if m == 0:
        empty = np.zeros(0, np.float64)
        if neighbor_rows is not None:
            return empty, np.zeros((0, k)), np.zeros((0, k), np.int64)
        return empty
    if index == "rpforest":
        from hdbscan_tpu_torch.ops.rpforest import rpforest_core_distances

        core_all, knn_all, idx_all = rpforest_core_distances(
            geom.data_host, min_pts, geom.metric, return_indices=True,
            trace=trace, device=dev, **(index_opts or {}),
        )
        core = core_all[row_ids]
        if neighbor_rows is not None:
            sel = np.asarray(row_ids)[np.asarray(neighbor_rows)]
            return core, knn_all[sel][:, :k], idx_all[sel][:, :k]
        return core
    if index != "exact":
        raise ValueError(f"unknown index {index!r}: exact | rpforest")
    rows = geom.data_host[row_ids]
    rows_sorted_pos = np.asarray(geom.inv_perm[row_ids], np.int32)
    best_d = torch.full((m + 1, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((m + 1, k), -1, dtype=torch.int32, device=dev)
    from hdbscan_tpu_torch.utils.flops import counter as _flops
    from hdbscan_tpu_torch.utils.flops import phase_stats as _phase_stats

    d = geom.data_host.shape[1]
    win_cols = geom.win_tiles * geom.col_tile
    use_fused = backend == "fused" and geom.metric == "euclidean" and k <= 128 and d <= 128
    form = "dot" if use_fused else (
        euclidean_form(row_tile, geom.col_tile, d) if geom.metric == "euclidean" else None
    )

    def stage(ids, starts, locs, n_real):
        waves = None if use_fused else _tile_waves(locs, n_real)
        return (torch.as_tensor(ids, device=dev),
                torch.as_tensor(locs.astype(np.int64), device=dev),
                torch.as_tensor(starts // geom.col_tile, device=dev), waves)

    def scan_jobs(jobs, stage_name):
        t0 = time.monotonic()
        fsnap = _flops.snapshot()
        n_chunks = n_tiles = n_pad_tiles = 0
        for _metas, staged, n_slots, n_real in _prestage_chunks(
            _tiled_window_jobs(
                jobs, lambda r: rows_sorted_pos[r], row_tile, dummy=m,
                slot_budget=_FUSED_SLOT_BUDGET if use_fused else None,
            ),
            stage,
        ):
            ids_d, locs_d, starts_d, waves = staged
            _flops.add_scan(n_real * row_tile, win_cols, d, row_tile=row_tile)
            if n_slots > n_real:
                _flops.add_pad_scan((n_slots - n_real) * row_tile, win_cols, d)
            n_tiles += n_real
            n_pad_tiles += n_slots - n_real
            if use_fused:
                _knn_window_merge_chunk_fused(
                    best_d, best_i, ids_d, locs_d, n_real, geom.data_sorted, geom.n,
                    starts_d, k, geom.col_tile, geom.win_tiles,
                )
            else:
                _knn_window_merge_chunk(
                    best_d, best_i, ids_d, locs_d, waves, n_real, geom.data_sorted, geom.n,
                    starts_d, k, geom.metric, form, geom.col_tile, geom.win_tiles,
                )
            n_chunks += 1
            if n_chunks % _MERGE_SYNC_EVERY == 0:
                _sync(dev)
        if trace is not None and n_chunks:
            _sync(dev)
            wall = time.monotonic() - t0
            trace(
                stage_name, rows=m, chunks=n_chunks, tiles=n_tiles, pad_tiles=n_pad_tiles,
                row_tile=row_tile, fused=use_fused, double_buffered=True,
                wall_s=round(wall, 6), **_phase_stats(fsnap, wall),
            )

    ub = np.asarray(ub, np.float64)
    probe = dc_cache = None
    if probe_blocks > 0 and len(geom.block_ids) > probe_blocks:
        dc_cache = geom.centroid_distance_cache(rows)
        ppr, ppb, probe = geom.probe_pairs(
            rows, probe_blocks, dc_rows=dc_cache, self_blocks=geom.block_of_rows(row_ids)
        )
        scan_jobs(_window_jobs(geom, ppr, ppb), "knn_probe_scan")
        kth_idx = min(k, geom.n) - 1
        probe_kth = best_d[:m, kth_idx].cpu().numpy().astype(np.float64)
        ub = np.where(np.isfinite(probe_kth), np.minimum(ub, probe_kth), ub)
    pair_rows, pair_blocks = geom.candidate_pairs(rows, ub, exclude=probe, dc_rows=dc_cache)
    scan_jobs(_window_jobs(geom, pair_rows, pair_blocks), "knn_window_scan")

    if min_pts > 1:
        core = best_d[:m, min(k, geom.n) - 1].cpu().numpy().astype(np.float64)
    else:
        core = np.zeros(m)
    if neighbor_rows is not None:
        nbr = torch.as_tensor(np.asarray(neighbor_rows, np.int64), device=dev)
        gd = best_d[nbr].cpu().numpy().astype(np.float64)
        gi = best_i[nbr].cpu().numpy().astype(np.int64)
        ids_g = np.where(gi >= 0, geom.perm[np.maximum(gi, 0)], -1)
        return core, gd, ids_g
    return core


def _segment_min(values: np.ndarray, segments: np.ndarray, n_seg: int) -> np.ndarray:
    out = np.full(n_seg, np.inf)
    np.minimum.at(out, segments, values)
    return out


def boruvka_glue_edges_blockpruned(
    data: np.ndarray,
    groups: np.ndarray,
    core: np.ndarray,
    metric: str = "euclidean",
    knn_d: np.ndarray | None = None,
    knn_j: np.ndarray | None = None,
    col_tile: int = 8192,
    row_tile: int = 512,
    max_rounds: int = 64,
    dense_work_ratio: float = 0.7,
    init_comp: np.ndarray | None = None,
    geom: BlockGeometry | None = None,
    trace=None,
    scan_backend: str = "host",
    *,
    device=None,
    mesh=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact inter-group MST glue with block-candidate column windows (the
    semantics of ``ops/tiled.boruvka_glue_edges`` at a fraction of the
    pairs). Per Borůvka round and component: an achievable upper bound on
    its min outgoing weight (k-NN-graph edges ``knn_d``/``knn_j`` with ids
    local to ``data``, retained window candidates, the geometric backstop,
    a seam probe where the bound is still geometric), the (row, block)
    pairs whose lower bound could beat it, their window scans, and the
    shared contraction (``utils/unionfind.contract_min_edges``). A round
    whose windowed work would pass ``dense_work_ratio`` of a dense scan runs
    the dense segment-min scan instead. ``init_comp`` decouples the initial
    components from the geometry blocks; ``geom`` is a pre-built
    :class:`BlockGeometry` over (``data``, ``groups``), whose device the
    scans run on (``device`` when none is given). A dense round takes
    ``parallel/ring.RingBoruvkaScanner`` over ``mesh`` where
    ``scan_backend`` resolves "ring" (``ops/tiled.scan_mesh``), else
    ``ops/tiled.BoruvkaScanner`` on that device."""
    from hdbscan_tpu_torch.utils.unionfind import contract_min_edges

    m = len(data)
    if m == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0)
    core = np.asarray(core, np.float64)
    if geom is None:
        geom = BlockGeometry.build(data, groups, metric, col_tile=col_tile, device=device)
    dev = geom.device
    g = len(geom.block_ids)
    if g <= 1:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0)

    core_pad = np.zeros(geom.n_pad, np.float32)
    core_pad[:m] = core[geom.perm]
    core_sorted = torch.as_tensor(core_pad, device=dev)
    rows_all = geom.data_host
    maxcore_b = np.full(g, -np.inf)
    mincore_b = np.full(g, np.inf)
    np.maximum.at(maxcore_b, np.searchsorted(geom.block_ids, groups), core)
    np.minimum.at(mincore_b, np.searchsorted(geom.block_ids, groups), core)
    dense_block = np.searchsorted(geom.block_ids, groups)

    order0 = np.argsort(dense_block, kind="stable")
    firsts = np.concatenate([[True], np.diff(dense_block[order0]) != 0])
    if init_comp is None:
        comp = order0[firsts][dense_block]
    else:
        comp = np.asarray(init_comp, np.int64).copy()
        if len(np.unique(comp)) <= 1:
            return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0)

    if knn_j is not None:
        knn_j = np.asarray(knn_j, np.int64)
        knn_d = np.asarray(knn_d, np.float64)
        knn_w = np.maximum(knn_d, np.maximum(core[:, None], core[np.maximum(knn_j, 0)]))
        knn_w = np.where(knn_j >= 0, knn_w, np.inf)

    eu, ev, ew = [], [], []
    slack = lambda x: x * (1 + _BOUND_RTOL) + _BOUND_ATOL  # noqa: E731
    dense_scanner = None
    n_comp = len(np.unique(comp))
    chunk = max(1, (256 << 20) // (8 * g))
    dc_cache = geom.centroid_distance_cache(rows_all)
    # f32 rounding of cached centroid distances is absolute error ~6e-8 dc:
    # widen the bounds by a distance-proportional slack wherever they enter.
    _dc_rtol = 1e-6 if dc_cache is not None else 0.0

    def _dc(sl: slice) -> np.ndarray:
        if dc_cache is not None:
            return dc_cache[sl]
        return _chunked_centroid_distances(rows_all[sl], geom.centroid, metric)

    cand_w = cand_i = None
    for rnd in range(max_rounds):
        if n_comp <= 1:
            break
        t_rnd = time.monotonic()
        _, cidx = np.unique(comp, return_inverse=True)
        ncomp_dense = cidx.max() + 1
        cs = cidx[geom.perm]
        bmin = np.minimum.reduceat(cs, geom.starts)
        bmax = np.maximum.reduceat(cs, geom.starts)
        block_comp = np.where(bmin == bmax, bmin, -2)
        comp_pad = np.full(geom.n_pad, -3, np.int32)
        comp_pad[:m] = cs
        comp_local_np = np.full(m + 1, -9, np.int32)
        comp_local_np[:m] = cidx
        comp_dev_cache = []

        def _comp_dev():
            if not comp_dev_cache:
                comp_dev_cache.append(torch.as_tensor(comp_pad, device=dev))
                comp_dev_cache.append(torch.as_tensor(comp_local_np, device=dev))
            return comp_dev_cache[0], comp_dev_cache[1]

        # --- pass A: k-NN-graph candidates + per-component upper bounds
        bestA_w = np.full(m, np.inf)
        bestA_j = np.full(m, -1, np.int64)
        if knn_j is not None:
            foreign = (knn_j >= 0) & (cidx[np.maximum(knn_j, 0)] != cidx[:, None])
            wA = np.where(foreign, knn_w, np.inf)
            sel = np.argmin(wA, axis=1)
            bestA_w = np.take_along_axis(wA, sel[:, None], axis=1)[:, 0]
            bestA_j = np.where(
                np.isfinite(bestA_w), np.take_along_axis(knn_j, sel[:, None], axis=1)[:, 0], -1
            )
        upper = _segment_min(bestA_w, cidx, ncomp_dense)

        def cand_upper():
            n_seg_pad = 1 << max(0, (int(ncomp_dense) - 1).bit_length())
            comp_sorted, comp_local = _comp_dev()
            cu = _cand_comp_min(cand_w, cand_i, comp_local, comp_sorted, n_seg_pad)
            return cu.cpu().numpy().astype(np.float64)[:ncomp_dense]

        if cand_w is not None:
            upper = np.minimum(upper, cand_upper())

        # --- geometric backstop; records each row's best foreign block
        row_geo = np.full(m, np.inf)
        row_geo_b = np.full(m, -1, np.int64)
        for lo in range(0, m, chunk):
            r = slice(lo, lo + chunk)
            dcc = _dc(r)
            foreign_c = block_comp[None, :] != cidx[r, None]
            ub2 = np.maximum(
                dcc * (1 + _dc_rtol) + geom.radius[None, :],
                np.maximum(core[r, None], maxcore_b[None, :]),
            )
            ub2 = np.where(foreign_c, ub2, np.inf)
            rb = np.argmin(ub2, axis=1)
            rv = ub2[np.arange(len(rb)), rb]
            row_geo[r] = rv
            row_geo_b[r] = np.where(np.isfinite(rv), rb, -1)
            np.minimum.at(upper, cidx[r], rv)

        def scan_window_pairs(pr, pb):
            """Window-scan (row, block) pairs into the cross-round
            candidate buffers (seam probe and main windowed pass)."""
            nonlocal cand_w, cand_i
            jobs = _window_jobs(geom, pr, pb)
            comp_sorted, comp_local = _comp_dev()
            if cand_w is None:
                cand_w = torch.full((m + 1, _CAND_F), float("inf"), dtype=torch.float32,
                                    device=dev)
                cand_i = torch.full((m + 1, _CAND_F), -1, dtype=torch.int32, device=dev)
            from hdbscan_tpu_torch.utils.flops import counter as _flops

            win_cols = geom.win_tiles * geom.col_tile
            n_chunks = 0
            for _metas, staged, n_slots, n_real in _prestage_chunks(
                _tiled_window_jobs(jobs, lambda r: geom.inv_perm[r], row_tile, dummy=m),
                lambda ids, starts, locs, n_real: (
                    torch.as_tensor(ids, device=dev),
                    torch.as_tensor(locs.astype(np.int64), device=dev),
                    torch.as_tensor(starts, device=dev), _tile_waves(locs, n_real),
                ),
            ):
                idsc_d, locs_d, starts_d, waves = staged
                _flops.add_scan(n_real * row_tile, win_cols, data.shape[1], row_tile=row_tile)
                if n_slots > n_real:
                    _flops.add_pad_scan((n_slots - n_real) * row_tile, win_cols, data.shape[1])
                _min_out_window_merge_chunk(
                    cand_w, cand_i, idsc_d, locs_d, waves, n_real, geom.data_sorted, core_sorted,
                    comp_sorted, comp_local, geom.valid_sorted, starts_d, _CAND_F,
                    metric, geom.col_tile, geom.win_tiles,
                )
                n_chunks += 1
                if n_chunks % _MERGE_SYNC_EVERY == 0:
                    _sync(dev)

        # --- seam probe: components whose bound is still the geometric
        # backstop get their best seam rows scanned against their nearest
        # foreign block first.
        comp_geo = _segment_min(row_geo, cidx, ncomp_dense)
        geo_bound = upper >= comp_geo * (1 - 1e-12)
        if geo_bound.any() and g > 1:
            need = geo_bound[cidx] & (row_geo_b >= 0)
            rows_n = np.nonzero(need)[0]
            if len(rows_n):
                order_p = np.lexsort((row_geo[rows_n], cidx[rows_n]))
                rows_n = rows_n[order_p]
                cn = cidx[rows_n]
                first = np.concatenate([[True], np.diff(cn) != 0])
                starts_p = np.nonzero(first)[0]
                rank = np.arange(len(rows_n)) - np.repeat(
                    starts_p, np.diff(np.concatenate([starts_p, [len(rows_n)]]))
                )
                sel_p = rows_n[rank < _SEAM_PROBE_ROWS]
                scan_window_pairs(sel_p, row_geo_b[sel_p])
                upper = np.minimum(upper, cand_upper())

        pair_rows_l, pair_blocks_l = [], []
        for lo in range(0, m, chunk):
            r = slice(lo, lo + chunk)
            dcc = _dc(r)
            foreign_c = block_comp[None, :] != cidx[r, None]
            lb = np.maximum(
                dcc * (1 - _dc_rtol) - geom.radius[None, :],
                np.maximum(core[r, None], mincore_b[None, :]),
            )
            keep = foreign_c & (lb <= slack(upper[cidx[r]])[:, None])
            pr, pb = np.nonzero(keep)
            pair_rows_l.append(pr + lo)
            pair_blocks_l.append(pb)
        pair_rows = np.concatenate(pair_rows_l)
        pair_blocks = np.concatenate(pair_blocks_l)
        n_pairs = len(pair_rows)
        bestB_w = np.full(m, np.inf, np.float64)
        bestB_j = np.full(m, -1, np.int64)
        dense_round = False
        if n_pairs:
            win_work = n_pairs * geom.win_tiles * geom.col_tile
            dense_work = m * geom.n_pad
            if win_work > dense_work_ratio * dense_work:
                dense_round = True
                if dense_scanner is None:
                    from hdbscan_tpu_torch.parallel.ring import (
                        RingBoruvkaScanner,
                        resolve_scan_backend,
                    )

                    if resolve_scan_backend(scan_backend, mesh) == "ring":
                        from hdbscan_tpu_torch.ops.tiled import scan_mesh

                        dense_scanner = RingBoruvkaScanner(
                            data, core, metric, mesh=scan_mesh(mesh, dev), trace=trace)
                    else:
                        from hdbscan_tpu_torch.ops.tiled import BoruvkaScanner

                        dense_scanner = BoruvkaScanner(data, core, metric, device=dev)
                bestB_w, bestB_j = dense_scanner.min_outgoing(comp)
            else:
                scan_window_pairs(pair_rows, pair_blocks)
                comp_sorted, comp_local = _comp_dev()
                bw_c, bi_c = _cand_best(cand_w, cand_i, comp_local, comp_sorted)
                bestB_w = bw_c.cpu().numpy().astype(np.float64)[:m]
                bi_c = bi_c.cpu().numpy().astype(np.int64)[:m]
                bestB_j = np.where(bi_c >= 0, geom.perm[np.maximum(bi_c, 0)], -1)

        take_b = bestB_w < bestA_w
        best_w = np.where(take_b, bestB_w, bestA_w)
        best_j = np.where(take_b, bestB_j, bestA_j)
        if trace is not None:
            trace("glue_round", round=rnd, n_comp=int(n_comp), pairs=int(n_pairs),
                  pair_frac=round(n_pairs / (m * g), 5), dense=dense_round,
                  wall_s=round(time.monotonic() - t_rnd, 6))
        emit, comp, n_comp = contract_min_edges(comp, best_j, best_w)
        if len(emit) == 0:
            break
        eu.append(emit)
        ev.append(best_j[emit])
        ew.append(best_w[emit])
    if dense_scanner is not None and hasattr(dense_scanner, "close"):
        dense_scanner.close()
    return (
        np.concatenate(eu) if eu else np.zeros(0, np.int64),
        np.concatenate(ev) if ev else np.zeros(0, np.int64),
        np.concatenate(ew) if ew else np.zeros(0, np.float64),
    )
