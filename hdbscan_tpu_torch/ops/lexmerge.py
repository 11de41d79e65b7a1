"""The (distance, id) lexicographic k-best — plain PyTorch.

The repo-wide neighbor-list order of the reference (``ops/lexmerge.py``):
ascending distance, ties broken by ascending global id. Two conventions for
empty slots coexist, kept apart exactly as the reference keeps them:

* **negative ids** (the exact-tier k-NN kernel, ``ops/cuda_knn``): empty
  slots are ``(+inf, -1)`` (:func:`lex_kbest`);
* **sentinel ids** (the rp-forest tier, ``ops/rpforest``,
  ``ops/cuda_forest``): empty or masked slots are ``(+inf, sentinel)`` with
  ``sentinel = n``, larger than every real id, so the lex order itself
  pushes them past every real candidate. Inside a candidate-panel
  reduction, a slot nothing filled carries :data:`ID_MAX`, which callers
  map back to their sentinel.

:func:`merge_tile_candidates` and :func:`topk_tile_candidates` are the
plain versions of the forest kernels' reductions (``csrc/forest_merge.cu``,
``csrc/forest_rescan.cu``); :func:`dedup_lex_merge` is the sort form of
the same contract that the unfused rp-forest path and the rescan merge use.
A lexsort is two stable ``torch.sort`` calls, the secondary key first
(:func:`lexsort_rows`).
"""

from __future__ import annotations

import torch

#: "No id" in the sentinel convention's scratch registers: larger than any
#: real int32 id, so a lex tie at +inf never prefers it over a real slot.
ID_MAX = torch.iinfo(torch.int32).max


def lex_improves(new_d, new_i, cur_d, cur_i):
    """True where (new_d, new_i) lex-precedes (cur_d, cur_i): the smaller
    distance wins, equal distances go to the smaller id."""
    return (new_d < cur_d) | ((new_d == cur_d) & (new_i < cur_i))


def lexsort_rows(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Per-row permutation sorting by ``primary``, ties by ``secondary``,
    remaining ties in place — ``jnp.lexsort((secondary, primary), axis=-1)``."""
    order = torch.sort(secondary, dim=-1, stable=True).indices
    inner = torch.sort(torch.gather(primary, -1, order), dim=-1, stable=True).indices
    return torch.gather(order, -1, inner)


def lex_kbest(dist: torch.Tensor, k: int):
    """Lex k-best of every row of a (rows, cols) distance block whose column
    ids are the column indices: ((rows, k) distances, (rows, k) int32 ids),
    ascending by (distance, id). Columns at +inf never enter; rows with
    fewer than k finite entries end in (+inf, -1).

    The k-th smallest value per row comes from ``torch.topk`` (values are
    exact whatever its tie order); every entry below it enters, and entries
    equal to it fill the remaining slots in ascending column order.
    """
    rows, cols = dist.shape
    kk = min(k, cols)
    out_d = torch.full((rows, k), float("inf"), dtype=dist.dtype, device=dist.device)
    out_i = torch.full((rows, k), -1, dtype=torch.int32, device=dist.device)
    if rows == 0 or kk == 0:
        return out_d, out_i
    kth = torch.topk(dist, kk, dim=1, largest=False, sorted=True).values[:, kk - 1 :]
    below = dist < kth
    at = (dist == kth) & torch.isfinite(dist)
    room = kk - below.sum(dim=1, keepdim=True)
    take = below | (at & (torch.cumsum(at.to(torch.int32), dim=1) <= room))
    r, c = torch.nonzero(take, as_tuple=True)  # row-major: ids ascend per row
    slot = torch.cumsum(take.to(torch.int32), dim=1)[r, c] - 1
    sel_d = torch.full((rows, kk), float("inf"), dtype=dist.dtype, device=dist.device)
    sel_i = torch.full((rows, kk), -1, dtype=torch.int32, device=dist.device)
    sel_d[r, slot] = dist[r, c]
    sel_i[r, slot] = c.to(torch.int32)
    # Stable sort by distance keeps ascending ids among equal distances.
    order = torch.sort(sel_d, dim=1, stable=True).indices
    out_d[:, :kk] = torch.gather(sel_d, 1, order)
    out_i[:, :kk] = torch.gather(sel_i, 1, order)
    return out_d, out_i


def topk_lex(values: torch.Tensor, k: int):
    """The k smallest entries of every row (last dim) in (value, position)
    lex order — ``jax.lax.top_k(-values, k)`` with its lower-index-first
    tie order, infinities included: ((..., k) values, (..., k) int64
    positions).

    float32 rows rank by one int64 key per entry (the value's order-
    preserving bit pattern above the position), so the selection is a
    single ``torch.topk`` with no ties and no host read; other dtypes take
    a stable sort.
    """
    if values.dtype != torch.float32:
        v, i = torch.sort(values, dim=-1, stable=True)
        return v[..., :k], i[..., :k]
    bits = (values + 0.0).view(torch.int32)  # + 0.0 folds -0.0 into +0.0
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    pos = torch.arange(values.shape[-1], dtype=torch.int64, device=values.device)
    key = (bits.to(torch.int64) << 32) | pos
    _, idx = torch.topk(key, k, dim=-1, largest=False, sorted=True)
    return torch.gather(values, -1, idx), idx


def merge_sorted_k(best, bidx, tile_d, tile_i, k: int):
    """Merge two (r, k) ascending lists (+ id companions) into one: a
    stable sort of the 2k concatenation by distance, the first list ahead
    on ties (the reference's ``ops/tiled._merge_sorted_k``)."""
    cat_d = torch.cat([best, tile_d], dim=-1)
    cat_i = torch.cat([bidx, tile_i], dim=-1)
    order = torch.sort(cat_d, dim=-1, stable=True).indices[..., :k]
    return torch.gather(cat_d, -1, order), torch.gather(cat_i, -1, order)


def merge_sorted_dedup(cur_d, cur_i, new_d, new_i, k: int):
    """Rowwise dedup-merge of two (r, k) ascending neighbor lists, negative-
    id convention (the reference's ``ops/lexmerge.merge_sorted_dedup``).

    The concatenation is stably sorted by id; a repeated id >= 0 keeps its
    first copy and the later copy's distance becomes +inf (its id stays).
    The k smallest distances then win, ties to the earlier position of the
    id-sorted order — ``top_k``'s order, so ties go to the lower id.
    """
    cat_d = torch.cat([cur_d, new_d], dim=-1)
    cat_i = torch.cat([cur_i, new_i], dim=-1)
    order = torch.sort(cat_i, dim=-1, stable=True).indices
    ci = torch.gather(cat_i, -1, order)
    cd = torch.gather(cat_d, -1, order)
    dup = (ci[..., 1:] == ci[..., :-1]) & (ci[..., 1:] >= 0)
    inf = torch.tensor(float("inf"), dtype=cd.dtype, device=cd.device)
    cd = torch.cat([cd[..., :1], torch.where(dup, inf, cd[..., 1:])], dim=-1)
    sel = torch.sort(cd, dim=-1, stable=True).indices[..., :k]
    return torch.gather(cd, -1, sel), torch.gather(ci, -1, sel)


def shift_insert(best, t: int, new_t, take):
    """Merged slot t gets ``new_t``; where the tile won, old slots past t
    shift right. ``best``: (rows, k); ``take``: (rows,) bool."""
    slot = torch.arange(best.shape[1], device=best.device)[None, :]
    shifted = torch.cat([best[:, :1], best[:, :-1]], dim=1)
    out = torch.where((slot > t) & take[:, None], shifted, best)
    return torch.where(slot == t, new_t[:, None], out)


def _extract_passes(bd, bi, cur, ids, k: int):
    """k passes of lex-min extraction from the candidate tile ``cur``/``ids``
    merged into the running lists (the reference's shared loop body)."""
    inf = torch.tensor(float("inf"), dtype=cur.dtype, device=cur.device)
    id_max = torch.tensor(ID_MAX, dtype=torch.int32, device=cur.device)
    for t in range(k):
        m = torch.amin(cur, dim=1)
        mi = torch.amin(torch.where(cur == m[:, None], ids, id_max), dim=1)
        cd, ci = bd[:, t], bi[:, t]
        # The finite guard: an exhausted tile row holds (+inf, real id)
        # columns that must not lex-beat an empty (+inf, sentinel) slot.
        take = lex_improves(m, mi, cd, ci) & torch.isfinite(m)
        hit = (cur == m[:, None]) & (ids == mi[:, None]) & take[:, None]
        cur = torch.where(hit, inf, cur)
        bd = shift_insert(bd, t, torch.where(take, m, cd), take)
        bi = shift_insert(bi, t, torch.where(take, mi, ci), take)
    return bd, bi


def merge_tile_candidates(bd, bi, dist, ids, k: int):
    """Merge a candidate tile with arbitrary (unsorted, possibly duplicated)
    int32 ids into running lex-ascending (distance, id) k-best lists.

    A tile id already in the running lists at a lex-no-worse distance is
    dropped first; every copy of an extracted (d, id) pair leaves the tile
    at once while exactly one is inserted. Empty slots carry (+inf,
    sentinel-or-:data:`ID_MAX`); masked columns must carry +inf with an id
    >= every real id.
    """
    inf = torch.tensor(float("inf"), dtype=dist.dtype, device=dist.device)
    cur = dist
    for t in range(k):
        match = ids == bi[:, t, None]
        cur = torch.where(match & (bd[:, t, None] <= cur), inf, cur)
    return _extract_passes(bd, bi, cur, ids, k)


def topk_tile_candidates(dist, ids, k: int):
    """Lex k-best of one candidate tile alone, duplicate (d, id) pairs
    collapsed, non-finite candidates never entering: ((r, k) d, (r, k) int32
    id) with (+inf, :data:`ID_MAX`) in unused slots.

    Reducing a tile to its k lex-best distinct ids before a
    :func:`dedup_lex_merge` against a k-wide running list is exact: any
    candidate outside the tile's own k-best is lex-preceded by k distinct
    tile ids, so it can never enter the final k-best.
    """
    r = dist.shape[0]
    bd = torch.full((r, k), float("inf"), dtype=dist.dtype, device=dist.device)
    bi = torch.full((r, k), ID_MAX, dtype=torch.int32, device=dist.device)
    return _extract_passes(bd, bi, dist, ids, k)


def dedup_lex_merge(all_d, all_i, k: int, sentinel: int):
    """k-best of per-row candidate lists under the (distance, id) lex order,
    duplicate ids collapsed to their smallest-distance copy first (sentinel
    convention); rows with fewer than k distinct ids end in (+inf,
    sentinel)."""
    order = lexsort_rows(all_i, all_d)  # by id, then distance
    si = torch.gather(all_i, -1, order)
    sd = torch.gather(all_d, -1, order)
    dup = torch.zeros_like(si, dtype=torch.bool)
    dup[:, 1:] = si[:, 1:] == si[:, :-1]
    sd = torch.where(dup, torch.tensor(float("inf"), dtype=sd.dtype, device=sd.device), sd)
    si = torch.where(dup, torch.tensor(sentinel, dtype=si.dtype, device=si.device), si)
    order = lexsort_rows(sd, si)
    return torch.gather(sd, -1, order)[:, :k], torch.gather(si, -1, order)[:, :k]
