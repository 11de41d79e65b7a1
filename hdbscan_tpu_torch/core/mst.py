"""Dense Borůvka MST over mutual-reachability matrices — the port of
``core/mst.py``, batched over blocks.

Every round, each vertex takes its minimum outgoing edge (first-index
``argmin``, which realizes the canonical (w, min(u, v), max(u, v)) order
within a row), each component its lexicographic minimum by (w, lo, hi,
vertex) through a cascade of segment minima, 2-cycles resolve to the
smaller root, and pointer jumping collapses the hooks. The round count is
fixed (``ceil(log2 n) + 1``), as in the reference's ``fori_loop``, so a
batch of blocks runs the same op sequence with no host read. All ops are
elementwise, minima, gathers and scatters: the result is the same on the
CPU and the card.
"""

from __future__ import annotations

import math

import torch

__all__ = ["boruvka_mst", "mst_edges_with_self_edges"]


def _segment_min(val: torch.Tensor, seg: torch.Tensor, n: int, fill) -> torch.Tensor:
    """(B, n) per-block segment minimum of ``val`` (B, n) by ``seg`` (B, n)
    labels in [0, n)."""
    out = torch.full(val.shape[:-1] + (n,), fill, dtype=val.dtype, device=val.device)
    return out.scatter_reduce_(-1, seg, val, "amin", include_self=True)


def _boruvka(weights: torch.Tensor, num_valid: torch.Tensor, num_rounds: int):
    bsz, n, _ = weights.shape
    dev = weights.device
    inf = torch.tensor(float("inf"), dtype=weights.dtype, device=dev)
    idx = torch.arange(n, dtype=torch.int64, device=dev).expand(bsz, n)
    valid = idx < num_valid[:, None]
    w = torch.where(valid[:, :, None] & valid[:, None, :], weights, inf)
    w = torch.where(torch.eye(n, dtype=torch.bool, device=dev), inf, w)

    m = max(n - 1, 1)
    labels = idx.clone()
    # One spare slot (index n) takes the writes of non-emitting components.
    eu = torch.zeros((bsz, n + 1), dtype=torch.int64, device=dev)
    ev = torch.zeros((bsz, n + 1), dtype=torch.int64, device=dev)
    ew = torch.full((bsz, n + 1), float("inf"), dtype=weights.dtype, device=dev)
    count = torch.zeros((bsz, 1), dtype=torch.int64, device=dev)
    sent = torch.tensor(n, dtype=torch.int64, device=dev)
    for _ in range(num_rounds):
        masked = torch.where(labels[:, :, None] == labels[:, None, :], inf, w)
        j_min = torch.argmin(masked, dim=2)
        w_min = torch.gather(masked, 2, j_min[:, :, None])[:, :, 0]
        del masked

        comp_w = _segment_min(w_min, labels, n, float("inf"))
        cand = torch.isfinite(w_min) & (w_min == torch.gather(comp_w, 1, labels))
        lo = torch.minimum(idx, j_min)
        hi = torch.maximum(idx, j_min)
        comp_lo = _segment_min(torch.where(cand, lo, sent), labels, n, n)
        cand = cand & (lo == torch.gather(comp_lo, 1, labels))
        comp_hi = _segment_min(torch.where(cand, hi, sent), labels, n, n)
        cand = cand & (hi == torch.gather(comp_hi, 1, labels))
        v_sel = _segment_min(torch.where(cand, idx, sent), labels, n, n)

        has_edge = v_sel < n
        v_safe = torch.clamp(v_sel, 0, n - 1)
        edge_u = v_safe
        edge_v = torch.gather(j_min, 1, v_safe)
        edge_w = torch.gather(w_min, 1, v_safe)
        target = torch.gather(labels, 1, edge_v)

        parent = torch.where(has_edge, target, idx)
        # 2-cycles (one undirected edge picked from both sides): the smaller
        # root survives; only the hooked side emits the edge.
        two_cycle = (parent != idx) & (torch.gather(parent, 1, parent) == idx)
        parent = torch.where(two_cycle & (idx < parent), idx, parent)
        added = has_edge & (parent != idx)
        for _ in range(num_rounds):
            parent = torch.gather(parent, 1, parent)
        labels = torch.gather(parent, 1, labels)

        pos = count + torch.cumsum(added.to(torch.int64), dim=1) - 1
        pos = torch.where(added, pos, sent)
        eu.scatter_(1, pos, edge_u)
        ev.scatter_(1, pos, edge_v)
        ew.scatter_(1, pos, edge_w)
        count = count + added.sum(dim=1, keepdim=True)
    mask = torch.arange(m, device=dev)[None, :] < count
    return eu[:, :m], ev[:, :m], ew[:, :m], mask, labels


def boruvka_mst(weights: torch.Tensor, num_valid=None):
    """MST of dense symmetric weight matrices (mutual reachability).

    ``weights``: (n, n) or (B, n, n); the diagonal is ignored.
    ``num_valid``: leading count of real vertices per block (int or (B,)
    tensor); vertices past it are isolated. Returns ``(u, v, w, mask,
    labels)`` with u/v/w (..., n - 1) local endpoints (int64) and weights,
    ``mask`` marking the emitted edges (``num_valid - 1`` of them for a
    connected block), and the final component label per vertex.
    """
    single = weights.dim() == 2
    if single:
        weights = weights[None]
    bsz, n, _ = weights.shape
    if num_valid is None:
        num_valid = n
    num_valid = torch.as_tensor(num_valid, dtype=torch.int64, device=weights.device)
    num_valid = num_valid.reshape(-1).expand(bsz)
    num_rounds = max(1, math.ceil(math.log2(n)) + 1) if n > 1 else 1
    out = _boruvka(weights, num_valid, num_rounds)
    return tuple(t[0] for t in out) if single else out


def mst_edges_with_self_edges(u, v, w, mask, core, valid=None):
    """Append per-point self edges (i, i, core_i): the level at which point
    i becomes noise. Returns concatenated (u, v, w, mask)."""
    n = core.shape[0]
    idx = torch.arange(n, dtype=u.dtype, device=u.device)
    self_mask = torch.ones(n, dtype=torch.bool, device=u.device) if valid is None else valid
    return (
        torch.cat([u, idx]),
        torch.cat([v, idx]),
        torch.cat([w, core.to(w.dtype)]),
        torch.cat([mask, self_mask]),
    )
