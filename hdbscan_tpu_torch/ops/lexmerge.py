"""The (distance, id) lexicographic k-best — plain PyTorch.

The repo-wide neighbor-list order of the reference (``ops/lexmerge.py``):
ascending distance, ties broken by ascending global id, empty slots
``(+inf, -1)``. This module holds the plain-side helpers of the k-NN kernel
(``ops/cuda_knn``): the exact lex k-best of a distance block, independent of
how ties fall inside ``torch.topk``.
"""

from __future__ import annotations

import torch


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

