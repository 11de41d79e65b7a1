"""B4 ``knn_window``: the windowed k-best scan of the boundary rescan, on
the card, and its plain version.

The port of the TPU kernel ``hdbscan_tpu/ops/pallas_knn.py``
``knn_window_fused_pallas`` and of the guarded per-column-tile merge of the
XLA chunk ``ops/blockscan._knn_window_merge_chunk``: for row tile t and each
of its rows, the k lex-smallest (distance, column id) pairs over the column
window ``[wstart[t] * col_tile, (wstart[t] + n_win_tiles) * col_tile)``,
scanned in ascending column tiles. A (row tile x column tile) block merges
only if some row of the tile has a distance strictly below min(its running
k-th, ``bnd[row]``) — the reference's guard at its grain, which decides
which id wins an exact tie at the k-th slot. Empty slots are (+inf, -1);
columns at or past ``n`` are masked.

The kernel is ``csrc/knn_window.cu``; its header has the design. It runs
the k-best body of K2 (``csrc/kbest.cuh``) under the guard: one block per
row tile (the guard needs all of a tile's rows), 2 rows a thread at
d <= 32 (1 above), float4 column reads from shared memory, lists in shared
memory with inserts placed by bisection (in the slots' output rows past
64 KB of lists a tile), pass 1 on squared values with a root only for a
row under its bound, and a pass that stops as soon as one row of the tile
holds a candidate. Past k or d = 128 it runs its wide mode.
:func:`knn_window` launches it for CUDA tensors and runs
:func:`knn_window_plain` for CPU tensors; nothing else picks the route.
The distance form is the caller's: the fused contract's dot form, or the
form the reference's XLA tile (row_tile x col_tile) takes.
"""

from __future__ import annotations

import torch

from hdbscan_tpu_torch.core.distances import pairwise_distance
from hdbscan_tpu_torch.ops import cuda_build
from hdbscan_tpu_torch.ops.lexmerge import topk_lex

#: Largest row tile: one thread per row, one block per row tile.
MAX_ROW_TILE = 512

#: Plain version: tiles per step so one (tiles, row_tile, col_tile)
#: distance block stays under this many elements.
_PLAIN_BLOCK_ELEMS = 1 << 26


def knn_window_plain(x, n: int, ids, wstart, bnd, k: int, col_tile: int,
                     n_win_tiles: int, metric: str = "euclidean", form: str | None = "dot"):
    """Plain PyTorch version of the kernel, same arithmetic and guard.

    Per column tile the merge is the lex k-best of the running list
    followed by the tile (the running ids all precede the tile's, so
    (distance, position) order is the (distance, id) order), applied only
    to the tiles whose guard fires."""
    tiles, rt = ids.shape
    dev = x.device
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    out_d = torch.full((tiles, rt, k), float("inf"), dtype=torch.float32, device=dev)
    out_i = torch.full((tiles, rt, k), -1, dtype=torch.int32, device=dev)
    group = max(1, _PLAIN_BLOCK_ELEMS // (rt * col_tile))
    ar = torch.arange(col_tile, dtype=torch.int64, device=dev)
    for g0 in range(0, tiles, group):
        sl = slice(g0, g0 + group)
        xr = x[ids[sl].long()]
        b = bnd[sl]
        bd, bi = out_d[sl], out_i[sl]
        for j in range(n_win_tiles):
            base = (wstart[sl].long() + j) * col_tile
            cols = base[:, None] + ar
            xc = x[torch.clamp(cols, max=x.shape[0] - 1)]
            dist = pairwise_distance(xr, xc, metric, form)
            dist = torch.where((cols < n)[:, None, :], dist, inf)
            thr = torch.minimum(bd[..., k - 1], b)
            guard = (dist < thr[..., None]).flatten(1).any(dim=1)
            vals, pos = topk_lex(torch.cat([bd, dist], dim=-1), k)
            tile_id = (base[:, None, None] + pos - k).to(torch.int32)
            new_i = torch.where(pos < k, torch.gather(bi, -1, torch.clamp(pos, max=k - 1)), tile_id)
            new_i = torch.where(torch.isfinite(vals), new_i, -1)
            bd = torch.where(guard[:, None, None], vals, bd)
            bi = torch.where(guard[:, None, None], new_i, bi)
        out_d[sl], out_i[sl] = bd, bi
    return out_d, out_i


def knn_window(x, n: int, ids, wstart, bnd, k: int, col_tile: int, n_win_tiles: int,
               metric: str = "euclidean", form: str | None = "dot"):
    """Windowed k-best of every slot of a chunk of row tiles.

    ``x`` (>= n, d) float32 block-sorted points (columns at or past ``n``
    are masked); ``ids`` (T, row_tile) int32 row positions in ``x``;
    ``wstart`` (T,) int32 window origins in column tiles; ``bnd`` (T,
    row_tile) float32 priming bounds. Returns ((T, row_tile, k) float32,
    (T, row_tile, k) int32 column ids). A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel (and raises if it cannot).
    """
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"knn_window: expected (n, d) float32 points, got {tuple(x.shape)} {x.dtype}")
    tiles, rt = ids.shape
    d = x.shape[1]
    if ids.dtype != torch.int32 or wstart.dtype != torch.int32 or wstart.shape != (tiles,):
        raise ValueError("knn_window: ids (T, row_tile) and wstart (T,) must be int32")
    if bnd.shape != (tiles, rt) or bnd.dtype != torch.float32:
        raise ValueError("knn_window: bnd must be (T, row_tile) float32")
    if k < 1 or d < 1:
        raise ValueError(f"knn_window: needs k >= 1 and d >= 1, got k={k}, d={d}")
    if not 0 < n <= x.shape[0]:
        raise ValueError(f"knn_window: n={n} must be in [1, {x.shape[0]}]")
    if x.device.type == "cpu":
        return knn_window_plain(x, n, ids, wstart, bnd, k, col_tile, n_win_tiles, metric, form)
    dev = cuda_build.launch_device("knn_window", x, ids, wstart, bnd)
    if rt > MAX_ROW_TILE:
        raise ValueError(f"knn_window supports row tiles up to {MAX_ROW_TILE}, got {rt}")
    code = cuda_build.metric_code(metric, form)
    x, ids, wstart, bnd = x.contiguous(), ids.contiguous(), wstart.contiguous(), bnd.contiguous()
    out_d = torch.empty((tiles, rt, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((tiles, rt, k), dtype=torch.int32, device=x.device)
    cuda_build.launch(
        "knn_window", dev, x.data_ptr(), n, d, ids.data_ptr(), wstart.data_ptr(),
        bnd.data_ptr(), tiles, rt, k, code, col_tile, n_win_tiles,
        out_d.data_ptr(), out_i.data_ptr(), wide=max(k, d) > cuda_build.WIDE,
    )
    return out_d, out_i
