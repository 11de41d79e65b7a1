"""Batched per-partition kernels over padded blocks — the port of
``parallel/blocks.py``.

- :func:`block_mst_batch` / :func:`block_mst_batch_with_core`: the exact
  HDBSCAN* block program (distances -> core distances -> mutual
  reachability -> dense Borůvka) over a (B, cap, d) batch of padded blocks,
  as batched PyTorch ops on the fit's device.
- :func:`run_packed_blocks`: launches of at most ``hbm_budget_bytes`` of
  block working set each (``_BLOCK_TEMPS`` copies of the (cap, cap) matrix
  per block), split over a mesh's shards when one is given, edges mapped
  back to global point ids on the host.
- :func:`nearest_sample_assign` and :func:`seam_margins`: the nearest-sample
  argmin and the seam-margin scan, tiled over the points so one (tile,
  samples) distance matrix is the only large temporary.

These are plain PyTorch ops on the card as well (the reference leaves them
to XLA; no Pallas kernel is involved). Every op is elementwise, a minimum,
a top-k value, a gather or a scatter, so the CPU and the card compute the
same values.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from hdbscan_tpu_torch.core.distances import euclidean_form, pairwise_distance, self_distance_matrix
from hdbscan_tpu_torch.core.knn import mutual_reachability, mutual_reachability_block
from hdbscan_tpu_torch.core.mst import boruvka_mst
from hdbscan_tpu_torch.ops.tiled import _next_pow2


def block_mst_batch(x: torch.Tensor, num_valid: torch.Tensor, min_pts: int, metric: str):
    """Exact block program per padded block: (B, cap, d) points with
    ``num_valid`` (B,) real rows each -> (u, v, w, mask) (B, cap - 1) local
    MST edges and (B, cap) core distances (+inf on padding)."""
    cap = x.shape[1]
    valid = torch.arange(cap, device=x.device)[None, :] < num_valid[:, None]
    mrd, core = mutual_reachability_block(x, min_pts, metric, valid)
    u, v, w, mask, _ = boruvka_mst(mrd, num_valid)
    return u, v, w, mask, core


def block_mst_batch_with_core(x: torch.Tensor, core: torch.Tensor,
                              num_valid: torch.Tensor, metric: str):
    """Per-block MST under pre-computed (global) core distances ``core``
    (B, cap), +inf on padding. Returns (u, v, w, mask) in local indices."""
    cap = x.shape[1]
    valid = torch.arange(cap, device=x.device)[None, :] < num_valid[:, None]
    dist = self_distance_matrix(x, metric)
    inf = torch.tensor(float("inf"), dtype=dist.dtype, device=x.device)
    dist = torch.where(valid[:, None, :] & valid[:, :, None], dist, inf)
    mrd = mutual_reachability(dist, core)
    del dist
    u, v, w, mask, _ = boruvka_mst(mrd, num_valid)
    return u, v, w, mask


def nearest_sample_assign(
    points: np.ndarray,
    samples: np.ndarray,
    metric: str = "euclidean",
    tile: int = 8192,
    *,
    device,
    dtype=np.float32,
) -> np.ndarray:
    """(n,) int32 index of each point's nearest sample (first index on
    ties). The reference pads the samples to a power of two and scans
    points in ``tile``-row steps; the euclidean form is the one it takes at
    that (tile, samples) shape."""
    n, d = points.shape
    s = len(samples)
    s_pad = _next_pow2(max(s, 1))
    tile = min(_next_pow2(tile), _next_pow2(max(n, 8)))
    form = euclidean_form(tile, s_pad, d)
    smp = torch.as_tensor(np.asarray(samples, dtype), device=device)
    pts = torch.as_tensor(np.asarray(points, dtype), device=device)
    out = torch.empty(n, dtype=torch.int64, device=device)
    for a in range(0, n, tile):
        dd = pairwise_distance(pts[a : a + tile], smp, metric, form)
        out[a : a + tile] = torch.argmin(dd, dim=1)
    return out.cpu().numpy().astype(np.int32)


def seam_margins(
    points: np.ndarray,
    samples: np.ndarray,
    sample_groups: np.ndarray,
    metric: str = "euclidean",
    tile: int = 8192,
    *,
    device,
) -> np.ndarray:
    """(n,) seam margins d_other_group - d_own (float32 scan, float64
    difference), +inf where no other group exists — the boundary-quality
    mode's distance-to-seam proxy."""
    n, d = points.shape
    s = len(samples)
    s_pad = _next_pow2(max(s, 1))
    tile = min(_next_pow2(tile), max(128, _next_pow2((1 << 25) // s_pad)))
    tile = min(tile, _next_pow2(max(n, 8)))
    form = euclidean_form(tile, s_pad, d)
    smp = torch.as_tensor(np.asarray(samples, np.float32), device=device)
    grp = torch.as_tensor(np.asarray(sample_groups, np.int64), device=device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=device)
    d1 = torch.empty(n, dtype=torch.float32, device=device)
    d2 = torch.empty(n, dtype=torch.float32, device=device)
    for a in range(0, n, tile):
        dd = pairwise_distance(pts[a : a + tile], smp, metric, form)
        i1 = torch.argmin(dd, dim=1)
        d1[a : a + tile] = torch.gather(dd, 1, i1[:, None])[:, 0]
        other = grp[None, :] != grp[i1][:, None]
        d2[a : a + tile] = torch.amin(torch.where(other, dd, inf), dim=1)
    out = torch.stack([d1, d2], dim=1).cpu().numpy().astype(np.float64)
    return out[:, 1] - out[:, 0]


@dataclass
class PackedBlocks:
    """Subsets packed into a padded (B, cap, d) array plus index maps."""

    x: np.ndarray  # (B, cap, d)
    num_valid: np.ndarray  # (B,) int32
    point_index: np.ndarray  # (B, cap) global point id per slot (-1 padding)
    subset_ids: np.ndarray  # (B,) the subset each block came from
    core: np.ndarray | None = None  # (B, cap) precomputed global core distances


def pack_blocks(
    data: np.ndarray,
    point_ids_per_subset: list[np.ndarray],
    capacity: int,
    core: np.ndarray | None = None,
) -> PackedBlocks:
    """Pack per-subset point-id lists into padded blocks (every subset must
    fit ``capacity``); ``core``: optional global core distances to pack."""
    b = len(point_ids_per_subset)
    d = data.shape[1]
    x = np.zeros((b, capacity, d), data.dtype)
    num_valid = np.zeros(b, np.int32)
    point_index = np.full((b, capacity), -1, np.int64)
    core_b = None
    if core is not None:
        core_b = np.full((b, capacity), np.inf, np.float64)
    for i, ids in enumerate(point_ids_per_subset):
        k = len(ids)
        if k > capacity:
            raise ValueError(f"subset {i} has {k} points > capacity {capacity}")
        x[i, :k] = data[ids]
        num_valid[i] = k
        point_index[i, :k] = ids
        if core_b is not None:
            core_b[i, :k] = core[ids]
    return PackedBlocks(
        x=x, num_valid=num_valid, point_index=point_index,
        subset_ids=np.arange(b), core=core_b,
    )


#: Per-block working-set multiplier of the block program: the weight
#: matrix plus the per-round component mask and temporaries — ~8 copies of
#: the (cap, cap) matrix.
_BLOCK_TEMPS = 8


def run_packed_blocks(
    packed: PackedBlocks,
    min_pts: int,
    metric: str = "euclidean",
    hbm_budget_bytes: int = 2 << 30,
    *,
    device=None,
    mesh=None,
    batch_pad: int = 1,
    dtype=np.float32,
    trace=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Run the block program over every packed block, at most
    ``hbm_budget_bytes`` of block working set per launch (a power-of-two
    number of blocks, padded to a multiple of ``batch_pad``). Returns
    global-id MST edges (u, v, w) concatenated over the blocks and the (B,
    cap) core distances aligned with ``packed.point_index`` (the packed
    global cores when given). ``trace`` receives one ``block_fit`` event
    per call.

    ``mesh`` (``parallel/mesh.Mesh``; the reference's block sharding):
    each launch's blocks split over the shards (``mesh.block_shards``),
    shard ``s``'s slice running on ``mesh.devices[s]``; every shard's
    launch is queued before the first result is read. Every op is per
    block, so edges and cores equal the single-device call's bitwise.
    Over a multi-process mesh each rank runs only its own shards' slices
    and the per-shard (u, v, w, mask, core) outputs are gathered, in shard
    order, to every rank (``parallel/mesh.fetch_many``). Without a mesh the
    launches run on ``device``."""
    from hdbscan_tpu_torch.parallel.mesh import block_shards, fetch_many, get_mesh, pad_batch

    t0 = time.monotonic()
    b = len(packed.x)
    cap = packed.x.shape[1]
    itemsize = np.dtype(dtype).itemsize
    per_block = cap * cap * itemsize * _BLOCK_TEMPS
    chunk = max(1, hbm_budget_bytes // per_block)
    chunk = 1 << (chunk.bit_length() - 1)
    chunk = min(max(batch_pad, chunk), _next_pow2(pad_batch(b, batch_pad)))
    chunk = pad_batch(chunk, batch_pad)
    mesh = mesh if mesh is not None else get_mesh([device])

    from hdbscan_tpu_torch.utils.flops import counter as _flops

    _flops.add(2.0 * b * cap * cap * packed.x.shape[2], float(b * cap * cap * itemsize))

    core = np.empty((b, cap), np.float64)
    with_core = packed.core is not None
    if with_core:
        core[:] = packed.core
    gu, gv, gw = [], [], []
    for start in range(0, b, chunk):
        real = min(chunk, b - start)
        outs = {}
        for s, (lo, hi, dev) in enumerate(block_shards(mesh.devices, real)):
            if not mesh.is_local(s):
                continue
            if lo == hi:
                outs[s] = None
                continue
            a, e = start + lo, start + hi
            x = torch.as_tensor(packed.x[a:e].astype(dtype), device=dev)
            nv = torch.as_tensor(packed.num_valid[a:e].astype(np.int64), device=dev)
            if with_core:
                cb = torch.as_tensor(packed.core[a:e].astype(dtype), device=dev)
                outs[s] = block_mst_batch_with_core(x, cb, nv, metric)
            else:
                outs[s] = block_mst_batch(x, nv, min_pts, metric)
        if mesh.multiprocess:
            # Every rank's shards' outputs, gathered in shard order: the
            # launch's blocks [start, start + real) on every rank.
            got = fetch_many(outs, mesh)
            outs = {0: tuple([torch.as_tensor(g) for g in got])}
            firsts = {0: start}
        else:
            firsts = {s: start + lo for s, (lo, _, _) in
                      enumerate(block_shards(mesh.devices, real))}
        for s, out in sorted(outs.items()):
            if out is None:
                continue
            a = firsts[s]
            u, v, w, mask = out[:4]
            if not with_core:
                core[a : a + len(u)] = out[4].cpu().numpy().astype(np.float64)
            u, v = u.cpu().numpy(), v.cpu().numpy()
            w, mask = w.cpu().numpy().astype(np.float64), mask.cpu().numpy()
            for i in range(len(u)):
                m = mask[i]
                ids = packed.point_index[a + i]
                gu.append(ids[u[i][m]])
                gv.append(ids[v[i][m]])
                gw.append(w[i][m])
    if trace is not None:
        trace("block_fit", blocks=b, cap=cap, launches=-(-b // chunk),
              wall_s=round(time.monotonic() - t0, 6))
    return (
        np.concatenate(gu) if gu else np.zeros(0, np.int64),
        np.concatenate(gv) if gv else np.zeros(0, np.int64),
        np.concatenate(gw) if gw else np.zeros(0, np.float64),
        core,
    )
