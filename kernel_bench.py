#!/usr/bin/env python3
"""Time one hand-written kernel body of one package tree on the card.

    python3 kernel_bench.py KERNEL ROOT [SHAPE ...]
    (KERNEL: segmin kbest rescan window ufscan leaf merge minout cosine)

ROOT is a directory holding ``hdbscan_tpu_torch/``: the checkout (``.``), or
an earlier commit unpacked with ``git archive`` into a git-ignored directory,
so that two versions are timed on one card in one call (run them in turns:
earlier, this, this, earlier). The kernel is built from ROOT's sources and
timed with CUDA events at the shapes of ``chip_smoke.py``'s cells; SHAPE
arguments keep only the shapes whose name contains one of them.

``segmin`` (K1/B1 and B9), on round-1 inputs (every row its own component):
B1 on the Skin-shaped 245,057 x 3 integer grid (diff form), B9 on one
65,536 x 65,536 panel of it (the 3g fit's shards), B1 on
``make_gauss(500,000, dims=28)`` (dot form, the 3f cell) and on 262,144 x 8
normal points. Core distances are the k-th nearest distances from
``torch.cdist`` (inputs for timing, not the fit's bits).

``kbest`` (K2, the rectangular B2 and B3): K2 on the Skin grid (k = 15,
diff form), the rectangular B2 on one 65,536 x 65,536 panel of it
(``id_offset`` 65,536, the 3g fit's form), B3 on Morton-ordered
``make_gauss(500,000, dims=28)`` (k = 7, dot form, the 3f cell) and at
dims=90 (3f's B3-alone leg), K2 on 262,144 x 8 normal points (k = 15, dot
form: the 1M x 8 exact twin's form at a quarter of the rows), and the
larger lists ``min_points`` 32 and 128 give (k = 31, 127) on the Skin grid,
the 262,144 x 8 points and the 3f points. Beside them, as a yardstick and
not a parity path, ``torch.cdist`` plus ``torch.topk(largest=False)`` over
row chunks at the k = 15 Skin, panel and 262,144 x 8 shapes and the 3f B3
shape, TF32 off: two library calls, with other rounding and tie order.

``rescan`` (B7): one rescan chunk (``max(64, 2^24 / (k^2 d))`` rows, each
against its k^2 neighbor-of-neighbor candidates) at the 3b fit's shape
(the Skin grid, k = 15, 24,855 rows x 225 candidates), on the Skin grid at
k = 63 (1,409 x 3,969) and k = 129 (336 x 16,641), and at the 3h fit's
3,000 x 3 lattice at k = 129 (336 x 16,641). The panels come from a real
forest query on that data (the forest of ``chip_smoke.forest_times``: 4
trees of leaf 1,024 on the Skin grid, 2 of leaf 300 on the lattice;
kernels B5 and B6), built once and kept in the git-ignored
``.torch_build/bench/`` beside this script, so every tree timed in turn
gets the same tensors. Each shape also reports the scan's grid (blocks)
and the share of its live candidates that repeat an id of their row.

``window`` (B4): one chunk at the 3d fit's main-chunk shape: 1,024 row
tiles of 512 rows, d = 10, k = 7, dot form, windows of 4 column tiles of
8,192 columns, on the Morton-sorted ``make_gauss(1,000,000, dims=10,
n_clusters=30, separation=9.0, seed=2)`` (the 3d data; block-sorted as
the rescan sorts it); row tile t holds rows [512 t, 512 (t + 1)), its
window starts one column tile before its own; odd tiles prime ``bnd`` with
each slot's k-th distance within its own row tile (finite), even tiles
with +inf, so that guards both fire and do not. It also reports the share
of (row tile x column tile) guards that fire, counted from the running
lists (not timed).

``ufscan`` (K3): the union-find event scan over the MST edge pool of an
exact fit, in the scan's (w, u, v) order: the Skin-shaped fit's (245,056
edges; ``chip_smoke.py`` phase 3) and the 1,048,576 x 8 blobs' exact fit
(1,048,575 edges; phase 3c's twin). The pools are made once by a fit of
the first tree timed and kept in ``.torch_build/bench/``. Where the tree
has ``mst_device.uf_scan_launch`` (the batched replay) it also reports,
from the kernel's ``prof`` counters, each phase's share of the block's
cycles, the hops per find and the replay's find rounds. No PyTorch call
runs a union-find: no yardstick.

``leaf`` (B5): one leaf batch of tree 0 (``rpforest.leaf_batches``) at the
3b fit's shape (the Skin grid, 4 trees of leaf 1,024: 36 leaves of 958
slots, kk 15), at the 3c fit's (the 1,048,576 x 8 blobs, 4 trees of leaf
1,024: 32 leaves of 1,024, kk 15; it reports the fit's B5 launches, trees
x batches) and at the 3h wide fit's (the 3,000 x 3 lattice, 2 trees of
leaf 300: 16 leaves of 188, kk 129), f32, the euclidean form the fit
takes. Inputs are built once into ``.torch_build/bench/``. Where the tree
has ``cuda_forest.leaf_blocks`` it reports each launch's grid.

``merge`` (B6): the fold of the per-tree lists a forest query's B5 launches
make (``cuda_forest.forest_knn_fused``'s stacks) at the 3b fit's shape (the
Skin grid, 4 trees of leaf 1,024: 4 x 245,057 x 15), at the 3c fit's (the
1,048,576 x 8 blobs: 4 x 1,048,576 x 15), on the 3b grid's bf16 stacks at
the bf16 route's over-provisioned kk = min(2k, 128, n) = 30, and at the 3h
wide fit's (the 3,000 x 3 lattice, 2 trees of leaf 300, kk 129). Inputs are
built once into ``.torch_build/bench/``.

``minout`` (B8): the four ``rescan`` panels, each with round-1 components
(every point its own) and with a later round's (each point's cell of an 8
x 8 x 8 grid over its first three features' range, 512 components, so
that most neighbors of neighbors lie in the row's own component); each
point's core distance is its k-th nearest distance (``torch.cdist`` +
``torch.topk`` over row chunks, k the panel's, built once into
``.torch_build/bench/``). It reports each shape's share of live candidates
in another component and, where the tree has ``cuda_forest.minout_splits``,
its spans.

``cosine`` (metric code 6, every kernel that takes it): K2 on the Skin grid
(k = 15) and on ``make_gauss(500,000, dims=28)`` at cosine and at pearson
(k = 7; the 3f cells, in the fits' own row order), B1 on both at round 1
with cosine core distances (each point's k-th nearest, from
``F.normalize`` + ``torch.mm`` + ``torch.topk``, built once into
``.torch_build/bench/``), B9 and the rectangular B2 on the 65,536 x 65,536
panel of the Skin grid, B5 on the 3b leaf batch, B7 on the 3b rescan chunk
and B8 on that chunk with round-1 components (the ``leaf`` and ``rescan``
inputs: their candidates come from the euclidean forest query, inputs for
timing). Beside the K2, B5 and B7 shapes, as a yardstick, one
``F.normalize``, then ``torch.mm`` / ``torch.bmm`` (TF32 off) and
``torch.topk(largest=True)`` of the similarities over the same pairs.

``rescan``, ``ufscan``, ``leaf``, ``merge``, ``minout`` and ``cosine`` also
report ``device_ms``: each kernel's device time a call from
``torch.profiler`` (the wrapper's host gaps, which the CUDA event times
include, left out).

Beside the rescan, window and leaf shapes, as a yardstick and not a parity path,
``torch.cdist`` plus ``torch.topk(largest=False)`` over the same pairs
(the candidate points gathered first for B7; tiles in groups), TF32 off:
two library calls, with other rounding, tie order and no dedup.

Prints the card and one JSON line of mean milliseconds by shape.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys

N_SKIN, N_HIGHD, N_BLOBS, PANEL = 245_057, 500_000, 262_144, 65_536


def ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs after one warm run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 3) -> dict:
    """Device time per call of each kernel ``fn()`` launches, by kernel
    name (``torch.profiler``, after one warm run): where a call's time
    goes, the wrapper's own small kernels included. A trace that records
    no device time (the profiler drops one now and then) is taken again, up
    to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            if us:
                out[e.key[:80]] = us / 1e3 / reps
        if out:
            break
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


class Data:
    """The bench's inputs on the card, each made once when a shape first
    asks for it: the Skin grid, then the 262,144 x 8 points, from one
    generator of seed 0; the Gaussian sets from seed 4."""

    def __init__(self):
        self._cache = {}

    def _get(self, key, make):
        if key not in self._cache:
            import torch

            self._cache[key] = torch.as_tensor(make().astype("float32"), device="cuda")
        return self._cache[key]

    def _seeded(self, which: int):
        import numpy as np

        rng = np.random.default_rng(0)
        draws = (rng.integers(0, 256, size=(N_SKIN, 3)), rng.normal(size=(N_BLOBS, 8)))
        return draws[which]

    def skin(self):
        return self._get("skin", lambda: self._seeded(0))

    def blobs(self):
        return self._get("blobs", lambda: self._seeded(1))

    def gauss(self, dims: int, morton: bool):
        import numpy as np

        from hdbscan_tpu_torch.utils.datasets import make_gauss

        def make():
            hd = make_gauss(N_HIGHD, dims=dims, n_clusters=8, separation=3 * np.sqrt(dims),
                            seed=4)[0]
            if morton:
                from hdbscan_tpu_torch.ops.cuda_knn_smallest import morton_order

                hd = hd[morton_order(hd)]
            return hd

        return self._get(("gauss", dims, morton), make)


def segmin_shapes(data: Data) -> dict:
    """Shape name -> (function to time, repetitions)."""
    import torch

    from hdbscan_tpu_torch.ops import cuda_segmin

    def round1(x, k):
        out = torch.empty(len(x), device="cuda")
        for a in range(0, len(x), 2048):
            dist = torch.cdist(x[a:a + 2048], x)
            out[a:a + 2048] = torch.topk(dist, k, largest=False).values[:, -1]
        n = len(x)
        return (x, out, torch.arange(n, dtype=torch.int32, device="cuda"),
                torch.ones(n, dtype=torch.bool, device="cuda"))

    def segmin(get, k, form):
        args = []

        def run():
            if not args:
                args.extend(round1(get(), k))
            return cuda_segmin.segmin(*args, "euclidean", form)
        return run

    def panel():
        args = []

        def run():
            if not args:
                skin = round1(data.skin(), 16)
                args.extend([t[:PANEL] for t in skin] + [t[PANEL:2 * PANEL] for t in skin])
            return cuda_segmin.min_outgoing_panel(*args, "euclidean", form="diff")
        return run

    return {
        f"B1 {N_SKIN}x3 diff": (segmin(data.skin, 16, "diff"), 5),
        f"B9 {PANEL}x{PANEL}x3 diff": (panel(), 10),
        f"B1 {N_HIGHD}x28 dot": (segmin(lambda: data.gauss(28, False), 8, "dot"), 3),
        f"B1 {N_BLOBS}x8 dot": (segmin(data.blobs, 16, "dot"), 3),
    }


def kbest_shapes(data: Data) -> dict:
    """Shape name -> (function to time, repetitions)."""
    from hdbscan_tpu_torch.core.distances import euclidean_form
    from hdbscan_tpu_torch.ops import cuda_knn
    from hdbscan_tpu_torch.ops import cuda_knn_smallest as ks
    from hdbscan_tpu_torch.parallel.ring import _ring_geometry

    rt, ct, shard, _ = _ring_geometry(N_SKIN, 4, 1024, 8192)
    form = euclidean_form(rt, ct, 3)

    def k2(get, k, form):
        return lambda: cuda_knn.knn_kbest(get(), k, "euclidean", form)

    def b3(dims, k):
        return lambda: ks.knn_smallest(data.gauss(dims, True), k, "dot")

    def b2():
        def run():
            skin = data.skin()
            return cuda_knn.knn_kbest_panel(skin[:shard], skin[shard:2 * shard], 15,
                                            "euclidean", form, id_offset=shard)
        return run

    shapes = {
        f"K2 {N_SKIN}x3 diff k15": (k2(data.skin, 15, "diff"), 5),
        f"B2 {shard}x{shard}x3 {form} k15": (b2(), 10),
        f"B3 {N_HIGHD}x28 dot k7": (b3(28, 7), 1),
        f"B3 {N_HIGHD}x90 dot k7": (b3(90, 7), 1),
        f"K2 {N_BLOBS}x8 dot k15": (k2(data.blobs, 15, "dot"), 3),
    }
    for k in (31, 127):
        shapes[f"K2 {N_SKIN}x3 diff k{k}"] = (k2(data.skin, k, "diff"), 2)
        shapes[f"K2 {N_BLOBS}x8 dot k{k}"] = (k2(data.blobs, k, "dot"), 2)
        shapes[f"B3 {N_HIGHD}x28 dot k{k}"] = (b3(28, k), 1)
    return shapes


def kbest_yardstick(data: Data) -> dict:
    """The two-call yardstick: cdist + topk over row chunks of at most 2^30
    distances, at the K2 (Skin, 262,144 x 8), B2 panel and B3 (3f) shapes."""
    import torch

    def two_calls(get, k, panel=False):
        def run():
            x = get()
            q, x = (x[:PANEL], x[PANEL:2 * PANEL]) if panel else (x, x)
            rows = max(1, (1 << 30) // len(x))
            for a in range(0, len(q), rows):
                torch.topk(torch.cdist(q[a:a + rows], x), k, dim=1, largest=False)
        return run

    return {
        f"{N_SKIN}x3 k15": (two_calls(data.skin, 15), 2),
        f"{PANEL}x{PANEL}x3 k15": (two_calls(data.skin, 15, panel=True), 5),
        f"{N_HIGHD}x28 k7": (two_calls(lambda: data.gauss(28, True), 7), 1),
        f"{N_BLOBS}x8 k15": (two_calls(data.blobs, 15), 2),
    }


def _cached(name: str, make):
    """Tensors ``make()`` returns, kept in ``.torch_build/bench/<name>.pt``
    beside this script so that every tree timed in turn gets the same ones."""
    import os

    import torch

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".torch_build", "bench",
                        f"{name}.pt")
    if os.path.exists(path):
        return [t.cuda() for t in torch.load(path)]
    out = make()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save([t.cpu() for t in out], f"{path}.tmp")
    os.replace(f"{path}.tmp", path)
    return out


def rescan_panel(data, k: int, trees: int, leaf_size: int):
    """(query rows, points, candidate ids) of the first rescan chunk of a
    forest fit at k: the forest query's lists (B5, B6), each chunk row's
    k^2 neighbors of neighbors (sentinel n where a slot is empty)."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.ops import rpforest

    n, d = data.shape
    x = torch.as_tensor(data.astype(np.float32), device="cuda")
    forest = rpforest.build_forest(data, trees=trees, leaf_size=max(leaf_size, 2 * k + 2),
                                   seed=0)
    _, best_i = rpforest.forest_knn(x, forest, k, backend="fused")
    kk = best_i.shape[1]
    chunk = min(n, max(64, rpforest._RESCAN_ELEM_BUDGET // (kk * kk * d)))
    return x[:chunk].contiguous(), x, rpforest._expand(best_i, best_i[:chunk], kk, n)


def rescan_panels(data: Data) -> dict:
    """Shape name -> (getter of the chunk's (q, x, cand), repetitions)."""
    import numpy as np

    from hdbscan_tpu_torch.utils.datasets import make_gauss

    def lattice():
        return np.round(make_gauss(3000, dims=3, n_clusters=6, separation=8.0, seed=3)[0])

    def skin():
        return data.skin().cpu().numpy().astype(np.float64)

    cases = (  # name, cache key, points, k, trees, leaf size, repetitions
        (f"B7 skin {N_SKIN}x3 k15 (3b)", "skin_k15", skin, 15, 4, 1024, 10),
        (f"B7 skin {N_SKIN}x3 k63", "skin_k63", skin, 63, 4, 1024, 5),
        (f"B7 skin {N_SKIN}x3 k129", "skin_k129", skin, 129, 4, 1024, 3),
        ("B7 lattice 3000x3 k129 (3h)", "lattice_k129", lattice, 129, 2, 300, 3),
    )
    panels = {}
    for name, key, points, k, trees, leaf, reps in cases:
        memo = []

        def get(memo=memo, key=key, points=points, k=k, trees=trees, leaf=leaf):
            if not memo:
                memo.extend(_cached(f"rescan_{key}",
                                    lambda: rescan_panel(points(), k, trees, leaf)))
            return memo
        panels[name] = (get, reps)
    return panels


def _rescan_k(cand) -> int:
    return math.isqrt(cand.shape[1])


def rescan_shapes(panels: dict) -> dict:
    """Shape name -> (function to time, repetitions)."""
    from hdbscan_tpu_torch.ops import cuda_forest as cf

    def run(get):
        q, x, cand = get()
        return cf.forest_rescan_topk(q, x, cand, _rescan_k(cand), "euclidean", "f32", len(x))

    return {name: (lambda get=get: run(get), reps) for name, (get, reps) in panels.items()}


def rescan_blocks_of(panels: dict) -> dict:
    """Each rescan shape's scan grid (row blocks x spans), where the tree
    has ``cuda_forest.rescan_blocks`` (the redesigned kernel)."""
    from hdbscan_tpu_torch.ops import cuda_forest as cf

    if not hasattr(cf, "rescan_blocks"):
        return {}
    out = {}
    for name, (get, _) in panels.items():
        q, x, cand = get()
        out[name] = cf.rescan_blocks(q.shape[0], cand.shape[1], q.shape[1], _rescan_k(cand))
    return out


def rescan_copy_share(panels: dict) -> dict:
    """Each rescan shape's share of live candidates that repeat an id
    already met in the same row (not timed)."""
    import torch

    out = {}
    for name, (get, _) in panels.items():
        _, x, cand = get()
        live = cand != len(x)
        s = torch.sort(cand, dim=1).values
        repeat = torch.zeros_like(live)
        repeat[:, 1:] = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] != len(x))
        out[name] = float(repeat.sum()) / max(1, int(live.sum()))
    return out


def rescan_yardstick(panels: dict) -> dict:
    """cdist + topk of each rescan chunk's rows against their gathered
    candidate points, rows in groups of at most 2^26 gathered features."""
    import torch

    def two_calls(get):
        q, x, cand = get()
        m, c = cand.shape
        rows = max(1, (1 << 26) // (c * x.shape[1]))
        for a in range(0, m, rows):
            pts = x[cand[a:a + rows].clamp(max=x.shape[0] - 1).long()]
            torch.topk(torch.cdist(q[a:a + rows, None, :], pts), _rescan_k(cand), dim=2,
                       largest=False)

    return {name: (lambda get=get: two_calls(get), reps) for name, (get, reps) in panels.items()}


W_TILES, W_RT, W_D, W_K, W_COL_TILE, W_WIN = 1024, 512, 10, 7, 8192, 4


def window_chunk():
    """(x, n, ids, wstart, bnd) of the window bench's chunk (see the module
    docstring)."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.core.distances import pairwise_distance
    from hdbscan_tpu_torch.ops.cuda_knn_smallest import morton_order
    from hdbscan_tpu_torch.ops.lexmerge import lex_kbest
    from hdbscan_tpu_torch.utils.datasets import make_gauss

    def make():
        xs = make_gauss(1_000_000, dims=W_D, n_clusters=30, separation=9.0, seed=2)[0]
        x = torch.as_tensor(xs[morton_order(xs)].astype(np.float32), device="cuda")
        n = x.shape[0]
        ids = torch.arange(W_TILES * W_RT, dtype=torch.int32, device="cuda").reshape(W_TILES, W_RT)
        n_tiles = -(-n // W_COL_TILE)
        own = torch.arange(W_TILES, device="cuda") * W_RT // W_COL_TILE
        wstart = torch.clamp(own - 1, 0, n_tiles - W_WIN).to(torch.int32)
        bnd = torch.full((W_TILES, W_RT), float("inf"), device="cuda")
        for t in range(1, W_TILES, 2):
            xt = x[ids[t].long()]
            bnd[t] = lex_kbest(pairwise_distance(xt, xt, "euclidean", "dot"), W_K)[0][:, -1]
        return [x, ids, wstart, bnd]

    x, ids, wstart, bnd = _cached("window_3d", make)
    return x, x.shape[0], ids, wstart, bnd


def window_shapes(chunk) -> dict:
    from hdbscan_tpu_torch.ops import cuda_knn_window as cw

    def run():
        x, n, ids, wstart, bnd = chunk
        return cw.knn_window(x, n, ids, wstart, bnd, W_K, W_COL_TILE, W_WIN, "euclidean", "dot")

    name = (f"B4 {W_TILES} tiles x {W_RT} rows, d {W_D}, k {W_K}, dot, windows {W_WIN} x "
            f"{W_COL_TILE}")
    return {name: (run, 2)}


def window_yardstick(chunk) -> dict:
    """cdist + topk of each slot against its window's columns, 8 row tiles
    a group."""
    import torch

    def go():
        x, n, ids, wstart, bnd = chunk
        ar = torch.arange(W_WIN * W_COL_TILE, device="cuda")
        for a in range(0, W_TILES, 8):
            cols = torch.clamp(wstart[a:a + 8, None].long() * W_COL_TILE + ar, max=n - 1)
            torch.topk(torch.cdist(x[ids[a:a + 8].long()], x[cols]), W_K, dim=2, largest=False)

    return {"window chunk": (go, 1)}


def window_guard_share(chunk) -> float:
    """Share of the chunk's (row tile x column tile) guards that fire: the
    running lists after j column tiles (the kernel over the first j), and a
    tile's guard fires iff one of its rows has a column of tile j strictly
    below min(its k-th, bnd)."""
    import torch

    from hdbscan_tpu_torch.core.distances import pairwise_distance
    from hdbscan_tpu_torch.ops import cuda_knn_window as cw

    x, n, ids, wstart, bnd = chunk
    fired = 0
    ar = torch.arange(W_COL_TILE, device="cuda")
    for j in range(W_WIN):
        if j:
            kth = cw.knn_window(x, n, ids, wstart, bnd, W_K, W_COL_TILE, j, "euclidean",
                                "dot")[0][..., -1]
        else:
            kth = torch.full_like(bnd, float("inf"))
        thr = torch.minimum(kth, bnd)
        for a in range(0, W_TILES, 16):
            cols = (wstart[a:a + 16, None].long() + j) * W_COL_TILE + ar
            dist = pairwise_distance(x[ids[a:a + 16].long()], x[cols.clamp(max=n - 1)],
                                     "euclidean", "dot")
            dist = torch.where((cols < n)[:, None, :], dist, float("inf"))
            fired += int((dist.amin(dim=2) < thr[a:a + 16]).any(dim=1).sum())
    return fired / (W_TILES * W_WIN)


def blobs(n: int, seed: int, d: int = 8):
    """The rp-forest tier's blobs of ``chip_smoke.py`` (6 centres x 6.0,
    unit normal)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(6, d)) * 6.0
    per = n // 6 + 1
    return np.concatenate([c + rng.normal(size=(per, d)) for c in centers])[:n]


def uf_pools(data: Data) -> dict:
    """Shape name -> getter of (su, sv, n): an exact fit's MST edges in the
    scan's (w, u, v) order."""
    import numpy as np

    def pool(key, points, min_cl):
        memo = []

        def get():
            if not memo:
                def make():
                    import torch

                    from hdbscan_tpu_torch import HDBSCANParams
                    from hdbscan_tpu_torch.models import exact

                    x = points()
                    res = exact.fit(x, HDBSCANParams(min_points=16, min_cluster_size=min_cl,
                                                     knn_index="exact"))
                    u, v, w = res.mst
                    order = np.lexsort((v, u, w))
                    return [torch.as_tensor(u[order].astype(np.int32), device="cuda"),
                            torch.as_tensor(v[order].astype(np.int32), device="cuda"),
                            torch.tensor([len(x)])]
                su, sv, n = _cached(f"ufscan_{key}", make)
                memo.extend([su, sv, int(n[0])])
            return memo
        return get

    return {
        f"K3 skin {N_SKIN}x3 MST pool": pool(
            "skin", lambda: data.skin().cpu().numpy().astype(np.float64), 3000),
        "K3 blobs 1048576x8 MST pool": pool("blobs", lambda: blobs(1 << 20, 0), 5000),
    }


def ufscan_shapes(pools: dict) -> dict:
    """Shape name -> (function to time, repetitions)."""
    from hdbscan_tpu_torch.core import mst_device

    return {name: (lambda get=get: mst_device.uf_scan(*get()), 2)
            for name, get in pools.items()}


def ufscan_profile(pools: dict) -> dict:
    """Each pool's phase shares of the kernel's cycles (block thread 0's
    clock), hops per find and replay steps, from its ``prof`` counters."""
    import torch

    from hdbscan_tpu_torch.core import mst_device

    if not hasattr(mst_device, "uf_scan_launch"):
        return {}
    out = {}
    for name, get in pools.items():
        su, sv, n = get()
        prof = torch.zeros(len(mst_device.UF_PROF_FIELDS), dtype=torch.int64, device="cuda")
        mst_device.uf_scan_launch(su, sv, n, prof=prof)
        f = dict(zip(mst_device.UF_PROF_FIELDS, prof.tolist()))
        cycles = sum(f[k] for k in ("find_cycles", "compact_cycles", "replay_cycles",
                                    "apply_cycles"))
        out[name] = dict(f, cycles=cycles, hops_per_find=f["hops"] / max(1, f["finds"]),
                         **{f"{k}_share": f[k] / max(1, cycles)
                            for k in ("find_cycles", "compact_cycles", "replay_cycles",
                                      "apply_cycles")})
    return out


def leaf_batches(data: Data) -> dict:
    """Shape name -> getter of (x, members, mask, kk, form, n, launches a
    fit): batch 0 of tree 0 of a forest fit's leaf scan."""
    import numpy as np

    from hdbscan_tpu_torch.utils.datasets import make_gauss

    def lattice():
        return np.round(make_gauss(3000, dims=3, n_clusters=6, separation=8.0, seed=3)[0])

    def batch(key, points, k, trees, leaf):
        memo = []

        def get():
            if not memo:
                def make():
                    import torch

                    from hdbscan_tpu_torch.core.distances import euclidean_form
                    from hdbscan_tpu_torch.ops import rpforest

                    pts = points()
                    forest = rpforest.build_forest(pts, trees=trees,
                                                   leaf_size=max(leaf, 2 * k + 2), seed=0)
                    batches = rpforest.leaf_batches(forest, "cuda")
                    a, b, _ = batches[0]
                    lmax = forest.max_leaf
                    return [torch.as_tensor(pts.astype(np.float32), device="cuda"),
                            torch.as_tensor(forest.members[0, a:b], device="cuda"),
                            torch.as_tensor(forest.leaf_mask[a:b], device="cuda"),
                            torch.tensor([min(k, lmax), trees * len(batches),
                                          int(euclidean_form(lmax, lmax, pts.shape[1])
                                              == "dot")])]
                x, members, mask, meta = _cached(f"leaf_{key}", make)
                kk, launches, dot = (int(v) for v in meta)
                memo.extend([x, members, mask, kk, "dot" if dot else "diff", x.shape[0],
                             launches])
            return memo
        return get

    def skin():
        return data.skin().cpu().numpy().astype(np.float64)

    return {
        f"B5 skin {N_SKIN}x3 k15 (3b)": batch("skin_k15", skin, 15, 4, 1024),
        "B5 blobs 1048576x8 k15 (3c)": batch("blobs_k15", lambda: blobs(1 << 20, 0), 15, 4,
                                             1024),
        "B5 lattice 3000x3 k129 (3h wide)": batch("lattice_k129", lattice, 129, 2, 300),
    }


def leaf_shapes(batches: dict) -> dict:
    from hdbscan_tpu_torch.ops import cuda_forest as cf

    def run(get):
        x, members, mask, kk, form, n, _ = get()
        return cf.forest_leaf_topk(x, members, mask, kk, "euclidean", form, "f32", n)

    return {name: (lambda get=get: run(get), 10) for name, get in batches.items()}


def leaf_info(batches: dict) -> dict:
    """Each leaf shape's batch, kk, the fit's B5 launches and (where the tree
    has ``cuda_forest.leaf_blocks``) the launch's scan grid."""
    from hdbscan_tpu_torch.ops import cuda_forest as cf

    out = {}
    for name, get in batches.items():
        x, members, mask, kk, form, n, launches = get()
        b, ell = members.shape
        out[name] = dict(leaves=b, width=ell, kk=kk, form=form, fit_launches=launches)
        if hasattr(cf, "leaf_blocks"):
            out[name]["blocks"] = cf.leaf_blocks(b, ell)
    return out


def leaf_yardstick(batches: dict) -> dict:
    """cdist + topk over each batch's gathered leaf points."""
    import torch

    def two_calls(get):
        x, members, mask, kk, form, n, _ = get()
        pts = x[members.long()]
        torch.topk(torch.cdist(pts, pts), kk, dim=2, largest=False)

    return {name: (lambda get=get: two_calls(get), 10) for name, get in batches.items()}


def merge_stacks(data: Data) -> dict:
    """Shape name -> getter of (stack_d, stack_i, kk, n): the per-tree lists
    of a forest query at kk, made by B5 over every leaf batch of every tree
    (in ``precision``) and scattered to point-major rows as
    ``cuda_forest.forest_knn_fused`` does."""
    import numpy as np

    from hdbscan_tpu_torch.utils.datasets import make_gauss

    def lattice():
        return np.round(make_gauss(3000, dims=3, n_clusters=6, separation=8.0, seed=3)[0])

    def skin():
        return data.skin().cpu().numpy().astype(np.float64)

    def stacks(key, points, k, kk, trees, leaf, precision):
        memo = []

        def get():
            if not memo:
                def make():
                    import torch

                    from hdbscan_tpu_torch.core.distances import euclidean_form
                    from hdbscan_tpu_torch.ops import cuda_forest as cf
                    from hdbscan_tpu_torch.ops import rpforest

                    pts = points()
                    n = len(pts)
                    x = torch.as_tensor(pts.astype(np.float32), device="cuda")
                    forest = rpforest.build_forest(pts, trees=trees,
                                                   leaf_size=max(leaf, 2 * k + 2), seed=0)
                    lmax = forest.max_leaf
                    width = min(kk, lmax)
                    form = euclidean_form(lmax, lmax, pts.shape[1])
                    members = torch.as_tensor(forest.members, device="cuda")
                    mask = torch.as_tensor(forest.leaf_mask, device="cuda")
                    sd = torch.full((trees, n, width), float("inf"), device="cuda")
                    si = torch.full((trees, n, width), n, dtype=torch.int32, device="cuda")
                    for t in range(trees):
                        for a, b, real in rpforest.leaf_batches(forest, "cuda"):
                            nd, ni = cf.forest_leaf_topk(x, members[t, a:b], mask[a:b], width,
                                                         "euclidean", form, precision, n)
                            rows = members[t, a:b].reshape(-1)[real].long()
                            sd[t].index_copy_(0, rows, nd.reshape(-1, width)[real])
                            si[t].index_copy_(0, rows, ni.reshape(-1, width)[real])
                    return [sd, si, torch.tensor([width, n])]
                sd, si, meta = _cached(f"merge_{key}", make)
                memo.extend([sd, si, int(meta[0]), int(meta[1])])
            return memo
        return get

    return {
        f"B6 skin {N_SKIN}x3 4 trees kk15 (3b)": stacks("skin_k15", skin, 15, 15, 4, 1024, "f32"),
        "B6 blobs 1048576x8 4 trees kk15 (3c)": stacks(
            "blobs_k15", lambda: blobs(1 << 20, 0), 15, 15, 4, 1024, "f32"),
        f"B6 skin {N_SKIN}x3 4 trees bf16 kk30 (3b bf16)": stacks(
            "skin_bf16_k30", skin, 15, 30, 4, 1024, "bf16"),
        "B6 lattice 3000x3 2 trees kk129 (3h wide)": stacks(
            "lattice_k129", lattice, 129, 129, 2, 300, "f32"),
    }


def merge_shapes(stacks: dict) -> dict:
    from hdbscan_tpu_torch.ops import cuda_forest as cf

    def run(get):
        sd, si, kk, n = get()
        return cf.forest_merge(sd, si, kk, n)

    return {name: (lambda get=get: run(get), 10) for name, get in stacks.items()}


def minout_inputs(data: Data, panels: dict) -> dict:
    """Shape name -> getter of B8's arguments on a ``rescan`` panel, with
    round-1 components or a later round's spatial cells
    (``chip_smoke.cell_components``)."""
    from chip_smoke import cell_components

    def kth_distance(x, k):
        import torch

        kth = []
        for a in range(0, x.shape[0], 1024):
            dist = torch.cdist(x[a:a + 1024], x)
            kth.append(torch.topk(dist, k, dim=1, largest=False).values[:, k - 1])
        return [torch.cat(kth)]

    out = {}
    for name, (get, reps) in panels.items():
        for label in ("round 1", "later round, 512 cells"):
            memo = []

            def args(get=get, label=label, memo=memo, name=name):
                if not memo:
                    import re

                    import torch

                    q, x, cand = get()
                    n, m = x.shape[0], q.shape[0]
                    key = re.sub(r"[^a-z0-9]+", "_", name.lower())
                    core = _cached(f"minout_core_{key}",
                                   lambda: kth_distance(x, _rescan_k(cand)))[0]
                    comp = (torch.arange(n, dtype=torch.int32, device=x.device)
                            if label == "round 1" else cell_components(x))
                    memo.extend([q, x, cand, core[:m], core, comp[:m].contiguous(), comp])
                return memo
            out[f"{name.replace('B7', 'B8')} {label}"] = (args, reps)
    return out


def minout_shapes(inputs: dict) -> dict:
    from hdbscan_tpu_torch.ops import cuda_forest as cf

    def run(args):
        return cf.forest_min_outgoing(*args(), "euclidean", args()[1].shape[0])

    return {name: (lambda args=args: run(args), reps) for name, (args, reps) in inputs.items()}


def minout_info(inputs: dict) -> dict:
    """Each B8 shape's share of live candidates in another component and,
    where the tree has ``cuda_forest.minout_splits``, its spans."""
    from hdbscan_tpu_torch.ops import cuda_forest as cf

    out = {}
    for name, (args, _) in inputs.items():
        q, x, cand, _, _, comp_q, comp = args()
        live = cand != x.shape[0]
        other = live & (comp[cand.clamp(max=x.shape[0] - 1).long()] != comp_q[:, None])
        out[name] = dict(rows=q.shape[0], candidates=cand.shape[1],
                         outgoing_share=float(other.sum()) / max(1, int(live.sum())))
        if hasattr(cf, "minout_splits"):
            out[name]["spans"] = cf.minout_splits(q.shape[0], cand.shape[1])
    return out


def cosine_inputs(data: Data) -> dict:
    """Getters of the cosine shapes' inputs: the Skin grid and the 3f points
    (unordered) with their cosine core distances (k 15 and 7)."""
    import torch

    def kth_cosine(x, k):
        xn = torch.nn.functional.normalize(x, dim=1)
        kth = []
        for a in range(0, x.shape[0], 1024):
            sim = torch.topk(torch.mm(xn[a:a + 1024], xn.t()), k, dim=1).values[:, k - 1]
            kth.append(1.0 - sim)
        return [torch.cat(kth)]

    def cored(get, k, key):
        memo = []

        def run():
            if not memo:
                x = get()
                memo.extend([x, _cached(f"cosine_core_{key}", lambda: kth_cosine(x, k))[0]])
            return memo
        return run

    return {"skin": cored(data.skin, 16, "skin"),
            "3f": cored(lambda: data.gauss(28, False), 8, "3f")}


def cosine_shapes(data: Data, inputs: dict) -> dict:
    """Shape name -> (function to time, repetitions), every kernel at
    cosine (K2 and B1 at pearson too on the 3f points)."""
    import torch

    from hdbscan_tpu_torch.ops import cuda_forest as cf
    from hdbscan_tpu_torch.ops import cuda_knn, cuda_segmin

    def k2(key, k, metric):
        return lambda: cuda_knn.knn_kbest(inputs[key]()[0], k, metric, None, 8192)

    def b1(key, metric):
        def run():
            x, core = inputs[key]()
            n = x.shape[0]
            return cuda_segmin.segmin(x, core, torch.arange(n, dtype=torch.int32, device="cuda"),
                                      torch.ones(n, dtype=torch.bool, device="cuda"), metric,
                                      None, 8192)
        return run

    def panel(which):
        def run():
            x, core = inputs["skin"]()
            r, c = slice(0, PANEL), slice(PANEL, 2 * PANEL)
            if which == "B2":
                return cuda_knn.knn_kbest_panel(x[r], x[c], 15, "cosine", None, PANEL,
                                                col_tile=PANEL)
            comp = torch.arange(x.shape[0], dtype=torch.int32, device="cuda")
            ones = torch.ones(x.shape[0], dtype=torch.bool, device="cuda")
            return cuda_segmin.min_outgoing_panel(
                x[r], core[r], comp[r], ones[r], x[c], core[c], comp[c], ones[c], "cosine",
                1024, PANEL, col_offset=PANEL)
        return run

    leaf = leaf_batches(data)[f"B5 skin {N_SKIN}x3 k15 (3b)"]
    rescan = rescan_panels(data)[f"B7 skin {N_SKIN}x3 k15 (3b)"][0]

    def b5():
        x, members, mask, kk, _, n, _ = leaf()
        return cf.forest_leaf_topk(x, members, mask, kk, "cosine", None, "f32", n)

    def b7():
        q, x, cand = rescan()
        return cf.forest_rescan_topk(q, x, cand, _rescan_k(cand), "cosine", "f32", x.shape[0])

    def b8():
        q, x, cand = rescan()
        core = inputs["skin"]()[1]
        comp = torch.arange(x.shape[0], dtype=torch.int32, device="cuda")
        m = q.shape[0]
        return cf.forest_min_outgoing(q, x, cand, core[:m], core, comp[:m], comp, "cosine",
                                      x.shape[0])

    return {
        f"K2 cosine {N_SKIN}x3 k15": (k2("skin", 15, "cosine"), 3),
        f"K2 cosine {N_HIGHD}x28 k7": (k2("3f", 7, "cosine"), 1),
        f"K2 pearson {N_HIGHD}x28 k7": (k2("3f", 7, "pearson"), 1),
        f"B1 cosine {N_SKIN}x3": (b1("skin", "cosine"), 3),
        f"B1 cosine {N_HIGHD}x28": (b1("3f", "cosine"), 1),
        f"B1 pearson {N_HIGHD}x28": (b1("3f", "pearson"), 1),
        f"B9 cosine {PANEL}x{PANEL}x3": (panel("B9"), 5),
        f"B2 cosine {PANEL}x{PANEL}x3 k15": (panel("B2"), 5),
        f"B5 cosine skin {N_SKIN}x3 k15 (3b)": (b5, 10),
        f"B7 cosine skin {N_SKIN}x3 k15 (3b)": (b7, 10),
        f"B8 cosine skin {N_SKIN}x3 k15 (3b) round 1": (b8, 10),
    }


def cosine_yardstick(data: Data, inputs: dict) -> dict:
    """``F.normalize``, ``torch.mm`` / ``torch.bmm`` (TF32 off) and
    ``torch.topk(largest=True)`` at the K2, B5 and B7 cosine shapes."""
    import torch

    normalize = torch.nn.functional.normalize

    def k2(key, k):
        def run():
            xn = normalize(inputs[key]()[0], dim=1)
            rows = max(1, (1 << 28) // xn.shape[0])
            for a in range(0, xn.shape[0], rows):
                torch.topk(torch.mm(xn[a:a + rows], xn.t()), k, dim=1)
        return run

    leaf = leaf_batches(data)[f"B5 skin {N_SKIN}x3 k15 (3b)"]
    rescan = rescan_panels(data)[f"B7 skin {N_SKIN}x3 k15 (3b)"][0]

    def b5():
        x, members, _, kk, _, _, _ = leaf()
        pn = normalize(x[members.long()], dim=2)
        torch.topk(torch.bmm(pn, pn.transpose(1, 2)), kk, dim=2)

    def b7():
        q, x, cand = rescan()
        k = _rescan_k(cand)
        xn, qn = normalize(x, dim=1), normalize(q, dim=1)
        rows = max(1, (1 << 26) // cand.shape[1])
        for a in range(0, q.shape[0], rows):
            pts = xn[cand[a:a + rows].clamp(max=x.shape[0] - 1).long()]
            torch.topk(torch.bmm(pts, qn[a:a + rows, :, None])[:, :, 0], k, dim=1)

    return {f"K2 {N_SKIN}x3 k15": (k2("skin", 15), 2), f"K2 {N_HIGHD}x28 k7": (k2("3f", 7), 1),
            f"B5 skin {N_SKIN}x3 k15 (3b)": (b5, 5), f"B7 skin {N_SKIN}x3 k15 (3b)": (b7, 5)}


def main() -> int:
    modes = ("segmin", "kbest", "rescan", "window", "ufscan", "leaf", "merge", "minout", "cosine")
    if len(sys.argv) < 3 or sys.argv[1] not in modes:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    kernel, root, keep = sys.argv[1], sys.argv[2], sys.argv[3:]
    sys.path.insert(0, root)
    import torch

    from hdbscan_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.kernel({"kbest": "knn_kbest", "segmin": "segmin", "rescan": "forest_rescan_topk",
                       "window": "knn_window", "ufscan": "uf_scan",
                       "leaf": "forest_leaf_topk", "merge": "forest_merge",
                       "minout": "forest_min_outgoing", "cosine": "knn_kbest"}[kernel])

    def timed(shapes):
        return {name: ms(fn, reps) for name, (fn, reps) in shapes.items()
                if not keep or any(s in name for s in keep)}

    data = Data()
    result = {"root": root, "kernel": kernel}
    yardstick = "two_library_calls_other_rounding_and_tie_order_ms"
    if kernel == "segmin":
        result["ms"] = timed(segmin_shapes(data))
    elif kernel == "kbest":
        result["ms"] = timed(kbest_shapes(data))
        result[yardstick] = timed(kbest_yardstick(data))
    elif kernel == "rescan":
        panels = {name: v for name, v in rescan_panels(data).items()
                  if not keep or any(s in name for s in keep)}
        result["ms"] = timed(rescan_shapes(panels))
        result["device_ms"] = {name: device_ms(fn) for name, (fn, _) in
                               rescan_shapes(panels).items()}
        result["blocks"] = rescan_blocks_of(panels)
        result["copy_share"] = rescan_copy_share(panels)
        result["two_library_calls_other_rounding_tie_order_and_no_dedup_ms"] = timed(
            rescan_yardstick(panels))
    elif kernel == "ufscan":
        pools = {name: get for name, get in uf_pools(data).items()
                 if not keep or any(s in name for s in keep)}
        result["ms"] = timed(ufscan_shapes(pools))
        result["profile"] = ufscan_profile(pools)
        result["device_ms"] = {name: device_ms(fn, 1) for name, (fn, _) in
                               ufscan_shapes(pools).items()}
    elif kernel == "leaf":
        batches = {name: get for name, get in leaf_batches(data).items()
                   if not keep or any(s in name for s in keep)}
        result["ms"] = timed(leaf_shapes(batches))
        result["device_ms"] = {name: device_ms(fn) for name, (fn, _) in
                               leaf_shapes(batches).items()}
        result["shapes"] = leaf_info(batches)
        result[yardstick] = timed(leaf_yardstick(batches))
    elif kernel == "merge":
        stacks = {name: get for name, get in merge_stacks(data).items()
                  if not keep or any(s in name for s in keep)}
        result["ms"] = timed(merge_shapes(stacks))
        result["device_ms"] = {name: device_ms(fn) for name, (fn, _) in
                               merge_shapes(stacks).items()}
    elif kernel == "cosine":
        inputs = cosine_inputs(data)
        shapes = cosine_shapes(data, inputs)
        result["ms"] = timed(shapes)
        result["device_ms"] = {name: device_ms(fn, 1) for name, (fn, _) in shapes.items()
                               if not keep or any(s in name for s in keep)}
        result["normalize_mm_topk_other_rounding_and_tie_order_ms"] = timed(
            cosine_yardstick(data, inputs))
    elif kernel == "minout":
        inputs = {name: v for name, v in minout_inputs(data, rescan_panels(data)).items()
                  if not keep or any(s in name for s in keep)}
        result["ms"] = timed(minout_shapes(inputs))
        result["device_ms"] = {name: device_ms(fn) for name, (fn, _) in
                               minout_shapes(inputs).items()}
        result["shapes"] = minout_info(inputs)
    else:
        chunk = window_chunk()
        result["ms"] = timed(window_shapes(chunk))
        result["guard_fired_share"] = window_guard_share(chunk)
        result[yardstick] = timed(window_yardstick(chunk))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
