#!/usr/bin/env python3
"""Time one hand-written kernel body of one package tree on the card.

    python3 kernel_bench.py segmin|kbest ROOT [SHAPE ...]

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

Prints the card and one JSON line of mean milliseconds by shape.
"""

from __future__ import annotations

import json
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


def main() -> int:
    if len(sys.argv) < 3 or sys.argv[1] not in ("segmin", "kbest"):
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
    cuda_build.kernel("knn_kbest" if kernel == "kbest" else "segmin")

    def timed(shapes):
        return {name: ms(fn, reps) for name, (fn, reps) in shapes.items()
                if not keep or any(s in name for s in keep)}

    data = Data()
    result = {"root": root, "kernel": kernel}
    if kernel == "segmin":
        result["ms"] = timed(segmin_shapes(data))
    else:
        result["ms"] = timed(kbest_shapes(data))
        result["two_library_calls_other_rounding_and_tie_order_ms"] = timed(
            kbest_yardstick(data))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
