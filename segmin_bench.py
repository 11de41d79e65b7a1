#!/usr/bin/env python3
"""Time the segment-min kernel (K1/B1 and B9) of one package tree on the card.

    python3 segmin_bench.py ROOT

ROOT is a directory holding ``hdbscan_tpu_torch/``: the checkout (``.``), or
an earlier commit unpacked with ``git archive`` into a git-ignored directory,
so that two versions are timed on one card in one call (run them in turns:
earlier, this, this, earlier). The kernel is built from ROOT's sources and
timed with CUDA events on round-1 inputs (every row its own component) at
the shapes of ``chip_smoke.py``'s cells: B1 on the Skin-shaped 245,057 x 3
grid (diff form), B9 on one 65,536 x 65,536 panel of it (the 3g fit's
shards), B1 on ``make_gauss(500,000, dims=28)`` (dot form, the 3f cell),
and B1 on 262,144 x 8 normal points. Core distances are the k-th nearest
distances from ``torch.cdist`` (inputs for timing, not the fit's bits).
Prints the card and one JSON line of mean milliseconds by shape.
"""

from __future__ import annotations

import json
import subprocess
import sys


def main() -> int:
    root = sys.argv[1]
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from hdbscan_tpu_torch.ops import cuda_build, cuda_segmin
    from hdbscan_tpu_torch.utils.datasets import make_gauss

    if not torch.cuda.is_available():
        print("segmin_bench: no CUDA device", file=sys.stderr)
        return 1
    cuda_build.kernel("segmin")

    def cores(x, k):
        out = torch.empty(len(x), device="cuda")
        for a in range(0, len(x), 2048):
            dist = torch.cdist(x[a:a + 2048], x)
            out[a:a + 2048] = torch.topk(dist, k, largest=False).values[:, -1]
        return out

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def round1(x, k):
        n = len(x)
        return (x, cores(x, k), torch.arange(n, dtype=torch.int32, device="cuda"),
                torch.ones(n, dtype=torch.bool, device="cuda"))

    rng = np.random.default_rng(0)
    times = {}
    skin = round1(torch.as_tensor(rng.integers(0, 256, size=(245_057, 3)).astype(np.float32),
                                  device="cuda"), 16)
    times["B1 245057x3 diff"] = ms(lambda: cuda_segmin.segmin(*skin, "euclidean", "diff"), 5)
    sh = 65_536
    panel = [t[:sh] for t in skin] + [t[sh:2 * sh] for t in skin]
    times["B9 65536x65536x3 diff"] = ms(
        lambda: cuda_segmin.min_outgoing_panel(*panel, "euclidean", form="diff"), 10)
    hd = make_gauss(500_000, dims=28, n_clusters=8, separation=3 * np.sqrt(28), seed=4)[0]
    highd = round1(torch.as_tensor(hd.astype(np.float32), device="cuda"), 8)
    times["B1 500000x28 dot"] = ms(lambda: cuda_segmin.segmin(*highd, "euclidean", "dot"), 3)
    blobs = round1(torch.as_tensor(rng.normal(size=(262_144, 8)).astype(np.float32),
                                   device="cuda"), 16)
    times["B1 262144x8 dot"] = ms(lambda: cuda_segmin.segmin(*blobs, "euclidean", "dot"), 3)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card)
    print(json.dumps({"root": root, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
