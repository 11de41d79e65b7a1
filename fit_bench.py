#!/usr/bin/env python3
"""Time the port's fits of one package tree on the card.

    python3 fit_bench.py ROOT [CELL ...]
    (CELL: 3d 3e 3e_local dense skin skin_sharded; default all six)

ROOT is a directory holding ``hdbscan_tpu_torch/``: the checkout (``.``), or
an earlier commit unpacked with ``git archive`` into a git-ignored directory,
so that two versions are timed on one card in one call (run them in turns:
earlier, this, this, earlier). The cells are ``chip_smoke.py``'s fits:

- ``3d``: MR in boundary mode (block cores from each block's dense matrix,
  ``parallel/blocks.block_mst_batch``) on ``make_gauss(1,000,000, dims=10,
  n_clusters=30, separation=9.0, seed=2)``, min_points=8,
  min_cluster_size=5,000, processing_units=16,384, k=0.01, seed 0,
  boundary_quality=0.05, knn_backend=fused; one fit;
- ``3e``: MR in the default mode (global core distances, so the blocks take
  ``block_mst_batch_with_core``) on 200,000 points of the same generator,
  min_cluster_size=1,000; three fits;
- ``3e_local``: ``3e`` with global_cores=false (the blocks compute their
  own cores: ``block_mst_batch``); three fits;
- ``dense``: the dense single-block fit (``models/hdbscan.fit``) on the
  first 30,000 rows of ``chip_smoke.py``'s seeded Skin-shaped set (245,057 x
  3 integers in [0, 255]), min_points=16, min_cluster_size=367; three fits;
- ``skin``: the exact fit's device route (``models/exact.fit``) on the whole
  Skin-shaped set, min_points=16, min_cluster_size=3,000; five fits;
- ``skin_sharded``: the same fit with fit_sharding=sharded on four shards
  of the first card (``parallel/shard.shard_boruvka_mst``); five fits.

Before the cells one 20,000-point MR fit warms the kernels and the
allocator. Each fit is timed on the host clock around a device
synchronisation; ``block_fit_s`` sums the fit's ``block_fit`` events (the
block programs), ``block_edges_s`` the dense fit's ``block_edges``,
``rounds_s`` an exact fit's Borůvka rounds (``boruvka_mst`` ``rounds_wall_s``)
and ``finalize_s`` its host finalize (the ``tree_*`` events).
Prints the card and one JSON line of the seconds of every fit by cell.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

MR_DATA = dict(dims=10, n_clusters=30, separation=9.0, seed=2)
MR_PARAMS = dict(min_points=8, processing_units=16384, k=0.01, seed=0)
CELLS = ("3d", "3e", "3e_local", "dense", "skin", "skin_sharded")


def main() -> int:
    if len(sys.argv) < 2 or any(c not in CELLS for c in sys.argv[2:]):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    root, cells = sys.argv[1], sys.argv[2:] or list(CELLS)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fit_bench: no CUDA device", file=sys.stderr)
        return 1
    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.models import exact, hdbscan, mr_hdbscan
    from hdbscan_tpu_torch.parallel.mesh import get_mesh
    from hdbscan_tpu_torch.utils.datasets import make_gauss

    def timed(fit, data, params):
        events = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        fit(data, params, trace=lambda stage, **kw: events.append((stage, kw)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        stage_s = {s: round(sum(kw.get("wall_s", 0.0) for st, kw in events if st == s), 6)
                   for s in ("block_fit", "block_edges")}
        rounds = [kw.get("rounds_wall_s", 0.0) for st, kw in events if st == "boruvka_mst"]
        return {"wall_s": round(wall, 6), "block_fit_s": stage_s["block_fit"],
                "block_edges_s": stage_s["block_edges"], "rounds_s": sum(rounds),
                "finalize_s": round(sum(kw.get("wall_s", 0.0) for st, kw in events
                                        if st.startswith("tree_")), 6)}

    warm, _ = make_gauss(20_000, **MR_DATA)
    mr_hdbscan.fit(warm, HDBSCANParams(**dict(MR_PARAMS, processing_units=4096),
                                       min_cluster_size=100))
    result = {"root": root}
    for cell in cells:
        if cell == "3d":
            data, _ = make_gauss(1_000_000, **MR_DATA)
            params = HDBSCANParams(**MR_PARAMS, min_cluster_size=5000, boundary_quality=0.05,
                                   knn_backend="fused")
            runs = [timed(mr_hdbscan.fit, data, params)]
        elif cell in ("3e", "3e_local"):
            data, _ = make_gauss(200_000, **MR_DATA)
            params = HDBSCANParams(**MR_PARAMS, min_cluster_size=1000,
                                   global_core_distances=cell == "3e")
            runs = [timed(mr_hdbscan.fit, data, params) for _ in range(3)]
        elif cell == "dense":
            skin = np.random.default_rng(0).integers(0, 256, size=(245_057, 3))
            data = skin[:30_000].astype(np.float64)
            params = HDBSCANParams(min_points=16, min_cluster_size=367,
                                   processing_units=30_000)
            runs = [timed(hdbscan.fit, data, params) for _ in range(3)]
        else:
            data = np.random.default_rng(0).integers(0, 256, size=(245_057, 3)).astype(float)
            params = HDBSCANParams(min_points=16, min_cluster_size=3000)
            fit = exact.fit
            if cell == "skin_sharded":
                params = params.replace(fit_sharding="sharded", mst_backend="device")
                mesh = get_mesh([torch.device("cuda", 0)] * 4)

                def fit(data, params, trace):
                    return exact.fit(data, params, mesh=mesh, trace=trace)
            runs = [timed(fit, data, params) for _ in range(5)]
        result[cell] = runs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}; torch {torch.__version__}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
