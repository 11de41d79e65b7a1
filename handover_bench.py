#!/usr/bin/env python3
"""Time the cross-rank hand-overs of ``parallel/mesh`` on this host's cards.

    python3 handover_bench.py [--ranks N] [--device cpu|shared|cards] [--reps R]

Starts N rank processes (default 4) wired by ``parallel/distributed`` on a
local coordinator, each with one shard: ``cards`` (the default) puts rank r
on ``cuda:r`` (NCCL by the backend rule), ``shared`` every rank on
``cuda:0`` (gloo) and ``cpu`` every rank on the CPU (gloo). Every rank
then times, at panels of 1,024 and 262,144 rows x 4 float32 (16 KiB and 4
MiB):

- ``ring``: a ring sweep of ``parallel/mesh.ring_shift`` (N - 1 steps),
  split per step into the host wall of ``batch_isend_irecv`` (``post``),
  of its works' ``wait`` (``wait``) and of a device synchronisation after
  it (``sync``), as ``ring_shift`` issues them;
- ``pairs``: the same steps as separate ``isend``/``irecv`` calls (a rank
  sends first when its destination's rank is higher, else receives
  first), each waited and synchronised;
- ``all_reduce``: ``parallel/mesh.all_reduce`` (MIN) of the panel.

Each is run once to warm (communicators, connections), then ``--reps``
times (default 10); a rank prints one JSON line of mean milliseconds a
step (a call for the all-reduce). The launcher prints the card's name and
power limit first and exits nonzero when a rank fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SIZES = (1024, 262144)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rank_main(rank: int, n: int, port: int, device: str, reps: int) -> int:
    import torch
    import torch.distributed as dist

    from hdbscan_tpu_torch.parallel import distributed
    from hdbscan_tpu_torch.parallel import mesh as mesh_mod

    distributed.initialize_from_cluster_name(f"127.0.0.1:{port},{rank},{n}", devices=[device],
                                             timeout_s=60)
    mesh = mesh_mod.get_mesh([device])
    dev, group = mesh.devices[rank], mesh.group
    out = {"rank": rank, "backend": mesh.backend, "device": str(dev)}
    try:
        for rows in SIZES:
            x = torch.randn(rows, 4, device=dev)
            counts = [rows] * n
            wire = mesh_mod._wire_device(mesh)

            def batched(step):
                dst, src = (rank + step) % n, (rank - step) % n
                b = torch.empty(rows, 4, device=wire)
                ops = [dist.P2POp(dist.isend, mesh_mod._wire(x, mesh), dst, group=group),
                       dist.P2POp(dist.irecv, b, src, group=group)]
                t0 = time.perf_counter()
                works = dist.batch_isend_irecv(ops)
                t1 = time.perf_counter()
                for w in works:
                    w.wait()
                t2 = time.perf_counter()
                _sync(dev)
                return t1 - t0, t2 - t1, time.perf_counter() - t2

            def pairs(step):
                dst, src = (rank + step) % n, (rank - step) % n
                b = torch.empty(rows, 4, device=wire)
                w = mesh_mod._wire(x, mesh)
                t0 = time.perf_counter()
                first, second = ((lambda: dist.isend(w, dst, group=group)),
                                 (lambda: dist.irecv(b, src, group=group)))
                if rank > dst:  # the lower rank of a pair sends first: no cycle
                    first, second = second, first
                works = [first(), second()]
                for wk in works:
                    wk.wait()
                _sync(dev)
                return time.perf_counter() - t0

            def sweep():
                t0 = time.perf_counter()
                for step in range(n):
                    mesh_mod.ring_shift(mesh, {rank: (x,)}, step, counts)
                _sync(dev)
                return time.perf_counter() - t0

            def reduce():
                t0 = time.perf_counter()
                mesh_mod.all_reduce(x, mesh, op="min")
                _sync(dev)
                return time.perf_counter() - t0

            steps = range(1, n)
            for step in steps:  # warm: communicators and connections
                batched(step)
                pairs(step)
            sweep()
            reduce()
            split = [batched(s) for _ in range(reps) for s in steps]
            per = len(split)
            out[f"ring_{rows}"] = {k: round(sum(p[i] for p in split) / per * 1e3, 4)
                                   for i, k in enumerate(("post", "wait", "sync"))}
            out[f"pairs_{rows}"] = round(sum(pairs(s) for _ in range(reps) for s in steps)
                                         / per * 1e3, 4)
            out[f"ring_shift_{rows}"] = round(sum(sweep() for _ in range(reps))
                                              / per * 1e3, 4)
            out[f"all_reduce_{rows}"] = round(sum(reduce() for _ in range(reps)) / reps * 1e3, 4)
        print(json.dumps(out), flush=True)
    finally:
        distributed.shutdown()
    return 0


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--rank"]:
        rank, n, port, device, reps = args[1:6]
        return rank_main(int(rank), int(n), int(port), device, int(reps))
    opts = dict(zip(args[::2], args[1::2]))
    if len(args) % 2 or set(opts) - {"--ranks", "--device", "--reps"}:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    n, mode, reps = int(opts.get("--ranks", 4)), opts.get("--device", "cards"), \
        int(opts.get("--reps", 10))
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from hdbscan_tpu_torch.parallel.distributed import (
        communicate_all,
        free_local_port,
        hermetic_child_env,
    )

    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        print(card.stdout.strip().splitlines()[0] if card.returncode == 0 else "no card")
    except FileNotFoundError:
        print("no card")
    devices = {"cards": [f"cuda:{r}" for r in range(n)], "shared": ["cuda:0"] * n,
               "cpu": ["cpu"] * n}[mode]
    port = free_local_port()
    env = hermetic_child_env(here, cpu=mode == "cpu")
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), str(n), str(port),
                               devices[r], str(reps)], cwd=here, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    outs = communicate_all(procs, timeout=300)
    rc = 0
    for p, (so, se) in zip(procs, outs):
        print(so.strip() or f"rank failed (exit {p.returncode}): {se[-1500:]}")
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
