#!/usr/bin/env python3
"""Readings that set a cell's limits, outside the measured window.

    python3 portbench/control.py --workload hepmass28.fit --seeds 1,2,3 --side control --precision tf32
    python3 portbench/control.py --workload hepmass28.fit --seeds 1,2,3 --side program

``--side program`` prints, a seed, the cell's numbers for the program's
answer on that seed's data (the lower reading); ``--side control`` the
numbers of the reference computed in ``--precision`` put in the program's
place (the upper reading), as the cell's kind (``kinds/<kind>.py``)
reads them: a fit kind the fit of the seed's first data copy, a serving
kind the served fit and ``--rows`` seeded query rows. One JSON line a seed
on standard output.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def readings(cell: dict, seed: int, side: str, precision: str, devices, rows: int) -> dict:
    """The cell's numbers on ``seed``, from its kind's ``readings``."""
    from portbench import spec

    kind = spec.kind(cell["traffic"]["kind"], cell["base"])
    return kind.readings(cell, seed, side, precision, devices, rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--side", choices=("program", "control"), required=True)
    ap.add_argument("--precision", default="tf32", choices=("tf32", "bf16"))
    ap.add_argument("--rows", type=int, default=5000)
    args = ap.parse_args()
    import torch

    from portbench import spec

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.cell(args.workload)
    devices = [torch.device("cuda", i) for i in range(cell["entry"]["chips"])]
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        numbers = readings(cell, seed, args.side, args.precision, devices, args.rows)
        print(json.dumps({"workload": args.workload, "seed": seed, "side": args.side,
                          "precision": args.precision if args.side == "control" else "f32",
                          "numbers": numbers, "seconds": time.perf_counter() - t}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
