#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload skin.fit --seed 7 --seconds 45 --trace 0

Run from the root of a checkout that holds ``hdbscan_tpu_torch`` and
``BENCHMARK.json``. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and ``checks``, the numbers compared with
their limits, last); the same checks are the last lines of standard error.
Exits non-zero, printing no result, without as many CUDA cards as the cell
takes, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, ".torch_build")
# Every build and kernel cache inside the checkout, at fixed paths.
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "extensions")
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness, spec

    cell = spec.cell(args.workload)
    import torch

    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell takes {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    devices = [torch.device("cuda", i) for i in range(chips)]
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), devices, T_START)
    banned = harness.banned_modules()
    if banned:
        print(f"portbench: modules loaded that may not be: {banned}", file=sys.stderr)
        return 2
    sys.stdout.flush()
    print(json.dumps(harness.finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
