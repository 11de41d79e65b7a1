#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build every CUDA kernel of the port from ``hdbscan_tpu_torch/csrc`` (one
   ``nvcc`` per source, started together) and print the card and its
   power limit;
2. hold each kernel against its plain PyTorch version on the card, bitwise
   (tolerance 0: the kernels are built with ``-fmad=false`` and repeat the
   plain versions' operation order): the segment-min (K1) and k-best (K2)
   kernels at 16,384 x 3 integer-grid points in both euclidean forms (K2 at
   min_pts 2, 16 and 129, i.e. k = 1, 15, 128) and at 8,192 x 7 continuous
   points, the union-find scan (K3) on a 16k-edge pool;
3. run the exact fit (``hdbscan_tpu_torch.models.exact.fit``) on a seeded
   Skin-shaped set — 245,057 x 3 integer RGB values in [0, 255] — with
   min_points=16, min_cluster_size=3000: first check that the fit on the
   card equals the fit on the CPU (plain versions) on a 4,096-point subset,
   then run the full fit with the launch counters zeroed just before and
   read just after; check n - 1 MST edges under the round cap, finite core
   distances, and that every kernel ran;
4. time each kernel at the fit's shapes with CUDA events beside its plain
   version and its bound (the larger of bytes over the memory rate and
   float operations over the FP32 rate of an H100 SXM: 3.35 TB/s, 67
   TFLOP/s).

The second line before the last is the card's name and power limit, the
line before the last the ``kernels`` JSON, the last line the device JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

N_SKIN = 245_057
MIN_PTS = 16
MIN_CL_SIZE = 3000
SEED = 0
H100_BYTES_PER_S = 3.35e12
H100_FP32_PER_S = 67e12


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs after one warm run."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_FP32_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def pair_ops(d: int, form: str) -> int:
    """Float operations of one pair distance: diff form d sub + d mul +
    (d - 1) add + sqrt; dot form d mul + (d - 1) add + 3 (norm sums,
    doubling, subtract) + max + sqrt."""
    return 3 * d if form == "diff" else 2 * d + 4


def parity() -> list[str]:
    """Kernel vs plain version on the card; returns failure messages."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.core import mst_device
    from hdbscan_tpu_torch.ops import cuda_knn, cuda_segmin, tiled

    errors = []
    print("kernel vs plain version on the card, tolerance 0 (bitwise):")
    rng = np.random.default_rng(SEED)
    cases = [
        ("grid 16384x3", rng.integers(0, 256, size=(16384, 3)).astype(np.float32)),
        ("continuous 8192x7", rng.normal(size=(8192, 7)).astype(np.float32)),
    ]
    for label, x in cases:
        n = len(x)
        xg = torch.as_tensor(x, device="cuda")
        core = torch.as_tensor(rng.integers(0, 40, n).astype(np.float32), device="cuda")
        comp = torch.as_tensor(rng.integers(0, 64, n).astype(np.int32), device="cuda")
        valid = torch.as_tensor(rng.random(n) < 0.97, device="cuda")
        for form in ("diff", "dot"):
            for min_pts in (2, 16, 129):
                k = max(min_pts - 1, 1)
                a = cuda_knn.knn_kbest(xg, k, "euclidean", form)
                torch.cuda.synchronize()
                b = cuda_knn.knn_kbest_plain(xg, k, "euclidean", form)
                ok = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                print(f"parity K2 knn_kbest {label} {form} k={k}: {'bitwise' if ok else 'MISMATCH'}")
                if not ok:
                    errors.append(f"K2 {label} {form} k={k}")
            a = cuda_segmin.segmin(xg, core, comp, valid, "euclidean", form)
            torch.cuda.synchronize()
            b = tiled._min_outgoing_scan(xg, core, comp, valid, "euclidean", form)
            ok = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            print(f"parity K1 segmin {label} {form}: {'bitwise' if ok else 'MISMATCH'}")
            if not ok:
                errors.append(f"K1 {label} {form}")
    m, n = 16384, 8192
    su = torch.as_tensor(rng.integers(0, n, m).astype(np.int32), device="cuda")
    sv = torch.as_tensor(rng.integers(0, n, m).astype(np.int32), device="cuda")
    a = mst_device.uf_scan(su, sv, n)
    torch.cuda.synchronize()
    b = mst_device.uf_scan_plain(su, sv, n)
    ok = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    print(f"parity K3 uf_scan {m} edges: {'bitwise' if ok else 'MISMATCH'}")
    if not ok:
        errors.append("K3")
    return errors


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "hdbscan_tpu_torch")):
        return fail("hdbscan_tpu_torch/ is not beside chip_smoke.py")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    sys.path.insert(0, here)
    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.core import mst_device
    from hdbscan_tpu_torch.models import exact
    from hdbscan_tpu_torch.ops import cuda_build, cuda_knn, cuda_segmin, tiled

    card = gpu_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t = time.perf_counter()
    cuda_build.build_all()
    print(f"kernel build: {time.perf_counter() - t:.1f} s")

    errors = parity()
    if errors:
        return fail(f"kernel/plain mismatches: {errors}")

    # --- the slice: the exact fit at Skin scale ---------------------------
    rng = np.random.default_rng(SEED)
    data = rng.integers(0, 256, size=(N_SKIN, 3)).astype(np.float64)
    params = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=MIN_CL_SIZE)
    # The card's fit equals the plain versions' fit on a subset (this also
    # warms PyTorch's own CUDA kernels before the timed fit).
    sub = data[rng.choice(N_SKIN, 4096, replace=False)]
    small = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=50)
    a = exact.fit(sub, small)
    b = exact.fit(sub, small, device="cpu")
    same = (
        np.array_equal(a.labels, b.labels)
        and np.array_equal(a.core_distances, b.core_distances)
        and all(np.array_equal(x, y) for x, y in zip(a.mst, b.mst))
        and np.array_equal(a.outlier_scores, b.outlier_scores)
    )
    print(f"card fit vs CPU fit on 4096 points: {'identical' if same else 'DIFFERENT'}")
    if not same:
        return fail("the card's fit differs from the plain versions' fit")

    events = []
    cuda_build.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = exact.fit(data, params, trace=lambda stage, **kw: events.append((stage, kw)))
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t
    launches = dict(cuda_build.LAUNCHES)
    ev = {}
    for stage, kw in events:
        ev.setdefault(stage, []).append(kw)
    mst = ev["boruvka_mst"][0]
    finalize_s = sum(e[0]["wall_s"] for s, e in ev.items() if s.startswith("tree_"))
    print(
        "fit walls (s): "
        f"core_distances {ev['core_distances'][0]['wall_s']}, "
        f"boruvka_rounds {mst['rounds_wall_s']}, "
        f"forest_events {ev['forest_events'][0]['wall_s']}, "
        f"fetch {ev['host_sync'][0]['wall_s']}, "
        f"host_finalize {finalize_s:.6f}, total {fit_wall:.3f}"
    )
    print(f"rounds {mst['rounds']}, round_syncs {mst['round_syncs']}, edges {mst['edges']}, "
          f"components per round {[e['components'] for e in ev['mst_round']]}")
    counts = np.bincount(res.labels)
    print(f"labels: {len(counts) - 1} clusters, histogram (label 0 = noise) "
          f"{dict((int(i), int(c)) for i, c in enumerate(counts) if c)}")
    print(f"launches on the fit: {launches}")
    u, v, w = res.mst
    if mst["edges"] != N_SKIN - 1 or len(u) != N_SKIN - 1:
        return fail(f"MST has {len(u)} edges, expected {N_SKIN - 1}")
    if mst["rounds"] >= mst_device.DEFAULT_MAX_ROUNDS:
        return fail(f"Borůvka hit the round cap ({mst['rounds']})")
    if not (np.all(np.isfinite(res.core_distances)) and np.all(np.isfinite(w))):
        return fail("non-finite core distances or MST weights")
    if res.labels.shape != (N_SKIN,) or res.outlier_scores.shape != (N_SKIN,):
        return fail("result arrays have the wrong shape")
    if any(c == 0 for c in launches.values()):
        return fail(f"a kernel of the path never launched: {launches}")

    # --- kernel times at the fit's shapes ---------------------------------
    n, d, k = N_SKIN, 3, MIN_PTS - 1
    form = tiled.scan_form(n, d, "euclidean", 1024, 8192)
    x = torch.as_tensor(data.astype(np.float32), device="cuda")
    core = torch.as_tensor(res.core_distances.astype(np.float32), device="cuda")
    comp = torch.arange(n, dtype=torch.int32, device="cuda")  # round 1
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    rows = []

    knn_ms = cuda_ms(lambda: cuda_knn.knn_kbest(x, k, "euclidean", form), 3)
    knn_plain = host_ms(lambda: cuda_knn.knn_kbest_plain(x, k, "euclidean", form))
    kd, ki = cuda_knn.knn_kbest(x, k, "euclidean", form)
    pd, pi = cuda_knn.knn_kbest_plain(x, k, "euclidean", form)
    knn_err = float((kd - pd).abs().max()) if torch.equal(ki, pi) else float("inf")
    b, by = bound_ms(n * d * 4 + n * k * 8, float(n) * n * pair_ops(d, form))
    rows.append(dict(
        name="knn_kbest", route="cuda", source="hdbscan_tpu_torch/csrc/knn_kbest.cu",
        replaces="hdbscan_tpu/ops/pallas_knn.py:453", launches=launches["knn_kbest"],
        max_abs_err=knn_err, ms=knn_ms, plain_ms=knn_plain, bound_ms=b, bound_by=by,
        library_ms=None,
    ))

    seg_ms = cuda_ms(lambda: cuda_segmin.segmin(x, core, comp, valid, "euclidean", form), 3)
    seg_plain = host_ms(lambda: tiled._min_outgoing_scan(x, core, comp, valid, "euclidean", form))
    sw, sj = cuda_segmin.segmin(x, core, comp, valid, "euclidean", form)
    pw, pj = tiled._min_outgoing_scan(x, core, comp, valid, "euclidean", form)
    seg_err = float((sw - pw).abs().max()) if torch.equal(sj, pj) else float("inf")
    pairs = float(n) * (n - 1)  # round 1: every pair but self crosses components
    b, by = bound_ms(n * (d * 4 + 4 + 4 + 1) + n * 8, pairs * (pair_ops(d, form) + 2))
    rows.append(dict(
        name="segmin", route="cuda", source="hdbscan_tpu_torch/csrc/segmin.cu",
        replaces="hdbscan_tpu/ops/pallas_segmin.py:79", launches=launches["segmin"],
        max_abs_err=seg_err, ms=seg_ms, plain_ms=seg_plain, bound_ms=b, bound_by=by,
        library_ms=None,
    ))

    order = np.lexsort((v, u, w))  # the (w, u, v) order the fit scans in
    eu = torch.as_tensor(u[order].astype(np.int32), device="cuda")
    evv = torch.as_tensor(v[order].astype(np.int32), device="cuda")
    uf_ms = cuda_ms(lambda: mst_device.uf_scan(eu, evv, n), 3)
    uf_plain = host_ms(lambda: mst_device.uf_scan_plain(eu, evv, n))
    ra, rb = mst_device.uf_scan(eu, evv, n)
    qa, qb = mst_device.uf_scan_plain(eu, evv, n)
    uf_err = 0.0 if torch.equal(ra, qa) and torch.equal(rb, qb) else float("inf")
    m = len(u)
    b, by = bound_ms(m * 4 * 4, 0.0)  # read u, v; write ra, rb
    rows.append(dict(
        name="uf_scan", route="cuda", source="hdbscan_tpu_torch/csrc/uf_scan.cu",
        replaces="hdbscan_tpu/core/mst_device.py:177 (lax.scan, not a Pallas kernel)",
        launches=launches["uf_scan"], max_abs_err=uf_err, ms=uf_ms, plain_ms=uf_plain,
        bound_ms=b, bound_by=by, library_ms=None,
    ))
    bad = [r["name"] for r in rows if r["max_abs_err"] != 0.0]
    if bad:
        return fail(f"kernels disagree with their plain versions at the fit's shapes: {bad}")

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
