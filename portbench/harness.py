"""One run of one cell: set-up, the measured window, the check, the result.

The cell's traffic names its loop (``kinds/<kind>.py``). With ``trace`` the
window runs under ``torch.profiler`` and each per-layer metric's own
recorder, for at most the traffic's ``trace_seconds``, and the result
carries the cell's per-layer metrics instead of its end-to-end ones, read
by ``metrics/<name>.py`` from the profile, the recorders and the loop's
``context()``.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np

from portbench import compare, profile as profread, recorder, spec

#: Modules that may not be loaded when the result is printed (whole
#: top-level names: the port's own name starts with the JAX package's).
BANNED = ("jax", "jaxlib", "flax", "hdbscan_tpu")


def banned_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(BANNED))


def process_start() -> float | None:
    """Seconds since this process started, from ``/proc`` (None elsewhere)."""
    import os

    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def device_info(devices, peak: int) -> dict:
    import torch

    kind = torch.cuda.get_device_name(devices[0]) if devices[0].type == "cuda" else "cpu"
    return {"platform": "gpu" if devices[0].type == "cuda" else "cpu", "kind": kind,
            "count": len(devices), "memory_peak_bytes": int(peak)}


def _peak(devices) -> int:
    import torch

    return max((torch.cuda.max_memory_allocated(d) for d in devices if d.type == "cuda"),
               default=0)


def traced_window(loop, cell: dict, seconds: float) -> tuple[dict, dict, dict]:
    """The window under the profiler, the loop's host phases named and
    every per-layer metric's own recorder around it; (window numbers,
    {metric name: what its recorder kept}, the profile's numbers)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    seconds = min(seconds, cell["traffic"]["trace_seconds"])
    cuda = torch.cuda.is_available() and any(d.type == "cuda" for d in loop.devices)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with contextlib.ExitStack() as stack:
        recorded = {}
        for m in cell["per_layer"]:
            reader = spec.metric(m["name"], cell["base"])
            if hasattr(reader, "record"):
                recorded[m["name"]] = stack.enter_context(reader.record())
        stack.enter_context(recorder.Spans(loop.SPANS))
        prof = stack.enter_context(profile(activities=acts))
        with record_function(profread.WINDOW):
            out = loop.window(seconds, traced=True)
            loop.sync()
    labels = {label for _, _, label in loop.SPANS}
    return out, recorded, profread.read(prof, labels, expect_device=cuda)


def per_layer(cell: dict, loop, recorded: dict, prof: dict) -> dict:
    """{name: {"value", "unit"}} of the cell's per-layer metrics that found
    something to read."""
    ctx = dict(loop.context(), profile=prof)
    metrics = {}
    for m in cell["per_layer"]:
        value = spec.metric(m["name"], cell["base"]).read(
            dict(ctx, recorded=recorded.get(m["name"])))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def run(cell: dict, seed: int, seconds: float, trace: bool, devices: list,
        t_start: float) -> dict:
    """One run; returns the result object (``checks`` last) and prints the
    compared numbers beside their limits as the last lines of stderr."""
    import torch

    loop = spec.kind(cell["traffic"]["kind"], cell["base"]).Loop(cell, seed, devices)
    for d in devices:
        if d.type == "cuda":
            torch.zeros(1, device=d)  # the context and allocator exist before the reset
            torch.cuda.reset_peak_memory_stats(d)
    loop.setup()
    setup_s = process_start() or (time.perf_counter() - t_start)
    if trace:
        out, recorded, prof = traced_window(loop, cell, seconds)
    else:
        out = loop.window(seconds)
    peak = _peak(devices)
    if trace:
        metrics = per_layer(cell, loop, recorded, prof)
        del recorded
    else:
        values = dict(out["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    loop.release()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()
    for line in loop.notes():
        print(line, file=sys.stderr)
    t_check = time.perf_counter()
    numbers = loop.check(cell["limits"])
    print(f"portbench: setup {setup_s:.3f} s, window {loop.window_s:.3f} s, "
          f"check {time.perf_counter() - t_check:.3f} s "
          f"(reference {loop.ref_seconds})", file=sys.stderr)
    ok, checks = compare.judge(numbers, cell["limits"])
    correct = bool(ok and out["failed"] == 0)
    device = device_info(devices, peak)
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if trace:
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    return result


def finite(obj):
    """The result with every float that is not finite written as a string
    (JSON has no infinity)."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    if isinstance(obj, (float, np.floating)):
        return float(obj) if np.isfinite(obj) else str(float(obj))
    if isinstance(obj, np.integer):
        return int(obj)
    return obj
