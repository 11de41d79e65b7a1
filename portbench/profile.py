"""Reading a ``torch.profiler`` trace of the measured window.

The harness opens a profiler around the traced window and marks the window
itself with ``record_function("portbench.window")``; host phases carry the
labels of ``recorder.Spans``. From the profile this module takes, per card,
the union of the intervals in which a kernel, copy or set ran (busy), the
device time of kernels by name, and the device's idle time split by the
innermost labelled host phase over it.
"""

from __future__ import annotations

import re

WINDOW = "portbench.window"


def _short(name: str) -> str:
    """A kernel's name without its template arguments and signature."""
    name = re.sub(r"^void ", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def _events(prof, expect_device: bool) -> tuple[list, list]:
    """(device events [(device, start_us, end_us, name)], host events
    [(start_us, end_us, name)]) of a finished profile, from ``events()``.
    Raises where ``expect_device`` and the profile holds no device event."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            dev.append((int(e.device_index), e.time_range.start, e.time_range.end, e.name))
        elif e.device_type != DeviceType.CUDA:
            host.append((e.time_range.start, e.time_range.end, e.name))
    if expect_device and not dev:
        raise RuntimeError("the profile of the window holds no device event")
    return dev, host


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _segments(spans: list) -> list:
    """Disjoint (start, end, label) pieces of the labelled host spans, each
    piece under the shortest span active over it (the innermost phase)."""
    points = sorted({x for a, b, _ in spans for x in (a, b)})
    if not points:
        return []
    import bisect

    best: list = [None] * (len(points) - 1)
    for a, b, name in sorted(spans, key=lambda s: s[0] - s[1]):  # longest first
        for i in range(bisect.bisect_left(points, a), bisect.bisect_left(points, b)):
            best[i] = name
    return [(points[i], points[i + 1], n) for i, n in enumerate(best) if n is not None]


def device_s(profile: dict, *parts: str) -> float:
    """Device seconds of the window's operations whose name contains any
    of ``parts``."""
    return sum(s for name, s in profile["op_s"].items() if any(p in name for p in parts))


def read(prof, labels: set, expect_device: bool) -> dict:
    """The window's numbers: ``window_s``; ``busy_s`` (mean over the cards
    that ran anything); ``idle_share`` by card; ``op_s`` {name: device
    seconds} of every device operation, named without template arguments
    (:func:`device_s` sums them by name); ``device_ops`` and ``idle_gaps``
    (top 10 [name, seconds], the gaps by the innermost labelled host phase
    over them)."""
    dev, host = _events(prof, expect_device)
    wins = [(a, b) for a, b, name in host if name == WINDOW]
    if not wins:
        raise RuntimeError("the traced window's marker is not in the profile")
    w0, w1 = wins[0]
    window_s = (w1 - w0) / 1e6
    by_dev: dict = {}
    op_s: dict = {}
    for d, a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        by_dev.setdefault(d, []).append((a, b))
        short = _short(name)
        op_s[short] = op_s.get(short, 0.0) + (b - a) / 1e6
    busy = {d: sum(b - a for a, b in _union(iv)) / 1e6 for d, iv in by_dev.items()}
    segs = _segments([(a, b, name) for a, b, name in host if name in labels])
    gaps_by: dict = {}
    for d, iv in by_dev.items():
        merged = _union(iv)
        edges = [w0] + [x for ab in merged for x in ab] + [w1]
        k = 0
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            while k < len(segs) and segs[k][1] <= a:
                k += 1
            covered = 0.0
            j = k
            while j < len(segs) and segs[j][0] < b:
                ov = min(b, segs[j][1]) - max(a, segs[j][0])
                if ov > 0:
                    gaps_by[segs[j][2]] = gaps_by.get(segs[j][2], 0.0) + ov / 1e6 / len(by_dev)
                    covered += ov
                j += 1
            rest = (b - a) - covered
            if rest > 0:
                gaps_by["no host phase"] = gaps_by.get("no host phase", 0.0) + \
                    rest / 1e6 / len(by_dev)
    top = sorted(op_s.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(gaps_by.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": window_s,
        "busy_s": sum(busy.values()) / len(busy) if busy else 0.0,
        "idle_share": {d: 100.0 * (1.0 - s / window_s) for d, s in busy.items()},
        "op_s": op_s,
        "device_ops": [[k, v] for k, v in top],
        "idle_gaps": [[k, v] for k, v in gaps],
    }
