"""Per-device phase timelines: comm/compute/host attribution and stragglers
— the port of ``hdbscan_tpu/obs/timeline.py``.

Every sharded or ring round (``parallel/ring.py``, ``parallel/shard.py``,
``core/mst_device.py``) reports its measured per-device walls here through
the one seam ``parallel/ring._emit_ring_trace`` (or its in-program twin
``_emit_modeled_rounds``), and the recorder decomposes each device's round
into three telescoping segments:

- ``host_s`` — the measured host segments bracketing the round (operand
  upload + result fetch). These serialise every device, so the same
  measured value lands on each device's row.
- ``comm_s`` — the panel hand-over share of the device wall, attributed
  from the bytes the device moved around the ring.
- ``compute_s`` — the remainder of the device wall (local panel scans).

A single-controller mesh has no per-device hardware profile, so the
comm/compute split is a *cost-model attribution* of the measured wall
(``attribution: "model"`` rides every event): the model times
``comm_bytes / MODEL_COMM_BYTES_S`` against ``flops / PEAK_FLOPS`` set
only the ratio; the measured wall sets the total. Every consumer
(``scripts/check_trace.py``, the tests) holds the port to

    ``compute_s + comm_s + host_s == wall_s``  (within 1e-6)

for every ``device_timeline`` event.

Shards on one card hand their panels over through the card's own memory
(``Tensor.to`` to the same device moves nothing), so there the comm share
is a model of what the same bytes would cost between cards, not a
measured transfer. ``parallel/ring._per_device_walls`` waits for shard
0's device first, and that wait covers every shard's queued work: on one
card the walls come out nearly equal and the skew near 1.

Per-round skew stats (max/median device wall) feed the straggler
detector: a device whose raw wall is ``>= skew_threshold x`` the round
median for ``straggler_rounds`` consecutive rounds is flagged — a
``straggler_flag`` trace event, one
``hdbscan_tpu_straggler_flags_total{device}`` increment per flagged
round, and the ``/healthz`` ``straggler`` block all carry it.
"""

from __future__ import annotations

import threading

__all__ = [
    "TimelineRecorder",
    "DEFAULT_SKEW_THRESHOLD",
    "DEFAULT_STRAGGLER_ROUNDS",
    "MODEL_COMM_BYTES_S",
]

#: Default straggler trip: a device at 2x the round-median wall is slow
#: enough to matter and rare enough not to false-positive on a shared-core
#: CPU mesh (config knob ``obs_skew_threshold``).
DEFAULT_SKEW_THRESHOLD = 2.0

#: Default K: consecutive flagged rounds before a straggler_flag fires
#: (config knob ``obs_straggler_rounds``).
DEFAULT_STRAGGLER_ROUNDS = 3

#: Cost-model link bandwidth for the comm share of a device wall: NVLink 4
#: on an H100 SXM, 450 GB/s a direction (NVIDIA's public spec). Only the
#: ratio against ``flops.PEAK_FLOPS`` matters — both legs scale the same
#: measured wall.
MODEL_COMM_BYTES_S = 450e9


def _split_exec(exec_s: float, comm_bytes: float, flops: float):
    """Split a measured device-exec wall into (compute_s, comm_s) by the
    cost-model ratio. ``compute_s = exec_s - comm_s`` exactly, so the two
    always telescope back to the measured wall."""
    from hdbscan_tpu_torch.utils import flops as _flops

    if exec_s <= 0.0:
        return 0.0, 0.0
    comm_t = max(float(comm_bytes), 0.0) / MODEL_COMM_BYTES_S
    comp_t = max(float(flops), 0.0) / float(_flops.PEAK_FLOPS)
    denom = comm_t + comp_t
    if denom <= 0.0:
        return exec_s, 0.0
    comm_s = exec_s * (comm_t / denom)
    return exec_s - comm_s, comm_s


def _median(values: list[float]) -> float:
    s = sorted(values)
    n = len(s)
    if n % 2:
        return s[n // 2]
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


class TimelineRecorder:
    """Accumulates per-device round timelines and detects stragglers.

    Parameters
    ----------
    skew_threshold:
        A device is flagged in a round when its raw wall is
        ``>= skew_threshold * median`` of the round's device walls
        (requires >= 2 devices and a positive median). Must be >= 1.
    straggler_rounds:
        K consecutive flagged rounds before ``straggler_flag`` fires
        (and keeps firing each further flagged round). Must be >= 1.
    straggler_counter:
        Optional metrics counter; ``inc(1.0, device=<id>)`` per flagged
        round (``hdbscan_tpu_straggler_flags_total{device}``).
    trace:
        Default ``Tracer`` for emission; ``record_round``'s ``trace=``
        argument overrides per call.
    """

    def __init__(self, skew_threshold: float = DEFAULT_SKEW_THRESHOLD,
                 straggler_rounds: int = DEFAULT_STRAGGLER_ROUNDS,
                 straggler_counter=None, trace=None):
        skew_threshold = float(skew_threshold)
        if not skew_threshold >= 1.0:
            raise ValueError(
                f"skew_threshold must be >= 1.0, got {skew_threshold!r}"
            )
        straggler_rounds = int(straggler_rounds)
        if straggler_rounds < 1:
            raise ValueError(
                f"straggler_rounds must be >= 1, got {straggler_rounds!r}"
            )
        self.skew_threshold = skew_threshold
        self.straggler_rounds = straggler_rounds
        self.straggler_counter = straggler_counter
        self.trace = trace
        self._lock = threading.Lock()
        # phase -> running totals joined by roofline.py / the report
        self._phases: dict[str, dict] = {}
        # device id -> consecutive flagged rounds / total flags fired
        self._streaks: dict[int, int] = {}
        self._flags: dict[int, int] = {}
        self._rounds = 0

    # -- recording ---------------------------------------------------------

    def record_round(self, phase: str, rnd: int, walls, *, upload_s=0.0,
                     fetch_s=0.0, comm_bytes=0, flops=0.0,
                     trace=None) -> dict | None:
        """Record one sharded/ring round and emit its timeline events.

        ``walls`` is ``[(device_id, exec_wall_s), ...]`` — each device's
        measured wall from round *dispatch* to its shard ready, the shape
        ``parallel/ring._per_device_walls`` produces. ``upload_s`` /
        ``fetch_s`` are the measured host segments bracketing the
        dispatch (operand upload before, result fetch after); a device's
        timeline wall is ``upload_s + exec + fetch_s``
        so the three segments telescope exactly. ``comm_bytes`` is the
        bytes ONE device moved over the ring this round; ``flops`` is
        the round's total FLOPs across devices. Returns the round's skew
        stats (also folded into the phase table), or None for an empty
        round.
        """
        trace = trace if trace is not None else self.trace
        walls = [(int(d), float(w)) for d, w in walls]
        if not walls:
            return None
        n_dev = len(walls)
        upload_s = max(float(upload_s), 0.0)
        fetch_s = max(float(fetch_s), 0.0)
        comm_bytes = max(int(comm_bytes), 0)
        raw = [w for _, w in walls]
        median = _median(raw)
        max_wall = max(raw)
        skew = (max_wall / median) if median > 0 else 1.0

        rows = []  # (device, wall_s, compute_s, comm_s, host_s)
        for dev, w in walls:
            # A device's round = upload (host) + exec (its measured wall
            # from dispatch) + fetch (host): the segments telescope by
            # construction, never by clamping.
            wall_d = upload_s + w + fetch_s
            host_s = upload_s + fetch_s
            comp, comm = _split_exec(w, comm_bytes, flops / n_dev)
            rows.append((dev, wall_d, comp, comm, host_s))

        flagged = []  # (device, wall, streak)
        with self._lock:
            self._rounds += 1
            for dev, w in walls:
                slow = n_dev >= 2 and median > 0 and (
                    w >= self.skew_threshold * median
                )
                streak = self._streaks.get(dev, 0) + 1 if slow else 0
                self._streaks[dev] = streak
                if streak >= self.straggler_rounds:
                    self._flags[dev] = self._flags.get(dev, 0) + 1
                    flagged.append((dev, w, streak))
            ph = self._phases.setdefault(phase, {
                "rounds": 0,
                "devices": 0,
                "wall_s": 0.0,
                "compute_s": 0.0,
                "comm_s": 0.0,
                "host_s": 0.0,
                "comm_bytes": 0,
                "flops": 0.0,
                "max_skew": 1.0,
            })
            ph["rounds"] += 1
            ph["devices"] = max(ph["devices"], n_dev)
            # Critical path: the slowest device bounds the round.
            ph["wall_s"] += max(r[1] for r in rows)
            ph["compute_s"] += sum(r[2] for r in rows) / n_dev
            ph["comm_s"] += sum(r[3] for r in rows) / n_dev
            ph["host_s"] += sum(r[4] for r in rows) / n_dev
            ph["comm_bytes"] += comm_bytes * n_dev
            ph["flops"] += max(float(flops), 0.0)
            ph["max_skew"] = max(ph["max_skew"], skew)

        counter = self.straggler_counter
        if counter is not None:
            for dev, _, _ in flagged:
                counter.inc(1.0, device=str(dev))

        if trace is not None:
            for dev, wall_d, comp, comm, host_s in rows:
                trace(
                    "device_timeline",
                    wall_s=round(wall_d, 9),
                    phase=phase,
                    round=int(rnd),
                    device=dev,
                    compute_s=round(comp, 9),
                    comm_s=round(comm, 9),
                    host_s=round(host_s, 9),
                    comm_bytes=comm_bytes,
                    attribution="model",
                )
            for dev, w, streak in flagged:
                trace(
                    "straggler_flag",
                    device=dev,
                    phase=phase,
                    round=int(rnd),
                    streak=streak,
                    wall_s=round(w, 9),
                    median_s=round(median, 9),
                    ratio=round(w / median, 6),
                    threshold=self.skew_threshold,
                )
        return {
            "skew": round(skew, 6),
            "max_wall_s": round(max_wall, 9),
            "median_wall_s": round(median, 9),
            "flagged": [dev for dev, _, _ in flagged],
        }

    def record_modeled_rounds(self, phase: str, rounds: int, walls, *,
                              upload_s=0.0, fetch_s=0.0, comm_bytes=0,
                              flops=0.0, trace=None) -> dict | None:
        """Record an in-jit multi-round program as modeled per-round rows.

        The sharded device Borůvka (``parallel/shard.shard_boruvka_mst``)
        reports one wall per device for the whole program and the round
        count the fetch landed (the reference's in-jit ``while_loop`` has
        no per-round host walls; the port keeps its shape). This splits each device's
        measured wall evenly across ``rounds`` and replays them through
        :meth:`record_round` so the ``device_timeline`` rows, phase totals
        and straggler detector see the same shape as host-stepped rounds.
        The host segments stay where they physically happened — ``upload_s``
        on round 0, ``fetch_s`` on the last — and ``comm_bytes``/``flops``
        split evenly (round 0 takes the integer remainder). The split is a
        model, same as the comm/compute attribution (``attribution:
        "model"`` already rides every row). Returns the LAST round's skew
        stats, or None for an empty program.
        """
        rounds = max(int(rounds), 1)
        walls = [(int(d), float(w) / rounds) for d, w in walls]
        comm_bytes = max(int(comm_bytes), 0)
        per_comm, rem_comm = divmod(comm_bytes, rounds)
        stats = None
        for r in range(rounds):
            stats = self.record_round(
                phase, r, walls,
                upload_s=upload_s if r == 0 else 0.0,
                fetch_s=fetch_s if r == rounds - 1 else 0.0,
                comm_bytes=per_comm + (rem_comm if r == 0 else 0),
                flops=max(float(flops), 0.0) / rounds,
                trace=trace,
            )
        return stats

    # -- reporting ---------------------------------------------------------

    def phase_table(self) -> dict[str, dict]:
        """Per-phase timeline totals with derived ``comm_frac``/``skew``
        (deep-copied; safe to serialize into the report)."""
        with self._lock:
            out = {}
            for name, ph in self._phases.items():
                total = ph["compute_s"] + ph["comm_s"] + ph["host_s"]
                out[name] = {
                    "rounds": ph["rounds"],
                    "devices": ph["devices"],
                    "wall_s": round(ph["wall_s"], 9),
                    "compute_s": round(ph["compute_s"], 9),
                    "comm_s": round(ph["comm_s"], 9),
                    "host_s": round(ph["host_s"], 9),
                    "comm_bytes": ph["comm_bytes"],
                    "flops": ph["flops"],
                    "comm_frac": (
                        round(ph["comm_s"] / total, 6) if total > 0 else 0.0
                    ),
                    "skew": round(ph["max_skew"], 6),
                }
            return out

    def state(self) -> dict:
        """Live detector state for ``/healthz`` (``straggler`` block)."""
        with self._lock:
            return {
                "skew_threshold": self.skew_threshold,
                "straggler_rounds": self.straggler_rounds,
                "rounds": self._rounds,
                "flags_total": sum(self._flags.values()),
                "flags": {str(d): n for d, n in sorted(self._flags.items())},
                "streaks": {
                    str(d): s for d, s in sorted(self._streaks.items()) if s
                },
            }
