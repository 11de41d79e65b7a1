"""Per-phase device-memory auditor — the port of ``hdbscan_tpu/obs/audit.py``.

The :class:`MemoryAuditor` wraps every traced phase (via ``obs.mem_phase``):
it samples per-device resident bytes synchronously at phase entry and exit
and from a background thread in between, emits a ``mem_sample`` trace event
per sample and one ``mem_phase_peak`` at phase exit, and keeps a per-phase
watermark table (merged by max across repeated phases) that lands in the
run report and the flight recorder's bundles.

Sampling sources (the reference's names, which ``scripts/check_trace.py``
accepts):

- ``memory_stats``: the card's caching allocator,
  ``torch.cuda.memory_stats(i)['allocated_bytes.all.current']`` for each
  visible CUDA device, keyed ``cuda:<i>``. Allocated, not reserved, bytes:
  the allocator keeps freed blocks reserved. Reading it is host-side
  bookkeeping — the sampler thread never synchronises a stream or touches
  a tensor on the card. A sample every ``interval_s`` misses a buffer that
  lives between two samples (a dense block fit allocates and frees GiBs
  in milliseconds), so a phase also reads the allocator's own high-water
  mark (``allocated_bytes.all.peak``) at entry and exit: when it rose
  during the phase, the phase reached it, and the device's phase peak is
  that value. The peak is never reset (other readers of
  ``max_memory_allocated`` keep their window).
- ``live_arrays``: the CPU's. It walks the live ``torch.Tensor`` objects
  (``gc.get_objects()``) and counts each storage's bytes once per
  ``(device, untyped_storage().data_ptr())`` — views and aliases of one
  storage count once, as an allocator counts them (the counterpart of the
  reference's buffer-pointer dedup). It sees only tensors Python still
  references, which is the population a replicated-buffer bug lives in.

Attribution is per physical device: a mesh that names one card four times
(``--device cuda:0,cuda:0,cuda:0,cuda:0``) is one device, and the
replication gate answers ``single_device: true`` for it, as it does for a
CPU mesh.

``assert_not_replicated(n, itemsize, slack)`` is the gate: any phase where
one device's peak *above its construction-time baseline* reaches
``slack * n * itemsize`` implies an O(n) buffer was materialised whole on
that device, and the fit fails with :class:`ReplicatedBufferError`.
"""

from __future__ import annotations

import gc
import threading
import time
from collections import defaultdict
from contextlib import contextmanager


class ReplicatedBufferError(RuntimeError):
    """A single device's phase peak implies a replicated O(n) buffer."""


# The live-tensor walk and a dispatch that hands a buffer over must not
# overlap. The reference's guard exists for JAX's donated operands
# (``jax.jit(donate_argnums=...)``); PyTorch has no donation, so here the
# guard only keeps the CPU sampler's walk out of the windows the
# reference's call sites mark (``parallel/shard.py``). ``memory_stats``
# never takes it. RLock, not Lock: the main thread takes synchronous entry
# and exit samples inside its own guarded window.
_DONATION_GUARD = threading.RLock()


@contextmanager
def donation_guard():
    """Hold while dispatching a computation whose operands the reference
    donates. Excludes the live-tensor sampler thread for the duration;
    PyTorch donates nothing, so this is exclusion only."""
    with _DONATION_GUARD:
        yield


def _device_key(device) -> str:
    """``cuda:<i>`` or ``cpu:0`` for a ``torch.device``."""
    return f"{device.type}:{device.index or 0}"


def _cuda_devices() -> int:
    """Visible CUDA devices (0 without a card)."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _memory_stats_sample() -> dict[str, int] | None:
    """Per-card allocated bytes, or None without a card. Before CUDA is
    initialised the allocator has handed out nothing (``memory_stats``
    returns an empty dict): 0."""
    import torch

    n = _cuda_devices()
    if n == 0:
        return None
    return {f"cuda:{i}": int(torch.cuda.memory_stats(i).get("allocated_bytes.all.current", 0))
            for i in range(n)}


def _memory_stats_peaks() -> dict[str, int]:
    """Per-card allocator high-water marks (``allocated_bytes.all.peak``);
    empty without a card."""
    import torch

    return {f"cuda:{i}": int(torch.cuda.memory_stats(i).get("allocated_bytes.all.peak", 0))
            for i in range(_cuda_devices())}


def live_tensor_storages() -> dict[tuple[str, int], tuple[str, int]]:
    """Every live tensor's storage, once: ``{(device key, data pointer):
    (device key, storage bytes)}``. Each tensor is read inside a ``try``: a
    tensor built or freed by another thread mid-walk is skipped."""
    import torch

    tensor = torch.Tensor
    seen: dict = {}
    for obj in gc.get_objects():
        try:
            # type(), not isinstance(): isinstance reads ``__class__``,
            # which some lazy module proxies answer with a warning.
            if not issubclass(type(obj), tensor):
                continue
            storage = obj.untyped_storage()
            key = _device_key(obj.device)
            ptr = storage.data_ptr()
            if (key, ptr) not in seen:
                seen[(key, ptr)] = (key, int(storage.nbytes()))
        except Exception:
            continue
    return seen


def _live_arrays_sample() -> dict[str, int]:
    """Storage bytes of the live tensors by device (``cpu:0`` always
    present). The walk sits inside the donation guard."""
    per_dev: dict[str, int] = {"cpu:0": 0}
    per_dev.update({f"cuda:{i}": 0 for i in range(_cuda_devices())})
    with _DONATION_GUARD:
        storages = live_tensor_storages()
    for key, nbytes in storages.values():
        per_dev[key] = per_dev.get(key, 0) + nbytes
    return per_dev


def sample_per_device(source: str = "auto") -> tuple[dict[str, int], str]:
    """One sample of per-device resident bytes.

    Returns ``(per_device_bytes, source_used)`` where ``source_used`` is
    ``"memory_stats"`` or ``"live_arrays"``. ``source`` forces one
    collector; ``auto`` takes ``memory_stats`` where a card is visible.
    """
    if source not in ("auto", "memory_stats", "live_arrays"):
        raise ValueError(
            f"source must be auto|memory_stats|live_arrays, got {source!r}"
        )
    if source in ("auto", "memory_stats"):
        stats = _memory_stats_sample()
        if stats is not None:
            return stats, "memory_stats"
        if source == "memory_stats":
            raise RuntimeError(
                "memory_stats unavailable on this machine "
                "(no CUDA device: the CPU has no allocator stats); use live_arrays"
            )
    return _live_arrays_sample(), "live_arrays"


class MemoryAuditor:
    """Samples per-device memory around traced phases, keeping watermarks.

    Parameters
    ----------
    tracer:
        Optional ``Tracer``; when set, every sample emits ``mem_sample``
        and every phase exit emits ``mem_phase_peak``.
    interval_s:
        Background sampling period inside a phase. Phases shorter than
        this still get the synchronous entry/exit samples.
    source:
        ``auto`` (default) picks memory_stats where a card is visible,
        else live_arrays; tests force ``live_arrays``.
    """

    def __init__(self, tracer=None, interval_s: float = 0.05,
                 source: str = "auto"):
        if not interval_s > 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s!r}")
        if source not in ("auto", "memory_stats", "live_arrays"):
            raise ValueError(
                f"source must be auto|memory_stats|live_arrays, got {source!r}"
            )
        self.tracer = tracer
        self.interval_s = float(interval_s)
        self._source_pref = source
        self._lock = threading.Lock()
        # phase -> watermark dict (merged by max across repeated phases)
        self._watermarks: dict[str, dict] = {}
        self.baseline, self.source = sample_per_device(source)

    # -- sampling ----------------------------------------------------------

    def _sample(self, phase: str, acc: dict) -> None:
        per_dev, src = sample_per_device(self._source_pref)
        max_dev = max(per_dev.values(), default=0)
        total = sum(per_dev.values())
        with self._lock:
            acc["samples"] += 1
            acc["source"] = src
            acc["max_device_bytes"] = max(acc["max_device_bytes"], max_dev)
            acc["total_bytes"] = max(acc["total_bytes"], total)
            for key, v in per_dev.items():
                if v > acc["per_device"].get(key, -1):
                    acc["per_device"][key] = v
        if self.tracer is not None:
            self.tracer(
                "mem_sample",
                phase=phase,
                source=src,
                max_device_bytes=max_dev,
                total_bytes=total,
            )

    @contextmanager
    def phase(self, name: str):
        """Audit device memory for the duration of the block."""
        acc = {
            "samples": 0,
            "source": self.source,
            "max_device_bytes": 0,
            "total_bytes": 0,
            "per_device": defaultdict(int),
        }
        stop = threading.Event()

        def _pump():
            while not stop.wait(self.interval_s):
                try:
                    self._sample(name, acc)
                except Exception:
                    return

        t0 = time.monotonic()
        peaks_in = self._peaks()
        # Entry and exit samples are best-effort: a phase whose sampling
        # failed still lands in the watermark table as a ``sampled: false``
        # row.
        try:
            self._sample(name, acc)
        except Exception:
            pass
        pump = threading.Thread(target=_pump, name=f"mem-audit-{name}", daemon=True)
        pump.start()
        try:
            yield acc
        finally:
            stop.set()
            pump.join(timeout=5.0)
            try:
                self._sample(name, acc)
            except Exception:
                pass
            self._fold_peaks(acc, peaks_in, self._peaks())
            wall_s = time.monotonic() - t0
            self._merge_watermark(name, acc, wall_s)
            if self.tracer is not None:
                self.tracer(
                    "mem_phase_peak",
                    phase=name,
                    source=acc["source"],
                    samples=acc["samples"],
                    sampled=acc["samples"] > 0,
                    devices=len(acc["per_device"]),
                    max_device_bytes=acc["max_device_bytes"],
                    total_bytes=acc["total_bytes"],
                    wall_s=round(wall_s, 9),
                )

    def _peaks(self) -> dict[str, int]:
        """The allocator high-water marks, where the phase samples the
        allocator (``memory_stats``); empty otherwise or on failure."""
        if self.source != "memory_stats":
            return {}
        try:
            return _memory_stats_peaks()
        except Exception:
            return {}

    def _fold_peaks(self, acc: dict, before: dict, after: dict) -> None:
        """A device whose allocator high-water mark rose during the phase
        reached it during the phase: that is its phase peak."""
        with self._lock:
            for key, peak in after.items():
                if peak > before.get(key, peak) and peak > acc["per_device"].get(key, -1):
                    acc["per_device"][key] = peak
            if acc["per_device"]:
                acc["max_device_bytes"] = max(acc["max_device_bytes"],
                                              max(acc["per_device"].values()))
                acc["total_bytes"] = max(acc["total_bytes"], acc["max_device_bytes"])

    def _merge_watermark(self, name: str, acc: dict, wall_s: float) -> None:
        with self._lock:
            wm = self._watermarks.get(name)
            if wm is None:
                # ``sampled`` tells "audited and small" from "never measured".
                self._watermarks[name] = {
                    "source": acc["source"],
                    "samples": acc["samples"],
                    "sampled": acc["samples"] > 0,
                    "max_device_bytes": acc["max_device_bytes"],
                    "total_bytes": acc["total_bytes"],
                    "per_device": dict(acc["per_device"]),
                    "wall_s": round(wall_s, 9),
                }
                return
            wm["samples"] += acc["samples"]
            wm["sampled"] = bool(wm.get("sampled")) or acc["samples"] > 0
            wm["max_device_bytes"] = max(wm["max_device_bytes"], acc["max_device_bytes"])
            wm["total_bytes"] = max(wm["total_bytes"], acc["total_bytes"])
            wm["wall_s"] = round(wm["wall_s"] + wall_s, 9)
            for key, v in acc["per_device"].items():
                if v > wm["per_device"].get(key, -1):
                    wm["per_device"][key] = v

    # -- reporting ---------------------------------------------------------

    def watermark_table(self) -> dict[str, dict]:
        """Per-phase watermarks (deep-copied; safe to serialise)."""
        with self._lock:
            return {
                name: {**wm, "per_device": dict(wm["per_device"])}
                for name, wm in self._watermarks.items()
            }

    def device_peaks(self) -> dict[str, int]:
        """Per-device peak bytes across all audited phases (for gauges)."""
        peaks: dict[str, int] = {}
        with self._lock:
            for wm in self._watermarks.values():
                for key, v in wm["per_device"].items():
                    if v > peaks.get(key, -1):
                        peaks[key] = v
        return peaks

    # -- the gate ----------------------------------------------------------

    def assert_not_replicated(self, n, itemsize, slack: float = 0.5,
                              phases=None) -> dict:
        """Fail if any device's phase peak implies a replicated O(n) buffer.

        The threshold is ``slack * n * itemsize`` bytes of growth above the
        device's construction-time baseline. Returns a summary dict
        (threshold, phases checked, worst offender margin) on success;
        raises :class:`ReplicatedBufferError` listing every offending
        (phase, device, peak) otherwise.
        """
        n = int(n)
        itemsize = int(itemsize)
        if n <= 0:
            raise ValueError(f"n must be > 0, got {n!r}")
        if itemsize <= 0:
            raise ValueError(f"itemsize must be > 0, got {itemsize!r}")
        if not slack > 0:
            raise ValueError(f"slack must be > 0, got {slack!r}")
        threshold = slack * n * itemsize
        table = self.watermark_table()
        if phases is not None:
            wanted = set(phases)
            missing = wanted - set(table)
            if missing:
                raise ValueError(
                    f"assert_not_replicated: phases never audited: "
                    f"{sorted(missing)} (have {sorted(table)})"
                )
            table = {k: v for k, v in table.items() if k in wanted}
        if not table:
            raise RuntimeError(
                "assert_not_replicated: no phases were audited — the gate "
                "cannot pass vacuously"
            )
        devices = set()
        for wm in table.values():
            devices.update(wm["per_device"])
        if len(devices) <= 1:
            # One device holds the whole problem by definition: "replicated
            # vs sharded" is only meaningful across several devices.
            return {
                "threshold_bytes": threshold,
                "phases": sorted(table),
                "worst_fraction": 0.0,
                "single_device": True,
            }
        offenders = []
        worst = 0.0
        for phase, wm in sorted(table.items()):
            for dev, peak in sorted(wm["per_device"].items()):
                growth = peak - self.baseline.get(dev, 0)
                worst = max(worst, growth / threshold)
                if growth >= threshold:
                    offenders.append((phase, dev, peak, growth))
        if offenders:
            lines = "; ".join(
                f"{phase}/{dev}: peak={peak}B growth={growth}B"
                for phase, dev, peak, growth in offenders
            )
            raise ReplicatedBufferError(
                f"replicated O(n) buffer: {len(offenders)} device-phase "
                f"peak(s) grew >= slack*n*itemsize = {slack}*{n}*{itemsize} "
                f"= {threshold:.0f}B above baseline ({lines})"
            )
        return {
            "threshold_bytes": threshold,
            "phases": sorted(table),
            "worst_fraction": round(worst, 6),
        }
