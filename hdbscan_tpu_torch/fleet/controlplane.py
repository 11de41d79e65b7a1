"""Fleet control plane: the autoscaler loop over the router's signals — a
host-only copy of ``hdbscan_tpu/fleet/controlplane.py``.

The paper's MapReduce driver sizes the executor pool to the work; the
serving fleet's analogue is this loop. :class:`Autoscaler` periodically
reads :meth:`FleetRouter.signals` — queue depth (in-flight proxied
requests per up replica) and the rolling p99 the router already tracks —
and drives :meth:`FleetRouter.scale_up` / :meth:`~FleetRouter.scale_down`
between ``min_replicas`` and ``max_replicas``:

* **Scale-up** when the per-replica queue depth exceeds ``high_load`` (or
  p99 exceeds ``high_p99_s``) for ``up_after`` consecutive ticks. The
  router spawns a standby, warms it (kernels loaded from the shared
  build directory, every bucket warmed, health probe green) and only
  then admits it to the ring — the autoscaler never routes load at a
  cold replica.
* **Scale-down** when queue depth stays below ``low_load`` AND p99 below
  ``high_p99_s`` for ``down_after`` consecutive ticks (hysteresis: the
  down window should be the longer one so a bursty arrival process
  doesn't thrash). The router drains the victim before SIGTERM.
* **Cooldown** — after any scale operation the loop holds for
  ``cooldown_s`` so the fleet re-equilibrates (a fresh replica empties
  the queue; judging the new topology on the old window double-scales).

Decisions trace as the router's ``scale_event`` (reason ``queue_depth``,
``p99``, or ``idle``) and count in ``hdbscan_tpu_scale_events_total``;
the loop itself is a daemon thread owned by the CLI ``fleet`` command
(``--autoscale``) or a test/bench harness via :meth:`start`/:meth:`stop`.
"""

from __future__ import annotations

import threading
import time

__all__ = ["Autoscaler"]


class Autoscaler:
    """Hysteresis-bounded scale loop over a running :class:`FleetRouter`.

    Args:
      router: a STARTED ``fleet.router.FleetRouter``.
      min_replicas / max_replicas: inclusive bounds on the routing set.
      high_load: per-up-replica in-flight requests above which a tick
        votes scale-up.
      low_load: per-up-replica in-flight requests below which a tick
        votes scale-down.
      high_p99_s: rolling p99 above which a tick votes scale-up (and
        vetoes scale-down). 0 disables the latency signal.
      up_after / down_after: consecutive votes required (hysteresis).
      interval_s: tick period.
      cooldown_s: hold after any scale operation.
    """

    def __init__(self, router, *, min_replicas: int = 1,
                 max_replicas: int = 4, high_load: float = 4.0,
                 low_load: float = 0.5, high_p99_s: float = 0.0,
                 up_after: int = 2, down_after: int = 5,
                 interval_s: float = 0.5, cooldown_s: float = 2.0):
        if min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {min_replicas!r}"
            )
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas must be >= min_replicas ({min_replicas}), "
                f"got {max_replicas!r}"
            )
        if not high_load > low_load:
            raise ValueError(
                f"high_load ({high_load!r}) must exceed low_load "
                f"({low_load!r}) — equal thresholds thrash"
            )
        if up_after < 1 or down_after < 1:
            raise ValueError(
                f"up_after/down_after must be >= 1, got "
                f"{up_after!r}/{down_after!r}"
            )
        if not interval_s > 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s!r}")
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {cooldown_s!r}")
        self.router = router
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.high_load = float(high_load)
        self.low_load = float(low_load)
        self.high_p99_s = float(high_p99_s)
        self.up_after = int(up_after)
        self.down_after = int(down_after)
        self.interval_s = float(interval_s)
        self.cooldown_s = float(cooldown_s)
        self._up_votes = 0
        self._down_votes = 0
        self._hold_until = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.scaled_up = 0
        self.scaled_down = 0

    # -- decision ----------------------------------------------------------

    def decide(self, signals: dict) -> tuple[str, str] | None:
        """Pure decision function: ``(direction, reason)`` or None.

        Exposed separately from the loop so tests (and the bench leg) can
        drive it against synthetic signals without a live fleet.
        """
        n = int(signals.get("replicas", 0))
        load = float(signals.get("in_flight_per_up", 0.0))
        p99 = float(signals.get("p99_s", 0.0) or 0.0)
        hot_p99 = self.high_p99_s > 0.0 and p99 > self.high_p99_s
        if load > self.high_load or hot_p99:
            self._down_votes = 0
            self._up_votes += 1
            if self._up_votes >= self.up_after and n < self.max_replicas:
                self._up_votes = 0
                return ("up", "p99" if hot_p99 and load <= self.high_load
                        else "queue_depth")
            return None
        self._up_votes = 0
        if load < self.low_load and not hot_p99:
            self._down_votes += 1
            if self._down_votes >= self.down_after and n > self.min_replicas:
                self._down_votes = 0
                return ("down", "idle")
            return None
        self._down_votes = 0
        return None

    def tick(self, now: float | None = None) -> tuple[str, str] | None:
        """One decision + (maybe) one scale operation. Returns what was
        attempted, or None."""
        now = time.monotonic() if now is None else now
        if now < self._hold_until:
            return None
        verdict = self.decide(self.router.signals())
        if verdict is None:
            return None
        direction, reason = verdict
        if direction == "up":
            ok = self.router.scale_up(reason=reason) is not None
            if ok:
                self.scaled_up += 1
        else:
            ok = self.router.scale_down(reason=reason)
            if ok:
                self.scaled_down += 1
        self._hold_until = time.monotonic() + self.cooldown_s
        return verdict

    # -- loop --------------------------------------------------------------

    def _loop(self) -> None:
        # Bring the fleet inside bounds first: a fleet started below
        # min_replicas (e.g. min raised by config) grows immediately.
        while (not self._stop.is_set()
               and len(self.router.replicas) < self.min_replicas):
            if self.router.scale_up(reason="min_replicas") is None:
                break
            self.scaled_up += 1
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must survive a
                pass           # failed scale op; the next tick retries

    def start(self) -> "Autoscaler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="autoscaler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    def stats(self) -> dict:
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "high_load": self.high_load,
            "low_load": self.low_load,
            "high_p99_s": self.high_p99_s,
            "scaled_up": self.scaled_up,
            "scaled_down": self.scaled_down,
            "running": self._thread is not None,
        }
