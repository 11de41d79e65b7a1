"""Refitter: background re-fit + schema-versioned artifact publication — the
port of ``hdbscan_tpu/stream/refit.py``.

When the server's drift detector flags shift (or the novelty buffer hits
its point budget — or, under ``stream_maintain=incremental``, the online
maintainer trips its dirty-work contract and demotes with
``reason="maintain_fallback"``), the refitter runs a full fit over the
re-fit pool —
novel buffered rows + the stream reservoir + a sample of original training
rows — on a daemon worker thread, so serving latency never sees fit wall.
The fit is the port's dense ``models/hdbscan.fit`` (the reference's
default) on the server's device: the card unless the server was given
another. The result is distilled through the standard
``HDBSCANResult.to_cluster_model`` path and saved as a generation-numbered
``hdbscan-tpu-model/2`` artifact (atomic ``ClusterModel.save``:
tempfile + ``os.replace`` + sha256 digests, wrapped in a bounded
backoff-retry so a transient publish failure doesn't waste the fit), then
handed to ``on_publish`` — in the server, that callback performs (or
stages, in ``manual`` reload mode) the blue/green swap.

At most one re-fit runs at a time: ``request`` returns ``False`` while a
worker is active, and the caller (``ClusterServer.ingest``) also suppresses
re-triggering while a published artifact awaits a manual swap.  A failed
fit never touches the served model — the error and its timestamp are
recorded (``last_error``/``last_error_at``, surfaced in ``/healthz``),
``hdbscan_tpu_refit_failures_total`` increments, the failure is traced as
``model_refit`` with ``ok=False``, serving continues on the old handle,
and ``request`` refuses new work until a capped exponential backoff
(growing with *consecutive* failures) has elapsed, so a persistently
failing fit cannot spin the worker hot.  ``on_result(ok, error)`` reports
every outcome — the server feeds it to the refit circuit breaker.
"""

from __future__ import annotations

import os
import random
import threading
import time

from hdbscan_tpu_torch.fault import inject
from hdbscan_tpu_torch.fault.policy import backoff_s, retry_call

__all__ = ["Refitter", "fit_and_publish"]


def fit_and_publish(points, params, path, *, fit_fn=None, tracer=None,
                    seed: int = 0, compress: bool = True,
                    fault_site: str = "refit_fit",
                    publish_name: str = "refit_publish", device=None):
    """Fit ``points`` on ``device`` (the card unless another is named),
    distill to a ClusterModel, and publish it atomically at ``path`` — the
    shared core of :class:`Refitter` and the fleet's fit-as-a-service
    workers (``fleet/jobs.py``).

    The fit runs under the obs phases (``model_refit`` memory phase +
    progress task); the save is wrapped in a bounded retry so a transient
    publish error (an injected ``artifact_save`` fault, a busy filesystem)
    doesn't waste the fit. ``fault_site`` names the injection site fired
    before the fit and ``publish_name`` the retried save's trace name.
    ``compress=False`` publishes an uncompressed artifact the per-host
    ``fleet.artifacts.ArtifactStore`` can spool and mmap without a
    decompression copy. ``fit_fn(points, params)`` replaces the dense fit
    (tests). Raises on failure; returns the published model.
    """
    from hdbscan_tpu_torch import obs

    if inject.maybe_fire(fault_site) is not None:
        raise inject.InjectedFault(f"injected {fault_site} crash")
    with obs.mem_phase("model_refit"), obs.task("model_refit", total=1):
        if fit_fn is not None:
            result = fit_fn(points, params)
        else:
            from hdbscan_tpu_torch.models import hdbscan

            result = hdbscan.fit(points, params, device=device)
        model = result.to_cluster_model(points, params, device=device)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # Only name the keyword when deviating from the default: save-compatible
    # duck types (test fakes) may predate ``compress``.
    save = (lambda: model.save(path)) if compress else (
        lambda: model.save(path, compress=False))
    retry_call(
        save,
        attempts=3, base_s=0.05, cap_s=0.5, seed=seed,
        retry_on=(OSError, inject.InjectedFault),
        tracer=tracer, name=publish_name,
    )
    return model


class Refitter:
    """One-at-a-time background re-fit worker.

    Parameters
    ----------
    params:
        :class:`~hdbscan_tpu_torch.config.HDBSCANParams` for the re-fit.  The
        caller must keep the fingerprint fields (``min_points``,
        ``min_cluster_size``, ``dist_function``) equal to the served
        model's, or the server's swap guard will reject the artifact.
    model_dir:
        Directory for published artifacts (created on demand);
        generation ``g`` lands at ``model_gen{g:04d}.npz``.
    on_publish:
        ``callback(path, model, reason)`` invoked on the worker thread
        after a successful save.
    on_result:
        ``callback(ok, error)`` invoked on the worker thread after every
        attempt (the server's circuit breaker hook).
    fit_fn:
        Override for the fit entry point (tests); defaults to
        ``hdbscan_tpu_torch.models.hdbscan.fit`` on ``device``.
    device:
        The re-fit's device (the card unless another is named, e.g.
        ``"cpu"``).
    backoff_base_s / backoff_cap_s:
        Failure backoff window: after ``k`` consecutive failures,
        ``request`` refuses work for ``min(cap, base * 2**(k-1))`` seconds
        (plus jitter).
    """

    def __init__(self, params, model_dir, tracer=None, on_publish=None,
                 fit_fn=None, metrics=None, on_result=None,
                 backoff_base_s: float = 0.5, backoff_cap_s: float = 30.0,
                 device=None):
        self.params = params
        self.device = device
        self.model_dir = model_dir
        self.tracer = tracer
        self.on_publish = on_publish
        self.on_result = on_result
        self.fit_fn = fit_fn
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._m_refits = self._m_failures = None
        if metrics is not None:
            self._m_refits = metrics.counter(
                "hdbscan_tpu_refits_total",
                "Background re-fits by outcome.",
                labelnames=("outcome",),
            )
            self._m_failures = metrics.counter(
                "hdbscan_tpu_refit_failures_total",
                "Background re-fit attempts that failed (fit or publish).",
            )
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._publish_seq = 0
        self._rng = random.Random(0)
        self._consecutive_failures = 0
        self._retry_at = 0.0  # monotonic instant before which request() refuses
        self.refits_ok = 0
        self.refits_failed = 0
        self.last_error: str | None = None
        self.last_error_at: float | None = None  # epoch seconds
        self.last_path: str | None = None

    @property
    def busy(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    def backoff_remaining_s(self) -> float:
        """Seconds until a new re-fit may start (0 when none pending)."""
        with self._lock:
            return max(0.0, self._retry_at - time.monotonic())

    def request(self, points, reason: str) -> bool:
        """Start a background re-fit over ``points``; ``False`` if one is
        already running or the failure backoff window is still open."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False
            if time.monotonic() < self._retry_at:
                return False
            self._publish_seq += 1
            seq = self._publish_seq
            self._thread = threading.Thread(
                target=self._worker,
                args=(points, str(reason), seq),
                name=f"refit-{seq}",
                daemon=True,
            )
            self._thread.start()
        return True

    def join(self, timeout: float | None = None) -> bool:
        """Wait for the active re-fit (if any); True when idle."""
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout)
        return not self.busy

    def _record_failure(self, exc: Exception) -> None:
        self.last_error = f"{type(exc).__name__}: {exc}"
        self.last_error_at = time.time()
        self.refits_failed += 1
        with self._lock:
            self._consecutive_failures += 1
            self._retry_at = time.monotonic() + backoff_s(
                self._consecutive_failures - 1,
                base_s=self.backoff_base_s,
                cap_s=self.backoff_cap_s,
                rng=self._rng,
            )
        if self._m_refits is not None:
            self._m_refits.inc(outcome="error")
        if self._m_failures is not None:
            self._m_failures.inc()

    def _worker(self, points, reason: str, seq: int) -> None:
        t0 = time.perf_counter()
        try:
            path = os.path.join(self.model_dir, f"model_gen{seq:04d}.npz")
            model = fit_and_publish(
                points, self.params, path,
                fit_fn=self.fit_fn, tracer=self.tracer, seed=seq,
                device=self.device,
            )
        except Exception as exc:  # never let a bad refit kill serving
            self._record_failure(exc)
            if self.tracer is not None:
                self.tracer(
                    "model_refit",
                    rows=int(len(points)),
                    reason=reason,
                    ok=False,
                    error=self.last_error,
                    wall_s=round(time.perf_counter() - t0, 6),
                )
            if self.on_result is not None:
                self.on_result(False, self.last_error)
            return
        with self._lock:
            self._consecutive_failures = 0
            self._retry_at = 0.0
        self.refits_ok += 1
        self.last_path = path
        if self._m_refits is not None:
            self._m_refits.inc(outcome="ok")
        if self.tracer is not None:
            self.tracer(
                "model_refit",
                rows=int(len(points)),
                reason=reason,
                ok=True,
                n_train=int(model.n_train),
                wall_s=round(time.perf_counter() - t0, 6),
            )
        if self.on_result is not None:
            self.on_result(True, None)
        if self.on_publish is not None:
            self.on_publish(path, model, reason)
