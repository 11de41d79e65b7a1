"""Fit-as-a-service: per-tenant fit/refit jobs on a bounded worker pool — a
host-side copy of ``hdbscan_tpu/fleet/jobs.py`` whose fits run on the
scheduler's device (the card unless another is named).

The paper's driver schedules fit work across executors; this is the serving
fleet's version of the same idea — one fleet both serves and re-fits.
:class:`FitScheduler` accepts fit jobs per tenant, applies a per-tenant
token-bucket quota (the ``TenantRegistry`` discipline, pointed at fits
instead of predicts) and a global queue bound, runs at most ``workers``
fits concurrently on daemon threads, and publishes each result through the
caller's ``publish`` callback — in the fleet, ``TenantRegistry.swap``, the
per-tenant blue/green generation bump.

Contracts, mirrored from ``stream/refit.Refitter``:

* A failed fit never touches serving: the worker records the error on the
  job (state ``failed``), reports through ``on_result`` (the circuit
  breaker hook), and moves on. Worker threads survive any job exception.
* The fit→distill→publish core is the SAME code path as the single-server
  refitter (:func:`stream.refit.fit_and_publish`): obs phases, atomic
  save, retried publish, ``artifact_save`` fault sites intact.
* Every state transition emits a ``fit_job`` trace event; the
  ``queued → running → published | failed`` machine is validated per job
  by ``scripts/check_trace.py``, and ``hdbscan_tpu_fit_jobs_total`` /
  queue-depth gauges by ``check_metrics.py``.

Jobs publish uncompressed by default (``compress=False``) so the per-host
``ArtifactStore`` can spool-and-mmap the new generation without a
decompression copy.

On the card the workers are threads of the serving process: their fits
launch on the device's current stream, the stream the tenants' predict
buckets use, so a prediction that arrives during a fit queues behind the
fit's kernels (there is one stream, as in the reference). A dense fit
holds a float32 (n, n) block (1 GiB at 16,384 rows), per worker.
"""

from __future__ import annotations

import math
import os
import queue
import threading
import time
from dataclasses import dataclass, field

from hdbscan_tpu_torch.fault.policy import ShedRequest

__all__ = ["FitJob", "FitScheduler"]

#: Terminal job states (``queued``/``running`` are transient).
TERMINAL_STATES = ("published", "failed")


@dataclass
class FitJob:
    """One scheduled fit: identity, lifecycle timestamps, and outcome."""

    job_id: str
    tenant: str
    reason: str
    points: object = field(repr=False, default=None)
    params: object = field(repr=False, default=None)
    state: str = "queued"
    submitted_at: float = 0.0
    started_at: float | None = None
    finished_at: float | None = None
    error: str | None = None
    path: str | None = None
    generation: int | None = None
    done: threading.Event = field(default_factory=threading.Event, repr=False)

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the job reaches a terminal state."""
        return self.done.wait(timeout)


@dataclass
class _Bucket:
    tokens: float
    last: float


class FitScheduler:
    """Bounded fit/refit worker pool with per-tenant quotas.

    Args:
      model_dir: artifacts land at ``model_dir/<tenant>_gen<k>.npz``.
      params: default fit params (per-job override via ``submit``).
      fit_fn: fit entry point override (tests); default
        ``models.hdbscan.fit`` on ``device``.
      publish: ``callback(tenant, path, model) -> entry-or-None`` run on
        the worker after a successful save — ``TenantRegistry.swap`` makes
        it the blue/green generation bump. A raising publish fails the job
        (the artifact stays on disk; serving is untouched).
      on_result: ``callback(ok, error)`` per terminal job — the circuit
        breaker hook, same signature as ``Refitter``'s.
      workers: concurrent fits (>= 1).
      queue_bound: max queued-but-not-running jobs; an overflowing submit
        sheds with HTTP 503 semantics.
      quota_rps: sustained per-tenant job rate (token bucket, burst 1);
        0 disables. Over-quota submits shed with HTTP 429 + Retry-After.
      compress: compress published artifacts (default False — see module
        docstring).
      device: where the default fit runs (``fit_and_publish(...,
        device=...)``: the card unless another is named, e.g. ``"cpu"``).
    """

    def __init__(self, model_dir: str, *, params=None, fit_fn=None,
                 publish=None, on_result=None, workers: int = 2,
                 queue_bound: int = 16, quota_rps: float = 0.0,
                 compress: bool = False, tracer=None, metrics=None,
                 clock=time.monotonic, device=None):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers!r}")
        if queue_bound < 1:
            raise ValueError(f"queue_bound must be >= 1, got {queue_bound!r}")
        if quota_rps < 0.0 or not math.isfinite(quota_rps):
            raise ValueError(
                f"quota_rps must be finite and >= 0, got {quota_rps!r}"
            )
        self.model_dir = str(model_dir)
        self.params = params
        self.fit_fn = fit_fn
        self.publish = publish
        self.on_result = on_result
        self.workers = int(workers)
        self.queue_bound = int(queue_bound)
        self.quota_rps = float(quota_rps)
        self.compress = bool(compress)
        self.device = device
        self.tracer = tracer
        self._clock = clock
        self._lock = threading.Lock()
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_bound)
        self._jobs: dict = {}  # job_id -> FitJob
        self._seq = 0
        self._gen: dict = {}  # tenant -> published artifact count
        self._buckets: dict = {}  # tenant -> _Bucket
        self._running = 0
        self._shutdown = threading.Event()
        self.published = 0
        self.failed = 0
        self.shed = 0
        self._m_jobs = self._m_queued = self._m_running = None
        if metrics is not None:
            self._m_jobs = metrics.counter(
                "hdbscan_tpu_fit_jobs_total",
                "Fit-as-a-service jobs by tenant and terminal outcome.",
                ("tenant", "state"),
            )
            self._m_queued = metrics.gauge(
                "hdbscan_tpu_fit_jobs_queued",
                "Fit jobs accepted but not yet running.",
            )
            self._m_running = metrics.gauge(
                "hdbscan_tpu_fit_jobs_running",
                "Fit jobs currently on a worker thread.",
            )
        self._threads = [
            threading.Thread(target=self._worker_loop,
                             name=f"fit-worker-{i}", daemon=True)
            for i in range(self.workers)
        ]
        for t in self._threads:
            t.start()

    # -- submission --------------------------------------------------------

    def _acquire_quota(self, tenant: str) -> None:
        # caller holds the lock
        if self.quota_rps <= 0.0:
            return
        now = self._clock()
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = _Bucket(tokens=1.0, last=now)
        b.tokens = min(1.0, b.tokens + (now - b.last) * self.quota_rps)
        b.last = now
        if b.tokens >= 1.0:
            b.tokens -= 1.0
            return
        self.shed += 1
        if self._m_jobs is not None:
            self._m_jobs.inc(tenant=tenant, state="shed")
        retry_s = (1.0 - b.tokens) / self.quota_rps
        raise ShedRequest(
            f"tenant {tenant!r} over fit quota ({self.quota_rps:g} jobs/s)",
            status=429, retry_after_s=retry_s, reason="fit_quota",
        )

    def submit(self, tenant: str, points, *, params=None,
               reason: str = "fit") -> FitJob:
        """Enqueue a fit for ``tenant`` over ``points``.

        Raises :class:`ShedRequest` when the tenant is over its job quota
        (429) or the queue is at its bound (503), and ``RuntimeError``
        after :meth:`close`.
        """
        tenant = str(tenant)
        if self._shutdown.is_set():
            raise RuntimeError("FitScheduler is closed")
        with self._lock:
            self._acquire_quota(tenant)
            self._seq += 1
            job = FitJob(
                job_id=f"{tenant}-{self._seq}", tenant=tenant,
                reason=str(reason), points=points,
                params=params if params is not None else self.params,
                submitted_at=self._clock(),
            )
        try:
            self._queue.put_nowait(job)
        except queue.Full:
            with self._lock:
                self.shed += 1
            if self._m_jobs is not None:
                self._m_jobs.inc(tenant=tenant, state="shed")
            raise ShedRequest(
                f"fit queue at bound ({self.queue_bound})",
                status=503, retry_after_s=1.0, reason="fit_queue_full",
            ) from None
        with self._lock:
            self._jobs[job.job_id] = job
        self._emit(job)
        self._set_gauges()
        return job

    # -- worker ------------------------------------------------------------

    def _worker_loop(self) -> None:
        while True:
            try:
                job = self._queue.get(timeout=0.1)
            except queue.Empty:
                if self._shutdown.is_set():
                    return
                continue
            try:
                self._run_one(job)
            except BaseException:  # noqa: BLE001 — pool must survive anything
                pass
            finally:
                self._queue.task_done()

    def _run_one(self, job: FitJob) -> None:
        from hdbscan_tpu_torch.stream.refit import fit_and_publish

        with self._lock:
            self._running += 1
            job.state = "running"
            job.started_at = self._clock()
        self._emit(job, queued_s=job.started_at - job.submitted_at)
        self._set_gauges()
        t0 = time.perf_counter()
        try:
            with self._lock:
                self._gen[job.tenant] = self._gen.get(job.tenant, 0) + 1
                gen = self._gen[job.tenant]
            path = os.path.join(
                self.model_dir, f"{job.tenant}_gen{gen:04d}.npz"
            )
            model = fit_and_publish(
                job.points, job.params, path,
                fit_fn=self.fit_fn, tracer=self.tracer, seed=gen,
                compress=self.compress, fault_site="fit_job",
                publish_name="fit_job_publish", device=self.device,
            )
            entry = None
            if self.publish is not None:
                entry = self.publish(job.tenant, path, model)
            with self._lock:
                self._running -= 1
                job.state = "published"
                job.path = path
                job.finished_at = self._clock()
                job.generation = getattr(entry, "generation", None)
                job.points = None  # don't pin the training rows
                self.published += 1
            if self._m_jobs is not None:
                self._m_jobs.inc(tenant=job.tenant, state="published")
            self._emit(job, wall_s=time.perf_counter() - t0)
            if self.on_result is not None:
                self.on_result(True, None)
        except Exception as exc:  # a bad fit never touches serving
            with self._lock:
                self._running -= 1
                job.state = "failed"
                job.error = f"{type(exc).__name__}: {exc}"[:500]
                job.finished_at = self._clock()
                job.points = None
                self.failed += 1
            if self._m_jobs is not None:
                self._m_jobs.inc(tenant=job.tenant, state="failed")
            self._emit(job, wall_s=time.perf_counter() - t0)
            if self.on_result is not None:
                self.on_result(False, job.error)
        finally:
            self._set_gauges()
            job.done.set()

    # -- bookkeeping -------------------------------------------------------

    def _emit(self, job: FitJob, **extra) -> None:
        if self.tracer is None:
            return
        fields = {
            "job": job.job_id, "tenant": job.tenant, "state": job.state,
            "reason": job.reason,
        }
        if job.state == "published" and job.generation is not None:
            fields["generation"] = int(job.generation)
        if job.state == "failed" and job.error:
            fields["error"] = job.error
        for k, v in extra.items():
            fields[k] = round(v, 6) if isinstance(v, float) else v
        self.tracer("fit_job", **fields)

    def _set_gauges(self) -> None:
        if self._m_queued is not None:
            self._m_queued.set(float(self._queue.qsize()))
            self._m_running.set(float(self._running))

    def job(self, job_id: str) -> FitJob:
        with self._lock:
            return self._jobs[job_id]

    def jobs(self) -> list:
        with self._lock:
            return list(self._jobs.values())

    def join(self, timeout: float | None = None) -> bool:
        """Wait for every accepted job to reach a terminal state."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            pending = [j for j in self._jobs.values() if not j.done.is_set()]
        for j in pending:
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                return False
            if not j.wait(left):
                return False
        return True

    def close(self, timeout: float = 10.0) -> None:
        """Stop accepting jobs and join the workers (queued jobs finish)."""
        self._shutdown.set()
        for t in self._threads:
            t.join(timeout)

    def stats(self) -> dict:
        with self._lock:
            states: dict = {}
            for j in self._jobs.values():
                states[j.state] = states.get(j.state, 0) + 1
            return {
                "workers": self.workers,
                "queue_bound": self.queue_bound,
                "quota_rps": self.quota_rps,
                "queued": self._queue.qsize(),
                "running": self._running,
                "published": self.published,
                "failed": self.failed,
                "shed": self.shed,
                "states": states,
            }
