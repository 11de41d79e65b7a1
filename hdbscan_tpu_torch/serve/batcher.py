"""Request coalescing for the inference server: the micro-batching layer —
the port of ``hdbscan_tpu/serve/batcher.py``.

Concurrent HTTP requests land here one at a time; the batcher drains them
into a single padded bucket dispatch so the device runs one kernel launch
per linger window instead of one per request. Shapes stay inside the
:class:`~hdbscan_tpu_torch.serve.predict.Predictor`'s power-of-two bucket
set.

Stdlib only (``threading`` + ``queue`` + ``concurrent.futures.Future``), one
worker thread feeding the device — a single dispatcher keeps
``predict_batch`` trace events (``batch_seq``) strictly ordered; the
predictor's own lock covers the callers that bypass the batcher.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from hdbscan_tpu_torch.fault import inject
from hdbscan_tpu_torch.fault.policy import DeadlineExceeded, ShedRequest


class MicroBatcher:
    """Coalesce concurrent predict requests into bucket-sized batches.

    Args:
      predictor: a warmed :class:`~hdbscan_tpu_torch.serve.predict.Predictor`.
      linger_s: how long the worker waits for more requests after the first
        one arrives before dispatching (the latency the smallest request
        pays to let a batch form; 0 disables coalescing).
      max_rows: dispatch ceiling per coalesced batch — defaults to the
        predictor's largest bucket, so a coalesced batch is exactly one
        device program.
      max_queue: bound on queued (undispatched) requests; a submit over the
        bound raises :class:`ShedRequest` (HTTP 503 + Retry-After) instead
        of queueing unboundedly. 0 = unbounded.
    """

    def __init__(self, predictor, linger_s: float = 0.002,
                 max_rows: int | None = None, max_queue: int = 0):
        self.predictor = predictor
        self.linger_s = float(linger_s)
        self.max_rows = int(max_rows or predictor.max_bucket)
        self.max_queue = int(max_queue or 0)
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._close_lock = threading.Lock()  # orders submit() vs close()
        self._batches = 0
        self._rows = 0
        self._shed = 0
        self._deadline_drops = 0
        self._worker = threading.Thread(
            target=self._run, name="predict-batcher", daemon=True
        )
        self._worker.start()

    # -- client side -------------------------------------------------------

    def submit(self, X, meta: dict | None = None) -> Future:
        """Enqueue one request; the Future resolves to this request's
        ``(labels, probabilities, outlier_scores)`` slice of the coalesced
        dispatch.

        ``meta``, when given, is filled by the worker before the Future
        resolves (the resolution is the happens-before edge) with the span
        attribution the server's ``request_span`` event needs: perf_counter
        marks ``t_assembled``/``t_dispatch``/``t_done``, the dispatched
        ``bucket``, the ``coalesced`` peer count, and ``batch_rows``.

        ``meta['deadline']`` (a ``time.perf_counter`` instant) makes the
        request deadline-aware: an already-expired deadline raises
        :class:`DeadlineExceeded` here, and one that expires while queued
        fails the future the same way before dispatch — an expired request
        never occupies a batch slot.
        """
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X[None, :]
        if inject.maybe_fire("batcher_submit") is not None:
            raise inject.InjectedFault("injected batcher_submit fault")
        deadline = meta.get("deadline") if meta else None
        if deadline is not None and time.perf_counter() > deadline:
            raise DeadlineExceeded("request deadline passed before enqueue")
        fut: Future = Future()
        # The close lock orders this put against close()'s sentinel: every
        # accepted future lands ahead of the sentinel in the FIFO queue, so
        # the worker's drain-until-sentinel loop resolves all of them —
        # close() never abandons an in-flight request.
        with self._close_lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            if self.max_queue and self._q.qsize() >= self.max_queue:
                self._shed += 1
                raise ShedRequest(
                    f"batcher queue at bound ({self.max_queue})",
                    status=503,
                    retry_after_s=max(0.01, self.linger_s * 2),
                    reason="queue_full",
                )
            self._q.put((X, fut, meta))
        return fut

    def predict(self, X, meta: dict | None = None):
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(X, meta).result()

    @property
    def stats(self) -> dict:
        """Dispatch counters — the coalescing ratio is rows/batches; shed
        and deadline_drops count load-shedding outcomes."""
        return {
            "batches": self._batches,
            "rows": self._rows,
            "shed": self._shed,
            "deadline_drops": self._deadline_drops,
        }

    # -- worker side -------------------------------------------------------

    def _collect(self, first) -> tuple[list, bool]:
        """Drain the queue into one batch: start from ``first``, keep
        accepting until the linger window closes or the batch would exceed
        ``max_rows``. Returns (batch, saw_close_sentinel)."""
        batch = [first]
        rows = len(first[0])
        deadline = time.monotonic() + self.linger_s
        while rows < self.max_rows:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                return batch, True
            batch.append(item)
            rows += len(item[0])
        return batch, False

    def _dispatch(self, batch) -> None:
        t_assembled = time.perf_counter()  # linger window closed; batch fixed
        # Deadline fail-fast: a request whose deadline already passed gets a
        # DeadlineExceeded (the server maps it to 504) instead of a batch
        # slot — under overload, expired work must not displace live work.
        live = []
        for item in batch:
            m = item[2]
            dl = m.get("deadline") if m else None
            if dl is not None and t_assembled > dl:
                self._deadline_drops += 1
                item[1].set_exception(
                    DeadlineExceeded("request deadline passed before dispatch")
                )
            else:
                live.append(item)
        if not live:
            return
        batch = live
        xs = [x for x, _, _ in batch]
        futs = [f for _, f, _ in batch]
        try:
            x_all = np.concatenate(xs)
        except ValueError as e:  # mixed dims inside one window
            for f in futs:
                f.set_exception(ValueError(f"incompatible request shapes: {e}"))
            return
        t_dispatch = time.perf_counter()
        try:
            labels, prob, score = self.predictor.predict(x_all)
        except Exception as e:  # noqa: BLE001 - fan the failure out
            for f in futs:
                f.set_exception(e)
            return
        t_done = time.perf_counter()
        self._batches += 1
        self._rows += len(x_all)
        bucket = self.predictor.bucket_for(
            min(len(x_all), self.predictor.max_bucket)
        )
        # Fill every caller's meta BEFORE resolving any future: the waiting
        # handler thread reads its meta only after .result() returns, so
        # resolution order is the publication barrier.
        for _, _, m in batch:
            if m is not None:
                m.update(
                    t_assembled=t_assembled,
                    t_dispatch=t_dispatch,
                    t_done=t_done,
                    bucket=bucket,
                    coalesced=len(batch),
                    batch_rows=len(x_all),
                )
        a = 0
        for x, f in zip(xs, futs):
            b = a + len(x)
            f.set_result((labels[a:b], prob[a:b], score[a:b]))
            a = b

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                break
            batch, stop = self._collect(item)
            self._dispatch(batch)
            if stop:
                break
        self._drain()

    def _drain(self) -> None:
        """Dispatch everything still queued ahead of the close sentinel (the
        linger window in :meth:`_collect` can expire with items left), in
        ``max_rows``-sized batches, so shutdown completes every accepted
        future instead of abandoning it."""
        pending = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                pending.append(item)
        while pending:
            batch, rows = [], 0
            while pending and rows < self.max_rows:
                batch.append(pending.pop(0))
                rows += len(batch[-1][0])
            self._dispatch(batch)

    # -- lifecycle ---------------------------------------------------------

    def close(self, timeout: float | None = 5.0) -> None:
        """Stop accepting requests, flush what's queued, join the worker.
        Every future accepted before close is resolved (graceful drain); if
        the worker cannot finish within ``timeout`` the leftovers fail with
        a ``RuntimeError`` rather than hanging their callers forever."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._worker.join(timeout=timeout)
        if not self._worker.is_alive():
            return
        # Worker wedged (a device fault mid-dispatch): fail what's left so no
        # caller blocks forever on an unresolvable future.
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[1].set_exception(
                    RuntimeError("MicroBatcher closed before dispatch")
                )

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
