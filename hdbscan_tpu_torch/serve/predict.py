"""Batched ``approximate_predict`` against a fitted ClusterModel — the port
of ``hdbscan_tpu/serve/predict.py``.

Semantics (the reference's, step for step):

1. **k-NN**: q's k nearest training points (k = minPts - 1) by (distance,
   id). Backends ``xla`` and ``fused`` run the rectangular k-best kernel
   (``ops/cuda_knn.knn_kbest_panel``, B2's port) on the card: ``xla`` in
   the distance form the reference's tiled scan takes at this bucket's
   tiles (``ops/tiled._knn_core_scan``: row tile ``min(next_pow2(bucket),
   128)``, column tile ``_tile_sizes(n, 128, 8192)``), with that column
   tile's zero-norm rule at cosine and pearson; ``fused`` in the fused TPU
   kernel's full-f32 dot form. ``rpforest`` routes q down the artifact's
   stored planes (``ops/rpforest.route_queries``) and scans only the T
   visited leaves' members with the rescan top-k kernel
   (``ops/cuda_forest.forest_rescan_topk``, B7's port) — sub-quadratic,
   approximate. A CPU predictor runs each kernel's plain version; a CUDA
   predictor launches the kernel or raises (there is no fallback).
2. **Core distance**: ``core_q`` = the (minPts - 1)-th smallest training
   distance.
3. **Attachment level**: ``eps_q = min_i max(d_i, core_q, core_i)`` over the
   k-NN list; the first argmin neighbor is q's exemplar.
4. **Cluster**: from the exemplar's deepest cluster, binary lifting over a
   precomputed ancestor table climbs to the deepest ancestor whose birth
   covers ``eps_q``. A query that is an exact duplicate of its nearest
   training row (raw rows compared, never the centred rows pearson's
   kernels take) attaches at that row's fitted cluster, so predicting the
   training set reproduces the fit labels.
5. **Label** = the attachment cluster's nearest selected ancestor;
   **probability** = ``min(1, eps_min[label] / eps_q)``; **outlier score**
   = GLOSH with ``eps_q`` as the exit level, clipped to [0, 1].

Steps 2-5 (``_attach``, ``_climb``) are plain PyTorch on the predictor's
device, as they are XLA in the reference. Everything runs in float32 (the
reference's serving type) with the reference's operation order, so on the
CPU labels, probabilities and outlier scores equal the reference's
bitwise; the membership row sum may sum in another order.

Batching: queries pad into power-of-two buckets (floor 8, ceiling
``max_batch``), larger requests chunk. The training tables stay on the
device; each chunk's padded rows go up with one copy. Each bucket is a
``predict.bucket`` span (``utils/tracing.span``: ``bucket``, real ``rows``,
``pad_rows``, ``backend``; device-timed on the card) over its
``predict.stage`` child (pad and copy up), the k-NN kernel and ``_attach``
through the fetch; it gives the ``tracer`` its ``predict_batch`` event.
"""

from __future__ import annotations

import itertools
import threading
import time

import numpy as np
import torch

from hdbscan_tpu_torch.core.distances import euclidean_form
from hdbscan_tpu_torch.fault import inject
from hdbscan_tpu_torch.ops import cuda_build
from hdbscan_tpu_torch.ops.tiled import _next_pow2, _round_up, _tile_sizes
from hdbscan_tpu_torch.utils import tracing

#: Smallest bucket: requests of 1..8 rows share one shape.
_MIN_BUCKET = 8

#: Process-unique predictor ids for predict_batch trace attribution.
_PRED_IDS = itertools.count(1)

#: Largest query row tile of the reference's tiled scan (it picks the
#: euclidean form at this bucket's tiles).
_MAX_ROW_TILE = 128

#: Column tile and feature lanes of the reference's fused TPU kernel
#: (``ops/pallas_knn.COL_TILE``, ``LANES``): the fused backend's gate and
#: the training tables' padding.
_FUSED_COL_TILE = 2048
_FUSED_LANES = 128

BACKENDS = ("auto", "xla", "fused", "rpforest")


def _resolve_backend(backend: str, model, device) -> str:
    """'xla' | 'fused' | 'rpforest' with the reference's ``knn_backend``-style
    rules, "on a TPU" read as "on the card": 'fused' takes the dot form
    only where the reference's fused kernel runs (euclidean, k and d <=
    128, and off the card n <= 16,384), else 'xla'; 'auto' picks
    'fused' on the card within that gate. 'rpforest' is opt-in only and
    needs an artifact that carries a forest. Both 'xla' and 'fused' launch
    the same rectangular kernel on the card; they differ in distance form."""
    if backend not in BACKENDS:
        raise ValueError(
            f"predict backend must be 'auto', 'xla', 'fused' or 'rpforest', "
            f"got {backend!r}"
        )
    if backend == "rpforest":
        if getattr(model, "rpf", None) is None:
            raise ValueError(
                "predict_backend='rpforest' needs a model artifact that "
                "carries an rp-forest index (hdbscan-tpu-model/2, fitted "
                "with knn_index=rpforest or saved with forest=...)"
            )
        return "rpforest"
    on_card = device.type == "cuda"
    k = max(model.min_points - 1, 1)
    fusable = (
        model.metric == "euclidean"
        and k <= _FUSED_LANES
        and model.data.shape[1] <= _FUSED_LANES
        and (on_card or model.n_train <= (1 << 14))
    )
    if fusable and (backend == "fused" or (backend == "auto" and on_card)):
        return "fused"
    return "xla"


def _climb(anc, birth, cluster, eps):
    """Deepest ancestor-or-self of ``cluster`` whose birth >= ``eps``.

    Births strictly increase toward the root, whose birth is +inf, so the
    predicate is monotone along every ancestor chain: binary lifting finds
    the last failing node greedily; its parent is the answer.
    """
    cur = cluster
    for level in range(anc.shape[0] - 1, -1, -1):
        cand = anc[level][cur]
        cur = torch.where(birth[cand] < eps, cand, cur)
    return torch.where(birth[cur] >= eps, cur, anc[0][cur])


def _attach(knn_d, knn_i, xq, t: dict, kth_col: int, with_membership: bool):
    """Post-k-NN logic: attachment level, climb, labels, prob, GLOSH (and
    optionally the per-selected-cluster membership matrix). ``t`` holds the
    device tables; ids index them as the reference's gathers do (-1, a
    slot no column filled, wraps to the last padded row)."""
    knn_i = knn_i.long()
    if kth_col < 0:  # minPts <= 1: every core distance is zero (fit parity)
        core_q = torch.zeros(knn_d.shape[0], dtype=knn_d.dtype, device=knn_d.device)
    else:
        core_q = knn_d[:, kth_col]
    mrd = torch.maximum(torch.maximum(knn_d, core_q[:, None]), t["core"][knn_i])
    j = torch.argmin(mrd, dim=1)[:, None]  # first minimum = lowest-distance exemplar
    eps_q = torch.gather(mrd, 1, j)[:, 0]
    nbr = torch.gather(knn_i, 1, j)[:, 0]
    # Exact-duplicate shortcut against the RAW training rows.
    nbr0 = knn_i[:, 0]
    is_dup = torch.all(xq == t["train"][nbr0], dim=1) & (nbr0 >= 0)
    cluster = torch.where(
        is_dup, t["last"][nbr0], _climb(t["anc"], t["birth"], t["last"][nbr], eps_q)
    )
    label = t["sel_anc"][cluster]
    em = t["eps_min"][label]
    one = torch.ones((), dtype=eps_q.dtype, device=eps_q.device)
    zero = torch.zeros((), dtype=eps_q.dtype, device=eps_q.device)
    prob = torch.where(label > 0, torch.where(eps_q <= em, one, em / eps_q), zero)
    emax = t["eps_max"][cluster]
    score = torch.where(eps_q > 0, torch.clamp(1.0 - emax / eps_q, 0.0, 1.0), zero)
    if not with_membership:
        return label, prob, score
    # Soft clustering: per selected cluster, the minimum mutual-reachability
    # distance to a k-NN neighbor fitted to that cluster; inverse-normalized.
    labn = t["labels"][knn_i]  # (B, k) fitted flat labels of the neighbors
    inf = torch.full((), float("inf"), dtype=mrd.dtype, device=mrd.device)
    md = torch.amin(
        torch.where(labn[:, :, None] == t["sel_ids"][None, None, :], mrd[:, :, None], inf),
        dim=1,
    )  # (B, S)
    big = torch.full((), 1e30, dtype=md.dtype, device=md.device)
    inv = torch.where(md > 0, 1.0 / torch.clamp_min(md, 1e-30), big)
    fin = torch.isfinite(md)
    tot = torch.sum(torch.where(fin, inv, zero), dim=1, keepdim=True)
    mvec = torch.where(fin & (tot > 0), inv / torch.clamp_min(tot, 1e-30), zero)
    return label, prob, score, mvec


def _ancestor_table(parent: np.ndarray) -> np.ndarray:
    """Binary-lifting ancestor table over the cluster labels: ``anc[l][c]``
    is c's 2^l-th ancestor, saturating at the root (and at the unused label
    0), as one (L, C+1) int64 array."""
    c1 = len(parent)
    anc0 = np.where(parent > 0, parent, np.arange(c1)).astype(np.int64)
    levels = max(1, int(np.ceil(np.log2(max(c1, 2)))))
    anc = [anc0]
    for _ in range(levels - 1):
        anc.append(anc[-1][anc[-1]])
    return np.stack(anc)


def _pad_rows(a: np.ndarray, n_pad: int) -> np.ndarray:
    pad = np.zeros((n_pad - len(a), *a.shape[1:]), a.dtype)
    return np.concatenate([a, pad])


class Predictor:
    """Device-resident serving state for one :class:`ClusterModel`.

    The training points, core distances and every tree table are placed on
    ``device`` once at construction (the card unless the caller passes
    another, e.g. ``"cpu"``); each :meth:`predict` call ships only the
    padded query bucket.

    Args:
      model: a loaded ``serve/artifact.ClusterModel``.
      backend: 'auto' | 'xla' | 'fused' | 'rpforest'
        (``HDBSCANParams.predict_backend``).
      max_batch: bucket ceiling; requests above it chunk. Rounded up to a
        power of two, floor ``_MIN_BUCKET``.
      tracer: optional ``utils/tracing.Tracer`` — every dispatched bucket
        emits a ``predict_batch`` event (bucket, rows, batch_seq, wall_s,
        and the ``predict.bucket`` span's fields).
      metrics: optional ``utils/metrics.MetricsRegistry`` — every dispatched
        bucket observes the batch-size and per-batch host-wall histograms served by
        ``GET /metrics`` (warmup dispatches are excluded).
      device: where the tables live and the kernels run.
    """

    def __init__(
        self, model, backend: str = "auto", max_batch: int = 256,
        tracer=None, metrics=None, device=None,
    ):
        self.model = model
        self.tracer = tracer
        self.device = cuda_build.resolve_device(device)
        self._m_batch_rows = self._m_device_s = None
        if metrics is not None:
            from hdbscan_tpu_torch.utils.metrics import DEFAULT_SIZE_BUCKETS

            self._m_batch_rows = metrics.histogram(
                "hdbscan_tpu_predict_batch_rows",
                "Rows per dispatched device batch (post-coalescing).",
                buckets=DEFAULT_SIZE_BUCKETS,
            )
            self._m_device_s = metrics.histogram(
                "hdbscan_tpu_predict_device_seconds",
                "Host wall per dispatched batch: staging and H2D copy, compute, D2H fetch.",
            )
        self.backend = _resolve_backend(backend, model, self.device)
        n = model.n_train
        self.k = max(model.min_points - 1, 1)
        self.kth_col = (
            min(max(model.min_points - 1, 1), n) - 1 if model.min_points > 1 else -1
        )
        self.max_bucket = max(_MIN_BUCKET, _next_pow2(max(1, int(max_batch))))
        # Serializes dispatch: batch_seq ordering assumes one predict() in
        # flight, and the HTTP server calls in from handler threads as well
        # as the batcher worker.
        self._lock = threading.RLock()
        self.buckets = [
            1 << p
            for p in range(_MIN_BUCKET.bit_length() - 1, self.max_bucket.bit_length())
        ]
        self._batch_seq = 0
        # Distinguishes predictors sharing one trace file (blue/green swaps
        # build a fresh Predictor per model generation).
        self._pred_id = f"{next(_PRED_IDS):06x}"

        # The tables pad to the reference's row count for this backend, so
        # an id of -1 (a slot no column filled) gathers the row the
        # reference's wrapped gather reads.
        def put(a, dt=None):
            a = np.ascontiguousarray(a)
            if not a.flags.writeable:  # a memory-mapped spool member (fleet/artifacts)
                a = a.copy()
            return torch.as_tensor(a, dtype=dt, device=self.device)

        self.col_tile = None
        if self.backend == "rpforest":
            n_pad = n + 1  # the sentinel id n gathers a zero pad row
            rpf = model.rpf
            self._rpf = tuple(put(rpf[key]) for key in ("normals", "thresholds", "members"))
            self._rpf_depth = int(rpf["depth"])
        elif self.backend == "fused":
            n_pad = _round_up(max(n, _FUSED_COL_TILE), _FUSED_COL_TILE)
        else:
            _, self.col_tile, n_pad = _tile_sizes(n, _MAX_ROW_TILE, 8192)

        f = torch.float32
        self._tables = {
            "train": put(_pad_rows(np.asarray(model.data, np.float32), n_pad), f),
            "core": put(_pad_rows(np.asarray(model.core, np.float32), n_pad), f),
            "labels": put(_pad_rows(np.asarray(model.labels, np.int64), n_pad), torch.int64),
            "last": put(_pad_rows(np.asarray(model.last_cluster, np.int64), n_pad),
                        torch.int64),
            "anc": put(_ancestor_table(np.asarray(model.parent)), torch.int64),
            "birth": put(np.asarray(model.birth, np.float32), f),
            "sel_anc": put(np.asarray(model.sel_anc, np.int64), torch.int64),
            "eps_min": put(np.asarray(model.eps_min, np.float32), f),
            "eps_max": put(np.asarray(model.eps_max, np.float32), f),
            "sel_ids": put(model.selected_ids, torch.int64),
        }
        self._train = self._tables["train"][:n]  # the kernels' column set
        if len(model.parent) != len(model.sel_anc):
            raise ValueError("model tables disagree in cluster count")

    # -- bucket plumbing ---------------------------------------------------

    def bucket_for(self, rows: int) -> int:
        """Smallest configured power-of-two bucket holding ``rows`` (the
        ceiling bucket for oversized requests, which chunk)."""
        for b in self.buckets:
            if rows <= b:
                return b
        return self.max_bucket

    def _stage(self, chunk: np.ndarray, bucket: int) -> torch.Tensor:
        """Pad one chunk to its bucket and copy it to the device."""
        xq = np.zeros((bucket, chunk.shape[1]), np.float32)
        xq[: len(chunk)] = chunk
        return torch.as_tensor(xq, device=self.device)

    def _knn(self, xq: torch.Tensor, bucket: int):
        """(bucket, k) distances and ids of the query rows: B2 or B7 on the
        card, their plain versions on the CPU."""
        metric = self.model.metric
        if self.backend == "rpforest":
            from hdbscan_tpu_torch.ops.cuda_forest import forest_rescan_topk
            from hdbscan_tpu_torch.ops.rpforest import route_queries

            normals, thresholds, members = self._rpf
            leaves = route_queries(xq, normals, thresholds, self._rpf_depth)  # (T, B)
            tree = torch.arange(members.shape[0], device=xq.device)[:, None]
            cand = members[tree, leaves]  # (T, B, Lmax)
            cand = cand.permute(1, 0, 2).reshape(xq.shape[0], -1).to(torch.int32)
            return forest_rescan_topk(xq, self._train, cand, self.k, metric, "f32",
                                      sentinel=self.model.n_train)
        from hdbscan_tpu_torch.ops.cuda_knn import knn_kbest_panel

        d = xq.shape[1]
        if self.backend == "fused":
            return knn_kbest_panel(xq, self._train, self.k, metric, "dot")
        row_tile = min(_next_pow2(max(bucket, 8)), _MAX_ROW_TILE)
        form = euclidean_form(row_tile, self.col_tile, d) if metric == "euclidean" else None
        return knn_kbest_panel(xq, self._train, self.k, metric, form, col_tile=self.col_tile)

    def _dispatch(self, staged: torch.Tensor, bucket: int, with_membership: bool):
        knn_d, knn_i = self._knn(staged, bucket)
        return _attach(knn_d, knn_i, staged, self._tables, self.kth_col, with_membership)

    # -- public API --------------------------------------------------------

    def predict(self, X, with_membership: bool = False):
        """Batched prediction: returns ``(labels, probabilities,
        outlier_scores)`` int64/float64 arrays aligned with ``X`` rows
        (plus the (n, S) membership matrix when ``with_membership``).
        Requests above ``max_bucket`` chunk."""
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X[None, :]
        if X.shape[1] != self.model.data.shape[1]:
            raise ValueError(
                f"query dims {X.shape[1]} != model dims {self.model.data.shape[1]}"
            )
        with self._lock:
            return self._predict_locked(X, with_membership)

    def _predict_locked(self, X: np.ndarray, with_membership: bool):
        if inject.maybe_fire("predict_dispatch") is not None:
            raise inject.InjectedFault("injected predict_dispatch fault")
        outs = []
        for a in range(0, max(len(X), 1), self.max_bucket):
            b = min(len(X) - a, self.max_bucket)
            bucket = self.bucket_for(b)
            # The histogram keeps its own host wall: without a tracer the
            # span is a no-op.
            t0 = time.perf_counter() if self._m_device_s is not None else 0.0
            with tracing.span("predict.bucket", hook=self.tracer, stage="predict_batch",
                              device=self.device, bucket=bucket, rows=b, pad_rows=bucket - b,
                              batch_seq=self._batch_seq, backend=self.backend,
                              pred=self._pred_id) as sp:
                with tracing.span("predict.stage"):
                    staged = self._stage(X[a : a + b], bucket)
                out = self._dispatch(staged, bucket, with_membership)
                sp.device_stop()  # before the fetch, which waits for the card
                fetched = [o[:b].cpu().numpy() for o in out]
            self._batch_seq += 1
            if self._m_batch_rows is not None:
                self._m_batch_rows.observe(b)
                self._m_device_s.observe(time.perf_counter() - t0)
            outs.append(fetched)
        label = np.concatenate([o[0] for o in outs]).astype(np.int64)
        prob = np.concatenate([o[1] for o in outs]).astype(np.float64)
        score = np.concatenate([o[2] for o in outs]).astype(np.float64)
        if with_membership:
            mvec = np.concatenate([o[3] for o in outs]).astype(np.float64)
            return label, prob, score, mvec
        return label, prob, score

    def warmup(self, with_membership: bool = False) -> dict:
        """Run zeros through every bucket (blocking), so the first real
        request finds every kernel built and loaded. Returns ``{"buckets":
        [...], "wall_s": float, "jit_compiles": int, "cache_hits": int}``,
        the reference's keys: ``jit_compiles`` counts the kernel sources this
        warmup built with nvcc and ``cache_hits`` the kernel libraries it
        loaded from the build directory without a build
        (``utils/telemetry.compile_counter``, ``cache_hit_counter``); a
        process whose kernels are already loaded reports 0 and 0."""
        from hdbscan_tpu_torch.utils.telemetry import cache_hit_counter, compile_counter

        builds, hits = compile_counter(), cache_hit_counter()
        before, hits_before = builds(), hits()
        t0 = time.perf_counter()
        d = self.model.data.shape[1]
        with self._lock:
            for bucket in self.buckets:
                for member in (False, True) if with_membership else (False,):
                    out = self._dispatch(self._stage(np.zeros((1, d)), bucket), bucket, member)
                    out[0].cpu()
        info = {
            "buckets": list(self.buckets),
            "wall_s": round(time.perf_counter() - t0, 6),
            "jit_compiles": builds() - before,
            "cache_hits": hits() - hits_before,
        }
        if self.tracer is not None:
            self.tracer("predict_warmup", **info)
        return info


def _predictor_for(model, backend, max_batch, tracer, device) -> Predictor:
    """Per-model predictor cache so the functional API reuses device state
    across calls instead of re-staging per call."""
    cache = model.__dict__.setdefault("_predictor_cache", {})
    key = (backend, max_batch, str(cuda_build.resolve_device(device)))
    if key not in cache:
        cache[key] = Predictor(
            model, backend=backend, max_batch=max_batch, tracer=tracer, device=device
        )
    pred = cache[key]
    if tracer is not None:
        pred.tracer = tracer
    return pred


def approximate_predict(
    model, X, backend: str = "auto", max_batch: int = 256, tracer=None, device=None
):
    """hdbscan-style ``(labels, probabilities)`` for unseen points ``X``
    against a fitted :class:`~hdbscan_tpu_torch.serve.artifact.ClusterModel`."""
    labels, prob, _ = _predictor_for(model, backend, max_batch, tracer, device).predict(X)
    return labels, prob


def outlier_scores(
    model, X, backend: str = "auto", max_batch: int = 256, tracer=None, device=None
):
    """GLOSH outlier scores for unseen points (score of the level at which
    each query attaches to the fitted hierarchy; clipped at 0)."""
    return _predictor_for(model, backend, max_batch, tracer, device).predict(X)[2]


def membership_vectors(
    model, X, backend: str = "auto", max_batch: int = 256, tracer=None, device=None
):
    """Soft clustering: an (n, S) matrix over ``model.selected_ids`` —
    inverse-mutual-reachability weights to each selected cluster's nearest
    fitted exemplar in the query's k-NN list, normalized per row (zero rows
    for queries whose neighborhood touches no selected cluster)."""
    return _predictor_for(model, backend, max_batch, tracer, device).predict(
        X, with_membership=True
    )[3]
