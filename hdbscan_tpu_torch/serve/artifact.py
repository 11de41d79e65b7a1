"""Schema-versioned model artifact: one atomic ``.npz`` per fitted model —
the port of ``hdbscan_tpu/serve/artifact.py``, format for format.

:class:`ClusterModel` is the persistent form of a fit: everything
``serve/predict.approximate_predict`` needs to classify new points against
the fitted hierarchy — training points + per-row core distances (the k-NN
reference set), the condensed-tree arrays (parent/birth chains for the
attachment climb), the selected-cluster set with its flat-label jump table,
per-selected-cluster max-lambda (membership probabilities) and per-cluster
GLOSH ``eps_max`` — plus a params fingerprint reusing ``utils/checkpoint``'s
digest scheme so a model can never silently serve the wrong dataset or
parameterization.

Every array is numpy and the layout is the reference's ``.npz`` (the same
keys, dtypes and JSON ``meta`` record), so a model saved by either package
loads in the other with no conversion step.

Deduplicated fits are stored expanded to ROW space (labels/cores already are;
the tree's per-point arrays translate through ``dedup_inverse``), so the
artifact is self-contained: predict never needs the fit-time vertex maps.
MR/data-bubble fits store the full training rows under the global/hybrid
core vector.

Save is atomic (tempfile + ``os.replace``); load refuses a mismatched schema
version, a corrupt payload (stored-data digest != stored fingerprint), and —
when the caller supplies ``params``/``data`` — a mismatched fingerprint.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass

import numpy as np

from hdbscan_tpu_torch.fault import inject
from hdbscan_tpu_torch.utils.checkpoint import _data_digest

#: Version tag carried by every model artifact. Bump the integer suffix on
#: any backwards-incompatible array-layout change; ``load`` refuses other
#: versions outright (a served prediction from misread arrays is silent
#: corruption, unlike a checkpoint, which can just start fresh).
#: ``/2`` adds the OPTIONAL rp-forest index arrays (``rpf_*``) so servers
#: can answer approximate_predict sub-quadratically; every ``/1`` array is
#: unchanged, so ``/1`` artifacts still load (they simply carry no index).
MODEL_SCHEMA = "hdbscan-tpu-model/2"

#: Schemas :meth:`ClusterModel.load` accepts. ``/1`` is the pre-rpforest
#: layout — a strict subset of ``/2`` — and loads with ``rpf=None``.
_COMPAT_SCHEMAS = ("hdbscan-tpu-model/1", MODEL_SCHEMA)

#: The arrays of a stored rp-forest index (``ops/rpforest.RPForest`` field
#: order); the artifact stores each under an ``rpf_`` key prefix.
_RPF_ARRAYS = ("normals", "thresholds", "members", "leaf_mask")

#: The parameter fields that must match for a model to serve a dataset —
#: the serve-relevant subset of ``utils/checkpoint._fingerprint`` (fit-only
#: knobs like ``k`` or ``refine_iterations`` are baked into the stored tree
#: and need not match at load time).
_FINGERPRINT_FIELDS = ("min_points", "min_cluster_size", "dist_function")


def _rpf_pack(forest) -> dict:
    """Host-side dict form of an ``ops/rpforest.RPForest`` for storage."""
    return {
        "trees": int(forest.trees),
        "depth": int(forest.depth),
        "leaf_size": int(forest.leaf_size),
        "normals": np.asarray(forest.normals, np.float32),
        "thresholds": np.asarray(forest.thresholds, np.float32),
        "members": np.asarray(forest.members, np.int32),
        "leaf_mask": np.asarray(forest.leaf_mask, bool),
    }


def _fingerprint(params, n: int, data_digest: str | None) -> dict:
    fp = {"n": int(n), "data": data_digest}
    for f in _FINGERPRINT_FIELDS:
        fp[f] = getattr(params, f)
    return fp


@dataclass
class ClusterModel:
    """A fitted clustering, ready to classify unseen points.

    Per-row arrays (length n, ROW space even for deduplicated fits):
    ``data``/``core``/``labels``/``last_cluster``. Per-cluster arrays
    (length C+1, 1-indexed labels, 0 unused — ``core/tree.CondensedTree``
    layout): ``parent``/``birth``/``selected``/``sel_anc``/``eps_min``/
    ``eps_max``.
    """

    mode: str  # "exact" | "mr"
    params: dict  # the _FINGERPRINT_FIELDS subset, as plain values
    fingerprint: dict
    data: np.ndarray  # (n, d) float64 training points
    core: np.ndarray  # (n,) float64 core distances
    labels: np.ndarray  # (n,) int64 fitted flat labels (0 = noise)
    last_cluster: np.ndarray  # (n,) int64 deepest cluster per point
    parent: np.ndarray  # (C+1,) int64 cluster parent (-1 root, 0 unused)
    birth: np.ndarray  # (C+1,) float64 cluster birth eps (inf at root)
    selected: np.ndarray  # (C+1,) bool EOM solution set
    sel_anc: np.ndarray  # (C+1,) int64 nearest selected ancestor-or-self
    eps_min: np.ndarray  # (C+1,) float64 per-selected-cluster min exit eps
    eps_max: np.ndarray  # (C+1,) float64 lowest descendant death (GLOSH)
    schema: str = MODEL_SCHEMA
    #: Optional rp-forest index (schema /2): ``{"trees", "depth",
    #: "leaf_size"}`` ints plus the ``ops/rpforest.RPForest`` arrays —
    #: ``normals`` (T, 2^depth - 1, d) f32, ``thresholds`` (T, 2^depth - 1)
    #: f32, ``members`` (T, L, Lmax) i32, ``leaf_mask`` (L, Lmax) bool.
    #: ``serve/predict`` routes queries down the stored planes instead of
    #: scanning all n train rows when ``predict_backend="rpforest"``.
    rpf: dict | None = None

    @property
    def n_train(self) -> int:
        return len(self.data)

    @property
    def min_points(self) -> int:
        return int(self.params["min_points"])

    @property
    def metric(self) -> str:
        return str(self.params["dist_function"])

    @property
    def selected_ids(self) -> np.ndarray:
        """The selected cluster labels, ascending — the column order of
        :func:`serve.predict.membership_vectors`."""
        return np.flatnonzero(self.selected).astype(np.int64)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_fit_result(
        cls, result, data: np.ndarray, params, forest=None, *, device=None
    ) -> "ClusterModel":
        """Build the artifact from a fit result (``models/hdbscan.
        HDBSCANResult`` or ``models/mr_hdbscan.MRHDBSCANResult``) plus the
        training data and params it was fitted with.

        Consensus results are stored as their REPRESENTATIVE draw's tree
        with the consensus flat labels — the same mixed provenance the
        five-file output set documents (``write_outputs`` sidecar).

        ``forest``: an ``ops/rpforest.RPForest`` to embed as the artifact's
        serving index. When omitted and ``params.knn_index`` resolves to
        rpforest for this n, a forest is built here (same knobs and seed the
        fit's scans used), so an approximate fit round-trips into an
        approximate-serving artifact with no extra caller step. That build
        runs on ``device`` (the card unless the caller names another, as
        the fits do); nothing else here touches a device.
        """
        from hdbscan_tpu_torch.models._finalize import serving_tables

        data = np.asarray(data, np.float64)
        if data.ndim == 1:
            data = data[:, None]
        n = len(data)
        tree = result.tree
        labels = np.asarray(result.labels, np.int64)
        core = np.asarray(result.core_distances, np.float64)
        if len(labels) != n or len(core) != n:
            raise ValueError(
                f"result arrays (n={len(labels)}) do not match data (n={n})"
            )
        inv = getattr(result, "dedup_inverse", None)
        last = np.asarray(tree.point_last_cluster, np.int64)
        if inv is not None:
            last = last[inv]
        tables = serving_tables(tree)
        mode = "mr" if hasattr(result, "n_levels") else "exact"
        rpf = None
        if forest is not None:
            rpf = _rpf_pack(forest)
        elif getattr(params, "knn_index", "exact") != "exact":
            from hdbscan_tpu_torch.ops.rpforest import build_forest, resolve_knn_index

            index = resolve_knn_index(
                params.knn_index, n,
                getattr(params, "knn_index_threshold", 1),
            )
            if index == "rpforest":
                k = max(getattr(params, "min_points", 2) - 1, 1)
                leaf_size = max(
                    getattr(params, "rpf_leaf_size", 1024), 2 * k + 2, 8
                )
                rpf = _rpf_pack(
                    build_forest(
                        data,
                        trees=getattr(params, "rpf_trees", 4),
                        leaf_size=min(leaf_size, max(n, 2)),
                        seed=getattr(params, "seed", 0),
                        device=device,
                    )
                )
        return cls(
            mode=mode,
            params={f: getattr(params, f) for f in _FINGERPRINT_FIELDS},
            fingerprint=_fingerprint(params, n, _data_digest(data)),
            data=data,
            core=core,
            labels=labels,
            last_cluster=last,
            parent=np.asarray(tree.parent, np.int64),
            birth=np.asarray(tree.birth, np.float64),
            selected=np.asarray(tree.selected, bool),
            sel_anc=np.asarray(tables["sel_anc"], np.int64),
            eps_min=np.asarray(tables["eps_min"], np.float64),
            eps_max=np.asarray(tables["eps_max"], np.float64),
            rpf=rpf,
        )

    # -- persistence -------------------------------------------------------

    def save(self, path: str, *, compress: bool = True) -> str:
        """Write the artifact atomically (tempfile + ``os.replace``, the
        ``utils/checkpoint`` pattern: a crashed save never leaves a
        half-written model where a server could load it).

        ``compress=False`` stores members uncompressed (``np.savez``):
        larger on disk, but the per-host ``fleet.artifacts.ArtifactStore``
        can then spool and memory-map the arrays without a decompression
        copy. Either form loads in both packages."""
        out_dir = os.path.dirname(os.path.abspath(path))
        os.makedirs(out_dir, exist_ok=True)
        meta = {
            "schema": self.schema,
            "mode": self.mode,
            "params": self.params,
            "fingerprint": self.fingerprint,
        }
        extra = {}
        if self.rpf is not None:
            meta["rpf"] = {
                k: int(self.rpf[k]) for k in ("trees", "depth", "leaf_size")
            }
            extra = {f"rpf_{k}": self.rpf[k] for k in _RPF_ARRAYS}
        fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".tmp")
        os.close(fd)
        savez = np.savez_compressed if compress else np.savez
        try:
            with open(tmp, "wb") as f:
                savez(
                    f,
                    meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                    data=self.data,
                    core=self.core,
                    labels=self.labels,
                    last_cluster=self.last_cluster,
                    parent=self.parent,
                    birth=self.birth,
                    selected=self.selected,
                    sel_anc=self.sel_anc,
                    eps_min=self.eps_min,
                    eps_max=self.eps_max,
                    **extra,
                )
            # Fault sites: a "torn" save crashes between
            # the tempfile write and the atomic rename — proving a crashed
            # publish leaves no partial artifact where a server could load
            # it; "digest" corrupts the published bytes so load's stored-
            # digest check must catch them.
            act = inject.maybe_fire("artifact_save")
            if act is not None and act.mode != "digest":
                raise inject.InjectedFault(
                    "injected artifact_save crash before publish rename"
                )
            os.replace(tmp, path)
            if act is not None and act.mode == "digest":
                with open(path, "r+b") as f:
                    f.seek(-1, os.SEEK_END)
                    last = f.read(1)[0]
                    f.seek(-1, os.SEEK_END)
                    f.write(bytes([last ^ 0xFF]))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return path

    @classmethod
    def load(cls, path: str, params=None, data=None) -> "ClusterModel":
        """Load and verify an artifact.

        Raises ``ValueError`` on (1) a schema version this build cannot read
        (``/1`` loads compatibly with no index; ``/2`` is current) — arrays
        of another layout must not be misread;
        (2) a corrupt payload — the stored training data's digest must equal
        the stored fingerprint's; (3) a fingerprint mismatch against the
        caller's ``params`` and/or ``data`` when supplied (a server asked to
        serve config X with a model fitted under config Y must refuse, the
        ``utils/checkpoint.load_latest`` stance).
        """
        if inject.maybe_fire("artifact_load") is not None:
            raise inject.InjectedFault("injected transient artifact_load fault")
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            schema = meta.get("schema")
            if schema not in _COMPAT_SCHEMAS:
                raise ValueError(
                    f"model {path} has schema {schema!r}; this build reads "
                    f"{' / '.join(map(repr, _COMPAT_SCHEMAS))} only"
                )
            rpf = None
            if meta.get("rpf") is not None:
                rpf = dict(meta["rpf"])
                for key in _RPF_ARRAYS:
                    rpf[key] = z[f"rpf_{key}"]
            model = cls(
                mode=meta["mode"],
                params=meta["params"],
                fingerprint=meta["fingerprint"],
                data=z["data"],
                core=z["core"],
                labels=z["labels"],
                last_cluster=z["last_cluster"],
                parent=z["parent"],
                birth=z["birth"],
                selected=z["selected"],
                sel_anc=z["sel_anc"],
                eps_min=z["eps_min"],
                eps_max=z["eps_max"],
                schema=schema,
                rpf=rpf,
            )
        stored_digest = model.fingerprint.get("data")
        if stored_digest is not None and _data_digest(model.data) != stored_digest:
            raise ValueError(
                f"model {path} is corrupt: stored training data digest does "
                f"not match its fingerprint ({stored_digest})"
            )
        if params is not None or data is not None:
            want = dict(model.fingerprint)
            if params is not None:
                for f in _FINGERPRINT_FIELDS:
                    want[f] = getattr(params, f)
            if data is not None:
                arr = np.asarray(data, np.float64)
                if arr.ndim == 1:
                    arr = arr[:, None]
                want["n"] = len(arr)
                want["data"] = _data_digest(arr)
            if want != model.fingerprint:
                raise ValueError(
                    f"model {path} was fitted for {model.fingerprint}, "
                    f"caller expects {want}; refusing to serve"
                )
        return model

    def summary(self) -> dict:
        """Small JSON-safe description (the ``/healthz`` payload core)."""
        out = {
            "schema": self.schema,
            "mode": self.mode,
            "n_train": int(self.n_train),
            "dims": int(self.data.shape[1]),
            "n_clusters": int(len(self.parent) - 1),
            "n_selected": int(self.selected.sum()),
            "params": dict(self.params),
        }
        if self.rpf is not None:
            out["rpf"] = {
                k: int(self.rpf[k]) for k in ("trees", "depth", "leaf_size")
            }
        return out
