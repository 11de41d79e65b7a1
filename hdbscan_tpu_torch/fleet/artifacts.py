"""Per-host zero-copy artifact store: one resident copy per digest — a
host-only copy of ``hdbscan_tpu/fleet/artifacts.py``.

The static fleet pays tenant model memory once per REPLICA: every replica's
``TenantRegistry`` privately ``ClusterModel.load``s the same ``.npz``, so a
host running R replicas over T tenants holds R×T copies of the training
arrays. :class:`ArtifactStore` collapses that to one copy per host:

* **Digest-keyed** — an artifact is identified by the sha256 of its file
  bytes (the same digest discipline ``serve/artifact.py`` applies to the
  payload). Two tenants publishing byte-identical artifacts share one
  mapping; a republished generation has a new digest and maps fresh.
* **Spool + mmap** — on first touch the store validates the artifact
  through the unchanged ``ClusterModel.load`` path (schema allow-list,
  stored-digest == fingerprint check), then spools each array member to a
  plain ``.npy`` under ``spool_dir/<digest>/`` and re-opens them with
  ``np.load(..., mmap_mode="r")``. Every replica process on the host that
  loads the same digest maps the same spool files, so the training arrays
  live once in the OS page cache no matter how many replicas serve them.
  (``np.load`` cannot mmap *inside* an ``.npz`` zip — compressed or not,
  members are read through zipfile — which is why the spool exists.)
* **Process cache** — within one process, repeat loads of a digest return
  the same :class:`~hdbscan_tpu_torch.serve.artifact.ClusterModel` object,
  so a registry re-warming an evicted tenant pays zero array I/O. Entries
  live for the life of the process: the host-level cost is bounded by
  distinct artifacts, not by LRU traffic.

The spool is the reference's layout (``meta.json`` plus one ``.npy`` per
member, ``rpf_<key>.npy`` for a forest) in the same default directory
(``$HDBSCAN_TPU_ARTIFACT_SPOOL``, else ``<tmp>/hdbscan_tpu_artifacts_<uid>``),
so a spool either package wrote loads in the other.

What the mmap saves on the card, and what it does not: it saves host
memory only (one page-cache copy of the arrays per host). Each replica's
``Predictor`` still copies its resident tenants' tables into its own CUDA
context, so device memory is paid once per replica per resident tenant
(bounded by ``tenant_lru_size``), plus each replica's own context. No
device memory is shared between processes.

Every load emits an ``artifact_map`` trace event (validated by
``scripts/check_trace.py``: per process a digest maps fresh — ``hit=false``
— at most once) and the ``hdbscan_tpu_artifact_*`` metric families.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
import time

import numpy as np

__all__ = ["ArtifactStore", "default_store", "file_digest"]

#: Array members every artifact carries (``serve/artifact.ClusterModel``
#: field order); optional ``rpf_*`` members ride alongside.
_MEMBERS = (
    "data", "core", "labels", "last_cluster", "parent", "birth",
    "selected", "sel_anc", "eps_min", "eps_max",
)

_CHUNK = 1 << 20


def file_digest(path: str) -> str:
    """sha256 of the file bytes — the store's identity for an artifact."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(_CHUNK)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _default_spool_dir() -> str:
    env = os.environ.get("HDBSCAN_TPU_ARTIFACT_SPOOL")
    if env:
        return env
    uid = os.getuid() if hasattr(os, "getuid") else 0
    return os.path.join(tempfile.gettempdir(), f"hdbscan_tpu_artifacts_{uid}")


class ArtifactStore:
    """Host-shared, digest-keyed cache of memory-mapped ClusterModels.

    Args:
      spool_dir: directory for the per-digest ``.npy`` spools. Defaults to
        ``$HDBSCAN_TPU_ARTIFACT_SPOOL`` or a per-user tmp path — every
        replica on the host must resolve the same directory for the page
        cache to be shared.
      mmap: open spooled members with ``mmap_mode="r"`` (default). False
        materializes (still one copy per process per digest) — for
        filesystems where mmap misbehaves.
      tracer / metrics: ``artifact_map`` trace events and the
        ``hdbscan_tpu_artifact_*`` instruments.
    """

    def __init__(self, spool_dir: str | None = None, *, mmap: bool = True,
                 tracer=None, metrics=None):
        self.spool_dir = spool_dir or _default_spool_dir()
        self.mmap = bool(mmap)
        self.tracer = tracer
        self._lock = threading.Lock()
        self._cache: dict = {}  # digest -> ClusterModel
        self._refs: dict = {}  # digest -> load count
        self._bytes: dict = {}  # digest -> resident array bytes
        self._m_loads = self._m_resident = self._m_bytes = None
        if metrics is not None:
            self._m_loads = metrics.counter(
                "hdbscan_tpu_artifact_loads_total",
                "Artifact-store loads by outcome (hit = process cache).",
                ("outcome",),
            )
            self._m_resident = metrics.gauge(
                "hdbscan_tpu_artifact_resident",
                "Distinct artifact digests resident in this process.",
            )
            self._m_bytes = metrics.gauge(
                "hdbscan_tpu_artifact_resident_bytes",
                "Array bytes mapped by resident artifacts (shared per host).",
            )

    # -- spool -------------------------------------------------------------

    def _spool_path(self, digest: str) -> str:
        return os.path.join(self.spool_dir, digest)

    def _write_spool(self, model, digest: str) -> bool:
        """Spool ``model``'s arrays under ``<spool_dir>/<digest>/``;
        returns True when this call published the spool (False when a
        sibling process won the rename race)."""
        final = self._spool_path(digest)
        if os.path.isdir(final):
            return False
        os.makedirs(self.spool_dir, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=self.spool_dir, prefix=f".{digest[:12]}.")
        try:
            meta = {
                "schema": model.schema,
                "mode": model.mode,
                "params": model.params,
                "fingerprint": model.fingerprint,
                "rpf": None if model.rpf is None else {
                    k: int(model.rpf[k])
                    for k in ("trees", "depth", "leaf_size")
                },
            }
            with open(os.path.join(tmp, "meta.json"), "w",
                      encoding="utf-8") as f:
                json.dump(meta, f)
            for name in _MEMBERS:
                np.save(os.path.join(tmp, f"{name}.npy"),
                        np.asarray(getattr(model, name)))
            if model.rpf is not None:
                from hdbscan_tpu_torch.serve.artifact import _RPF_ARRAYS

                for key in _RPF_ARRAYS:
                    np.save(os.path.join(tmp, f"rpf_{key}.npy"),
                            np.asarray(model.rpf[key]))
            try:
                os.rename(tmp, final)
                return True
            except OSError:
                return False  # concurrent spooler won; theirs is complete
        finally:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp, ignore_errors=True)

    def _read_spool(self, digest: str):
        """Reconstruct a ClusterModel from a spool, arrays memory-mapped.
        Returns None when the spool is absent or unreadable (caller falls
        back to the .npz)."""
        from hdbscan_tpu_torch.serve.artifact import (
            _COMPAT_SCHEMAS, _RPF_ARRAYS, ClusterModel,
        )
        from hdbscan_tpu_torch.utils.checkpoint import _data_digest

        root = self._spool_path(digest)
        mode = "r" if self.mmap else None
        try:
            with open(os.path.join(root, "meta.json"),
                      encoding="utf-8") as f:
                meta = json.load(f)
            if meta.get("schema") not in _COMPAT_SCHEMAS:
                return None
            arrays = {
                name: np.load(os.path.join(root, f"{name}.npy"),
                              mmap_mode=mode)
                for name in _MEMBERS
            }
            rpf = None
            if meta.get("rpf") is not None:
                rpf = dict(meta["rpf"])
                for key in _RPF_ARRAYS:
                    rpf[key] = np.load(os.path.join(root, f"rpf_{key}.npy"),
                                       mmap_mode=mode)
            model = ClusterModel(
                mode=meta["mode"], params=meta["params"],
                fingerprint=meta["fingerprint"], schema=meta["schema"],
                rpf=rpf, **arrays,
            )
        except (OSError, ValueError, KeyError):
            return None
        # Same corruption stance as ClusterModel.load: the spooled training
        # data must still hash to the stored fingerprint (a torn or tampered
        # spool must not serve).
        stored = model.fingerprint.get("data")
        if stored is not None and _data_digest(np.asarray(model.data)) != stored:
            return None
        return model

    # -- load --------------------------------------------------------------

    def load(self, path: str):
        """Resolve ``path`` to a (possibly shared) ClusterModel.

        First touch of a digest validates through ``ClusterModel.load``
        (or an existing sibling spool), publishes the spool, and maps it;
        repeat touches return the process-cached model. Raises whatever
        ``ClusterModel.load`` raises on a corrupt/mismatched artifact.
        """
        t0 = time.perf_counter()
        digest = file_digest(path)
        with self._lock:
            model = self._cache.get(digest)
            if model is not None:
                self._refs[digest] += 1
                self._emit(path, digest, hit=True, spooled=False, t0=t0)
                return model
        # Miss: validate + spool outside the lock (loads can be slow), then
        # publish under it. A concurrent same-digest load does duplicate
        # work but both land on one cache entry.
        spooled = False
        model = self._read_spool(digest)
        if model is None:
            from hdbscan_tpu_torch.serve.artifact import ClusterModel

            loaded = ClusterModel.load(path)
            spooled = self._write_spool(loaded, digest)
            model = self._read_spool(digest) or loaded
        with self._lock:
            if digest in self._cache:  # concurrent loader published first
                model = self._cache[digest]
                self._refs[digest] += 1
                self._emit(path, digest, hit=True, spooled=spooled, t0=t0)
                return model
            self._cache[digest] = model
            self._refs[digest] = 1
            self._bytes[digest] = int(
                sum(np.asarray(getattr(model, m)).nbytes for m in _MEMBERS)
            )
            self._emit(path, digest, hit=False, spooled=spooled, t0=t0)
            return model

    def _emit(self, path: str, digest: str, *, hit: bool, spooled: bool,
              t0: float) -> None:
        # caller holds the lock
        if self._m_loads is not None:
            self._m_loads.inc(outcome="hit" if hit else "miss")
            self._m_resident.set(len(self._cache))
            self._m_bytes.set(float(sum(self._bytes.values())))
        if self.tracer is not None:
            self.tracer(
                "artifact_map", digest=digest, path=str(path),
                hit=bool(hit), spooled=bool(spooled),
                resident=len(self._cache),
                bytes=int(self._bytes.get(digest, 0)),
                refs=int(self._refs.get(digest, 0)),
                wall_s=round(time.perf_counter() - t0, 6),
            )

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "spool_dir": self.spool_dir,
                "resident": len(self._cache),
                "resident_bytes": int(sum(self._bytes.values())),
                "refs": dict(self._refs),
            }


_DEFAULT_LOCK = threading.Lock()
_DEFAULT: ArtifactStore | None = None


def default_store(tracer=None, metrics=None) -> ArtifactStore:
    """The process-wide store (created on first use). ``tracer``/
    ``metrics`` attach on the creating call only — later callers share the
    instance as-is."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = ArtifactStore(tracer=tracer, metrics=metrics)
        return _DEFAULT
