"""Per-level checkpoint/resume for the distributed pipeline — a copy of the
reference package's ``utils/checkpoint.py``: the same file format, data
digest and parameter fingerprint, so a checkpoint written by either package
resumes in the other.

The reference checkpoints implicitly: every stage boundary is a
``saveAsObjectFile`` to HDFS (``_unprocessed_<i>``, ``_local_mst<i>``, ... —
``main/Main.java:101,199,230,238,265,298``; SURVEY.md §5.4), so a crashed
main program can re-run from the last level's files. Here that capability
is explicit and compact: one ``.npz`` per completed level holding the
entire pipeline state (subset assignment, processed mask, core distances, pooled MST
edges, RNG state), written atomically; ``load_latest`` resumes from the
newest level whose parameter fingerprint matches.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

_PREFIX = "mr_level_"


#: Digest scheme version. A checkpoint written under a different scheme is
#: treated as absent (fresh start) rather than raising: the digest exists to
#: catch silent wrong-data resumes, not to brick old checkpoint dirs.
_DIGEST_SCHEME = "v2-"


def _data_digest(data) -> str:
    """Dataset identity: shape + a hash over the full buffer. One sequential
    pass (~6 MB for the 245k north-star set) is cheap next to any fit, and
    unlike a strided row sample it catches edits anywhere in the data, so a
    stale checkpoint can never resume silently. hashlib consumes the array
    via the buffer protocol — no host-RAM copy of multi-GB datasets."""
    import hashlib

    a = np.ascontiguousarray(data)
    h = hashlib.sha1()
    h.update(str(a.shape).encode())
    h.update(str(a.dtype).encode())
    h.update(a)
    return _DIGEST_SCHEME + h.hexdigest()[:16]


def _fingerprint(params, n: int, data_digest: str | None = None) -> dict:
    """The parameters that must match for a checkpoint to be resumable."""
    return {
        "n": int(n),
        "data": data_digest,
        "min_points": params.min_points,
        "min_cluster_size": params.min_cluster_size,
        "processing_units": params.processing_units,
        "k": params.k,
        "dist_function": params.dist_function,
        "variant": params.variant,
        "seed": params.seed,
        "exact_inter_edges": params.exact_inter_edges,
        "global_core_distances": params.global_core_distances,
        "boundary_quality": params.boundary_quality,
    }


def save_level(
    ckpt_dir: str,
    level: int,
    params,
    data_digest: str,
    subset: np.ndarray,
    processed: np.ndarray,
    core: np.ndarray,
    pool_u: np.ndarray,
    pool_v: np.ndarray,
    pool_w: np.ndarray,
    rng_state: dict,
    level_stats: list[dict],
    bmargin: np.ndarray | None = None,
    final_block: np.ndarray | None = None,
) -> str:
    """Write the post-level pipeline state; atomic via rename."""
    os.makedirs(ckpt_dir, exist_ok=True)
    meta = {
        "level": level,
        "fingerprint": _fingerprint(params, len(subset), data_digest),
        "rng_state": rng_state,
        "level_stats": level_stats,
    }
    path = os.path.join(ckpt_dir, f"{_PREFIX}{level:04d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f,
                meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                subset=subset,
                processed=processed,
                core=core,
                pool_u=pool_u,
                pool_v=pool_v,
                pool_w=pool_w,
                bmargin=bmargin if bmargin is not None else np.zeros(0),
                final_block=final_block if final_block is not None else np.zeros(0),
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_latest(ckpt_dir: str, params, n: int, data_digest: str | None = None) -> dict | None:
    """Newest matching checkpoint as a dict, or None.

    A checkpoint with a different parameter fingerprint raises — resuming a
    different configuration silently would corrupt results.
    """
    if not os.path.isdir(ckpt_dir):
        return None
    files = sorted(
        f for f in os.listdir(ckpt_dir) if f.startswith(_PREFIX) and f.endswith(".npz")
    )
    if not files:
        return None
    # Newest-to-oldest: files written under an older digest scheme are
    # unverifiable — skip them (rather than abort) so the newest
    # verifiable checkpoint still resumes.
    want = _fingerprint(params, n, data_digest)
    path = meta = None
    for name in reversed(files):
        cand = os.path.join(ckpt_dir, name)
        with np.load(cand) as z:
            m = json.loads(bytes(z["meta"]).decode())
        have = m["fingerprint"]
        if data_digest is not None and (have.get("data") or "").partition("-")[0] != (
            data_digest.partition("-")[0]
        ):
            continue
        path, meta = cand, m
        break
    if path is None:
        return None  # only older-scheme checkpoints present: start fresh
    if meta["fingerprint"] != want:
        raise ValueError(
            f"checkpoint {path} was written for {meta['fingerprint']}, "
            f"current run is {want}; pass a fresh checkpoint_dir"
        )
    with np.load(path) as z:
        return {
            "level": meta["level"],
            "rng_state": meta["rng_state"],
            "level_stats": meta["level_stats"],
            "subset": z["subset"],
            "processed": z["processed"],
            "core": z["core"],
            "pool_u": z["pool_u"],
            "pool_v": z["pool_v"],
            "pool_w": z["pool_w"],
            "bmargin": (
                z["bmargin"]
                if "bmargin" in z.files and len(z["bmargin"])
                else None
            ),
            "final_block": (
                z["final_block"]
                if "final_block" in z.files and len(z["final_block"])
                else None
            ),
        }
