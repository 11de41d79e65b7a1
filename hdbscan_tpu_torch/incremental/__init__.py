"""Online hierarchy maintenance: absorb the stream without re-fitting — a
host-only copy of ``hdbscan_tpu/incremental`` with the same names.

Layered between ``stream/`` (which decides *what* is novel) and ``serve/``
(which publishes models): :mod:`~hdbscan_tpu_torch.incremental.insert`
maintains the mutual-reachability MST under bounded per-point updates,
:mod:`~hdbscan_tpu_torch.incremental.subtree` re-finalizes the hierarchy
with dirty-subtree reuse. The server drives both when
``stream_maintain="incremental"``; a :class:`MaintainFallback` demotes the
stream to the circuit-gated full re-fit. Both run in numpy on the host, as
the reference's do, so a maintainer of either package reaches the same
MST digests from the same rows.
"""

from hdbscan_tpu_torch.incremental.insert import (
    HierarchyMaintainer,
    MaintainFallback,
    f32_distances,
    host_knn_rows,
    host_mst,
)
from hdbscan_tpu_torch.incremental.subtree import (
    DirtySubtreeFinalizer,
    ResumableForestBuilder,
    finalize_from_mst,
)

__all__ = [
    "HierarchyMaintainer",
    "MaintainFallback",
    "DirtySubtreeFinalizer",
    "ResumableForestBuilder",
    "finalize_from_mst",
    "f32_distances",
    "host_knn_rows",
    "host_mst",
]
