"""Streaming ingest: online maintenance of a served model — the port of
``hdbscan_tpu/stream`` (host-only copies, the same names and formats).

- ``stream/buffer.py`` — :class:`IngestBuffer`: arriving points route
  through the served predict path; exact duplicates of training rows and
  near-duplicates are absorbed into per-cluster **bubble summaries**
  (count / linear sum / squared sum); only genuinely novel points are
  buffered.
- ``stream/drift.py`` — :class:`DriftDetector`: a streaming histogram of
  GLOSH outlier scores plus per-cluster assignment rates, compared against
  the fit-time baseline with a PSI- or KS-style statistic; emits
  ``drift_check`` trace events.
- ``stream/refit.py`` — :class:`Refitter`: on a drift trigger or a buffered
  point budget, re-fits in a background worker thread on the server's
  device and publishes a schema-versioned artifact for the server to
  hot-swap.
- ``stream/wal.py`` — :class:`StreamJournal`: crash-safe durability for
  buffer + drift state via an fsync'd JSONL write-ahead log and periodic
  atomic snapshots, in the reference's on-disk format (a journal written
  by either package recovers in the other).
"""

from hdbscan_tpu_torch.stream.buffer import IngestBuffer  # noqa: F401
from hdbscan_tpu_torch.stream.drift import DriftDetector  # noqa: F401
from hdbscan_tpu_torch.stream.refit import Refitter  # noqa: F401
from hdbscan_tpu_torch.stream.wal import StreamJournal  # noqa: F401
