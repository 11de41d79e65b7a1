"""Serving: persist a fitted model, classify new points, serve HTTP — the
port of ``hdbscan_tpu/serve``, with the reference's exports.

- ``serve/artifact.py`` — schema-versioned :class:`ClusterModel` saved as one
  atomic ``.npz`` in the reference's layout (either package loads the
  other's);
- ``serve/predict.py`` — batched :func:`approximate_predict` (query k-NN
  against the training set on the rectangular k-best kernel, or the
  stored rp-forest's candidates on the rescan top-k kernel, then the
  attachment level and the climb), :func:`membership_vectors` and GLOSH
  :func:`outlier_scores` for unseen points;
- ``serve/batcher.py`` — :class:`MicroBatcher` coalescing concurrent
  requests into padded power-of-two buckets;
- ``serve/server.py`` — stdlib HTTP ``/predict`` + ``/healthz`` +
  ``/metrics`` + ``/swap`` (plus ``/ingest`` in streaming mode —
  ``hdbscan_tpu_torch/stream``) with blue/green model-handle swaps.
"""

from hdbscan_tpu_torch.serve.artifact import MODEL_SCHEMA, ClusterModel  # noqa: F401
from hdbscan_tpu_torch.serve.batcher import MicroBatcher  # noqa: F401
from hdbscan_tpu_torch.serve.predict import (  # noqa: F401
    Predictor,
    approximate_predict,
    membership_vectors,
    outlier_scores,
)
from hdbscan_tpu_torch.serve.server import ClusterServer  # noqa: F401
