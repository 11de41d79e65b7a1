"""Batcher: the 95th percentile, over the window's requests, of the time
from ``submit`` to the dispatch of the batch that carried the request
(the ``meta`` marks the batcher fills), ms."""

import numpy as np


def read(ctx):
    q = ctx["queue_ms"]
    return float(np.percentile(q, 95)) if q else None
