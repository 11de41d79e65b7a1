"""Run telemetry — for now only :func:`json_sanitize`, the value coercion
every ``JsonlSink`` line goes through (the port of
``hdbscan_tpu/utils/telemetry.py:53-72``).

The rest of the reference's module (the run manifest, the ``--report``
builder, per-phase aggregates, compile counters, device-memory samples)
is not ported yet (ROADMAP A11).
"""

from __future__ import annotations


def json_sanitize(obj):
    """Recursively coerce numpy and torch scalars and arrays, tuples and
    other non-JSON values to plain Python so ``json.dumps`` never trips on a
    trace field. A torch tensor becomes its number (0-d) or nested list, as
    a numpy array does."""
    import numpy as np
    import torch

    if isinstance(obj, dict):
        return {str(k): json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_sanitize(v) for v in obj]
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return json_sanitize(obj.tolist())
    if isinstance(obj, (np.bool_, bool)):
        return bool(obj)
    if isinstance(obj, (np.integer, int)):
        return int(obj)
    if isinstance(obj, (np.floating, float)):
        return float(obj)
    if obj is None or isinstance(obj, str):
        return obj
    return str(obj)
