"""Pairwise distances on torch tensors — the port of ``core/distances.py``.

Every metric is a pairwise-matrix function ``(n, d) x (m, d) -> (n, m)``
on tensors of one device. Euclidean keeps the reference's two forms and
its switch between them (``_sq_euclidean``): the difference form below
``_DIFF_FORM_BUDGET`` broadcast elements per tile, the dot-product
expansion ``|x|^2 + |y|^2 - 2 x.y`` above it. Parity with the reference
depends on choosing the same form at the same tile shape, so the callers
pass the form the reference would pick (:func:`euclidean_form`).

Both euclidean forms accumulate over the feature axis one feature at a time
with separate multiplies and adds, in ascending feature order, and take
correctly rounded square roots (:func:`sqrt_rn`). That is the arithmetic of
the CUDA kernels built with ``-fmad=false`` (``ops/cuda_segmin``,
``ops/cuda_knn``), so a kernel and this plain version agree bitwise on any
input. With the reference's XLA scans they agree bitwise on integer grids
(every partial sum is exact and every root correctly rounded there) and
within 2 ulp on continuous data (XLA's fused CPU square root is not
correctly rounded).

Cosine (:func:`_cosine`) is the dot form's loop too: the cross term and
both squared norms in ascending feature order with separate multiplies and
adds, the norms rooted by :func:`sqrt_rn`, then ``1 - cross / (nx * ny)``
with an IEEE division: the CUDA kernels' metric code 6 (``csrc/
distance.cuh``) repeats it. Pearson is cosine over rows centred once
(:func:`centre_rows`: each row's in-order sum over d, subtracted), exactly
the reference's ``cosine(x - mean, y - mean)`` over the d real features;
the kernel wrappers centre their points before the launch
(``ops/cuda_build.kernel_points``). A zero-norm row (a zero row at cosine,
a constant row at pearson; :func:`zero_rows`) has NaN distances to every
row, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

#: The metric vocabulary of the reference CLI flag ``dist_function``
#: (``main/Main.java:475-488``).
METRICS = ("euclidean", "manhattan", "supremum", "cosine", "pearson")

DEFAULT_METRIC = "euclidean"

#: Broadcast-element budget of the difference form (the reference's
#: ``core/distances._DIFF_FORM_BUDGET``): a (rows, cols, d) tile at or
#: below it takes the exact difference form, a larger one the dot form.
_DIFF_FORM_BUDGET = 1 << 25


def euclidean_form(rows: int, cols: int, d: int) -> str:
    """The form the reference's ``_sq_euclidean`` picks for a
    (rows, d) x (cols, d) tile: "diff" or "dot"."""
    return "diff" if rows * cols * d <= _DIFF_FORM_BUDGET else "dot"


def _sq_euclidean(x: torch.Tensor, y: torch.Tensor, form: str) -> torch.Tensor:
    """Squared euclidean distances, accumulated feature by feature."""
    d = x.shape[-1]
    if form == "diff":
        t = x[..., :, None, 0] - y[..., None, :, 0]
        acc = t * t
        for f in range(1, d):
            t = x[..., :, None, f] - y[..., None, :, f]
            acc = acc + t * t
        return acc
    if form != "dot":
        raise ValueError(f"unknown euclidean form {form!r}: diff | dot")
    x_sq = x[..., 0] * x[..., 0]
    y_sq = y[..., 0] * y[..., 0]
    cross = x[..., :, None, 0] * y[..., None, :, 0]
    for f in range(1, d):
        x_sq = x_sq + x[..., f] * x[..., f]
        y_sq = y_sq + y[..., f] * y[..., f]
        cross = cross + x[..., :, None, f] * y[..., None, :, f]
    d2 = (x_sq[..., :, None] + y_sq[..., None, :]) - 2.0 * cross
    return torch.clamp_min(d2, 0.0)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root, float32 or float64.

    PyTorch's vectorized CPU ``sqrt`` is not correctly rounded in either
    type (it misses on a fraction of a percent of integers, sqrt(2) among
    them in float64), while ``sqrtf`` in the CUDA kernels, CUDA's ``sqrt``
    and the reference's scans on integer grids are. On the CPU the root is
    numpy's (IEEE); on the card float32 takes it in float64 and rounds once,
    which is correctly rounded (53 >= 2*24 + 2 bits).
    """
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.double().numpy())).to(x.dtype)
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Squared norms of the rows of ``x`` (..., n, d), in the dot form's
    order."""
    acc = x[..., 0] * x[..., 0]
    for f in range(1, x.shape[-1]):
        acc = acc + x[..., f] * x[..., f]
    return acc


def _cosine(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``1 - x.y / (|x| |y|)``: the cross term and the squared norms
    accumulated feature by feature in ascending order, the norms rooted
    correctly rounded (the CUDA kernels' metric code 6)."""
    cross = x[..., :, None, 0] * y[..., None, :, 0]
    for f in range(1, x.shape[-1]):
        cross = cross + x[..., :, None, f] * y[..., None, :, f]
    nx = sqrt_rn(_sq_norms(x))
    ny = sqrt_rn(_sq_norms(y))
    return 1.0 - cross / (nx[..., :, None] * ny[..., None, :])


def centre_rows(x: torch.Tensor) -> torch.Tensor:
    """Each row less its mean over the d features (the sum in ascending
    feature order, divided by d): the rows pearson takes the cosine of.

    d divides as a tensor: PyTorch's CUDA division by a Python scalar
    multiplies by its rounded reciprocal, which is not the CPU's (or the
    reference's) IEEE division."""
    acc = x[..., 0]
    for f in range(1, x.shape[-1]):
        acc = acc + x[..., f]
    return x - (acc / torch.full_like(acc, x.shape[-1]))[..., None]


def zero_rows(x: torch.Tensor, metric: str) -> torch.Tensor:
    """(n,) bool: the rows of ``x`` (n, d) whose distances are NaN at
    cosine or pearson, i.e. whose (centred, for pearson) squared norm in
    the dot form's order is 0 (for finite rows, ``1 - 0 / 0``). All False
    at the other metrics."""
    if metric == "pearson":
        x = centre_rows(x)
    elif metric != "cosine":
        return torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    return _sq_norms(x) == 0


def pairwise_distance(
    x: torch.Tensor, y: torch.Tensor, metric: str = DEFAULT_METRIC,
    form: str | None = None,
) -> torch.Tensor:
    """Full (n, m) distance matrix between row sets ``x`` and ``y``; leading
    batch dimensions of ``x`` (..., n, d) and ``y`` (..., m, d) broadcast.

    ``form`` ("diff" or "dot") selects the euclidean form — the one the
    reference picks at the caller's tile shape (:func:`euclidean_form`).
    """
    if metric == "euclidean":
        return sqrt_rn(_sq_euclidean(x, y, form))
    if metric in ("manhattan", "supremum"):
        acc = torch.abs(x[..., :, None, 0] - y[..., None, :, 0])
        for f in range(1, x.shape[-1]):
            a = torch.abs(x[..., :, None, f] - y[..., None, :, f])
            acc = acc + a if metric == "manhattan" else torch.maximum(acc, a)
        return acc
    if metric == "cosine":
        return _cosine(x, y)
    if metric == "pearson":
        return _cosine(centre_rows(x), centre_rows(y))
    raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")


def self_distance_matrix(x: torch.Tensor, metric: str = DEFAULT_METRIC) -> torch.Tensor:
    """(..., n, n) distance matrix of a point block (..., n, d) against
    itself with an exact-zero diagonal, in the euclidean form the reference
    picks for an (n, n, d) block."""
    n, d = x.shape[-2], x.shape[-1]
    dist = pairwise_distance(x, x, metric, euclidean_form(n, n, d))
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    return torch.where(eye, torch.zeros((), dtype=dist.dtype, device=x.device), dist)


def rowwise_distance_np(a, b, metric: str = DEFAULT_METRIC):
    """Distance between corresponding rows of two host arrays, in float64
    (numpy; a copy of the reference's helper for edge re-weighting)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if metric == "euclidean":
        return np.sqrt(np.sum((a - b) ** 2, axis=-1))
    if metric == "manhattan":
        return np.sum(np.abs(a - b), axis=-1)
    if metric == "supremum":
        return np.max(np.abs(a - b), axis=-1)
    if metric == "cosine":
        num = np.sum(a * b, axis=-1)
        den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
        return 1.0 - num / den
    if metric == "pearson":
        ac = a - a.mean(axis=-1, keepdims=True)
        bc = b - b.mean(axis=-1, keepdims=True)
        num = np.sum(ac * bc, axis=-1)
        den = np.linalg.norm(ac, axis=-1) * np.linalg.norm(bc, axis=-1)
        return 1.0 - num / den
    raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")
