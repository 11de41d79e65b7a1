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


def _cross_f32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x @ y.T at full input precision: TF32 is switched off for the product,
    the analog of the reference's ``Precision.HIGHEST``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return x @ y.transpose(-1, -2)


def _cosine(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    cross = _cross_f32(x, y)
    nx = torch.sqrt(torch.sum(x * x, dim=-1))
    ny = torch.sqrt(torch.sum(y * y, dim=-1))
    return 1.0 - cross / (nx[..., :, None] * ny[..., None, :])


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
        return _cosine(
            x - x.mean(dim=-1, keepdim=True), y - y.mean(dim=-1, keepdim=True)
        )
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
