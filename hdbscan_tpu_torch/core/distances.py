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
    """Correctly rounded float32 square root.

    PyTorch's vectorized CPU ``sqrt`` is not correctly rounded (it misses on
    a fraction of a percent of integers), while ``sqrtf`` in the CUDA
    kernels and the reference's scans on integer grids are. The square root
    taken in float64 and rounded once to float32 is correctly rounded (53 >=
    2*24 + 2 bits), on every device.
    """
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
