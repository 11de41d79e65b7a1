"""Operations and bytes of the port's kernel launches, and the card's peaks.

A launch's least time is max(operations / peak FP32 rate, bytes / peak
bandwidth), with the operations the inputs need and each input byte read
once and each output byte written once, whatever the kernel does to get
there:

- k-best (K2, the rectangular B2, B3): every (row, column) pair of the
  call: the pair's distance (:func:`pair_ops`) and one comparison with the
  row's current k-th; no root, which only the admitted candidates need;
- segment minimum (B1, B9): only pairs whose row and column lie in
  different components, read from the call's component labels: the
  distance, two maxima with the core distances, one comparison.
"""

from __future__ import annotations

import numpy as np

#: NVIDIA H100 SXM (data sheet, dense): FP32 outside the tensor cores, and
#: HBM3 bandwidth. A roofline share is stated against these beside the
#: card's power limit.
PEAK_FP32_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12

#: Distance forms of the port's kernel metric codes (``csrc/distance.cuh``):
#: euclidean diff / dot (rooted and squared), manhattan, supremum, cosine.
CODE_FORMS = {0: "diff", 1: "dot", 2: "diff", 3: "diff", 4: "diff", 5: "dot", 6: "cosine"}


def pair_ops(d: int, form: str) -> int:
    """Float operations of one pair's distance without a root: diff d
    subtractions, d products, d - 1 sums (manhattan and supremum alike, an
    absolute value or a maximum for the product); dot d products, d - 1 sums,
    the two norms added and the doubled product subtracted (3); cosine the
    dot form's d products and d - 1 sums, the norms' product, the division
    and the subtraction from 1."""
    return 3 * d - 1 if form == "diff" else 2 * d + 2


def bound_s(ops: float, nbytes: float) -> float:
    """Least seconds for ``ops`` operations and ``nbytes`` bytes."""
    return max(ops / PEAK_FP32_PER_S, nbytes / PEAK_BYTES_PER_S)


def kbest_bound(name: str, args: tuple) -> float:
    """Least seconds of one k-best launch from its ``cuda_build.launch``
    arguments (after the device): K2 ``knn_kbest`` (x, n, d, k, code, ...),
    B2 ``knn_kbest_panel`` (q, r, x, c, d, k, code, ...), B3
    ``knn_smallest`` (x, n, d, k, code, ...)."""
    if name in ("knn_kbest", "knn_smallest"):
        n, d, k, code = args[1:5]
        rows, cols = n, n
    elif name == "knn_kbest_panel":
        rows, cols, (d, k, code) = args[1], args[3], args[4:7]
    else:
        raise ValueError(f"not a k-best launch: {name}")
    out = rows * k * (8 if name != "knn_smallest" else 4)
    nbytes = (rows + (cols if name == "knn_kbest_panel" else 0)) * d * 4 + out
    return bound_s(float(rows) * cols * (pair_ops(d, CODE_FORMS[code]) + 1), nbytes)


def cross_pairs(comp_r: np.ndarray, valid_r: np.ndarray, comp_c: np.ndarray,
                valid_c: np.ndarray) -> int:
    """Pairs of a valid row and a valid column in different components."""
    cr, cc = comp_r[valid_r], comp_c[valid_c]
    labels = np.union1d(cr, cc)
    nr = np.bincount(np.searchsorted(labels, cr), minlength=len(labels))
    nc = np.bincount(np.searchsorted(labels, cc), minlength=len(labels))
    return int(len(cr)) * int(len(cc)) - int(np.dot(nr, nc))


def segmin_bound(d: int, code: int, comp_r, valid_r, comp_c, valid_c) -> float:
    """Least seconds of one B1 (columns = rows) or B9 launch: the cross
    pairs' work; rows' and columns' points, cores, components and validity
    read once, each row's (weight, column) written once."""
    pairs = cross_pairs(comp_r, valid_r, comp_c, valid_c)
    r, c = len(comp_r), len(comp_c)
    nbytes = r * (d * 4 + 9) + c * (d * 4 + 9) + r * 8
    return bound_s(float(pairs) * (pair_ops(d, CODE_FORMS[code]) + 3), nbytes)


def share(bound_total_s: float, device_s: float) -> float | None:
    """Percent of the roofline: least time over device time; None when the
    device time was not read."""
    if not device_s or device_s <= 0:
        return None
    return 100.0 * bound_total_s / device_s
