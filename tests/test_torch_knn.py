"""k-best scan: the plain PyTorch version of kernel K2 (which the CUDA
kernel reproduces bitwise on the card), through the port's
``knn_core_distances``, against the reference's fused Pallas kernel in
interpret mode and its XLA scan, ids included.

Tolerances: integer grids are bitwise — distances, ids, core distances.
Continuous data allows 2 ulp of float32 on distances in the diff form
(XLA's fused CPU ``sqrt`` is not correctly rounded; the port's is). The
dot form adds its cancellation error near zero distance: the squared
distance carries ~eps * |x|^2 absolute error whose square root reaches
~1e-3 at |x|^2 ~ 10, and the reference and the port sum the norms and the
cross term in different orders; distances there are held to 4e-3
absolute. Ids agree on at least 99% of entries (a last-bit shift can swap
two near-tied neighbours).
"""

import numpy as np
import pytest
import torch

from hdbscan_tpu.ops.pallas_knn import knn_core_distances_fused as ref_fused
from hdbscan_tpu.ops.tiled import knn_core_distances as ref_knn
from hdbscan_tpu_torch.ops.cuda_knn import knn_kbest
from hdbscan_tpu_torch.ops.lexmerge import lex_kbest
from hdbscan_tpu_torch.ops.tiled import knn_core_distances as port_knn


def _grid(seed, n, d, hi):
    return np.random.default_rng(seed).integers(0, hi, size=(n, d)).astype(np.float64)


def _assert_same(port, ref):
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("min_pts", [2, 16, 129])
def test_fused_bitwise_vs_pallas_interpret(min_pts):
    data = _grid(min_pts, 300, 3, 9)  # heavy duplicate ties; 300 is no tile multiple
    ref = ref_fused(data, min_pts, row_tile=64, col_tile=128, interpret=True,
                    return_indices=True)
    port = port_knn(data, min_pts, backend="fused", return_indices=True, device="cpu")
    _assert_same(port, ref)


@pytest.mark.parametrize("min_pts", [2, 16, 129])
@pytest.mark.parametrize("tiles", [(64, 128), (1024, 8192)])
def test_xla_bitwise_vs_xla_scan(min_pts, tiles):
    data = _grid(100 + min_pts, 1000, 3, 40)
    kw = dict(row_tile=tiles[0], col_tile=tiles[1], return_indices=True)
    ref = ref_knn(data, min_pts, backend="xla", **kw)
    port = port_knn(data, min_pts, backend="xla", device="cpu", **kw)
    _assert_same(port, ref)


def test_auto_kth_only_matches_reference():
    data = _grid(3, 900, 2, 30)
    ref = ref_knn(data, 16, backend="auto", fetch_knn=False)
    port = port_knn(data, 16, backend="auto", fetch_knn=False, device="cpu")
    assert port[1] is None and ref[1] is None
    np.testing.assert_array_equal(port[0], ref[0])


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_continuous_within_sqrt_rounding(backend):
    data = np.random.default_rng(5).normal(size=(600, 7))
    if backend == "fused":
        ref = ref_fused(data, 16, row_tile=64, col_tile=128, interpret=True,
                        return_indices=True)
    else:
        ref = ref_knn(data, 16, backend="xla", return_indices=True, row_tile=64, col_tile=128)
    port = port_knn(data, 16, backend=backend, return_indices=True, device="cpu",
                    row_tile=64, col_tile=128)
    atol = 4e-3 if backend == "fused" else 0.0
    np.testing.assert_allclose(port[0], ref[0], rtol=2.5e-7, atol=atol)
    np.testing.assert_allclose(port[1], ref[1], rtol=2.5e-7, atol=atol)
    assert np.mean(port[2] == ref[2]) > 0.99


@pytest.mark.parametrize("metric", ["manhattan", "supremum"])
def test_fused_with_other_metric_runs_the_scan_contract(metric):
    """As in the reference, ``fused`` with a metric the fused kernel does not
    take computes what the XLA scan does."""
    data = _grid(11, 400, 3, 20)
    ref = ref_knn(data, 8, metric, backend="fused", return_indices=True)
    port = port_knn(data, 8, metric, backend="fused", return_indices=True, device="cpu")
    _assert_same(port, ref)


def test_min_pts_one_gives_zero_core():
    data = _grid(7, 50, 3, 9)
    core, _ = port_knn(data, 1, device="cpu")
    np.testing.assert_array_equal(core, ref_knn(data, 1)[0])
    assert np.all(core == 0)


def test_fewer_points_than_k_pads_with_empty_slots():
    x = torch.tensor([[0.0], [1.0], [3.0]])
    d, i = knn_kbest(x, 5)
    assert torch.equal(i[0], torch.tensor([0, 1, 2, -1, -1], dtype=torch.int32))
    assert torch.isinf(d[:, 3:]).all()


def test_lex_kbest_breaks_ties_by_lowest_id():
    dist = torch.tensor([[2.0, 1.0, 1.0, 0.5, 1.0, float("inf")]])
    d, i = lex_kbest(dist, 3)
    assert torch.equal(i, torch.tensor([[3, 1, 2]], dtype=torch.int32))
    assert torch.equal(d, torch.tensor([[0.5, 1.0, 1.0]]))


def _straddling_grid(seed, n, d, hi):
    """An integer grid in [0, hi) with one point outside it planted 16 times
    at the columns 1,020-1,027 and 2,044-2,051: equal distances on both
    sides of the columns 1,024 and 2,048, a point duplicated more than k."""
    data = _grid(seed, n, d, hi)
    planted = np.r_[1020:1028, 2044:2052]
    data[planted] = hi
    return data, planted


@pytest.mark.parametrize("min_pts", [2, 8, 16])
@pytest.mark.parametrize("tiles", [(256, 1024), (1024, 8192)])
def test_split_boundary_ties_bitwise_vs_xla_scan(min_pts, tiles):
    """The contract the kernel's column-split merge must keep: equal
    distances straddling the columns 1,024 and 2,048 go to the lower ids,
    and a point duplicated more than k times keeps its k lowest copies."""
    k = max(min_pts - 1, 1)
    data, planted = _straddling_grid(min_pts, 2100, 3, 40)
    kw = dict(row_tile=tiles[0], col_tile=tiles[1], return_indices=True)
    ref = ref_knn(data, min_pts, backend="xla", **kw)
    port = port_knn(data, min_pts, backend="xla", device="cpu", **kw)
    _assert_same(port, ref)
    for row in planted:
        np.testing.assert_array_equal(np.asarray(port[2])[row, :k], planted[:k])
