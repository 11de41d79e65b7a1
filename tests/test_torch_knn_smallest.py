"""The k-smallest scan (kernel B3): its plain PyTorch version (which the
CUDA kernel reproduces bitwise on the card) against the reference's Pallas
kernel ``knn_smallest_pallas`` in interpret mode, the core-distance entry point
``knn_core_distances_pallas`` against the reference's, the backend routing
of ``ops/tiled.knn_core_distances``, and the high-dimension exact fit.

Tolerances: integer grids are bitwise — squared distances, core distances
(float64 roots of the same float32 squared distances) and the fit's labels,
MST and condensed tree. Continuous data allows 2 ulp of float32 in the
difference form; the dot form adds its cancellation error, ~eps * (|x|^2 +
|y|^2) absolute on the squared distance (the reference sums the norms and
the cross term over 128 zero-padded lanes in XLA's order, the port one
feature at a time), held to 8 eps of the largest norm sum.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.models import exact as ref_exact
from hdbscan_tpu.ops.pallas_knn import knn_core_distances_pallas as ref_core
from hdbscan_tpu.ops.pallas_knn import knn_smallest_pallas, morton_order as ref_morton
from hdbscan_tpu.ops.tiled import knn_core_distances as ref_knn
from hdbscan_tpu_torch.config import HDBSCANParams as PortParams
from hdbscan_tpu_torch.models import exact as port_exact
from hdbscan_tpu_torch.ops.cuda_knn_smallest import (
    knn_core_distances_pallas as port_core,
    knn_smallest,
    knn_smallest_plain,
    morton_order,
)
from hdbscan_tpu_torch.ops.tiled import knn_core_distances as port_knn

_TREE_FIELDS = (
    "parent", "birth", "death", "stability", "has_children", "num_members",
    "point_exit_level", "point_last_cluster", "propagated_stability",
    "lowest_child_death", "selected",
)
_EPS = float(np.finfo(np.float32).eps)


def _grid(seed, n, d, hi=8):
    return np.random.default_rng(seed).integers(0, hi, size=(n, d)).astype(np.float64)


def _ref_smallest(x, k, form, order, row_tile=64, col_tile=128):
    """The reference kernel on its padded operands; (n, k) squared distances."""
    n, d = x.shape
    n_pad = -(-n // col_tile) * col_tile
    xp = np.zeros((n_pad, 128), np.float32)
    xp[:n, :d] = x
    mask = np.full((1, n_pad), np.inf, np.float32)
    mask[0, :n] = 0.0
    out = knn_smallest_pallas(xp, np.ascontiguousarray(xp.T), mask, d, k, row_tile=row_tile,
                              col_tile=col_tile, order=order, form=form, interpret=True)
    return np.asarray(out)[:n, :k]


def _port_smallest(x, k, form):
    return knn_smallest(torch.from_numpy(np.asarray(x, np.float32)), k, form).numpy()


@pytest.mark.parametrize("form", ["diff", "dot"])
@pytest.mark.parametrize("k", [1, 7, 15])
@pytest.mark.parametrize("d", [24, 28, 90, 128])
def test_plain_bitwise_vs_pallas_interpret(d, k, form):
    """Integer grid with duplicate ties, a ragged n, both column orders."""
    x = _grid(d * 31 + k, 300, d)
    port = _port_smallest(x, k, form)
    for order in ("scan", "diag"):
        np.testing.assert_array_equal(port, _ref_smallest(x, k, form, order), err_msg=order)


@pytest.mark.parametrize("form", ["diff", "dot"])
@pytest.mark.parametrize("k", [7, 15])
def test_split_boundary_ties_bitwise_vs_pallas_interpret(k, form):
    """The contract the kernel's column-split merge must keep, at d = 24: a
    point outside the grid planted 16 times at the columns 1,020-1,027 and
    2,044-2,051 (equal values on both sides of 1,024 and 2,048, more than k
    copies) among duplicate grid ties."""
    x = _grid(k + 3, 2100, 24, hi=3)
    planted = np.r_[1020:1028, 2044:2052]
    x[planted] = 3
    port = _port_smallest(x, k, form)
    np.testing.assert_array_equal(port, _ref_smallest(x, k, form, "scan", 256, 1024))
    np.testing.assert_array_equal(port[planted], 0.0)


@pytest.mark.parametrize("form", ["diff", "dot"])
def test_continuous_within_tolerance(form):
    x = np.random.default_rng(4).normal(size=(250, 28))
    port = _port_smallest(x, 15, form)
    ref = _ref_smallest(x, 15, form, "diag")
    if form == "diff":
        np.testing.assert_allclose(port, ref, rtol=2.5e-7, atol=0)
    else:
        norms = np.sum(x.astype(np.float32) ** 2, axis=1)
        atol = 8 * _EPS * 2 * norms.max()
        np.testing.assert_allclose(port, ref, rtol=2.5e-7, atol=atol)


def test_fewer_points_than_k_pads_with_inf():
    x = torch.tensor([[0.0, 1.0], [3.0, 1.0], [0.0, 0.0]])
    out = knn_smallest_plain(x, 5, "diff")
    assert torch.equal(out[0, :3], torch.tensor([0.0, 1.0, 9.0]))
    assert torch.isinf(out[:, 3:]).all()


def test_morton_order_is_the_reference_permutation():
    for d in (3, 28, 90):
        x = np.random.default_rng(d).normal(size=(1000, d))
        np.testing.assert_array_equal(morton_order(x), ref_morton(x))


@pytest.mark.parametrize("fetch_knn", [True, False])
@pytest.mark.parametrize("order,form", [("diag", "dot"), ("scan", "diff"), ("diag", "diff")])
def test_core_distances_bitwise_vs_reference(order, form, fetch_knn):
    data = _grid(11, 700, 28, hi=12)
    kw = dict(row_tile=64, col_tile=128, order=order, form=form, fetch_knn=fetch_knn)
    ref = ref_core(data, 8, interpret=True, **kw)
    port = port_core(data, 8, device="cpu", **kw)
    np.testing.assert_array_equal(port[0], ref[0])
    if fetch_knn:
        np.testing.assert_array_equal(port[1], ref[1])
    else:
        assert port[1] is None and ref[1] is None


def test_core_distances_high_d_column_tile_and_min_pts_one():
    """d >= 64 halves the reference's column tile (schedule only); min_pts
    1 gives zero cores; k above min_pts - 1 widens the list."""
    data = _grid(12, 260, 90, hi=6)
    ref = ref_core(data, 1, k=9, row_tile=64, col_tile=2048, interpret=True)
    port = port_core(data, 1, k=9, row_tile=64, col_tile=2048, device="cpu")
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_array_equal(port[1], ref[1])
    assert np.all(port[0] == 0) and port[1].shape == (260, 9)


@pytest.mark.parametrize("d,k", [(129, 4), (8, 129)])
def test_refuses_past_128_lanes(d, k):
    data = np.zeros((10, d))
    with pytest.raises(ValueError):
        ref_core(data, 4, k=k, interpret=True)
    with pytest.raises(ValueError):
        port_core(data, 4, k=k, device="cpu")
    with pytest.raises(ValueError):
        knn_smallest(torch.zeros((10, d)), k)


def test_backend_pallas_runs_b3_in_dot_form():
    data = _grid(13, 500, 28, hi=10)
    ref = ref_core(data, 8, form="dot", interpret=True, fetch_knn=False)
    port = port_knn(data, 8, backend="pallas", fetch_knn=False, device="cpu")
    np.testing.assert_array_equal(port[0], ref[0])
    assert port[1] is None


@pytest.mark.parametrize(
    "kw", [dict(metric="manhattan"), dict(return_indices=True), dict(k=129)],
    ids=["manhattan", "indices", "k129"],
)
def test_backend_pallas_refuses_what_b3_cannot_do(kw):
    data = _grid(14, 60, 28)
    with pytest.raises(ValueError, match="pallas"):
        port_knn(data, 8, backend="pallas", device="cpu", **kw)


def test_backend_auto_on_the_cpu_keeps_the_xla_scan():
    """Off the card ``auto`` is the XLA scan's form at any d, as the
    reference's ``auto`` off-TPU: float32 roots, equal to the reference."""
    data = _grid(15, 600, 28, hi=10)
    ref = ref_knn(data, 8, backend="auto")
    port = port_knn(data, 8, backend="auto", device="cpu")
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_array_equal(port[1], ref[1])


def test_high_d_fit_equals_the_reference():
    """The high-d exact fit: the port with B3 (``knn_backend=pallas``; on
    the card ``auto`` takes it at d >= 24) against the reference's fit.
    Labels, MST and condensed tree are identical — the MST casts the cores
    to float32, where the float64 and float32 roots agree — and the cores
    equal the reference's B3 entry point, not its XLA scan's float32 roots."""
    rng = np.random.default_rng(16)
    centers = rng.integers(0, 40, size=(4, 28))
    data = (centers[rng.integers(0, 4, 2200)] + rng.integers(-3, 4, size=(2200, 28))).astype(
        np.float64
    )
    ref_params = RefParams(min_points=8, min_cluster_size=40, mst_backend="device")
    port_params = PortParams.from_dict(dict(dataclasses.asdict(ref_params), knn_backend="pallas"))
    ref = ref_exact.fit(data, ref_params)
    port = port_exact.fit(data, port_params, device="cpu")
    np.testing.assert_array_equal(port.labels, ref.labels)
    for a, b in zip(port.mst, ref.mst):
        np.testing.assert_array_equal(a, b)
    for f in _TREE_FIELDS:
        np.testing.assert_array_equal(getattr(port.tree, f), getattr(ref.tree, f), err_msg=f)
    assert len(np.unique(port.labels)) > 2
    core, _ = ref_core(data, 8, form="dot", interpret=True, fetch_knn=False)
    np.testing.assert_array_equal(port.core_distances, core)
