"""The rest of the MR-HDBSCAN* pipeline's variants against the reference:
``variant=rs``, the compat CF arithmetic (``core/compat``), the unpruned
boundary rescan (``ops/tiled.knn_core_distances_rows``, its forest twin
``ops/rpforest.rpforest_core_distances_rows``) and the weighted bubble
statistics.

The harness is ``tests/test_torch_mr.py``'s: the reference under the
suite's ``jax_enable_x64`` against the port with ``dtype=np.float64``, one
case a piece at the production setting (``jax.enable_x64(False)`` against
the port's float32). On lattice data every level stat, label, tree field,
core distance, outlier score and pooled edge is bitwise; pearson, whose
float32 cancellation the port's centred cosine and the reference's formula
round differently, is held on continuous data as
``tests/test_torch_metrics.py`` holds it (labels and integer tree fields
exact, cores within 1e-6 absolute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.core import bubbles as ref_bubbles
from hdbscan_tpu.core import compat as ref_compat
from hdbscan_tpu.models import bubble_hdbscan as ref_bh
from hdbscan_tpu.models import mr_hdbscan as ref_mr
from hdbscan_tpu.ops import rpforest as ref_rpf
from hdbscan_tpu.ops import tiled as ref_tiled
from hdbscan_tpu_torch.config import HDBSCANParams as PortParams
from hdbscan_tpu_torch.core import bubbles as port_bubbles
from hdbscan_tpu_torch.core import compat as port_compat
from hdbscan_tpu_torch.models import bubble_hdbscan as port_bh
from hdbscan_tpu_torch.models import mr_hdbscan as port_mr
from hdbscan_tpu_torch.ops import rpforest as port_rpf
from hdbscan_tpu_torch.ops import tiled as port_tiled
from tests.test_torch_mr import BASE, _assert_bitwise, _fit_both, _lattice
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


pytestmark = pytest.mark.filterwarnings("ignore:boundary set capped")


def _pools_equal(port, ref):
    for a, b in zip(port.edge_pool, ref.edge_pool):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "overrides",
    [
        {"variant": "rs"},
        {"compat_cf_int_math": True},
        {"boundary_quality": 0.1, "boundary_block_pruning": False},
        {"boundary_quality": 0.1, "boundary_block_pruning": False, "knn_backend": "fused"},
        {"boundary_quality": 0.1, "dist_function": "cosine"},
        {"boundary_quality": 0.1, "boundary_block_pruning": False, "knn_index": "rpforest",
         "rpf_trees": 3, "rpf_leaf_size": 128},
    ],
    ids=["rs", "compat", "boundary_unpruned", "boundary_unpruned_fused", "boundary_cosine",
         "boundary_forest"],
)
def test_lattice_bitwise(overrides):
    port, ref, events = _fit_both(_lattice(), {"keep_edge_pool": True}, **overrides)
    _assert_bitwise(port, ref)
    _pools_equal(port, ref)
    if "boundary_quality" in overrides:
        assert "knn_window_scan" not in events  # no B4: the rows scan ran
        assert {"boundary_cores", "boundary_phase"} <= set(events)
    if "rpf_trees" in overrides:
        assert "knn_index_build" in events


@pytest.mark.parametrize(
    "overrides",
    [{"variant": "rs"}, {"compat_cf_int_math": True},
     {"boundary_quality": 0.1, "boundary_block_pruning": False}],
    ids=["rs", "compat", "boundary_unpruned"],
)
def test_lattice_bitwise_float32(overrides):
    """The production setting: the reference without x64, the port at its
    float32 default."""
    kw = {**BASE, **overrides}
    with jax.enable_x64(False):
        ref = ref_mr.fit(_lattice(), RefParams(**kw))
    port = port_mr.fit(_lattice(), PortParams(**kw), device="cpu")
    _assert_bitwise(port, ref)


def _blobs(seed, per, d):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(5, d)) * 5.0
    return np.concatenate([c + rng.normal(size=(per, d)) for c in centres])


def test_boundary_pearson_within_tolerance():
    """The unpruned boundary at pearson (no triangle inequality, so no block
    pruning) on continuous 4-d blobs."""
    port, ref, events = _fit_both(_blobs(3, 300, 4), boundary_quality=0.1,
                                  dist_function="pearson")
    np.testing.assert_array_equal(port.labels, ref.labels)
    assert [lv.n_inter_edges for lv in port.levels] == [lv.n_inter_edges for lv in ref.levels]
    for f in ("parent", "num_members", "selected"):
        np.testing.assert_array_equal(getattr(port.tree, f), getattr(ref.tree, f), err_msg=f)
    np.testing.assert_allclose(port.core_distances, ref.core_distances, rtol=0, atol=1e-6)
    assert "knn_window_scan" not in events and len(np.unique(port.labels)) > 2


def _zero_rows_data(metric):
    """600 x 4 blobs on an integer grid with zero-norm rows (zero rows at
    cosine, constant rows at pearson) in two of the three 256-column
    tiles."""
    x = np.round(_blobs(7, 120, 4) * 3.0)
    for i in (5, 300, 301):
        x[i] = 2.0 if metric == "pearson" else 0.0
    return x


@pytest.mark.parametrize("min_pts", [1, 2, 8])
@pytest.mark.parametrize("metric", ["euclidean", "manhattan", "supremum", "cosine", "pearson"])
def test_rows_scan_matches_reference(metric, min_pts):
    """``knn_core_distances_rows``: the rectangular k-best over the selected
    rows against every column (float32, the reference's type for this
    scan), zero-norm columns under the reference's tile rule at its
    column tile. Bitwise on the grid; cosine and pearson, whose roots and
    quotients are not exact there, within 1e-6 with the same +inf rows."""
    x = _zero_rows_data(metric)
    rows = np.random.default_rng(1).choice(len(x), 150, replace=False)
    rows[:2] = (5, 300)  # zero-norm rows themselves: cores +inf
    kw = dict(row_tile=128, col_tile=256)
    ref = ref_tiled.knn_core_distances_rows(x, rows, min_pts, metric, **kw)
    port = port_tiled.knn_core_distances_rows(x, rows, min_pts, metric, device="cpu", **kw)
    assert port.dtype == np.float64 and port.shape == (150,)
    if metric in ("cosine", "pearson"):
        np.testing.assert_array_equal(np.isinf(port), np.isinf(ref))
        np.testing.assert_allclose(port, ref, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(port, ref)
    if min_pts > 2 and metric in ("cosine", "pearson"):
        assert np.isinf(port[:2]).all()


def test_rows_scan_fused_dot_form_matches_reference():
    """``backend="fused"``: the fused TPU kernel's dot form (the reference
    runs its Pallas kernel in interpret mode here)."""
    x = np.round(_blobs(8, 120, 3) * 3.0)
    rows = np.arange(0, 600, 7)
    ref = ref_tiled.knn_core_distances_rows(x, rows, 8, backend="fused")
    port = port_tiled.knn_core_distances_rows(x, rows, 8, backend="fused", device="cpu")
    np.testing.assert_array_equal(port, ref)


def test_forest_rows_match_reference():
    """The forest's rows: one whole-set pass sliced by rows (B5-B7's plain
    versions) on an integer grid (the forest builds bitwise at 3 <= d <=
    8; this is d = 4)."""
    x = np.round(_blobs(9, 200, 4) * 3.0)
    rows = np.arange(0, 1000, 3)
    opts = dict(trees=3, leaf_size=128, rescan_rounds=1, seed=0)
    ref = ref_rpf.rpforest_core_distances_rows(x, rows, 8, "euclidean", **opts)
    port = port_rpf.rpforest_core_distances_rows(x, rows, 8, "euclidean", device="cpu", **opts)
    np.testing.assert_array_equal(port, ref)
    via = port_tiled.knn_core_distances_rows(x, rows, 8, index="rpforest", index_opts=opts,
                                             device="cpu")
    np.testing.assert_array_equal(via, port)


@pytest.mark.parametrize("x64", [True, False], ids=["float64", "float32"])
def test_bubble_stats_weighted_matches_reference(x64):
    """Heavy integer weights on lattice points: every weighted sum exact in
    both types (values stay under 2^24), so the pairwise tree and the
    reference's scatter-add give the same rep and n bitwise; extent and
    nn_dist, a root and a power that neither side rounds correctly, within
    a few ulp (as ``tests/test_torch_blocks.py`` holds ``bubble_stats``).
    Unit weights give ``bubble_stats`` bit for bit."""
    rng = np.random.default_rng(4)
    pts = rng.integers(0, 12, size=(700, 3)).astype(np.float64)
    w = rng.integers(1, 4, size=700).astype(np.float64)
    w[:5] = (300, 250, 200, 150, 120)
    asg = rng.integers(0, 64, size=700)
    asg[-20:] = 64  # padding rows, dropped
    dtype = np.float64 if x64 else np.float32
    with jax.enable_x64(x64):
        ref = ref_bubbles.bubble_stats_weighted(jnp.asarray(pts.astype(dtype)),
                                                jnp.asarray(asg.astype(np.int32)),
                                                jnp.asarray(w.astype(dtype)), 64)
        ref = [np.asarray(a) for a in ref]
    port = port_bubbles.bubble_stats_weighted(torch.as_tensor(pts.astype(dtype)),
                                              torch.as_tensor(asg), torch.as_tensor(w.astype(dtype)),
                                              64)
    tol = 1e-12 if x64 else 5e-7
    for name, a, b in zip(("rep", "extent", "nn_dist", "n"), port, ref):
        if name in ("rep", "n"):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=tol, atol=tol, err_msg=name)
    assert float(port[3].max()) >= 300
    unit = port_bubbles.bubble_stats_weighted(torch.as_tensor(pts), torch.as_tensor(asg),
                                              torch.ones(700, dtype=torch.float64), 64)
    for a, b in zip(unit, port_bubbles.bubble_stats(torch.as_tensor(pts), torch.as_tensor(asg), 64)):
        assert torch.equal(a, b)


def test_compat_stats_and_walk_match_reference():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(300, 3))
    asg = rng.integers(0, 20, size=300)
    w = rng.integers(1, 5, size=300).astype(np.float64)
    for weights in (None, w):
        for a, b in zip(port_compat.combinestep_bubble_stats(pts, asg, 20, weights=weights),
                        ref_compat.combinestep_bubble_stats(pts, asg, 20, weights=weights)):
            np.testing.assert_array_equal(a, b)
    for seed, k, dims in ((0, 5, 2), (1, 9, 3), (2, 4, 1)):
        r = np.random.default_rng(seed)
        d = r.uniform(0.1, 5.0, size=(12, 12))
        d = (d + d.T) / 2
        np.fill_diagonal(d, 0.0)
        n_b, e_b = r.integers(1, 6, size=12), r.uniform(0.0, 1.0, size=12)
        np.testing.assert_array_equal(
            port_compat.reference_bubble_core_distances(d, n_b, e_b, k, dims),
            ref_compat.reference_bubble_core_distances(d, n_b, e_b, k, dims))


def test_compat_walk_overrun_raises_value_error():
    """A live bubble whose member count truncates to 0 leaves the Java
    walk's covering loop short of min_pts - 1: it runs off its slot buffer
    (``IndexError``, Java's ArrayIndexOutOfBoundsException), which
    ``fit_bubbles`` reports as the reference's ``ValueError``."""
    rng = np.random.default_rng(6)
    rep = rng.normal(size=(8, 3))
    extent = rng.uniform(0.1, 1.0, size=8)
    n_b = np.full(8, 0.5)
    args = (rep, extent, extent * 0.5, n_b, 6, 5, "euclidean")
    with pytest.raises(ValueError) as ref_err:
        ref_bh.fit_bubbles(*args, compat_cf_int_math=True)
    with pytest.raises(ValueError) as port_err:
        port_bh.fit_bubbles(torch.as_tensor(rep), extent, extent * 0.5, n_b, *args[4:],
                            compat_cf_int_math=True)
    assert str(port_err.value) == str(ref_err.value)
    assert "overran its neighbor buffer (8 bubbles, 8 live, min_pts=6)" in str(port_err.value)
    assert isinstance(port_err.value.__cause__, IndexError)
