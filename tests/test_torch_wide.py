"""k and d past 128: every kernel's plain version (which the kernels'
wide modes reproduce bitwise on the card) against the reference, and the
fits at such shapes end to end.

The reference caps only its Pallas kernels at 128 lanes and routes around
them (``fused`` falls back to the guarded XLA scan, the window rescan to
the XLA chunk, the fused forest to the unfused route); the port's CUDA
kernels take every k and d, so its plain versions must equal those routes.
Inputs are integer grids with many duplicate points, where every distance
is exact in float32: tolerance 0, ids and tie order included.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hdbscan_tpu.ops.blockscan as ref_bs
from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.models import exact as ref_exact
from hdbscan_tpu.models import mr_hdbscan as ref_mr
from hdbscan_tpu.ops import rpforest as ref_rpf
from hdbscan_tpu.ops import tiled as ref_tiled
from hdbscan_tpu.ops.pallas_segmin import min_outgoing_xla_reference
from hdbscan_tpu_torch.config import HDBSCANParams as PortParams
from hdbscan_tpu_torch.models import exact as port_exact
from hdbscan_tpu_torch.models import mr_hdbscan as port_mr
from hdbscan_tpu_torch.ops import blockscan as port_bs
from hdbscan_tpu_torch.ops import rpforest as port_rpf
from hdbscan_tpu_torch.ops import tiled as port_tiled
from hdbscan_tpu_torch.ops.cuda_segmin import min_outgoing_all_rows
from hdbscan_tpu_torch.utils.datasets import make_gauss


def _grid(seed, n, d, hi=3):
    return np.random.default_rng(seed).integers(0, hi, size=(n, d)).astype(np.float64)


def _equal(port, ref):
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- K2 / the exact tier's core distances -------------------------------------


@pytest.mark.parametrize("backend", ["xla", "fused"])
@pytest.mark.parametrize("tiles", [(64, 128), (1024, 8192)], ids=["small_tiles", "default"])
@pytest.mark.parametrize("d,k", [(129, 15), (200, 15), (3, 129), (3, 200), (129, 129)])
def test_knn_core_distances_bitwise(d, k, tiles, backend):
    """The k-best kernel's plain version against ``_knn_core_scan`` through
    ``knn_core_distances``; past 128 ``fused`` takes the XLA scan's form on
    both sides (at default tiles and d = 129 that is the dot form)."""
    data = _grid(d * 1000 + k, 300, d, hi=3 if d > 3 else 5)
    kw = dict(k=k, row_tile=tiles[0], col_tile=tiles[1], return_indices=True,
              backend=backend)
    ref = ref_tiled.knn_core_distances(data, k + 1, **kw)
    port = port_tiled.knn_core_distances(data, k + 1, device="cpu", **kw)
    _equal(port, ref)


def test_pallas_backend_still_refuses_past_128():
    with pytest.raises(ValueError, match="d <= 128"):
        port_tiled.knn_core_distances(_grid(0, 64, 129), 4, backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="k <= 128"):
        port_tiled.knn_core_distances(_grid(0, 300, 3), 130, backend="pallas", device="cpu")


# -- B1 / B9: the segment-min ---------------------------------------------------


@pytest.mark.parametrize("tiles", [(64, 128), (512, 512)], ids=["diff_form", "dot_form"])
@pytest.mark.parametrize("d", [129, 200])
def test_segmin_bitwise_vs_xla_reference(d, tiles):
    rng = np.random.default_rng(d)
    n, n_pad = 450, 512
    x = np.zeros((n_pad, d), np.float32)
    x[:n] = rng.integers(0, 3, size=(n, d))
    core = np.zeros(n_pad, np.float32)
    core[:n] = rng.integers(0, 4, size=n)
    comp = np.zeros(n_pad, np.int32)
    comp[:n] = rng.integers(0, 7, size=n)
    valid = np.arange(n_pad) < n
    ref = min_outgoing_xla_reference(x, core, comp, valid, "euclidean", *tiles)
    port = min_outgoing_all_rows(torch.from_numpy(x), torch.from_numpy(core),
                                 torch.from_numpy(comp), torch.from_numpy(valid),
                                 "euclidean", *tiles)
    _equal(port, ref)


# -- B4: the windowed rescan, XLA-chunk contract past the fused gate ------------


def _blocky_lattice(seed, n, d, n_blocks=8):
    rng = np.random.default_rng(seed)
    pts = np.concatenate(
        [rng.normal(c * 3.0, 1.0, size=(n // 4, d)) for c in rng.normal(size=(4, d))]
    )[:n]
    order = np.argsort(pts @ rng.normal(size=d))
    block_of = np.empty(len(pts), np.int64)
    for b, seg in enumerate(np.array_split(order, n_blocks)):
        block_of[seg] = b
    return np.round(pts * 2.0), block_of


@pytest.mark.parametrize("backend", ["xla", "fused"])
@pytest.mark.parametrize("d,min_pts", [(129, 6), (3, 130)])
def test_window_rescan_bitwise(d, min_pts, backend):
    """Past k or d = 128 both backends run the reference's XLA chunk
    (``_knn_window_merge_chunk``): core distances, neighbour distances and
    ids equal."""
    pts, block_of = _blocky_lattice(d, 1200, d)
    rows = np.arange(0, len(pts), 3)
    ub = np.full(len(rows), np.inf)
    ref_geom = ref_bs.BlockGeometry.build(pts, block_of, col_tile=256)
    port_geom = port_bs.BlockGeometry.build(pts, block_of, col_tile=256, device="cpu")
    kw = dict(return_neighbors=True, row_tile=64, backend=backend)
    ref = ref_bs.knn_rows_blockpruned(ref_geom, rows, ub, min_pts, **kw)
    port = port_bs.knn_rows_blockpruned(port_geom, rows, ub, min_pts, **kw)
    _equal(port, ref)


# -- B5-B7: the forest's fused route past the gate = the reference's unfused ----


@pytest.mark.parametrize("d,k", [(3, 129), (3, 200), (129, 15)])
def test_forest_fused_route_equals_unfused_reference(d, k):
    """The fused route's plain versions (B5 leaf scan, B6 merge, B7 rescan:
    what the wide kernels compute on the card) against the reference's
    unfused query and rescan, on the reference's forest."""
    n = max(300, 2 * k + 100)
    data = _grid(k + d, n, d, hi=6 if d == 3 else 3).astype(np.float32)
    ref_forest = ref_rpf.build_forest(data, trees=2, leaf_size=2 * k + 2, seed=1)
    forest = port_rpf.forest_from_numpy(**dataclasses.asdict(ref_forest))
    dd, dt = jnp.asarray(data), torch.as_tensor(data)
    ref = ref_rpf.forest_knn(dd, ref_forest, k, "euclidean")
    got = port_rpf.forest_knn(dt, forest, k, "euclidean", backend="fused")
    _equal(got, ref)
    ref = ref_rpf.rescan_round(dd, *ref, k, "euclidean", 0, 1, sentinel=n)
    got = port_rpf.rescan_round(dt, *got, k, "euclidean", 0, 1, sentinel=n, backend="fused")
    _equal(got, ref)


# -- the fits end to end ---------------------------------------------------------

_TREE_FIELDS = ("parent", "birth", "death", "stability", "num_members", "selected")


def _fits_equal(port, ref):
    np.testing.assert_array_equal(port.labels, ref.labels)
    np.testing.assert_array_equal(port.core_distances, ref.core_distances)
    for a, b in zip(port.mst, ref.mst):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.outlier_scores, ref.outlier_scores)
    for f in _TREE_FIELDS:
        np.testing.assert_array_equal(getattr(port.tree, f), getattr(ref.tree, f), err_msg=f)


@pytest.mark.parametrize(
    "n,d,hi,kw",
    [
        (200, 129, 6, dict(min_points=4, min_cluster_size=5)),
        (1500, 3, 30, dict(min_points=200, min_cluster_size=50)),
        (900, 3, 12, dict(min_points=130, min_cluster_size=40, knn_index="rpforest",
                          rpf_trees=2, rpf_leaf_size=300, knn_backend="fused")),
    ],
    ids=["exact_d129", "exact_minpts200", "rpforest_k129"],
)
def test_exact_fit_equals_reference(n, d, hi, kw):
    """The three shapes where the port used to raise, plus the forest tier
    at k = 129: labels, core distances, MST, outlier scores and tree equal."""
    data = _grid(n + d, n, d, hi=hi)
    ref = ref_exact.fit(data, RefParams(**kw))
    port = port_exact.fit(data, PortParams(**kw), device="cpu")
    _fits_equal(port, ref)


def test_mr_fit_d130_equals_reference():
    pts, _ = make_gauss(1500, dims=130, n_clusters=4, separation=8.0, seed=3)
    data = np.round(pts)
    kw = dict(min_points=5, min_cluster_size=20, processing_units=256, k=0.1, seed=0)
    ref = ref_mr.fit(data, RefParams(**kw))
    port = port_mr.fit(data, PortParams(**kw), device="cpu", dtype=np.float64)
    np.testing.assert_array_equal(port.labels, ref.labels)
    np.testing.assert_array_equal(port.core_distances, ref.core_distances)
    np.testing.assert_array_equal(port.outlier_scores, ref.outlier_scores)
