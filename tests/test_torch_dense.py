"""The dense single-block fit (``hdbscan_tpu_torch/models/hdbscan.fit``, the
CLI's route for n <= ``processing_units``) against the reference's
``hdbscan_tpu.models.hdbscan.fit``, on the CPU.

Integer grids: at float64 against the reference under x64 and at float32
against it under ``jax.enable_x64(False)``, labels, core distances, MST,
outlier scores, every condensed-tree field and the five files are
identical, zero rows included (cosine's NaN distances). Pearson and
continuous data: labels identical, core distances and MST weights within
1e-6 absolute at float32 and 1e-12 at float64 (the tolerances of
``tests/test_torch_metrics.py``: the reference centres pearson rows with
``jnp.mean``, the port with ``centre_rows``; XLA's fused CPU ``sqrt`` is not
correctly rounded).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.core import knn as ref_knn
from hdbscan_tpu.models import hdbscan as ref_hdbscan
from hdbscan_tpu.models import mr_hdbscan as ref_mr
from hdbscan_tpu_torch.config import HDBSCANParams as PortParams
from hdbscan_tpu_torch.core import knn as port_knn
from hdbscan_tpu_torch.models import hdbscan as port_hdbscan
from hdbscan_tpu_torch.models import mr_hdbscan as port_mr
from hdbscan_tpu_torch.parallel.blocks import block_mst_batch
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


_TREE_FIELDS = (
    "parent", "birth", "death", "stability", "has_children", "num_members",
    "point_exit_level", "point_last_cluster", "propagated_stability",
    "lowest_child_death", "selected",
)
_TOL = {np.float32: 1e-6, np.float64: 1e-12}


def _grid(seed=0, n=640, zero_rows=0):
    """Integer blobs plus uniform noise on [1, 16], after ``zero_rows`` zero
    rows (NaN distances at cosine)."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(3, 14, size=(4, 3))
    x = np.round(centres[rng.integers(0, 4, n)] + rng.normal(0, 1.2, size=(n, 3)))
    x = np.concatenate([x, rng.integers(1, 17, size=(n // 8, 3))])
    return np.concatenate([np.zeros((zero_rows, 3)), np.clip(x, 1, None)])


def _continuous(seed=1, n=600, d=5):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 4, size=(4, d))
    return centres[rng.integers(0, 4, n)] + rng.normal(0, 0.6, size=(n, d)) + 3.0


def _ref_fit(data, params, dtype):
    with jax.enable_x64(dtype == np.float64):
        return ref_hdbscan.fit(data, params)


def _params(**kw):
    ref = RefParams(min_points=8, min_cluster_size=20, **kw)
    return ref, PortParams.from_dict(dataclasses.asdict(ref))


def _equal(a, b):
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64-x64", "f32"])
@pytest.mark.parametrize(
    "metric,zero_rows",
    [("euclidean", 0), ("manhattan", 0), ("supremum", 0), ("cosine", 0), ("cosine", 3),
     ("euclidean", 3)],
)
def test_grid_fit_bitwise(tmp_path, metric, zero_rows, dtype):
    """With zero rows at cosine every row's k-best holds their NaN
    distances, as the reference's ``lax.top_k`` ranks them: the zero rows'
    cores are NaN, and the NaN weights leave no MST edge (all noise) in
    both packages."""
    data = _grid(zero_rows=zero_rows)
    ref_params, port_params = _params(dist_function=metric, input_file="grid.csv")
    ref = _ref_fit(data, ref_params, dtype)
    port = port_hdbscan.fit(data, port_params, device="cpu", dtype=dtype)
    _equal(port.labels, ref.labels)
    _equal(port.core_distances, ref.core_distances)
    for a, b in zip(port.mst, ref.mst):
        _equal(a, b)
    _equal(port.outlier_scores, ref.outlier_scores)
    assert port.infinite_stability == ref.infinite_stability
    for f in _TREE_FIELDS:
        _equal(getattr(port.tree, f), getattr(ref.tree, f))
    if metric == "cosine" and zero_rows:
        assert np.isnan(port.core_distances[:zero_rows]).all() and len(port.mst[0]) == 0
    else:
        assert len(np.unique(port.labels)) > 2  # real clusters
    paths = {}
    for tag, res, params, write in (("ref", ref, ref_params, ref_hdbscan.write_outputs),
                                    ("port", port, port_params, port_hdbscan.write_outputs)):
        paths[tag] = write(res, dataclasses.replace(params, out_dir=str(tmp_path / tag)))
    for kind in paths["ref"]:
        with open(paths["ref"][kind], "rb") as a, open(paths["port"][kind], "rb") as b:
            assert a.read() == b.read(), kind


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64-x64", "f32"])
@pytest.mark.parametrize("metric", ["pearson", "euclidean", "cosine"])
def test_continuous_fit_labels_equal(metric, dtype):
    data = _continuous()
    ref_params, port_params = _params(dist_function=metric)
    ref = _ref_fit(data, ref_params, dtype)
    port = port_hdbscan.fit(data, port_params, device="cpu", dtype=dtype)
    _equal(port.labels, ref.labels)
    assert len(np.unique(port.labels)) > 2
    tol = _TOL[dtype]
    np.testing.assert_allclose(port.core_distances, ref.core_distances, rtol=0, atol=tol)
    # Edge ids tie-break on weights within tol: compare the weight multiset.
    np.testing.assert_allclose(np.sort(port.mst[2]), np.sort(ref.mst[2]), rtol=0, atol=tol)
    _equal(port.tree.num_members, ref.tree.num_members)
    _equal(port.tree.selected, ref.tree.selected)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64-x64", "f32"])
@pytest.mark.parametrize("min_pts", [1, 2, 8, 1000])
def test_block_pieces_equal_reference(min_pts, dtype):
    """``mutual_reachability_block``'s core distances against the
    reference's ``core_distances``, and its MRD matrix and cores against the
    reference's ``mutual_reachability_block``, bitwise on a grid (min_pts
    past n clamps to n)."""
    data = _grid(seed=2, n=300)
    with jax.enable_x64(dtype == np.float64):
        x = jnp.asarray(data.astype(dtype))
        ref_core = np.asarray(ref_knn.core_distances(x, min_pts, "euclidean"))
        ref_mrd, ref_core2 = (np.asarray(a) for a in
                              ref_knn.mutual_reachability_block(x, min_pts, "manhattan"))
    t = torch.as_tensor(data.astype(dtype))
    _equal(port_knn.mutual_reachability_block(t, min_pts, "euclidean")[1].numpy(), ref_core)
    mrd, core = port_knn.mutual_reachability_block(t, min_pts, "manhattan")
    _equal(mrd.numpy(), ref_mrd)
    _equal(core.numpy(), ref_core2)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64-x64", "f32"])
@pytest.mark.parametrize("metric", ["cosine", "pearson"])
def test_zero_norm_rows_mr_block_cores_match_reference(metric, dtype):
    """The MR pipeline with ``global_cores=false`` takes each point's core
    from its block's dense matrix (``parallel/blocks.block_mst_batch``):
    the zero rows' NaN distances rank first there, as in the reference's
    ``lax.top_k``, so their cores are NaN and every other core and label is
    the reference's (seed 1 puts the zero rows in blocks with other rows;
    ranking NaN last changes most cores here). Cosine on a grid is bitwise; pearson runs on
    continuous data (on a grid its 1-ulp centring differences flip the
    sampling's exact ties) and its cores agree within the stated
    tolerance."""
    if metric == "cosine":
        data = _grid(seed=6, n=480, zero_rows=3)
    else:
        data = np.concatenate([np.zeros((3, 5)), _continuous(n=600)])
    ref_params, port_params = _params(dist_function=metric, processing_units=200, seed=1,
                                      global_core_distances=False)
    with jax.enable_x64(dtype == np.float64):
        ref = ref_mr.fit(data, ref_params)
    port = port_mr.fit(data, port_params, device="cpu", dtype=dtype)
    assert port.n_levels == ref.n_levels > 1
    assert np.isnan(port.core_distances[:3]).all()
    _equal(np.isnan(port.core_distances), np.isnan(ref.core_distances))
    if metric == "cosine":
        _equal(port.core_distances, ref.core_distances)
    else:
        np.testing.assert_allclose(port.core_distances, ref.core_distances, rtol=0,
                                   atol=_TOL[dtype])
    _equal(port.labels, ref.labels)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_block_edges_equal_the_batched_block_program(metric):
    """The dense block and ``parallel/blocks.block_mst_batch`` at B = 1 (the
    MR pipeline's block program, built on the same pieces) give the same
    edges and core distances."""
    data = _grid(seed=4, n=400).astype(np.float32)
    x = torch.as_tensor(data)
    u, v, w, core = port_hdbscan.hdbscan_block_edges(x, 8, metric)
    bu, bv, bw, bmask, bcore = block_mst_batch(x[None], torch.tensor([len(data)]), 8, metric)
    m = bmask[0].numpy()
    _equal(u, bu[0].numpy()[m])
    _equal(v, bv[0].numpy()[m])
    _equal(w, bw[0].numpy().astype(np.float64)[m])
    _equal(core, bcore[0].numpy().astype(np.float64))
    assert len(u) == len(data) - 1


def test_fit_traces_block_edges_and_keeps_the_result_fields():
    events = []
    data = _grid(seed=5, n=200)
    res = port_hdbscan.fit(data, PortParams(min_points=4, min_cluster_size=10), device="cpu",
                           trace=lambda stage, **f: events.append(stage))
    assert events[0] == "block_edges" and any(s.startswith("tree_") for s in events)
    assert res.dedup_inverse is None and len(res.labels) == len(data)


def test_fit_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="empty"):
        port_hdbscan.fit(np.zeros((0, 2)), device="cpu")
    with pytest.raises(ValueError, match="float32 or float64"):
        port_hdbscan.fit(np.zeros((4, 2)), device="cpu", dtype=np.float16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_hdbscan.fit(np.zeros((4, 2)), PortParams(min_points=2, min_cluster_size=2))
