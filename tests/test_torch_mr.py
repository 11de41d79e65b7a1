"""The MR-HDBSCAN* slice as a whole: the port's ``models/mr_hdbscan.fit``
against the reference's on the same seeded data and parameters.

The reference runs under the test suite's ``jax_enable_x64``, so its block
programs, bubbles and sample assignment compute in float64; the port takes
``dtype=np.float64`` for those stages to match (its scans, seam margins and
block geometry run in float32 on both sides). On integer-lattice data the
labels, level stats, condensed-tree fields, core distances and outlier
scores are bitwise equal; on continuous data labels and tree structure are
equal, core distances agree within 1e-6 relative (the scans' float32
roots differ from XLA's CPU roots by an ulp) and outlier scores within
1e-6 relative plus 2.5e-7 absolute.

The lattice set (2,000 points, processing_units=256, k=0.1) runs ten
levels with a forced split, and its boundary mode engages the pruned
rescan (kernel B4's plain version) and the pruned glue.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.models import mr_hdbscan as ref_mr
from hdbscan_tpu_torch.config import HDBSCANParams as PortParams
from hdbscan_tpu_torch.core import mst_device
from hdbscan_tpu_torch.core import tree as port_tree
from hdbscan_tpu_torch.models import mr_hdbscan as port_mr
from hdbscan_tpu_torch.utils.datasets import make_gauss
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


BASE = dict(min_points=6, min_cluster_size=20, processing_units=256, k=0.1, seed=0)


def _lattice():
    pts, _ = make_gauss(2000, dims=3, n_clusters=5, separation=8.0, seed=1)
    return np.round(pts * 2.0)


def _fit_both(data, fit_kw=None, **overrides):
    """The reference and the port on ``data`` with ``BASE`` plus
    ``overrides``; ``fit_kw`` goes to both ``fit`` calls. Returns (port,
    ref, the port's trace stages)."""
    kw = {**BASE, **overrides}
    fit_kw = fit_kw or {}
    events = []
    ref = ref_mr.fit(data, RefParams(**kw), **fit_kw)
    port = port_mr.fit(data, PortParams(**kw), device="cpu", dtype=np.float64,
                       trace=lambda s, **f: events.append(s), **fit_kw)
    return port, ref, events


def _assert_structure_equal(port, ref):
    assert port.n_levels == ref.n_levels
    strip = lambda lv: {k: v for k, v in dataclasses.asdict(lv).items() if k != "wall_s"}  # noqa: E731
    assert [strip(a) for a in port.levels] == [strip(b) for b in ref.levels]
    np.testing.assert_array_equal(port.labels, ref.labels)
    assert port.n_edges == ref.n_edges
    assert port.infinite_stability == ref.infinite_stability
    for f in ("parent", "has_children", "point_last_cluster", "selected"):
        np.testing.assert_array_equal(getattr(port.tree, f), getattr(ref.tree, f), err_msg=f)


def _assert_bitwise(port, ref):
    _assert_structure_equal(port, ref)
    np.testing.assert_array_equal(port.core_distances, ref.core_distances)
    np.testing.assert_array_equal(port.outlier_scores, ref.outlier_scores)
    for f in ("birth", "death", "stability", "num_members", "point_exit_level"):
        np.testing.assert_array_equal(getattr(port.tree, f), getattr(ref.tree, f), err_msg=f)


@pytest.mark.parametrize(
    "mode,overrides",
    [
        ("default", {}),
        ("refine_flat", {"refine_flat_iterations": 2}),
        ("boundary_auto", {"boundary_quality": 0.1}),
        ("boundary_fused", {"boundary_quality": 0.1, "knn_backend": "fused"}),
    ],
)
def test_lattice_bitwise(mode, overrides):
    port, ref, events = _fit_both(_lattice(), **overrides)
    _assert_bitwise(port, ref)
    assert sum(lv.forced_splits for lv in ref.levels) >= 1
    if mode.startswith("boundary"):
        assert {"knn_window_scan", "boundary_phase", "glue_round"} <= set(events)
    if mode == "refine_flat":
        assert "refine_flat" in events


def test_continuous_within_tolerance():
    data, _ = make_gauss(2000, dims=4, n_clusters=5, separation=8.0, seed=3)
    port, ref, _ = _fit_both(data, processing_units=512)
    _assert_structure_equal(port, ref)
    np.testing.assert_allclose(port.core_distances, ref.core_distances, rtol=1e-6)
    # GLOSH = 1 - eps_cluster / eps_point: a relative error d of the eps
    # values moves a score by ~2d absolute, whatever its size.
    np.testing.assert_allclose(port.outlier_scores, ref.outlier_scores, rtol=1e-6, atol=2.5e-7)


def test_degenerate_subset_chain():
    """All-identical points: every level's bubble model puts them in one
    group, so the positional chunks chained by explicit edges carry the
    recursion (the reference's degenerate-subset path)."""
    data = np.zeros((700, 2))
    port, ref, _ = _fit_both(data, processing_units=200, min_cluster_size=10)
    _assert_bitwise(port, ref)


@pytest.mark.parametrize(
    "overrides",
    [{"fit_sharding": "sharded"}, {"scan_backend": "ring"}, {}],
    ids=["sharded", "ring", "mesh"],
)
def test_mesh_options_once_refused_match_reference(overrides):
    """``fit_sharding=sharded``, ``scan_backend=ring`` and a mesh with the
    host engine, once refused: bitwise equal to the reference's fit over
    two of its devices (the wider cases are in ``tests/test_torch_mr_mesh.py``)."""
    import jax
    import torch

    from hdbscan_tpu.parallel.mesh import get_mesh as ref_get_mesh
    from hdbscan_tpu_torch.parallel.mesh import get_mesh

    data = np.round(make_gauss(600, dims=3, n_clusters=4, separation=8.0, seed=4)[0] * 2.0)
    kw = {**BASE, **overrides}
    ref = ref_mr.fit(data, RefParams(**kw), mesh=ref_get_mesh(jax.devices()[:2]))
    port = port_mr.fit(data, PortParams(**kw), dtype=np.float64,
                       mesh=get_mesh([torch.device("cpu")] * 2))
    _assert_bitwise(port, ref)


@pytest.mark.parametrize(
    "overrides,kw",
    [
        ({"variant": "rs"}, {}),
        ({"dedup_points": True}, {}),
        ({"consensus_draws": 3}, {}),
        ({}, {"checkpoint_dir": "ckpt"}),
        ({"compat_cf_int_math": True}, {}),
        ({"boundary_quality": 0.1, "boundary_block_pruning": False}, {}),
        ({"boundary_quality": 0.1, "dist_function": "cosine"}, {}),
    ],
    ids=["rs", "dedup", "consensus", "checkpoint", "compat", "boundary_unpruned",
         "boundary_cosine"],
)
def test_options_once_refused_match_reference(tmp_path, overrides, kw):
    """The options that raised ``NotImplementedError`` before they were
    ported run and equal the reference on a small lattice (the dedicated
    files ``test_torch_mr_variants.py``, ``test_torch_mr_dedup.py``,
    ``test_torch_consensus.py`` and ``test_torch_checkpoint.py`` hold them
    in depth)."""
    data = _lattice()[:800]
    if "dedup_points" in overrides:
        data = np.concatenate([data, data[::4]])
    params = {**BASE, "processing_units": 200, **overrides}
    ref = ref_mr.fit(data, RefParams(**params), **{k: str(tmp_path / "ref") for k in kw})
    port = port_mr.fit(data, PortParams(**params), device="cpu", dtype=np.float64,
                       **{k: str(tmp_path / "port") for k in kw})
    _assert_bitwise(port, ref)
    if kw:
        assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "ref"))


def _forest_fields(f):
    return (f.n_points, f.children, list(np.asarray(f.dist, np.float64)), f.roots,
            list(np.asarray(f.sizes, np.float64)), [list(a) for a in f.kids_csr])


@pytest.mark.parametrize("pool", ["lattice", "continuous_f32", "declined"])
def test_device_merge_forest_equals_host_builder(pool):
    """``finalize_clustering``'s device route (``mst_backend`` auto/device)
    builds the host builder's forest; a float64 pool whose weights are not
    float32-representable is declined (None) and the host builder runs."""
    rng = np.random.default_rng(11)
    n = 400
    u = rng.integers(0, n, 1500)
    v = rng.integers(0, n, 1500)
    if pool == "lattice":
        w = rng.integers(0, 12, 1500).astype(np.float64)  # exact ties everywhere
    elif pool == "continuous_f32":
        w = rng.random(1500).astype(np.float32).astype(np.float64)
    else:
        w = rng.random(1500)
    host = port_tree.build_merge_forest(n, u, v, w)
    dev = mst_device.build_merge_forest_device(n, u, v, w, device="cpu")
    if pool == "declined":
        assert dev is None
        return
    assert mst_device.supports_inputs(w)
    assert _forest_fields(dev) == _forest_fields(host)


def test_finalize_takes_the_device_route_under_the_gate():
    from hdbscan_tpu_torch.models._finalize import finalize_clustering

    rng = np.random.default_rng(12)
    n = 300
    u = np.arange(n - 1)
    v = u + 1
    w = rng.integers(1, 9, n - 1).astype(np.float64)
    core = np.zeros(n)
    stages = {}
    for backend in ("auto", "host"):
        ev = []
        params = PortParams(min_points=3, min_cluster_size=5, mst_backend=backend)
        out = finalize_clustering(n, u, v, w, core, params, device="cpu",
                                  trace=lambda s, **f: ev.append(s))
        stages[backend] = (ev, out)
    assert "tree_build_device" in stages["auto"][0]
    assert "tree_build_device" not in stages["host"][0]
    np.testing.assert_array_equal(stages["auto"][1][1], stages["host"][1][1])
    np.testing.assert_array_equal(stages["auto"][1][2], stages["host"][1][2])
