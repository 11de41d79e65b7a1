"""The rp-forest tier of the port (``ops/rpforest``, ``core/knn``) against
the reference's ``ops/rpforest`` and ``models/exact.fit``, on numpy-seeded
inputs, with ``device="cpu"`` (every kernel's plain version).

Tolerances: on integer grids the forest, the neighbor lists, the core
distances, the fit (labels, MST, condensed tree, scores) and its five files
are bitwise equal. The build is bitwise at 3 <= d <= 8, where XLA's CPU
``einsum`` accumulates the projection in the port's feature order; at other
d a projection can differ by an ulp, so thresholds are held to 1e-6
relative and the member lists to 99% of slots. Continuous data: distances
within 2 ulp of float32 (rtol 2.5e-7), ids on at least 99% of entries,
labels identical.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.core.knn import resolve_index_for as ref_resolve
from hdbscan_tpu.models import exact as ref_exact
from hdbscan_tpu.models.hdbscan import write_outputs as ref_write
from hdbscan_tpu.ops import rpforest as rpf
from hdbscan_tpu.utils.tracing import Tracer
from hdbscan_tpu_torch.config import HDBSCANParams as PortParams
from hdbscan_tpu_torch.core.knn import resolve_index_for
from hdbscan_tpu_torch.models import exact as port_exact
from hdbscan_tpu_torch.models.hdbscan import write_outputs as port_write
from hdbscan_tpu_torch.ops import rpforest as port_rpf
from hdbscan_tpu_torch.ops.tiled import knn_core_distances as port_knn
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 16


def _blobs(n, seed, d=8):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(6, d)) * 6.0
    per = n // 6 + 1
    return np.concatenate([c + rng.normal(size=(per, d)) for c in centers])[:n]


def _moons(n, seed):
    rng = np.random.default_rng(seed)
    half = n // 2
    t1, t2 = rng.uniform(0, np.pi, half), rng.uniform(0, np.pi, n - half)
    x = np.concatenate([np.stack([np.cos(t1), np.sin(t1)], 1),
                        np.stack([1.0 - np.cos(t2), 0.5 - np.sin(t2)], 1)])
    return x + rng.normal(scale=0.05, size=x.shape)


def _anisotropic(n, seed):
    return _blobs(n, seed, d=2) @ np.array([[0.6, -0.64], [-0.41, 0.85]])


def _grid(seed, n, d, scale=4.0):
    return np.round(_blobs(n, seed, d) * scale)


def _port_forest(ref_forest):
    return port_rpf.forest_from_numpy(**dataclasses.asdict(ref_forest))


def _assert_knn(got, ref, integer):
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        if integer or g.dtype.kind == "i":
            if g.dtype.kind == "i" and not integer:
                assert np.mean(g == r) >= 0.99
            else:
                np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=2.5e-7, atol=0)


# -- geometry and the build ----------------------------------------------------


@pytest.mark.parametrize("n,leaf", [(4000, 256), (100, 1024), (10, 4), (245057, 1024),
                                    (1 << 20, 1024), (137, 20)])
def test_depth_and_segments_match_reference(n, leaf):
    depth = port_rpf.forest_depth(n, leaf)
    assert depth == rpf.forest_depth(n, leaf)
    if n < 5000:
        assert port_rpf._level_segments(n, depth) == rpf._level_segments(n, depth)


@pytest.mark.parametrize("d", [3, 4, 8])
@pytest.mark.parametrize("integer", [True, False], ids=["grid", "continuous"])
def test_build_bitwise_vs_reference(d, integer):
    data = _grid(d, 1500, d) if integer else _blobs(1500, d, d)
    ref = rpf.build_forest(data, trees=3, leaf_size=200, seed=7)
    got = port_rpf.build_forest(data, trees=3, leaf_size=200, seed=7, device="cpu")
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(ref, f.name), err_msg=f.name)


@pytest.mark.parametrize("d", [2, 16])
def test_build_within_an_ulp_elsewhere(d):
    """Where XLA's einsum sums in another order the projections can move by
    an ulp: thresholds within 1e-6 relative, members on >= 99% of slots."""
    data = _blobs(1500, d, d)
    ref = rpf.build_forest(data, trees=3, leaf_size=200, seed=7)
    got = port_rpf.build_forest(data, trees=3, leaf_size=200, seed=7, device="cpu")
    np.testing.assert_array_equal(got.normals, ref.normals)
    np.testing.assert_array_equal(got.leaf_mask, ref.leaf_mask)
    np.testing.assert_allclose(got.thresholds, ref.thresholds, rtol=1e-6)
    assert np.mean(got.members == ref.members) >= 0.99


def test_forest_invariants():
    data = _blobs(1500, 0)
    forest = port_rpf.build_forest(data, trees=3, leaf_size=200, seed=7, device="cpu")
    assert forest.depth == port_rpf.forest_depth(1500, 200) and forest.max_leaf <= 200
    for t in range(3):
        assert sorted(forest.members[t][forest.leaf_mask].tolist()) == list(range(1500))
    assert not np.allclose(forest.normals[0], forest.normals[1])
    again = port_rpf.build_forest(data, trees=3, leaf_size=200, seed=7, device="cpu")
    other = port_rpf.build_forest(data, trees=3, leaf_size=200, seed=8, device="cpu")
    assert np.array_equal(forest.members, again.members)
    assert not np.array_equal(forest.normals, other.normals)


def test_forest_from_numpy_checks_shapes():
    ref = rpf.build_forest(_blobs(300, 1), trees=2, leaf_size=64, seed=0)
    fields = dataclasses.asdict(ref)
    assert dataclasses.asdict(port_rpf.forest_from_numpy(**fields)).keys() == fields.keys()
    with pytest.raises(ValueError, match="leaf_mask"):
        port_rpf.forest_from_numpy(**dict(fields, leaf_mask=fields["leaf_mask"][:, :3]))
    with pytest.raises(ValueError, match="outside"):
        port_rpf.forest_from_numpy(**dict(fields, members=fields["members"] + 1))


# -- query, rescan and core distances on one forest ----------------------------


@pytest.mark.parametrize("backend", ["xla", "fused"])
@pytest.mark.parametrize("integer", [True, False], ids=["grid", "continuous"])
def test_forest_knn_and_rescan_vs_reference(backend, integer):
    import jax.numpy as jnp
    import torch

    data = (_grid(1, 900, 4) if integer else _blobs(900, 1, 4)).astype(np.float32)
    ref_forest = rpf.build_forest(data, trees=3, leaf_size=64, seed=3)
    forest = _port_forest(ref_forest)
    dd, dt = jnp.asarray(data), torch.as_tensor(data)
    ref = rpf.forest_knn(dd, ref_forest, 8, "euclidean")
    got = port_rpf.forest_knn(dt, forest, 8, "euclidean", backend=backend)
    _assert_knn(got, ref, integer)
    for rnd in range(2):
        ref = rpf.rescan_round(dd, *ref, 8, "euclidean", rnd, 2, sentinel=900)
        got = port_rpf.rescan_round(dt, *got, 8, "euclidean", rnd, 2, sentinel=900,
                                    backend=backend)
        _assert_knn(got, ref, integer)


@pytest.mark.parametrize("knn_backend", ["auto", "fused"])
@pytest.mark.parametrize("integer", [True, False], ids=["grid", "continuous"])
def test_core_distances_vs_reference(knn_backend, integer):
    data = _grid(2, 1100, 3) if integer else _blobs(1100, 2, 5)
    kw = dict(trees=3, leaf_size=96, rescan_rounds=1, seed=5, return_indices=True)
    ref = rpf.rpforest_core_distances(data, 7, "euclidean", 10, **kw)
    got = port_rpf.rpforest_core_distances(data, 7, "euclidean", 10, knn_backend=knn_backend,
                                           device="cpu", **kw)
    _assert_knn(got, ref, integer)


def test_core_distances_on_the_reference_forest():
    """Handed the reference's forest, the port's tier equals the
    reference's wherever its own build could not (d = 2)."""
    data = _moons(1200, 0)
    forest = rpf.build_forest(data, trees=3, leaf_size=128, seed=0)
    kw = dict(rescan_rounds=1, return_indices=True)
    ref = rpf.rpforest_core_distances(data, 6, "euclidean", forest=forest, **kw)
    got = port_rpf.rpforest_core_distances(data, 6, "euclidean", forest=_port_forest(forest),
                                           device="cpu", **kw)
    _assert_knn(got, ref, integer=False)


def _recall(exact, got):
    return float(np.mean([len(np.intersect1d(a, b)) for a, b in zip(exact, got)])) / exact.shape[1]


@pytest.mark.parametrize("maker", [_blobs, _moons, _anisotropic])
@pytest.mark.parametrize("seed", [0, 1])
def test_recall_sweep(maker, seed):
    """>= 0.95 mean recall@16 across dataset shapes and seeds (the
    reference's acceptance floor for the tier)."""
    data = maker(2000, seed)
    _, _, exact = port_knn(data, 2, "euclidean", k=K, return_indices=True, device="cpu")
    _, _, idx = port_rpf.rpforest_core_distances(
        data, 2, "euclidean", K, trees=4, leaf_size=256, rescan_rounds=1, seed=seed,
        return_indices=True, device="cpu",
    )
    r = _recall(exact, idx)
    assert r >= 0.95, f"{maker.__name__} seed={seed}: recall {r:.4f}"


def test_rescan_improves_recall_and_self_comes_first():
    data = _blobs(2000, 5)
    _, _, exact = port_knn(data, 2, "euclidean", k=K, return_indices=True, device="cpu")
    rs = []
    for rounds in (0, 2):
        _, knn, idx = port_rpf.rpforest_core_distances(
            data, 2, "euclidean", K, trees=2, leaf_size=128, rescan_rounds=rounds, seed=5,
            return_indices=True, device="cpu",
        )
        rs.append(_recall(exact, idx))
        assert np.array_equal(idx[:, 0], np.arange(2000)) and np.all(knn[:, 0] == 0.0)
        assert np.all(np.diff(knn, axis=1) >= 0)
    assert rs[1] >= rs[0]


def test_core_contract():
    data = _blobs(500, 6)
    core, knn, idx = port_rpf.rpforest_core_distances(
        data, 5, "euclidean", 16, trees=3, leaf_size=128, rescan_rounds=1, seed=1,
        return_indices=True, device="cpu",
    )
    assert core.dtype == np.float64 and knn.dtype == np.float64 and idx.dtype == np.int64
    assert np.array_equal(core, knn[:, 3])
    kth, none = port_rpf.rpforest_core_distances(
        data, 5, "euclidean", 16, trees=3, leaf_size=128, rescan_rounds=1, seed=1,
        fetch_knn=False, device="cpu",
    )
    assert none is None and np.array_equal(kth, core)
    zero, _ = port_rpf.rpforest_core_distances(data, 1, trees=2, leaf_size=128, device="cpu",
                                               fetch_knn=False)
    assert np.all(zero == 0.0)


# -- tier resolution ------------------------------------------------------------


def test_resolve_knn_index_and_auto_threshold():
    assert port_rpf.resolve_knn_index("auto", 100, 1000) == "exact"
    assert port_rpf.resolve_knn_index("auto", 1000, 1000) == "rpforest"
    assert port_rpf.resolve_knn_index("exact", 10**9, 1) == "exact"
    assert port_rpf.resolve_knn_index("rpforest", 10, 10**9) == "rpforest"
    assert port_rpf.AUTO_INDEX_THRESHOLD == rpf.AUTO_INDEX_THRESHOLD
    with pytest.raises(ValueError, match="knn_index"):
        port_rpf.resolve_knn_index("annoy", 10, 10)


@pytest.mark.parametrize("n", [100, 600])
def test_resolve_index_for_matches_reference(n):
    kw = dict(knn_index="auto", knn_index_threshold=500, rpf_trees=3, rpf_leaf_size=64,
              rpf_rescan_rounds=2, seed=9, knn_backend="fused", knn_precision="bf16")
    assert resolve_index_for(PortParams(**kw), n) == ref_resolve(RefParams(**kw), n)


# -- the fit ---------------------------------------------------------------------

_TREE_FIELDS = (
    "parent", "birth", "death", "stability", "has_children", "num_members",
    "point_exit_level", "point_last_cluster", "propagated_stability",
    "lowest_child_death", "selected",
)


@pytest.mark.parametrize("knn_backend", ["auto", "fused"])
def test_integer_grid_fit_and_files_identical(tmp_path, knn_backend):
    data = _grid(3, 2400, 3, scale=3.0)
    kw = dict(min_points=16, min_cluster_size=60, mst_backend="device", knn_index="rpforest",
              rpf_trees=3, rpf_leaf_size=256, knn_backend=knn_backend,
              input_file=str(tmp_path / "grid.csv"))
    ref_params = RefParams(out_dir=str(tmp_path / "ref"), **kw)
    port_params = PortParams.from_dict(
        dict(dataclasses.asdict(ref_params), out_dir=str(tmp_path / "port")))
    ref = ref_exact.fit(data, ref_params)
    port = port_exact.fit(data, port_params, device="cpu")
    np.testing.assert_array_equal(port.labels, ref.labels)
    np.testing.assert_array_equal(port.core_distances, ref.core_distances)
    for a, b in zip(port.mst, ref.mst):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.outlier_scores, ref.outlier_scores)
    for f in _TREE_FIELDS:
        np.testing.assert_array_equal(getattr(port.tree, f), getattr(ref.tree, f), err_msg=f)
    assert len(np.unique(port.labels)) > 2
    ref_paths, port_paths = ref_write(ref, ref_params), port_write(port, port_params)
    assert sorted(ref_paths) == sorted(port_paths)
    for kind in ref_paths:
        with open(ref_paths[kind], "rb") as a, open(port_paths[kind], "rb") as b:
            assert a.read() == b.read(), kind


def test_continuous_fit_labels_identical():
    data = _blobs(2000, 4, 4)
    ref_params = RefParams(min_points=10, min_cluster_size=50, mst_backend="device",
                           knn_index="rpforest", rpf_trees=3, rpf_leaf_size=256)
    ref = ref_exact.fit(data, ref_params)
    port = port_exact.fit(data, PortParams.from_dict(dataclasses.asdict(ref_params)),
                          device="cpu")
    np.testing.assert_array_equal(port.labels, ref.labels)
    np.testing.assert_allclose(port.core_distances, ref.core_distances, rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(np.sort(port.mst[2]), np.sort(ref.mst[2]), rtol=2.5e-7, atol=0)


def test_auto_at_the_threshold_takes_the_forest():
    data = _grid(5, 800, 3)
    kw = dict(min_points=8, min_cluster_size=30, rpf_trees=2, rpf_leaf_size=128)
    auto = port_exact.fit(data, PortParams(knn_index="auto", knn_index_threshold=800, **kw),
                          device="cpu")
    forest = port_exact.fit(data, PortParams(knn_index="rpforest", **kw), device="cpu")
    exact = port_exact.fit(data, PortParams(knn_index="auto", knn_index_threshold=801, **kw),
                           device="cpu")
    np.testing.assert_array_equal(auto.core_distances, forest.core_distances)
    np.testing.assert_array_equal(auto.labels, forest.labels)
    exact_core = port_knn(data, 8, device="cpu", fetch_knn=False)[0]
    np.testing.assert_array_equal(exact.core_distances, exact_core)


def test_trace_events_carry_the_reference_fields():
    data = _blobs(1200, 10)
    kw = dict(trees=3, leaf_size=128, rescan_rounds=2, seed=6)
    for backend in ("auto", "fused"):
        tracer = Tracer()
        rpf.rpforest_core_distances(data, 5, "euclidean", K, trace=tracer, knn_backend=backend,
                                    **kw)
        ref = [(e.name, sorted([*e.fields, "wall_s"])) for e in tracer.events]
        events = []
        port_rpf.rpforest_core_distances(
            data, 5, "euclidean", K, knn_backend=backend, device="cpu",
            trace=lambda stage, **f: events.append((stage, sorted(f))), **kw)
        assert events == ref
    assert [name for name, _ in events] == [
        "knn_index_build", "knn_index_query", "knn_index_rescan", "knn_index_rescan",
        "knn_fused_forest"]


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import hdbscan_tpu_torch.ops.rpforest, hdbscan_tpu_torch.ops.cuda_forest\n"
        "import hdbscan_tpu_torch.core.knn\n"
        "bad = [m for m in sys.modules if m == 'hdbscan_tpu' or m.startswith('hdbscan_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
