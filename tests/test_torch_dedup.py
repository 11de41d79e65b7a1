"""The dedup route of the port (``core/dedup.py``, ``models/exact._fit_dedup``)
against the reference's ``hdbscan_tpu.core.dedup`` and its dedup fit, on the
CPU (the reference on its forced 8-device mesh, the port with
``device="cpu"`` or a mesh of CPU shards).

Integer grids: core distances, labels, MST, tree fields and GLOSH bitwise
against the reference's dedup fit; labels equal the full-row fit's (ARI
1.0) with heavy groups past ``min_cluster_size`` expanded.
"""

import jax
import numpy as np
import pytest
import torch

from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.core import dedup as ref_dedup
from hdbscan_tpu.models import exact as ref_exact
from hdbscan_tpu.ops.tiled import knn_core_distances as ref_knn
from hdbscan_tpu.parallel.mesh import get_mesh as ref_get_mesh
from hdbscan_tpu_torch.config import HDBSCANParams as PortParams
from hdbscan_tpu_torch.core import dedup
from hdbscan_tpu_torch.models import exact as port_exact
from hdbscan_tpu_torch.models import hdbscan as port_dense
from hdbscan_tpu_torch.parallel.mesh import get_mesh
from hdbscan_tpu_torch.utils.evaluation import adjusted_rand_index
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


TILES = dict(row_tile=64, col_tile=128)
_TREE_FIELDS = (
    "parent", "birth", "death", "stability", "has_children", "num_members",
    "point_exit_level", "point_last_cluster", "propagated_stability",
    "lowest_child_death", "selected",
)


def _dup_rows(seed, n_unique=150, reps=(1, 2, 5, 9), scale=3.0):
    """Blobs on an integer grid, unique point i repeated reps[i % len]
    times, rows shuffled."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-3, 3, size=(3, 3))
    pts = np.round((centres[rng.integers(0, 3, n_unique)]
                    + rng.normal(0, 0.5, size=(n_unique, 3))) * scale)
    pts = np.unique(pts, axis=0)
    rows = np.concatenate([np.repeat(pts[i : i + 1], reps[i % len(reps)], axis=0)
                           for i in range(len(pts))])
    return rows[rng.permutation(len(rows))]


def _heavy_rows(seed):
    """Three groups of 40 duplicate rows (past min_cluster_size 20) amid
    lighter groups and singletons: ``expand_heavy_groups`` runs."""
    rng = np.random.default_rng(seed)
    base = _dup_rows(seed, n_unique=120, reps=(1, 2, 3))
    heavy = np.round(rng.uniform(-6, 6, size=(3, 3)))
    return np.concatenate([base, np.repeat(heavy, 40, axis=0)])[
        rng.permutation(len(base) + 120)]


def _assert_same(port, ref):
    np.testing.assert_array_equal(port.labels, ref.labels)
    np.testing.assert_array_equal(port.core_distances, ref.core_distances)
    for a, b in zip(port.mst, ref.mst):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.outlier_scores, ref.outlier_scores)
    np.testing.assert_array_equal(port.dedup_inverse, ref.dedup_inverse)
    for f in _TREE_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(port.tree, f)), np.asarray(getattr(ref.tree, f)), err_msg=f
        )


def test_deduplicate_matches_reference():
    rows = _dup_rows(0)
    got, want = dedup.deduplicate(rows), ref_dedup.deduplicate(rows)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    uniq, counts, inverse = got
    assert counts.sum() == len(rows)
    np.testing.assert_array_equal(uniq[inverse], rows)


@pytest.mark.parametrize("min_pts", [1, 2, 6, 16])
def test_weighted_core_distances_matches_reference(min_pts):
    """Lists with ids from the reference's scan, padding (-1, +inf) where k
    exceeds the unique points of a tiny set."""
    rows = _dup_rows(1)
    uniq, counts, _ = dedup.deduplicate(rows)
    k = max(min_pts, 2)
    _, knn_d, knn_i = ref_knn(uniq, min_pts, k=k, return_indices=True)
    np.testing.assert_array_equal(
        dedup.weighted_core_distances(knn_d, knn_i, counts, min_pts),
        ref_dedup.weighted_core_distances(knn_d, knn_i, counts, min_pts),
    )
    with pytest.raises(ValueError, match="need k"):
        dedup.weighted_core_distances(knn_d[:, :1], knn_i[:, :1], counts, 8)


def test_weighted_core_tiny_clamp_is_finite():
    """Rows below minPts coverage clamp to the farthest finite distance,
    not the +inf list padding (the reference's ``test_dedup.py`` case)."""
    rows = np.array([[0.0, 0.0], [0.0, 0.0], [1.0, 0.0], [2.0, 0.0]])
    params = dict(min_points=6, min_cluster_size=2)
    full = port_dense.fit(rows, PortParams(**params), device="cpu")
    port = port_exact.fit(rows, PortParams(dedup_points=True, **params), device="cpu")
    ref = ref_exact.fit(rows, RefParams(dedup_points=True, **params))
    assert np.all(np.isfinite(port.core_distances))
    np.testing.assert_array_equal(port.core_distances, ref.core_distances)
    np.testing.assert_allclose(port.core_distances, full.core_distances, rtol=1e-6)
    np.testing.assert_array_equal(port.labels, ref.labels)


@pytest.mark.parametrize("n_dev", [None, 1, 3, 4])
def test_global_weighted_core_distances_matches_reference(n_dev):
    """Replicated (the k-best scan with ids) and sharded (the ring scan on
    ``n_dev`` shards), each against the reference's replicated and sharded
    scan: bitwise."""
    rows = _dup_rows(2, n_unique=400)
    uniq, counts, _ = dedup.deduplicate(rows)
    if n_dev is None:
        got = dedup.global_weighted_core_distances(uniq, counts, 6, "euclidean", **TILES,
                                                   device="cpu")
        want = ref_dedup.global_weighted_core_distances(uniq, counts, 6, "euclidean", **TILES)
    else:
        got = dedup.global_weighted_core_distances(
            uniq, counts, 6, "euclidean", **TILES, fit_sharding="sharded",
            mesh=get_mesh([torch.device("cpu")] * n_dev))
        want = ref_dedup.global_weighted_core_distances(
            uniq, counts, 6, "euclidean", **TILES, fit_sharding="sharded",
            mesh=ref_get_mesh(jax.devices()[:n_dev]))
    np.testing.assert_array_equal(got, want)


def test_expand_heavy_groups_matches_reference():
    rng = np.random.default_rng(3)
    n = 50
    counts = rng.choice([1.0, 2.0, 7.0, 25.0], size=n)
    u = np.arange(n - 1)
    v = np.arange(1, n)
    w = rng.integers(0, 5, n - 1).astype(float)
    core = rng.integers(0, 5, n).astype(float)
    for mcs in (5, 20, 100):
        got = dedup.expand_heavy_groups(u, v, w, core, counts, mcs)
        want = ref_dedup.expand_heavy_groups(u, v, w, core, counts, mcs)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert len(dedup.expand_heavy_groups(u, v, w, core, counts, 20)[0]) > n - 1


ROUTES = {
    "host": (dict(), None),
    "ring3": (dict(scan_backend="ring"), 3),
    "shard4": (dict(fit_sharding="sharded"), 4),
}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("data", ["dup", "heavy"])
def test_dedup_fit_matches_reference_and_full_rows(data, route):
    """The dedup fit through each scanner against the reference's dedup
    fit (bitwise) and the full-row fit (ARI 1.0, equal core distances)."""
    rows = _dup_rows(4) if data == "dup" else _heavy_rows(5)
    extra, n_dev = ROUTES[route]
    kw = dict(min_points=6, min_cluster_size=20, dedup_points=True, **extra)
    ref = ref_exact.fit(rows, RefParams(**kw), **TILES,
                        mesh=None if n_dev is None else ref_get_mesh(jax.devices()[:n_dev]))
    port = port_exact.fit(rows, PortParams(**kw), **TILES,
                          **({"device": "cpu"} if n_dev is None else
                             {"mesh": get_mesh([torch.device("cpu")] * n_dev)}))
    _assert_same(port, ref)
    full = port_exact.fit(rows, PortParams(min_points=6, min_cluster_size=20), device="cpu",
                          **TILES)
    assert adjusted_rand_index(port.labels, full.labels) == 1.0
    np.testing.assert_array_equal(port.core_distances, full.core_distances)
    assert len(np.unique(port.labels)) > 1


def test_dedup_fit_trace_and_heavy_expansion():
    rows = _heavy_rows(6)
    events = []
    p = PortParams(min_points=6, min_cluster_size=20, dedup_points=True)
    res = port_exact.fit(rows, p, device="cpu", trace=lambda s, **f: events.append((s, f)))
    ev = dict(events)
    uniq = len(np.unique(rows, axis=0))
    assert ev["dedup"] == {"rows": len(rows), "unique": uniq}
    assert ev["boruvka_mst"]["edges"] == uniq - 1
    # The expanded weights are integral: both finalize gates pass (the
    # device forest build and the vectorized condense).
    assert "tree_build_device" in ev and "tree_merge_forest" not in ev
    assert ev["tree_condense"]["backend"] == "vectorized"
    assert res.tree.n_clusters > 1 and len(res.labels) == len(rows)


@pytest.mark.parametrize("metric", ["cosine", "pearson"])
def test_dedup_fit_zero_norm_rows_collapse(metric):
    """Zero rows (cosine) or constant rows (pearson), many of them equal:
    they collapse into unique points whose distances are all NaN, and the
    dedup fit still gives the reference's dedup fit (labels, infinite
    cores) at float64."""
    rng = np.random.default_rng(8)
    centres = rng.normal(size=(3, 3)) * 5.0
    pts = np.round(np.concatenate([c + rng.normal(size=(150, 3)) for c in centres]) * 2.0)
    rows = np.repeat(pts, rng.integers(1, 4, len(pts)), axis=0)
    bad = np.repeat([[0.0] * 3, [2.0] * 3] if metric == "cosine" else [[2.0] * 3, [5.0] * 3],
                    [4, 3], axis=0)
    rows = np.concatenate([rows, bad])[rng.permutation(len(rows) + 7)]
    kw = dict(min_points=6, min_cluster_size=20, dist_function=metric, dedup_points=True)
    ref = ref_exact.fit(rows, RefParams(**kw), dtype=np.float64, **TILES)
    port = port_exact.fit(rows, PortParams(**kw), device="cpu", dtype=np.float64, **TILES)
    np.testing.assert_array_equal(port.labels, ref.labels)
    inf = np.isinf(ref.core_distances)
    assert inf.any()
    np.testing.assert_array_equal(np.isinf(port.core_distances), inf)
    np.testing.assert_allclose(port.core_distances[~inf], ref.core_distances[~inf],
                               rtol=0, atol=1e-10)


def test_dedup_fit_float64_continuous():
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(200, 3))
    rows = np.repeat(pts, rng.integers(1, 5, 200), axis=0)
    kw = dict(min_points=6, min_cluster_size=20, dedup_points=True)
    ref = ref_exact.fit(rows, RefParams(**kw), dtype=np.float64)
    port = port_exact.fit(rows, PortParams(**kw), device="cpu", dtype=np.float64)
    np.testing.assert_array_equal(port.labels, ref.labels)
    np.testing.assert_allclose(port.core_distances, ref.core_distances, rtol=1e-12)
