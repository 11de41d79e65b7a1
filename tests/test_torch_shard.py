"""The sharded exact fit on a mesh of CPU shards (``parallel/mesh``,
``parallel/ring``, ``parallel/shard``): the ring k-NN scan against the
reference's ring on its forced 8-device CPU mesh, the sharded Borůvka
rounds against the port's single-device ``boruvka_mst_device`` edge for
edge, and the sharded ``exact.fit`` against the reference's single-device
fit (the reference's own sharded rounds raise on the installed jax).

Integer grids, so every comparison is bitwise. The reference's guarded ring
tile scan skips a tile unless some distance is strictly below a row's
k-th, so on an exact tie at the k-th slot it can keep another id than the
lexicographic merge; ring ids are compared where the reference's ring
agrees with its own host scan.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.models import exact as ref_exact
from hdbscan_tpu.models.hdbscan import write_outputs as ref_write
from hdbscan_tpu.ops.tiled import knn_core_distances as ref_knn
from hdbscan_tpu.parallel.mesh import get_mesh as ref_get_mesh
from hdbscan_tpu.parallel.ring import ring_knn_core_distances as ref_ring
from hdbscan_tpu_torch.config import HDBSCANParams as PortParams
from hdbscan_tpu_torch.core.mst_device import assert_rounds_converged, boruvka_mst_device
from hdbscan_tpu_torch.models import exact as port_exact
from hdbscan_tpu_torch.models.hdbscan import write_outputs as port_write
from hdbscan_tpu_torch.ops.tiled import knn_core_distances as port_knn
from hdbscan_tpu_torch.parallel import ring, shard
from hdbscan_tpu_torch.parallel.mesh import fetch, get_mesh, ring_permutation

TILES = dict(row_tile=64, col_tile=128)
_TREE_FIELDS = (
    "parent", "birth", "death", "stability", "has_children", "num_members",
    "point_exit_level", "point_last_cluster", "propagated_stability",
    "lowest_child_death", "selected",
)


def _cpu_mesh(d):
    return get_mesh([torch.device("cpu")] * d)


def _grid(seed, n, d=3, hi=20):
    return np.random.default_rng(seed).integers(0, hi, size=(n, d)).astype(np.float64)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_ring_knn_bitwise_vs_reference_ring(n_dev):
    data = _grid(n_dev, 700, hi=9)  # heavy duplicate ties; 700 is no shard multiple
    ref_mesh = ref_get_mesh(jax.devices()[:n_dev])
    rc, rk, ri = ref_ring(data, 11, return_indices=True, mesh=ref_mesh, **TILES)
    hc, hk, hi = ref_knn(data, 11, backend="xla", return_indices=True, **TILES)
    pc, pk, pi = ring.ring_knn_core_distances(data, 11, return_indices=True,
                                              mesh=_cpu_mesh(n_dev), **TILES)
    np.testing.assert_array_equal(pc, rc)
    np.testing.assert_array_equal(pk, rk)
    np.testing.assert_array_equal(pi, hi)  # the lexicographic k-best
    agree = ri == hi
    assert agree.mean() > 0.9
    np.testing.assert_array_equal(pi[agree], ri[agree])


@pytest.mark.parametrize("n_dev", [2, 8])
def test_ring_kth_only_and_uneven_shards(n_dev):
    """Trailing shards hold no rows at all (530 rows, 128-row shards)."""
    data = _grid(10 + n_dev, 530, hi=30)
    ref_mesh = ref_get_mesh(jax.devices()[:n_dev])
    rc, _ = ref_ring(data, 7, fetch_knn=False, mesh=ref_mesh, **TILES)
    pc, pk = ring.ring_knn_core_distances(data, 7, fetch_knn=False, mesh=_cpu_mesh(n_dev),
                                          **TILES)
    assert pk is None
    np.testing.assert_array_equal(pc, rc)
    np.testing.assert_array_equal(pc, port_knn(data, 7, fetch_knn=False, device="cpu",
                                               **TILES)[0])


def test_ring_geometry_and_trace():
    assert ring._ring_geometry(700, 4, 64, 128) == (64, 128, 256, 1024)
    assert ring._ring_geometry(245_057, 4, 1024, 8192) == (1024, 8192, 65536, 262144)
    assert ring_permutation(4) == [(0, 1), (1, 2), (2, 3), (3, 0)]
    events = []
    ring.ring_knn_core_distances(_grid(1, 300), 5, mesh=_cpu_mesh(4), fetch_knn=False,
                                 trace=lambda s, **k: events.append((s, k)), **TILES)
    scan = [k for s, k in events if s == "ring_knn_scan"]
    walls = [k for s, k in events if s == "ring_device_wall"]
    assert len(scan) == 1 and scan[0]["devices"] == 4 and scan[0]["ppermute_steps"] == 3
    assert [w["device"] for w in walls] == [0, 1, 2, 3]
    assert fetch([torch.arange(2), torch.arange(3)]).tolist() == [0, 1, 0, 1, 2]


def _trial(rng, n, d=2):
    """One adversarial (points, cores) draw, as the reference's sweep makes
    them: duplicate sites, all-equal weights, or a generic lattice."""
    kind = rng.choice(["duplicates", "all_equal_w", "generic"])
    if kind == "duplicates":
        sites = rng.integers(0, 4, size=(max(2, n // 8), d))
        return sites[rng.integers(0, len(sites), size=n)].astype(np.float64), \
            rng.integers(0, 3, size=n).astype(np.float64)
    if kind == "all_equal_w":
        return rng.integers(0, 5, size=(n, d)).astype(np.float64), np.full(n, 64.0)
    return rng.integers(0, 50, size=(n, d)).astype(np.float64), \
        rng.integers(0, 8, size=n).astype(np.float64)


def _assert_edges_equal(pts, core, n_dev, metric="euclidean"):
    one = boruvka_mst_device(pts, core, metric, device="cpu", **TILES)
    res = shard.shard_boruvka_mst(pts, core, metric, mesh=_cpu_mesh(n_dev), **TILES)
    for key in ("u", "v", "w"):
        assert torch.equal(torch.cat(res[key]), one[key]), key
    for key in ("count", "rounds", "round_syncs"):
        assert res[key] == one[key], key
    np.testing.assert_array_equal(res["stat_comp"], one["stat_comp"])
    np.testing.assert_array_equal(res["stat_edges"], one["stat_edges"])


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("n,trials", [(1, 2), (2, 4), (3, 4), (60, 12), (129, 12), (700, 4),
                                      (1031, 3)])
def test_sharded_mst_equals_single_device(n, trials, n_dev):
    rng = np.random.default_rng(1000 * n_dev + n)
    for _ in range(trials):
        _assert_edges_equal(*_trial(rng, n), n_dev)


def test_sharded_mst_all_points_identical():
    _assert_edges_equal(np.ones((60, 2)), np.full(60, 2.0), 4)


def test_sharded_mst_manhattan():
    rng = np.random.default_rng(7)
    pts = rng.integers(0, 20, size=(300, 3)).astype(np.float64)
    _assert_edges_equal(pts, rng.integers(0, 5, size=300).astype(np.float64), 4, "manhattan")


def test_sharded_round_cap_raises_with_surviving_components():
    rng = np.random.default_rng(11)
    n = 300
    pts = rng.integers(0, 50, size=(n, 2)).astype(np.float64)
    core = rng.integers(0, 8, size=n).astype(np.float64)
    res = shard.shard_boruvka_mst(pts, core, mesh=_cpu_mesh(4), max_rounds=1, **TILES)
    assert res["rounds"] == 1 and res["count"] < n - 1
    with pytest.raises(RuntimeError, match="round cap") as exc:
        assert_rounds_converged(res["rounds"], res["count"], n, max_rounds=1,
                                stat_comp=res["stat_comp"], stat_edges=res["stat_edges"],
                                where="shard_boruvka_mst")
    assert f"{int(res['stat_comp'][0])} components still unmerged" in str(exc.value)
    assert "shard_boruvka_mst" in str(exc.value)


def _blobs(seed, n, d=3):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-3, 3, size=(5, d))
    x = centers[rng.integers(0, 5, n)] + rng.normal(0, 0.4, size=(n, d))
    return np.round(np.concatenate([x, rng.uniform(-4, 4, size=(n // 10, d))]) * 8.0)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_fit_and_files_equal_reference_single_device(tmp_path, n_dev):
    data = _blobs(n_dev, 2800)
    ref_params = RefParams(input_file=str(tmp_path / "ref" / "grid.csv"),
                           out_dir=str(tmp_path / "ref"), min_points=16,
                           min_cluster_size=60, mst_backend="device")
    port_params = PortParams.from_dict(dict(
        dataclasses.asdict(ref_params), out_dir=str(tmp_path / "port"), fit_sharding="sharded",
    ))
    ref = ref_exact.fit(data, ref_params)
    events = []
    port = port_exact.fit(data, port_params, mesh=_cpu_mesh(n_dev),
                          trace=lambda s, **k: events.append((s, k)))
    np.testing.assert_array_equal(port.labels, ref.labels)
    np.testing.assert_array_equal(port.core_distances, ref.core_distances)
    for a, b in zip(port.mst, ref.mst):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.outlier_scores, ref.outlier_scores)
    for f in _TREE_FIELDS:
        np.testing.assert_array_equal(getattr(port.tree, f), getattr(ref.tree, f), err_msg=f)
    assert len(np.unique(port.labels)) > 2
    ref_paths = ref_write(ref, ref_params)
    port_paths = port_write(port, port_params)
    assert sorted(ref_paths) == sorted(port_paths)
    for kind in ref_paths:
        with open(ref_paths[kind], "rb") as a, open(port_paths[kind], "rb") as b:
            assert a.read() == b.read(), kind
        assert os.path.basename(ref_paths[kind]) == os.path.basename(port_paths[kind])
    stages = [s for s, _ in events]
    assert stages.count("host_sync") == 1
    rounds = [k for s, k in events if s == "mst_round"]
    assert rounds and all(k["sharded"] for k in rounds)
    assert [k["components"] for k in rounds] == sorted(
        {k["components"] for k in rounds}, reverse=True)
    summary = dict(events)["shard_mst_device"]
    assert summary["devices"] == n_dev and summary["rounds"] == len(rounds)
    assert dict(events)["ring_knn_scan"]["devices"] == n_dev


def test_fit_sharding_resolution():
    assert shard.resolve_fit_sharding("auto", None) == "replicated"
    assert shard.resolve_fit_sharding("auto", _cpu_mesh(4)) == "replicated"
    assert shard.resolve_fit_sharding("sharded", None) == "sharded"
    assert shard.resolve_fit_sharding("replicated", _cpu_mesh(2)) == "replicated"
    with pytest.raises(ValueError):
        shard.resolve_fit_sharding("x", None)
    # fit_sharding=sharded without a mesh shards once on the named device.
    data = _grid(3, 400)
    p = PortParams(min_points=8, min_cluster_size=20)
    a = port_exact.fit(data, p, device="cpu")
    b = port_exact.fit(data, dataclasses.replace(p, fit_sharding="sharded"), device="cpu")
    np.testing.assert_array_equal(a.labels, b.labels)
    for x, y in zip(a.mst, b.mst):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("piece", ["ring_rows", "sharded_rpforest"])
def test_once_refused_sharded_pieces_match_reference(piece):
    """The ring rows scan and the sharded rp-forest, once refused: bitwise
    equal to the reference's on two of its devices (the wider cases are in
    ``tests/test_torch_shard_forest.py``)."""
    from hdbscan_tpu.parallel import ring as ref_ring_mod
    from hdbscan_tpu.parallel import shard as ref_shard_mod

    data = _grid(5, 300)
    ref_mesh = ref_get_mesh(jax.devices()[:2])
    if piece == "ring_rows":
        rows = np.arange(0, 300, 7)
        want = ref_ring_mod.ring_knn_core_distances_rows(data, rows, 6, mesh=ref_mesh, **TILES)
        got = ring.ring_knn_core_distances_rows(data, rows, 6, mesh=_cpu_mesh(2), **TILES)
    else:
        opts = dict(trees=2, leaf_size=32, seed=1)
        want = ref_shard_mod.shard_core_distances(data, 6, mesh=ref_mesh, index="rpforest",
                                                  index_opts=opts)
        got = shard.shard_core_distances(data, 6, mesh=_cpu_mesh(2), index="rpforest",
                                         index_opts=opts)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["shard_scanner", "ring_scanner"])
def test_host_round_scanners_match_reference(kind):
    """The host-round sharded scanners, once refused: the Borůvka rounds
    over each on four CPU shards give the reference's edges through its
    own scanner on four of its devices (``mst_edges_from_core``)."""
    data = _grid(30, 700, hi=9)
    core = ref_knn(data, 8, fetch_knn=False, **TILES)[0]
    kw = (dict(fit_sharding="sharded") if kind == "shard_scanner"
          else dict(scan_backend="ring", fit_sharding="replicated"))
    want = ref_exact.mst_edges_from_core(data, core, **TILES, **kw,
                                         mesh=ref_get_mesh(jax.devices()[:4]))
    got = port_exact.mst_edges_from_core(data, core, **TILES, **kw, mesh=_cpu_mesh(4))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) == len(data) - 1
