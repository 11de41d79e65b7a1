"""The host-round exact route of the port (``models/exact.mst_edges``,
``mst_edges_from_core``, ``pool_mst``, ``mst_edges_random_blocks``) and its
two sharded scanners (``parallel/ring.RingBoruvkaScanner``,
``parallel/shard.ShardBoruvkaScanner``) against the reference on the CPU.

The reference runs on its forced 8-device CPU mesh (``tests/conftest.py``);
the port with ``device="cpu"`` or ``get_mesh([torch.device("cpu")] * D)``.
Small tiles (64 x 128) so the multi-tile and multi-shard paths run, with
uneven shards (700 rows). Integer grids with many exact ties: MST (u, v, w),
core distances, labels, every condensed-tree field and GLOSH are bitwise.
Continuous data at cosine and pearson with zero-norm rows: labels exact,
infinite cores in the same rows, the finite ones within an absolute 1e-6
(float32) or 1e-10 (float64) as in ``tests/test_torch_metrics.py`` — a
cosine distance near 0 carries an absolute error of a few ulp of 1.0, so a
relative bound does not apply; at euclidean within 1e-6 relative (float32)
and 1e-12 (float64).
"""

import jax
import numpy as np
import pytest
import torch

from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.models import exact as ref_exact
from hdbscan_tpu.parallel.mesh import get_mesh as ref_get_mesh
from hdbscan_tpu.parallel.ring import RingBoruvkaScanner as RefRingScanner
from hdbscan_tpu.parallel.shard import ShardBoruvkaScanner as RefShardScanner
from hdbscan_tpu.utils.unionfind import contract_min_edges as ref_contract
from hdbscan_tpu_torch.config import HDBSCANParams as PortParams
from hdbscan_tpu_torch.models import exact as port_exact
from hdbscan_tpu_torch.ops.tiled import BoruvkaScanner
from hdbscan_tpu_torch.parallel import ring, shard
from hdbscan_tpu_torch.parallel.mesh import Mesh, get_mesh

TILES = dict(row_tile=64, col_tile=128)
_TREE_FIELDS = (
    "parent", "birth", "death", "stability", "has_children", "num_members",
    "point_exit_level", "point_last_cluster", "propagated_stability",
    "lowest_child_death", "selected",
)


def _cpu_mesh(d):
    return get_mesh([torch.device("cpu")] * d)


def _ref_mesh(d):
    return ref_get_mesh(jax.devices()[:d])


def _grid(seed, n, d=3, hi=9):
    return np.random.default_rng(seed).integers(0, hi, size=(n, d)).astype(np.float64)


def _blobs(seed, per, d=3):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(4, d)) * 5.0
    return np.concatenate([c + rng.normal(size=(per, d)) for c in centres])


def _assert_mst_equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _assert_fits_identical(port, ref):
    np.testing.assert_array_equal(port.labels, ref.labels)
    np.testing.assert_array_equal(port.core_distances, ref.core_distances)
    _assert_mst_equal(port.mst, ref.mst)
    np.testing.assert_array_equal(port.outlier_scores, ref.outlier_scores)
    for f in _TREE_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(port.tree, f)), np.asarray(getattr(ref.tree, f)), err_msg=f
        )


# ---------------------------------------------------------------------------
# pool_mst


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_mst_matches_reference_on_tied_multigraphs(seed):
    """Random multigraphs with duplicate edges, self-loops and integer
    weights (many exact ties): the pooled MST equals the reference's edge
    for edge, n - 1 edges when the pool spans."""
    rng = np.random.default_rng(seed)
    n, m = 300, 3000
    u = rng.integers(0, n, m)
    v = rng.integers(0, n, m)
    u = np.concatenate([u, np.arange(n - 1), u[:200]])  # a spanning path, duplicates
    v = np.concatenate([v, np.arange(1, n), v[:200]])
    w = rng.integers(0, 6, len(u)).astype(np.float64)
    got = port_exact.pool_mst(u, v, w, n)
    want = ref_exact.pool_mst(u, v, w, n)
    _assert_mst_equal(got, want)
    assert len(got[0]) == n - 1


# ---------------------------------------------------------------------------
# mst_edges / mst_edges_from_core through the three scanners


SCANNERS = [("host", "replicated", 1), ("ring", "replicated", 1), ("ring", "replicated", 3),
            ("ring", "replicated", 4), ("host", "sharded", 1), ("host", "sharded", 3),
            ("host", "sharded", 4)]
SCANNER_IDS = [f"{'shard' if f == 'sharded' else s}-D{d}" for s, f, d in SCANNERS]


@pytest.mark.parametrize("scan_backend,fit_sharding,n_dev", SCANNERS, ids=SCANNER_IDS)
def test_mst_edges_matches_reference(scan_backend, fit_sharding, n_dev):
    """700 grid rows (no shard multiple: trailing shards uneven or empty)."""
    data = _grid(n_dev, 700)
    want = ref_exact.mst_edges(data, 8, **TILES)
    got = port_exact.mst_edges(data, 8, **TILES, mesh=_cpu_mesh(n_dev),
                               scan_backend=scan_backend, fit_sharding=fit_sharding)
    _assert_mst_equal(got, want)
    assert len(got[0]) == len(data) - 1


@pytest.mark.parametrize("scan_backend,fit_sharding,n_dev", SCANNERS, ids=SCANNER_IDS)
def test_mst_edges_from_core_ties_match_reference(scan_backend, fit_sharding, n_dev):
    """Zero core distances on a coarse grid: every weight is a plain grid
    distance, most of them tied many times over, so the three tie rules
    (per-point candidates, per-component ring winners, the contraction's
    (w, j) pick) are exercised; the edges equal the reference's."""
    data = _grid(10 + n_dev, 650, hi=5)
    core = np.zeros(len(data))
    want = ref_exact.mst_edges_from_core(data, core, "manhattan", **TILES)
    got = port_exact.mst_edges_from_core(data, core, "manhattan", **TILES,
                                         mesh=_cpu_mesh(n_dev), scan_backend=scan_backend,
                                         fit_sharding=fit_sharding)
    _assert_mst_equal(got, want)


@pytest.mark.parametrize("n_dev", [1, 3, 4])
@pytest.mark.parametrize("kind", ["ring", "shard"])
def test_scanner_rounds_match_reference_scanner(kind, n_dev):
    """``min_outgoing`` round for round against the reference's own
    scanner on ``n_dev`` of its CPU devices, under the same component
    labels (the reference's contraction between rounds)."""
    data = _grid(20 + n_dev, 700)
    core = ref_exact.mst_edges(data, 6, **TILES)[3]
    port_cls = ring.RingBoruvkaScanner if kind == "ring" else shard.ShardBoruvkaScanner
    ref_cls = RefRingScanner if kind == "ring" else RefShardScanner
    events = []
    port = port_cls(data, core, "euclidean", **TILES, mesh=_cpu_mesh(n_dev),
                    trace=lambda s, **f: events.append((s, f)))
    ref = ref_cls(data, core, "euclidean", **TILES, mesh=_ref_mesh(n_dev))
    comp = np.arange(len(data), dtype=np.int64)
    rounds = 0
    while len(np.unique(comp)) > 1:
        pw, pj = port.min_outgoing(comp)
        rw, rj = ref.min_outgoing(comp)
        np.testing.assert_array_equal(pw, rw)
        np.testing.assert_array_equal(pj, rj)
        emit, comp, _ = ref_contract(comp, rj, rw)
        assert len(emit)
        rounds += 1
    port.close()
    stage = "ring_boruvka_scan" if kind == "ring" else "shard_boruvka_scan"
    scans = [f for s, f in events if s == stage]
    assert [f["round"] for f in scans] == list(range(rounds))
    assert all(f["devices"] == n_dev and f["ppermute_steps"] == n_dev - 1 for f in scans)
    assert scans[0]["n_comp"] == len(data) and scans[0]["candidates"] > 0
    walls = [f for s, f in events if s == "ring_device_wall"]
    assert len(walls) == rounds * n_dev


def test_host_scanner_float64_and_walls():
    data = _blobs(5, 60)
    core = np.zeros(len(data))
    sc = BoruvkaScanner(data, core, "euclidean", device="cpu", dtype=np.float64)
    bw, bj = sc.min_outgoing(np.arange(len(data)))
    d = np.sqrt(((data[:, None] - data[None]) ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    np.testing.assert_allclose(bw, d.min(1), rtol=1e-15)
    np.testing.assert_array_equal(bj, d.argmin(1))
    assert all(t >= 0 for t in sc.walls)


def test_scan_backend_resolution():
    assert ring.resolve_scan_backend("auto", None) == "host"
    assert ring.resolve_scan_backend("auto", _cpu_mesh(4)) == "host"
    assert ring.resolve_scan_backend("ring", None) == "ring"
    assert ring.resolve_scan_backend("host", _cpu_mesh(2)) == "host"
    # auto takes the ring on two or more distinct cards only (a mesh's
    # devices are only named here; nothing runs on them).
    two_cards = Mesh((torch.device("cuda", 0), torch.device("cuda", 1)))
    assert ring.resolve_scan_backend("auto", two_cards) == "ring"
    assert ring.resolve_scan_backend("auto", Mesh((torch.device("cuda", 0),) * 4)) == "host"
    with pytest.raises(ValueError):
        ring.resolve_scan_backend("x", None)


# ---------------------------------------------------------------------------
# exact.fit down the host-round route


ROUTES = {
    "host": (dict(mst_backend="host"), None),
    "ring4": (dict(scan_backend="ring"), 4),
    "shard3": (dict(fit_sharding="sharded", mst_backend="host"), 3),
}


def _fit_pair(x, route, dtype=np.float32, **kw):
    extra, n_dev = ROUTES[route]
    kw = dict(kw, **extra)
    ref = ref_exact.fit(x, RefParams(**kw), dtype=dtype, **TILES,
                        mesh=None if n_dev is None else _ref_mesh(n_dev))
    port = port_exact.fit(x, PortParams(**kw), dtype=dtype, **TILES,
                          **({"device": "cpu"} if n_dev is None else {"mesh": _cpu_mesh(n_dev)}))
    return port, ref


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("metric", ["euclidean", "manhattan", "supremum"])
def test_host_route_fit_identical_on_grid(metric, route):
    x = np.round(_blobs(7, 200) * 3.0)  # four blobs on an integer grid
    port, ref = _fit_pair(x, route, min_points=8, min_cluster_size=30, dist_function=metric)
    _assert_fits_identical(port, ref)
    assert len(np.unique(port.labels)) > 1


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("metric", ["cosine", "pearson"])
def test_host_route_fit_zero_norm_rows(metric, dtype, route):
    """Zero rows (cosine) or constant rows (pearson) in two tiles of the
    host scan and on two ring shards: the tile rule of each route's
    reference scan gives the same labels and infinite cores."""
    x = _blobs(3, 150)
    x[[5, 300, 301]] = 0.0 if metric == "cosine" else 2.0
    port, ref = _fit_pair(x, route, dtype, min_points=8, min_cluster_size=20,
                          dist_function=metric)
    tol = 1e-6 if dtype == np.float32 else 1e-10
    np.testing.assert_array_equal(port.labels, ref.labels)
    inf = np.isinf(ref.core_distances)
    assert inf.sum() == 3
    np.testing.assert_array_equal(np.isinf(port.core_distances), inf)
    np.testing.assert_allclose(port.core_distances[~inf], ref.core_distances[~inf],
                               rtol=0, atol=tol)
    assert len(np.unique(port.labels)) > 2


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6), (np.float64, 1e-12)])
@pytest.mark.parametrize("route", list(ROUTES))
def test_host_route_fit_continuous(route, dtype, rtol):
    x = _blobs(4, 200)
    port, ref = _fit_pair(x, route, dtype, min_points=8, min_cluster_size=30)
    np.testing.assert_array_equal(port.labels, ref.labels)
    np.testing.assert_allclose(port.core_distances, ref.core_distances, rtol=rtol)
    for a, b in zip(port.mst[:2], ref.mst[:2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(port.mst[2], ref.mst[2], rtol=rtol)


def test_host_route_trace_events():
    events = []
    x = _grid(8, 500)
    port_exact.fit(x, PortParams(min_points=8, min_cluster_size=20, mst_backend="host"),
                   device="cpu", **TILES, trace=lambda s, **f: events.append((s, f)))
    stages = [s for s, _ in events]
    assert stages[0] == "core_distances"
    rounds = [f for s, f in events if s == "boruvka_round"]
    assert [f["round"] for f in rounds] == list(range(len(rounds)))
    assert rounds[-1]["components"] == 1
    assert all(f["scan_s"] >= 0 and f["contract_s"] >= 0 for f in rounds)
    mst = [f for s, f in events if s == "boruvka_mst"]
    assert mst[0]["edges"] == len(x) - 1 and mst[0]["rounds"] == len(rounds)
    assert "tree_merge_forest" in stages  # mst_backend=host: the forest on the host
    assert "host_sync" not in stages


def test_ring_route_auto_builds_the_device_forest():
    """scan_backend=ring with mst_backend=auto runs the host rounds and
    builds the forest through the union-find event scan (K3's plain
    version), as the reference's auto finalize would at this size."""
    events = []
    x = _grid(9, 500)
    p = PortParams(min_points=8, min_cluster_size=20, scan_backend="ring")
    res = port_exact.fit(x, p, mesh=_cpu_mesh(2), **TILES,
                         trace=lambda s, **f: events.append((s, f)))
    stages = [s for s, _ in events]
    assert "ring_boruvka_scan" in stages and "boruvka_round" in stages
    assert "tree_build_device" in stages and "tree_merge_forest" not in stages
    want = ref_exact.fit(x, RefParams(min_points=8, min_cluster_size=20, mst_backend="host"),
                         **TILES)
    _assert_fits_identical(res, want)


def test_non_sharded_mesh_runs_the_host_scanner_on_its_root():
    x = _grid(11, 400)
    p = PortParams(min_points=8, min_cluster_size=20, mst_backend="host")
    events = []
    a = port_exact.fit(x, p, mesh=_cpu_mesh(3), **TILES,
                       trace=lambda s, **f: events.append(s))
    assert "ring_boruvka_scan" not in events and "shard_boruvka_scan" not in events
    _assert_fits_identical(a, port_exact.fit(x, p, device="cpu", **TILES))


# ---------------------------------------------------------------------------
# Random Blocks


@pytest.mark.parametrize("n_parts,seed", [(1, 0), (4, 0), (5, 3)])
def test_random_blocks_matches_reference(n_parts, seed):
    """Bitwise the reference's RB at the same seed and n_parts (max_block
    256 raises 4 and 5 parts to 6 on 700 rows), and its MST weights equal
    the tiled route's."""
    x = _grid(12, 700, hi=12)
    want = ref_exact.mst_edges_random_blocks(x, 8, n_parts=n_parts, seed=seed, max_block=256
                                             if n_parts > 1 else 8192)
    events = []
    got = port_exact.mst_edges_random_blocks(
        x, 8, n_parts=n_parts, seed=seed, max_block=256 if n_parts > 1 else 8192,
        device="cpu", trace=lambda s, **f: events.append((s, f)),
    )
    _assert_mst_equal(got, want)
    tiled = port_exact.mst_edges(x, 8, device="cpu")
    np.testing.assert_array_equal(np.sort(got[2]), np.sort(tiled[2]))
    np.testing.assert_array_equal(got[3], tiled[3])
    blocks = [f for s, f in events if s == "block_msts"]
    assert blocks[-1]["blocks"] == blocks[-1]["total_blocks"]
    assert all(f["pool_s"] >= 0 and f["block_s"] >= 0 for f in blocks)


def test_random_blocks_float64_continuous():
    x = _blobs(6, 120)
    want = ref_exact.mst_edges_random_blocks(x, 6, n_parts=3, seed=1, dtype=np.float64)
    got = port_exact.mst_edges_random_blocks(x, 6, n_parts=3, seed=1, dtype=np.float64,
                                             device="cpu")
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-12)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-12)


@pytest.mark.parametrize(
    "params",
    [dict(mst_backend="host"), dict(scan_backend="ring"), dict(dedup_points=True)],
    ids=["mst_backend_host", "scan_backend_ring", "dedup_points"],
)
def test_new_routes_need_a_device_without_a_card(params):
    """No fallback: without a card and without ``device="cpu"`` every new
    route raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the fit would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_exact.fit(_grid(0, 50), PortParams(min_points=4, **params))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_exact.mst_edges_random_blocks(_grid(0, 50), 4)
