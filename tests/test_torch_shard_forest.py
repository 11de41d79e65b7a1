"""The forest and rows scans over a mesh of CPU shards, each against the
reference's own run on as many of its forced CPU devices:

* ``parallel/shard.shard_forest_core_distances`` (per-shard trees, the ring
  panel exchange through B7's plain version): bitwise cores and the same
  sampled recall, at 3 <= d <= 8 (where XLA's CPU ``einsum`` sums the
  features in order, so the trees are the same), uneven n, and a last shard
  of pad rows only;
* ``parallel/ring.ring_knn_core_distances_rows`` and
  ``parallel/shard.shard_core_distances_rows``: bitwise, with fewer query
  rows than ``D * row_tile`` and none at all;
* ``parallel/blocks.run_packed_blocks(mesh=..., batch_pad=D)``: bitwise
  against the reference's mesh call and the port's one-device call;
* the forest over a mesh (``scan_backend=ring`` with ``knn_index=rpforest``):
  cores, lists and ids bitwise equal to the port's one-device forest, in
  the unfused route and in the kernels' (their plain versions here).

Integer-grid data made with numpy from a seed.
"""

import jax
import numpy as np
import pytest
import torch

from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.models import exact as ref_exact
from hdbscan_tpu.parallel import blocks as ref_blocks
from hdbscan_tpu.parallel import ring as ref_ring
from hdbscan_tpu.parallel import shard as ref_shard
from hdbscan_tpu.parallel.mesh import get_mesh as ref_get_mesh
from hdbscan_tpu_torch.config import HDBSCANParams as PortParams
from hdbscan_tpu_torch.models import exact as port_exact
from hdbscan_tpu_torch.ops import rpforest
from hdbscan_tpu_torch.parallel import blocks as port_blocks
from hdbscan_tpu_torch.parallel import ring, shard
from hdbscan_tpu_torch.parallel.mesh import block_shards, get_mesh, pad_batch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The mesh programs run many small per-shard ops: one intra-op thread
    keeps them from contending with the suite's other workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(d):
    return get_mesh([torch.device("cpu")] * d)


def _ref_mesh(d):
    return ref_get_mesh(jax.devices()[:d])


def _grid(seed, n, d=3, hi=30):
    return np.random.default_rng(seed).integers(0, hi, size=(n, d)).astype(np.float64)


def _recorder():
    events = {}
    return events, lambda stage, **f: events.setdefault(stage, []).append(f)


def test_block_shards_and_pad_batch():
    assert pad_batch(5, 4) == 8 and pad_batch(8, 4) == 8 and pad_batch(0, 3) == 0
    devs = ["a", "b", "c", "d"]
    assert block_shards(devs, 9) == [(0, 3, "a"), (3, 6, "b"), (6, 9, "c"), (9, 9, "d")]
    assert block_shards(devs, 2) == [(0, 1, "a"), (1, 2, "b"), (2, 2, "c"), (2, 2, "d")]


@pytest.mark.parametrize(
    "n,d,metric,n_dev",
    [
        (1003, 3, "euclidean", 2),
        (1001, 5, "euclidean", 4),
        (1003, 3, "manhattan", 4),
        (9, 3, "euclidean", 4),  # shard 3: the last shard holds pad rows only
    ],
)
def test_shard_forest_bitwise_vs_reference(n, d, metric, n_dev):
    data = _grid(n + d, n, d)
    kw = dict(trees=3, leaf_size=64, seed=2)
    ref_ev, ref_trace = _recorder()
    port_ev, port_trace = _recorder()
    want = ref_shard.shard_forest_core_distances(data, 7, metric, mesh=_ref_mesh(n_dev),
                                                 trace=ref_trace, **kw)
    got = shard.shard_forest_core_distances(data, 7, metric, mesh=_cpu_mesh(n_dev),
                                            trace=port_trace, **kw)
    np.testing.assert_array_equal(got, want)
    # The same neighbour ids: the sampled recall agrees exactly.
    r, p = ref_ev["shard_knn_exchange"][0], port_ev["shard_knn_exchange"][0]
    assert p.get("recall_at_k") == r.get("recall_at_k")
    assert {k: p[k] for k in ("k", "trees", "devices", "candidates")} == {
        k: r[k] for k in ("k", "trees", "devices", "candidates")}
    for stage in ("shard_knn_build", "shard_panel_sweep"):
        assert len(port_ev[stage]) == 1
    assert len(port_ev["ring_device_wall"]) == n_dev


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_shard_forest_chunked_visits_equal_whole(monkeypatch, precision):
    """A visit's rows in chunks (the element budget cut to a few dozen
    rows, so each visit launches B7 several times) give the whole visits'
    cores bitwise, bf16's 8-row tiles included."""
    from hdbscan_tpu_torch.ops import cuda_forest

    calls = []
    b7 = cuda_forest.forest_rescan_topk
    monkeypatch.setattr(cuda_forest, "forest_rescan_topk",
                        lambda q, *a, **kw: calls.append(len(q)) or b7(q, *a, **kw))
    data = _grid(5, 1003, 3)
    kw = dict(mesh=_cpu_mesh(2), trees=3, leaf_size=64, seed=2, knn_precision=precision)
    whole = shard.shard_forest_core_distances(data, 7, **kw)
    n_whole = len(calls)
    monkeypatch.setattr(rpforest, "_RESCAN_ELEM_BUDGET", 3 * 64 * 3 * 40)
    chunked = shard.shard_forest_core_distances(data, 7, **kw)
    np.testing.assert_array_equal(chunked, whole)
    assert len(calls) - n_whole > 4 * n_whole
    assert max(calls[n_whole:]) % 8 == 0 and max(calls[n_whole:]) <= 48


def test_shard_forest_bf16_recall_and_min_pts_one():
    """bf16 tiles centre on 8-row query tiles (the reference on each
    shard's block): held to recall, not bitwise."""
    data = _grid(4, 1500, 3)
    ev, trace = _recorder()
    core = shard.shard_forest_core_distances(data, 8, mesh=_cpu_mesh(3), trees=3,
                                             leaf_size=64, knn_precision="bf16", trace=trace)
    f32 = shard.shard_forest_core_distances(data, 8, mesh=_cpu_mesh(3), trees=3, leaf_size=64)
    assert ev["shard_knn_exchange"][0]["recall_at_k"] > 0.9
    np.testing.assert_allclose(core, f32, rtol=0.05, atol=0.5)
    zeros = shard.shard_forest_core_distances(data, 1, mesh=_cpu_mesh(2), trees=2)
    assert zeros.shape == (1500,) and not zeros.any()
    with pytest.raises(ValueError, match="euclidean only"):
        shard.shard_forest_core_distances(data, 8, "manhattan", mesh=_cpu_mesh(2),
                                          knn_precision="bf16")


@pytest.mark.parametrize(
    "n_dev,m",
    [(2, 0), (2, 5), (4, 700), (3, 1201)],
)
def test_rows_scans_bitwise_vs_reference(n_dev, m):
    """``m < D * row_tile`` leaves shards without query rows (they launch
    nothing); ``m = 0`` returns an empty array."""
    data = _grid(m, 1201, 3, hi=12)
    rows = np.random.default_rng(m).choice(len(data), m, replace=False)
    tiles = dict(row_tile=128, col_tile=256)
    ev, trace = _recorder()
    want = ref_ring.ring_knn_core_distances_rows(data, rows, 9, mesh=_ref_mesh(n_dev), **tiles)
    got = ring.ring_knn_core_distances_rows(data, rows, 9, mesh=_cpu_mesh(n_dev), trace=trace,
                                            **tiles)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (m,)
    want = ref_shard.shard_core_distances_rows(data, rows, 9, mesh=_ref_mesh(n_dev))
    got = shard.shard_core_distances_rows(data, rows, 9, mesh=_cpu_mesh(n_dev))
    np.testing.assert_array_equal(got, want)
    if m:
        assert ev["ring_rows_scan"][0]["rows"] == m


def test_rows_scan_forest_index_matches_reference():
    data = _grid(6, 900, 4)
    rows = np.arange(0, 900, 5)
    opts = dict(trees=2, leaf_size=64, seed=3)
    want = ref_shard.shard_core_distances_rows(data, rows, 6, mesh=_ref_mesh(3),
                                               index="rpforest", index_opts=opts)
    got = shard.shard_core_distances_rows(data, rows, 6, mesh=_cpu_mesh(3), index="rpforest",
                                          index_opts=opts)
    np.testing.assert_array_equal(got, want)
    # The ring's forest rows: the one-device forest's, sliced.
    opts = dict(opts, rescan_rounds=1)
    got = ring.ring_knn_core_distances_rows(data, rows, 6, mesh=_cpu_mesh(3),
                                            index="rpforest", index_opts=opts)
    one = rpforest.rpforest_core_distances_rows(data, rows, 6, device="cpu", **opts)
    np.testing.assert_array_equal(got, one)


@pytest.mark.parametrize("n_dev,with_core", [(2, False), (4, True)])
def test_run_packed_blocks_mesh_bitwise(n_dev, with_core):
    rng = np.random.default_rng(n_dev)
    data = rng.integers(0, 10, size=(900, 3)).astype(np.float64)
    sizes = [100, 37, 128, 90, 5, 128, 64]
    ids = np.split(rng.permutation(900)[: sum(sizes)], np.cumsum(sizes)[:-1])
    core = rng.random(900) if with_core else None
    packed = port_blocks.pack_blocks(data, ids, 128, core=core)
    ref_packed = ref_blocks.pack_blocks(data, ids, 128, core=core)
    budget = 3 * 128 * 128 * 8 * port_blocks._BLOCK_TEMPS  # several launches
    ev, trace = _recorder()
    got = port_blocks.run_packed_blocks(packed, 5, hbm_budget_bytes=budget,
                                        mesh=_cpu_mesh(n_dev), batch_pad=n_dev,
                                        dtype=np.float64, trace=trace)
    one = port_blocks.run_packed_blocks(packed, 5, hbm_budget_bytes=budget, device="cpu",
                                        dtype=np.float64)
    want = ref_blocks.run_packed_blocks(ref_packed, 5, mesh=_ref_mesh(n_dev),
                                        batch_pad=n_dev, hbm_budget_bytes=budget)
    for a, b, c in zip(got, one, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert ev["block_fit"][0]["launches"] >= 2


@pytest.mark.parametrize(
    "n_dev,metric,fused",
    [(2, "euclidean", False), (4, "manhattan", False), (3, "euclidean", True),
     (4, "cosine", True)],
)
def test_ring_forest_equals_one_device_forest(n_dev, metric, fused):
    """Leaf batches on the shards that own them, B6 and the B7 rescans on
    row shards: cores, lists and ids equal the one-device forest's, in the
    unfused route (off the card) and the kernels' route (their plain
    versions, as the card runs them)."""
    data = _grid(n_dev, 2001, 4)
    kw = dict(trees=3, leaf_size=96, rescan_rounds=2, seed=1, return_indices=True,
              knn_backend="fused" if fused else "xla")
    one = rpforest.rpforest_core_distances(data, 9, metric, device="cpu", **kw)
    got = rpforest.rpforest_core_distances(data, 9, metric, mesh=_cpu_mesh(n_dev), **kw)
    for a, b in zip(got, one):
        np.testing.assert_array_equal(a, b)


def test_ring_forest_lists_equal_one_device_lists():
    """The query and rescan loops over uneven row shards (three shards of
    2,001 rows, one device's tensors) hand back the one-device lists cut at
    the shards' bounds."""
    data = _grid(3, 2001, 4)
    forest = rpforest.build_forest(data, trees=3, leaf_size=96, seed=1, device="cpu")
    x = torch.as_tensor(data.astype(np.float32))
    cpu = torch.device("cpu")
    rows = block_shards(_cpu_mesh(3).devices, len(data))
    bd, bi = rpforest.forest_knn(x, forest, 8, "euclidean", backend="fused")
    lists = rpforest.forest_knn_shards({cpu: x}, rows, forest, 8, "euclidean", backend="fused")
    for rnd in range(2):
        bd, bi = rpforest.rescan_round(x, bd, bi, 8, "euclidean", rnd, 2, sentinel=len(data),
                                       backend="fused")
        lists = rpforest.rescan_round_shards({cpu: x}, rows, lists, 8, "euclidean", rnd, 2,
                                             len(data), backend="fused")
    assert [len(d) for d, _ in lists] == [hi - lo for lo, hi, _ in rows]
    assert torch.equal(torch.cat([d for d, _ in lists]), bd)
    assert torch.equal(torch.cat([i for _, i in lists]), bi)


def test_mesh_refuses_cpu_beside_cards(tmp_path, capsys):
    """A mesh is all CPU or all CUDA (no card is needed to be refused): the
    kernels are chosen by each tensor's device, and a mixed mesh would run
    some shards plain. The CLI's ``--device cpu,cuda:0`` exits 2."""
    from hdbscan_tpu_torch import cli

    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        get_mesh([torch.device("cpu"), torch.device("cuda", 0)])
    assert len(get_mesh([torch.device("cpu")] * 2).devices) == 2
    src = tmp_path / "pts.txt"
    np.savetxt(src, _grid(13, 40), delimiter=",")
    rc = cli.main([f"file={src}", "minPts=4", "minClSize=4", f"out_dir={tmp_path}",
                   "fit_sharding=sharded", "--device", "cpu,cuda:0"])
    assert rc == 2
    assert "all CPU or all CUDA" in capsys.readouterr().err


def test_ring_forest_core_distances_match_reference():
    """The reference's forest over its mesh is its one-device forest; the
    port's over four CPU shards equals it (d = 4, the forest bitwise)."""
    data = _grid(11, 1500, 4)
    kw = dict(trees=2, leaf_size=64, rescan_rounds=1, seed=0)
    want = ref_ring.ring_knn_core_distances(data, 8, fetch_knn=False, mesh=_ref_mesh(4),
                                            index="rpforest", index_opts=kw)[0]
    got = ring.ring_knn_core_distances(data, 8, fetch_knn=False, mesh=_cpu_mesh(4),
                                       index="rpforest", index_opts=kw)[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("route", ["sharded", "ring"])
def test_exact_fit_forest_over_mesh_matches_reference(route):
    """``exact.fit`` with ``knn_index=rpforest`` over four shards: the sharded
    fit's labels and cores are the reference's sharded fit's (its own
    approximation, not the one-device forest's); the ring fit's are the
    one-device forest fit's."""
    data = _grid(12, 1200, 3, hi=25)
    kw = dict(min_points=8, min_cluster_size=25, knn_index="rpforest", rpf_trees=2,
              rpf_leaf_size=64)
    kw.update(dict(fit_sharding="sharded", mst_backend="host") if route == "sharded"
              else dict(scan_backend="ring"))
    ref = ref_exact.fit(data, RefParams(**kw), mesh=_ref_mesh(4))
    port = port_exact.fit(data, PortParams(**kw), mesh=_cpu_mesh(4))
    np.testing.assert_array_equal(port.core_distances, ref.core_distances)
    np.testing.assert_array_equal(port.labels, ref.labels)
    if route == "ring":
        one = port_exact.fit(data, PortParams(**{k: v for k, v in kw.items()
                                                 if k != "scan_backend"}), device="cpu")
        np.testing.assert_array_equal(port.core_distances, one.core_distances)
        np.testing.assert_array_equal(port.labels, one.labels)
