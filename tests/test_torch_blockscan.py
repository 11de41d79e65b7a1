"""Block-pruned windowed scans (``ops/blockscan``) against the reference's.

The port keeps the reference's schedule (jobs, row tiles, chunks, pad tiles
on the dummy row, the tile guard's grain), so on integer-lattice data —
where every distance is exact in float32 and ties abound — the rescan's
core distances, neighbour distances and ids are bitwise equal to the
reference's for both window contracts, also under squeezed chunk budgets,
and the pruned glue returns the reference's edges in the reference's order.
"""

import numpy as np
import pytest

import hdbscan_tpu.ops.blockscan as ref_bs
import hdbscan_tpu_torch.ops.blockscan as port_bs
import torch
from hdbscan_tpu.ops import tiled as ref_tiled
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


def _blocky_data(rng, n=3000, d=5, n_blocks=12):
    """Spatially coherent blocks (the reference test's helper)."""
    pts = np.concatenate(
        [rng.normal(c * 3.0, 1.0, size=(n // 6, d)) for c in rng.normal(size=(6, d))]
    )[:n]
    proj = pts @ rng.normal(size=d) + rng.normal(0, 0.1, len(pts))
    order = np.argsort(proj)
    block_of = np.empty(len(pts), np.int64)
    for b, seg in enumerate(np.array_split(order, n_blocks)):
        block_of[seg] = b
    return pts, block_of


def _per_block_cores(pts, block_of, min_pts):
    core = np.empty(len(pts))
    for b in np.unique(block_of):
        ids = np.nonzero(block_of == b)[0]
        seg = pts[ids]
        dm = np.sqrt(((seg[:, None, :] - seg[None, :, :]) ** 2).sum(-1))
        core[ids] = np.sort(dm, axis=1)[:, min(min_pts - 1, len(ids)) - 1]
    return core


def _lattice(seed, n=1200, d=3, n_blocks=12):
    pts, block_of = _blocky_data(np.random.default_rng(seed), n=n, d=d, n_blocks=n_blocks)
    return np.round(pts * 2.0), block_of


def test_geometry_fields_equal_reference():
    pts, block_of = _blocky_data(np.random.default_rng(1), n=1500, d=4)
    ref = ref_bs.BlockGeometry.build(pts, block_of, col_tile=256)
    port = port_bs.BlockGeometry.build(pts, block_of, col_tile=256, device="cpu")
    for f in ("metric", "col_tile", "n", "n_pad", "win_tiles"):
        assert getattr(port, f) == getattr(ref, f), f
    for f in ("perm", "inv_perm", "block_ids", "starts", "ends", "centroid", "radius",
              "win_start", "data_host"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), err_msg=f)
    np.testing.assert_array_equal(port.data_sorted.numpy(), np.asarray(ref.data_sorted))
    np.testing.assert_array_equal(port.valid_sorted.numpy(), np.asarray(ref.valid_sorted))


def test_window_jobs_and_tiles_equal_reference():
    pts, block_of = _blocky_data(np.random.default_rng(2), n=1500, d=4)
    ref = ref_bs.BlockGeometry.build(pts, block_of, col_tile=256)
    port = port_bs.BlockGeometry.build(pts, block_of, col_tile=256, device="cpu")
    rows = pts[::3]
    ub = _per_block_cores(pts, block_of, 6)[::3]
    pr, pb = port.candidate_pairs(rows, ub)
    rr, rb = ref.candidate_pairs(rows, ub)
    np.testing.assert_array_equal(pr, rr)
    np.testing.assert_array_equal(pb, rb)
    jobs_p, jobs_r = port_bs._window_jobs(port, pr, pb), ref_bs._window_jobs(ref, rr, rb)
    assert [j[0] for j in jobs_p] == [j[0] for j in jobs_r]
    for (_, a), (_, b) in zip(jobs_p, jobs_r):
        np.testing.assert_array_equal(a, b)
    to_pos = lambda r: ref.inv_perm[r]  # noqa: E731
    got = list(port_bs._tiled_window_jobs(jobs_p, to_pos, 64, dummy=len(rows), slot_budget=512))
    want = list(ref_bs._tiled_window_jobs(jobs_r, to_pos, 64, dummy=len(rows), slot_budget=512))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)
    assert port_bs._window_jobs(port, np.zeros(0, np.int64), np.zeros(0, np.int64)) == []


def _rescan_both(pts, block_of, bset, min_pts, backend, **kw):
    ub = _per_block_cores(pts, block_of, min_pts)
    ref_geom = ref_bs.BlockGeometry.build(pts, block_of, col_tile=256)
    port_geom = port_bs.BlockGeometry.build(pts, block_of, col_tile=256, device="cpu")
    ref = ref_bs.knn_rows_blockpruned(ref_geom, bset, ub[bset], min_pts, return_neighbors=True,
                                      row_tile=64, backend=backend, **kw)
    port = port_bs.knn_rows_blockpruned(port_geom, bset, ub[bset], min_pts,
                                        return_neighbors=True, row_tile=64, backend=backend, **kw)
    return port, ref


def _assert_same(port, ref):
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", ["xla", "fused"])
@pytest.mark.parametrize("min_pts", [2, 6])
def test_rescan_bitwise_on_lattice(backend, min_pts):
    pts, block_of = _lattice(3)
    port, ref = _rescan_both(pts, block_of, np.arange(0, len(pts), 2), min_pts, backend)
    _assert_same(port, ref)


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_rescan_bitwise_under_squeezed_budgets(backend, monkeypatch):
    for mod in (ref_bs, port_bs):
        monkeypatch.setattr(mod, "_FUSED_SLOT_BUDGET", 256)  # 4 tiles per chunk
        monkeypatch.setattr(mod, "_BATCH_SLOT_BUDGET", 256)
        monkeypatch.setattr(mod, "_MIN_CHUNK_TILES", 2)
    pts, block_of = _lattice(4, n=900)
    port, ref = _rescan_both(pts, block_of, np.arange(len(pts)), 6, backend)
    _assert_same(port, ref)


def test_rescan_without_probe_and_with_manhattan():
    pts, block_of = _lattice(5, n=800)
    port, ref = _rescan_both(pts, block_of, np.arange(1, len(pts), 3), 5, "xla", probe_blocks=0)
    _assert_same(port, ref)
    ub = _per_block_cores(pts, block_of, 5)
    bset = np.arange(0, len(pts), 2)
    rg = ref_bs.BlockGeometry.build(pts, block_of, "manhattan", col_tile=256)
    pg = port_bs.BlockGeometry.build(pts, block_of, "manhattan", col_tile=256, device="cpu")
    want = ref_bs.knn_rows_blockpruned(rg, bset, ub[bset] * 2, 5, row_tile=64, backend="fused")
    got = port_bs.knn_rows_blockpruned(pg, bset, ub[bset] * 2, 5, row_tile=64, backend="fused")
    np.testing.assert_array_equal(got, want)


def test_rescan_continuous_within_tolerance():
    pts, block_of = _blocky_data(np.random.default_rng(6), n=1000, d=4)
    port, ref = _rescan_both(pts, block_of, np.arange(0, len(pts), 2), 6, "xla")
    np.testing.assert_allclose(port[0], ref[0], rtol=2.5e-7)
    np.testing.assert_allclose(port[1], ref[1], rtol=2.5e-7)
    assert np.mean(port[2] == ref[2]) > 0.99


def _knn_graph(pts, block_of, min_pts):
    port_geom = port_bs.BlockGeometry.build(pts, block_of, col_tile=256, device="cpu")
    _, knn_d, knn_j = port_bs.knn_rows_blockpruned(
        port_geom, np.arange(len(pts)), np.full(len(pts), np.inf), min_pts,
        return_neighbors=True, row_tile=64)
    return knn_d, knn_j


@pytest.mark.parametrize("mode", ["knn", "no_knn", "init_comp", "squeezed"])
def test_glue_edges_equal_reference(mode, monkeypatch):
    if mode == "squeezed":
        for mod in (ref_bs, port_bs):
            monkeypatch.setattr(mod, "_BATCH_SLOT_BUDGET", 256)
            monkeypatch.setattr(mod, "_MIN_CHUNK_TILES", 2)
            monkeypatch.setattr(mod, "_MERGE_SYNC_EVERY", 2)
    pts, block_of = _lattice(7, n=1000, d=4)
    core, _ = ref_tiled.knn_core_distances(pts, 6, row_tile=64, col_tile=256)
    knn_d = knn_j = init = None
    if mode != "no_knn":
        knn_d, knn_j = _knn_graph(pts, block_of, 6)
    if mode == "init_comp":
        init = (pts[:, 0] > np.median(pts[:, 0])).astype(np.int64) + 2 * (pts[:, 1] > 0)
    kw = dict(knn_d=knn_d, knn_j=knn_j, col_tile=256, row_tile=64, init_comp=init)
    want = ref_bs.boruvka_glue_edges_blockpruned(pts, block_of, core, **kw)
    events = []
    got = port_bs.boruvka_glue_edges_blockpruned(
        pts, block_of, core, device="cpu", trace=lambda s, **f: events.append((s, f)), **kw)
    assert len(want[0]) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert events and all(s == "glue_round" for s, _ in events)


def test_glue_dense_fallback_round_equals_reference():
    """dense_work_ratio=0 sends every round to the segment-min scan."""
    pts, block_of = _lattice(8, n=600, d=3)
    core, _ = ref_tiled.knn_core_distances(pts, 5, row_tile=64, col_tile=256)
    want = ref_bs.boruvka_glue_edges_blockpruned(pts, block_of, core, col_tile=256, row_tile=64,
                                                 dense_work_ratio=0.0)
    got = port_bs.boruvka_glue_edges_blockpruned(pts, block_of, core, col_tile=256, row_tile=64,
                                                 dense_work_ratio=0.0, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_single_group_and_ring_refused():
    pts = np.random.default_rng(9).normal(size=(200, 3))
    u, v, w = port_bs.boruvka_glue_edges_blockpruned(pts, np.zeros(200, np.int64),
                                                     np.zeros(200), device="cpu")
    assert len(u) == len(v) == len(w) == 0
    # The ring's dense rounds (every round dense here), once refused: the
    # host route's edges, on a mesh of three CPU shards.
    import torch

    from hdbscan_tpu_torch.parallel.mesh import get_mesh

    args = (pts, np.arange(200) // 50, np.zeros(200))
    host = port_bs.boruvka_glue_edges_blockpruned(*args, device="cpu", dense_work_ratio=0.0)
    ring = port_bs.boruvka_glue_edges_blockpruned(
        *args, device="cpu", dense_work_ratio=0.0, scan_backend="ring",
        mesh=get_mesh([torch.device("cpu")] * 3))
    assert len(host[0]) == 3
    for a, b in zip(ring, host):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="triangle"):
        port_bs.BlockGeometry.build(pts, np.zeros(200, np.int64), "cosine", device="cpu")


def test_rescan_rpforest_index_equals_reference():
    """``index="rpforest"`` slices the rows out of one forest pass (the
    forest build is bitwise at 3 <= d <= 8)."""
    pts, block_of = _lattice(10, n=900)
    bset = np.arange(0, len(pts), 3)
    opts = dict(trees=2, leaf_size=64, rescan_rounds=1, seed=0, knn_backend="xla",
                knn_precision="f32")
    ref_geom = ref_bs.BlockGeometry.build(pts, block_of, col_tile=256)
    port_geom = port_bs.BlockGeometry.build(pts, block_of, col_tile=256, device="cpu")
    ref = ref_bs.knn_rows_blockpruned(ref_geom, bset, np.zeros(len(bset)), 6,
                                      return_neighbors=True, index="rpforest", index_opts=opts)
    port = port_bs.knn_rows_blockpruned(port_geom, bset, np.zeros(len(bset)), 6,
                                        return_neighbors=True, index="rpforest",
                                        index_opts=opts)
    _assert_same(port, ref)
