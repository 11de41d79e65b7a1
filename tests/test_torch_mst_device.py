"""Device MST -> merge forest: the port's ``boruvka_mst_device``,
``forest_events_device`` (with the plain version of kernel K3) and
``assemble_merge_forest`` against the reference's, on a randomized
integer-grid sweep. Every output is compared bitwise: edges, weights,
counts, rounds, per-round stats, the union event stream and every
``MergeForest`` field.
"""

import numpy as np
import pytest
import torch

from hdbscan_tpu.core import mst_device as RM
from hdbscan_tpu.ops.tiled import knn_core_distances as ref_knn
from hdbscan_tpu_torch.core import mst_device as PM

# (seed, n, d, grid, min_pts, row_tile, col_tile): ragged n, duplicate-heavy
# grids (tie groups), default and small tiles.
_SWEEP = [
    (0, 2, 2, 3, 2, 1024, 8192),
    (1, 17, 2, 3, 3, 1024, 8192),
    (2, 60, 3, 4, 5, 8, 128),
    (3, 129, 2, 6, 4, 32, 128),
    (4, 300, 3, 8, 8, 1024, 8192),
    (5, 700, 3, 16, 16, 64, 128),
    (6, 1031, 2, 32, 6, 1024, 8192),
]


def _forest_equal(a, b):
    assert a is not None and b is not None
    assert a.n_points == b.n_points
    np.testing.assert_array_equal(np.asarray(a.dist), np.asarray(b.dist))
    assert [int(r) for r in a.roots] == [int(r) for r in b.roots]
    np.testing.assert_array_equal(np.asarray(a.sizes), np.asarray(b.sizes))
    assert len(a.children) == len(b.children)
    for x, y in zip(a.children, b.children):
        assert (x is None) == (y is None)
        if x is not None:
            assert [int(v) for v in x] == [int(v) for v in y]
    assert (a.kids_csr is None) == (b.kids_csr is None)
    if a.kids_csr is None:
        return
    np.testing.assert_array_equal(np.asarray(a.kids_csr[0]), np.asarray(b.kids_csr[0]))
    np.testing.assert_array_equal(np.asarray(a.kids_csr[1]), np.asarray(b.kids_csr[1]))


@pytest.mark.parametrize("case", _SWEEP, ids=lambda c: f"seed{c[0]}-n{c[1]}")
def test_boruvka_events_forest_bitwise(case):
    seed, n, d, grid, min_pts, row_tile, col_tile = case
    data = np.random.default_rng(seed).integers(0, grid, size=(n, d)).astype(np.float64)
    core, _ = ref_knn(data, min_pts, fetch_knn=False)

    ref = RM.boruvka_mst_device(data, core, "euclidean", row_tile, col_tile)
    port = PM.boruvka_mst_device(data, core, "euclidean", row_tile, col_tile, device="cpu")
    for key in ("u", "v", "w"):
        np.testing.assert_array_equal(port[key].numpy(), np.asarray(ref[key]))
    assert port["count"] == int(ref["count"]) == n - 1
    assert port["rounds"] == int(ref["rounds"]) == port["round_syncs"]
    np.testing.assert_array_equal(port["stat_comp"], np.asarray(ref["stat_comp"]))
    np.testing.assert_array_equal(port["stat_edges"], np.asarray(ref["stat_edges"]))

    rev = RM.forest_events_device(ref["u"], ref["v"], ref["w"], n)
    pev = PM.forest_events_device(port["u"], port["v"], port["w"], n)
    for key in ("sw", "ra", "rb"):
        np.testing.assert_array_equal(pev[key].numpy(), np.asarray(rev[key]))

    host = {k: np.asarray(v) for k, v in rev.items()}
    for build_children in (True, False):
        rf = RM.assemble_merge_forest(n, host, build_children=build_children)
        pf = PM.assemble_merge_forest(
            n, {k: v.numpy() for k, v in pev.items()}, build_children=build_children
        )
        if build_children:
            _forest_equal(pf, rf)
        else:
            assert pf.children is None and rf.children is None
            np.testing.assert_array_equal(pf.kids_csr[0], rf.kids_csr[0])


@pytest.mark.parametrize("seed", range(6))
def test_uf_scan_stream_matches_reference_on_unsorted_pools(seed):
    """Path halving changes only the parent array, never the roots: the
    event stream equals the reference scan's on arbitrary edge orders,
    self-loops and repeated edges included."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 400))
    m = int(rng.integers(1, 3 * n))
    u = rng.integers(0, n, m).astype(np.int32)
    v = np.where(rng.random(m) < 0.1, u, rng.integers(0, n, m)).astype(np.int32)
    _, (ra, rb) = RM._uf_scan(u, v, n)
    pa, pb = PM.uf_scan(torch.from_numpy(u), torch.from_numpy(v), n)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(rb))


@pytest.mark.parametrize(
    "w,pw",
    [
        ([1.0, 2.0, 2.0, 3.0], None),
        ([1.0, 1.0 + 1e-12, 2.0], None),       # near-tied but unequal
        ([1.0, 2.0], [1.0, 2.0, 3.0]),          # integral weights
        ([1.0, 2.0], [1.0, 2.5, 3.0]),          # fractional weights
        ([np.inf, 1.0, np.inf], None),          # padding rows
    ],
)
def test_supports_inputs_matches_reference(w, pw):
    assert PM.supports_inputs(w, pw) == RM.supports_inputs(w, pw)


def test_forest_declines_near_tied_weights_like_reference():
    out = {"sw": np.array([1.0, 1.0 + 1e-12, 2.0]), "ra": np.array([0, 0, 0]),
           "rb": np.array([1, 2, 3])}
    assert RM.assemble_merge_forest(4, out) is None
    assert PM.assemble_merge_forest(4, out) is None


@pytest.mark.parametrize("mst_backend,expect", [("auto", "device"), ("device", "device"),
                                               ("host", "host")])
def test_resolve_mst_backend_runs_device_at_any_n(mst_backend, expect):
    from hdbscan_tpu_torch.config import HDBSCANParams

    assert PM.resolve_mst_backend(HDBSCANParams(mst_backend=mst_backend), 10) == expect


def test_round_cap_raises_while_still_merging():
    stat_comp = np.array([8, 4, 2])
    stat_edges = np.array([4, 2, 1])
    with pytest.raises(RuntimeError, match="round cap"):
        PM.assert_rounds_converged(3, 7, 16, max_rounds=3, stat_comp=stat_comp,
                                   stat_edges=stat_edges)
    with pytest.raises(RuntimeError, match="round cap"):
        RM.assert_rounds_converged(3, 7, 16, max_rounds=3, stat_comp=stat_comp,
                                   stat_edges=stat_edges)
    PM.assert_rounds_converged(2, 7, 16, max_rounds=3)  # under the cap
    PM.assert_rounds_converged(3, 7, 16, max_rounds=3, stat_comp=stat_comp,
                               stat_edges=np.array([4, 2, 0]))  # saturated


def _host_forests(seed):
    from hdbscan_tpu.core import tree as RT
    from hdbscan_tpu_torch.core import tree as PT

    rng = np.random.default_rng(seed)
    n = 80
    u = rng.integers(0, n, 200)
    v = rng.integers(0, n, 200)
    w = np.round(rng.random(200), 2) + np.where(rng.random(200) < 0.2, 1e-12, 0.0)
    return PT.build_merge_forest(n, u, v, w), RT.build_merge_forest(n, u, v, w)


@pytest.mark.parametrize("seed", range(3))
def test_host_merge_forest_matches_reference(seed):
    """The host builder the finalize tail falls back to (the port's copy of
    ``core/tree.py`` with its own native C library) equals the reference's,
    near-tied weights included (the case the device forest declines)."""
    _forest_equal(*_host_forests(seed))


@pytest.mark.parametrize("seed", range(3))
def test_host_merge_forest_python_path_matches_reference(seed, monkeypatch):
    """Without a C compiler the host builder runs its pure-Python loop,
    which equals the reference's pure-Python forest."""
    import hdbscan_tpu.native as ref_native
    import hdbscan_tpu_torch.native as native

    monkeypatch.setattr(native, "merge_forest_lib", lambda: None)
    monkeypatch.setattr(ref_native, "merge_forest_lib", lambda: None)
    _forest_equal(*_host_forests(seed))


@pytest.mark.parametrize("seed", range(4))
def test_contract_min_edges_matches_reference(seed):
    """The port's copy of the host union-find contraction (``utils/unionfind``)
    emits the reference's edges and labels, weight ties included."""
    from hdbscan_tpu.utils import unionfind as RU
    from hdbscan_tpu_torch.utils import unionfind as PU

    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 300))
    comp = rng.integers(0, max(n // 3, 1), n).astype(np.int64)
    cand_j = np.where(rng.random(n) < 0.9, rng.integers(0, n, n), -1).astype(np.int64)
    cand_w = rng.integers(0, 5, n).astype(np.float64)
    for got, want in zip(PU.contract_min_edges(comp, cand_j, cand_w),
                         RU.contract_min_edges(comp, cand_j, cand_w)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    parent = np.minimum(np.arange(n), rng.integers(0, n, n)).astype(np.int64)
    np.testing.assert_array_equal(PU.flatten_parents(parent.copy()),
                                  RU.flatten_parents(parent.copy()))
    assert PU.find(parent.copy(), n - 1) == RU.find(parent.copy(), n - 1)
