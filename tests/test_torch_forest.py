"""The four rp-forest kernels' plain versions (which the CUDA kernels
reproduce bitwise on the card) against the reference's Pallas kernels in
interpret mode, or against the XLA chain they equal bitwise, on the same
numpy-seeded inputs and the same forest.

Tolerances: integer grids are bitwise — distances, ids, order. Continuous
data: distances within 2 ulp of float32 (rtol 2.5e-7; XLA's fused CPU
``sqrt`` is not correctly rounded, the port's is) and ids equal on at
least 99% of entries (a last-bit shift can swap two near-tied neighbors).
bf16 is held by the reference's recall gate only (the port centres its
bf16 operands on its own centres).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdbscan_tpu.ops import lexmerge as ref_lex
from hdbscan_tpu.ops import pallas_forest as pf
from hdbscan_tpu.ops import rpforest as rpf
from hdbscan_tpu_torch.core.distances import euclidean_form, pairwise_distance
from hdbscan_tpu_torch.ops import cuda_forest as cf
from hdbscan_tpu_torch.ops import lexmerge as port_lex
from hdbscan_tpu_torch.ops import rpforest as port_rpf
from tests.conftest import make_blobs


def _port_forest(ref_forest):
    return port_rpf.forest_from_numpy(**dataclasses.asdict(ref_forest))


def _data(rng, n, d, centers, integer):
    x, _ = make_blobs(rng, n=n, d=d, centers=centers)
    return (np.round(x * 8.0) if integer else x).astype(np.float32)


def _assert_lists(got_d, got_i, ref_d, ref_i, integer):
    got_d, got_i = np.asarray(got_d), np.asarray(got_i)
    ref_d, ref_i = np.asarray(ref_d), np.asarray(ref_i)
    if integer:
        np.testing.assert_array_equal(got_d, ref_d)
        np.testing.assert_array_equal(got_i, ref_i)
    else:
        np.testing.assert_allclose(got_d, ref_d, rtol=2.5e-7, atol=0)
        assert np.mean(got_i == ref_i) >= 0.99


def _leaf_cases():
    rng = np.random.default_rng(0)
    base = np.round(make_blobs(rng, n=30, d=3, centers=3)[0] * 8.0)
    return {
        "blobs": (lambda integer: _data(np.random.default_rng(1), 220, 5, 4, integer), 3, 32, 5),
        "duplicates": (lambda integer: np.repeat(base, 6, axis=0).astype(np.float32), 2, 24, 6),
        "all_equal": (
            lambda integer: np.random.default_rng(2).integers(0, 2, size=(160, 4)).astype(np.float32),
            2, 16, 4,
        ),
        "uneven_leaves": (lambda integer: _data(np.random.default_rng(3), 137, 3, 3, integer), 2, 20, 4),
        "k_is_leaf_occupancy": (lambda integer: _data(np.random.default_rng(4), 64, 3, 2, integer), 2, 8, None),
    }


@pytest.mark.parametrize("integer", [True, False], ids=["grid", "continuous"])
@pytest.mark.parametrize("case", list(_leaf_cases()))
def test_leaf_topk_matches_pallas(case, integer):
    """B5's plain version == ``forest_leaf_topk`` (interpret) == the unfused
    ``_leaf_scan`` on every leaf of every tree."""
    make, trees, leaf, kk = _leaf_cases()[case]
    data = make(integer)
    integer = integer or case in ("duplicates", "all_equal")
    forest = rpf.build_forest(data, trees=trees, leaf_size=leaf, seed=0)
    n, lmax = forest.n, forest.max_leaf
    kk = lmax if kk is None else min(kk, lmax)
    form = pf.euclid_form(lmax, lmax, forest.d)
    mask = forest.leaf_mask
    for t in range(trees):
        ref_d, ref_i = pf.forest_leaf_topk(
            jnp.asarray(data), jnp.asarray(forest.members[t]), jnp.asarray(mask), kk,
            form=form, sentinel=n, interpret=True,
        )
        got_d, got_i = cf.forest_leaf_topk(
            torch.as_tensor(data), torch.as_tensor(forest.members[t]), torch.as_tensor(mask),
            kk, "euclidean", form, "f32", n,
        )
        _assert_lists(got_d, got_i, ref_d, ref_i, integer)


@pytest.mark.parametrize("metric", ["euclidean", "manhattan", "supremum"])
def test_leaf_topk_k128_matches_xla_chain(metric):
    """k = 128 (the kernels' widest list) against the XLA chain the Pallas
    kernel equals bitwise, on an integer grid, every fused metric the
    card runs."""
    data = np.random.default_rng(5).integers(0, 12, size=(600, 3)).astype(np.float32)
    forest = rpf.build_forest(data, trees=1, leaf_size=300, seed=0)
    n, lmax = forest.n, forest.max_leaf
    ref = rpf._leaf_scan(jnp.asarray(data), jnp.asarray(forest.members[0]),
                         jnp.asarray(forest.leaf_mask), 128, metric, n)
    got = cf.forest_leaf_topk(
        torch.as_tensor(data), torch.as_tensor(forest.members[0]),
        torch.as_tensor(forest.leaf_mask), 128, metric,
        euclidean_form(lmax, lmax, 3) if metric == "euclidean" else None, "f32", n,
    )
    _assert_lists(*got, *ref, integer=True)


def _tree_stacks(data, forest, kk):
    """Per-tree (T, n, kk) lists from the reference's leaf scan."""
    n = forest.n
    sd = np.full((forest.trees, n, kk), np.inf, np.float32)
    si = np.full((forest.trees, n, kk), n, np.int32)
    for t in range(forest.trees):
        nd, ni = rpf._leaf_scan(jnp.asarray(data), jnp.asarray(forest.members[t]),
                                jnp.asarray(forest.leaf_mask), kk, "euclidean", n)
        flat = forest.members[t].reshape(-1)
        sd[t, flat] = np.asarray(nd).reshape(-1, kk)
        si[t, flat] = np.asarray(ni).reshape(-1, kk)
    return sd, si


@pytest.mark.parametrize("kk", [1, 6, None])
def test_merge_matches_pallas(kk):
    """B6's plain version == ``forest_merge_pallas`` (interpret) == the
    dedup lex merge of the concatenated lists."""
    data = _data(np.random.default_rng(6), 300, 4, 4, True)
    forest = rpf.build_forest(data, trees=3, leaf_size=32, seed=1)
    kk = forest.max_leaf if kk is None else kk
    sd, si = _tree_stacks(data, forest, kk)
    n = forest.n
    ref = pf.forest_merge_pallas(jnp.asarray(sd), jnp.asarray(si), kk, n, interpret=True)
    got = cf.forest_merge(torch.as_tensor(sd), torch.as_tensor(si), kk, n)
    _assert_lists(*got, *ref, integer=True)
    cat = port_lex.dedup_lex_merge(torch.as_tensor(np.concatenate(sd, 1)),
                                   torch.as_tensor(np.concatenate(si, 1)), kk, n)
    _assert_lists(*got, *cat, integer=True)


@pytest.mark.parametrize("integer", [True, False], ids=["grid", "continuous"])
def test_forest_knn_fused_matches_reference(integer):
    """B5 + B6 (plain versions) == the reference's unfused engine on one
    forest."""
    data = _data(np.random.default_rng(7), 300, 4, 4, integer)
    forest = rpf.build_forest(data, trees=3, leaf_size=32, seed=1)
    ref = rpf.forest_knn(jnp.asarray(data), forest, 6, "euclidean")
    got = port_rpf.forest_knn(torch.as_tensor(data), _port_forest(forest), 6, "euclidean",
                              backend="fused")
    _assert_lists(*got, *ref, integer=integer)


@pytest.mark.parametrize("integer", [True, False], ids=["grid", "continuous"])
def test_rescan_round_fused_matches_reference(integer):
    """One rescan round through B7 (plain) == the reference's unfused and
    fused rounds."""
    data = _data(np.random.default_rng(8), 280, 4, 4, integer)
    forest = rpf.build_forest(data, trees=2, leaf_size=32, seed=2)
    dd = jnp.asarray(data)
    best_d, best_i = rpf.forest_knn(dd, forest, 5, "euclidean")
    ref = rpf.rescan_round(dd, best_d, best_i, 5, "euclidean", 0, 1, sentinel=len(data))
    got = port_rpf.rescan_round(
        torch.as_tensor(data), torch.as_tensor(np.asarray(best_d)),
        torch.as_tensor(np.asarray(best_i)), 5, "euclidean", 0, 1, sentinel=len(data),
        backend="fused",
    )
    _assert_lists(*got, *ref, integer=integer)


def _panel(rng, data, rows, c):
    n = len(data)
    cand = rng.integers(0, n, size=(rows, c)).astype(np.int32)
    cand[:, -3:] = n  # sentinel slots
    cand[:, 5] = cand[:, 4]  # duplicate ids
    return cand


@pytest.mark.parametrize("integer", [True, False], ids=["grid", "continuous"])
def test_rescan_topk_matches_pallas(integer):
    """B7's plain version == ``forest_rescan_topk`` (interpret) on a panel
    with sentinel and duplicate candidates."""
    rng = np.random.default_rng(9)
    data = _data(rng, 200, 4, 3, integer)
    n, k = len(data), 5
    cand = _panel(rng, data, 24, k * k)
    dd = jnp.asarray(data)
    cpts = dd[jnp.clip(jnp.asarray(cand), 0, n - 1)]
    ref = pf.forest_rescan_topk(dd[:24], cpts, jnp.asarray(cand), k, "euclidean", "f32", n,
                                interpret=True)
    got = cf.forest_rescan_topk(torch.as_tensor(data[:24]), torch.as_tensor(data),
                                torch.as_tensor(cand), k, "euclidean", "f32", n)
    _assert_lists(*got, *ref, integer=integer)


def _copied_panel(rng, n, rows, c, cuts):
    """Random ids of ``n`` points with id 3 copied on both sides of every
    cut position, every 7th slot, and two sentinel slots a row."""
    cand = rng.integers(0, n, size=(rows, c)).astype(np.int32)
    for cut in cuts:
        cand[:, cut - 1: cut + 1] = 3
    cand[:, ::7] = 3
    cand[:, -2:] = n
    return cand


@pytest.mark.parametrize("k", [1, 7, 16, 17, 33])
def test_rescan_topk_grid_ties_and_copies_match_pallas(k):
    """B7's plain version == ``forest_rescan_topk`` (interpret), bitwise, on
    a 0..2 integer grid (exact ties at the k-th slot, the lower id first)
    with one id copied across the positions where a span would cut."""
    rng = np.random.default_rng(20 + k)
    data = rng.integers(0, 3, size=(150, 3)).astype(np.float32)
    n, rows, c = len(data), 12, max(k * k, 64)
    cand = _copied_panel(rng, n, rows, c, range(c // 4, c, c // 4))
    dd = jnp.asarray(data)
    cpts = dd[jnp.clip(jnp.asarray(cand), 0, n - 1)]
    ref = pf.forest_rescan_topk(dd[:rows], cpts, jnp.asarray(cand), k, "euclidean", "f32", n,
                                interpret=True)
    got = cf.forest_rescan_topk(torch.as_tensor(data[:rows]), torch.as_tensor(data),
                                torch.as_tensor(cand), k, "euclidean", "f32", n)
    _assert_lists(*got, *ref, integer=True)
    ids = got[1].numpy()
    assert all(len(set(r[r != n])) == np.count_nonzero(r != n) for r in ids)


@pytest.mark.parametrize("partition", ["spans", "shuffled"])
@pytest.mark.parametrize("parts", [2, 3, 7])
def test_rescan_topk_partition_merge_equals_whole(parts, partition):
    """The invariant B7's span merge relies on: the plain version over any
    partition of each row's candidates, the parts' lists merged with
    ``lexmerge.dedup_lex_merge``, equals the plain version over the whole
    row, bitwise (copies of one id in several parts count once)."""
    rng = np.random.default_rng(30 + parts)
    data = torch.as_tensor(rng.integers(0, 3, size=(120, 3)).astype(np.float32))
    n, rows, c, k = len(data), 10, 200, 9
    span = -(-c // parts)
    cand = torch.as_tensor(_copied_panel(rng, n, rows, c, range(span, c, span)))
    q = data[:rows]
    whole = cf.forest_rescan_topk_plain(q, data, cand, k, "euclidean", "f32", n)
    order = np.arange(c) if partition == "spans" else rng.permutation(c)
    lists = [cf.forest_rescan_topk_plain(q, data, cand[:, order[a:a + span]].contiguous(), k,
                                         "euclidean", "f32", n) for a in range(0, c, span)]
    merged = port_lex.dedup_lex_merge(torch.cat([d for d, _ in lists], 1),
                                      torch.cat([i for _, i in lists], 1), k, n)
    assert torch.equal(merged[0], whole[0]) and torch.equal(merged[1], whole[1])


@pytest.mark.parametrize("integer", [True, False], ids=["grid", "continuous"])
def test_min_outgoing_matches_pallas(integer):
    """B8's plain version == ``forest_min_outgoing`` (interpret) and its XLA
    oracle, including a row with no outgoing candidate (+inf, -1)."""
    rng = np.random.default_rng(10)
    data = _data(rng, 90, 4, 3, integer)
    n, c = len(data), 12
    cand = rng.integers(0, n, size=(n, c)).astype(np.int32)
    cand[:5, -2:] = n
    core = rng.integers(0, 6, size=n).astype(np.float32)
    comp = rng.integers(0, 4, size=n).astype(np.int32)
    comp[7] = 99
    cand[7] = 7
    dd, cids = jnp.asarray(data), jnp.asarray(cand)
    clip = jnp.clip(cids, 0, n - 1)
    args = (dd, dd[clip], cids, jnp.asarray(core), jnp.asarray(core)[clip], jnp.asarray(comp),
            jnp.where(cids == n, -1, jnp.asarray(comp)[clip]))
    ref = pf.forest_min_outgoing(*args, sentinel=n, interpret=True)
    oracle = pf.forest_min_outgoing_xla(*args, sentinel=n)
    t = torch.as_tensor
    got = cf.forest_min_outgoing(t(data), t(data), t(cand), t(core), t(core), t(comp), t(comp),
                                 "euclidean", n)
    for r in (ref, oracle):
        if integer:
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(r[0]))
        else:
            np.testing.assert_allclose(got[0].numpy(), np.asarray(r[0]), rtol=2.5e-7, atol=0)
        assert np.mean(got[1].numpy() == np.asarray(r[1])) >= (1.0 if integer else 0.99)
    assert got[1][7] == -1 and torch.isinf(got[0][7])


def test_lexmerge_helpers_match_reference():
    """The port's lexmerge contract helpers == the reference's on rows with
    duplicate ids, ties, sentinels and infinities."""
    rng = np.random.default_rng(11)
    r, c, k, sentinel = 40, 24, 7, 50
    dist = rng.integers(0, 6, size=(r, c)).astype(np.float32)
    ids = rng.integers(0, 30, size=(r, c)).astype(np.int32)
    dist[:, -4:] = np.inf
    ids[:, -4:] = sentinel
    base = {}
    for row_i in range(r):  # one distance per id, as real panels have
        for j in range(c):
            dist[row_i, j] = base.setdefault((row_i, int(ids[row_i, j])), dist[row_i, j])
    t, j = torch.as_tensor, jnp.asarray
    _assert_lists(*port_lex.dedup_lex_merge(t(dist), t(ids), k, sentinel),
                  *ref_lex.dedup_lex_merge(j(dist), j(ids), k, sentinel), integer=True)
    _assert_lists(*port_lex.topk_tile_candidates(t(dist), t(ids), k),
                  *ref_lex.topk_tile_candidates(j(dist), j(ids), k), integer=True)
    bd, bi = port_lex.dedup_lex_merge(t(dist[:, :8]), t(ids[:, :8]), k, sentinel)
    _assert_lists(*port_lex.merge_tile_candidates(bd, bi, t(dist[:, 8:]), t(ids[:, 8:]), k),
                  *ref_lex.merge_tile_candidates(j(bd.numpy()), j(bi.numpy()), j(dist[:, 8:]),
                                                 j(ids[:, 8:]), k), integer=True)


def test_bf16_recall_gate():
    """The reference's tier-1 bf16 gate on the port: the over-provisioned
    bf16 chain plus the float32 refine keeps recall@k >= 0.95."""
    rng = np.random.default_rng(0)
    data = make_blobs(rng, n=1200, d=8, centers=8, spread=0.3)[0].astype(np.float32)
    k = 8
    _, _, idx = port_rpf.rpforest_core_distances(
        data, min_pts=k, k=k, trees=3, leaf_size=128, rescan_rounds=1, knn_backend="fused",
        knn_precision="bf16", return_indices=True, device="cpu",
    )
    x = torch.as_tensor(data)
    dm = pairwise_distance(x, x, "euclidean", "dot").numpy()
    truth = np.argsort(dm, axis=1, kind="stable")[:, :k]
    hits = np.mean([len(set(idx[i]) & set(truth[i])) / k for i in range(len(data))])
    assert hits >= 0.95, f"bf16 recall@{k} = {hits:.4f} < 0.95"


def test_bf16_tiles_center_on_the_ports_centres():
    """The port's bf16 centres: the mean of a leaf's real members, and the
    mean of a query row's tile of 8 rows; bf16 leaf lists mostly pick the
    float32 lists' neighbors."""
    data = np.random.default_rng(12).integers(0, 16, size=(96, 3)).astype(np.float32)
    x = torch.as_tensor(data)
    members = torch.arange(96, dtype=torch.int32).reshape(2, 48)
    mask = torch.ones((2, 48), dtype=torch.bool)
    mask[1, -3:] = False
    mu = cf.leaf_centres(x[members.long()], mask)
    np.testing.assert_allclose(mu[1].numpy(), data[48:93].mean(0), rtol=1e-6)
    b16 = cf.forest_leaf_topk(x, members, mask, 6, "euclidean", "diff", "bf16", 96)
    f32 = cf.forest_leaf_topk(x, members, mask, 6, "euclidean", "diff", "f32", 96)
    overlap = np.mean([len(set(a) & set(b)) / 6 for a, b in
                       zip(b16[1].reshape(-1, 6).tolist(), f32[1].reshape(-1, 6).tolist())])
    assert overlap >= 0.8
    q = cf.row_tile_centres(x[:11])
    np.testing.assert_allclose(q[9].numpy(), data[8:11].mean(0), rtol=1e-6)


def test_eligibility_and_card_limits():
    ok = dict(n=1000, d=8, k=16, metric="euclidean", dtype=np.float32)
    assert cf.fused_forest_eligible(**ok)
    for bad in ({"metric": "pearson"}, {"k": 129}, {"d": 200}, {"dtype": np.float64}):
        assert not cf.fused_forest_eligible(**{**ok, **bad})
    cf.check_card_shape(8, 128, "manhattan", np.float32)
    # Cosine and pearson (centred rows) run the kernels in f32; bf16 tiles
    # stay euclidean only, as in the reference.
    for metric in ("cosine", "pearson"):
        cf.check_card_shape(8, 16, metric, np.float32)
        with pytest.raises(ValueError, match="bf16 distance tiles support euclidean only"):
            cf.check_card_shape(8, 16, metric, np.float32, "bf16")
    # Past the fused gate the kernels run their wide mode: the card takes
    # every k and d, but bf16 tiles stay within the gate.
    for d, k in ((8, 129), (129, 8), (200, 200)):
        cf.check_card_shape(d, k, "euclidean", np.float32)
        with pytest.raises(ValueError, match="bf16 tiles need k and d <= 128"):
            cf._check_bf16_width("forest_leaf_topk", k, d)
    with pytest.raises(ValueError, match="k >= 1"):
        cf.check_card_shape(8, 0, "euclidean", np.float32)
    with pytest.raises(ValueError, match="float32"):
        cf.check_card_shape(8, 16, "euclidean", np.float64)


@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
@pytest.mark.parametrize("d,kk", [(3, 129), (129, 15), (200, 200)])
def test_leaf_topk_wide_matches_xla_chain(d, kk, metric):
    """Past 128 (the wide kernels' shapes) B5's plain version against the
    XLA chain the reference's unfused route runs, on an integer grid."""
    data = np.random.default_rng(d + kk).integers(0, 4, size=(2 * kk + 60, d)).astype(np.float32)
    forest = rpf.build_forest(data, trees=1, leaf_size=2 * kk + 2, seed=0)
    n, lmax = forest.n, forest.max_leaf
    kk = min(kk, lmax)
    ref = rpf._leaf_scan(jnp.asarray(data), jnp.asarray(forest.members[0]),
                         jnp.asarray(forest.leaf_mask), kk, metric, n)
    got = cf.forest_leaf_topk(
        torch.as_tensor(data), torch.as_tensor(forest.members[0]),
        torch.as_tensor(forest.leaf_mask), kk, metric,
        euclidean_form(lmax, lmax, d) if metric == "euclidean" else None, "f32", n,
    )
    _assert_lists(*got, *ref, integer=True)


def test_ineligible_fused_runs_the_unfused_route():
    """knn_backend='fused' with pearson runs the unfused route off the card,
    as the reference does: the same result as knn_backend='auto'."""
    data = _data(np.random.default_rng(13), 180, 3, 3, False)
    kw = dict(min_pts=5, trees=2, leaf_size=32, rescan_rounds=0, metric="pearson", seed=0,
              device="cpu", return_indices=True)
    got = port_rpf.rpforest_core_distances(data, knn_backend="fused", **kw)
    unfused = port_rpf.rpforest_core_distances(data, knn_backend="auto", **kw)
    for a, b in zip(got, unfused):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="euclidean"):
        port_rpf.rpforest_core_distances(data, 4, "manhattan", knn_backend="fused",
                                         knn_precision="bf16", device="cpu")


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    meta = lambda *s, **kw: torch.zeros(*s, device="meta", **kw)  # noqa: E731
    i32 = dict(dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cf.forest_leaf_topk(meta(8, 3), meta(2, 4, **i32), meta(2, 4, dtype=torch.bool), 2)
    with pytest.raises(ValueError, match="CUDA"):
        cf.forest_merge(meta(2, 8, 3), meta(2, 8, 3, **i32), 3, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cf.forest_rescan_topk(meta(4, 3), meta(8, 3), meta(4, 9, **i32), 3, sentinel=8)
    with pytest.raises(ValueError, match="CUDA"):
        cf.forest_min_outgoing(meta(4, 3), meta(8, 3), meta(4, 9, **i32), meta(4), meta(8),
                               meta(4, **i32), meta(8, **i32), sentinel=8)
