"""Cosine and pearson in the port (the kernels' metric code 6; pearson as
cosine over rows centred once) against the reference, and the repairs of
float64 fits (F4) and zero-norm rows (F5).

Inputs come from a seed through numpy. The reference runs under x64 (the
suite's ``tests/conftest.py``), its Pallas kernels in interpret mode or
through their XLA oracles; pearson is held to the XLA route (the
reference's Pallas B1 zero-pads features to 128 lanes, which moves
pearson's row means; ROADMAP C note 8).

Tolerances. The port sums the cross term feature by feature, the
reference in XLA's dot; the two differ by rounding only: float32 values
within 1e-6 absolute (a few ulp of 1.0), float64 within 1e-12, and ids
equal on at least 99% of entries in float32 (a last-bit shift can swap two
near-tied neighbours) and on all of them in float64. Fits: labels and
condensed-tree fields exact, core distances and MST weights within 1e-10
(float64) or 1e-6 (float32 scans). Zero-norm rows: the NaN / +inf pattern,
the ids and the labels exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.core import distances as ref_dist
from hdbscan_tpu.models import exact as ref_exact
from hdbscan_tpu.models import mr_hdbscan as ref_mr
from hdbscan_tpu.ops import pallas_forest as pf
from hdbscan_tpu.ops import rpforest as rpf
from hdbscan_tpu.ops import tiled as ref_tiled
from hdbscan_tpu.ops.pallas_segmin import min_outgoing_xla_reference
from hdbscan_tpu_torch.config import HDBSCANParams as PortParams
from hdbscan_tpu_torch.core import distances as port_dist
from hdbscan_tpu_torch.models import exact as port_exact
from hdbscan_tpu_torch.models import mr_hdbscan as port_mr
from hdbscan_tpu_torch.ops import cuda_forest as cf
from hdbscan_tpu_torch.ops import cuda_knn, cuda_segmin
from hdbscan_tpu_torch.ops import tiled as port_tiled
from hdbscan_tpu_torch.parallel.mesh import get_mesh
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


METRICS = ("cosine", "pearson")
_TREE_FIELDS = ("parent", "birth", "death", "stability", "num_members", "selected")


def _blobs(seed, per, d=3, zero_row=None):
    """Four normal blobs off the origin; row ``zero_row`` set to 0 (a zero
    row at cosine, a constant row at pearson)."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(4, d)) * 5.0
    x = np.concatenate([c + rng.normal(size=(per, d)) for c in centres])
    if zero_row is not None:
        x[zero_row] = 0.0
    return x


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# The metric


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pairwise_matches_reference(metric, dtype):
    """The port's in-order cosine and centred pearson against the
    reference's ``pairwise_distance``, NaN where a row has zero norm."""
    x = _blobs(0, 60, d=5, zero_row=7).astype(dtype)
    y = _blobs(1, 40, d=5).astype(dtype)
    y[3] = 1.5  # a constant row: pearson's zero norm
    got = port_dist.pairwise_distance(_t(x), _t(y), metric).numpy()
    ref = np.asarray(ref_dist.pairwise_distance(jnp.asarray(x), jnp.asarray(y), metric))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[7]).all()
    tol = 1e-6 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def test_cosine_repeats_the_kernel_arithmetic():
    """The plain cosine is the kernels' code 6 step by step: the cross term
    and the squared norms summed in ascending feature order with separate
    multiplies and adds, correctly rounded roots, an IEEE division; pearson
    centres each row by its in-order sum over d."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(30, 6)).astype(np.float32)
    y = rng.normal(size=(20, 6)).astype(np.float32)
    f32 = np.float32
    cross = x[:, None, 0] * y[None, :, 0]
    xs, ys = x[:, 0] * x[:, 0], y[:, 0] * y[:, 0]
    for f in range(1, 6):
        cross = (cross + x[:, None, f] * y[None, :, f]).astype(f32)
        xs = (xs + x[:, f] * x[:, f]).astype(f32)
        ys = (ys + y[:, f] * y[:, f]).astype(f32)
    nx = np.sqrt(xs.astype(np.float64)).astype(f32)
    ny = np.sqrt(ys.astype(np.float64)).astype(f32)
    want = (f32(1.0) - cross / (nx[:, None] * ny[None, :])).astype(f32)
    got = port_dist.pairwise_distance(_t(x), _t(y), "cosine").numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    acc = x[:, 0].copy()
    for f in range(1, 6):
        acc = (acc + x[:, f]).astype(f32)
    centred = x - (acc / f32(6))[:, None]
    np.testing.assert_array_equal(port_dist.centre_rows(_t(x)).numpy(), centred)
    z = port_dist.zero_rows(_t(np.concatenate([x, np.zeros((1, 6), f32)])), "cosine")
    assert z.tolist() == [False] * 30 + [True]


# ---------------------------------------------------------------------------
# Kernels' plain versions


def _segmin_inputs(seed, n, metric, zero_rows=()):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    x[list(zero_rows)] = 0.0
    core = (rng.random(n) * 0.2).astype(np.float32)
    comp = rng.integers(0, 9, size=n).astype(np.int32)
    valid = np.ones(n, bool)
    valid[::41] = False
    return x, core, comp, valid


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("zero", [(), (3,), (3, 200, 201)], ids=["none", "one", "three"])
def test_segmin_matches_xla_reference(metric, zero):
    """B1's plain version against ``min_outgoing_xla_reference`` with
    128-column tiles, zero-norm rows in one and in two tiles: the tile rule
    (a row takes nothing from a tile where one outgoing weight is NaN)."""
    x, core, comp, valid = _segmin_inputs(3, 384, metric, zero)
    got = cuda_segmin.min_outgoing_all_rows(_t(x), _t(core), _t(comp), _t(valid), metric,
                                            64, 128)
    ref = min_outgoing_xla_reference(x, core, comp, valid, metric, 64, 128)
    ref_w, ref_j = np.asarray(ref[0]), np.asarray(ref[1])
    gw, gj = got[0].numpy(), got[1].numpy()
    np.testing.assert_array_equal(np.isinf(gw), np.isinf(ref_w))
    np.testing.assert_allclose(gw, ref_w, rtol=0, atol=1e-6)
    assert np.mean(gj == ref_j) >= 0.99
    if zero:
        assert np.isinf(gw[list(zero)]).all() and (gj[list(zero)] == -1).all()


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("zero", [(), (130,)], ids=["none", "zero-norm column"])
def test_segmin_panel_matches_xla_reference(metric, zero):
    """B9's plain version: one shard's rows (all of one component) against
    a visiting panel at global offset 128, against the rows of
    ``min_outgoing_xla_reference``'s square scan, where the shard's own
    columns are not outgoing (same component) and the panel's are."""
    x, core, comp, valid = _segmin_inputs(4, 256, metric, zero)
    r = 128
    comp[:r] = 50  # no panel column carries it
    args = (x[:r], core[:r], comp[:r], valid[:r], x[r:], core[r:], comp[r:], valid[r:])
    got = cuda_segmin.min_outgoing_panel(*map(_t, args), metric, 64, 128, col_offset=r)
    ref = min_outgoing_xla_reference(x, core, comp, valid, metric, 64, 128)
    ref_w, ref_j = np.asarray(ref[0])[:r], np.asarray(ref[1])[:r]
    ref_j = np.where(ref_j >= 0, ref_j - r, -1)
    gw, gj = got[0].numpy(), got[1].numpy()
    np.testing.assert_array_equal(np.isinf(gw), np.isinf(ref_w))
    np.testing.assert_allclose(gw, ref_w, rtol=0, atol=1e-6)
    assert np.mean(gj == ref_j) >= 0.99
    if zero:  # the zero-norm column's tile gives no row anything
        assert np.isinf(gw).all()


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("zero", [None, 5, 300], ids=["none", "zero-norm row", "zero-norm row 2"])
def test_kbest_matches_xla_scan(metric, zero):
    """K2's plain version (through ``knn_core_distances``, float64) against
    the reference's guarded XLA scan at 256-column tiles: distances, ids
    and the reference's rule for a zero-norm column (in its tile it takes
    one of the k slots, then drops out), so the other rows' k-th entry can
    come from another tile and the zero-norm row's list stays empty."""
    x = _blobs(5, 150, d=4, zero_row=zero)
    kw = dict(dtype=np.float64, return_indices=True, row_tile=64, col_tile=256)
    rc, rk, ri = ref_tiled.knn_core_distances(x, 8, metric, backend="xla", **kw)
    pc, pk, pi = port_tiled.knn_core_distances(x, 8, metric, device="cpu", **kw)
    for got, ref in ((pc, rc), (pk, rk)):
        np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(pi, ri)
    if zero is not None:
        assert np.isinf(pk[zero]).all() and (pi[zero] == -1).all()


@pytest.mark.parametrize("metric", METRICS)
def test_kbest_panel_matches_xla_scan(metric):
    """The rectangular B2's plain version: 64 query rows against a
    512-column panel holding a zero-norm row, against the reference's
    ``_knn_core_scan`` over the same panel (128-column tiles)."""
    x = _blobs(6, 150, d=4)
    x[64 + 10] = 0.0
    q, panel, k = x[:64], x[64:576], 15
    ref_d, ref_i = ref_tiled._knn_core_scan(jnp.asarray(q), jnp.asarray(panel),
                                            jnp.ones(512, bool), k, metric, 64, 128,
                                            with_indices=True)
    got_d, got_i = cuda_knn.knn_kbest_panel(_t(q), _t(panel), k, metric, None, 0, col_tile=128)
    ref_d, ref_i = np.asarray(ref_d), np.asarray(ref_i)
    np.testing.assert_array_equal(np.isinf(got_d.numpy()), np.isinf(ref_d))
    np.testing.assert_allclose(got_d.numpy(), ref_d, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got_i.numpy(), ref_i)


def _lists_close(got, ref):
    gd, gi = (np.asarray(a) for a in got)
    rd, ri = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(rd))
    np.testing.assert_allclose(gd, rd, rtol=0, atol=1e-6)
    assert np.mean(gi == ri) >= 0.99


def _forest_case(seed=11, n=400, d=4):
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(n, d)) + rng.integers(-3, 4, size=(n, 1))).astype(np.float32)
    return data, rpf.build_forest(data, trees=2, leaf_size=48, seed=0)


@pytest.mark.parametrize("kk", [1, 7])
def test_leaf_topk_cosine_matches_pallas(kk):
    """B5's plain version at cosine == ``forest_leaf_topk`` (interpret)."""
    data, forest = _forest_case()
    for t in range(forest.trees):
        ref = pf.forest_leaf_topk(jnp.asarray(data), jnp.asarray(forest.members[t]),
                                  jnp.asarray(forest.leaf_mask), kk, "cosine",
                                  sentinel=forest.n, interpret=True)
        got = cf.forest_leaf_topk(_t(data), _t(forest.members[t]), _t(forest.leaf_mask), kk,
                                  "cosine", None, "f32", forest.n)
        _lists_close(got, ref)


def test_rescan_and_min_outgoing_cosine_match_pallas():
    """B7's and B8's plain versions at cosine == ``forest_rescan_topk`` and
    ``forest_min_outgoing`` (interpret) and B8's XLA oracle, on one panel of
    neighbour-of-neighbour candidates with sentinel slots."""
    data, forest = _forest_case(12)
    n, k = forest.n, 5
    rng = np.random.default_rng(13)
    cand = rng.integers(0, n, size=(40, k * k)).astype(np.int32)
    cand[:, -3:] = n
    dd = jnp.asarray(data)
    cpts = dd[jnp.clip(jnp.asarray(cand), 0, n - 1)]
    ref = pf.forest_rescan_topk(dd[:40], cpts, jnp.asarray(cand), k, "cosine", "f32", n,
                                interpret=True)
    got = cf.forest_rescan_topk(_t(data[:40]), _t(data), _t(cand), k, "cosine", "f32", n)
    _lists_close(got, ref)
    core = (rng.random(n) * 0.05).astype(np.float32)
    comp = rng.integers(0, 5, size=n).astype(np.int32)
    clip = jnp.clip(jnp.asarray(cand), 0, n - 1)
    args = (dd[:40], cpts, jnp.asarray(cand), jnp.asarray(core[:40]), jnp.asarray(core)[clip],
            jnp.asarray(comp[:40]), jnp.where(jnp.asarray(cand) == n, -1, jnp.asarray(comp)[clip]))
    got = cf.forest_min_outgoing(_t(data[:40]), _t(data), _t(cand), _t(core[:40]), _t(core),
                                 _t(comp[:40]), _t(comp), "cosine", n)
    for ref in (pf.forest_min_outgoing(*args, metric="cosine", sentinel=n, interpret=True),
                pf.forest_min_outgoing_xla(*args, metric="cosine", sentinel=n)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=1e-6)
        assert np.mean(got[1].numpy() == np.asarray(ref[1])) >= 0.99


def test_forest_kernels_nan_rules():
    """The plain versions' NaN rules the kernels repeat: B5 never lists a
    zero-norm column (its own slot lists nothing), B7 empties a row with a
    NaN candidate, B8 gives it the weight NaN at its first NaN candidate."""
    data, forest = _forest_case(14)
    data[3] = 0.0
    n = forest.n
    nd, ni = cf.forest_leaf_topk(_t(data), _t(forest.members[0]), _t(forest.leaf_mask), 5,
                                 "cosine", None, "f32", n)
    assert not torch.isnan(nd).any() and not (ni == 3).any()
    slot = np.argwhere(forest.members[0] == 3)[0]
    assert torch.isinf(nd[tuple(slot)]).all() and (ni[tuple(slot)] == n).all()
    cand = torch.tensor([[1, 2, 3, 4, n], [1, 2, 4, 5, 6]], dtype=torch.int32)
    td, ti = cf.forest_rescan_topk(_t(data[:2]), _t(data), cand, 3, "cosine", "f32", n)
    assert torch.isinf(td[0]).all() and (ti[0] == n).all() and torch.isfinite(td[1]).all()
    core = torch.zeros(n)
    comp = torch.arange(n, dtype=torch.int32)
    w, j = cf.forest_min_outgoing(_t(data[:2]), _t(data), cand, core[:2], core, comp[:2], comp,
                                  "cosine", n)
    assert torch.isnan(w[0]) and j[0] == 3 and torch.isfinite(w[1])


# ---------------------------------------------------------------------------
# Fits


def _fits_close(port, ref, tol):
    """Labels and the condensed tree's integer fields exact; core distances
    within ``tol``; the tree's float fields within a relative ``2000 tol``
    (2e-3 in float32): they sum 1 / distance, and a cosine distance near 0
    (1e-4 here) carries an absolute error of a few ulp of 1.0, a relative
    one of about 1e-3."""
    np.testing.assert_array_equal(port.labels, ref.labels)
    np.testing.assert_array_equal(np.isinf(port.core_distances), np.isinf(ref.core_distances))
    np.testing.assert_allclose(port.core_distances, ref.core_distances, rtol=0, atol=tol)
    for f in _TREE_FIELDS:
        a, b = np.asarray(getattr(port.tree, f)), np.asarray(getattr(ref.tree, f))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=2000 * tol, atol=tol, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_exact_fit_matches_reference(metric, dtype):
    """The exact fit at cosine and pearson: labels and condensed tree equal
    the reference's, core distances within the type's tolerance."""
    x = _blobs(20, 200, d=4)
    kw = dict(min_points=8, min_cluster_size=40, dist_function=metric, mst_backend="device")
    ref = ref_exact.fit(x, RefParams(**kw), dtype=dtype)
    port = port_exact.fit(x, PortParams(**kw), device="cpu", dtype=dtype)
    _fits_close(port, ref, 1e-6 if dtype == np.float32 else 1e-10)
    assert len(np.unique(port.labels)) > 2


def test_forest_fit_cosine_matches_reference():
    """The rp-forest tier at cosine (the reference's unfused route, and the
    port's plain versions of it)."""
    x = _blobs(21, 300, d=4)
    kw = dict(min_points=8, min_cluster_size=40, dist_function="cosine", mst_backend="device",
              knn_index="rpforest", rpf_trees=3, rpf_leaf_size=128)
    ref = ref_exact.fit(x, RefParams(**kw))
    port = port_exact.fit(x, PortParams(**kw), device="cpu")
    _fits_close(port, ref, 1e-6)


@pytest.mark.parametrize("metric", METRICS)
def test_mr_fit_matches_reference(metric):
    """The MR pipeline's default mode (global cores through K2, glue and
    refine through B1) at cosine and pearson."""
    x = _blobs(22, 400, d=4)
    kw = dict(min_points=8, min_cluster_size=40, dist_function=metric, processing_units=300,
              seed=0)
    ref = ref_mr.fit(x, RefParams(**kw))
    port = port_mr.fit(x, PortParams(**kw), device="cpu", dtype=np.float64)
    _fits_close(port, ref, 1e-6)


def test_sharded_fit_cosine_matches_reference():
    """The sharded fit (ring K2 panels, B9) at cosine over four CPU shards:
    bitwise the single-device port fit, and the reference's exact fit within
    float32 tolerance."""
    x = _blobs(23, 250, d=3)
    kw = dict(min_points=8, min_cluster_size=40, dist_function="cosine", mst_backend="device")
    single = port_exact.fit(x, PortParams(**kw), device="cpu")
    sharded = port_exact.fit(x, PortParams(**kw, fit_sharding="sharded"),
                             mesh=get_mesh([torch.device("cpu")] * 4))
    np.testing.assert_array_equal(sharded.labels, single.labels)
    np.testing.assert_array_equal(sharded.core_distances, single.core_distances)
    for a, b in zip(sharded.mst, single.mst):
        np.testing.assert_array_equal(a, b)
    _fits_close(sharded, ref_exact.fit(x, RefParams(**kw)), 1e-6)


# ---------------------------------------------------------------------------
# F4: float64 fits


@pytest.mark.parametrize("index", ["exact", "rpforest"])
def test_float64_fit_matches_reference(index):
    """``exact.fit(dtype=np.float64, device="cpu")`` on an integer grid
    equals the reference's float64 fit bitwise, on the exact and the forest
    tier (whose fetch carries float64 tensors)."""
    x = np.random.default_rng(24).integers(0, 24, size=(900, 3)).astype(np.float64)
    kw = dict(min_points=8, min_cluster_size=30, mst_backend="device", knn_index=index,
              rpf_trees=3, rpf_leaf_size=128)
    ref = ref_exact.fit(x, RefParams(**kw), dtype=np.float64)
    port = port_exact.fit(x, PortParams(**kw), device="cpu", dtype=np.float64)
    np.testing.assert_array_equal(port.labels, ref.labels)
    np.testing.assert_array_equal(port.core_distances, ref.core_distances)
    for a, b in zip(port.mst, ref.mst):
        np.testing.assert_array_equal(a, b)
    for f in _TREE_FIELDS:
        np.testing.assert_array_equal(getattr(port.tree, f), getattr(ref.tree, f), err_msg=f)


def test_fetch_carries_every_width():
    """``_fetch`` reads float64 and int64 tensors back intact beside 32-bit
    ones, and refuses a type it does not carry."""
    rng = np.random.default_rng(25)
    arrays = {"sw": rng.normal(size=7), "ra": rng.integers(0, 9, 5).astype(np.int32),
              "w": rng.normal(size=3).astype(np.float32), "u": rng.integers(0, 9, 4)}
    got = port_exact._fetch({k: _t(v) for k, v in arrays.items()})
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)
    with pytest.raises(ValueError, match="_fetch"):
        port_exact._fetch({"h": torch.zeros(3, dtype=torch.float16)})


def test_float64_on_the_card_is_refused_at_entry():
    """The kernels are float32 only: float64 with the card raises before
    any work (no card is needed to reach the check)."""
    x = _blobs(26, 20)
    with pytest.raises(ValueError, match="float32"):
        port_exact.fit(x, PortParams(min_points=4), device="cuda", dtype=np.float64)
    with pytest.raises(ValueError, match="float32"):
        port_tiled.check_dtype(np.float64, torch.device("cuda"))
    port_tiled.check_dtype(np.float64, torch.device("cpu"))


# ---------------------------------------------------------------------------
# F5: zero-norm rows


@pytest.mark.parametrize("metric", METRICS)
def test_zero_norm_row_exact_fit_matches_reference(metric):
    """A zero row (cosine) or a constant row (pearson) in one tile: the
    reference's scan gives every row an infinite core distance; the port's
    cores, neighbour ids and labels equal it."""
    x = _blobs(0, 150, zero_row=5)
    if metric == "pearson":
        x[5] = 2.0
    kw = dict(min_points=8, min_cluster_size=20, dist_function=metric, mst_backend="device")
    ref = ref_exact.fit(x, RefParams(**kw), dtype=np.float64)
    port = port_exact.fit(x, PortParams(**kw), device="cpu", dtype=np.float64)
    assert np.isinf(ref.core_distances).all() and np.isinf(port.core_distances).all()
    np.testing.assert_array_equal(port.labels, ref.labels)
    _, _, ri = ref_tiled.knn_core_distances(x, 8, metric, dtype=np.float64, return_indices=True)
    _, _, pi = port_tiled.knn_core_distances(x, 8, metric, dtype=np.float64,
                                             return_indices=True, device="cpu")
    np.testing.assert_array_equal(pi, ri)


@pytest.mark.parametrize("metric", METRICS)
def test_zero_norm_row_mr_fit_matches_reference(metric):
    """The MR pipeline on the same kind of data: infinite global cores, the
    glue's tile rule and the host forest builder for the pool's +inf
    weights give the reference's labels."""
    x = _blobs(0, 500, zero_row=5)
    if metric == "pearson":
        x[5] = 2.0
    kw = dict(min_points=8, min_cluster_size=20, dist_function=metric, processing_units=300,
              seed=0)
    ref = ref_mr.fit(x, RefParams(**kw))
    port = port_mr.fit(x, PortParams(**kw), device="cpu", dtype=np.float64)
    np.testing.assert_array_equal(np.isinf(port.core_distances), np.isinf(ref.core_distances))
    np.testing.assert_array_equal(port.labels, ref.labels)
