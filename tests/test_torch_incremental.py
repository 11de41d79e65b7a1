"""The port's incremental hierarchy maintenance (``hdbscan_tpu_torch/incremental``)
against the reference's ``hdbscan_tpu/incremental``, on the same seeded
lattice rows (multiples of 1/8, where float32 distance math is exact).

Bitwise: the bootstrap's k-NN rows and Prim MST, the maintained MST (edge
ids, raw distances, weights) and cores after every insert and splice, every
splice's statistics, the maintainer's ``state_dict`` (the edit-journal and
MST sha256 digests the WAL watermark persists), the finalize tail's tree
fields, the resumable merge-forest fold's forests, and the WAL recovery fold
verified across the packages. The maintained MST also equals the port's
own dense fit of the grown rows.
"""

import dataclasses

import numpy as np
import pytest

from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.core import tree as ref_tree
from hdbscan_tpu import incremental as ref_inc
from hdbscan_tpu.ops import rpforest as ref_rpforest
from hdbscan_tpu_torch.config import HDBSCANParams
from hdbscan_tpu_torch import incremental as inc
from hdbscan_tpu_torch.models import hdbscan
from hdbscan_tpu_torch.ops import rpforest
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401

TREE_FIELDS = ("parent", "birth", "death", "stability", "has_children", "num_members",
               "point_exit_level", "point_last_cluster")
MST_FIELDS = ("m_lo", "m_hi", "m_d", "m_w")


def _lattice(rng, n, dims):
    return rng.integers(0, 48, (n, dims)).astype(np.float64) / 8.0


def _same_maintainers(a, b, ctx=""):
    n = a.n
    assert n == b.n, ctx
    assert a.core[:n].tobytes() == b.core[:n].tobytes(), f"{ctx} core"
    assert a.nbr_d[:n].tobytes() == b.nbr_d[:n].tobytes(), f"{ctx} knn rows"
    assert a.nbr_i[:n].tobytes() == b.nbr_i[:n].tobytes(), f"{ctx} knn ids"
    for f in MST_FIELDS:
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f"{ctx} {f}"
    assert a.state_dict() == b.state_dict(), ctx


def _same_trees(ref, got, ctx=""):
    for name in TREE_FIELDS:
        a, b = np.asarray(getattr(ref[0], name)), np.asarray(getattr(got[0], name))
        assert a.dtype == b.dtype and a.shape == b.shape, f"{ctx} {name} shape"
        assert a.tobytes() == b.tobytes(), f"{ctx} {name}"
    for i, name in ((1, "labels"), (2, "scores"), (3, "infinite")):
        np.testing.assert_array_equal(ref[i], got[i], err_msg=f"{ctx} {name}")


def test_bootstrap_equals_reference():
    """``f32_distances``, ``host_knn_rows`` and ``host_mst`` bitwise,
    including a ``block`` smaller than n (the chunked k-NN)."""
    rng = np.random.default_rng(11)
    data = _lattice(rng, 70, 3)
    np.testing.assert_array_equal(inc.f32_distances(data[3], data),
                                  ref_inc.f32_distances(data[3], data))
    for block in (16, 1024):
        got = inc.host_knn_rows(data, 5, block=block)
        want = ref_inc.host_knn_rows(data, 5, block=block)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    core = want[0]
    for a, b in zip(inc.host_mst(data, core), ref_inc.host_mst(data, core)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", range(3))
def test_insert_parity_sweep(seed):
    """Eager splices (``refresh_every=1``): after EVERY insert + splice the
    port's maintainer equals the reference's bitwise, the splice statistics
    agree (one new vertex evicts spliced - 1 edges), and at checkpoints the
    dirty-subtree finalize equals the reference's ``finalize_from_mst``."""
    rng = np.random.default_rng(seed)
    for trial in range(2):
        n0, dims, min_pts = int(rng.integers(12, 40)), int(rng.integers(2, 4)), int(
            rng.integers(3, 6))
        data = _lattice(rng, n0, dims)
        m = inc.HierarchyMaintainer(data, min_pts=min_pts, refresh_every=1)
        r = ref_inc.HierarchyMaintainer(data, min_pts=min_pts, refresh_every=1)
        fin = inc.DirtySubtreeFinalizer(HDBSCANParams(min_points=min_pts, min_cluster_size=4))
        ref_params = RefParams(min_points=min_pts, min_cluster_size=4)
        _same_maintainers(m, r, f"seed={seed} trial={trial} bootstrap")
        for step, row in enumerate(_lattice(rng, 30, dims)):
            got_ins, want_ins = m.insert(row), r.insert(row)
            for key in ("id", "candidates", "affected"):
                assert got_ins[key] == want_ins[key]
            got, want = m.splice(), r.splice()
            ctx = f"seed={seed} trial={trial} step={step}"
            for key in ("n", "inserts", "candidates", "dirty_frac", "spliced", "evicted",
                        "edges_prev", "edges"):
                assert got[key] == want[key], f"{ctx} {key}"
            assert got["evicted"] == got["spliced"] - 1, ctx
            _same_maintainers(m, r, ctx)
            if step % 10 == 9:
                lo, hi, w = m.mst_arrays()
                ref_out = ref_inc.finalize_from_mst(m.n, lo, hi, w, r.core[: r.n], ref_params)
                _same_trees(ref_out, fin.finalize(m.n, lo, hi, w, m.core[: m.n]), ctx)
                _same_trees(ref_out, inc.finalize_from_mst(
                    m.n, lo, hi, w, m.core[: m.n], fin.params), ctx)


def test_cadence_splices_equal_reference_and_the_port_fit():
    """Deferred splices (``refresh_every=8``) land on the reference's state,
    and the maintained MST is the port's own float32 dense fit's on the
    grown rows (cores, weights, the canonical edge set)."""
    rng = np.random.default_rng(99)
    data = _lattice(rng, 30, 3)
    m = inc.HierarchyMaintainer(data, min_pts=4, refresh_every=8)
    r = ref_inc.HierarchyMaintainer(data, min_pts=4, refresh_every=8)
    splices = 0
    for row in _lattice(rng, 40, 3):
        m.insert(row)
        r.insert(row)
        if m._since_splice >= m.refresh_every:
            got, want = m.splice(), r.splice()
            assert {k: v for k, v in got.items() if k != "wall_s"} == {
                k: v for k, v in want.items() if k != "wall_s"}
            splices += 1
    assert splices == 5 and m.pending_edges == 0
    _same_maintainers(m, r, "cadence")
    grown = np.asarray(m.data[: m.n])
    fit = hdbscan.fit(grown, HDBSCANParams(min_points=4, min_cluster_size=4), device="cpu")
    u, v, w = fit.mst
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    order = np.lexsort((hi, lo, w))
    np.testing.assert_array_equal(m.core[: m.n], fit.core_distances)
    np.testing.assert_array_equal(m.m_lo, lo[order])
    np.testing.assert_array_equal(m.m_hi, hi[order])
    np.testing.assert_array_equal(m.m_w, w[order])


def test_resumable_forest_equals_reference_forest():
    """The port's ``ResumableForestBuilder`` resumes from checkpoints yet
    builds the reference's ``build_merge_forest`` forest, node for node."""
    rng = np.random.default_rng(7)
    data = _lattice(rng, 40, 2)
    m = inc.HierarchyMaintainer(data, min_pts=3, refresh_every=4)
    fold = inc.ResumableForestBuilder(checkpoints=6)
    resumed = 0
    for row in _lattice(rng, 24, 2):
        m.insert(row)
        if m._since_splice >= m.refresh_every:
            m.splice()
            lo, hi, w = m.mst_arrays()
            got = fold.build(m.n, lo, hi, w)
            resumed += fold.last_stats["resume_pos"] > 0
            want = ref_tree.build_merge_forest(m.n, lo, hi, w)
            assert got.children == want.children and got.roots == want.roots
            assert got.dist.tobytes() == want.dist.tobytes()
            assert got.sizes.tobytes() == want.sizes.tobytes()
    assert resumed >= 1, "the fold never resumed from a checkpoint"


def test_rebuild_verifies_across_packages():
    """The WAL recovery fold: the port's ``rebuild`` verifies the
    reference's persisted watermark (and the reference's verifies the
    port's), and a corrupted digest is detected in both."""
    rng = np.random.default_rng(5)
    data, rows = _lattice(rng, 24, 3), _lattice(rng, 30, 3)
    marks = {}
    for name, mod in (("port", inc), ("ref", ref_inc)):
        live = mod.HierarchyMaintainer(data, min_pts=4, refresh_every=8)
        for row in rows:
            live.insert(row)
            if live._since_splice >= live.refresh_every:
                live.splice()
        marks[name] = live.state_dict()
    assert marks["port"] == marks["ref"]
    for mod, other in ((inc, "ref"), (ref_inc, "port")):
        rec = mod.HierarchyMaintainer(data, min_pts=4, refresh_every=8)
        rec.rebuild(rows, verify_at=(marks[other]["inserts"], marks[other]))
        assert rec.state_dict() == marks[other]
    bad = dict(marks["ref"], mst_sha="0" * 64)
    with pytest.raises(inc.MaintainFallback, match="diverged"):
        inc.HierarchyMaintainer(data, min_pts=4, refresh_every=8).rebuild(
            rows, verify_at=(bad["inserts"], bad))


def test_dirty_frac_fallback_preserves_state():
    """A splice over ``maintain_dirty_max_frac`` raises before mutating, in
    both packages, with equal states before and after."""
    rng = np.random.default_rng(3)
    data = _lattice(rng, 20, 2)
    states = []
    for mod in (inc, ref_inc):
        m = mod.HierarchyMaintainer(data, min_pts=3, refresh_every=64, dirty_max_frac=1e-9)
        m.insert(np.asarray(data[0]) + 1.0 / 8.0)
        before = m.state_dict()
        with pytest.raises(mod.MaintainFallback, match="dirty fraction"):
            m.splice()
        assert m.state_dict() == before
        states.append(before)
    assert states[0] == states[1]


def test_forest_candidates_equal_reference():
    """With a stored rp-forest (the artifact's packed dict), each insert's
    candidate set is the union of the routed leaves plus every inserted
    row: ``leaf_members_np`` and the bounded maintainers equal the
    reference's."""
    rng = np.random.default_rng(13)
    data = _lattice(rng, 200, 3)
    forest = rpforest.build_forest(data, trees=3, leaf_size=32, seed=4, device="cpu")
    rpf = {f.name: getattr(forest, f.name) for f in dataclasses.fields(forest)}
    rows = _lattice(rng, 40, 3)
    for row in rows[:8]:
        np.testing.assert_array_equal(rpforest.leaf_members_np(rpf, row),
                                      ref_rpforest.leaf_members_np(rpf, row))
        np.testing.assert_array_equal(rpforest.leaf_members_np(forest, row),
                                      rpforest.leaf_members_np(rpf, row))
    m = inc.HierarchyMaintainer(data, min_pts=5, rpf=rpf, refresh_every=8)
    r = ref_inc.HierarchyMaintainer(data, min_pts=5, rpf=rpf, refresh_every=8)
    for row in rows:
        got, want = m.insert(row), r.insert(row)
        assert got["candidates"] == want["candidates"] < m.n - 1
        if m._since_splice >= m.refresh_every:
            m.splice()
            r.splice()
    _same_maintainers(m, r, "rp-forest candidates")


def test_non_euclidean_metric_rejected():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="euclidean"):
        inc.HierarchyMaintainer(_lattice(rng, 8, 2), min_pts=3, metric="cosine")
