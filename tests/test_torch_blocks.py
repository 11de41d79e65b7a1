"""Blocks and bubbles: the port's dense Borůvka, block programs, sample
assignment, seam margins, bubble statistics and bubble model against the
reference's, on numpy-seeded inputs.

The reference runs in float64 here (the suite's ``jax_enable_x64``), so the
port runs these stages with float64 tensors too; seam margins are float32
on both sides. Integer-lattice inputs are bitwise; continuous bubble
statistics differ in the order of the segment sums (the port's fixed
pairwise tree against XLA's scatter-add) and are held to 1e-12 relative,
and the bubble core distances' powers to 2 ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdbscan_tpu.core import bubbles as ref_bubbles
from hdbscan_tpu.core.mst import boruvka_mst as ref_boruvka
from hdbscan_tpu.models.bubble_hdbscan import fit_bubbles as ref_fit_bubbles
from hdbscan_tpu.parallel import blocks as ref_blocks
from hdbscan_tpu_torch.core import bubbles as port_bubbles
from hdbscan_tpu_torch.core.knn import core_distances_from_matrix
from hdbscan_tpu_torch.core.mst import boruvka_mst as port_boruvka
from hdbscan_tpu_torch.models.bubble_hdbscan import fit_bubbles as port_fit_bubbles
from hdbscan_tpu_torch.parallel import blocks as port_blocks

CPU = torch.device("cpu")


def _grid(seed, n, d, hi=9):
    return np.random.default_rng(seed).integers(0, hi, size=(n, d)).astype(np.float64)


@pytest.mark.parametrize("n,num_valid", [(64, 64), (128, 100), (200, 1)])
def test_boruvka_mst_equals_reference(n, num_valid):
    x = _grid(n, n, 2, 6)  # heavy exact ties: the (w, lo, hi) rule decides
    w = np.sqrt(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    ref = ref_boruvka(jnp.asarray(w), num_valid)
    port = port_boruvka(torch.as_tensor(w), num_valid)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_self_edges_append_core_levels():
    from hdbscan_tpu.core.mst import mst_edges_with_self_edges as ref_self
    from hdbscan_tpu_torch.core.mst import mst_edges_with_self_edges as port_self

    u, v, w, mask = np.array([0, 1]), np.array([1, 2]), np.array([1.0, 2.0]), np.array([True, False])
    core = np.array([0.5, 0.25, 3.0])
    valid = np.array([True, True, False])
    ref = ref_self(jnp.asarray(u), jnp.asarray(v), jnp.asarray(w), jnp.asarray(mask),
                   jnp.asarray(core), jnp.asarray(valid))
    port = port_self(*(torch.as_tensor(a) for a in (u, v, w, mask, core, valid)))
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_core_distances_with_padding_clamp():
    x = _grid(1, 6, 2)
    d = torch.as_tensor(np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)))
    valid = torch.tensor([True, True, True, False, False, False])
    core = core_distances_from_matrix(d, 8, valid)  # k > valid columns: clamp
    want = d[:3, :3].amax(dim=1)
    assert torch.equal(core[:3], want) and torch.isinf(core[3:]).all()


def _packed(seed, with_core):
    rng = np.random.default_rng(seed)
    data = _grid(seed, 700, 3, 12)
    sizes = [128, 90, 7, 1, 120]
    ids = np.split(rng.permutation(700)[: sum(sizes)], np.cumsum(sizes)[:-1])
    core = rng.integers(1, 5, 700).astype(np.float64) if with_core else None
    return ref_blocks.pack_blocks(data, ids, 128, core=core)


@pytest.mark.parametrize("with_core", [False, True])
def test_run_packed_blocks_equals_reference(with_core):
    packed = _packed(3, with_core)
    ref = ref_blocks.run_packed_blocks(packed, 5, "euclidean")
    port = port_blocks.run_packed_blocks(packed, 5, "euclidean", device=CPU, dtype=np.float64)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)


def test_run_packed_blocks_budget_chunks():
    """A budget of one block per launch gives the same edges."""
    packed = _packed(4, False)
    ref = ref_blocks.run_packed_blocks(packed, 4, "manhattan")
    port = port_blocks.run_packed_blocks(packed, 4, "manhattan", hbm_budget_bytes=1,
                                         device=CPU, dtype=np.float64)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("metric", ["euclidean", "supremum"])
def test_nearest_sample_assign_and_seam_margins(metric):
    pts = _grid(5, 3000, 3, 30)
    samples = pts[np.random.default_rng(6).choice(3000, 90, replace=False)]
    groups = np.arange(90) % 4
    ref_a = ref_blocks.nearest_sample_assign(pts, samples, metric, tile=1024)
    port_a = port_blocks.nearest_sample_assign(pts, samples, metric, tile=1024, device=CPU,
                                               dtype=np.float64)
    np.testing.assert_array_equal(port_a, ref_a)
    ref_m = ref_blocks.seam_margins(pts, samples, groups, metric, tile=1024)
    port_m = port_blocks.seam_margins(pts, samples, groups, metric, tile=1024, device=CPU)
    np.testing.assert_array_equal(port_m, ref_m)


def _stats_inputs(lattice):
    rng = np.random.default_rng(7)
    pts = _grid(7, 1200, 3, 20) if lattice else rng.normal(size=(1200, 3)) * 3.0
    assign = rng.integers(0, 60, 1200)
    assign[:5] = 64  # padding rows: dropped
    assign[assign == 13] = 12  # an empty bubble
    return pts, assign


@pytest.mark.parametrize("lattice", [True, False])
def test_bubble_stats_equals_reference(lattice):
    pts, assign = _stats_inputs(lattice)
    ref = ref_bubbles.bubble_stats(jnp.asarray(pts), jnp.asarray(assign, jnp.int32), 64)
    port = port_bubbles.bubble_stats(torch.as_tensor(pts), torch.as_tensor(assign), 64)
    for name, a, b in zip(("rep", "extent", "nn_dist", "n"), port, ref):
        if lattice and name in ("rep", "n"):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12,
                                       err_msg=name)


def test_bubble_matrix_core_and_fit_equal_reference():
    pts, assign = _stats_inputs(True)
    stats = ref_bubbles.bubble_stats(jnp.asarray(pts), jnp.asarray(assign, jnp.int32), 64)
    rep, extent, nn, n_b = (np.array(t) for t in stats)
    t = [torch.as_tensor(a) for a in (rep, extent, nn, n_b)]
    ref_d = ref_bubbles.bubble_distance_matrix(*(jnp.asarray(a) for a in (rep, extent, nn)))
    port_d = port_bubbles.bubble_distance_matrix(*t[:3])
    np.testing.assert_array_equal(port_d.numpy(), np.asarray(ref_d))
    valid = np.arange(64) < 60
    ref_c = ref_bubbles.bubble_core_distances(ref_d, jnp.asarray(n_b), jnp.asarray(extent), 6, 3,
                                              valid=jnp.asarray(valid))
    port_c = port_bubbles.bubble_core_distances(port_d, t[3], t[1], 6, 3,
                                                valid=torch.as_tensor(valid))
    # pow((k'/n), 1/d) is correctly rounded on neither side: 2 ulp.
    np.testing.assert_allclose(port_c.numpy(), np.asarray(ref_c), rtol=4.5e-16)
    ref_m = ref_fit_bubbles(rep, extent, nn, n_b, 6, 40, num_valid=60)
    port_m = port_fit_bubbles(*t, 6, 40, num_valid=60)
    np.testing.assert_array_equal(port_m.labels, ref_m.labels)
    np.testing.assert_allclose(port_m.core, ref_m.core, rtol=4.5e-16)
    np.testing.assert_array_equal(port_m.weights, ref_m.weights)
    for (pu, pv, pw), (ru, rv, rw) in ((port_m.mst, ref_m.mst),
                                       (port_m.inter_edges, ref_m.inter_edges)):
        np.testing.assert_array_equal(pu, ru)
        np.testing.assert_array_equal(pv, rv)
        np.testing.assert_allclose(pw, rw, rtol=4.5e-16)  # MRD weights carry the cores


def test_fit_bubbles_single_bubble():
    t = [torch.tensor([[1.0, 2.0]]), torch.zeros(1), torch.zeros(1), torch.tensor([5.0])]
    m = port_fit_bubbles(*t, 4, 2)
    assert m.labels.tolist() == [1] and len(m.mst[0]) == 0
