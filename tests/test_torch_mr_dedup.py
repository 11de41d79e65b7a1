"""``dedup_points`` in the MR-HDBSCAN* pipeline against the reference: the
fit over weighted unique points (weighted global cores through K2 with
ids, the Gumbel top-k sample draw by multiplicity, weighted bubbles, heavy
groups expanded before the finalize) broadcast back to rows.

The harness is ``tests/test_torch_mr.py``'s (the reference under x64
against the port at float64, and one case without x64 against the port's
float32). The rows are a lattice set with every third point repeated 1 to
6 more times, so every level stat, label, tree field, core distance,
outlier score and pooled edge (in unique-vertex space) is bitwise.
"""

import jax
import numpy as np
import pytest

from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.models import mr_hdbscan as ref_mr
from hdbscan_tpu_torch.config import HDBSCANParams as PortParams
from hdbscan_tpu_torch.models import mr_hdbscan as port_mr
from tests.test_torch_mr import BASE, _assert_bitwise, _fit_both, _lattice
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


def _rows(heavy: bool = False):
    """The lattice with every third point repeated 1-6 more times; with
    ``heavy`` three points repeated 60, 50 and 45 times more (past
    min_cluster_size 40, so the heavy-group expansion runs), rows
    shuffled."""
    x = _lattice()
    rng = np.random.default_rng(5)
    idx = np.arange(0, len(x), 3)
    reps = rng.integers(1, 7, len(idx))
    if heavy:
        reps[:3] = (60, 50, 45)
    rows = np.concatenate([x, np.repeat(x[idx], reps, axis=0)])
    return rows[rng.permutation(len(rows))]


def _check(port, ref, rows):
    _assert_bitwise(port, ref)
    for a, b in zip(port.edge_pool, ref.edge_pool):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.dedup_inverse, ref.dedup_inverse)
    assert port.labels.shape == (len(rows),)


@pytest.mark.parametrize(
    "overrides",
    [{}, {"variant": "rs"}, {"compat_cf_int_math": True}, {"refine_flat_iterations": 2}],
    ids=["db", "rs", "compat", "refine_flat"],
)
def test_dedup_lattice_bitwise(overrides):
    rows = _rows()
    port, ref, events = _fit_both(rows, {"keep_edge_pool": True}, dedup_points=True,
                                  **overrides)
    _check(port, ref, rows)
    assert "dedup" in events and "global_cores" in events


def test_dedup_heavy_groups_bitwise():
    """Groups past min_cluster_size: the heavy-group expansion before the
    finalize, and bubbles whose weighted sums run large."""
    rows = _rows(heavy=True)
    port, ref, _ = _fit_both(rows, {"keep_edge_pool": True}, dedup_points=True,
                             min_cluster_size=40)
    _check(port, ref, rows)
    assert np.unique(rows, axis=0, return_counts=True)[1].max() >= 40


def test_dedup_float32_bitwise():
    """The production setting: the reference without x64, the port at its
    float32 default, heavy groups included."""
    rows = _rows(heavy=True)
    kw = {**BASE, "dedup_points": True, "min_cluster_size": 40}
    with jax.enable_x64(False):
        ref = ref_mr.fit(rows, RefParams(**kw))
    port = port_mr.fit(rows, PortParams(**kw), device="cpu")
    _assert_bitwise(port, ref)


def test_weighted_draw_follows_the_reference():
    """The Gumbel top-k draw consumes the generator as the reference's does
    (``rng.gumbel`` then ``argpartition``, not ``rng.choice``): a run with
    a different draw would differ from level 1 on; the level stats of a
    four-level run pin it."""
    rows = _rows()
    port, ref, _ = _fit_both(rows, dedup_points=True, k=0.05, seed=3)
    assert port.n_levels == ref.n_levels >= 3
    _assert_bitwise(port, ref)


def test_dedup_needs_global_cores():
    rows = _rows()[:300]
    params = PortParams(**{**BASE, "dedup_points": True, "global_core_distances": False})
    with pytest.raises(ValueError, match="dedup_points requires global_core_distances"):
        port_mr.fit(rows, params, device="cpu")
