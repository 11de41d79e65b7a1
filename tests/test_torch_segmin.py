"""Segment-min (Borůvka per-row min outgoing edge): the plain PyTorch
version of kernel K1 (``ops/tiled._min_outgoing_scan``, which the CUDA
kernel reproduces bitwise on the card) against the reference's XLA oracle
``min_outgoing_xla_reference`` and its Pallas kernel in interpret mode.

Tolerances: integer grids are bitwise, ids included (every distance is
the correctly rounded square root of an exact integer). Continuous data
allows 2 ulp of float32 on the weights: XLA's fused CPU ``sqrt`` is not
correctly rounded there, while the port's is; ids agree on at least 99% of
rows (a last-bit shift can reorder two near-tied candidates).
"""

import numpy as np
import pytest
import torch

from hdbscan_tpu.ops.pallas_segmin import min_outgoing_pallas, min_outgoing_xla_reference
from hdbscan_tpu_torch.core.distances import euclidean_form
from hdbscan_tpu_torch.ops.cuda_segmin import min_outgoing_all_rows, min_outgoing_plain


def _inputs(seed, n, n_pad, d, grid, n_comp):
    rng = np.random.default_rng(seed)
    if grid:
        x = rng.integers(0, grid, size=(n, d)).astype(np.float32)
        core = rng.integers(0, 3, size=n).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        core = (rng.random(n) * 0.5).astype(np.float32)
    comp = rng.integers(0, n_comp, size=n).astype(np.int32)
    xp = np.zeros((n_pad, d), np.float32)
    xp[:n] = x
    cp = np.zeros(n_pad, np.float32)
    cp[:n] = core
    kp = np.zeros(n_pad, np.int32)
    kp[:n] = comp
    valid = np.arange(n_pad) < n
    return xp, cp, kp, valid


def _port(x, core, comp, valid, form):
    bw, bj = min_outgoing_plain(
        torch.from_numpy(x), torch.from_numpy(core), torch.from_numpy(comp),
        torch.from_numpy(valid), "euclidean", form,
    )
    return bw.numpy(), bj.numpy()


def _ref(x, core, comp, valid, row_tile, col_tile):
    bw, bj = min_outgoing_xla_reference(x, core, comp, valid, "euclidean", row_tile, col_tile)
    return np.asarray(bw), np.asarray(bj)


@pytest.mark.parametrize(
    "seed,n,n_pad,d,grid,n_comp,row_tile,col_tile",
    [
        (0, 300, 384, 3, 8, 5, 64, 128),      # heavy duplicates, ragged n
        (1, 500, 512, 2, 4, 40, 32, 128),     # many exact ties
        (2, 250, 256, 7, 16, 250, 64, 128),   # every point its own component
        (3, 1000, 1024, 3, 256, 17, 128, 256),
    ],
)
def test_integer_grid_bitwise_vs_xla(seed, n, n_pad, d, grid, n_comp, row_tile, col_tile):
    x, core, comp, valid = _inputs(seed, n, n_pad, d, grid, n_comp)
    form = euclidean_form(row_tile, col_tile, d)
    bw, bj = _port(x, core, comp, valid, form)
    rw, rj = _ref(x, core, comp, valid, row_tile, col_tile)
    np.testing.assert_array_equal(bw, rw)
    np.testing.assert_array_equal(bj, rj)
    assert np.all(bj[n:] == -1) and np.all(np.isinf(bw[n:]))  # invalid pad rows


def test_integer_grid_dot_form_bitwise_vs_xla():
    """At 4096 x 4096 x 3 tiles the reference takes the dot form."""
    x, core, comp, valid = _inputs(4, 4000, 4096, 3, 256, 300)
    assert euclidean_form(4096, 4096, 3) == "dot"
    bw, bj = _port(x, core, comp, valid, "dot")
    rw, rj = _ref(x, core, comp, valid, 4096, 4096)
    np.testing.assert_array_equal(bw, rw)
    np.testing.assert_array_equal(bj, rj)


def test_integer_grid_bitwise_vs_pallas_interpret():
    x, core, comp, valid = _inputs(5, 500, 512, 3, 8, 9)
    bw, bj = _port(x, core, comp, valid, euclidean_form(64, 128, 128))
    rw, rj = min_outgoing_pallas(
        x, core, comp, valid, "euclidean", 64, 128, interpret=True
    )
    np.testing.assert_array_equal(bw, np.asarray(rw))
    np.testing.assert_array_equal(bj, np.asarray(rj))


def test_single_component_has_no_outgoing_edge():
    x, core, _, valid = _inputs(6, 200, 256, 3, 8, 1)
    comp = np.zeros(256, np.int32)
    bw, bj = _port(x, core, comp, valid, "diff")
    rw, rj = _ref(x, core, comp, valid, 64, 128)
    assert np.all(np.isinf(bw)) and np.all(bj == -1)
    np.testing.assert_array_equal(bw, rw)
    np.testing.assert_array_equal(bj, rj)


@pytest.mark.parametrize("seed,d", [(7, 3), (8, 7)])
def test_continuous_within_sqrt_rounding(seed, d):
    x, core, comp, valid = _inputs(seed, 480, 512, d, 0, 12)
    bw, bj = _port(x, core, comp, valid, euclidean_form(64, 128, d))
    rw, rj = _ref(x, core, comp, valid, 64, 128)
    np.testing.assert_allclose(bw, rw, rtol=2.5e-7, atol=0)
    assert np.mean(bj == rj) > 0.99


def test_min_outgoing_all_rows_picks_the_reference_form():
    """The round entry point chooses the form from the clamped tiles, on
    unpadded rows; the reference scans the padded rows at those tiles."""
    from hdbscan_tpu_torch.ops.tiled import _tile_sizes

    n = 700
    row_tile, col_tile, n_pad = _tile_sizes(n, 1024, 8192)
    x, core, comp, valid = _inputs(9, n, n_pad, 3, 32, 20)
    t = [torch.from_numpy(a[:n]) for a in (x, core, comp, valid)]
    bw, bj = min_outgoing_all_rows(*t, "euclidean", 1024, 8192)
    rw, rj = _ref(x, core, comp, valid, row_tile, col_tile)
    np.testing.assert_array_equal(bw.numpy(), rw[:n])
    np.testing.assert_array_equal(bj.numpy(), rj[:n])


@pytest.mark.parametrize("form,row_tile,col_tile", [("diff", 64, 128), ("dot", 512, 512)])
@pytest.mark.parametrize("case", ["all_equal", "zero_cores_duplicates"])
def test_ties_and_zero_weights_pin_the_contract(case, form, row_tile, col_tile):
    """The contract the kernel's split combine must keep: among equal
    weights the lowest column wins, and a zero weight keeps its bits (the
    sign included, compared as int32 patterns). All-equal weights: every
    point identical, equal cores. Zero cores with duplicate rows: every
    duplicate in another component is a zero-weight edge."""
    rng = np.random.default_rng(11)
    n = 500
    if case == "all_equal":
        x = np.zeros((n, 3), np.float32)
        core = np.full(n, 2.0, np.float32)
    else:
        x = np.repeat(rng.integers(0, 6, size=(n // 5, 3)), 5, axis=0).astype(np.float32)
        core = np.zeros(n, np.float32)
    comp = rng.integers(0, 9, size=n).astype(np.int32)
    valid = rng.random(n) < 0.9
    n_pad = 512
    xp, cp, kp = (np.zeros((n_pad, 3), np.float32), np.zeros(n_pad, np.float32),
                  np.zeros(n_pad, np.int32))
    xp[:n], cp[:n], kp[:n] = x, core, comp
    vp = np.arange(n_pad) < n
    vp[:n] &= valid
    bw, bj = _port(xp, cp, kp, vp, form)
    rw, rj = _ref(xp, cp, kp, vp, row_tile, col_tile)
    np.testing.assert_array_equal(bw.view(np.int32), np.asarray(rw, np.float32).view(np.int32))
    np.testing.assert_array_equal(bj, rj)
    ok = vp & (bj >= 0)
    # The lowest valid column in another component wins every tie.
    for i in np.flatnonzero(ok)[:50]:
        others = np.flatnonzero(vp & (kp != kp[i]))
        w = np.maximum(np.sqrt(((xp[others] - xp[i]) ** 2).sum(-1)),
                       np.maximum(cp[i], cp[others]))
        assert bj[i] == others[np.argmin(w)]
    if case == "zero_cores_duplicates":
        assert np.any(bw[ok] == 0.0) and not np.any(np.signbit(bw[ok]))
