"""Windowed k-best scan (kernel B4): the plain PyTorch version, which the
CUDA kernel reproduces bitwise on the card, against the reference's fused
Pallas kernel ``knn_window_fused_pallas`` in interpret mode.

Tolerances: integer grids are bitwise — distances and ids, every slot.
Continuous data takes the dot form's cancellation error, as the fused k-NN
tests do (``tests/test_torch_knn.py``): the squared distance carries ~eps *
|x|^2 absolute error and the reference and the port sum norms and cross
terms in different orders, so distances are held to 2.5e-7 relative plus
4e-3 absolute, and ids agree on at least 99% of slots.
"""

import numpy as np
import pytest
import torch

from hdbscan_tpu.ops.pallas_knn import LANES, knn_window_fused_pallas
from hdbscan_tpu_torch.ops.cuda_knn_window import knn_window, knn_window_plain
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


COL_TILE = 128


def _case(seed, n, d, lattice, rt, tiles, n_win, last_window=False, finite_bnd=False):
    rng = np.random.default_rng(seed)
    if lattice:
        x = rng.integers(0, 12, size=(n, d)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
    n_pad = -(-n // COL_TILE) * COL_TILE
    n_tiles = n_pad // COL_TILE
    ids = rng.integers(0, n, size=(tiles, rt)).astype(np.int32)
    ids[-1, rt // 2 :] = 0  # pad slots of a partial tile scan row 0
    wstart = rng.integers(0, n_tiles - n_win + 1, size=tiles).astype(np.int32)
    if last_window:
        wstart[:] = n_tiles - n_win
    if finite_bnd:
        bnd = rng.uniform(0.5, 4.0, size=(tiles, rt)).astype(np.float32)
        if lattice:
            bnd = np.round(bnd).astype(np.float32)
    else:
        bnd = np.full((tiles, rt), np.inf, np.float32)
    return x, n_pad, ids, wstart, bnd


def _reference(x, n_pad, ids, wstart, bnd, k, n_win):
    tiles, rt = ids.shape
    n, d = x.shape
    rows = np.zeros((tiles * rt, LANES), np.float32)
    rows[:, :d] = x[ids.reshape(-1)]
    xt = np.zeros((LANES, n_pad), np.float32)
    xt[:d, :n] = x.T
    mask = np.full((1, n_pad), np.inf, np.float32)
    mask[0, :n] = 0.0
    dd, ii = knn_window_fused_pallas(
        rows, xt, mask, wstart, bnd.reshape(-1, 1), k, row_tile=rt, col_tile=COL_TILE,
        n_win_tiles=n_win, interpret=True,
    )
    return (np.asarray(dd)[:, :k].reshape(tiles, rt, k),
            np.asarray(ii)[:, :k].reshape(tiles, rt, k))


def _port(x, n_pad, ids, wstart, bnd, k, n_win):
    xp = np.zeros((n_pad, x.shape[1]), np.float32)
    xp[: len(x)] = x
    dd, ii = knn_window(torch.as_tensor(xp), len(x), torch.as_tensor(ids),
                        torch.as_tensor(wstart), torch.as_tensor(bnd), k, COL_TILE, n_win)
    return dd.numpy(), ii.numpy()


@pytest.mark.parametrize(
    "k,n_win,finite_bnd",
    [(1, 1, False), (7, 2, False), (15, 4, False), (1, 4, True), (7, 1, True), (15, 2, True)],
)
def test_lattice_bitwise_vs_pallas(k, n_win, finite_bnd):
    case = _case(k * 10 + n_win, 700, 3, True, 32, 3, n_win, finite_bnd=finite_bnd)
    ref = _reference(*case, k, n_win)
    port = _port(*case, k, n_win)
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_array_equal(port[1], ref[1])


@pytest.mark.parametrize("n_win", [1, 3])
@pytest.mark.parametrize("k", [7, 8])
def test_lattice_bnd_at_window_distances_vs_pallas(k, n_win):
    """``bnd`` equal to distances present in each slot's window — its
    nearest column of the window's first tile, odd slots a random column of
    the last — so a guard must not fire on equality: bitwise vs the
    reference."""
    x, n_pad, ids, wstart, _ = _case(70 + k + n_win, 700, 3, True, 32, 3, n_win)
    rng = np.random.default_rng(k * n_win)
    n = len(x)
    xr = x[ids].astype(np.float64)
    first = wstart[:, None] * COL_TILE + np.arange(COL_TILE)
    first = np.where(first < n, first, n - 1)
    near = np.sqrt(((xr[:, :, None, :] - x[first][:, None, :, :]) ** 2).sum(-1)).min(-1)
    last = (wstart[:, None] + n_win - 1) * COL_TILE + rng.integers(0, COL_TILE, size=ids.shape)
    other = np.sqrt(((xr - x[np.minimum(last, n - 1)]) ** 2).sum(-1))
    odd = np.arange(ids.shape[1]) % 2 == 1
    bnd = np.where(odd, other, near).astype(np.float32)
    ref = _reference(x, n_pad, ids, wstart, bnd, k, n_win)
    port = _port(x, n_pad, ids, wstart, bnd, k, n_win)
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_array_equal(port[1], ref[1])


@pytest.mark.parametrize("k", [1, 7, 15])
def test_lattice_window_at_last_column_tile(k):
    case = _case(50 + k, 650, 4, True, 16, 2, 2, last_window=True)  # ragged last tile
    ref = _reference(*case, k, 2)
    port = _port(*case, k, 2)
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_array_equal(port[1], ref[1])


@pytest.mark.parametrize("finite_bnd", [False, True])
def test_continuous_within_dot_form_tolerance(finite_bnd):
    case = _case(9, 600, 7, False, 32, 3, 2, finite_bnd=finite_bnd)
    ref = _reference(*case, 7, 2)
    port = _port(*case, 7, 2)
    np.testing.assert_allclose(port[0], ref[0], rtol=2.5e-7, atol=4e-3)
    assert np.mean(port[1] == ref[1]) > 0.99


def test_guard_is_per_row_tile():
    """A bound that excludes a row's own tile candidates must not stop the
    merge when another row of the tile fires: every row then takes the
    whole column tile (the reference's grain)."""
    x = np.array([[0.0], [1.0], [2.0], [10.0]], np.float32)
    ids = torch.tensor([[0, 3]], dtype=torch.int32)
    wstart = torch.tensor([0], dtype=torch.int32)
    bnd = torch.tensor([[0.5, float("inf")]])  # row 0 alone would skip
    dd, ii = knn_window_plain(torch.as_tensor(x), 4, ids, wstart, bnd, 2, 128, 1, "euclidean",
                              "diff")
    assert ii[0, 0].tolist() == [0, 1]
    bnd = torch.tensor([[0.0, 0.0]])  # no row fires: the tile is skipped
    dd, ii = knn_window_plain(torch.as_tensor(x), 4, ids, wstart, bnd, 2, 128, 1, "euclidean",
                              "diff")
    assert ii.tolist() == [[[-1, -1], [-1, -1]]] and torch.isinf(dd).all()


@pytest.mark.parametrize("d,k", [(3, 129), (129, 7), (200, 200)])
def test_rejects_k_and_d_past_128(d, k):
    """Past 128 the window scan no longer refuses (the kernel's wide mode):
    with infinite bounds every tile merges, so each slot holds the exact
    (distance, id) k-best of its window's unmasked columns, which a numpy
    lexsort gives on an integer grid. k < 1 and d < 1 are still refused."""
    rng = np.random.default_rng(d + k)
    n_all, n, col_tile, n_win = 768, 700, 256, 2
    x = rng.integers(0, 4, size=(n_all, d)).astype(np.float32)
    ids = rng.integers(0, n, size=(3, 16)).astype(np.int32)
    wstart = np.array([0, 1, 1], np.int32)
    bnd = np.full((3, 16), np.inf, np.float32)
    dd, ii = knn_window(torch.as_tensor(x), n, torch.as_tensor(ids), torch.as_tensor(wstart),
                        torch.as_tensor(bnd), k, col_tile, n_win, "euclidean", "diff")
    for t in range(3):
        cols = np.arange(wstart[t] * col_tile, min((wstart[t] + n_win) * col_tile, n))
        for s in range(16):
            dist = np.sqrt(((x[cols] - x[ids[t, s]]) ** 2).sum(-1, dtype=np.float64))
            order = np.lexsort((cols, dist))[:k]
            want_d = np.full(k, np.inf, np.float32)
            want_i = np.full(k, -1, np.int32)
            want_d[: len(order)] = dist[order].astype(np.float32)
            want_i[: len(order)] = cols[order]
            np.testing.assert_array_equal(dd[t, s].numpy(), want_d)
            np.testing.assert_array_equal(ii[t, s].numpy(), want_i)
    z = torch.zeros((1, 4))
    with pytest.raises(ValueError, match="k >= 1"):
        knn_window(torch.zeros((8, 3)), 8, torch.zeros((1, 4), dtype=torch.int32),
                   torch.zeros(1, dtype=torch.int32), z, 0, 128, 1)


def test_cuda_only_route_for_non_cpu_tensors():
    x = torch.zeros((8, 3), device="meta")
    ids = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    w = torch.zeros(1, dtype=torch.int32, device="meta")
    b = torch.zeros((1, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        knn_window(x, 8, ids, w, b, 3, 128, 1)
