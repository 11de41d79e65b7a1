"""The panel segment-min (kernel B9): its plain PyTorch version (which the
CUDA kernel reproduces bitwise on the card) against the reference's
``min_outgoing_panel`` in interpret mode — resident rows against a visiting
column panel, each with its own core, label and validity vectors, the
winner's column local to the panel — and the rectangular k-best (B2) the
ring scan runs per panel against the reference's per-panel XLA tile scan.

Integer grids, so every comparison is bitwise, ids included.
"""

import numpy as np
import pytest
import torch

from hdbscan_tpu.ops.pallas_segmin import min_outgoing_panel as ref_panel
from hdbscan_tpu.ops.tiled import _knn_core_scan
from hdbscan_tpu_torch.ops.cuda_knn import knn_kbest_panel
from hdbscan_tpu_torch.ops.cuda_segmin import min_outgoing_panel, panel_form
from hdbscan_tpu_torch.ops.tiled import _min_outgoing_scan


def _side(rng, m, m_pad, d, grid, n_comp, p_valid=1.0, core_hi=3):
    x = np.zeros((m_pad, d), np.float32)
    x[:m] = rng.integers(0, grid, size=(m, d))
    core = np.zeros(m_pad, np.float32)
    core[:m] = rng.integers(0, core_hi, size=m)
    comp = rng.integers(0, n_comp, size=m_pad).astype(np.int32)
    valid = (np.arange(m_pad) < m) & (rng.random(m_pad) < p_valid)
    return x, core, comp, valid


def _both(rows, panel, metric="euclidean", row_tile=64, col_tile=128):
    rw, rj = ref_panel(*rows, *panel, metric=metric, row_tile=row_tile, col_tile=col_tile,
                       interpret=True)
    pw, pj = min_outgoing_panel(*(torch.from_numpy(a) for a in (*rows, *panel)), metric,
                                row_tile, col_tile)
    return (np.asarray(rw), np.asarray(rj)), (pw.numpy(), pj.numpy())


def _assert_same(ref, port):
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_array_equal(port[1], ref[1])


@pytest.mark.parametrize("metric", ["euclidean", "manhattan", "supremum"])
@pytest.mark.parametrize(
    "r,r_pad,c,c_pad,grid,n_comp,p_valid",
    [
        (300, 320, 200, 256, 8, 5, 1.0),      # r != c, ragged both sides, duplicates
        (120, 128, 500, 512, 4, 40, 0.9),     # invalid rows and columns, many ties
        (250, 256, 250, 256, 16, 1000, 1.0),  # every point its own component
    ],
)
def test_plain_bitwise_vs_pallas_interpret(metric, r, r_pad, c, c_pad, grid, n_comp, p_valid):
    rng = np.random.default_rng(r + c + n_comp)
    rows = _side(rng, r, r_pad, 3, grid, n_comp, p_valid)
    panel = _side(rng, c, c_pad, 3, grid, n_comp, p_valid)
    ref, port = _both(rows, panel, metric)
    _assert_same(ref, port)
    assert np.all(port[1] < c_pad)  # panel-local winners
    invalid = ~rows[3]
    assert np.all(port[1][invalid] == -1) and np.all(np.isinf(port[0][invalid]))


def test_dot_form_tiles_bitwise():
    """At 512 x 1024 tiles over the 128 padded lanes the reference takes the
    dot form, and so does the port's default."""
    assert panel_form(3, "euclidean", 512, 1024) == "dot"
    rng = np.random.default_rng(1)
    rows = _side(rng, 1000, 1024, 3, 256, 30, core_hi=40)
    panel = _side(rng, 900, 1024, 3, 256, 30, core_hi=40)
    ref, port = _both(rows, panel, row_tile=512, col_tile=1024)
    _assert_same(ref, port)


def test_all_rows_in_one_component_have_no_edge():
    rng = np.random.default_rng(2)
    rows = list(_side(rng, 100, 128, 2, 8, 1))
    panel = list(_side(rng, 100, 128, 2, 8, 1))
    rows[2][:] = 7
    panel[2][:] = 7
    ref, port = _both(tuple(rows), tuple(panel))
    _assert_same(ref, port)
    assert np.all(port[1] == -1) and np.all(np.isinf(port[0]))


def test_lattice_ties_pick_the_lowest_panel_column():
    """Every weight equal (a constant core above every distance): the
    winner is the first valid column of another component."""
    rng = np.random.default_rng(3)
    rows = list(_side(rng, 64, 64, 2, 3, 4))
    panel = list(_side(rng, 128, 128, 2, 3, 4))
    rows[1][:] = 50.0
    panel[1][:] = 50.0
    ref, port = _both(tuple(rows), tuple(panel))
    _assert_same(ref, port)
    kc, vc = panel[2], panel[3]
    for i in range(64):
        other = np.nonzero(vc & (kc != rows[2][i]))[0]
        assert port[1][i] == (other[0] if len(other) else -1)


def test_panels_with_offsets_compose_to_the_full_scan():
    """A row set scanned panel by panel (the shards' ring order, panels at
    global offsets) and combined under the explicit (w, j) update equals
    the square scan of the rows against all columns: the sharded round's
    contract."""
    rng = np.random.default_rng(4)
    n, shard = 384, 128
    x, core, comp, valid = _side(rng, n, n, 3, 6, 25)
    t = [torch.from_numpy(a) for a in (x, core, comp, valid)]
    full_w, full_j = _min_outgoing_scan(*t, "euclidean", "diff")
    for me in range(3):
        r = slice(me * shard, (me + 1) * shard)
        rows = tuple(a[r] for a in (x, core, comp, valid))
        bw = torch.full((shard,), float("inf"))
        bj = torch.full((shard,), -1, dtype=torch.int32)
        for step in range(3):
            src = (me - step) % 3
            c = slice(src * shard, (src + 1) * shard)
            panel = tuple(a[c] for a in (x, core, comp, valid))
            ref, port = _both(rows, panel)
            _assert_same(ref, port)
            pw, pj = torch.from_numpy(port[0]), torch.from_numpy(port[1])
            tj = torch.where(pj >= 0, pj + src * shard, 0)
            upd = (pw < bw) | ((pw == bw) & (tj < bj))
            bw, bj = torch.where(upd, pw, bw), torch.where(upd, tj, bj)
        assert torch.equal(bw, full_w[r])
        assert torch.equal(torch.where(torch.isinf(bw), -1, bj), full_j[r])


@pytest.mark.parametrize("k", [1, 11, 128])
def test_rectangular_kbest_vs_xla_tile_scan(k):
    """Queries against one visiting panel (ids from an offset, padding
    columns masked), in the reference's per-panel tile form; k = 128 (the
    kernel's limit) spans the reference's column tiles."""
    rng = np.random.default_rng(5 + k)
    q = rng.integers(0, 9, size=(192, 3)).astype(np.float32)
    panel = rng.integers(0, 9, size=(256, 3)).astype(np.float32)
    off, n_cols = 512, 512 + 230
    valid = (off + np.arange(256)) < n_cols
    rd, ri = _knn_core_scan(q, panel, valid, k, "euclidean", 64, 128, with_indices=True,
                            guarded=False)
    rd, ri = np.asarray(rd), np.asarray(ri)
    ri = np.where(ri >= 0, ri + off, ri)
    pd, pi = knn_kbest_panel(torch.from_numpy(q), torch.from_numpy(panel), k, "euclidean",
                             "diff", id_offset=off, n_cols=n_cols)
    np.testing.assert_array_equal(pd.numpy(), rd)
    np.testing.assert_array_equal(pi.numpy(), ri)


@pytest.mark.parametrize("k", [1, 11, 15])
def test_rectangular_kbest_split_boundary_ties(k):
    """The contract the kernel's column-split merge must keep, on the ring's
    rectangular entry: a point outside the grid planted 16 times in the
    panel at the columns 1,020-1,027 and 2,044-2,051 (equal distances on
    both sides of 1,024 and 2,048, more than k copies); queries at that
    point take its k lowest copies, ids from the offset, padding masked."""
    rng = np.random.default_rng(40 + k)
    q = rng.integers(0, 9, size=(192, 3)).astype(np.float32)
    q[::16] = 9.0
    panel = np.zeros((3072, 3), np.float32)  # the scan's whole column tiles
    panel[:2100] = rng.integers(0, 9, size=(2100, 3))
    planted = np.r_[1020:1028, 2044:2052]
    panel[planted] = 9.0
    off, n_cols = 4096, 4096 + 2090
    valid = (off + np.arange(3072)) < n_cols
    rd, ri = _knn_core_scan(q, panel, valid, k, "euclidean", 64, 1024, with_indices=True,
                            guarded=False)
    rd, ri = np.asarray(rd), np.asarray(ri)
    ri = np.where(ri >= 0, ri + off, ri)
    pd, pi = knn_kbest_panel(torch.from_numpy(q), torch.from_numpy(panel[:2100]), k,
                             "euclidean", "diff", id_offset=off, n_cols=n_cols)
    np.testing.assert_array_equal(pd.numpy(), rd)
    np.testing.assert_array_equal(pi.numpy(), ri)
    np.testing.assert_array_equal(pi.numpy()[::16], np.tile(off + planted[:k], (12, 1)))
