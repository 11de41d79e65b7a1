"""The cross-tree fold (B6) and the candidate segment-min (B8): their plain
versions, which the CUDA kernels reproduce bitwise on the card, against the
reference's Pallas kernels in interpret mode, on numpy-seeded inputs.

B6 is a fold over the trees in order, not a dedup of the concatenated lists:
where one id's copies carry different distances in different trees (the bf16
forest, whose leaves are centred on their own means), a later, smaller copy
enters beside the earlier one. The stacks here hold such copies, sentinel
tails of unequal length and entries at +inf with a real id; they are held
bitwise at T in {1, 3, 65} and kk in {1, 15, 129}.

B8's tolerances: f32 on an integer grid is bitwise. bf16 centres on the
port's own row-tile means, the reference's on its zero-padded tiles, and
the two sum the cross term in other orders; so weights agree within one
bf16 ulp of an operand (rtol 2^-8) and ids on at least 99% of rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdbscan_tpu.ops import pallas_forest as pf
from hdbscan_tpu_torch.ops import cuda_forest as cf
from hdbscan_tpu_torch.ops import lexmerge as port_lex
from tests.conftest import make_blobs
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


#: The reference's merge over row tiles of 8 (the kernel's contract does not
#: depend on the tile; a small tile keeps interpret mode quick).
REF_ROW_TILE = 8


def fold_stacks(rng, n: int, trees: int, kk: int):
    """(T, n, kk) per-tree lists as B6 takes them, each ascending by
    (distance, id) with (+inf, n) tails: every row of every tree draws
    between 0 and kk distinct ids from a pool of about 2 kk, so one id
    recurs across trees, each copy with its own integer distance in [0, 8)
    (exact ties and copies that differ); a fifth of the lists end their real
    entries at +inf. Where it fits, row 0 holds the two-tree example whose
    fold keeps one id twice (see ``test_fold_keeps_a_smaller_later_copy``),
    its other trees' lists empty."""
    sentinel = n
    pool = min(n, max(2 * kk, 8))
    sd = np.full((trees, n, kk), np.inf, np.float32)
    si = np.full((trees, n, kk), sentinel, np.int32)
    for t in range(trees):
        for r in range(n):
            m = int(rng.integers(0, kk + 1))
            ids = rng.choice(pool, size=min(m, pool), replace=False).astype(np.int32)
            d = rng.integers(0, 8, size=len(ids)).astype(np.float32)
            if len(ids) and rng.random() < 0.2:
                d[-1] = np.inf
            order = np.lexsort((ids, d))
            sd[t, r, :len(ids)] = d[order]
            si[t, r, :len(ids)] = ids[order]
    if trees >= 2 and kk >= 3 and n > 5:
        sd[:, 0], si[:, 0] = np.inf, sentinel  # the other trees' row 0 empty
        sd[:2, 0, :3], si[:2, 0, :3] = example_lists()
    return sd, si, sentinel


def example_lists():
    """Two trees' lists of one row: tree 0 (1, 1) (5, 4) (6, 2), tree 1
    (2, 3) (3, 4) (7, 5); id 4 stands at 5 in tree 0 and at 3 in tree 1."""
    return (np.array([[1, 5, 6], [2, 3, 7]], np.float32),
            np.array([[1, 4, 2], [3, 4, 5]], np.int32))


def _reference_fold(sd, si, kk, sentinel):
    return pf.forest_merge_pallas(jnp.asarray(sd), jnp.asarray(si), kk, sentinel,
                                  row_tile=REF_ROW_TILE, interpret=True)


def _assert_bitwise(got, ref):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))


@pytest.mark.parametrize("kk", [1, 15, 129])
@pytest.mark.parametrize("trees", [1, 3, 65])
def test_fold_matches_pallas(trees, kk):
    """B6's plain version == ``forest_merge_pallas`` (interpret), bitwise, on
    stacks with differing cross-tree copies, unequal sentinel tails and
    +inf entries with real ids, at 1, 3 and 65 trees (the card's kernel
    takes any tree count)."""
    rng = np.random.default_rng(100 * trees + kk)
    n = 140 if kk > 15 else 48
    sd, si, sentinel = fold_stacks(rng, n, trees, kk)
    got = cf.forest_merge(torch.as_tensor(sd), torch.as_tensor(si), kk, sentinel)
    _assert_bitwise(got, _reference_fold(sd, si, kk, sentinel))
    # Every list ascends and a real id never rides an infinite distance.
    d, i = got[0].numpy(), got[1].numpy()
    assert np.all(d[:, 1:] >= d[:, :-1])
    assert np.all(i[np.isinf(d)] == sentinel)


def test_fold_keeps_a_smaller_later_copy():
    """The example of the fold: id 4 enters at 5 from tree 0 and again at 3
    from tree 1; the plain version and the reference keep both copies. The
    dedup lex merge of the concatenated lists keeps only the smaller copy,
    which is why the kernel must fold and not dedup."""
    n, kk = 10, 5
    sd = np.full((2, n, kk), np.inf, np.float32)
    si = np.full((2, n, kk), n, np.int32)
    ex_d, ex_i = example_lists()
    sd[:, 0, :3], si[:, 0, :3] = ex_d, ex_i
    got = cf.forest_merge(torch.as_tensor(sd), torch.as_tensor(si), kk, n)
    _assert_bitwise(got, _reference_fold(sd, si, kk, n))
    np.testing.assert_array_equal(got[0][0].numpy(), [1, 2, 3, 5, 6])
    np.testing.assert_array_equal(got[1][0].numpy(), [1, 3, 4, 4, 2])
    cat = port_lex.dedup_lex_merge(torch.as_tensor(np.concatenate(sd, 1)),
                                   torch.as_tensor(np.concatenate(si, 1)), kk, n)
    np.testing.assert_array_equal(cat[0][0].numpy(), [1, 2, 3, 6, 7])
    np.testing.assert_array_equal(cat[1][0].numpy(), [1, 3, 4, 2, 5])
    assert not torch.equal(cat[1], got[1])


def test_fold_of_equal_copies_is_the_dedup():
    """Where every copy of a pair carries one distance (f32 forests: the
    same two points through the same arithmetic), the fold equals the dedup
    lex merge of the concatenated lists."""
    rng = np.random.default_rng(7)
    n, trees, kk = 60, 4, 6
    dist = rng.integers(0, 8, size=(n, n)).astype(np.float32)
    sd = np.full((trees, n, kk), np.inf, np.float32)
    si = np.full((trees, n, kk), n, np.int32)
    for t in range(trees):
        for r in range(n):
            ids = rng.choice(n, size=int(rng.integers(0, kk + 1)), replace=False)
            order = np.lexsort((ids, dist[r, ids]))
            sd[t, r, :len(ids)] = dist[r, ids[order]]
            si[t, r, :len(ids)] = ids[order]
    got = cf.forest_merge(torch.as_tensor(sd), torch.as_tensor(si), kk, n)
    cat = port_lex.dedup_lex_merge(torch.as_tensor(np.concatenate(sd, 1)),
                                   torch.as_tensor(np.concatenate(si, 1)), kk, n)
    _assert_bitwise(got, cat)


def _minout_args(data, cand, core, comp):
    n = len(data)
    dd, cids = jnp.asarray(data), jnp.asarray(cand)
    clip = jnp.clip(cids, 0, n - 1)
    return (dd, dd[clip], cids, jnp.asarray(core), jnp.asarray(core)[clip], jnp.asarray(comp),
            jnp.where(cids == n, -1, jnp.asarray(comp)[clip]))


def _port_minout(data, cand, core, comp, precision="f32"):
    t = torch.as_tensor
    return cf.forest_min_outgoing(t(data), t(data), t(cand), t(core), t(core), t(comp), t(comp),
                                  "euclidean", len(data), precision)


@pytest.mark.parametrize("n,d,c", [(160, 8, 40), (96, 5, 30), (200, 3, 64)])
def test_min_outgoing_bf16_matches_pallas(n, d, c):
    """B8's plain version in bf16 == ``forest_min_outgoing(precision="bf16")``
    (interpret) within one bf16 ulp of an operand, ids on 99% of rows; the
    bf16 weights are not the f32 ones (the mode is on)."""
    rng = np.random.default_rng(40 + d)
    data = make_blobs(rng, n=n, d=d, centers=4)[0].astype(np.float32)
    cand = rng.integers(0, n, size=(n, c)).astype(np.int32)
    cand[:5, -3:] = n
    core = (rng.random(n) * 0.5).astype(np.float32)
    comp = rng.integers(0, 6, size=n).astype(np.int32)
    args = _minout_args(data, cand, core, comp)
    ref = pf.forest_min_outgoing(*args, precision="bf16", sentinel=n, interpret=True)
    got = _port_minout(data, cand, core, comp, "bf16")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=2.0 ** -8, atol=0)
    assert np.mean(got[1].numpy() == np.asarray(ref[1])) >= 0.99
    f32 = _port_minout(data, cand, core, comp)
    assert not torch.equal(got[0], f32[0])


def test_min_outgoing_first_minimal_column_on_ties():
    """Exact ties on an integer grid: where several candidates of another
    component share the row's minimum weight, the first such panel column
    wins (the reference's argmin), bitwise against the reference; rows
    whose candidates all lie in their own component give (+inf, -1)."""
    rng = np.random.default_rng(41)
    n, c = 120, 48
    data = rng.integers(0, 3, size=(n, 3)).astype(np.float32)
    cand = rng.integers(0, n, size=(n, c)).astype(np.int32)
    cand[:, ::5] = cand[:, :1]  # one id copied through the row
    cand[:4, -6:] = n
    core = rng.integers(0, 3, size=n).astype(np.float32)
    core[:20] = 9.0  # the row's own core dominates: every outgoing weight ties
    comp = rng.integers(0, 3, size=n).astype(np.int32)
    comp[30] = 7
    cand[30] = 30  # only itself: no outgoing candidate
    ref = pf.forest_min_outgoing(*_minout_args(data, cand, core, comp), sentinel=n,
                                 interpret=True)
    got = _port_minout(data, cand, core, comp)
    _assert_bitwise(got, ref)
    for r in range(20):
        out = [j for j in range(c) if cand[r, j] != n and comp[cand[r, j]] != comp[r]]
        assert got[0][r] == 9.0 and got[1][r] == cand[r, out[0]]
    assert got[1][30] == -1 and torch.isinf(got[0][30])
