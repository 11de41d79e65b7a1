"""Operation and byte counts of the launches at small hand-checked shapes."""

import numpy as np
import pytest

from portbench import roofline as rf


def test_pair_ops():
    assert rf.pair_ops(3, "diff") == 8  # 3 sub + 3 mul + 2 add
    assert rf.pair_ops(3, "dot") == 8  # 3 mul + 2 add + 3
    assert rf.pair_ops(28, "dot") == 58


def test_kbest_square():
    # K2: 1,000 rows, d 3, k 15, dot form: 1e6 pairs x 9 ops; bytes: points
    # read once, (distance, id) lists written once.
    got = rf.kbest_bound("knn_kbest", (None, 1000, 3, 15, 1, 4))
    assert got == pytest.approx(max(9e6 / 67e12, (12_000 + 120_000) / 3.35e12))
    assert got == pytest.approx(9e6 / 67e12)


def test_kbest_panel_and_smallest():
    got = rf.kbest_bound("knn_kbest_panel", (None, 256, None, 245_057, 3, 15, 1, 0, 4))
    assert got == pytest.approx(256 * 245_057 * 9 / 67e12)
    # B3: squared dot form (code 5), no ids: 100 x 100 pairs x 59 ops.
    got = rf.kbest_bound("knn_smallest", (None, 100, 28, 7, 5, 1))
    assert got == pytest.approx(max(1e4 * 59 / 67e12, (100 * 28 * 4 + 100 * 7 * 4) / 3.35e12))


def test_cross_pairs():
    comp = np.array([0, 0, 1, 2])
    allv = np.ones(4, bool)
    assert rf.cross_pairs(comp, allv, comp, allv) == 16 - (4 + 1 + 1)
    v = np.array([True, True, True, False])
    assert rf.cross_pairs(comp, v, comp, v) == 9 - (4 + 1)
    assert rf.cross_pairs(np.array([0, 1]), np.ones(2, bool), np.array([1, 1, 2]),
                          np.ones(3, bool)) == 6 - 2


def test_segmin_bound_counts_only_cross_pairs():
    comp = np.array([0, 0, 1, 2])
    allv = np.ones(4, bool)
    got = rf.segmin_bound(3, 0, comp, allv, comp, allv)
    assert got == pytest.approx(max(10 * 11 / 67e12, (4 * 21 * 2 + 32) / 3.35e12))
    one = np.zeros(4, np.int64)  # one component: nothing to scan
    assert rf.segmin_bound(3, 0, one, allv, one, allv) == pytest.approx((4 * 21 * 2 + 32)
                                                                        / 3.35e12)


def test_share():
    assert rf.share(1.0, 4.0) == 25.0
    assert rf.share(1.0, 0.0) is None


def test_launch_recorder_keeps_only_the_named_launches(monkeypatch):
    from hdbscan_tpu_torch.ops import cuda_build
    from portbench.recorder import LaunchRecorder

    ran = []
    monkeypatch.setattr(cuda_build, "launch", lambda name, device, *args: ran.append(name))
    with LaunchRecorder(("knn_kbest", "knn_smallest")) as rec:
        cuda_build.launch("knn_kbest", "cuda:0", 1, 1000, 3, 15, 1)
        cuda_build.launch("segmin", "cuda:0", 2)
        cuda_build.launch("knn_smallest", "cuda:0", 3, 100, 28, 7, 5)
    cuda_build.launch("knn_kbest", "cuda:0", 4)  # after the block: not recorded
    assert ran == ["knn_kbest", "segmin", "knn_smallest", "knn_kbest"]
    assert rec.count == 3
    assert rec.launches == [("knn_kbest", (1, 1000, 3, 15, 1)),
                            ("knn_smallest", (3, 100, 28, 7, 5))]
