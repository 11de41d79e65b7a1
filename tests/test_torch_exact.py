"""The slice end to end: the port's exact fit (``device="cpu"``, every
kernel's plain version) against the reference's ``models.exact.fit`` with
``mst_backend=device``, for ``knn_backend`` auto (XLA scan) and fused
(the Pallas kernel in interpret mode).

Integer-grid data: labels, core distances, MST, every condensed-tree field
and outlier scores are identical, and the five output files are
byte-identical. Continuous data: labels identical; core distances and MST
weights within 2 ulp of float32 (the reference's fused CPU ``sqrt`` is not
correctly rounded, the port's is).
"""

import dataclasses
import os

import numpy as np
import pytest

from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.models import exact as ref_exact
from hdbscan_tpu.models.hdbscan import write_outputs as ref_write
from hdbscan_tpu_torch.config import HDBSCANParams as PortParams
from hdbscan_tpu_torch.models import exact as port_exact
from hdbscan_tpu_torch.models.hdbscan import write_outputs as port_write
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


_TREE_FIELDS = (
    "parent", "birth", "death", "stability", "has_children", "num_members",
    "point_exit_level", "point_last_cluster", "propagated_stability",
    "lowest_child_death", "selected",
)


def _blobs(seed, n, d, scale, integer):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-3, 3, size=(5, d))
    x = centers[rng.integers(0, 5, n)] + rng.normal(0, 0.4, size=(n, d))
    x = np.concatenate([x, rng.uniform(-4, 4, size=(n // 10, d))])
    return np.round(x * scale) if integer else x


def _params(cls, tmp, name, **kw):
    return cls(input_file=os.path.join(tmp, name), out_dir=tmp, min_points=16,
               min_cluster_size=60, mst_backend="device", **kw)


@pytest.mark.parametrize("knn_backend", ["auto", "fused"])
def test_integer_grid_fit_and_files_identical(tmp_path, knn_backend):
    data = _blobs(0, 2800, 3, 8.0, integer=True)
    ref_params = _params(RefParams, str(tmp_path / "ref"), "grid.csv", knn_backend=knn_backend)
    port_params = PortParams.from_dict(
        dict(dataclasses.asdict(ref_params), out_dir=str(tmp_path / "port"))
    )
    ref = ref_exact.fit(data, ref_params)
    port = port_exact.fit(data, port_params, device="cpu")

    np.testing.assert_array_equal(port.labels, ref.labels)
    np.testing.assert_array_equal(port.core_distances, ref.core_distances)
    for a, b in zip(port.mst, ref.mst):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.outlier_scores, ref.outlier_scores)
    assert port.infinite_stability == ref.infinite_stability
    for f in _TREE_FIELDS:
        np.testing.assert_array_equal(getattr(port.tree, f), getattr(ref.tree, f), err_msg=f)
    assert len(np.unique(port.labels)) > 2  # real clusters, not all noise

    ref_paths = ref_write(ref, ref_params)
    port_paths = port_write(port, port_params)
    assert sorted(ref_paths) == sorted(port_paths)
    for kind in ref_paths:
        with open(ref_paths[kind], "rb") as a, open(port_paths[kind], "rb") as b:
            assert a.read() == b.read(), kind
        assert os.path.basename(ref_paths[kind]) == os.path.basename(port_paths[kind])


def test_continuous_fit_labels_identical():
    data = _blobs(1, 2500, 4, 1.0, integer=False)
    ref_params = RefParams(min_points=10, min_cluster_size=50, mst_backend="device")
    port_params = PortParams.from_dict(dataclasses.asdict(ref_params))
    ref = ref_exact.fit(data, ref_params)
    port = port_exact.fit(data, port_params, device="cpu")
    np.testing.assert_array_equal(port.labels, ref.labels)
    np.testing.assert_allclose(port.core_distances, ref.core_distances, rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(np.sort(port.mst[2]), np.sort(ref.mst[2]), rtol=2.5e-7, atol=0)


def test_trace_carries_the_reference_stages():
    data = _blobs(2, 600, 2, 6.0, integer=True)
    events = []
    port_exact.fit(
        data, PortParams(min_points=8, min_cluster_size=20), device="cpu",
        trace=lambda stage, **kw: events.append((stage, kw)),
    )
    stages = [s for s, _ in events]
    for name in ("core_distances", "mst_round", "forest_events", "host_sync",
                 "boruvka_mst", "tree_build_device", "tree_condense",
                 "tree_propagate", "tree_labels", "tree_glosh"):
        assert name in stages, name
    assert stages.count("host_sync") == 1
    mst = dict(events)["boruvka_mst"]
    assert mst["edges"] == len(data) - 1
    assert mst["round_syncs"] == mst["rounds"] == stages.count("mst_round")
