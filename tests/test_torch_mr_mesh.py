"""``models/mr_hdbscan.fit`` over a mesh of CPU shards against the
reference's ``fit(mesh=...)`` on as many of its forced CPU devices: the
sharded engine (``fit_sharding=sharded``), the ring (``scan_backend=ring``)
and the host engine over a mesh (block batches split over the shards), each
in the default and the boundary mode, the two forest tiers
(``knn_index=rpforest``). Labels, probabilities (the tree's per-point
exit levels), outlier scores, core distances and the five files are equal.
The dedup and consensus paths pass the mesh through: over shards they
equal the port's own one-device fits, which their own files hold to the
reference.

Each configuration is fitted once per module (the ``fits`` fixture). The
reference runs under the suite's ``jax_enable_x64``, so the port's block
programs take ``dtype=np.float64``; the data lie on an integer grid.
"""

import numpy as np
import pytest
import torch

import jax

from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.models import mr_hdbscan as ref_mr
from hdbscan_tpu.models.hdbscan import write_outputs as ref_write
from hdbscan_tpu.parallel.mesh import get_mesh as ref_get_mesh
from hdbscan_tpu_torch.config import HDBSCANParams as PortParams
from hdbscan_tpu_torch.models import mr_hdbscan as port_mr
from hdbscan_tpu_torch.models.hdbscan import write_outputs as port_write
from hdbscan_tpu_torch.parallel.mesh import get_mesh


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch intra-op thread for the module: the suite runs six
    workers at once, and a worker's small torch ops spread over every core
    only contend with the others'. The port's other test files import
    this fixture, which applies to each importing module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = dict(min_points=8, min_cluster_size=30, processing_units=512, k=0.05, seed=0)
FOREST = dict(knn_index="rpforest", rpf_trees=2, rpf_leaf_size=128)
BOUNDARY = dict(boundary_quality=0.05)

#: name -> (shards, params over BASE).
CONFIGS = {
    "sharded": (4, dict(fit_sharding="sharded")),
    "sharded_boundary": (4, dict(fit_sharding="sharded", **BOUNDARY)),
    "ring": (3, dict(scan_backend="ring")),
    "ring_boundary": (3, dict(scan_backend="ring", **BOUNDARY)),
    "replicated": (2, dict(fit_sharding="replicated")),
    "replicated_boundary": (2, dict(fit_sharding="replicated", **BOUNDARY)),
    "sharded_rpforest": (4, dict(fit_sharding="sharded", **FOREST)),
    "ring_rpforest": (4, dict(scan_backend="ring", **FOREST)),
}


@pytest.fixture(scope="module")
def data():
    """3,000 points on an integer grid: six blobs and uniform noise."""
    rng = np.random.default_rng(0)
    centres = rng.integers(0, 60, size=(6, 3))
    blobs = [c + rng.integers(-4, 5, size=(400, 3)) for c in centres]
    return np.concatenate(blobs + [rng.integers(0, 64, size=(600, 3))]).astype(np.float64)


@pytest.fixture(scope="module")
def fits(data, tmp_path_factory):
    """Each configuration's (port, ref, port events) fitted on first use,
    with both results' five files written."""
    cache = {}

    def get(name):
        if name not in cache:
            n_dev, extra = CONFIGS[name]
            kw = {**BASE, **extra}
            events = {}
            ref = ref_mr.fit(data, RefParams(**kw), mesh=ref_get_mesh(jax.devices()[:n_dev]))
            port = port_mr.fit(data, PortParams(**kw), dtype=np.float64,
                               mesh=get_mesh([torch.device("cpu")] * n_dev),
                               trace=lambda s, **f: events.setdefault(s, []).append(f))
            out = tmp_path_factory.mktemp(name)
            files = {}
            for tag, write, res, cls in (("ref", ref_write, ref, RefParams),
                                         ("port", port_write, port, PortParams)):
                paths = write(res, cls(**kw, out_dir=str(out / tag)))
                files[tag] = {k: open(p, "rb").read() for k, p in paths.items()}
            cache[name] = (port, ref, events, files)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fit_equals_reference(fits, name):
    port, ref, _, _ = fits(name)
    np.testing.assert_array_equal(port.labels, ref.labels)
    np.testing.assert_array_equal(port.outlier_scores, ref.outlier_scores)
    np.testing.assert_array_equal(port.core_distances, ref.core_distances)
    np.testing.assert_array_equal(port.tree.point_exit_level, ref.tree.point_exit_level)
    assert port.n_levels == ref.n_levels and port.n_edges == ref.n_edges
    assert len(np.unique(port.labels)) >= 3


@pytest.mark.parametrize("name", list(CONFIGS))
def test_five_files_equal_reference(fits, name):
    _, _, _, files = fits(name)
    assert sorted(files["port"]) == sorted(files["ref"])
    assert len(files["ref"]) == 5
    for key in files["ref"]:
        assert files["port"][key] == files["ref"][key], key


@pytest.mark.parametrize(
    "name,stages",
    [
        ("sharded", {"ring_knn_scan", "shard_boruvka_scan", "block_fit"}),
        ("sharded_boundary", {"ring_rows_scan", "shard_boruvka_scan", "boundary_phase"}),
        ("ring", {"ring_knn_scan", "ring_boruvka_scan"}),
        ("ring_boundary", {"knn_window_scan", "glue_round"}),
        ("sharded_rpforest", {"shard_knn_build", "shard_panel_sweep", "shard_knn_exchange"}),
        ("ring_rpforest", {"knn_index_build", "knn_index_query", "ring_boruvka_scan"}),
    ],
)
def test_engines_run_their_scans(fits, name, stages):
    _, _, events, _ = fits(name)
    assert stages <= set(events), sorted(events)
    if name.startswith("sharded"):
        assert "boruvka_round" not in events
    if name == "sharded_boundary":  # the full sweep: no pruned glue
        assert not events["boundary_select"][0]["pruned"]
        assert "glue_round" not in events


def test_sharded_boundary_equals_unpruned_one_device_fit(fits, data):
    """The sharded boundary fit takes the full-sweep glue, so it equals the
    one-device ``boundary_block_pruning=False`` fit (not the default pruned
    one)."""
    port, _, _, _ = fits("sharded_boundary")
    kw = {**BASE, **BOUNDARY, "boundary_block_pruning": False}
    one = port_mr.fit(data, PortParams(**kw), device="cpu", dtype=np.float64)
    np.testing.assert_array_equal(port.labels, one.labels)
    np.testing.assert_array_equal(port.outlier_scores, one.outlier_scores)
    np.testing.assert_array_equal(port.core_distances, one.core_distances)


def test_ring_forest_fit_equals_one_device_forest_fit(fits, data):
    port, _, _, _ = fits("ring_rpforest")
    one = port_mr.fit(data, PortParams(**BASE, **FOREST), device="cpu", dtype=np.float64)
    np.testing.assert_array_equal(port.labels, one.labels)
    np.testing.assert_array_equal(port.core_distances, one.core_distances)


@pytest.mark.parametrize(
    "extra",
    [dict(fit_sharding="sharded", dedup_points=True),
     dict(scan_backend="ring", consensus_draws=2)],
    ids=["sharded_dedup", "ring_consensus"],
)
def test_dedup_and_consensus_pass_the_mesh(data, extra):
    """Over four CPU shards the dedup and consensus fits run their scans on
    the mesh and equal the one-device fits."""
    kw = {**BASE, **extra}
    events = set()
    got = port_mr.fit(data, PortParams(**kw), dtype=np.float64,
                      mesh=get_mesh([torch.device("cpu")] * 4),
                      trace=lambda s, **f: events.add(s))
    one = port_mr.fit(data, PortParams(**{**kw, "fit_sharding": "replicated",
                                          "scan_backend": "host"}),
                      device="cpu", dtype=np.float64)
    np.testing.assert_array_equal(got.labels, one.labels)
    np.testing.assert_array_equal(got.outlier_scores, one.outlier_scores)
    assert got.consensus_info == one.consensus_info
    assert ("ring_knn_scan" if "dedup_points" in extra else "ring_boruvka_scan") in events
