"""The PyTorch port as a package: it imports with JAX absent, never imports
the JAX package, carries the reference's configuration across unchanged,
and refuses what it has not ported instead of falling back.
"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu_torch.config import HDBSCANParams as PortParams
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "hdbscan_tpu_torch")

_PORT_MODULES = [
    "hdbscan_tpu_torch",
    "hdbscan_tpu_torch.__main__",
    "hdbscan_tpu_torch.cli",
    "hdbscan_tpu_torch.config",
    "hdbscan_tpu_torch.core.bubbles",
    "hdbscan_tpu_torch.core.compat",
    "hdbscan_tpu_torch.core.constraints",
    "hdbscan_tpu_torch.core.dedup",
    "hdbscan_tpu_torch.core.distances",
    "hdbscan_tpu_torch.core.knn",
    "hdbscan_tpu_torch.core.mst",
    "hdbscan_tpu_torch.core.mst_device",
    "hdbscan_tpu_torch.core.tree",
    "hdbscan_tpu_torch.core.tree_vec",
    "hdbscan_tpu_torch.fault",
    "hdbscan_tpu_torch.fault.inject",
    "hdbscan_tpu_torch.fault.policy",
    "hdbscan_tpu_torch.fleet",
    "hdbscan_tpu_torch.fleet.artifacts",
    "hdbscan_tpu_torch.fleet.controlplane",
    "hdbscan_tpu_torch.fleet.jobs",
    "hdbscan_tpu_torch.fleet.router",
    "hdbscan_tpu_torch.fleet.tenants",
    "hdbscan_tpu_torch.incremental",
    "hdbscan_tpu_torch.incremental.insert",
    "hdbscan_tpu_torch.incremental.subtree",
    "hdbscan_tpu_torch.models._finalize",
    "hdbscan_tpu_torch.models.bubble_hdbscan",
    "hdbscan_tpu_torch.models.consensus",
    "hdbscan_tpu_torch.models.exact",
    "hdbscan_tpu_torch.models.hdbscan",
    "hdbscan_tpu_torch.models.mr_hdbscan",
    "hdbscan_tpu_torch.native",
    "hdbscan_tpu_torch.obs",
    "hdbscan_tpu_torch.obs.audit",
    "hdbscan_tpu_torch.obs.correlate",
    "hdbscan_tpu_torch.obs.flightrec",
    "hdbscan_tpu_torch.obs.heartbeat",
    "hdbscan_tpu_torch.obs.roofline",
    "hdbscan_tpu_torch.obs.timeline",
    "hdbscan_tpu_torch.ops.blockscan",
    "hdbscan_tpu_torch.ops.cuda_build",
    "hdbscan_tpu_torch.ops.cuda_forest",
    "hdbscan_tpu_torch.ops.cuda_knn",
    "hdbscan_tpu_torch.ops.cuda_knn_smallest",
    "hdbscan_tpu_torch.ops.cuda_knn_window",
    "hdbscan_tpu_torch.ops.cuda_segmin",
    "hdbscan_tpu_torch.ops.lexmerge",
    "hdbscan_tpu_torch.ops.rpforest",
    "hdbscan_tpu_torch.ops.tiled",
    "hdbscan_tpu_torch.parallel.blocks",
    "hdbscan_tpu_torch.parallel.distributed",
    "hdbscan_tpu_torch.parallel.mesh",
    "hdbscan_tpu_torch.parallel.ring",
    "hdbscan_tpu_torch.parallel.shard",
    "hdbscan_tpu_torch.serve",
    "hdbscan_tpu_torch.serve.artifact",
    "hdbscan_tpu_torch.serve.batcher",
    "hdbscan_tpu_torch.serve.predict",
    "hdbscan_tpu_torch.serve.server",
    "hdbscan_tpu_torch.stream",
    "hdbscan_tpu_torch.stream.buffer",
    "hdbscan_tpu_torch.stream.drift",
    "hdbscan_tpu_torch.stream.refit",
    "hdbscan_tpu_torch.stream.wal",
    "hdbscan_tpu_torch.utils.cache",
    "hdbscan_tpu_torch.utils.checkpoint",
    "hdbscan_tpu_torch.utils.datasets",
    "hdbscan_tpu_torch.utils.evaluation",
    "hdbscan_tpu_torch.utils.flops",
    "hdbscan_tpu_torch.utils.io",
    "hdbscan_tpu_torch.utils.metrics",
    "hdbscan_tpu_torch.utils.telemetry",
    "hdbscan_tpu_torch.utils.tracing",
    "hdbscan_tpu_torch.utils.unionfind",
]


def test_module_list_covers_the_package():
    """Every module file of the port is in the JAX-blocked import list."""
    found = set()
    for root, _, names in os.walk(PORT):
        for name in names:
            if name.endswith(".py") and name != "__init__.py":
                rel = os.path.relpath(os.path.join(root, name[:-3]), REPO)
                found.add(rel.replace(os.sep, "."))
    assert found <= set(_PORT_MODULES), sorted(found - set(_PORT_MODULES))


def test_imports_with_jax_blocked():
    """Every module of the port imports in a fresh interpreter where
    ``import jax`` fails, and no module of the JAX package gets loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {_PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'hdbscan_tpu' or m.startswith('hdbscan_tpu.')]\n"
        "assert not bad, bad\n"
        "assert sys.modules['jax'] is None\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+hdbscan_tpu\b(?!_torch)"
    r"|from\s+hdbscan_tpu(\.|\s)(?!_torch))",
    re.M,
)


def _port_sources():
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py", "fit_bench.py",
                                             "handover_bench.py", "kernel_bench.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    with open(path) as f:
        src = f.read()
    assert not _FORBIDDEN.search(src), f"{path} imports jax or hdbscan_tpu"


#: The reference's TPU figures (a v5e's HBM rate and peak, one ICI link)
#: that must not carry over into the port's observability layer.
_TPU_FIGURES = re.compile(r"\b(819e9|45e9|197e12|819\.0e9|1\.97e14)\b")


@pytest.mark.parametrize(
    "path",
    [p for p in _port_sources() if os.sep + "obs" + os.sep in p or os.sep + "utils" + os.sep in p],
    ids=lambda p: os.path.relpath(p, REPO),
)
def test_observability_peaks_are_the_cards(path):
    """The roofline, timeline and MFU figures divide by the H100's peaks
    (``utils/flops.PEAK_FLOPS``, ``obs/roofline.PEAK_BYTES_S``,
    ``obs/timeline.MODEL_COMM_BYTES_S``), never by a TPU's."""
    with open(path) as f:
        assert not _TPU_FIGURES.search(f.read()), path


@pytest.mark.parametrize(
    "overrides",
    [
        {},
        {"min_points": 16, "min_cluster_size": 3000},
        {"dist_function": "manhattan", "knn_backend": "fused", "mst_backend": "device",
         "tree_backend": "reference", "compact_hierarchy": True, "input_file": "x.csv",
         "out_dir": "/tmp/o", "fault_spec": "predict_dispatch:p=0.5,count=2"},
    ],
)
def test_from_dict_round_trips_reference_params(overrides):
    ref = RefParams(**overrides)
    port = PortParams.from_dict(dataclasses.asdict(ref))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.output_path("partition") == ref.output_path("partition")


def test_from_dict_rejects_unknown_fields():
    with pytest.raises(ValueError, match="bogus"):
        PortParams.from_dict({"bogus": 1})


def test_flag_vocabulary_matches_reference():
    argv = ["file=a/b.txt", "minPts=7", "minClSize=9", "compact=true",
            "dist_function=supremum", "knn_backend=xla", "mst_backend=device"]
    assert dataclasses.asdict(PortParams.from_args(argv)) == dataclasses.asdict(
        RefParams.from_args(argv)
    )


# The bad values tests/unit/test_config.py holds the reference to, plus the
# range and fault-spec checks: the port must refuse each one too.
_BAD = [
    ("knn_backend", "cuda"), ("scan_backend", "nccl"), ("tree_backend", "gpu"),
    ("predict_backend", "onnx"), ("knn_index", "annoy"),
    ("stream_drift_stat", "chi2"), ("stream_reload", "eager"),
    ("knn_index_threshold", 0), ("rpf_trees", 0), ("rpf_leaf_size", 3),
    ("rpf_rescan_rounds", -1), ("stream_absorb_eps_frac", -0.1),
    ("stream_drift_threshold", 0.0), ("stream_refit_budget", 0),
    ("trace_max_events", -1), ("fleet_policy", "random"),
    ("stream_maintain", "lazy"), ("maintain_budget_ms", -1.0),
    ("maintain_dirty_max_frac", 0.0), ("dist_function", "hamming"),
    ("min_points", 0), ("mst_backend", "gpu"), ("fit_sharding", "x"),
    ("fault_spec", "nosuchsite"), ("fault_spec", "predict_dispatch:p=2"),
    ("fault_spec", "predict_dispatch:bogus=1"),
]


@pytest.mark.parametrize("field,bad", _BAD, ids=lambda v: str(v))
def test_rejects_the_reference_bad_values(field, bad):
    with pytest.raises(ValueError):
        RefParams(**{field: bad})
    with pytest.raises(ValueError):
        PortParams(**{field: bad})


def test_fit_without_a_card_raises():
    """The entry point runs on the card unless told otherwise; with no card
    it raises instead of continuing on the CPU."""
    from hdbscan_tpu_torch.models import exact

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the fit would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        exact.fit(np.zeros((4, 2)), PortParams(min_points=2, min_cluster_size=2))


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """A kernel wrapper takes its plain version only for CPU tensors; any
    other device must reach the kernel or raise."""
    from hdbscan_tpu_torch.core.mst_device import uf_scan
    from hdbscan_tpu_torch.ops.cuda_knn import knn_kbest, knn_kbest_panel
    from hdbscan_tpu_torch.ops.cuda_knn_smallest import knn_smallest
    from hdbscan_tpu_torch.ops.cuda_segmin import min_outgoing_all_rows, min_outgoing_panel

    x = torch.zeros((8, 3), device="meta")
    side = (x, torch.zeros(8, device="meta"), torch.zeros(8, dtype=torch.int32, device="meta"),
            torch.ones(8, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        knn_kbest(x, 3)
    with pytest.raises(ValueError, match="CUDA"):
        knn_kbest_panel(x, x, 3)
    with pytest.raises(ValueError, match="CUDA"):
        knn_smallest(x, 3, "dot")
    with pytest.raises(ValueError, match="CUDA"):
        min_outgoing_all_rows(*side, "euclidean", 8, 128)
    with pytest.raises(ValueError, match="CUDA"):
        min_outgoing_panel(*side, *side)
    with pytest.raises(ValueError, match="CUDA"):
        uf_scan(torch.zeros(4, dtype=torch.int32, device="meta"),
                torch.zeros(4, dtype=torch.int32, device="meta"), 8)
    # One launch never mixes devices: a CPU tensor beside the others is
    # refused as well.
    with pytest.raises(ValueError, match="CUDA"):
        min_outgoing_panel(*side, torch.zeros((8, 3)), *side[1:])


@pytest.mark.parametrize(
    "overrides",
    [{"fit_sharding": "sharded", "knn_index": "rpforest", "mst_backend": "host"}],
    ids=["sharded_rpforest"],
)
def test_once_refused_routes_match_reference(overrides):
    """The sharded fit's rp-forest tier, once refused: the reference's fit
    on two of its devices and the port's on two CPU shards give the same
    labels and core distances (integer grid, d = 3)."""
    import jax

    from hdbscan_tpu.models import exact as ref_exact
    from hdbscan_tpu.parallel.mesh import get_mesh as ref_get_mesh
    from hdbscan_tpu_torch.models import exact
    from hdbscan_tpu_torch.parallel.mesh import get_mesh

    data = np.random.default_rng(0).integers(0, 12, size=(400, 3)).astype(float)
    kw = dict(min_points=5, min_cluster_size=10, rpf_trees=2, rpf_leaf_size=32, **overrides)
    ref = ref_exact.fit(data, RefParams(**kw), mesh=ref_get_mesh(jax.devices()[:2]))
    port = exact.fit(data, PortParams(**kw), mesh=get_mesh([torch.device("cpu")] * 2))
    np.testing.assert_array_equal(port.core_distances, ref.core_distances)
    np.testing.assert_array_equal(port.labels, ref.labels)


@pytest.mark.parametrize(
    "overrides",
    [{"mst_backend": "host"}, {"dedup_points": True}, {"scan_backend": "ring"}],
    ids=["mst_backend_host", "dedup_points", "scan_backend_ring"],
)
def test_formerly_refused_routes_match_reference(overrides):
    """The three exact routes the port used to refuse now run and give the
    reference's fit (a grid with duplicate rows: bitwise)."""
    from hdbscan_tpu.config import HDBSCANParams as RefParams
    from hdbscan_tpu.models import exact as ref_exact
    from hdbscan_tpu_torch.models import exact

    data = np.round(np.random.default_rng(0).normal(size=(400, 2)) * 4.0)
    kw = dict(min_points=5, min_cluster_size=10, **overrides)
    port = exact.fit(data, PortParams(**kw), device="cpu")
    ref = ref_exact.fit(data, RefParams(**kw))
    np.testing.assert_array_equal(port.labels, ref.labels)
    np.testing.assert_array_equal(port.core_distances, ref.core_distances)
    for a, b in zip(port.mst, ref.mst):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.outlier_scores, ref.outlier_scores)
