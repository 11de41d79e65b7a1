"""The port's command line over real rank processes (``clusterName=``,
``parallel/distributed``), on the CPU over gloo.

The counterpart of the reference's ``tests/e2e/test_multiprocess.py``: the
same command run as 2 ranks x ``--device cpu,cpu`` and as 4 ranks x
``--device cpu`` writes five files byte-identical to the port's one process
over ``--device cpu,cpu,cpu,cpu`` and to the reference CLI on the same flags
(``jax.enable_x64(False)``, its production float32; on the exact-sharded
route the reference's ``exact.fit`` plus ``write_outputs`` in process, as
``tests/test_torch_cli.py`` holds it). Three legs: the reference test's own
flags (the MR route), ``fit_sharding=sharded`` (mr-sharded) and the exact
route with ``fit_sharding=sharded processing_units=n``. Only rank 0 prints
the result and writes; its stderr names the global mesh; every rank's
trace passes ``scripts/check_trace.py``; the report merges every rank's
phases under ``per_host`` and its manifest's topology names each device's
rank. A ``scan_backend=ring`` fit over two ranks equals its one-process twin
and its ring events count the bytes the mesh's helpers handed over.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from hdbscan_tpu.cli import main as ref_main
from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.models import exact as ref_exact
from hdbscan_tpu.models.hdbscan import write_outputs as ref_write
from hdbscan_tpu.utils.io import load_points as ref_load
from hdbscan_tpu_torch.cli import main as port_main
from hdbscan_tpu_torch.parallel.distributed import (
    communicate_all,
    free_local_port,
    hermetic_child_env,
)
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECK_TRACE = os.path.join(REPO, "scripts", "check_trace.py")
N = 1200
#: The reference test's flags (tests/e2e/test_multiprocess.py:70-80).
MR_FLAGS = ["minPts=4", "minClSize=50", "processing_units=256", "k=0.1", "seed=3"]
LEGS = {
    "mr": (MR_FLAGS, "mr (3 levels)"),
    "mr_sharded": (MR_FLAGS + ["fit_sharding=sharded"], "mr-sharded (3 levels)"),
    "exact_sharded": (["minPts=4", "minClSize=50", "fit_sharding=sharded",
                       f"processing_units={N}"], "exact-sharded"),
}


@pytest.fixture(scope="module")
def blobs_file(tmp_path_factory):
    """The reference test's three blobs of 400 points, on an integer grid
    (ten units a reference unit), so both packages compute every distance
    exactly."""
    rng = np.random.default_rng(7)
    pts = np.concatenate([np.round(rng.normal(c, 4.0, size=(400, 3)))
                          for c in ((0, 0, 0), (80, 0, 0), (0, 80, 80))])
    path = tmp_path_factory.mktemp("blobs") / "blobs.txt"
    np.savetxt(path, pts, fmt="%d")
    return str(path)


def _files(out_dir) -> dict:
    out = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.fixture(scope="module")
def twins(blobs_file, tmp_path_factory):
    """Per leg, the five files of the port's one process over four CPU
    shards and of the reference, computed once for the module."""
    cache = {}

    def get(leg):
        if leg not in cache:
            flags, mode = LEGS[leg]
            root = tmp_path_factory.mktemp(leg)
            argv = ["fit", f"file={blobs_file}", *flags]
            assert port_main(argv + [f"out_dir={root / 'one'}", "--device",
                                     "cpu,cpu,cpu,cpu"]) == 0
            with jax.enable_x64(False):
                if leg == "exact_sharded":
                    params = RefParams.from_args(argv[1:] + [f"out_dir={root / 'ref'}"])
                    ref_write(ref_exact.fit(ref_load(blobs_file), params), params)
                else:
                    assert ref_main(argv + [f"out_dir={root / 'ref'}"]) == 0
            cache[leg] = (_files(root / "one"), _files(root / "ref"))
        return cache[leg]

    return get


def _run_ranks(n_ranks, device, argv, root):
    """The command as ``n_ranks`` rank processes on a local coordinator:
    [(returncode, stdout, stderr)] in rank order."""
    port = free_local_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "hdbscan_tpu_torch", *argv,
             f"clusterName=127.0.0.1:{port},{r},{n_ranks}", "--device", device,
             "--trace-out", str(root / "trace.jsonl"), "--report", str(root / "report.json")],
            env=hermetic_child_env(REPO), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(n_ranks)
    ]
    outs = communicate_all(procs, timeout=120)
    return [(p.returncode, so, se) for p, (so, se) in zip(procs, outs)]


def _check_trace(*paths):
    out = subprocess.run([sys.executable, CHECK_TRACE, *paths], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("n_ranks,device", [(2, "cpu,cpu"), (4, "cpu")],
                         ids=["2x2", "4x1"])
@pytest.mark.parametrize("leg", list(LEGS))
def test_ranks_write_the_one_process_files(blobs_file, twins, tmp_path, leg, n_ranks, device):
    flags, mode = LEGS[leg]
    one, ref = twins(leg)
    assert sorted(one) == sorted(ref) and len(ref) == 5
    for name in ref:
        assert one[name] == ref[name], name
    out_dir = tmp_path / "out"
    ranks = _run_ranks(n_ranks, device, ["fit", f"file={blobs_file}", *flags,
                                         f"out_dir={out_dir}"], tmp_path)
    for r, (rc, _, se) in enumerate(ranks):
        assert rc == 0, f"rank {r}:\n{se[-3000:]}"
    # Rank 0 alone prints and writes; its stderr names the global mesh.
    assert f", {mode}" in ranks[0][1].splitlines()[0]
    for _, so, _ in ranks[1:]:
        assert "hdbscan-tpu" not in so and mode not in so
    assert f"{n_ranks} processes" in ranks[0][2] and "4 devices" in ranks[0][2]
    assert "gloo hand-overs" in ranks[0][2]
    got = _files(out_dir)
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert got[name] == ref[name], name
    traces = [str(tmp_path / f"trace.{r}.jsonl") for r in range(n_ranks)]
    _check_trace(traces[0], str(tmp_path / "report.json"))
    for path in traces[1:]:
        _check_trace(path)
    with open(tmp_path / "report.json", encoding="utf-8") as f:
        report = json.load(f)
    assert sorted(report["per_host"]) == [str(r) for r in range(n_ranks)]
    assert all("fit" in report["per_host"][str(r)] for r in range(n_ranks))
    topo = report["manifest"]["topology"]
    assert topo["process_count"] == n_ranks and topo["process_index"] == 0
    assert topo["device_count"] == 4 and topo["local_device_count"] == 4 // n_ranks
    assert [d["process_index"] for d in topo["devices"]] == [i * n_ranks // 4 for i in range(4)]


def test_ring_over_ranks_equals_one_process_and_hands_over(blobs_file, tmp_path):
    """``scan_backend=ring`` (the ring k-NN cores and the ring glue) over
    two ranks of two CPU shards writes the one-process twin's files; the
    ring events of the two traces carry the bytes the mesh's helpers
    handed over between the ranks, and their wall."""
    argv = ["fit", f"file={blobs_file}", *MR_FLAGS, "scan_backend=ring"]
    assert port_main(argv + [f"out_dir={tmp_path / 'one'}", "--device", "cpu,cpu,cpu,cpu"]) == 0
    ranks = _run_ranks(2, "cpu,cpu", argv + [f"out_dir={tmp_path / 'out'}"], tmp_path)
    for r, (rc, _, se) in enumerate(ranks):
        assert rc == 0, f"rank {r}:\n{se[-3000:]}"
    assert _files(tmp_path / "out") == _files(tmp_path / "one")
    moved, stages = 0, set()
    for r in range(2):
        path = tmp_path / f"trace.{r}.jsonl"
        _check_trace(str(path))
        with open(path, encoding="utf-8") as f:
            for line in f:
                ev = json.loads(line)
                if ev["stage"] in ("ring_knn_scan", "ring_boruvka_scan"):
                    assert "handover_s" in ev
                    moved += ev.get("comm_bytes", 0)
                    stages.add(ev["stage"])
    assert stages == {"ring_knn_scan", "ring_boruvka_scan"} and moved > 0


def test_forest_over_ranks_exits_2_before_reading_data(tmp_path):
    """``knn_index=rpforest`` over ranks (ROADMAP A9c) exits 2 on every
    rank before any data is read, never runs wrong."""
    ranks = _run_ranks(2, "cpu", ["fit", f"file={tmp_path / 'absent.tsv'}", *MR_FLAGS,
                                  "knn_index=rpforest", f"out_dir={tmp_path / 'out'}"],
                       tmp_path)
    for rc, so, se in ranks:
        assert rc == 2 and "(ROADMAP A9c)" in se and "hdbscan-tpu:" not in so
    assert not os.path.exists(tmp_path / "out")
