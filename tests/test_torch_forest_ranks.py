"""The rp-forest over real rank processes (``clusterName=``,
``parallel/distributed``), on the CPU over gloo.

Both forest engines run over a mesh whose shards live in several
processes: the row-sharded forest (``parallel/shard.
shard_forest_core_distances``: each rank builds its own shards' trees, the
visiting panels travel by ``ring_shift``) and the forest over the mesh
(``ops/rpforest.rpforest_core_distances(mesh=...)``: every rank builds the
same forest, scans its own shards' leaf slices, and the leaf lists and the
rescans' id lists are all-gathered). Over ranks each equals the port's one
process at the same global shard count, bitwise; the sharded forest at f32
euclidean also equals the reference's at four shards, and the forest over
the mesh equals the one-device forest, ids included.

A library worker of 2 ranks x 2 CPU shards runs each call once; the
command line runs as 2 ranks x ``--device cpu,cpu`` (and 4 x ``cpu``), its
five files byte-identical to one process over ``--device cpu,cpu,cpu,cpu``:
the forest routes (exact-sharded, the sharded unpruned boundary MR fit, the
ring, ``knn_index=auto`` past its threshold) and three configurations
without the forest that no other multi-process test covers (MR dedup
sharded, MR boundary ring, exact ``mst_backend=host`` sharded). Each rank's
trace passes ``scripts/check_trace.py``.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from hdbscan_tpu.parallel import shard as ref_shard
from hdbscan_tpu.parallel.mesh import get_mesh as ref_get_mesh
from hdbscan_tpu_torch.cli import main as port_main
from hdbscan_tpu_torch.ops import rpforest
from hdbscan_tpu_torch.parallel import distributed, shard
from hdbscan_tpu_torch.parallel.mesh import get_mesh
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECK_TRACE = os.path.join(REPO, "scripts", "check_trace.py")

#: The library worker's calls: the sharded forest by (metric, precision),
#: the forest over the mesh by (rescan rounds, knn_backend, metric).
SHARD_KW = dict(trees=3, leaf_size=64, seed=2)
SHARD_CASES = {"euclidean": ("euclidean", "f32"), "cosine": ("cosine", "f32"),
               "pearson": ("pearson", "f32"), "bf16": ("euclidean", "bf16")}
RING_KW = dict(trees=3, leaf_size=96, seed=1, return_indices=True)
RING_CASES = {"rounds0": (0, "fused", "euclidean"), "rounds1": (1, "fused", "euclidean"),
              "rounds2": (2, "fused", "euclidean"), "rounds2_unfused": (2, "xla", "euclidean"),
              "rounds1_cosine": (1, "fused", "cosine")}


def _shard_grid():
    return np.random.default_rng(5).integers(0, 30, size=(1003, 3)).astype(np.float64)


def _ring_grid():
    return np.random.default_rng(4).integers(0, 30, size=(2001, 4)).astype(np.float64)


_LIBRARY_WORKER = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
SHARD_KW, SHARD_CASES, RING_KW, RING_CASES = {consts}
pid, nproc, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
grids = np.load(sys.argv[5])
from hdbscan_tpu_torch.parallel.distributed import initialize_from_cluster_name
assert initialize_from_cluster_name(f"127.0.0.1:{port},{pid},{nproc}", devices=["cpu", "cpu"],
                                    timeout_s=60)
from hdbscan_tpu_torch.ops import rpforest
from hdbscan_tpu_torch.parallel.mesh import comm_snapshot, get_mesh
from hdbscan_tpu_torch.parallel.shard import shard_forest_core_distances
mesh = get_mesh(["cpu", "cpu"])
assert mesh.multiprocess and mesh.local_shards() == [2 * pid, 2 * pid + 1]
res = {}


def run(key, fn):
    events = {}
    before = comm_snapshot()[0]
    got = fn(lambda stage, **f: events.setdefault(stage, []).append(f))
    res[key + "_bytes"] = np.array(comm_snapshot()[0] - before)
    return got, events


grid = grids["shard"]
for name, (metric, precision) in SHARD_CASES.items():
    core, ev = run(f"shard_{name}", lambda trace: shard_forest_core_distances(
        grid, 7, metric, mesh=mesh, knn_precision=precision, trace=trace, **SHARD_KW))
    res[f"shard_{name}"] = core
    res[f"shard_{name}_recall"] = np.array(ev["shard_knn_exchange"][0].get("recall_at_k", -1.0))
grid = grids["ring"]
for name, (rounds, backend, metric) in RING_CASES.items():
    got, ev = run(f"ring_{name}", lambda trace: rpforest.rpforest_core_distances(
        grid, 9, metric, mesh=mesh, rescan_rounds=rounds, knn_backend=backend, trace=trace,
        **RING_KW))
    for key, arr in zip(("core", "knn", "idx"), got):
        res[f"ring_{name}_{key}"] = arr
    res[f"ring_{name}_improved"] = np.array([e["improved"] for e in ev.get("knn_index_rescan", [])])
    res[f"ring_{name}_recall"] = np.array(ev["knn_index_query"][0]["recall_at_k"])
forest = rpforest.build_forest(grid, trees=3, leaf_size=96, seed=1, device="cpu")
res["forest_members"], res["forest_thresholds"] = forest.members, forest.thresholds
np.savez(out, **res)
print("RANK_OK", pid)
"""


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """Each rank's arrays from the library worker, run once for the module:
    2 ranks x 2 CPU shards, the four-shard global mesh."""
    root = tmp_path_factory.mktemp("forest_library")
    script = root / "worker.py"
    script.write_text(_LIBRARY_WORKER.replace(
        "{consts}", repr((SHARD_KW, SHARD_CASES, RING_KW, RING_CASES))))
    grids = root / "grids.npz"
    np.savez(grids, shard=_shard_grid(), ring=_ring_grid())
    port = distributed.free_local_port()
    outs = [root / f"rank{r}.npz" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2", str(port), str(outs[r]),
                               str(grids)],
                              env=distributed.hermetic_child_env(REPO), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p, (so, se) in zip(procs, distributed.communicate_all(procs, timeout=150)):
        assert p.returncode == 0, se[-3000:]
        assert "RANK_OK" in so
    return [dict(np.load(path)) for path in outs]


def _recorder():
    events = {}
    return events, lambda stage, **f: events.setdefault(stage, []).append(f)


def _same_on_both_ranks(library, prefix):
    a, b = library
    keys = [k for k in a if k.startswith(prefix) and not k.endswith("_bytes")]
    assert keys
    for key in keys:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("name", list(SHARD_CASES))
def test_sharded_forest_over_ranks_equals_one_process(library, name):
    """Each rank builds only its own shards' trees and the visiting panels
    (rows, leaf members, thresholds) travel by ``ring_shift``: both ranks'
    cores and sampled recall equal one process over four CPU shards
    bitwise, bf16's 8-row tiles included; at f32 euclidean they equal the
    reference's sharded forest at four shards."""
    _same_on_both_ranks(library, f"shard_{name}")
    metric, precision = SHARD_CASES[name]
    grid = _shard_grid()
    ev, trace = _recorder()
    one = shard.shard_forest_core_distances(grid, 7, metric, mesh=get_mesh(["cpu"] * 4),
                                            knn_precision=precision, trace=trace, **SHARD_KW)
    got = library[0][f"shard_{name}"]
    np.testing.assert_array_equal(got, one)
    assert float(library[0][f"shard_{name}_recall"]) == \
        ev["shard_knn_exchange"][0].get("recall_at_k", -1.0)
    if name == "euclidean":
        want = ref_shard.shard_forest_core_distances(grid, 7, metric,
                                                     mesh=ref_get_mesh(jax.devices()[:4]),
                                                     **SHARD_KW)
        np.testing.assert_array_equal(got, want)
    assert all(int(r[f"shard_{name}_bytes"]) > 0 for r in library)


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_forest_over_ranks_equals_one_device(library, name):
    """Every rank builds the same forest, scans its own shards' leaf slices
    and all-gathers the leaf lists and the rescans' id lists: both ranks'
    cores, lists and ids equal the one-device forest's after 0, 1 and 2
    rescan rounds, on the kernels' route (their plain versions) and the
    unfused one, and the rescans' improved counts sum to its counts."""
    _same_on_both_ranks(library, f"ring_{name}")
    rounds, backend, metric = RING_CASES[name]
    ev, trace = _recorder()
    one = rpforest.rpforest_core_distances(_ring_grid(), 9, metric, device="cpu",
                                           rescan_rounds=rounds, knn_backend=backend,
                                           trace=trace, **RING_KW)
    for key, want in zip(("core", "knn", "idx"), one):
        np.testing.assert_array_equal(library[0][f"ring_{name}_{key}"], want, err_msg=key)
    assert library[0][f"ring_{name}_improved"].tolist() == \
        [e["improved"] for e in ev.get("knn_index_rescan", [])]
    assert float(library[0][f"ring_{name}_recall"]) == ev["knn_index_query"][0]["recall_at_k"]
    assert all(int(r[f"ring_{name}_bytes"]) > 0 for r in library)


def test_ranks_build_the_same_forest(library):
    """The forest's build (stable sorts and elementwise ops) gives every
    rank the forest this process builds, bitwise."""
    want = rpforest.build_forest(_ring_grid(), trees=3, leaf_size=96, seed=1, device="cpu")
    for r in library:
        np.testing.assert_array_equal(r["forest_members"], want.members)
        np.testing.assert_array_equal(r["forest_thresholds"], want.thresholds)


N = 1200
#: The reference multi-process test's flags (tests/e2e/test_multiprocess.py:70-80).
MR_FLAGS = ["minPts=4", "minClSize=50", "processing_units=256", "k=0.1", "seed=3"]
EXACT_SHARDED = ["minPts=4", "minClSize=50", "fit_sharding=sharded", f"processing_units={N}"]
FOREST = ["knn_index=rpforest", "rpf_trees=3", "rpf_leaf_size=128"]
#: name -> (flags, ranks, each rank's --device, the route rank 0 names, the
#: forest's trace stage every rank must emit, or None).
LEGS = {
    "exact_sharded_forest_2x2": (EXACT_SHARDED + FOREST, 2, "cpu,cpu", "exact-sharded",
                                 "shard_panel_sweep"),
    "exact_sharded_forest_4x1": (EXACT_SHARDED + FOREST, 4, "cpu", "exact-sharded",
                                 "shard_panel_sweep"),
    "mr_sharded_boundary_forest_2x2": (
        MR_FLAGS + ["fit_sharding=sharded", "boundary=0.05", "block_pruning=false", *FOREST],
        2, "cpu,cpu", "mr-sharded (", "shard_panel_sweep"),
    "ring_forest_2x2": (MR_FLAGS + ["scan_backend=ring", *FOREST], 2, "cpu,cpu", "mr (",
                        "knn_index_query"),
    "auto_forest_2x2": (MR_FLAGS + ["knn_index=auto", "knn_index_threshold=100", *FOREST[1:]],
                        2, "cpu,cpu", "mr (", "knn_index_query"),
    "mr_dedup_sharded_2x2": (MR_FLAGS + ["dedup=true", "fit_sharding=sharded"], 2, "cpu,cpu",
                             "mr-sharded (", None),
    "mr_boundary_ring_2x2": (MR_FLAGS + ["boundary=0.05", "scan_backend=ring"], 2, "cpu,cpu",
                             "mr (", None),
    "exact_host_sharded_2x2": (EXACT_SHARDED + ["mst_backend=host"], 2, "cpu,cpu",
                               "exact-sharded", None),
}


@pytest.fixture(scope="module")
def blobs_file(tmp_path_factory):
    """The reference multi-process test's three blobs of 400 points, on an
    integer grid, so every distance is exact."""
    rng = np.random.default_rng(7)
    pts = np.concatenate([np.round(rng.normal(c, 4.0, size=(400, 3)))
                          for c in ((0, 0, 0), (80, 0, 0), (0, 80, 80))])
    path = tmp_path_factory.mktemp("forest_blobs") / "blobs.txt"
    np.savetxt(path, pts, fmt="%d")
    return str(path)


def _files(out_dir) -> dict:
    out = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name), "rb") as f:
            out[name] = f.read()
    return out


def _run_ranks(n_ranks, device, argv, root):
    port = distributed.free_local_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "hdbscan_tpu_torch", *argv,
             f"clusterName=127.0.0.1:{port},{r},{n_ranks}", "--device", device,
             "--trace-out", str(root / "trace.jsonl")],
            env=distributed.hermetic_child_env(REPO), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(n_ranks)
    ]
    outs = distributed.communicate_all(procs, timeout=120)
    return [(p.returncode, so, se) for p, (so, se) in zip(procs, outs)]


@pytest.mark.parametrize("leg", list(LEGS))
def test_cli_over_ranks_writes_the_one_process_files(blobs_file, tmp_path, leg):
    """Every rank exits 0 (``knn_index=auto`` past its threshold too, where
    the forest once exited 2 after the load), rank 0 alone prints, the
    five files equal one process over four CPU shards byte for byte, and
    every rank's trace passes ``check_trace.py`` and shows the forest ran
    over the ranks."""
    flags, n_ranks, device, mode, stage = LEGS[leg]
    argv = ["fit", f"file={blobs_file}", *flags]
    assert port_main(argv + [f"out_dir={tmp_path / 'one'}", "--device", "cpu,cpu,cpu,cpu"]) == 0
    ranks = _run_ranks(n_ranks, device, argv + [f"out_dir={tmp_path / 'out'}"], tmp_path)
    for r, (rc, _, se) in enumerate(ranks):
        assert rc == 0, f"rank {r}:\n{se[-3000:]}"
    assert f", {mode}" in ranks[0][1].splitlines()[0]
    assert all("hdbscan-tpu" not in so for _, so, _ in ranks[1:])
    one = _files(tmp_path / "one")
    assert len(one) == 5 and _files(tmp_path / "out") == one
    for r in range(n_ranks):
        path = tmp_path / f"trace.{r}.jsonl"
        out = subprocess.run([sys.executable, CHECK_TRACE, str(path)], capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        with open(path, encoding="utf-8") as f:
            stages = {json.loads(line)["stage"] for line in f}
        assert stage is None or stage in stages, (r, sorted(stages))
