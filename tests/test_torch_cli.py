"""The port's command line (``python -m hdbscan_tpu_torch``) against the
reference's (``hdbscan_tpu.cli``), on the CPU (``--device cpu``).

On integer grids the five files are byte-identical to the reference CLI's,
run at its production setting (float32: ``jax.enable_x64(False)``), on the
dense route and on the MR route in the default and boundary modes and
with ``variant=rs``, ``dedup=true``, ``compat_cf=true`` and ``consensus=3``
(whose provenance sidecar is identical too). The
``exact-sharded`` route's files equal the reference's ``exact.fit`` plus
``write_outputs`` run in process (the reference's own sharded CLI route
fails under the installed jax). Every ``--trace-out`` file passes
``scripts/check_trace.py``; ``fit --model-out`` then ``predict --out``
write a prediction file byte-identical to the reference CLI's on the dense
and MR routes and on the ``fused`` and ``rpforest`` backends; a
``clusterName`` that is not ported exits 2 naming its ROADMAP item before
any data is read; ``fleet`` validates its arguments as the reference's
does and fails fast on a model that does not exist.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from hdbscan_tpu.cli import main as ref_main
from hdbscan_tpu.config import HDBSCANParams as RefParams
from hdbscan_tpu.models import exact as ref_exact
from hdbscan_tpu.models.hdbscan import write_outputs as ref_write
from hdbscan_tpu.utils.io import load_points as ref_load
from hdbscan_tpu_torch.cli import main as port_main
from tests.test_torch_mr_mesh import _one_thread  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECK_TRACE = os.path.join(REPO, "scripts", "check_trace.py")
BASE = ["minPts=8", "minClSize=40", "seed=0"]


@pytest.fixture(scope="module")
def grid_file(tmp_path_factory):
    """1,650 points on an integer grid (six blobs and uniform noise), tab
    separated like ``Skin_NonSkin.txt``."""
    rng = np.random.default_rng(3)
    centres = rng.uniform(0, 60, size=(6, 3))
    x = np.round(centres[rng.integers(0, 6, 1500)] + rng.normal(0, 3, size=(1500, 3)))
    x = np.concatenate([x, rng.integers(0, 60, size=(150, 3))])
    path = tmp_path_factory.mktemp("grid") / "grid.tsv"
    np.savetxt(path, x, delimiter="\t", fmt="%d")
    return str(path)


def _files(out_dir) -> dict:
    out = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name), "rb") as f:
            out[name] = f.read()
    return out


def _check_trace(path):
    out = subprocess.run([sys.executable, CHECK_TRACE, path], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _summary(stdout: str) -> str:
    """The result line without its wall time."""
    line = stdout.splitlines()[0]
    assert line.startswith("hdbscan-tpu: "), stdout
    return line.rsplit(",", 1)[0]


@pytest.mark.parametrize(
    "extra,mode",
    [
        (["processing_units=2000"], "exact,"),
        (["processing_units=256", "k=0.1"], "mr (3 levels)"),
        (["processing_units=256", "k=0.1", "boundary=0.05"], "mr (3 levels)"),
    ],
    ids=["dense", "mr-default", "mr-boundary"],
)
def test_files_equal_reference_cli(tmp_path, grid_file, capsys, extra, mode):
    argv = ["fit", f"file={grid_file}", *BASE, *extra]
    with jax.enable_x64(False):
        assert ref_main(argv + [f"out_dir={tmp_path / 'ref'}"]) == 0
    ref_out = capsys.readouterr().out
    trace = str(tmp_path / "trace.jsonl")
    assert port_main(argv + [f"out_dir={tmp_path / 'port'}", "--device", "cpu",
                             "--trace-out", trace]) == 0
    out, err = capsys.readouterr()
    assert _summary(out) == _summary(ref_out)
    assert f", {mode}" in out.splitlines()[0]
    assert "phases:" in err and "write_outputs: n=1" in err
    ref_files, port_files = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(port_files) == sorted(ref_files) and len(ref_files) == 5
    for name in ref_files:
        assert port_files[name] == ref_files[name], name
    _check_trace(trace)


@pytest.mark.parametrize(
    "extra,mode",
    [
        (["variant=rs"], "mr (3 levels)"),
        (["dedup=true"], "mr (3 levels)"),
        (["compat_cf=true"], "mr (3 levels)"),
        (["consensus=3"], "mr-consensus (3 draws)"),
    ],
    ids=["rs", "dedup", "compat_cf", "consensus"],
)
def test_mr_route_options_equal_reference_cli(tmp_path, grid_file, capsys, extra, mode):
    """The MR route's ``variant=rs``, ``dedup=true``, ``compat_cf=true`` and
    ``consensus=3``: the five files byte-identical to the reference CLI's
    (a consensus run adds the ``grid_consensus.json`` sidecar, identical
    too, and its stderr note)."""
    argv = ["fit", f"file={grid_file}", *BASE, "processing_units=256", "k=0.1", *extra]
    with jax.enable_x64(False):
        assert ref_main(argv + [f"out_dir={tmp_path / 'ref'}"]) == 0
    ref_out, ref_err = capsys.readouterr()
    trace = str(tmp_path / "trace.jsonl")
    assert port_main(argv + [f"out_dir={tmp_path / 'port'}", "--device", "cpu",
                             "--trace-out", trace]) == 0
    out, err = capsys.readouterr()
    assert _summary(out) == _summary(ref_out)
    assert f", {mode}, " in out.splitlines()[0]
    ref_files, port_files = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(port_files) == sorted(ref_files)
    assert len(ref_files) == (6 if mode.startswith("mr-consensus") else 5)
    for name in ref_files:
        assert port_files[name] == ref_files[name], name
    if mode.startswith("mr-consensus"):
        import json

        info = json.loads(port_files["grid_consensus.json"])
        assert info["draws"] == 3 and info["tree_and_hierarchy"] == "representative draw only"
        assert "note: consensus run" in err and "note: consensus run" in ref_err
    _check_trace(trace)


def test_exact_sharded_route_equals_reference_exact_fit(tmp_path, grid_file, capsys):
    argv = ["fit", f"file={grid_file}", *BASE, "processing_units=2000", "fit_sharding=sharded"]
    trace = str(tmp_path / "trace.jsonl")
    assert port_main(argv + [f"out_dir={tmp_path / 'port'}", "--device", "cpu",
                             "--trace-out", trace]) == 0
    out = capsys.readouterr().out
    assert ", exact-sharded, " in out.splitlines()[0]
    # The reference's single-device exact fit: its sharded program fails
    # under the installed jax, and the sharded fit equals the single-device
    # one (tests/test_torch_shard.py).
    ref_params = RefParams.from_args(argv[1:-1] + [f"out_dir={tmp_path / 'ref'}"])
    with jax.enable_x64(False):
        ref_write(ref_exact.fit(ref_load(grid_file), ref_params), ref_params)
    ref_files, port_files = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(port_files) == sorted(ref_files) and len(ref_files) == 5
    for name in ref_files:
        assert port_files[name] == ref_files[name], name
    _check_trace(trace)


@pytest.mark.parametrize(
    "extra",
    [["mst_backend=host"], ["dedup=true"], ["dedup=true", "mst_backend=host", "scan_backend=ring"]],
    ids=["mst_backend_host", "dedup", "dedup_ring_host"],
)
def test_exact_sharded_host_rounds_equal_reference_cli(tmp_path, grid_file, capsys, extra):
    """The exact-sharded route down the host rounds (the sharded scanner)
    and with dedup: the reference CLI runs these on its 8-device mesh, the
    port on one CPU shard; the five files are byte-identical."""
    argv = ["fit", f"file={grid_file}", *BASE, "processing_units=2000",
            "fit_sharding=sharded", *extra]
    with jax.enable_x64(False):
        assert ref_main(argv + [f"out_dir={tmp_path / 'ref'}"]) == 0
    ref_out = capsys.readouterr().out
    trace = str(tmp_path / "trace.jsonl")
    assert port_main(argv + [f"out_dir={tmp_path / 'port'}", "--device", "cpu",
                             "--trace-out", trace]) == 0
    out = capsys.readouterr().out
    assert _summary(out) == _summary(ref_out)
    assert ", exact-sharded, " in out.splitlines()[0]
    ref_files, port_files = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(port_files) == sorted(ref_files) and len(ref_files) == 5
    for name in ref_files:
        assert port_files[name] == ref_files[name], name
    _check_trace(trace)


def test_trace_file_records_the_cli_events(tmp_path, grid_file, capsys):
    import json

    trace = str(tmp_path / "t.jsonl")
    assert port_main([f"file={grid_file}", *BASE, "processing_units=2000",
                      f"out_dir={tmp_path}", f"--trace-out={trace}", "--device=cpu",
                      "trace_rotate_bytes=0"]) == 0
    capsys.readouterr()
    with open(trace) as f:
        recs = [json.loads(line) for line in f]
    stages = [r["stage"] for r in recs]
    assert stages[0] == "load_points" and stages[-2:] == ["fit", "write_outputs"]
    assert "block_edges" in stages
    fit = recs[-2]
    assert fit["mode"] == "exact" and fit["rows"] == 1650 and fit["process"] == 0
    assert [r["seq"] for r in recs] == list(range(len(recs)))


@pytest.mark.parametrize(
    "fit_extra,predict_extra",
    [
        (["processing_units=2000"], []),
        (["processing_units=256", "k=0.1"], ["predict_batch=64"]),
        (["processing_units=2000"], ["predict_backend=fused"]),
        (["processing_units=2000", "knn_index=rpforest", "rpf_trees=3", "rpf_leaf_size=256"],
         ["predict_backend=rpforest"]),
    ],
    ids=["dense", "mr", "fused", "rpforest"],
)
def test_fit_predict_cli_equals_reference(tmp_path, grid_file, capsys, fit_extra,
                                          predict_extra):
    """``fit --model-out`` then ``predict --out`` in both packages: the two
    model files hold the same arrays and the prediction files are
    byte-identical; the predict trace passes ``scripts/check_trace.py``."""
    rng = np.random.default_rng(9)
    x = ref_load(grid_file)
    q = np.round(x[rng.integers(0, len(x), 300)] + rng.normal(0, 1, size=(300, 3)))
    points = str(tmp_path / "queries.tsv")
    np.savetxt(points, np.concatenate([q, x[:40]]), delimiter="\t", fmt="%d")
    for who, run, flags in (("ref", ref_main, []), ("port", port_main, ["--device", "cpu"])):
        model = str(tmp_path / f"{who}.npz")
        with jax.enable_x64(False):
            assert run(["fit", f"file={grid_file}", *BASE, *fit_extra,
                        f"out_dir={tmp_path / who}", "--model-out", model, *flags]) == 0
            argv = ["predict", "--model", model, "--points", points,
                    "--out", str(tmp_path / f"{who}.csv"), *predict_extra, *flags]
            if who == "port":
                argv += ["--trace-out", str(tmp_path / "predict.jsonl")]
            assert run(argv) == 0
        out = capsys.readouterr().out
        assert "hdbscan-tpu predict: 340 points" in out
    with np.load(tmp_path / "ref.npz") as r, np.load(tmp_path / "port.npz") as p:
        assert sorted(r.files) == sorted(p.files)
        for key in r.files:
            np.testing.assert_array_equal(p[key], r[key], err_msg=key)
    with open(tmp_path / "ref.csv", "rb") as f1, open(tmp_path / "port.csv", "rb") as f2:
        assert f2.read() == f1.read()
    _check_trace(str(tmp_path / "predict.jsonl"))


@pytest.mark.parametrize(
    "argv,item",
    [
        (["file=MISSING", "clusterName=auto"], "A9b"),
        (["file=MISSING", "clusterName=localhost:1234,0,2"], "A9b"),
    ],
)
def test_unported_flags_exit_2_before_reading_data(tmp_path, capsys, argv, item):
    """``file=`` names a file that does not exist: a run that read data
    would raise instead of returning 2."""
    argv = [a.replace("MISSING", str(tmp_path / "absent.tsv")) for a in argv]
    assert port_main(argv + ["--device", "cpu"]) == 2
    assert f"is not ported yet (ROADMAP {item})" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize(
    "extra,mode",
    [(["processing_units=256", "fit_sharding=sharded"], "mr-sharded (3 levels)")],
    ids=["mr_sharded"],
)
def test_once_refused_routes_equal_reference_cli(tmp_path, grid_file, capsys, extra, mode):
    """The MR route with ``fit_sharding=sharded``, once refused: the port on
    a mesh of four CPU shards (``--device cpu,cpu,cpu,cpu``) writes the
    reference CLI's five files (its 8-device mesh) byte for byte."""
    argv = ["fit", f"file={grid_file}", *BASE, "k=0.1", *extra]
    with jax.enable_x64(False):
        assert ref_main(argv + [f"out_dir={tmp_path / 'ref'}"]) == 0
    ref_out = capsys.readouterr().out
    trace = str(tmp_path / "trace.jsonl")
    assert port_main(argv + [f"out_dir={tmp_path / 'port'}", "--device", "cpu,cpu,cpu,cpu",
                             "--trace-out", trace]) == 0
    out = capsys.readouterr().out
    assert _summary(out) == _summary(ref_out)
    assert f", {mode}, " in out.splitlines()[0]
    ref_files, port_files = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(port_files) == sorted(ref_files) and len(ref_files) == 5
    for name in ref_files:
        assert port_files[name] == ref_files[name], name
    _check_trace(trace)


def test_bad_flag_missing_file_and_help(capsys):
    assert port_main(["file=x", "bogus=1", "--device", "cpu"]) == 2
    assert "unknown flag" in capsys.readouterr().err
    assert port_main(["minPts=4", "--device", "cpu"]) == 2
    assert "file=<input> is required" in capsys.readouterr().err
    assert port_main(["fit", "--trace-out"]) == 2
    assert "requires a PATH" in capsys.readouterr().err
    for argv in (["--help"], ["fit", "-h"], []):
        assert port_main(argv) == 0
        out = capsys.readouterr().out
        assert "minPts" in out and "--trace-out" in out and "--report" in out
        assert "--flight-dir" in out and "A12" not in out and "(A11)" not in out
        assert "(multi-process runs, A9b)" in out


def test_without_a_card_fails_and_writes_nothing(tmp_path, grid_file, capsys):
    """No ``--device`` means the card; with no card the command fails
    instead of running on the CPU, and writes no file."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the command would run on it")
    argv = [f"file={grid_file}", *BASE, "processing_units=2000", f"out_dir={tmp_path / 'out'}",
            "--trace-out", str(tmp_path / "t.jsonl")]
    assert port_main(argv) != 0
    assert "--device cpu" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []
    assert port_main(argv + ["--device", "bogus"]) != 0
    assert os.listdir(tmp_path) == []


def test_module_runs_as_a_command(tmp_path, grid_file):
    out = subprocess.run(
        [sys.executable, "-m", "hdbscan_tpu_torch", "fit", f"file={grid_file}", *BASE,
         "processing_units=2000", f"out_dir={tmp_path}", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert ", exact, " in out.stdout.splitlines()[0]
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"grid_{k}" for k in ("hierarchy.csv", "tree.csv", "partition.csv",
                              "outlier_scores.csv", "visualization.vis"))


def test_fleet_cli_validates_args(capsys):
    """``fleet`` fails fast on a missing ``--model`` or a bad fleet knob —
    exit 2 with the reason, before any replica is spawned — as the
    reference's does, and the help text documents the subcommand."""
    from hdbscan_tpu.cli import HELP as REF_HELP
    from hdbscan_tpu_torch.cli import HELP

    for run in (port_main, ref_main):
        assert run(["fleet"]) == 2
        assert "--model" in capsys.readouterr().err
        assert run(["fleet", "--model", "m.npz", "fleet_policy=round_robin"]) == 2
        err = capsys.readouterr().err
        assert "fleet_policy" in err and "round_robin" in err
        assert run(["fleet", "--model", "m.npz", "fleet_replicas=0"]) == 2
        assert "fleet_replicas" in capsys.readouterr().err
    for needle in ("fleet", "fleet_replicas=N", "fleet_policy=", "--tenants-dir DIR",
                   "tenant_quota=F", "--replica-trace-dir DIR", "artifact_store="):
        assert needle in HELP and needle in REF_HELP, needle
    assert "--device DEV" in HELP.split("fleet --model", 1)[1]


def test_fleet_cli_missing_model_fails_fast(tmp_path):
    """A model path that does not exist dies at replica startup with exit
    2, not a hang: the router's startup deadline turns a replica that never
    binds its port into a loud error."""
    rc = port_main([
        "fleet", "--model", str(tmp_path / "nope.npz"), "--device", "cpu",
        "fleet_replicas=1", "fleet_health_interval=0.1",
    ])
    assert rc == 2
