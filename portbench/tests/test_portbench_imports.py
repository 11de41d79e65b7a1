"""Nothing the benchmark loads is JAX or the JAX package (whole top-level
names), and the reference loads nothing of the port."""

import os
import subprocess
import sys

from conftest import ROOT

BANNED = "{'jax', 'jaxlib', 'flax', 'hdbscan_tpu'}"


def _fresh(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_portbench_modules_load_no_jax():
    got = _fresh(
        "import sys, glob, os\n"
        "from portbench import spec\n"
        "import portbench.run, portbench.control, portbench.harness, portbench.generator\n"
        "for folder in ('metrics', 'kinds', 'data'):\n"
        "    for p in glob.glob(os.path.join(spec.HERE, folder, '*.py')):\n"
        "        spec.module(folder, os.path.basename(p)[:-3])\n"
        "import hdbscan_tpu_torch.models.exact, hdbscan_tpu_torch.serve.batcher\n"
        "import hdbscan_tpu_torch.serve.predict, hdbscan_tpu_torch.parallel.mesh\n"
        f"print(sorted({{m.split('.')[0] for m in sys.modules}} & {BANNED}))")
    assert got == "[]"


def test_reference_loads_nothing_of_the_port():
    got = _fresh("import sys\nimport portbench.reference, portbench.compare, portbench.data\n"
                 "import portbench.data.skin_grid, portbench.data.gauss\n"
                 "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('hdbscan')))")
    assert got == "[]"


def test_run_refuses_without_cards(tmp_path):
    """No CUDA card here: the run exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "skin.fit",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_without_the_port(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "skin.fit",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
