"""On the card: a short run of every one-card cell prints a correct result
line whose keys are the contract's."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("cell", ["skin.fit", "skin.predict", "hepmass28.fit"])
def test_cell_runs_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "4000000007", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] and result["device"]["platform"] == "gpu"
