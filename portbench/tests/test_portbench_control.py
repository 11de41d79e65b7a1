"""The control, the reference computed a precision lower than the
configuration states and put in the program's place, comes out as not
correct against each fit cell's limits (small sizes; the cell-size
readings are the chip's, in PERF.md)."""

import pytest
import torch

from conftest import small_cell
from portbench import compare
from portbench.control import readings

CPU = [torch.device("cpu")]


@pytest.mark.parametrize("cell,precision", [("hepmass28.fit", "tf32"), ("skin.fit", "bf16")])
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_control_fails(cell, precision, seed):
    c = small_cell(cell, config={"n": 2000, "min_cluster_size": 40})
    numbers = readings(c, seed, "control", precision, CPU, 0)
    ok, checks = compare.judge(numbers, c["limits"])
    assert not ok, checks


def test_tf32_reads_nothing_on_the_grid():
    """Skin's 8-bit integer codes are exact in TF32: that control reads 0,
    so the Skin cells' control is bfloat16."""
    c = small_cell("skin.fit", config={"n": 2000, "min_cluster_size": 40})
    numbers = readings(c, 24, "control", "tf32", CPU, 0)
    assert numbers == {"core_gap": 0.0, "mst_gap": 0.0, "mst_excess": 0.0, "label_rows": 0}


def test_serving_control_fails():
    c = small_cell("skin.predict", config={"n": 2000, "min_cluster_size": 40})
    numbers = readings(c, 25, "control", "bf16", CPU, 500)
    assert not compare.judge(numbers, c["limits"])[0]


def test_program_side_is_within_limits():
    c = small_cell("hepmass28.fit", config={"n": 2000, "min_cluster_size": 40})
    numbers = readings(c, 26, "program", "tf32", CPU, 0)
    assert compare.judge(numbers, c["limits"])[0], numbers
