"""Tests of the benchmark itself. They run on the CPU with the port's plain
versions at small sizes; those marked ``card`` need a CUDA card and skip
without one (``python3 -m pytest portbench/tests -m card`` on the chip)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


def small_cell(name: str, **over) -> dict:
    """Cell ``name`` of BENCHMARK.json at a size a CPU test holds."""
    from portbench import spec

    c = spec.cell(name)
    c["config"] = dict(c["config"], **over.get("config", {}))
    c["traffic"] = dict(c["traffic"], **over.get("traffic", {}))
    return c
