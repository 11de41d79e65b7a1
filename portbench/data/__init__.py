"""Frozen data of the benchmark, numpy only.

A configuration's ``data.generator`` names a module ``data/<generator>.py``
with ``generate(config, rng) -> (n, dims) float64``; :func:`generate` finds
it by that name. Kept here so later changes to the program cannot move the
yardstick:

- ``data/skin_grid.py``: the Skin-shaped set on the 0-255 RGB grid;
- ``data/gauss.py``: the paper's Gauss1/2/3 mixture;
- :func:`novel_queries`: serving queries in the reference bench sampler's
  shape, training rows with every fourth an exact duplicate and the rest
  jittered by a rounded N(0, 1) and kept on the grid.
"""

from __future__ import annotations

import os

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for ``seed`` (any whole number, also past 32 bits)
    and a sub-stream: every (seed, stream) pair draws its own numbers."""
    return np.random.default_rng([int(seed) % (1 << 63), *stream])


def novel_queries(data: np.ndarray, rows: int, rng: np.random.Generator) -> np.ndarray:
    """``rows`` queries: training rows, every fourth unchanged, the rest
    moved by a rounded N(0, 1) a feature and clipped to [0, 255]."""
    q = data[rng.integers(0, len(data), rows)]
    jitter = np.round(rng.normal(0, 1, (rows, data.shape[1])))
    jitter[::4] = 0.0
    return np.clip(q + jitter, 0, 255)


def generate(config: dict, seed: int, copy: int, base: str = HERE) -> np.ndarray:
    """Copy ``copy`` of the configuration's data set for run seed ``seed``,
    from the generator its ``data.generator`` names."""
    from portbench import spec

    gen = spec.data_generator(config["data"]["generator"], base)
    return gen.generate(config, rng_for(seed, copy))
