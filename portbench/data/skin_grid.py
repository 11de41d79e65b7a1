"""The Skin-shaped set: rows of integer RGB codes drawn uniformly on the
0-255 grid (the real ``Skin_NonSkin.txt`` is not in the repository), as
the port's smoke run draws it."""

from __future__ import annotations

import numpy as np


def skin_grid(n: int, dims: int, rng: np.random.Generator) -> np.ndarray:
    """(n, dims) float64 integer codes, uniform on [0, 255]."""
    return rng.integers(0, 256, size=(n, dims)).astype(np.float64)


def generate(config: dict, rng: np.random.Generator) -> np.ndarray:
    return skin_grid(config["n"], config["dims"], rng)
