"""hdbscan_tpu_torch — the PyTorch / CUDA port of hdbscan_tpu for NVIDIA H100.

Imports torch and numpy only (never jax, nothing of ``hdbscan_tpu``). The
exact fit runs on the card: ``models.exact.fit(data, params)``; the tests
run it on the CPU with ``device="cpu"``, where every kernel's plain
PyTorch version stands in.
"""

__version__ = "0.1.0"

from hdbscan_tpu_torch import models  # noqa: F401
from hdbscan_tpu_torch.config import HDBSCANParams  # noqa: F401
