"""The kernel build cache for the CLI and servers — the port of
``hdbscan_tpu/utils/cache.py``.

The reference keeps XLA's compiled programs in a persistent cache so every
shape compiles once per machine. The port has no JIT: its compiled work is
the hand-written CUDA kernels, each source built once with ``nvcc`` into a
shared library (``ops/cuda_build``). This module points that build at a
directory chosen by the ``compile_cache`` knob:

- ``auto`` (default): ``<repo>/.torch_build/cuda``
  (``ops/cuda_build.BUILD_DIR``, git-ignored), shared by every process of
  the checkout, so a library built once loads everywhere after;
- ``off`` (or ``HDBSCAN_TPU_NO_CACHE=1``): a fresh directory for this
  process, removed at exit, so every kernel the process runs compiles;
- anything else: that directory itself (created if missing).

A library's file name carries the hash of its sources and flags, so a
shared directory never loads a stale build.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

#: The fresh per-process directory of ``off``, made once.
_PROCESS_DIR: list[str] = []


def resolve_cache_dir(path: str | None = None) -> str | None:
    """The persistent build directory the ``compile_cache`` knob resolves
    to, or None when the cache is off (the process then builds into a
    fresh directory of its own). Touches neither the file system nor
    ``ops/cuda_build``'s state. The fleet router (``fleet/router.py``)
    calls it once and hands the directory to every replica as
    ``compile_cache=<dir>``, so a respawned or scaled-up replica loads
    the libraries its siblings built."""
    from hdbscan_tpu_torch.ops import cuda_build

    if os.environ.get("HDBSCAN_TPU_NO_CACHE") or path == "off":
        return None
    if path in (None, "auto"):
        return cuda_build.BUILD_DIR
    return path


def enable_persistent_compilation_cache(path: str | None = None) -> str | None:
    """Point the kernel builds of this process at the directory
    ``compile_cache`` names (module docstring); returns it, or None when
    the cache is off. The reference's name, so a reader finds the
    counterpart; idempotent."""
    from hdbscan_tpu_torch.ops import cuda_build

    resolved = resolve_cache_dir(path)
    if resolved is None:
        if not _PROCESS_DIR:
            _PROCESS_DIR.append(tempfile.mkdtemp(prefix="hdbscan_torch_build_"))
            atexit.register(shutil.rmtree, _PROCESS_DIR[0], True)
        cuda_build.set_build_dir(_PROCESS_DIR[0])
        return None
    os.makedirs(resolved, exist_ok=True)
    cuda_build.set_build_dir(resolved)
    return resolved
