"""Native (C) host-runtime components, built on demand via the system cc.

The per-edge Kruskal merge-forest loop (the host tree builder's fallback
when the device forest declines a pool) runs in C where Python would
dominate. Compilation happens at first use into the port's git-ignored
build directory (``<repo>/.torch_build/native``) with a source-mtime
check; every caller falls back to the pure-Python implementation when no
compiler is available, so the native layer is an accelerator, never a
requirement.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_DIR = os.path.dirname(__file__)
_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(_DIR)), ".torch_build", "native"
)

_lib = None
_lib_tried = False


def _build(src: str, so: str) -> bool:
    os.makedirs(os.path.dirname(so), exist_ok=True)
    # Compile to a unique temp name and rename into place: an interrupted or
    # concurrent build must never leave a half-written .so with a fresh mtime.
    tmp = f"{so}.{os.getpid()}.tmp"
    for cc in ("cc", "gcc", "clang"):
        try:
            subprocess.run(
                [cc, "-O2", "-shared", "-fPIC", "-o", tmp, src],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(tmp, so)
            return True
        except (OSError, subprocess.SubprocessError):
            continue
        finally:
            if os.path.exists(tmp):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
    return False


def merge_forest_lib():
    """ctypes handle to the merge-forest library, or None (use Python)."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    src = os.path.join(_DIR, "merge_forest.c")
    so = os.path.join(_CACHE, "merge_forest.so")
    try:
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
            if not _build(src, so):
                return None
        lib = ctypes.CDLL(so)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.build_merge_forest_c.restype = ctypes.c_int64
        lib.build_merge_forest_c.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            i64p, i64p, f64p, f64p, ctypes.c_double,
            i64p, i64p, f64p, f64p, f64p, u8p, i64p, i64p, i64p,
        ]
        lib.flatten_children_c.restype = ctypes.c_int64
        lib.flatten_children_c.argtypes = [
            ctypes.c_int64, u8p, i64p, i64p, i64p, i64p,
        ]
        _lib = lib
    except (OSError, AttributeError):
        # AttributeError: a stale cached .so missing a newer symbol — use
        # Python rather than crash (the mtime check rebuilds next time).
        _lib = None
    return _lib
