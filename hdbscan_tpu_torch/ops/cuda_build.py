"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C entry point, loaded with ``ctypes``. ``-fmad=false`` keeps every
``a*b+c`` as two roundings, the arithmetic of the plain PyTorch versions
(eager PyTorch and XLA on the CPU do not contract), so kernel and plain
version agree bitwise. The libraries land in the build directory
(:func:`build_dir`: the git-ignored ``<repo>/.torch_build/cuda`` unless
``utils/cache`` points it elsewhere) under a name keyed by the sources'
content hash, so an edited source is rebuilt and a stale library never
loads.

A failed build raises: there is no fallback for CUDA tensors.

Builds and loads are serialised within a process by one lock, so threads
that first reach the same source together (a server's fit-job workers
beside its batcher) run one ``nvcc`` and load one library; each build
writes a temporary file named by process and thread, and the atomic
``os.replace`` publishes it, so processes building into one directory
(replicas sharing a card) never tear a library either.

``LAUNCHES`` counts kernel launches by name, ``BUILDS`` the sources this
process compiled and ``CACHE_HITS`` the libraries it loaded from the build
directory without compiling them; each wrapper adds one where it
launches its kernel and nowhere else. A launch past k or d = 128 (a
kernel's wide mode) counts under ``<name>_wide`` instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
    ".torch_build", "cuda",
)

#: Kernel name -> (source file, C entry point, ctypes argtypes; the last
#: argument is the stream). Kernels that share a source share its library.
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNELS = {
    "segmin": (
        "segmin.cu", "segmin_launch",
        [_P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P],
    ),
    "segmin_panel": (
        "segmin.cu", "segmin_panel_launch",
        [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    ),
    "knn_kbest": (
        "knn_kbest.cu", "knn_kbest_launch", [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    ),
    "knn_kbest_panel": (
        "knn_kbest.cu", "knn_kbest_panel_launch",
        [_P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    ),
    "knn_kbest_merge": (
        "knn_kbest.cu", "knn_kbest_merge_launch", [_P, _P, _I, _I, _I, _P, _P, _P],
    ),
    "knn_smallest": (
        "knn_kbest.cu", "knn_smallest_launch", [_P, _I, _I, _I, _I, _I, _P, _P, _P],
    ),
    "uf_scan": ("uf_scan.cu", "uf_scan_launch", [_P, _P, _I, _I, _P, _P, _P, _P, _P]),
    "forest_leaf_topk": (
        "forest_leaf_topk.cu", "forest_leaf_topk_launch",
        [_P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    ),
    "forest_merge": (
        "forest_merge.cu", "forest_merge_launch", [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    ),
    "forest_rescan_topk": (
        "forest_rescan.cu", "forest_rescan_topk_launch",
        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P],
    ),
    "forest_min_outgoing": (
        "forest_rescan.cu", "forest_min_outgoing_launch",
        [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    ),
    "knn_window": (
        "knn_window.cu", "knn_window_launch",
        [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    ),
}
_HEADERS = ("distance.cuh", "kbest.cuh", "lexlist.cuh", "warplist.cuh")
SOURCES = sorted({src for src, _, _ in KERNELS.values()})

#: Metric/form codes of ``csrc/distance.cuh``. Pearson has none of its
#: own: a wrapper centres its points (:func:`kernel_points`) and runs cosine.
METRIC_CODES = {
    ("euclidean", "diff"): 0,
    ("euclidean", "dot"): 1,
    ("manhattan", None): 2,
    ("supremum", None): 3,
    ("cosine", None): 6,
}

#: Codes of the squared euclidean distance (no root) by form: B3's selection.
SQ_EUCLID_CODES = {"diff": 4, "dot": 5}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
]

#: Past this k or d a kernel runs its wide mode (csrc/distance.cuh).
WIDE = 128

#: The kernels with a wide mode (B3, knn_smallest, keeps the reference's
#: limit; K3 has no k or d).
WIDE_KERNELS = ("segmin", "segmin_panel", "knn_kbest", "knn_kbest_panel", "knn_window",
                "forest_leaf_topk", "forest_merge", "forest_rescan_topk",
                "forest_min_outgoing")

LAUNCHES = {name: 0 for name in (*KERNELS, *(f"{k}_wide" for k in WIDE_KERNELS))}

#: Sources compiled by this process (a library already on disk is not
#: counted): the serving warmup's ``jit_compiles``.
BUILDS = 0

#: Libraries this process loaded from the build directory without
#: compiling them: the serving warmup's ``cache_hits``.
CACHE_HITS = 0

_build_dir: list[str] = []  # the directory utils/cache chose, if any
_built: set = set()  # sources this process compiled

_libs: dict = {}  # source -> loaded library
_fns: dict = {}  # (source, symbol) -> ctypes function
#: Serialises builds and loads (and the counters they bump) in a process.
_LOCK = threading.RLock()


def build_dir() -> str:
    """The directory kernels are built into and loaded from, read at build
    time: :data:`BUILD_DIR` unless ``utils/cache`` set another."""
    return _build_dir[0] if _build_dir else BUILD_DIR


def set_build_dir(path: str) -> None:
    """Build and load this process's kernels from ``path`` from now on
    (``utils/cache.enable_persistent_compilation_cache``). A library
    already loaded stays loaded."""
    _build_dir[:] = [path]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def metric_code(metric: str, form: str | None) -> int:
    """The kernels' code for a metric (and euclidean form). Pearson is
    refused: its points are centred first and run as cosine
    (:func:`kernel_points`)."""
    key = (metric, form if metric == "euclidean" else None)
    if key not in METRIC_CODES:
        raise ValueError(
            f"no kernel metric code for {metric!r} (form {form!r}); pearson runs as "
            "cosine over rows centred by cuda_build.kernel_points"
        )
    return METRIC_CODES[key]


def kernel_points(x, metric: str):
    """The points a kernel takes for ``metric`` and the metric it runs:
    pearson's rows centred once (``core/distances.centre_rows``, O(n d)
    preparation outside the pairwise scan, on the points' own device, so
    kernel and plain version see the same tensor) under cosine; the points
    as they are otherwise."""
    if metric == "pearson":
        from hdbscan_tpu_torch.core.distances import centre_rows

        return centre_rows(x).contiguous(), "cosine"
    return x, metric


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _so_path(src: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (src, *_HEADERS):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(build_dir(), f"{src[:-3]}-{h.hexdigest()[:16]}.so")


def _start(src: str):
    """Start the nvcc build of one source; None when it is already built."""
    so = _so_path(src)
    if os.path.exists(so):
        return None
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )
    return proc, tmp, so


def _finish(src: str, job) -> None:
    global BUILDS
    if job is None:
        return
    proc, tmp, so = job
    out, err = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src} ({proc.returncode}):\n{out}{err}")
    os.replace(tmp, so)
    BUILDS += 1
    _built.add(src)


def build_all() -> None:
    """Build every kernel, one nvcc process per source, all at once; every
    process is waited for before a failure is raised."""
    errors = []
    with _LOCK:
        jobs = {src: _start(src) for src in SOURCES}
        for src, job in jobs.items():
            try:
                _finish(src, job)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def function(src: str, sym: str, argtypes):
    """The C function ``sym`` of ``csrc/<src>`` (returning int) through
    ctypes, building the source if needed."""
    global CACHE_HITS
    key = (src, sym)
    fn = _fns.get(key)
    if fn is not None:
        return fn
    with _LOCK:  # the first caller builds and loads; the rest wait for it
        fn = _fns.get(key)
        if fn is None:
            lib = _libs.get(src)
            if lib is None:
                _finish(src, _start(src))
                lib = _libs[src] = ctypes.CDLL(_so_path(src))
                if src not in _built:
                    CACHE_HITS += 1
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[key] = fn
    return fn


def kernel(name: str):
    """The ctypes entry point of kernel ``name``, building it if needed."""
    src, sym, argtypes = KERNELS[name]
    return function(src, sym, argtypes)


def launch(name: str, device, *args, wide: bool = False) -> None:
    """Launch kernel ``name`` on ``device`` (the device its tensors lie on,
    from :func:`launch_device`), on that device's current stream, and count
    it (under ``<name>_wide`` when ``wide``: the launch's k or d is past
    :data:`WIDE`); raises on a refused launch (``cudaGetLastError`` != 0)."""
    import torch

    fn = kernel(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
    LAUNCHES[f"{name}_wide" if wide else name] += 1


def launch_device(name: str, *tensors):
    """Wrappers' guard: the one CUDA device all of a launch's tensors lie
    on. A tensor on another kind of device is refused (there is no other
    route), and so are tensors on two different cards."""
    devices = {t.device for t in tensors}
    for dev in devices:
        if dev.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got one on {dev}")
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors lie on several devices {sorted(map(str, devices))}")
    return devices.pop()


def resolve_device(device=None):
    """The device an entry point runs on: the card unless the caller names
    another (the tests pass ``"cpu"``). Raises when no card is present."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the port runs on the card; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        return torch.device("cuda")
    return torch.device(device)
