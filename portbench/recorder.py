"""Recorders around the port's entry points, kept with the benchmark.

:class:`CallRecorder` wraps ``module.name`` for a window, counting its calls
and keeping their arguments; the wrapped call runs as before. The others
build on it: :class:`LaunchRecorder` keeps the arguments of the kernel
launches through ``ops/cuda_build.launch`` whose names it is given,
:class:`SegminRecorder` the component labels of every segment-min launch
(copied on the device, read after the window), and :class:`Spans` names
host phases in the profiler's timeline. A per-layer metric's ``record()``
returns the recorder it reads.
"""

from __future__ import annotations

import contextlib
import importlib


class CallRecorder:
    """Wraps ``mod.name`` during a ``with`` block: counts its calls and
    keeps ``(args, kw)`` of the first ``keep`` (every call when None)."""

    def __init__(self, mod, name: str, keep: int | None = None):
        self.mod, self.name, self.keep = mod, name, keep
        self.orig = getattr(mod, name)
        self.calls, self.count = [], 0

    def record(self, args, kw):
        self.count += 1
        if self.keep is None or len(self.calls) < self.keep:
            self.calls.append((args, kw))

    def __enter__(self):
        def rec(*args, **kw):
            self.record(args, kw)
            return self.orig(*args, **kw)

        setattr(self.mod, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


class LaunchRecorder(CallRecorder):
    """Every ``cuda_build.launch(name, device, *args)`` with ``name`` in
    ``names``: (name, the arguments past the device)."""

    def __init__(self, names):
        super().__init__(importlib.import_module("hdbscan_tpu_torch.ops.cuda_build"), "launch")
        self.names = frozenset(names)
        self.launches: list = []

    def record(self, args, kw):
        self.count += 1
        if args and args[0] in self.names:
            self.launches.append((args[0], tuple(args[2:])))


class SegminRecorder(CallRecorder):
    """Every segment-min launch (``ops/cuda_segmin._launch``): d, the metric
    code and copies of the rows' and columns' component labels and validity
    (the columns are the rows in a square B1 launch)."""

    def __init__(self):
        super().__init__(importlib.import_module("hdbscan_tpu_torch.ops.cuda_segmin"), "_launch")
        self.launches: list = []

    def record(self, args, kw):
        self.count += 1
        name, _dev, rows, cols, code = args[:5]
        cols = rows if cols is None else cols
        self.launches.append((name, rows[0].shape[1], code, rows[2].clone(),
                              rows[3].clone(), cols[2].clone(), cols[3].clone()))

    def bounds(self):
        """Least seconds of every recorded launch."""
        from portbench.roofline import segmin_bound

        out = []
        for _name, d, code, cr, vr, cc, vc in self.launches:
            out.append(segmin_bound(d, code, cr.cpu().numpy(), vr.cpu().numpy().astype(bool),
                                    cc.cpu().numpy(), vc.cpu().numpy().astype(bool)))
        return out


class Spans(contextlib.ExitStack):
    """Names host phases in the profiler's timeline: each ``(module path,
    function or Class.method, label)`` is wrapped in ``torch.profiler.record_function(label)``
    while the block runs. Functions the port imports at call time are
    looked up there, so the wrapper is what runs."""

    def __init__(self, spans):
        super().__init__()
        self.spans = spans

    def __enter__(self):
        super().__enter__()
        import torch

        for path, qualname, label in self.spans:
            mod = importlib.import_module(path)
            *owners, name = qualname.split(".")
            for owner in owners:
                mod = getattr(mod, owner)
            orig = getattr(mod, name)

            def wrapped(*args, _orig=orig, _label=label, **kw):
                with torch.profiler.record_function(_label):
                    return _orig(*args, **kw)

            self.enter_context(_Swap(mod, name, wrapped))
        return self


class _Swap:
    def __init__(self, mod, name, fn):
        self.mod, self.name, self.fn = mod, name, fn
        self.orig = getattr(mod, name)

    def __enter__(self):
        setattr(self.mod, self.name, self.fn)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)
