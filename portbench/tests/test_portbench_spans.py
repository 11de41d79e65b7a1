"""The per-layer metrics that read the program's own spans
(``program_spans.py``): each reads a number in a traced run of every cell
it lists, on the CPU at small sizes; against a program without spans each
reads nothing and raises nothing. On the card (``card``): the card's busy
time under the spans against the profile's kernels, and the batcher
worker's shares against the window."""

import time

import pytest
import torch

from conftest import small_cell
from portbench import harness, profile, spec

CPU = [torch.device("cpu")]
SMALL = {"config": {"n": 2000, "min_cluster_size": 40}}
SERVE = {"config": {"n": 2000, "min_cluster_size": 40},
         "traffic": {"pool_rows": 20_000, "clients": 4, "sample_requests": 8}}
SPAN_METRICS = {"worker_wait_share.predict", "worker_linger_share.predict",
                "worker_host_share.predict", "bucket_device_ms.predict", "bucket_fill.predict",
                "round_host_ms.fit", "core_host_s.fit"}
#: The card's busy time only: no number without a card.
DEVICE_ONLY = {"bucket_device_ms.predict"}


def _traced(cell, devices=CPU, seed=987654321987):
    return harness.run(cell, seed, 0.5, True, devices, time.perf_counter())


def _listed(name):
    return {m["name"] for m in spec.cell(name)["per_layer"]} & SPAN_METRICS


@pytest.mark.parametrize("name,over", [("skin.predict", SERVE), ("skin.fit", SMALL),
                                       ("hepmass28.fit", SMALL)])
def test_span_metrics_read_a_number(name, over):
    r = _traced(small_cell(name, **over))
    assert r["correct"]
    listed = _listed(name)
    assert listed
    for m in listed - DEVICE_ONLY:
        v = r["metrics"][m]["value"]
        assert isinstance(v, float) and v >= 0.0, m
    assert not listed & DEVICE_ONLY & set(r["metrics"])  # the CPU has no device time
    if name == "skin.predict":
        fill = r["metrics"]["bucket_fill.predict"]["value"]
        assert 0.0 < fill <= 100.0


def test_span_metrics_are_silent_without_spans(monkeypatch):
    """The benchmark's files laid over a program that has no spans: the
    new metrics read nothing, the run goes on."""
    from hdbscan_tpu_torch.utils import tracing

    monkeypatch.delattr(tracing, "install")
    r = _traced(small_cell("skin.predict", **SERVE))
    assert r["correct"] and not set(r["metrics"]) & SPAN_METRICS
    assert "bucket_rows.predict" in r["metrics"]


def _window(card, name, seconds):
    """A traced window of cell ``name``, with a tracer that wants
    ``device_ms`` installed too (the benchmark's own asks for none)."""
    from hdbscan_tpu_torch.utils import tracing

    cell = spec.cell(name)
    loop = spec.kind(cell["traffic"]["kind"], cell["base"]).Loop(cell, 4000000007, [card])
    loop.setup()
    with tracing.install(tracing.Tracer()):
        out, recorded, prof = harness.traced_window(loop, cell, seconds)
    metrics = harness.per_layer(cell, loop, recorded, prof)
    loop.release()
    return recorded, prof, metrics


@pytest.mark.card
def test_device_time_against_the_profile(card):
    """skin.predict: the card's busy time under the ``predict.bucket``
    spans is 1.0-1.3 times the profile's ``knn_kbest*`` kernel time (every
    such kernel runs inside a bucket, beside the bucket's smaller ones);
    the buckets' ``device_ms`` encloses those kernels too. The worker's
    wait, linger and host shares with the buckets' busy time make 90-105%
    of the window. skin.fit: the busy time and the ``device_ms`` of the
    ``boruvka.round`` spans cover the ``segmin`` kernels."""
    recorded, prof, metrics = _window(card, "skin.predict", 5.0)
    tl = recorded["bucket_device_ms.predict"].timeline
    spans = tl.spans("predict.bucket")
    busy_s = sum(tl.busy_us(a, b) for a, b, _ in spans) / 1e6
    kbest = profile.device_s(prof, "knn_kbest")
    device_s = sum(f["device_ms"] for _, _, f in spans) / 1e3
    print(f"predict.bucket busy over knn_kbest* kernel time: {busy_s / kbest:.3f}; "
          f"device_ms over it: {device_s / kbest:.3f}; clock shift {tl.shift_us:.1f} us")
    assert 1.0 <= busy_s / kbest <= 1.3, (busy_s, kbest)
    assert device_s >= kbest, (device_s, kbest)
    shares = sum(metrics[m]["value"] for m in ("worker_wait_share.predict",
                                               "worker_linger_share.predict",
                                               "worker_host_share.predict"))
    total = shares + tl.share(busy_s * 1e6)
    print(f"worker shares {shares:.2f}% + buckets' busy time: {total:.2f}% of the window")
    assert 90.0 <= total <= 105.0, (shares, busy_s, tl.window_us)

    recorded, prof, _ = _window(card, "skin.fit", 4.0)
    tl = recorded["round_host_ms.fit"].timeline
    rounds = tl.spans("boruvka.round")
    busy_s = sum(tl.busy_us(a, b) for a, b, _ in rounds) / 1e6
    device_s = sum(f["device_ms"] for _, _, f in rounds) / 1e3
    segmin = profile.device_s(prof, "segmin")
    print(f"boruvka.round busy over segmin kernel time: {busy_s / segmin:.3f}; "
          f"device_ms over it: {device_s / segmin:.3f}")
    assert busy_s >= segmin and device_s >= segmin, (busy_s, device_s, segmin)


def test_busy_time_inside_an_interval():
    from portbench import program_spans

    busy = program_spans.Busy([[10.0, 20.0], [30.0, 35.0]])
    assert busy(0.0, 100.0) == 15.0
    assert busy(12.0, 18.0) == 6.0
    assert busy(15.0, 32.0) == 7.0
    assert busy(20.0, 30.0) == 0.0 and busy(0.0, 10.0) == 0.0
    assert program_spans.Busy([])(0.0, 5.0) == 0.0


class _Kineto:
    """A Kineto event stand-in."""

    def __init__(self, device, name, corr, start_ns, note=False):
        from torch.autograd import DeviceType

        self._d = DeviceType.CUDA if device else DeviceType.CPU
        self._n, self._c, self._s, self._u = name, corr, start_ns, note

    def device_type(self):
        return self._d

    def name(self):
        return self._n

    def correlation_id(self):
        return self._c

    def start_ns(self):
        return self._s

    def is_user_annotation(self):
        return self._u


def test_clock_shift_is_the_least_launch_delay():
    """Device stamps 700 µs ahead of the host's launches: the shift reads
    the least delay, -700 µs plus the shortest latency; host operations
    that are not CUDA calls, annotations and unlinked events count not."""
    from portbench import program_spans

    events = [_Kineto(False, "cudaLaunchKernel", 1, 1_000_000),
              _Kineto(True, "knn_kbest_kernel", 1, 1_000_000 - 700_000 + 4_000),
              _Kineto(False, "cudaMemcpyAsync", 2, 2_000_000),
              _Kineto(True, "Memcpy DtoH", 2, 2_000_000 - 700_000 + 9_000),
              _Kineto(False, "aten::mm", 3, 5_000_000),
              _Kineto(True, "gemm", 3, 100),
              _Kineto(True, "note", 1, 0, note=True),
              _Kineto(True, "unlinked", 99, 0)]
    assert program_spans.clock_shift_us(events) == -696.0
    assert program_spans.clock_shift_us(events[4:]) == 0.0
