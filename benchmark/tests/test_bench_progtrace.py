"""The program's spans on a trace (``benchmark/progtrace.py``), from
synthetic events: each idle gap is labelled by the innermost program span
open at its middle, ahead of the benchmark's own spans; ``idle_by_span``
sums to the stretch's idle time; and every reader reads its spans and
counters, and returns None without a stretch or without its spans."""

from __future__ import annotations

import pytest

from benchmark import devtrace, progtrace
from guitar_tablature_classification_tpu_torch.utils.profiling import Span

MARK_PERF = 5.0  # the host clock at the mark, seconds


def _host(us: float) -> float:
    """The host clock of trace time ``us`` (the mark at 1000 us)."""
    return MARK_PERF + (us - 1000.0) * 1e-6


def _events(kernels) -> list[dict]:
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamQuery", "ts": 1000.0, "dur": 1.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 1990.0,
           "dur": 10.0}]
    for i, (a, b) in enumerate(kernels):
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": a, "dur": b - a,
                   "args": {"correlation": i}})
    return ev


def _span(i, name, a, b, parent=None, request=0) -> Span:
    return Span(i, name, _host(a), _host(b), parent, request)


# one step: the program's spans (us on the trace's clock) and the benchmark's
PROGRAM = [
    _span(1, "train.forward", 1100, 1400, parent=0),
    _span(2, "train.backward", 1400, 1800, parent=0),
    _span(0, "train.step", 1030, 1900),
    _span(4, "data.prefetch_wait", 1940, 1980, parent=3, request=None),
    _span(3, "data.prefetch", 1900, 1990, request=None),
]
BENCH = [("step", _host(1000), _host(1900)), ("prefetch_wait", _host(1900), _host(1995))]
KERNELS = [(1020, 1100), (1300, 1500), (1600, 1700), (1920, 1930)]


@pytest.fixture
def stretch() -> progtrace.Stretch:
    trace = devtrace.parse(_events(KERNELS), MARK_PERF, progtrace.timeline(PROGRAM, BENCH))
    trace.extra = {"units": 1}
    return progtrace.Stretch(trace, PROGRAM, {})


def test_each_gap_gets_the_innermost_span(stretch):
    gaps = [(label, round(s * 1e6, 6)) for label, s in stretch.trace.idle_gaps()]
    assert gaps == [("step", 20.0),  # before the program's step opened: the benchmark's span
                    ("train.forward", 200.0), ("train.backward", 100.0),
                    ("train.step", 220.0), ("data.prefetch_wait", 70.0)]


def test_idle_by_span_sums_to_the_idle_time(stretch):
    by = dict(progtrace.idle_by_span(stretch))
    idle_ms = 1e3 * (stretch.trace.window_s - stretch.trace.busy_s())
    assert sum(by.values()) == pytest.approx(idle_ms, rel=1e-12)
    assert by["train.step"] == pytest.approx(0.22)
    assert progtrace.labelled_share(stretch) == pytest.approx(100.0 * 590 / 610)
    assert progtrace.idle_by_span(stretch)[0][0] == "train.step"  # the largest first


def test_training_readers(stretch):
    got = {k: r(stretch) for k, (_, r) in progtrace.READERS.items()}
    assert got["forward_host_ms.train"] == pytest.approx(0.3)
    assert got["backward_host_ms.train"] == pytest.approx(0.4)
    assert got["features_host_ms.train"] == 0.0 and got["update_host_ms.train"] == 0.0
    assert got["prefetch_blocked_ms.train"] == pytest.approx(0.04)
    assert all(got[k] is None for k in got if k.endswith(".serve"))


def test_serving_readers():
    spans, k = [], 0
    for track in range(2):
        t0 = 1000 + 5000 * track
        spans += [_span(k + 1, "serve.h2d", t0 + 100, t0 + 1100, parent=k + 3, request=track),
                  _span(k + 2, "serve.forward", t0 + 1100, t0 + 1600, parent=k + 3,
                        request=track),
                  _span(k + 3, "serve.bucket", t0 + 100, t0 + 1700, parent=k, request=track),
                  _span(k + 4, "serve.fetch", t0 + 1700, t0 + 3700, parent=k, request=track),
                  _span(k, "serve.transcribe", t0, t0 + 4000, request=track)]
        k += 5
    trace = devtrace.Trace(stretch=(1000.0, 11000.0), device=[], launched=[], host=[],
                           extra={"units": 2})
    st = progtrace.Stretch(trace, spans, {"serve.rows_real": 46, "serve.rows_forwarded": 48})
    got = {k: r(st) for k, (_, r) in progtrace.READERS.items()}
    assert got["bucket_fill.serve"] == pytest.approx(100.0 * 46 / 48)
    assert got["h2d_host_ms_per_track.serve"] == pytest.approx(1.0)
    assert got["forward_host_ms_per_track.serve"] == pytest.approx(0.5)
    assert got["device_wait_share.serve"] == pytest.approx(50.0)
    assert all(got[k] is None for k in got if k.endswith(".train"))


def test_every_reader_is_none_without_the_stretch():
    empty = progtrace.Stretch(devtrace.Trace(stretch=(0.0, 1.0), device=[], launched=[], host=[],
                                             extra={"units": 1}), [], {})
    for name, (unit, read) in progtrace.READERS.items():
        assert unit in ("ms", "%")
        assert read(None) is None and read(empty) is None, name


def test_a_trace_whose_kernels_left_the_stretch_is_misplaced():
    """The stretch ends with a device synchronize, so a kernel launched in
    it that the trace puts after the end (or before the mark) means the
    device's clock slipped against the host's: the harness takes the
    stretch again."""
    launched = [("k0", 1100.0, 1300.0), ("k1", 1300.0, 1990.5)]
    trace = devtrace.Trace(stretch=(1000.0, 2000.0), device=[], launched=launched, host=[])
    assert trace.misplaced() == 0
    trace.launched.append(("k2", 3500.0, 3600.0))  # past the end by more than 1 ms
    trace.launched.append(("k3", -400.0, -300.0))
    assert trace.misplaced() == 2
