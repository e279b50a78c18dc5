"""The device trace of a short steady stretch, and what is read from it.

``take(run_stretch, spans)`` runs ``run_stretch()`` under
``torch.profiler`` with CUDA activity only (CUPTI's kernel, copy and
runtime-call records; recording every CPU op would slow the host and
inflate the idle share), exports the Chrome trace to a temporary file
(under ``TMPDIR``), reads it and deletes it.  ``run_stretch`` opens the
part to measure with :func:`mark` (a ``cudaStreamQuery``, which nothing
else in a step calls) and closes it with a device synchronize
(``cudaDeviceSynchronize``).  The device's work in that range (kernels,
copies, sets) is read by time: the union of their intervals is its busy
time, the rest is idle.  Each idle gap is labelled by the benchmark span
open on the host at its middle, or ``outside``: the spans' host clock is
put on the trace's by the mark's own runtime record.  Kernels are counted
and timed by launch: those whose launching runtime call (matched by
CUPTI's correlation id) lies in the range, so that the work queued before
it does not count and the work it queued does.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    stretch: tuple[float, float]  # us on the trace's clock: the mark to the synchronize
    device: list[tuple[str, str, float, float]]  # (cat, name, start us, end us)
    launched: list[tuple[str, float, float]]  # kernels launched in the stretch: (name, start, end)
    host: list[tuple[str, float, float]]  # the benchmark's spans: (name, start, end)
    extra: dict = field(default_factory=dict)  # what the driver recorded alongside

    @property
    def window_s(self) -> float:
        return (self.stretch[1] - self.stretch[0]) * 1e-6

    def kernel_count(self, name: str) -> int:
        """Kernels launched in the stretch whose name is ``name`` or a
        template of it."""
        return sum(1 for n, _, _ in self.launched if _base(n) == name)

    def kernel_s(self, names: tuple[str, ...]) -> float:
        """Device seconds of the kernels of these names launched in the
        stretch."""
        return 1e-6 * sum(b - a for n, a, b in self.launched if _base(n) in names)

    def misplaced(self, slack_us: float = 1000.0) -> int:
        """Kernels launched in the stretch whose device interval lies
        outside it: the stretch ends with a device synchronize, so none
        can, and a trace whose device clock slipped against the host's
        (seen on the card: a whole stretch's kernels after its end) holds
        some."""
        lo, hi = self.stretch
        return sum(1 for _, a, b in self.launched if a < lo - slack_us or b > hi + slack_us)

    def busy_intervals(self) -> list[tuple[float, float]]:
        lo, hi = self.stretch
        spans = sorted((max(a, lo), min(b, hi)) for _, _, a, b in self.device if b > lo and a < hi)
        merged: list[list[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return 1e-6 * sum(b - a for a, b in self.busy_intervals())

    def idle_gaps(self) -> list[tuple[str, float]]:
        """(label, seconds) of every idle gap in the stretch."""
        lo, hi = self.stretch
        edges, t = [], lo
        for a, b in self.busy_intervals():
            if a > t:
                edges.append((t, a))
            t = max(t, b)
        if hi > t:
            edges.append((t, hi))
        out = []
        for a, b in edges:
            mid = 0.5 * (a + b)
            label = next((n for n, s, e in self.host if s <= mid <= e), "outside")
            out.append((label, 1e-6 * (b - a)))
        return out

    def top_device_ops(self, k: int = 10) -> list[list]:
        totals: dict[str, float] = {}
        lo, hi = self.stretch
        for _, n, a, b in self.device:
            if a >= lo and b <= hi:
                totals[n] = totals.get(n, 0.0) + 1e-6 * (b - a)
        return [[n, s] for n, s in sorted(totals.items(), key=lambda x: -x[1])[:k]]


def _base(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return name.split(" ")[-1].split("::")[-1]


def mark(device) -> float:
    """Open the measured range: a ``cudaStreamQuery`` on the device's
    stream; returns the host clock just before it."""
    import torch

    t = time.perf_counter()
    torch.cuda.current_stream(device).query()
    return t


def parse(events: list[dict], mark_perf: float, spans: list[tuple[str, float, float]]) -> Trace:
    """``spans``: (name, start, end) on the host's ``perf_counter``."""
    device, calls, kernels, marks, syncs = [], {}, [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((cat, name, a, b))
            if cat == "kernel":
                kernels.append((name, a, b, corr))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if corr is not None:
                calls[corr] = a
            if name == "cudaStreamQuery":
                marks.append(a)
            elif name == "cudaDeviceSynchronize":
                syncs.append(b)
    if not marks or not syncs:
        raise RuntimeError("the trace holds no stretch: no cudaStreamQuery mark or no "
                           "cudaDeviceSynchronize after it")
    lo = marks[0]
    hi = max(syncs)
    offset = lo - 1e6 * mark_perf
    host = [(n, offset + 1e6 * a, offset + 1e6 * b) for n, a, b in spans]
    launched = [(n, a, b) for n, a, b, c in kernels if c in calls and lo <= calls[c] <= hi]
    return Trace(stretch=(lo, hi), device=device, launched=launched,
                 host=[h for h in host if h[2] > lo and h[1] < hi])


def warm_up() -> None:
    """Start and stop the profiler once, so a later trace does not pay its
    first start (set-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def take(run_stretch, spans) -> Trace:
    """``run_stretch()`` returns what the driver recorded, with the host
    clock of its :func:`mark` under ``mark``; ``spans`` is the benchmark's
    :class:`.spans.Spans`, whose timeline fills while the stretch runs."""
    from torch.profiler import ProfilerActivity, profile

    spans.timeline = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        extra = run_stretch()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    trace = parse(events, extra["mark"], spans.timeline)
    spans.timeline = None
    trace.extra = extra
    return trace
