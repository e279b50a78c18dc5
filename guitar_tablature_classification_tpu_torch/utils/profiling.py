"""Profiling hooks: ``torch.profiler`` traces and a throughput meter (the
JAX package's ``utils/profiling.py``).

The reference's only instrumentation is wall-clock epoch timing
(bestengine.py:892,973).  Here: optional trace capture around any code
region (a Chrome trace, viewable in Perfetto, plus a table of the top
device ops) and a steady-state throughput meter whose ``stop()``
synchronises the device before it reads the clock.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``log_dir``: ``trace.json`` (Chrome trace format) and ``ops.txt``, the
    top 25 ops by device time (by host time without a card)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    ops = prof.key_averages()
    sort_by = "self_cpu_time_total"
    if cuda and len(ops):  # the device times' name since torch 2.4, else the older one
        sort_by = ("self_device_time_total" if hasattr(ops[0], "self_device_time_total")
                   else "self_cuda_time_total")
    with open(os.path.join(log_dir, "ops.txt"), "w") as f:
        f.write(ops.table(sort_by=sort_by, row_limit=25))


class ThroughputMeter:
    """Counts items (segments) between start() and stop()."""

    def __init__(self):
        self.items = 0
        self._t0 = None
        self.elapsed = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self.items = 0

    def count(self, n: int) -> None:
        self.items += n

    def stop(self, device: str | torch.device | None = None) -> float:
        """Returns items/sec.  On a CUDA ``device`` (or with ``device``
        None and a card present) the device is synchronised first, so the
        clock stops after the work the region enqueued."""
        dev = torch.device(device) if device is not None else None
        if dev is None and torch.cuda.is_available() or dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.elapsed = time.perf_counter() - self._t0
        return self.items / self.elapsed if self.elapsed else 0.0
