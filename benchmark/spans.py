"""Host spans around the benchmark's calls into the port: each span's
durations on the host clock and, while a trace is taken (``timeline`` is
a list), each span's start and end, so that the trace can say what the
host was doing while the device sat idle."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Spans:
    def __init__(self):
        self.durations: dict[str, list[float]] = defaultdict(list)
        self.timeline: list[tuple[str, float, float]] | None = None

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            self.durations[name].append(end - t)
            if self.timeline is not None:
                self.timeline.append((name, t, end))
