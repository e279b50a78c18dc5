"""Profiling hooks: ``torch.profiler`` traces and the program's own spans
and counters.

The reference's only instrumentation is wall-clock epoch timing
(bestengine.py:892,973).  Here:

- :func:`trace` captures a ``torch.profiler`` trace of any code region (a
  Chrome trace, viewable in Perfetto, with the program's spans of the
  region on a row of their own, and a table of the top device ops).
- :func:`span` and :func:`count` mark the program's phases (the train
  step's, the prefetch's, the Transcriber's) and count what they do.  While
  no :func:`recording` is open they record nothing: a span costs one check
  of a module-level variable and returns a shared null context, and a count
  does nothing.  Under :func:`recording` each span keeps its name,
  start and end on ``time.perf_counter``, its enclosing span and its
  request (the training step or the track), and the counters add up.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import time
from typing import Iterator, NamedTuple

import torch

# the profiler range whose host clock puts the spans on a trace's clock
MARK = "profiling.mark"


class Span(NamedTuple):
    id: int
    name: str
    start: float  # time.perf_counter()
    end: float
    parent: int | None  # the id of the enclosing span
    request: int | None  # the training step or the track's sequence number


class Recorder:
    """The spans closed and the counters added since the last :meth:`drain`,
    recorded by one thread."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: collections.Counter = collections.Counter()
        self._ids = itertools.count()
        self._open: list[_OpenSpan] = []  # the spans open, innermost last

    def drain(self) -> tuple[list[Span], dict[str, int]]:
        """The spans and counters recorded so far; clears them."""
        spans, counters = self.spans, dict(self.counters)
        self.spans, self.counters = [], collections.Counter()
        return spans, counters


class _OpenSpan:
    __slots__ = ("rec", "name", "request", "id", "parent", "start")

    def __init__(self, rec: Recorder, name: str, request: int | None):
        self.rec, self.name, self.request = rec, name, request

    def __enter__(self):
        opened = self.rec._open
        outer = opened[-1] if opened else None
        self.parent = outer.id if outer is not None else None
        if self.request is None and outer is not None:
            self.request = outer.request
        self.id = next(self.rec._ids)
        opened.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter()
        self.rec._open.pop()
        self.rec.spans.append(Span(self.id, self.name, self.start, end, self.parent,
                                   self.request))
        return False


_recorder: Recorder | None = None
_OFF = contextlib.nullcontext()


def span(name: str, request: int | None = None):
    """A context manager that records the enclosed phase as ``name`` while a
    :func:`recording` is open.  ``request`` defaults to the enclosing
    span's."""
    if _recorder is None:
        return _OFF
    return _OpenSpan(_recorder, name, request)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a :func:`recording` is open."""
    if _recorder is not None:
        _recorder.counters[name] += n


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Record spans and counters into a new :class:`Recorder` for the
    enclosed region (an outer recording gets none of them)."""
    global _recorder
    outer, _recorder = _recorder, Recorder()
    try:
        yield _recorder
    finally:
        _recorder = outer


def self_times(spans: list[Span]) -> dict[int, float]:
    """Each span's seconds less those of the spans it encloses, by id."""
    own = {s.id: s.end - s.start for s in spans}
    for s in spans:
        if s.parent in own:
            own[s.parent] -= s.end - s.start
    return own


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``log_dir``: ``trace.json`` (Chrome trace format), with the program's
    spans of the region as complete events on a thread row named ``program
    spans``, and ``ops.txt``, the top 25 ops by device time (by host time
    without a card)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording() as rec, profile(activities=activities) as prof:
        for _ in range(2):  # the first range pays for the profiler's first record
            t0 = time.perf_counter()
            with record_function(MARK):
                pass
            mark = 0.5 * (t0 + time.perf_counter())
        yield
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, rec.drain()[0], mark)
    ops = prof.key_averages()
    sort_by = "self_cpu_time_total"
    if cuda and len(ops):  # the device times' name since torch 2.4, else the older one
        sort_by = ("self_device_time_total" if hasattr(ops[0], "self_device_time_total")
                   else "self_cuda_time_total")
    with open(os.path.join(log_dir, "ops.txt"), "w") as f:
        f.write(ops.table(sort_by=sort_by, row_limit=25))


def _add_spans(path: str, spans: list[Span], mark: float) -> None:
    """Write ``spans`` into the Chrome trace at ``path`` as complete events,
    on the trace's clock: the middle of the last :data:`MARK` range is the
    host clock ``mark``."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    ref = max((e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
               and e.get("name") == MARK), key=lambda e: float(e["ts"]))
    offset = float(ref["ts"]) + 0.5 * float(ref.get("dur", 0.0)) - 1e6 * mark
    pid = ref["pid"]
    tid = 1 + max((e["tid"] for e in events if isinstance(e.get("tid"), int)), default=0)
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": "program spans"}})
    for s in spans:
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": tid,
                       "ts": offset + 1e6 * s.start, "dur": 1e6 * (s.end - s.start),
                       "args": {"request": s.request, "id": s.id, "parent": s.parent}})
    with open(path, "w") as f:
        json.dump(doc, f)
