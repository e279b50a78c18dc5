"""The program's own spans and counters over one more traced stretch, and
what they say of the device's idle time.

The port records spans and counters while its recorder is on
(``utils.profiling.recording``): ``train.step`` and its phases
``train.features``, ``train.forward``, ``train.backward``,
``train.update``; ``data.prefetch`` and ``data.prefetch_wait``;
``serve.transcribe`` and its ``serve.frame``, ``serve.bucket`` (with
``serve.pad``, ``serve.h2d``, ``serve.forward``), ``serve.fetch``,
``serve.smooth``; the counters ``serve.rows_real`` and
``serve.rows_forwarded``.  :func:`take` runs a cell's traffic stretch
(``drv.stretch`` through :func:`.devtrace.take`) with the recorder on,
drops what the steps before the stretch's mark recorded, and puts the
program's spans into the host timeline ahead of the benchmark's, shortest
first: ``Trace.idle_gaps`` labels a gap by the first span that holds its
middle, so each gap gets the innermost program span open then.
:data:`READERS` read such a stretch; each returns None without one (a
program without the recorder, a CPU run, a cell of the other kind).

The harness's traced stretch runs with the recorder off and takes no such
stretch.  This module runs beside it:

    python3 -m benchmark.progtrace --workload <name> --seed <n> [--pairs 3]

sets the cell up as ``benchmark.run`` does, then takes ``--pairs`` pairs of
stretches in turn, the harness's (recorder off) and this module's (on),
and prints one JSON line: for each stretch the benchmark's span mean
(``step`` or ``transcribe``) and the device's idle share, and for each
stretch with the recorder on ``idle_by_span``, the share of idle time a
program span labels, and each reader's value; then the medians.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass

from . import devtrace


@dataclass
class Stretch:
    trace: devtrace.Trace
    spans: list  # the program's spans from the mark on (``utils.profiling.Span``)
    counters: dict[str, int]

    @property
    def units(self) -> int:
        return self.trace.extra["units"]


def _profiling():
    """The port's ``utils.profiling``, or None where it has no recorder."""
    from guitar_tablature_classification_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "recording") else None


def timeline(program: list, bench: list[tuple[str, float, float]]) -> list[tuple]:
    """The host timeline for ``Trace.idle_gaps``: the program's spans,
    shortest first, ahead of the benchmark's (name, start, end)."""
    ours = sorted(((s.name, s.start, s.end) for s in program), key=lambda s: s[2] - s[1])
    return ours + list(bench)


def take(drv, spans) -> Stretch | None:
    """One traced stretch of ``drv`` with the program's recorder on;
    ``spans`` is the :class:`.spans.Spans` ``drv`` records into.  None where the
    program has no recorder."""
    profiling = _profiling()
    if profiling is None:
        return None
    got = {}

    def run_stretch() -> dict:
        real = devtrace.mark

        def mark(device) -> float:
            rec.drain()  # the steps before the mark
            return real(device)

        with profiling.recording() as rec:
            devtrace.mark = mark  # ``drv.stretch`` looks it up when it runs
            try:
                extra = drv.stretch()
            finally:
                devtrace.mark = real
            got["spans"], got["counters"] = rec.drain()
        spans.timeline[:] = timeline(got["spans"], spans.timeline)
        return extra

    trace = devtrace.take(run_stretch, spans)
    return Stretch(trace, got["spans"], got["counters"])


def idle_by_span(st: Stretch) -> list[list]:
    """[label, idle ms a step or track] over every idle gap of the stretch,
    the largest first."""
    totals: dict[str, float] = {}
    for label, s in st.trace.idle_gaps():
        totals[label] = totals.get(label, 0.0) + s
    return [[k, 1e3 * v / st.units] for k, v in sorted(totals.items(), key=lambda x: -x[1])]


def labelled_share(st: Stretch) -> float | None:
    """Share of the stretch's idle time that a program span labels, %."""
    gaps = st.trace.idle_gaps()
    idle = sum(s for _, s in gaps)
    if not idle:
        return None
    names = {s.name for s in st.spans}
    return 100.0 * sum(s for label, s in gaps if label in names) / idle


def bench_span_ms(trace: devtrace.Trace, name: str) -> float | None:
    """Mean host ms of the benchmark's span ``name`` in a stretch."""
    d = [b - a for n, a, b in trace.host if n == name]
    return 1e-3 * statistics.fmean(d) if d else None


def idle_share(trace: devtrace.Trace) -> float:
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def _has(st: Stretch | None, unit: str) -> bool:
    return st is not None and any(s.name == unit for s in st.spans)


def _self_ms(st: Stretch | None, name: str) -> float | None:
    """Self ms of the spans ``name`` a step (the spans it encloses left out)."""
    if not _has(st, "train.step"):
        return None
    own = _profiling().self_times(st.spans)
    return 1e3 * sum(own[s.id] for s in st.spans if s.name == name) / st.units


def _sum_ms(st: Stretch | None, name: str, unit: str) -> float | None:
    """Host ms of the spans ``name`` summed, a step or track."""
    if not _has(st, unit):
        return None
    return 1e3 * sum(s.end - s.start for s in st.spans if s.name == name) / st.units


def _bucket_fill(st: Stretch | None) -> float | None:
    forwarded = st.counters.get("serve.rows_forwarded", 0) if st is not None else 0
    return 100.0 * st.counters.get("serve.rows_real", 0) / forwarded if forwarded else None


def _device_wait_share(st: Stretch | None) -> float | None:
    whole = _sum_ms(st, "serve.transcribe", "serve.transcribe")
    return 100.0 * _sum_ms(st, "serve.fetch", "serve.transcribe") / whole if whole else None


# per-layer metric -> (unit, reader of a Stretch or None)
READERS = {
    "features_host_ms.train": ("ms", lambda st: _self_ms(st, "train.features")),
    "forward_host_ms.train": ("ms", lambda st: _self_ms(st, "train.forward")),
    "backward_host_ms.train": ("ms", lambda st: _self_ms(st, "train.backward")),
    "update_host_ms.train": ("ms", lambda st: _self_ms(st, "train.update")),
    "prefetch_blocked_ms.train": ("ms", lambda st: _sum_ms(st, "data.prefetch_wait",
                                                           "train.step")),
    "bucket_fill.serve": ("%", _bucket_fill),
    "h2d_host_ms_per_track.serve": ("ms", lambda st: _sum_ms(st, "serve.h2d",
                                                             "serve.transcribe")),
    "forward_host_ms_per_track.serve": ("ms", lambda st: _sum_ms(st, "serve.forward",
                                                                 "serve.transcribe")),
    "device_wait_share.serve": ("%", _device_wait_share),
}


def _median(values: list) -> float | None:
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    from . import run as _environment  # noqa: F401  (the run's threads and variables)

    p = argparse.ArgumentParser(prog="benchmark.progtrace", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=3)
    args = p.parse_args(argv)

    import torch

    from . import harness
    from .spans import Spans

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("benchmark.progtrace: needs a CUDA card", file=sys.stderr)
        return 3
    if _profiling() is None:
        print("benchmark.progtrace: the program has no span recorder", file=sys.stderr)
        return 4
    torch.set_num_threads(1)
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda")
    spans = Spans()
    drv = harness.driver(cell, args.seed, dev, spans)
    drv.setup()
    devtrace.warm_up()
    unit = "step" if drv.kind == "train" else "transcribe"
    pairs = []
    for _ in range(args.pairs):
        off = devtrace.take(drv.stretch, spans)
        on = take(drv, spans)
        pairs.append({
            "off": {"span_ms": bench_span_ms(off, unit), "idle_share": idle_share(off)},
            "on": {"span_ms": bench_span_ms(on.trace, unit), "idle_share": idle_share(on.trace),
                   "spans_per_unit": len(on.spans) / on.units,
                   "idle_by_span": idle_by_span(on), "labelled_share": labelled_share(on),
                   "metrics": {k: r(on) for k, (_, r) in READERS.items() if r(on) is not None}}})
    median = {f"{side}.{k}": _median([p[side][k] for p in pairs])
              for side in ("off", "on") for k in ("span_ms", "idle_share")}
    median["on.labelled_share"] = _median([p["on"]["labelled_share"] for p in pairs])
    for k in pairs[0]["on"]["metrics"]:
        median[k] = _median([p["on"]["metrics"].get(k) for p in pairs])
    print(json.dumps({"workload": args.workload, "seed": args.seed, "unit": unit,
                      "device": torch.cuda.get_device_name(dev), "pairs": pairs,
                      "median": median}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
