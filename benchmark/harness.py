"""One run of one cell, found by name.

``BENCHMARK.json`` (at the checkout's root) names each cell's
configuration and traffic; the harness reads ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``limits/<cell>.json`` beside it, picks the
driver of the traffic's ``kind`` (``drivers/<kind>.py``), and reads each
metric with ``metrics/<metric>.py``'s ``read(run)``.  So a new cell, mix,
configuration or metric is a new file and a new entry; no table here
names them.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import check, counters, devtrace
from .spans import Spans

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "guitar_tablature_classification_tpu")
TRACE_ATTEMPTS = 3


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def load_cell(name: str) -> Cell:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in spec["end_to_end"] if _applies(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, names)]
    return Cell(name=name, workload=work, config=_json("configs", f"{work['config']}.json"),
                traffic=_json("traffic", f"{work['traffic']}.json"),
                limits=_json("limits", f"{name}.json"), end_to_end=e2e, per_layer=per_layer)


@dataclass
class Run:
    """What a metric's reader reads."""

    cell: Cell
    setup_s: float = 0.0
    window: dict = field(default_factory=dict)  # the driver's window record
    spans: dict = field(default_factory=dict)  # span name -> host seconds, the window's
    trace: devtrace.Trace | None = None

    def span_mean_ms(self, name: str) -> float | None:
        d = self.spans.get(name)
        return 1e3 * statistics.fmean(d) if d else None


def reader(metric: str):
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(cell: Cell, seed: int, device, spans: Spans):
    module = importlib.import_module(f".drivers.{cell.traffic['kind']}", __package__)
    return module.Driver(cell, seed, device, spans)


def judge(cell: Cell, drv, port_readings) -> dict:
    """Each number that the cell's limits name beside its limit; run after
    the port's state is freed.  ``port_readings``: the training driver's
    readings from set-up, or the serving driver's sampled results."""
    if drv.kind == "train":
        numbers = check.train_numbers(port_readings, drv.reference())
    else:
        served = [(out.frets, out.logits) for _, out in port_readings]
        refs = [drv.reference_logits(drv.tracks[i]).numpy() for i, _ in port_readings]
        numbers = check.serve_numbers(served, refs, cell.traffic["smooth_window"])
    return {k: {"value": numbers[k], "limit": limit} for k, limit in cell.limits.items()}


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(name: str, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> dict:
    """The result line of one run (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with ``trace`` ``breakdown``, then ``checks``)."""
    cell = load_cell(name)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    spans = Spans()
    drv = driver(cell, seed, dev, spans)
    drv.setup()
    traced = trace and cuda  # a CPU run (the tests) reads no device trace
    # an end-to-end metric read from the device trace: a --trace 0 run takes
    # the same stretch after its window, and pays the profiler's first start there
    e2e_traced = not trace and cuda and any(m["source"] == "device_trace"
                                            for m in cell.end_to_end)
    if traced:
        devtrace.warm_up()
    r = Run(cell=cell)
    spans.durations.clear()
    r.setup_s = time.perf_counter() - t_start
    r.window = drv.window(seconds)
    r.spans = {k: list(v) for k, v in spans.durations.items()}
    if e2e_traced:
        devtrace.warm_up()
    if traced or e2e_traced:  # the profiler at times drops a few kernel records, or places the
        # device's records off the host's clock: take the stretch again
        for _ in range(TRACE_ATTEMPTS):
            r.trace = devtrace.take(drv.stretch, spans)
            lost, off = counters.missing(r.trace, tuple(counters.KERNELS)), r.trace.misplaced()
            if not lost and not off:
                break
            print(f"benchmark: a flawed trace: records lost {lost}, "
                  f"kernels outside the stretch {off}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    port_readings = drv.readings if drv.kind == "train" else [drv.results[k] for k in drv.sample()]
    attempted = r.window.get("steps", r.window.get("tracks", 0))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    drv.free()
    checks = judge(cell, drv, port_readings)
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": bool(correct), "attempted": attempted, "failed": 0, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else dev.type,
                      "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if traced:
        out["device"]["busy_s"] = r.trace.busy_s()
        out["device"]["window_s"] = r.trace.window_s
        gaps = sorted(r.trace.idle_gaps(), key=lambda g: -g[1])[:10]
        out["breakdown"] = {"device_ops": r.trace.top_device_ops(10),
                            "idle_gaps": [[n, s] for n, s in gaps]}
    out["checks"] = checks
    return out
