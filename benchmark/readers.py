"""Arithmetic that several per-layer metrics share: shares of the peak and
of a kernel's roofline, copy time, idle share.  Each returns None where
the run has nothing to read (no trace, no such kernel launched), never 0
for a share."""

from __future__ import annotations

import numpy as np

from . import counters, peaks


def mfu(run, train: bool) -> float | None:
    """The window's nominal operations over its seconds, as a share of the
    bf16 peak.  The operations are the configuration's ``nominal``: its
    ``train_flops`` a trained segment, or two a multiply-add of its
    ``forward_macs`` a served window."""
    w, nominal = run.window, run.cell.config.get("nominal")
    if nominal is None:
        return None
    if train:
        if "segments" not in w:
            return None
        flops = nominal["train_flops"] * w["segments"]
    else:
        if "windows" not in w:
            return None
        flops = 2 * nominal["forward_macs"] * w["windows"]
    return 100.0 * flops / w["wall_s"] / peaks.PEAK_FLOPS["bf16"]


def track_p95_ms(run) -> float | None:
    """95th percentile of the window's track times, milliseconds."""
    lat = run.window.get("latency_s")
    return 1e3 * float(np.percentile(lat, 95)) if lat else None


def _traced(run, backward: bool):
    t = run.trace
    return t if t is not None and t.extra.get("backward") == backward else None


def copy_ms_per_unit(run, direction: str) -> float | None:
    t = run.trace
    if t is None:
        return None
    lo, hi = t.stretch
    ms = 1e-3 * sum(b - a for c, n, a, b in t.device
                    if c == "gpu_memcpy" and direction in n and a >= lo and b <= hi)
    return ms / t.extra["units"]


def attention_share(run, backward: bool) -> float | None:
    t = _traced(run, backward)
    if t is None:
        return None
    wrappers = ("attn_fwd", "attn_bwd") if backward else ("attn_fwd",)
    if t.extra["counts"].get("attn_fwd", 0) == 0:
        return None
    counters.check_trace(t, wrappers)
    m = run.cell.config["model"]
    tokens = (224 // m["vit_patch"]) ** 2 + 1
    bound = 0.0
    for b in t.extra["forward_batches"]:
        for k in wrappers:
            bound += m["vit_layers"] * peaks.attention_bound_s(k, b, tokens, m["vit_heads"],
                                                                m["vit_hidden"] // m["vit_heads"])
    spent = t.kernel_s(tuple(k for w in wrappers for k in counters.KERNELS[w]))
    return 100.0 * bound / spent


def stem_share(run, backward: bool) -> float | None:
    t = _traced(run, backward)
    if t is None or t.extra["counts"].get("stem_fwd", 0) == 0:
        return None
    wrappers = ("stem_stats", "stem_fwd", "stem_bwd") if backward else ("stem_fwd",)
    counters.check_trace(t, wrappers)
    bound = sum(peaks.stem_bound_s(k, b) for b in t.extra["forward_batches"] for k in wrappers)
    spent = t.kernel_s(tuple({k for w in wrappers for k in counters.KERNELS[w]}))
    return 100.0 * bound / spent


def device_us_per_segment(run) -> float | None:
    """Device microseconds a trained segment: the union of the traced
    steps' kernel, copy and set intervals over the segments they train."""
    t = _traced(run, True)
    if t is None:
        return None
    return 1e6 * t.busy_s() / sum(t.extra["forward_batches"])


def device_mfu(run) -> float | None:
    """The traced steps' nominal training operations over their device
    busy seconds, as a share of the bf16 peak."""
    t, nominal = _traced(run, True), run.cell.config.get("nominal")
    if t is None or nominal is None:
        return None
    flops = nominal["train_flops"] * sum(t.extra["forward_batches"])
    return 100.0 * flops / t.busy_s() / peaks.PEAK_FLOPS["bf16"]


def idle_share(run) -> float | None:
    t = run.trace
    if t is None:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def cqt_share(run, backward: bool) -> float | None:
    """B1's bound over its kernels' device time, at the ``default`` tier
    on the tensor cores (one CQT call a traced step or forward call)."""
    t = _traced(run, backward)
    cqt = run.cell.config["cqt"]
    if t is None or cqt["precision"] != "default" or t.extra["counts"].get("cqt_fused_mma", 0) == 0:
        return None
    wrappers = ("cqt_fused", "cqt_fused_mma")
    counters.check_trace(t, wrappers)
    counts, calls = t.extra["counts"], t.extra["forward_batches"]
    if {counts["cqt_fused"], counts["cqt_fused_mma"]} != {len(calls)}:
        raise RuntimeError(f"{counts} CQT launches for {len(calls)} calls")
    bound = sum(peaks.cqt_bound_s(b, cqt) for b in calls)
    spent = t.kernel_s(tuple(k for w in wrappers for k in counters.KERNELS[w]))
    return 100.0 * bound / spent
