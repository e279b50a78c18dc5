#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only streaming,rgb_train,data_parallel  # build, then those

1. Set-up: the card's name and power limit, torch and CUDA versions, and
   the build of the port's eight kernel sources (``csrc/cqt.cu``,
   ``csrc/stem.cu``, ``csrc/attention.cu``, ``csrc/bn.cu``,
   ``csrc/stem_native.cu``, ``csrc/cqt_frame_gemm.cu``,
   ``csrc/stem_gemm.cu``, ``csrc/conv3x3.cu``: one ``nvcc`` each, started
   together); the attention kernels' ``-Xptxas -v`` lines (registers,
   spills) and their occupancy on the card (shared bytes, CTAs per SM);
   the same -Xptxas -v lines of the CQT and conv3x3 tensor-core kernels,
   of the stem tails' kernels (csrc/stem.cu, csrc/stem_native.cu) and of
   the stem front's GEMM (csrc/stem_gemm.cu).
2. Kernel against plain version (TF32 off): the fused CQT kernel at every
   precision tier on the training recipe (B=4096), the 3 s serving recipe,
   a reflect-padded recipe, a hop-1000 recipe and a hop-333 one, each
   against its plain PyTorch version on the same inputs, two runs
   identical, each launch on the kernel ``cqt_cuda.cqt_route`` names for
   the tier, hop and batch (the counters by tier), each tier's
   tensor-core occupancy printed, with the bound and the frame-GEMM
   yardstick of the reflect and hop-1000 recipes (the shapes of TPU
   kernels B3 and B4) at every tier, plus the kernel at highest against
   the repo's NumPy golden fixture, its error there at most
   HIGHEST_F64_FACTOR times the fp32 plain version's.  The route sweep:
   at highest and bf16x3, both kernels timed at the batches either side
   of the route's limit, beside the kernel the route picks.
3. The ``native-best`` serving path: a seeded random-init ``Transcriber``
   (batch 2048) transcribes synthetic tracks and one 4096-window batch;
   the kernel's launch count must rise, every launch on the tensor-core
   kernel; windows/s after a warm-up; the same windows through the plain
   CQT on the card must give the same logits.
4. A short ``--arch resnet18`` transcription through the CLI.
5. (a) The three stem-tail kernels against their plain versions at the
   flagship's training shape (B=256: y [256, 2, 56, 7168] bf16 from the
   quadrant GEMM of real CQT features), directly (``stem_bwd`` twice:
   identical; its plan and occupancy on the card printed) and through the
   ``autograd.Function``; each timed beside its plain version, the
   ``torch.var_mean`` yardstick and the cuDNN BN -> ReLU -> max-pool
   composition.
6. (b) Flagship training: ``resnet18`` + ``stem_fusion="fused"``, bf16,
   B=256 on 4 rotating batches of seeded audio, 20 steps after a warm-up;
   each stem counter and the CQT counter rise by exactly one per step, the
   loss stays finite, and one step with the kernels agrees with one step
   with the plain versions from the same state.  (d) A ``torch.profiler``
   table of the step's top 15 device ops, and the stem's and the CQT's
   device time a step and share of it.
7. (c) Native training: ``resnet18_native``, ``native-best`` CQT tier,
   B=4096, 20 steps.
8. (a) The attention kernels against the plain version on strided q, k, v
   views of one projection at [64, 785, 6, 64], [2, 50, 4, 64] and
   [1, 300, 2, 64], fp32 and bf16: outputs, gradients, two identical
   backward runs, the ``autograd.Function``'s wiring; times at vit_s8's
   shape beside the plain version, the bound and
   ``scaled_dot_product_attention``; kernel against plain at 19, 197 and
   785 tokens.
9. (b) ``vit_s8`` training (``vit-reference``: AdamW, backbone lr/10, bf16,
   B=64), 20 steps: each attention counter +12 and the CQT counter +1 a
   step; one step with the kernels against one with the plain attention at
   fp32 and bf16; a ``torch.profiler`` table.  (c) ``vit_s8`` serving
   through ``Transcriber`` at batch 128 (``attn_fwd`` +12 a batch).  (d)
   ``vit-small-data`` training, 5 steps: 19 tokens take the plain
   attention, so the attention counters stay at 0.
10. (a) The fused trunk BatchNorm's column sums (``bn_sums``,
   ``bn_grad_sums``) against their plain versions at the flagship's four
   trunk shapes (B=256, bf16, NCHW and channels last), one fp32 shape and
   one native trunk shape (B=4096); two runs identical; times at
   [256, 64, 56, 56] (:func:`_kernel_ms`: the profiler's device time under
   0.1 ms) beside the plain version, the bound and ``torch.var_mean``.
11. (a) The native stem kernels (``native_stats``, ``native_fwd``,
   ``native_bwd``) against their plain versions on ``native-best``'s conv1
   planes (ye, yo [4096, 24, 384]) at bf16 and fp32 and on a tie-rich
   input; times (:func:`_kernel_ms`; ``native_fwd`` and ``native_bwd``
   also by ``_sync_ms``) beside the plain versions, the bounds and
   ``torch.var_mean``; ``native_fwd``'s and ``native_bwd``'s plans and
   occupancy on the card, and both on the planes without a pad column
   (w_pad=0, [4096, 24, 320]): checked and timed.
12. (b) Path A: the flagship with ``bn_fusion="on"`` (B=256, 20 steps:
   ``bn_sums`` and ``bn_grad_sums`` +19 a step beside the stem and CQT
   kernels), the kernels-vs-plain step, a profile, the memory format each
   trunk BatchNorm receives, and the trunk BatchNorms' device time a step,
   fused against the plain ``FlaxBatchNorm`` at the same shapes.  (c) Path
   B: ``native-best`` with ``stem_fusion="fused"`` and ``bn_fusion="on"``
   (B=4096, 20 steps: each ``native_*`` +1 and each ``bn_*`` +19 a step),
   the same checks.  (d) Path B served through ``Transcriber`` at batch 2048
   (``native_fwd`` +1 a batch, no train-mode kernel), its frets against the
   same weights served unfused.
13. The raw CQT frame GEMM (B9) through its entry point
   ``cqt_cuda.cqt_frame_gemm``: the training recipe at B=256 at every tier
   and ``serving_cnn`` at B=64, ``default``, one launch each, every one on
   a tensor-core kernel; each against ``frame_gemm_plain``, deterministic,
   and through the plain epilogue against the fused B1 kernel's dB;
   ``highest`` against float64 as accurate as the fp32 plain version;
   times, bound, occupancy, frame-GEMM yardstick.
14. The stem front's GEMM with statistics (B8) against its plain version on
   random operands and on the real 224^2 front at B=256 (y against
   ``precomposed_conv1_quadrant``, channel sums against B2's
   ``stem_stats``); then its entry point, the ported
   ``tools/profile_stem_pieces``, with its launches counted; the kernel's
   plan and occupancy on the card.
15. The 3x3 conv with a fused ReLU-affine (B10) against its plain version at
   the probe's three shapes and four odd ones; then its entry point, the
   ported ``tools/probe_conv``, with cuDNN's times, the parity figures and
   its launches counted.
16. The train entry point: ``train.run.main`` with ``--synthetic
   --synthetic-tracks 32 --batch-size 32 --recipe native-best --stem-fusion
   fused --bn-fusion on --epochs 3`` into a temporary directory (B1's, B6's three
   and B7's two counters must rise), then ``--resume --epochs 4`` (it must
   start at the epoch after the checkpoint's), ``--eval-only`` (its JSON
   with ``checkpoint_step``; its val loss must agree with the same
   evaluation through the stem's and BatchNorms' plain versions), and the
   serving CLI transcribing a synthetic track from the checkpoint; each
   run's lines printed.
17. The port's bench (``bench.main``) in-process: its JSON line (the
   flagship train step at B=256, ``resnet18_native`` train at B=4096 at
   ``highest`` and ``default``, at B=8192 at ``default``, serving at
   B=4096), each row's step ms beside its host enqueue ms; every row must
   have launched B1 once a step, the flagship row B2's three kernels too.
18. The GuitarSet runbook: the port's ``make_synthetic_guitarset`` renders
   48 excerpts of 24 s (5,760 windows), ``run_guitarset.main`` extracts
   their CQT on the card (B1 at ``highest``, one launch per track's chunk
   of 512 windows), makes the labels, audits the pairing and trains
   ``native-best`` for 2 epochs with ``--report-dir`` (the seven PNGs; on a
   machine without matplotlib, the report's arrays from the checkpoint on
   the card instead); one track's features against the plain CQT.
19. Raw-audio training: ``AudioWindowLoader`` (the native C++ loader) at
   B=2048 over the same tree, through ``as_device_batches(prefetch=2)``,
   into path B's train step (the CQT kernel as the frontend): 10 steps,
   path B's launches a step, the prefetched batches bit for bit the
   loader's, the first three steps replayed through the plain versions,
   then the same steps through ``batch_to_device``.
20. Streaming: path B served at batch 2048 through ``StreamingTranscriber``
   (a 60 s track in seeded chunks, then 2 s in single windows), exactly the
   offline transcription, B1 and ``native_fwd`` once a bucket call, feed
   times, a stretch of feeds traced (device and host time a feed); the
   CLI with ``--image`` (a PNG where PIL exists, else a clean refusal).
21. ``rgb_image`` training: the flagship on [256, 224, 224, 3] uint8
   renders, 10 steps (B7 20 a step, B1 and B2 never), the kernels-vs-plain
   first step.
22. Data and string parallelism: two gloo processes on the card, path B's
   step at global B=2048 under dp=2 and mp=2 against one process, and
   ``Transcriber(mesh=...)`` at dp=2.

Then one JSON line of the fourteen kernels' measurements (``cqt_fused`` and
``cqt_frame_gemm`` with their other tiers' beside: B1's ``bf16x3`` at the
flagship shape, B=256, ``highest`` on the tensor cores at the kernel
phase's B=4096, and ``default`` at the serving shape; B1's, B6's and B7's
with their launches in the runbook, raw-audio training, streaming,
``rgb_image`` training and rank 0's data-parallel step beside), and the
status line last.  Any failed check raises, which exits non-zero.  Needs one CUDA card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}
# Tolerances, with their reasons:
# - two formulations of the CQT at one precision differ by fp32 summation
#   order only; the repo holds such pairs to 2e-3 dB on ungated cells with
#   no gate flips (tests/test_cqt.py:260-261,317-319).  Over 10^6 cells a
#   cell may sit within that distance of the -60 dB gate, so a flip is
#   accepted only where the ungated side lies within 2e-3 dB of it.
DB_TOL = 2e-3
# - against the float64 NumPy golden: 0.15 dB off the gate boundary
#   (tests/test_cqt.py:385-395).
GOLDEN_TOL = 0.15
# - logits of the bf16 model from kernel vs plain CQT features: the
#   features differ by < 2e-3 dB (1.7e-5 after db_to_unit), far below bf16
#   resolution (2^-8 relative), so differences come from bf16 rounding
#   boundaries the perturbation crosses and from cells at the gate.
LOGIT_REL_TOL = 2e-2
# - the stem kernels against their plain versions: pooled output and dy bit
#   for bit (the same fp32 arithmetic, tie-break and single rounding); the
#   per-channel sums of 411 MB of bf16 values to fp32 summation order.
SUM_REL_TOL = 1e-5
# - one flagship train step with kernels against one with the plain
#   versions, from the same state.  At fp32 the two differ by summation
#   order only: loss to 1e-5, the raw gradients' norm to 1e-4, and the Adam
#   first moments (the clipped gradient) to cosine similarity 0.9999.  At
#   bf16 (the main path) perturbations as small as the CQT kernel's 2e-3 dB
#   or a last-bit change of the batch statistics move bf16 roundings and
#   ReLU and max-pool decisions across 20 batch-statistics BatchNorms, so
#   the gradients move by percents; each run prints the kernel step against
#   itself with only the CQT plain as that reference.  bf16: loss to
#   LOGIT_REL_TOL, gradient norm to 0.1, cosine 0.8, and bn1's running
#   statistics (fp32 sums of the same conv output) to 1e-4.
#   Where the CQT runs at the `default` tier (native-best), kernel and plain
#   CQT differ by up to 2e-3 dB, not by summation order, so there the plain
#   step keeps the CQT kernel (compare_step's plain_cqt=False) and the two
#   steps differ by the model's kernels only.
STEP_TOL = {
    "float32": {"loss": 1e-5, "grad_norm": 1e-4, "cosine": 0.9999, "bn1": 1e-5},
    "bfloat16": {"loss": LOGIT_REL_TOL, "grad_norm": 0.1, "cosine": 0.8, "bn1": 1e-4},
}
# - a trunk BatchNorm's running statistics after the kernels-vs-plain step:
#   its input has passed conv1, the stem and a conv after the perturbations
#   above, so at fp32 ten times bn1's limit, at bf16 that of the loss.
TRUNK_BN_TOL = {"float32": 1e-4, "bfloat16": LOGIT_REL_TOL}
# - path B served fused (native stem tail, bf16 BatchNorm affines) against
#   the same weights served unfused (fp32 BatchNorm normalize), its
#   BatchNorms moved off the identity: the share of frets that must agree.
#   The first reading on the card was 0.9974 (PERF.md section 6); the
#   limit allows four times its disagreement.
FRET_AGREEMENT_MIN = 0.99
# - the raw frame GEMM (B9) against its plain version: the same fp32
#   products (exact for the bf16 operands of the lower tiers), another fp32
#   summation order over up to 23,552 filter rows: per window, max|err| <=
#   1e-4 max|ref|.
FRAME_GEMM_REL_TOL = 1e-4
# - B9 at highest against a float64 contraction of the same inputs, and B1
#   at highest against the float64 golden fixture (off-gate cells): the
#   tier must be as accurate as fp32, so its max error may be at most this
#   many times that of the fp32 plain version (TF32 off).
HIGHEST_F64_FACTOR = 4.0
# - bf16 outputs of the GEMM kernels (B8, B10) against their plain
#   versions: both round once from fp32 sums of the same exact products in
#   another order, so within one bf16 ulp of the larger magnitude; plus
#   this share of max|ref| for outputs near zero, where the fp32 order's
#   error exceeds a tiny value's ulp.
BF16_FLOOR = 1e-5
TOOL_ITERS = 20  # timed calls of each piece in the two ported tools
LR = 5e-4  # bench.py's learning rate
TRAIN_STEPS = 20


def _sync_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()`` on the card (the port's tools'
    CUDA-event timer)."""
    import torch

    from guitar_tablature_classification_tpu_torch.tools.timing import time_ms

    return time_ms(fn, iters, torch.device("cuda"))


def _kernel_ms(fn, iters: int) -> float:
    """``_sync_ms``, or where that reads under 0.1 ms (back-to-back calls,
    where a slow host inflates a small kernel), the profiler's device time
    of every kernel ``fn`` launches, per call.  A trace with no device time
    is taken again, three times at most, and after three the ``_sync_ms``
    reading stands, printed as such; a trace whose count of device ops is
    not a multiple of ``iters`` lost records, and is printed as such (its
    time then reads low)."""
    ms = _sync_ms(fn, iters)
    if ms >= 0.1:
        return ms
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [evt for evt in prof.key_averages()  # kernels and copies
                  if evt.device_type == DeviceType.CUDA and "Activity Buffer" not in evt.key]
        device_ms = sum(_device_ms(evt) for evt in events)
        ops = sum(evt.count for evt in events)
        if device_ms > 0:
            if ops % iters:
                print(f"_kernel_ms: the profiler lost records ({ops} device ops for {iters} "
                      f"calls, {device_ms / iters:.6f} ms a call; _sync_ms {ms:.6f})", flush=True)
            return device_ms / iters
    print(f"_kernel_ms: the profiler saw no device time, three times; _sync_ms {ms:.6f} "
          f"stands", flush=True)
    return ms


def tone_windows(batch: int, num_samples: int, sample_rate: int, seed: int):
    """Guitar-range test windows made on the card: three sinusoids with
    log-uniform pitch (60 Hz - 2 kHz) and random level, plus weak noise."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.arange(num_samples, device="cuda", dtype=torch.float32) / sample_rate
    f = 60.0 * (2000.0 / 60.0) ** torch.rand(batch, 3, 1, generator=g, device="cuda")
    amp = torch.rand(batch, 3, 1, generator=g, device="cuda")
    phase = 6.2831853 * torch.rand(batch, 3, 1, generator=g, device="cuda")
    x = (amp * torch.sin(6.2831853 * f * t + phase)).sum(dim=1)
    x += 0.01 * torch.randn(batch, num_samples, generator=g, device="cuda")
    return x.contiguous()


def synthetic_track(rng: np.random.Generator, seconds: float, sr: int) -> np.ndarray:
    """Plucked-string notes on random strings/frets: decaying harmonic
    stacks starting every 0.2-0.6 s."""
    n = int(seconds * sr)
    audio = np.zeros(n, np.float32)
    t0 = 0.0
    while t0 < seconds:
        midi = (40, 45, 50, 55, 59, 64)[rng.integers(6)] + rng.integers(0, 13)
        f0 = 440.0 * 2.0 ** ((midi - 69) / 12.0)
        start = int(t0 * sr)
        length = min(n - start, int(1.5 * sr))
        tt = np.arange(length) / sr
        note = sum(
            np.sin(2 * np.pi * h * f0 * tt) / h for h in range(1, 6)
            if h * f0 < sr / 2
        ) * np.exp(-tt / 0.5)
        audio[start:start + length] += 0.3 * note.astype(np.float32)
        t0 += rng.uniform(0.2, 0.6)
    return audio + 0.003 * rng.standard_normal(n).astype(np.float32)


def compare_db(got, want, gate: float, threshold: float) -> dict:
    import torch

    g_gated, w_gated = got == gate, want == gate
    flips = g_gated != w_gated
    both = ~g_gated & ~w_gated
    err = float((got - want).abs()[both].max()) if bool(both.any()) else 0.0
    # a flipped cell's ungated side must lie at the gate boundary
    ungated_side = torch.where(g_gated, want, got)[flips]
    bad_flips = int((ungated_side - threshold > DB_TOL).sum())
    return {"flips": int(flips.sum()), "bad_flips": bad_flips,
            "max_err_db": err, "cells": got.numel()}


def _cqt_counts(cqt_cuda) -> dict:
    """The fused CQT's counters: its launches, those on the tensor cores,
    and those by tier."""
    out = {"cqt_fused": cqt_cuda.launches, "cqt_fused_mma": cqt_cuda.mma_launches}
    for tier, n in cqt_cuda.mma_launches_by_tier.items():
        out[f"cqt_fused_mma_{tier}"] = n
    return out


def _cqt_launches_since(cqt_cuda, before: dict) -> dict:
    return {k: v - before[k] for k, v in _cqt_counts(cqt_cuda).items() if v != before[k]}


def _cqt_expect(route: str, precision: str, n: int = 1) -> dict:
    """The counters a run of n calls at a tier on ``route`` (what
    cqt_cuda.cqt_route picks for them) must add: every call a launch, and
    on the tensor cores where the route says so."""
    if route != "mma":
        return {"cqt_fused": n}
    return {"cqt_fused": n, "cqt_fused_mma": n, f"cqt_fused_mma_{precision}": n}


def _route(frontend, batch: int) -> str:
    """The kernel cqt_cuda.cqt_route picks for ``batch`` windows."""
    import torch

    return frontend.route(batch, frontend.cfg.window_samples,
                          torch.device("cuda", torch.cuda.current_device()))


# the route sweep's shapes: at highest, batches either side of the route's
# limit (the tensor-core grid's fill of its waves, cqt_cuda.MMA_MIN_FILL);
# at bf16x3, the smallest and the largest (and the flagship's B=256)
ROUTE_SWEEP = {
    "train": ({"highest": (64, 256, 384, 512, 768, 1024, 4096),
               "bf16x3": (64, 256, 4096)}, {}),
    "serving_cnn_3s": ({"highest": (16, 32, 64, 256), "bf16x3": (16, 256)}, None),
    "reflect": ({"highest": (64, 512), "bf16x3": (64, 512)}, {"pad_mode": "reflect"}),
    "hop1000": ({"highest": (64, 128, 256, 512), "bf16x3": (64, 512)},
                {"hop_length": 1000, "window_seconds": 0.25, "hop_seconds": 0.125}),
}


def cqt_route_sweep(torch, cqt_cuda, CQTConfig, CQTFrontend) -> list:
    """Both CQT kernels timed (``_sync_ms``) at the split tiers over the
    ROUTE_SWEEP shapes, beside the one cqt_cuda.cqt_route picks: the
    evidence for the route, not a check (times move between runs)."""
    rows = []
    for name, (tiers, change) in ROUTE_SWEEP.items():
        base = CQTConfig.serving_cnn() if change is None else dataclasses.replace(
            CQTConfig(), **change)
        for prec, batches in tiers.items():
            fe = CQTFrontend(dataclasses.replace(base, precision=prec))
            plan = fe.kernel_plan(base.window_samples, torch.device("cuda", 0), "mma")
            for batch in batches:
                x = tone_windows(batch, base.window_samples, base.sample_rate, seed=3)
                ms = {r: _sync_ms(lambda: cqt_cuda.cqt_fused(x, fe, route=r), 10)
                      for r in ("mma", "simt")}
                ctas = plan.n_ctas(batch)
                route = _route(fe, batch)
                rows.append({
                    "recipe": name, "tier": prec, "batch": batch, "route": route,
                    "mma_ms": ms["mma"], "simt_ms": ms["simt"], "mma_ctas": ctas,
                    "mma_fill": ctas / (cqt_cuda.SMS * -(-ctas // cqt_cuda.SMS)),
                    "mma_windows_per_cta": plan.shape.windows,
                    "route_is_faster": ms[route] <= min(ms.values()),
                })
                print("cqt route sweep: " + json.dumps(rows[-1]), flush=True)
                del x
    print(f"cqt route sweep: the route took the faster kernel at "
          f"{sum(r['route_is_faster'] for r in rows)} of {len(rows)} shapes", flush=True)
    return rows


def kernel_phase(torch, cqt_cuda, CQTConfig, CQTFrontend) -> dict:
    recipes = {
        "train": (CQTConfig(), 4096),
        "serving_cnn_3s": (CQTConfig.serving_cnn(), 256),
        "reflect": (dataclasses.replace(CQTConfig(), pad_mode="reflect"), 512),
        "hop1000": (dataclasses.replace(
            CQTConfig(), hop_length=1000, window_seconds=0.25,
            hop_seconds=0.125), 512),
        # off the 8-sample hop grid: highest and bf16x3 on the SIMT kernel
        "hop333": (dataclasses.replace(CQTConfig(), hop_length=333), 256),
    }
    results = {}
    occupancy = {}
    for name, (base, batch) in recipes.items():
        x = tone_windows(batch, base.window_samples, base.sample_rate, seed=1)
        for prec in ("highest", "bf16x3", "default"):
            fe = CQTFrontend(dataclasses.replace(base, precision=prec))
            route = _route(fe, batch)
            before = _cqt_counts(cqt_cuda)
            got = fe(x)
            torch.cuda.synchronize()
            launches = _cqt_launches_since(cqt_cuda, before)
            want = fe.plain(x)
            again = fe(x)
            torch.cuda.synchronize()
            r = compare_db(got, want, base.gate_floor_db, base.gate_threshold_db)
            r.update(
                batch=batch, route=route, launches=launches,
                deterministic=bool(torch.equal(again, got)),
                kernel_ms=_sync_ms(lambda: fe(x), 5),
                plain_ms=_sync_ms(lambda: fe.plain(x), 3),
            )
            if cqt_cuda.mma_takes(prec, base.hop_length):
                r["occupancy"] = cqt_cuda.mma_kernel_info(
                    fe.kernel_plan(x.shape[1], x.device, "mma"))
                occupancy.setdefault(prec, r["occupancy"])
            print(f"cqt {name} {prec} B={batch}: " + json.dumps(r), flush=True)
            if (r["bad_flips"] or r["max_err_db"] > DB_TOL or not r["deterministic"]
                    or launches != _cqt_expect(route, prec)):
                raise AssertionError(f"CQT kernel disagrees on {name}/{prec}: {r}")
            results[(name, prec)] = r
            del got, want
        del x
        torch.cuda.empty_cache()
    # each tier's tensor-core kernel as the card runs it (training recipe)
    print("cqt_mma_kernel on the card, by tier: " + json.dumps(occupancy), flush=True)

    # bound and library yardstick of the recipes that B3 (reflect) and B4
    # (hop 1000) serve, at every tier
    for name in ("reflect", "hop1000"):
        base, batch = recipes[name]
        for prec in ("highest", "bf16x3", "default"):
            cqt_kernel_row(torch, cqt_cuda,
                           CQTFrontend(dataclasses.replace(base, precision=prec)),
                           batch, name)

    # the kernel at highest against the float64 NumPy golden fixture, and
    # as accurate as the fp32 plain version (TF32 off) against it
    root = os.path.dirname(os.path.abspath(__file__))
    golden = np.load(os.path.join(root, "tests", "data", "cqt_golden.npz"))
    fe = CQTFrontend(CQTConfig())
    audio = torch.from_numpy(golden["input"]).cuda()
    got = fe(audio).cpu().numpy()
    plain = fe.plain(audio).cpu().numpy()
    want = golden["output"]
    off_gate = np.abs(want + 60.0) >= 0.5
    gerr = float(np.abs(got - want)[off_gate].max())
    perr = float(np.abs(plain - want)[off_gate].max())
    print(f"cqt golden fixture: max_err_db={gerr} (tol {GOLDEN_TOL}); the fp32 plain "
          f"version's {perr} (the kernel's at most {HIGHEST_F64_FACTOR}x it)", flush=True)
    if gerr > GOLDEN_TOL or gerr > HIGHEST_F64_FACTOR * perr:
        raise AssertionError("CQT kernel disagrees with the golden fixture")
    return results


def cqt_kernel_row(torch, cqt_cuda, frontend, batch: int, label: str) -> dict:
    """The kernel at one recipe, tier and batch: times, bound and the
    library yardstick."""
    cfg = frontend.cfg
    fb = frontend.filterbank
    x = tone_windows(batch, cfg.window_samples, cfg.sample_rate, seed=2)
    before = _cqt_counts(cqt_cuda)
    got, want = frontend(x), frontend.plain(x)
    launches = _cqt_launches_since(cqt_cuda, before)
    route = _route(frontend, batch)
    r = compare_db(got, want, cfg.gate_floor_db, cfg.gate_threshold_db)
    kernel_ms = _sync_ms(lambda: frontend(x), 10)
    plain_ms = _sync_ms(lambda: frontend.plain(x), 5)
    # yardstick: one torch.matmul of the prebuilt frame stack with the
    # filterbank (the frame GEMM alone, without the epilogue): bf16 operands
    # at the default tier, fp32 (TF32 off) at highest and bf16x3
    dt = torch.bfloat16 if cfg.precision == "default" else torch.float32
    kw = fb.kernel_width
    padded = torch.nn.functional.pad(x, (kw // 2, kw // 2))
    frames = padded.unfold(-1, kw, cfg.hop_length)[:, :cfg.n_frames]
    frames = frames.reshape(-1, kw).to(dt).contiguous()
    kern = frontend.kernels_on(x.device).to(dt)
    library_ms = _sync_ms(lambda: torch.matmul(frames, kern), 10)
    del frames, padded
    # the bound: the products at the peak of the operands' type and each
    # filter value the window needs in that type (bf16 at default, fp32
    # else); the audio is read as given (fp32) and the dB written as fp32.
    # default: one bf16 tensor-core pass; bf16x3: three; highest: the least
    # time of fp32-accurate work, the FP32 pipes or six bf16 passes
    macs = cqt_cuda.needed_macs(fb, cfg, cfg.window_samples) * batch
    ops, peak = {"highest": min((2 * macs, "fp32"), (12 * macs, "bf16"),
                                key=lambda op: op[0] / PEAK_FLOPS[op[1]]),
                 "bf16x3": (6 * macs, "bf16"), "default": (2 * macs, "bf16")}[cfg.precision]
    width = 2 if cfg.precision == "default" else 4
    ops_s = ops / PEAK_FLOPS[peak]
    filt_values = cqt_cuda.needed_filter_values(fb, cfg, cfg.window_samples)
    nbytes = (4 * x.numel() + width * filt_values
              + 4 * batch * cfg.n_bins * cfg.n_frames)
    bytes_s = nbytes / PEAK_BYTES_PER_S
    row = {
        "max_abs_err": r["max_err_db"], "flips": r["flips"],
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": 1e3 * max(ops_s, bytes_s),
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "macs": macs, "ops": ops, "ops_peak": peak, "bytes": nbytes, "route": route,
        "tensor_core_launches": launches.get("cqt_fused_mma", 0),
    }
    if route == "mma":
        row["occupancy"] = cqt_cuda.mma_kernel_info(
            frontend.kernel_plan(x.shape[1], x.device, "mma"))
    print(f"cqt row, {label} {cfg.precision} B={batch}: {json.dumps(row)}",
          flush=True)
    if (r["bad_flips"] or r["max_err_db"] > DB_TOL
            or launches != _cqt_expect(route, cfg.precision)):
        raise AssertionError(f"CQT kernel disagrees at the main-path shape: {r}, {row}")
    return row


def serving_phase(torch, cqt_cuda, RECIPES, Transcriber, frame_track) -> dict:
    recipe = RECIPES["native-best"]()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = Transcriber(
        None, model_cfg=recipe.model, cqt_cfg=recipe.cqt, batch_size=2048,
        device="cuda", seed=0,
    )
    cfg = t.cqt_cfg
    rng = np.random.default_rng(0)
    tracks = [synthetic_track(rng, s, cfg.sample_rate) for s in (20.0, 30.0, 45.0)]
    big = np.concatenate([
        np.asarray(frame_track(synthetic_track(rng, 60.0, cfg.sample_rate), cfg))
        for _ in range(8)
    ])[:4096]
    assert big.shape == (4096, cfg.window_samples), big.shape
    t.predict_windows(big[:2048])  # warm-up (cuDNN plans, kernel load)
    torch.cuda.synchronize()

    cqt_cuda.launches = cqt_cuda.mma_launches = 0
    results = [t.transcribe(a, keep_logits=True) for a in tracks]
    logits_big = t.predict_windows(big)
    torch.cuda.synchronize()
    launches, mma_launches = cqt_cuda.launches, cqt_cuda.mma_launches
    print(f"serving native-best: cqt kernel launches on the main path = "
          f"{launches}, on the tensor cores = {mma_launches}", flush=True)
    if launches <= 0 or mma_launches != launches:
        raise AssertionError("the serving path did not launch the CQT tensor-core kernel "
                             f"each time ({mma_launches} of {launches})")
    for a, res in zip(tracks, results):
        n = (len(a) - cfg.window_samples) // cfg.hop_samples + 1
        assert res.frets.shape == (n, 6) and res.logits.shape == (n, 6, 19)
        assert np.isfinite(res.logits).all()
        assert ((res.frets >= 0) & (res.frets < 19)).all()
    assert logits_big.shape == (4096, 6, 19) and np.isfinite(logits_big).all()

    # throughput: windows/s of predict_windows (host arrays in and out),
    # CUDA events around the call (it ends in a device->host copy)
    rates = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t.predict_windows(big)
        end.record()
        torch.cuda.synchronize()
        rates.append(1e3 * len(big) / start.elapsed_time(end))
    # host-to-device copy of one 2048-window batch (pageable memory)
    h2d = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = torch.from_numpy(big[:2048]).to("cuda")
        torch.cuda.synchronize()
        h2d.append(1e3 * (time.perf_counter() - t0))
    # device time per 2048-window batch, by stage
    with torch.inference_mode():
        feats = t.frontend(x)
        images = t.preprocess(feats)
        stage_ms = {
            "cqt": _sync_ms(lambda: t.frontend(x), 10),
            "preprocess": _sync_ms(lambda: t.preprocess(feats), 10),
            "model": _sync_ms(lambda: t.model(images), 10),
            "predict_logits": _sync_ms(lambda: t.predict_logits(x), 10),
        }
        # the same windows through the plain CQT on the card
        with_kernel = t.model(t.preprocess(t.frontend(x)))
        with_plain = t.model(t.preprocess(t.frontend.plain(x)))
    diff = float((with_kernel - with_plain).abs().max())
    scale = float(with_plain.abs().max())
    agree = float((with_kernel.argmax(-1) == with_plain.argmax(-1)).float().mean())
    out = {
        "windows_per_s": rates, "stage_ms_per_2048": stage_ms,
        "h2d_ms_per_2048": h2d,
        "launches": launches, "tensor_core_launches": mma_launches,
        "logit_max_abs_diff": diff,
        "logit_scale": scale, "fret_agreement": agree,
        "tracks_s": [len(a) / cfg.sample_rate for a in tracks],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    print("serving native-best: " + json.dumps(out), flush=True)
    if diff > LOGIT_REL_TOL * scale:
        raise AssertionError("kernel and plain CQT give different logits")
    return out


def resnet18_phase(torch, cqt_cuda, cli) -> int:
    """A short 224^2 resnet18 transcription through the CLI."""
    from scipy.io import wavfile

    rng = np.random.default_rng(3)
    audio = synthetic_track(rng, 2.0, 44100)
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "demo.wav")
        out = os.path.join(tmp, "demo_tab.txt")
        wavfile.write(wav, 44100, (np.clip(audio, -1, 1) * 32767).astype(np.int16))
        cqt_cuda.launches = 0
        rc = cli.main([wav, "--arch", "resnet18", "--output", out,
                       "--batch-size", "8", "--device", "cuda"])
        launches = cqt_cuda.launches
        text = open(out).read()
    lines = [ln for ln in text.splitlines() if ln[:2] in ("e|", "B|", "G|", "D|", "A|", "E|")]
    print(f"resnet18 CLI transcription: rc={rc} tab lines={len(lines)} "
          f"cqt launches={launches}", flush=True)
    if rc != 0 or len(lines) != 6 or launches <= 0:
        raise AssertionError("resnet18 CLI transcription failed")
    return launches


@contextlib.contextmanager
def plain_stem(stem_tail):
    """Send the stem tail's calls to its plain versions while the block
    runs (for the kernel-against-plain comparison only)."""
    saved = stem_tail.stats, stem_tail.fwd, stem_tail.bwd
    stem_tail.stats = stem_tail.stats_plain
    stem_tail.fwd = stem_tail.fwd_plain
    stem_tail.bwd = stem_tail.bwd_plain
    try:
        yield
    finally:
        stem_tail.stats, stem_tail.fwd, stem_tail.bwd = saved


def stem_kernel_phase(torch, mods, batch: int = 256) -> dict:
    """(a) The three stem-tail kernels against their plain versions at the
    flagship's training shape, directly and through the autograd.Function,
    with times, bounds and yardsticks."""
    stem_cuda, stem_tail = mods["stem_cuda"], mods["stem_tail"]
    F = torch.nn.functional
    cfg = mods["CQTConfig"]()
    frontend = mods["CQTFrontend"](cfg)
    model = mods["build_model"](
        mods["ModelConfig"](arch="resnet18", stem_fusion="fused"),
        generator=torch.Generator().manual_seed(0),
    ).cuda()
    x = tone_windows(batch, cfg.window_samples, cfg.sample_rate, seed=3)
    with torch.no_grad():
        feats = mods["db_to_unit"](frontend(x))
        yq = mods["stem_fusion"].precomposed_conv1_quadrant(
            feats, model.resnet.conv1.weight, dtype=torch.bfloat16).contiguous()
    b, _, h2, lanes = yq.shape
    c = lanes // (2 * h2)
    g = torch.Generator(device="cuda").manual_seed(4)
    scale = 1.0 + 0.2 * torch.randn(c, generator=g, device="cuda")
    bias = 0.1 * torch.randn(c, generator=g, device="cuda")
    gout = torch.randn((b, h2, lanes // 2), generator=g, device="cuda").to(torch.bfloat16)
    mean, var = stem_tail.quadrant_batch_stats(yq)
    se, oe, _ = stem_tail.lane_affine(mean, var, scale, bias, 1e-5)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    sums, sums_p = stem_cuda.stats(yq), stem_tail.stats_plain(yq)
    pooled, pooled_p = stem_cuda.fwd(yq, se, oe), stem_tail.fwd_plain(yq, se, oe)
    dy, sdz, sdzy = stem_cuda.bwd(yq, gout, se, oe)
    again = stem_cuda.bwd(yq, gout, se, oe)
    dy_p, sdz_p, sdzy_p = stem_tail.bwd_plain(yq, gout, se, oe)
    torch.cuda.synchronize()
    checks = {
        "stats_rel_err": rel(sums, sums_p),
        "fwd_equal": bool(torch.equal(pooled, pooled_p)),
        "bwd_dy_equal": bool(torch.equal(dy, dy_p)),
        "bwd_deterministic": all(torch.equal(a, w) for a, w in zip(again, (dy, sdz, sdzy))),
        "bwd_sum_dz_rel_err": rel(sdz, sdz_p),
        "bwd_sum_dzy_rel_err": rel(sdzy, sdzy_p),
    }
    errs = {
        "stem_stats": float((sums - sums_p).abs().max()),
        "stem_fwd": float((pooled.float() - pooled_p.float()).abs().max()),
        "stem_bwd": max(float((dy.float() - dy_p.float()).abs().max()),
                        float((sdz - sdz_p).abs().max()),
                        float((sdzy - sdzy_p).abs().max())),
    }
    del pooled_p, dy_p, again

    # through the autograd.Function: kernels against plain versions
    def train_op():
        y = yq.clone().requires_grad_(True)
        s_, b_ = scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)
        out, m, v = stem_tail.bn_relu_pool_train(y, s_, b_)
        out.backward(gout.reshape(out.shape))
        return out.detach(), m, v, y.grad, s_.grad, b_.grad

    got = train_op()
    with plain_stem(stem_tail):
        want = train_op()
    torch.cuda.synchronize()
    names = ("pooled", "mean", "var", "dy", "dscale", "dbias")
    function_err = {n: rel(a.float(), w.float()) for n, a, w in zip(names, got, want)}
    del got, want
    torch.cuda.empty_cache()
    print("stem kernels vs plain, B=%d: %s" % (b, json.dumps(
        {**checks, "abs_err": errs, "autograd_function_rel_err": function_err})), flush=True)
    if not (checks["fwd_equal"] and checks["bwd_dy_equal"] and checks["bwd_deterministic"]
            and max(checks["stats_rel_err"], checks["bwd_sum_dz_rel_err"],
                    checks["bwd_sum_dzy_rel_err"]) <= SUM_REL_TOL):
        raise AssertionError(f"stem kernels disagree with their plain versions: {checks}")
    # one bf16 ulp on outputs where the sums' order moves se/oe's last bit
    if max(function_err.values()) > LOGIT_REL_TOL:
        raise AssertionError(f"bn_relu_pool_train kernels vs plain: {function_err}")

    # times (CUDA events), plain versions, bounds and yardsticks
    ms = {
        "stem_stats": (_sync_ms(lambda: stem_cuda.stats(yq), 20),
                       _sync_ms(lambda: stem_tail.stats_plain(yq), 3)),
        "stem_fwd": (_sync_ms(lambda: stem_cuda.fwd(yq, se, oe), 20),
                     _sync_ms(lambda: stem_tail.fwd_plain(yq, se, oe), 3)),
        "stem_bwd": (_sync_ms(lambda: stem_cuda.bwd(yq, gout, se, oe), 20),
                     _sync_ms(lambda: stem_tail.bwd_plain(yq, gout, se, oe), 3)),
    }
    nhwc = stem_tail.quadrant_unpack(yq, c)  # a permuted view, [B, 112, 112, C]
    library = {"stem_stats": _sync_ms(
        lambda: torch.var_mean(nhwc.float(), dim=(0, 1, 2), correction=0), 10)}
    # context only: eager cuDNN batch_norm -> relu -> max_pool2d (a
    # composition of library calls, not one call computing the function)
    xin = nhwc.permute(0, 3, 1, 2).detach().requires_grad_(True)  # channels last

    def composed():
        z = F.batch_norm(xin, None, None, scale, bias, True, 0.0, 1e-5)
        return F.max_pool2d(F.relu(z), 3, 2, 1)

    with torch.no_grad():
        comp_fwd = _sync_ms(composed, 10)
    gcomp = gout.reshape(b, h2, h2, c).permute(0, 3, 1, 2)
    comp_fwd_bwd = _sync_ms(lambda: torch.autograd.grad(composed(), xin, gcomp), 10)
    el = yq.element_size()
    n_y, n_pool = yq.numel(), b * h2 * (lanes // 2)
    bytes_ = {
        "stem_stats": el * n_y + 8 * c,
        "stem_fwd": el * (n_y + n_pool) + 8 * c,
        "stem_bwd": el * (2 * n_y + n_pool) + 16 * c,
    }
    ops = {  # fp32 operations on the FP32 pipes (bound_by is bytes for all)
        "stem_stats": 3 * n_y,          # y, y*y, two adds
        "stem_fwd": 3 * n_y + 8 * n_pool,  # affine + ReLU, 8 maxima a window
        "stem_bwd": 7 * n_y + 17 * n_pool,  # + mask, dy, two sums; window max and routing
    }
    rows = {}
    for name in ("stem_stats", "stem_fwd", "stem_bwd"):
        bytes_s = bytes_[name] / PEAK_BYTES_PER_S
        ops_s = ops[name] / PEAK_FLOPS["fp32"]
        rows[name] = {
            "max_abs_err": errs[name], "ms": ms[name][0], "plain_ms": ms[name][1],
            "bound_ms": 1e3 * max(bytes_s, ops_s),
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "library_ms": library.get(name), "bytes": bytes_[name],
        }
    context = {"cudnn_bn_relu_maxpool_fwd_ms": comp_fwd,
               "cudnn_bn_relu_maxpool_fwd_bwd_ms": comp_fwd_bwd,
               "var_mean_ms": library["stem_stats"]}
    # stem_bwd's plan and occupancy on the card (band rows, channel slice,
    # registers, spills, shared bytes, CTAs per SM)
    rows["stem_bwd"]["occupancy"] = stem_cuda.bwd_kernel_info(yq)
    print("stem_bwd on the card: " + json.dumps(rows["stem_bwd"]["occupancy"]), flush=True)
    print("stem kernel rows: " + json.dumps(rows), flush=True)
    print("stem yardsticks (composition, context only): " + json.dumps(context), flush=True)
    del nhwc, xin, yq, gout
    torch.cuda.empty_cache()
    return {"rows": rows, "context": context}


COUNTED = ("stem_cuda", "attention_cuda", "bn_cuda", "stem_native_cuda", "conv3x3_cuda")


def _counts(mods) -> dict:
    cqt_cuda = mods["cqt_cuda"]
    out = {**_cqt_counts(cqt_cuda), "cqt_frame_gemm": cqt_cuda.frame_gemm_launches}
    for tier, n in cqt_cuda.frame_gemm_mma_launches.items():  # tensor-core launches by tier
        out[f"cqt_frame_gemm_mma_{tier}"] = n
    for name in COUNTED:
        out.update(mods[name].launches)
    return out


def _reset_counts(mods) -> None:
    for name in ("launches", "mma_launches", "frame_gemm_launches"):
        setattr(mods["cqt_cuda"], name, 0)
    for counts in (mods["cqt_cuda"].mma_launches_by_tier, mods["cqt_cuda"].frame_gemm_mma_launches):
        for tier in counts:
            counts[tier] = 0
    for name in COUNTED:
        counts = mods[name].launches
        for key in counts:
            counts[key] = 0


def _device_ms(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
        us = evt.self_cuda_time_total
    return us / 1e3


def compare_step(torch, mods, model_cfg, frontend, batch, *, optim_cfg, smoothing,
                 plain_ctx, expect, bn=None, trunk_bn=None, plain_cqt=True,
                 preprocess=None) -> dict:
    """One train step with the kernels and one with the plain versions
    (``plain_ctx(model)`` for the model's kernels, and the plain CQT unless
    ``plain_cqt`` is False), each from the same freshly seeded state and
    batch; held to STEP_TOL for the model's dtype.  ``expect``: each
    kernel's launches in the kernel step.  ``bn(model)``: a BatchNorm whose
    running statistics are held to STEP_TOL's "bn1" entry;
    ``trunk_bn(model)``: one held to TRUNK_BN_TOL (each skipped when
    None).  ``preprocess``: the model input's (the dB features' when None);
    a batch of features needs no ``frontend`` (None)."""
    preprocess = preprocess or mods["make_preprocess"](model_cfg)

    def one_step(plain_kernels: bool, plain_cqt: bool):
        model = mods["build_model"](model_cfg, generator=torch.Generator().manual_seed(0))
        state = mods["create_train_state"](model, optim_cfg, device="cuda")
        step = mods["make_train_step"](
            model, preprocess, smoothing=smoothing,
            frontend=frontend.plain if plain_cqt and frontend is not None else frontend)
        ctx = plain_ctx(model) if plain_kernels else contextlib.nullcontext()
        with ctx:
            met = step(state, batch, torch.Generator(device="cuda").manual_seed(7), LR)
        torch.cuda.synchronize()
        stats = {key: (f(model).running_mean.clone(), f(model).running_var.clone())
                 for key, f in (("bn1", bn), ("trunk_bn", trunk_bn)) if f is not None}
        out = (float(met["loss"]), float(met["grad_norm"]), state.opt_state.mu.clone(), stats)
        del state, model
        torch.cuda.empty_cache()
        return out

    def agreement(a, b):
        out = {
            "loss_rel": abs(a[0] - b[0]) / abs(b[0]),
            "grad_norm_rel": abs(a[1] - b[1]) / abs(b[1]),
            "adam_mu_cosine": float(torch.nn.functional.cosine_similarity(a[2], b[2], dim=0)),
        }
        for key in a[3]:
            out[f"{key}_running_rel"] = max(float((x - y).abs().max() / y.abs().max())
                                            for x, y in zip(a[3][key], b[3][key]))
        return out

    before = _counts(mods)
    kern = one_step(False, False)
    launches = {k: v - before[k] for k, v in _counts(mods).items()}
    plain = one_step(True, plain_cqt)
    plain_launches = {k: v - before[k] - launches[k] for k, v in _counts(mods).items()}
    if not plain_cqt:  # the plain step's CQT ran as the kernel
        for key in plain_launches:
            if key.startswith("cqt_fused"):
                plain_launches[key] -= launches[key]
    cmp = {
        "loss": [kern[0], plain[0]], "grad_norm": [kern[1], plain[1]],
        **agreement(kern, plain),
        "kernel_step_launches": launches, "plain_step_launches": plain_launches,
    }
    if frontend is not None:
        # reference: the kernel step against itself with only the CQT plain,
        # i.e. under a perturbation of the features of <= 2e-3 dB
        cmp["kernel_vs_kernel_with_plain_cqt"] = agreement(kern, one_step(False, True))
    tol = STEP_TOL[model_cfg.dtype]
    if (cmp["loss_rel"] > tol["loss"] or cmp["grad_norm_rel"] > tol["grad_norm"]
            or cmp["adam_mu_cosine"] < tol["cosine"]
            or cmp.get("bn1_running_rel", 0.0) > tol["bn1"]
            or cmp.get("trunk_bn_running_rel", 0.0) > TRUNK_BN_TOL[model_cfg.dtype]
            or launches != {k: expect.get(k, 0) for k in launches}
            or any(plain_launches.values())):
        raise AssertionError(
            f"{model_cfg.dtype}: kernel and plain train steps disagree: {cmp}")
    return cmp


ATTN_TOL = {  # (atol, rtol), tests/test_models.py:304-377,713-737 of the JAX package
    "float32": {"out": (2e-5, 0.0), "grad": (1e-4, 0.0)},
    "bfloat16": {"out": (3e-2, 3e-2), "grad": (0.25, 0.1)},
}
# The JAX limits were set at N=40.  At N=785 with unit-variance inputs a
# typical output or gradient element is ~0.06, so at bf16 they would pass a
# backward whose dV is off by a factor of two.  Each tensor (the output, dq,
# dk, dv) is therefore also held relative to the plain version:
# max|err| <= max * max|ref| and ||err||_2 <= l2 * ||ref||_2.  The limits
# sit between the bf16 kernels' readings and those of faulty versions that
# must fail (attention_controls); each run checks both sides.
ATTN_REL_TOL = {"max": 0.05, "l2": 0.015}
ATTN_MUST_FAIL = ("dv_halved", "rowsum_dropped", "last_key_dropped")
# (B, N, H) at head dim 64: vit_s8's training shape, a ragged N below one
# tile, and N over several tiles
ATTN_CASES = {"main": (64, 785, 6), "ragged": (2, 50, 4), "multi_tile": (1, 300, 2)}


def _qkv_views(torch, b, n, h, dtype, seed, requires_grad=False):
    """One [B, N, 3*H*64] projection output and its q, k, v [B, N, H, 64]
    strided views (the ViT block's layout)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, n, 3 * h * 64), generator=g, device="cuda").to(dtype)
    qkv.requires_grad_(requires_grad)
    return qkv, [t.view(b, n, h, 64) for t in qkv.split(h * 64, dim=-1)]


def _allclose(got, want, atol: float, rtol: float) -> bool:
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def _rel_err(got, want) -> dict:
    """max|err| / max|ref| and ||err||_2 / ||ref||_2 (see ATTN_REL_TOL)."""
    got, want = got.float(), want.float()
    err = got - want
    return {"max": float(err.abs().max() / want.abs().max()),
            "l2": float(err.norm() / want.norm())}


def _rel_ok(errs: dict) -> bool:
    return all(e["max"] <= ATTN_REL_TOL["max"] and e["l2"] <= ATTN_REL_TOL["l2"]
               for e in errs.values())


def attention_controls(torch, attention, q, k, v, g, want, want_grads, dname) -> dict:
    """Faulty versions of the attention, each against the plain version on
    the same inputs: a halved dV; dS = P*dP without its rowsum(dP*P) term
    (dq, dk); the last key left out of the softmax, as an off-by-one mask
    would (the output).  ATTN_REL_TOL must reject each of them; the
    returned ``jax_limits_pass`` says whether ATTN_TOL alone would let it
    through.  ``p_unrounded`` (the value GEMM on fp32 weights) is a
    reading only: a rounding-order difference of the size a sound bf16
    kernel shows."""
    dtype = q.dtype
    (gatol, grtol), (atol, rtol) = ATTN_TOL[dname]["grad"], ATTN_TOL[dname]["out"]
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    scale = q.shape[-1] ** -0.5
    with torch.no_grad():
        p = torch.softmax(torch.einsum("btnh,bsnh->bnts", qf, kf) * scale, dim=-1)
        ds = p * torch.einsum("btnh,bsnh->bnts", gf, vf)
        faulty = {
            "dv_halved": {"dv": (0.5 * want_grads[2].float()).to(dtype)},
            "rowsum_dropped": {
                "dq": (torch.einsum("bnts,bsnh->btnh", ds, kf) * scale).to(dtype),
                "dk": (torch.einsum("bnts,btnh->bsnh", ds, qf) * scale).to(dtype)},
            "last_key_dropped": {"out": attention.attention_reference(q, k[:, :-1], v[:, :-1])},
            "p_unrounded": {"out": torch.einsum("bnts,bsnh->btnh", p, vf).to(dtype)},
        }
        del p, ds
    refs = {"out": want, "dq": want_grads[0], "dk": want_grads[1], "dv": want_grads[2]}
    result = {}
    for name, tensors in faulty.items():
        errs = {t: _rel_err(got, refs[t]) for t, got in tensors.items()}
        result[name] = {
            "rel_err": errs, "rejected": not _rel_ok(errs),
            "jax_limits_pass": all(
                _allclose(got, refs[t], *((atol, rtol) if t == "out" else (gatol, grtol)))
                for t, got in tensors.items())}
    return result


@contextlib.contextmanager
def plain_attention(model, attention):
    """Send the ViT blocks' attention to the plain version while the block
    runs (for the kernel-against-plain comparison only)."""
    blocks = list(model.vit.encoder.layer)
    saved = [blk.attend for blk in blocks]
    for blk in blocks:
        blk.attend = attention.attention_reference
    try:
        yield
    finally:
        for blk, fn in zip(blocks, saved):
            blk.attend = fn


def attention_kernel_phase(torch, mods) -> dict:
    """(a) The attention kernels against the plain version on strided q, k,
    v views at three shapes and both dtypes (forward, gradients, two
    identical backward runs, and the autograd.Function's wiring); then the
    times at vit_s8's training shape in bf16 beside the plain version, the
    bound and scaled_dot_product_attention; then kernel against plain at
    19, 197 and 785 tokens beside the JAX package's 128-token rule."""
    attention, attention_cuda = mods["attention"], mods["attention_cuda"]
    F = torch.nn.functional
    errs = {"attn_fwd": 0.0, "attn_bwd": 0.0}
    for case, (b, n, h) in ATTN_CASES.items():
        for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            qkv, (q, k, v) = _qkv_views(torch, b, n, h, dtype, seed=11)
            g = torch.randn((b, n, h, 64), generator=torch.Generator(device="cuda")
                            .manual_seed(12), device="cuda").to(dtype)
            out, lse = attention_cuda.fwd(q, k, v)
            grads = attention_cuda.bwd(q, k, v, out, lse, g)
            again = attention_cuda.bwd(q, k, v, out, lse, g)
            leaf, views = _qkv_views(torch, b, n, h, dtype, seed=11, requires_grad=True)
            want = attention.attention_reference(*views)
            want_grads = torch.autograd.grad(want, views, g)
            want = want.detach()
            # through the autograd.Function, as the model calls it
            leaf2, views2 = _qkv_views(torch, b, n, h, dtype, seed=11, requires_grad=True)
            fused = attention.fused_attention(*views2)
            dqkv = torch.autograd.grad(fused, leaf2, g)[0]
            torch.cuda.synchronize()
            (atol, rtol), (gatol, grtol) = ATTN_TOL[dname]["out"], ATTN_TOL[dname]["grad"]
            r = {
                "out_max_abs_err": float((out.float() - want.float()).abs().max()),
                "grad_max_abs_err": max(float((a.float() - w.float()).abs().max())
                                        for a, w in zip(grads, want_grads)),
                "out_ok": _allclose(out, want, atol, rtol),
                "grad_ok": all(_allclose(a, w, gatol, grtol)
                               for a, w in zip(grads, want_grads)),
                "deterministic": all(torch.equal(a, w) for a, w in zip(grads, again)),
                "function_equals_kernels": bool(torch.equal(fused, out) and torch.equal(
                    dqkv, torch.cat([d.reshape(b, n, h * 64) for d in grads], dim=-1))),
                "lse_finite": bool(torch.isfinite(lse).all()),
                "rel_err": {t: _rel_err(a, w) for t, a, w in
                            zip(("out", "dq", "dk", "dv"), (out, *grads), (want, *want_grads))},
            }
            r["rel_ok"] = _rel_ok(r["rel_err"])
            print(f"attention kernels vs plain, {case} {dname} [B={b}, N={n}, H={h}, 64]: "
                  + json.dumps(r), flush=True)
            if not all(v for key, v in r.items() if not key.endswith("err")):
                raise AssertionError(f"attention kernels disagree, {case} {dname}: {r}")
            controls = attention_controls(torch, attention, q, k, v, g, want, want_grads, dname)
            print(f"attention controls (faulty versions vs plain), {case} {dname}: "
                  + json.dumps(controls), flush=True)
            passed = [c for c in ATTN_MUST_FAIL if not controls[c]["rejected"]]
            if passed:
                raise AssertionError(f"the attention limits pass faulty versions {passed}, "
                                     f"{case} {dname}: {controls}")
            if case == "main" and dname == "bfloat16":
                errs = {"attn_fwd": r["out_max_abs_err"], "attn_bwd": r["grad_max_abs_err"]}
            del qkv, leaf, leaf2, views, views2, out, lse, grads, again, want, want_grads
            del fused, dqkv
            torch.cuda.empty_cache()

    # times at vit_s8's training shape, bf16
    b, n, h = ATTN_CASES["main"]
    qkv, (q, k, v) = _qkv_views(torch, b, n, h, torch.bfloat16, seed=13)
    g = torch.randn((b, n, h, 64), device="cuda").to(torch.bfloat16)
    out, lse = attention_cuda.fwd(q, k, v)
    ms = {"attn_fwd": _sync_ms(lambda: attention_cuda.fwd(q, k, v), 10),
          "attn_bwd": _sync_ms(lambda: attention_cuda.bwd(q, k, v, out, lse, g), 5)}
    with torch.no_grad():
        plain = {"attn_fwd": _sync_ms(lambda: attention.attention_reference(q, k, v), 5)}
    leaf, views = _qkv_views(torch, b, n, h, torch.bfloat16, seed=13, requires_grad=True)
    ref = attention.attention_reference(*views)
    plain["attn_bwd"] = _sync_ms(
        lambda: torch.autograd.grad(ref, views, g, retain_graph=True), 5)
    del ref
    # yardstick: scaled_dot_product_attention on [B, H, N, Dh] (timed here,
    # never called by the port)
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    gh = g.transpose(1, 2).contiguous()
    with torch.no_grad():
        lib_fwd = _sync_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), 10)
    lib_out = F.scaled_dot_product_attention(qh, kh, vh)
    lib_bwd = _sync_ms(
        lambda: torch.autograd.grad(lib_out, (qh, kh, vh), gh, retain_graph=True), 10)
    lib_fwd_bwd = _sync_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qh, kh, vh), (qh, kh, vh), gh), 10)
    del lib_out
    # bounds: the operations of the JAX kernels' own cost estimates
    # (attention_pallas.py:116-120, 216-220, N unpadded) at the bf16 tensor
    # peak, and each input read once and each output written once
    el = q.element_size()
    elems = b * n * h * 64
    ops = {"attn_fwd": 4 * b * h * n * n * 64, "attn_bwd": 10 * b * h * n * n * 64}
    bytes_ = {"attn_fwd": 4 * el * elems + 4 * b * h * n,           # q, k, v, o; lse
              "attn_bwd": 8 * el * elems + 4 * b * h * n}           # q,k,v,o,g,dq,dk,dv; lse
    rows = {}
    for name in ("attn_fwd", "attn_bwd"):
        ops_s = ops[name] / PEAK_FLOPS["bf16"]
        bytes_s = bytes_[name] / PEAK_BYTES_PER_S
        rows[name] = {
            "max_abs_err": errs[name], "ms": ms[name], "plain_ms": plain[name],
            "bound_ms": 1e3 * max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "library_ms": lib_fwd if name == "attn_fwd" else lib_bwd,
            "flops": ops[name], "bytes": bytes_[name],
            "tflops_per_s": ops[name] / ms[name] / 1e9,
        }
    print("attention kernel rows, bf16 [64, 785, 6, 64]: " + json.dumps(rows), flush=True)
    print("attention yardstick: scaled_dot_product_attention fwd %.4f ms, bwd %.4f ms, "
          "fwd+bwd %.4f ms" % (lib_fwd, lib_bwd, lib_fwd_bwd), flush=True)
    del qkv, q, k, v, g, out, lse, leaf, views, qh, kh, vh, gh
    torch.cuda.empty_cache()

    # kernel against plain, forward + backward, at three token counts
    crossover = {}
    for n in (19, 197, 785):
        gn = torch.randn((b, n, h, 64), device="cuda").to(torch.bfloat16)
        leaf, _ = _qkv_views(torch, b, n, h, torch.bfloat16, seed=14, requires_grad=True)

        def fwd_bwd(fn, n=n, gn=gn, leaf=leaf):
            views = [t.view(b, n, h, 64) for t in leaf.split(h * 64, dim=-1)]
            torch.autograd.grad(fn(*views), leaf, gn)

        crossover[n] = {"kernel_ms": _sync_ms(lambda: fwd_bwd(attention.fused_attention), 5),
                        "plain_ms": _sync_ms(lambda: fwd_bwd(attention.attention_reference), 5)}
        crossover[n]["plain_over_kernel"] = crossover[n]["plain_ms"] / crossover[n]["kernel_ms"]
    print("attention fwd+bwd, kernel vs plain by tokens (B=64, H=6, bf16; the JAX "
          "package's rule takes the kernel above 128 tokens): " + json.dumps(crossover),
          flush=True)
    torch.cuda.empty_cache()
    return {"rows": rows, "crossover": crossover,
            "sdpa_ms": {"fwd": lib_fwd, "bwd": lib_bwd, "fwd_bwd": lib_fwd_bwd}}


def vit_serving_phase(torch, mods, batch: int = 128, n_batches: int = 8) -> dict:
    """(c) vit_s8 serving through Transcriber at batch 128 (vit-reference
    recipe, bf16): windows/s, attn_fwd launches (12 a batch), and the same
    windows through the plain attention."""
    recipe = mods["RECIPES"]["vit-reference"]()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = mods["Transcriber"](None, model_cfg=recipe.model, cqt_cfg=recipe.cqt,
                            batch_size=batch, device="cuda", seed=0)
    cfg = t.cqt_cfg
    windows = tone_windows(batch * n_batches, cfg.window_samples, cfg.sample_rate,
                           seed=8).cpu().numpy()
    t.predict_windows(windows[:batch])  # warm-up
    torch.cuda.synchronize()
    _reset_counts(mods)
    logits = t.predict_windows(windows)
    torch.cuda.synchronize()
    counts = _counts(mods)
    rates = []
    for _ in range(2):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t.predict_windows(windows)
        end.record()
        torch.cuda.synchronize()
        rates.append(1e3 * len(windows) / start.elapsed_time(end))
    x = torch.from_numpy(windows[:batch]).to("cuda")
    with torch.inference_mode():
        feats = t.frontend(x)
        images = t.preprocess(feats)
        model_ms = _sync_ms(lambda: t.model(images), 5)
        with_kernel = t.model(images)
        # the eager forward: a bucket's CUDA graph replays the kernels it captured
        eager = t.model.forward.eager
        with plain_attention(t.model, mods["attention"]):
            with_plain = eager(images)
            plain_model_ms = _sync_ms(lambda: eager(images), 3)
    track = synthetic_track(np.random.default_rng(9), 5.0, cfg.sample_rate)
    res = t.transcribe(track, keep_logits=True)
    diff = float((with_kernel - with_plain).abs().max())
    scale = float(with_plain.abs().max())
    out = {
        "batch": batch, "windows": len(windows), "windows_per_s": rates,
        "model_ms_per_batch": model_ms, "model_ms_per_batch_plain_attention": plain_model_ms,
        "launches": counts, "logit_max_abs_diff": diff, "logit_scale": scale,
        "fret_agreement": float((with_kernel.argmax(-1) == with_plain.argmax(-1))
                                .float().mean()),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    print("serving vit_s8: " + json.dumps(out), flush=True)
    want = {key: 0 for key in counts}
    want.update(_cqt_expect(_route(t.frontend, batch), cfg.precision, n_batches),
                attn_fwd=12 * n_batches)
    if counts != want:
        raise AssertionError(f"vit_s8 serving launches {counts}, expected {want}")
    if logits.shape != (len(windows), 6, 19) or not np.isfinite(logits).all():
        raise AssertionError("vit_s8 serving gave bad logits")
    if res.frets.shape != (res.times.shape[0], 6) or not np.isfinite(res.logits).all():
        raise AssertionError("vit_s8 transcription failed")
    # bf16 model tolerance of the repo (tests/test_torch_models.py): 5e-2 of
    # the logits' scale
    if diff > 5e-2 * scale:
        raise AssertionError("vit_s8 logits with kernel and plain attention differ")
    del t, x, feats, images
    torch.cuda.empty_cache()
    return out


def train_phase(torch, mods, name: str, model_cfg, cqt_cfg, batch: int, *,
                expect: dict, optim_cfg=None, smoothing: float = 0.05,
                compare: dict | None = None, profile: dict | None = None,
                trunk_bn: bool = False, steps: int = TRAIN_STEPS) -> dict:
    """(b)/(c) ``steps`` train steps on 4 rotating batches of seeded audio
    after a warm-up; counters set to 0 just before the timed run and read
    just after, each held to ``expect`` launches per step (0 where not
    named).  ``compare``: keyword arguments of :func:`compare_step`.
    ``profile``: groups of kernel-name fragments ({group: (fragment, ...)})
    whose shares of device time the profiler table reports.  ``trunk_bn``:
    record the memory format of each trunk BatchNorm's input in one step
    and time those BatchNorms (:func:`trunk_bn_cost`)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    optim_cfg = optim_cfg or mods["OptimConfig"]()
    frontend = mods["CQTFrontend"](cqt_cfg)
    preprocess = mods["make_preprocess"](model_cfg)
    model = mods["build_model"](model_cfg, generator=torch.Generator().manual_seed(0))
    state = mods["create_train_state"](model, optim_cfg, device="cuda")
    step = mods["make_train_step"](model, preprocess, smoothing=smoothing, frontend=frontend)
    g = torch.Generator(device="cuda").manual_seed(5)
    audio = torch.randn((4, batch, cqt_cfg.window_samples), generator=g, device="cuda")
    labels = torch.randint(0, 19, (4, batch, 6), generator=g, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)

    def batch_i(i):
        return {"audio": audio[i % 4], "labels": labels[i % 4]}

    for i in range(2):  # warm-up: cuDNN plans, kernel loads
        with record_bn_inputs(torch, mods, model) if trunk_bn and i else \
                contextlib.nullcontext() as bn_record:
            step(state, batch_i(i), gen, LR)
    torch.cuda.synchronize()
    _reset_counts(mods)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t_host = time.perf_counter()
    losses = [step(state, batch_i(i), gen, LR)["loss"] for i in range(steps)]
    t_host = time.perf_counter() - t_host  # the host's time to enqueue the steps
    end.record()
    torch.cuda.synchronize()
    counts = _counts(mods)
    elapsed = start.elapsed_time(end)
    losses = torch.stack(losses)
    out = {
        "batch": batch, "steps": steps, "step_ms": elapsed / steps,
        "host_enqueue_ms_per_step": 1e3 * t_host / steps,
        "segments_per_s": 1e3 * batch * steps / elapsed,
        "launches": counts, "first_loss": float(losses[0]),
        "last_loss": float(losses[-1]), "all_finite": bool(torch.isfinite(losses).all()),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    if not out["all_finite"]:
        raise AssertionError(f"{name}: non-finite loss {losses.tolist()}")
    want = {key: steps * expect.get(key, 0) for key in counts}
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, expected {want}")

    if profile:  # the step's device ops
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(3):
                step(state, batch_i(i), gen, LR)
            torch.cuda.synchronize()
        from torch.autograd import DeviceType

        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and _device_ms(e) > 0]
        total = sum(_device_ms(e) for e in events)
        top = sorted(events, key=_device_ms, reverse=True)[:15]
        print(f"{name}: top 15 device ops (kernels, copies) over 3 steps (device ms, "
              f"share of {total:.3f} ms device time):", flush=True)
        for e in top:
            print(f"  {_device_ms(e):9.3f} ms {100 * _device_ms(e) / total:5.1f} %  "
                  f"x{e.count:<4d} {e.key[:110]}", flush=True)
        groups = {}
        for group, fragments in profile.items():
            mine = sum(_device_ms(e) for e in events if any(f in e.key for f in fragments))
            groups[group] = {"kernels": fragments, "ms_per_step": mine / 3,
                             "share_of_device_time": mine / total}
        out["profile"] = {
            "device_ms_per_step": total / 3, "groups": groups,
            "device_ops_per_step": sum(e.count for e in events) / 3,
            # device time of a profiled step over the timed run's step time
            "device_busy_share": total / 3 / out["step_ms"],
        }
    if trunk_bn:
        out["trunk_bn"] = trunk_bn_cost(torch, mods, bn_record,
                                        out.get("profile", {}).get("device_ms_per_step"))
    del state, model
    torch.cuda.empty_cache()
    if compare:  # one step with the kernels, one with the plain versions
        out["kernel_vs_plain_step"] = {
            dtype: compare_step(torch, mods, dataclasses.replace(model_cfg, dtype=dtype),
                                frontend, batch_i(0), optim_cfg=optim_cfg,
                                smoothing=smoothing, expect=expect, **compare)
            for dtype in STEP_TOL
        }
    print(f"train {name}: " + json.dumps(out), flush=True)
    del audio, labels
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def plain_trunk_and_stems(mods):
    """The fused BatchNorm's, the 224^2 stem tail's and the native stem
    tail's kernels all sent to their plain versions while the block runs."""
    with plain_bn(mods["bn_fused"]), plain_stem(mods["stem_tail"]), \
            plain_native_stem(mods["stem_native"]):
        yield


@contextlib.contextmanager
def plain_bn(bn_fused):
    """Send the fused BatchNorm's reductions to their plain versions while
    the block runs (for the kernel-against-plain comparison only)."""
    saved = bn_fused.sums, bn_fused.grad_sums
    bn_fused.sums, bn_fused.grad_sums = bn_fused.sums_plain, bn_fused.grad_sums_plain
    try:
        yield
    finally:
        bn_fused.sums, bn_fused.grad_sums = saved


@contextlib.contextmanager
def plain_native_stem(stem_native):
    """The same for the native stem tail's three kernels."""
    saved = stem_native.stats, stem_native.fwd, stem_native.bwd
    stem_native.stats = stem_native.stats_plain
    stem_native.fwd, stem_native.bwd = stem_native.fwd_plain, stem_native.bwd_plain
    try:
        yield
    finally:
        stem_native.stats, stem_native.fwd, stem_native.bwd = saved


def _layout(t) -> str:
    import torch

    nchw = t.is_contiguous()
    last = t.ndim == 4 and t.is_contiguous(memory_format=torch.channels_last)
    return "both" if nchw and last else "nchw" if nchw else "channels_last" if last else "strided"


@contextlib.contextmanager
def record_bn_inputs(torch, mods, model):
    """While the block runs (one train step): the (shape, dtype, layout) of
    every FusedBatchNorm input, and how many backward passes received a
    gradient whose strides differ from the input's (the backward then copies
    it into the input's layout)."""
    rec = {"calls": [], "grad_layout_copies": 0}

    def on_forward(_m, args, out):
        x = args[0]
        rec["calls"].append((tuple(x.shape), x.dtype, _layout(x)))
        if out.requires_grad:
            out.register_hook(lambda g: rec.__setitem__(
                "grad_layout_copies", rec["grad_layout_copies"] + (g.stride() != x.stride())))

    hooks = [m.register_forward_hook(on_forward)
             for m in model.modules() if isinstance(m, mods["FusedBatchNorm"])]
    try:
        yield rec
    finally:
        for h in hooks:
            h.remove()


def trunk_bn_cost(torch, mods, rec, device_ms_per_step) -> dict:
    """One step's trunk BatchNorms, forward and backward, run alone at their
    recorded shapes and memory formats: FusedBatchNorm (the bn_sums /
    bn_grad_sums kernels and the plain PyTorch apply and dy) against
    FlaxBatchNorm (plain PyTorch) on the same inputs.  Device time from the
    profiler (the sum of the device ops' times), and the wall time of the
    same pass between CUDA events, which also holds the host's gaps."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    calls = rec["calls"]
    inputs = []
    for shape, dtype, layout in calls:
        fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
        x = torch.randn(shape, device="cuda").to(dtype).contiguous(memory_format=fmt)
        inputs.append((x.requires_grad_(True), torch.randn_like(x)))
    out = {"calls_per_step": len(calls),
           "input_layouts": dict(Counter(layout for _, _, layout in calls)),
           "grad_layout_copies_per_step": rec["grad_layout_copies"]}
    for name, cls in (("fused", mods["FusedBatchNorm"]), ("plain", mods["FlaxBatchNorm"])):
        bns = [cls(x.shape[1]).cuda().train() for x, _ in inputs]

        def one_pass():
            for m, (x, g) in zip(bns, inputs):
                torch.autograd.grad(m(x), x, g)

        out[f"{name}_wall_ms_per_step"] = _sync_ms(one_pass, 3)
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            one_pass()
            torch.cuda.synchronize()
        out[f"{name}_device_ms_per_step"] = sum(
            _device_ms(e) for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    del inputs
    torch.cuda.empty_cache()
    if device_ms_per_step:
        out["fused_share_of_step_device_time"] = out["fused_device_ms_per_step"] / device_ms_per_step
    print("trunk BatchNorms of one step, each timed alone (forward + backward): "
          + json.dumps(out) + " (PERF.md run E: trunk BatchNorm took 49 % of the flagship "
          "step's device time under FlaxBatchNorm)", flush=True)
    return out


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


def bn_kernel_phase(torch, mods) -> dict:
    """(a) bn_sums and bn_grad_sums against their plain versions: the
    flagship's four trunk shapes at B=256 (bf16, NCHW and channels last),
    one fp32 shape and one native trunk shape at B=4096; two runs identical.
    Rows at [256, 64, 56, 56] bf16 channels last (the flagship's layer1, as
    the fused stem hands it over)."""
    bn_cuda, bn_fused = mods["bn_cuda"], mods["bn_fused"]
    cases = [(shape, torch.bfloat16, cl) for shape in
             ((256, 64, 56, 56), (256, 128, 28, 28), (256, 256, 14, 14), (256, 512, 7, 7))
             for cl in (False, True)]
    cases += [((256, 64, 56, 56), torch.float32, True), ((4096, 64, 24, 3), torch.bfloat16, False),
              ((4096, 64, 24, 3), torch.bfloat16, True)]
    gen = torch.Generator(device="cuda").manual_seed(21)
    errs, worst = {"bn_sums": 0.0, "bn_grad_sums": 0.0}, 0.0
    for shape, dtype, cl in cases:
        fmt = torch.channels_last if cl else torch.contiguous_format
        y, g = ((torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5)
                .to(dtype).contiguous(memory_format=fmt) for _ in range(2))
        got, got_g = bn_cuda.sums(y), bn_cuda.grad_sums(y, g)
        want, want_g = bn_fused.sums_plain(y), bn_fused.grad_sums_plain(y, g)
        again = torch.equal(bn_cuda.sums(y), got) and torch.equal(bn_cuda.grad_sums(y, g), got_g)
        torch.cuda.synchronize()
        r = {"sums_rel_err": _rel(got, want), "grad_sums_rel_err": _rel(got_g, want_g),
             "deterministic": again}
        print(f"bn sums vs plain {list(shape)} {str(dtype)[6:]} "
              f"{'channels_last' if cl else 'nchw'}: " + json.dumps(r), flush=True)
        if max(r["sums_rel_err"], r["grad_sums_rel_err"]) > SUM_REL_TOL or not again:
            raise AssertionError(f"bn sums kernels disagree at {shape} {dtype}: {r}")
        worst = max(worst, r["sums_rel_err"], r["grad_sums_rel_err"])
        if shape == (256, 64, 56, 56) and dtype == torch.bfloat16 and cl:
            errs = {"bn_sums": float((got - want).abs().max()),
                    "bn_grad_sums": float((got_g - want_g).abs().max())}
            row_inputs = (y, g)
        else:
            del y, g
        del want, want_g
        torch.cuda.empty_cache()

    y, g = row_inputs
    ms = {"bn_sums": (_kernel_ms(lambda: bn_cuda.sums(y), 20),
                      _sync_ms(lambda: bn_fused.sums_plain(y), 5)),
          "bn_grad_sums": (_kernel_ms(lambda: bn_cuda.grad_sums(y, g), 20),
                           _sync_ms(lambda: bn_fused.grad_sums_plain(y, g), 5))}
    # batch_norm_backward_reduce (SyncBatchNorm's reduction) with mean 0 and
    # invstd 1 returns (sum g, sum g*(y - 0)): the same two sums
    c = y.shape[1]
    mean, invstd = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")

    def reduce():
        return torch.batch_norm_backward_reduce(g, y, mean, invstd, None, True, False, False)

    library = {"bn_sums": _kernel_ms(lambda: torch.var_mean(y, dim=(0, 2, 3), correction=0), 10),
               "bn_grad_sums": _kernel_ms(reduce, 10)}
    lib_g = torch.stack(reduce()[:2])
    if _rel(lib_g, bn_fused.grad_sums_plain(y, g)) > SUM_REL_TOL:
        raise AssertionError("batch_norm_backward_reduce does not compute bn_grad_sums' sums")
    n = y.numel()
    bytes_ = {"bn_sums": y.element_size() * n + 8 * c,
              "bn_grad_sums": 2 * y.element_size() * n + 8 * c}
    ops = {"bn_sums": 3 * n, "bn_grad_sums": 3 * n}  # fp32 products and adds
    rows = {}
    for name in ("bn_sums", "bn_grad_sums"):
        bytes_s, ops_s = bytes_[name] / PEAK_BYTES_PER_S, ops[name] / PEAK_FLOPS["fp32"]
        rows[name] = {
            "max_abs_err": errs[name], "ms": ms[name][0], "plain_ms": ms[name][1],
            "bound_ms": 1e3 * max(bytes_s, ops_s),
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "library_ms": library[name], "bytes": bytes_[name],
        }
    print("bn kernel rows, [256, 64, 56, 56] bf16 channels last: " + json.dumps(rows), flush=True)
    del y, g, row_inputs, lib_g
    torch.cuda.empty_cache()
    return {"rows": rows, "worst_rel_err": worst}


def native_stem_kernel_phase(torch, mods, batch: int = 4096) -> dict:
    """(a) native_stats, native_fwd and native_bwd against their plain
    versions on native-best's conv1 planes (ye, yo [4096, 24, 384] from the
    recipe's CQT of seeded audio) at bf16 and fp32, and on a tie-rich bf16
    input (values on a 1/4 grid); rows at bf16 with times, bounds and
    yardsticks."""
    sn, snc = mods["stem_native"], mods["stem_native_cuda"]
    F = torch.nn.functional
    recipe = mods["RECIPES"]["native-best"]()
    cfg = recipe.cqt
    model_cfg = dataclasses.replace(recipe.model, stem_fusion="fused", bn_fusion="on")
    model = mods["build_model"](model_cfg, generator=torch.Generator().manual_seed(0)).cuda()
    x = tone_windows(batch, cfg.window_samples, cfg.sample_rate, seed=22)
    with torch.no_grad():
        feats = mods["make_preprocess"](model_cfg)(mods["CQTFrontend"](cfg)(x))  # [B, 96, 9, 1]
    del x
    gen = torch.Generator(device="cuda").manual_seed(23)
    c, wreal = 64, 5
    scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
    errs, checks = {}, {}
    inputs = {}
    for label, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32), ("bf16_ties", None)):
        if dtype is None:
            shape = inputs["bf16"][0].shape
            ye, yo = ((torch.randn(shape, generator=gen, device="cuda") * 4).round() / 4
                      for _ in range(2))
            ye, yo = ye.to(torch.bfloat16), yo.to(torch.bfloat16)
        else:
            with torch.no_grad():
                ye, yo = sn.conv1_parity_native(feats, model.resnet.conv1.weight, dtype=dtype)
        b, h2, lanes = ye.shape
        mean, var = sn.native_batch_stats(ye, yo, c, wreal)
        se, oe, _ = mods["stem_tail"].lane_affine(mean, var, scale, bias, 1e-5)
        gout = torch.randn((b, h2, 3, c), generator=gen, device="cuda").to(ye.dtype)
        sums, sums_p = snc.stats(ye, yo), sn.stats_plain(ye, yo)
        pooled, pooled_p = snc.fwd(ye, yo, se, oe, wreal), sn.fwd_plain(ye, yo, se, oe, wreal)
        dye, dyo, sdz, sdzy = snc.bwd(ye, yo, gout, se, oe, wreal)
        pdye, pdyo, psdz, psdzy = sn.bwd_plain(ye, yo, gout, se, oe, wreal)
        again = snc.bwd(ye, yo, gout, se, oe, wreal)
        torch.cuda.synchronize()
        r = {
            "stats_rel_err": _rel(sums, sums_p),
            "fwd_equal": bool(torch.equal(pooled, pooled_p)),
            "bwd_dy_equal": bool(torch.equal(dye, pdye) and torch.equal(dyo, pdyo)),
            "bwd_sum_dz_rel_err": _rel(sdz, psdz), "bwd_sum_dzy_rel_err": _rel(sdzy, psdzy),
            "deterministic": bool(torch.equal(again[2], sdz) and torch.equal(again[3], sdzy)
                                  and torch.equal(snc.stats(ye, yo), sums)),
        }
        checks[label] = r
        print(f"native stem kernels vs plain, {label} ye/yo {list(ye.shape)}: "
              + json.dumps(r), flush=True)
        if not (r["fwd_equal"] and r["bwd_dy_equal"] and r["deterministic"]
                and max(r["stats_rel_err"], r["bwd_sum_dz_rel_err"],
                        r["bwd_sum_dzy_rel_err"]) <= SUM_REL_TOL):
            raise AssertionError(f"native stem kernels disagree ({label}): {r}")
        if label == "bf16":
            errs = {"native_stats": float((sums - sums_p).abs().max()),
                    "native_fwd": float((pooled.float() - pooled_p.float()).abs().max()),
                    "native_bwd": max(float((dye.float() - pdye.float()).abs().max()),
                                      float((dyo.float() - pdyo.float()).abs().max()),
                                      float((sdz - psdz).abs().max()),
                                      float((sdzy - psdzy).abs().max()))}
            inputs["bf16"] = (ye, yo, se, oe, gout)
        del sums_p, pooled_p, pdye, pdyo, again
        torch.cuda.empty_cache()

    ye, yo, se, oe, gout = inputs["bf16"]
    b, h2, lanes = ye.shape
    wp = lanes // c
    ms = {
        "native_stats": (_kernel_ms(lambda: snc.stats(ye, yo), 20),
                         _sync_ms(lambda: sn.stats_plain(ye, yo), 5)),
        "native_fwd": (_kernel_ms(lambda: snc.fwd(ye, yo, se, oe, wreal), 20),
                       _sync_ms(lambda: sn.fwd_plain(ye, yo, se, oe, wreal), 3)),
        "native_bwd": (_kernel_ms(lambda: snc.bwd(ye, yo, gout, se, oe, wreal), 20),
                       _sync_ms(lambda: sn.bwd_plain(ye, yo, gout, se, oe, wreal), 3)),
    }
    # yardstick of the stats: torch.var_mean of the same values per channel,
    # pad columns left out, over one tensor holding both planes
    both = torch.cat([ye, yo]).view(2 * b * h2, wp, c)
    library = {"native_stats": _kernel_ms(
        lambda: torch.var_mean(both[:, :wreal], dim=(0, 1), correction=0), 10),
        "native_fwd": None, "native_bwd": None}
    # context only: batch_norm -> relu -> max_pool2d on the NCHW conv output
    y4 = torch.stack([ye.view(b, h2, wp, c), yo.view(b, h2, wp, c)], dim=2)
    xin = y4.view(b, 2 * h2, wp, c)[:, :, :wreal].permute(0, 3, 1, 2).contiguous()
    xin.requires_grad_(True)

    def composed():
        z = F.batch_norm(xin, None, None, scale, bias, True, 0.0, 1e-5)
        return F.max_pool2d(F.relu(z), 3, 2, 1)

    with torch.no_grad():
        comp_fwd = _sync_ms(composed, 10)
    gcomp = gout.permute(0, 3, 1, 2)
    comp_fwd_bwd = _sync_ms(lambda: torch.autograd.grad(composed(), xin, gcomp), 10)
    del both, y4, xin
    el = ye.element_size()
    # the functions need only the real columns of ye and yo (the pad column
    # is masked out); dye and dyo are written at full width
    n_y, n_real, n_pool = 2 * ye.numel(), 2 * b * h2 * wreal * c, gout.numel()
    bytes_ = {"native_stats": el * n_real + 8 * wreal * c,
              "native_fwd": el * (n_real + n_pool) + 8 * c,
              "native_bwd": el * (n_real + n_pool + n_y) + 8 * c + 8 * wreal * c}
    ops = {"native_stats": 3 * n_real, "native_fwd": 3 * n_real + 8 * n_pool,
           "native_bwd": 7 * n_real + 17 * n_pool}  # as the stem rows count them
    rows = {}
    for name in ("native_stats", "native_fwd", "native_bwd"):
        bytes_s, ops_s = bytes_[name] / PEAK_BYTES_PER_S, ops[name] / PEAK_FLOPS["fp32"]
        rows[name] = {
            "max_abs_err": errs[name], "ms": ms[name][0], "plain_ms": ms[name][1],
            "bound_ms": 1e3 * max(bytes_s, ops_s),
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "library_ms": library[name], "bytes": bytes_[name],
        }
    # the parent commit's yardstick for native_bwd (its ms above is the same
    # timer wherever it reads 0.1 ms or more); native_fwd's ms reads under
    # 0.1 ms, where the profiler's traces lose records: _sync_ms beside it
    rows["native_bwd"]["sync_ms"] = _sync_ms(lambda: snc.bwd(ye, yo, gout, se, oe, wreal), 20)
    rows["native_fwd"]["sync_ms"] = _sync_ms(lambda: snc.fwd(ye, yo, se, oe, wreal), 20)
    rows["native_fwd"]["occupancy"] = snc.fwd_kernel_info(ye)
    print("native_fwd_kernel_info, bf16 [4096, 24, 384]: "
          + json.dumps(rows["native_fwd"]["occupancy"]), flush=True)
    rows["native_bwd"]["occupancy"] = snc.bwd_kernel_info(ye)
    print("native_bwd_kernel_info, bf16 [4096, 24, 384]: "
          + json.dumps(rows["native_bwd"]["occupancy"]), flush=True)
    rows["native_bwd"]["w_pad0"] = native_bwd_without_pad(torch, mods, feats, model, se, oe, gout)
    rows["native_fwd"]["w_pad0"] = native_fwd_without_pad(torch, mods, feats, model, se, oe)
    context = {"batch_norm_relu_maxpool_fwd_ms": comp_fwd,
               "batch_norm_relu_maxpool_fwd_bwd_ms": comp_fwd_bwd,
               "var_mean_ms": library["native_stats"]}
    print("native stem kernel rows, bf16 ye/yo [4096, 24, 384]: " + json.dumps(rows), flush=True)
    print("native stem yardsticks (composition, context only): " + json.dumps(context),
          flush=True)
    del inputs, ye, yo, gout, feats, model
    torch.cuda.empty_cache()
    return {"rows": rows, "checks": checks, "context": context}


def native_bwd_without_pad(torch, mods, feats, model, se, oe, gout) -> dict:
    """native_bwd on conv1's planes with no pad column (w_pad=0: ye, yo
    [4096, 24, 320] bf16, Wp = Wreal = 5) against its plain version (dye,
    dyo equal, sums rtol 1e-5, two runs identical), timed beside the same
    bound as the padded row's counting: the real columns read, dy written."""
    sn, snc = mods["stem_native"], mods["stem_native_cuda"]
    wreal = 5
    with torch.no_grad():
        ye, yo = sn.conv1_parity_native(feats, model.resnet.conv1.weight, w_pad=0,
                                        dtype=torch.bfloat16)
    dye, dyo, sdz, sdzy = snc.bwd(ye, yo, gout, se, oe, wreal)
    pdye, pdyo, psdz, psdzy = sn.bwd_plain(ye, yo, gout, se, oe, wreal)
    again = snc.bwd(ye, yo, gout, se, oe, wreal)
    torch.cuda.synchronize()
    r = {"planes": list(ye.shape),
         "bwd_dy_equal": bool(torch.equal(dye, pdye) and torch.equal(dyo, pdyo)),
         "bwd_sum_dz_rel_err": _rel(sdz, psdz), "bwd_sum_dzy_rel_err": _rel(sdzy, psdzy),
         "deterministic": all(bool(torch.equal(a, w))
                              for a, w in zip(again, (dye, dyo, sdz, sdzy)))}
    if not (r["bwd_dy_equal"] and r["deterministic"]
            and max(r["bwd_sum_dz_rel_err"], r["bwd_sum_dzy_rel_err"]) <= SUM_REL_TOL):
        raise AssertionError(f"native_bwd disagrees without a pad column: {r}")
    del pdye, pdyo, again
    r["ms"] = _kernel_ms(lambda: snc.bwd(ye, yo, gout, se, oe, wreal), 20)
    r["sync_ms"] = _sync_ms(lambda: snc.bwd(ye, yo, gout, se, oe, wreal), 20)
    c = se.shape[0]
    # ye, yo read and dye, dyo written (every column is real), g read
    nbytes = ye.element_size() * (4 * ye.numel() + gout.numel()) + 8 * c + 8 * wreal * c
    r["bound_ms"] = 1e3 * nbytes / PEAK_BYTES_PER_S
    r["plan"] = snc.bwd_kernel_info(ye)
    print("native_bwd without a pad column: " + json.dumps(r), flush=True)
    return r


def native_fwd_without_pad(torch, mods, feats, model, se, oe) -> dict:
    """native_fwd on conv1's planes with no pad column (w_pad=0: ye, yo
    [4096, 24, 320] bf16, Wp = Wreal = 5) against its plain version (pooled
    output equal), timed (the profiler's time and _sync_ms) beside the same
    bound as the padded row's counting: the real columns read, the pool
    written."""
    sn, snc = mods["stem_native"], mods["stem_native_cuda"]
    wreal = 5
    with torch.no_grad():
        ye, yo = sn.conv1_parity_native(feats, model.resnet.conv1.weight, w_pad=0,
                                        dtype=torch.bfloat16)
    pooled = snc.fwd(ye, yo, se, oe, wreal)
    want = sn.fwd_plain(ye, yo, se, oe, wreal)
    torch.cuda.synchronize()
    r = {"planes": list(ye.shape), "fwd_equal": bool(torch.equal(pooled, want))}
    if not r["fwd_equal"]:
        raise AssertionError(f"native_fwd disagrees without a pad column: {r}")
    del want
    r["ms"] = _kernel_ms(lambda: snc.fwd(ye, yo, se, oe, wreal), 20)
    r["sync_ms"] = _sync_ms(lambda: snc.fwd(ye, yo, se, oe, wreal), 20)
    c = se.shape[0]
    nbytes = ye.element_size() * (2 * ye.numel() + pooled.numel()) + 8 * c
    r["bound_ms"] = 1e3 * nbytes / PEAK_BYTES_PER_S
    r["plan"] = snc.fwd_kernel_info(ye)
    print("native_fwd without a pad column: " + json.dumps(r), flush=True)
    return r


def off_identity(torch, model, seed: int) -> None:
    """At init every BatchNorm is the identity in bf16 (rsqrt(1 + 1e-5)
    rounds to 1), which would make a serving comparison vacuous: move their
    parameters and running statistics off it, as the CPU tests do."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                c, dev = m.num_features, m.weight.device
                m.weight.mul_((0.5 + torch.rand(c, generator=gen)).to(dev))
                m.bias.add_((0.1 * torch.randn(c, generator=gen)).to(dev))
                m.running_mean.add_((0.1 * torch.randn(c, generator=gen)).to(dev))
                m.running_var.mul_((0.5 + torch.rand(c, generator=gen)).to(dev))


def native_fused_serving_phase(torch, mods, batch: int = 2048, n_batches: int = 4) -> dict:
    """(d) native-best with stem_fusion="fused", bn_fusion="on" served
    through Transcriber at batch 2048: native_fwd once a batch, no other
    stem or BatchNorm kernel; windows/s; frets against the same weights
    served unfused."""
    recipe = mods["RECIPES"]["native-best"]()
    cfg = recipe.cqt
    fused_cfg = dataclasses.replace(recipe.model, stem_fusion="fused", bn_fusion="on")
    t = mods["Transcriber"](None, model_cfg=fused_cfg, cqt_cfg=cfg, batch_size=batch,
                            device="cuda", seed=0)
    plain = mods["Transcriber"](None, model_cfg=recipe.model, cqt_cfg=cfg, batch_size=batch,
                                device="cuda", seed=0)
    off_identity(torch, t.model, 25)
    plain.model.load_state_dict(t.model.state_dict(), strict=True)
    windows = tone_windows(batch * n_batches, cfg.window_samples, cfg.sample_rate,
                           seed=24).cpu().numpy()
    t.predict_windows(windows[:batch])  # warm-up
    torch.cuda.synchronize()
    _reset_counts(mods)
    logits = t.predict_windows(windows)
    torch.cuda.synchronize()
    counts = _counts(mods)
    rates = []
    for _ in range(2):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t.predict_windows(windows)
        end.record()
        torch.cuda.synchronize()
        rates.append(1e3 * len(windows) / start.elapsed_time(end))
    want_logits = plain.predict_windows(windows)
    agree = float((logits.argmax(-1) == want_logits.argmax(-1)).mean())
    out = {"batch": batch, "windows": len(windows), "windows_per_s": rates, "launches": counts,
           "fret_agreement_with_unfused": agree,
           "logit_max_abs_diff": float(np.abs(logits - want_logits).max()),
           "logit_scale": float(np.abs(want_logits).max())}
    print("serving native-best, stem_fusion=fused bn_fusion=on: " + json.dumps(out), flush=True)
    want = {key: 0 for key in counts}
    want.update(_cqt_expect(_route(t.frontend, batch), t.cqt_cfg.precision, n_batches),
                native_fwd=n_batches)
    if counts != want:
        raise AssertionError(f"fused native serving launches {counts}, expected {want}")
    # bf16 model tolerance of the repo (tests/test_torch_models.py): 5e-2 of
    # the logits' scale
    if (not np.isfinite(logits).all() or agree < FRET_AGREEMENT_MIN
            or out["logit_max_abs_diff"] > 5e-2 * out["logit_scale"]):
        raise AssertionError(f"fused native serving disagrees with unfused: {out}")
    del t, plain
    torch.cuda.empty_cache()
    return out


def _within_one_bf16_ulp(torch, got, want) -> dict:
    """Per element, |got - want| against one bf16 ulp of the larger
    magnitude plus 1e-5 of max|want| (outputs near zero: the fp32 order's
    error exceeds a tiny value's ulp); the share of equal bits."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    limit = torch.ldexp(torch.ones_like(got), e - 8) + BF16_FLOOR * want.abs().max()
    return {"within_one_ulp": bool((diff <= limit).all()),
            "equal_share": float((diff == 0).float().mean()),
            "max_abs_err": float(diff.max()), "scale": float(want.abs().max())}


def _row(ms, plain_ms, library_ms, nbytes, ops, peak, max_abs_err, **extra) -> dict:
    bytes_s, ops_s = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[peak]
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(bytes_s, ops_s),
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "library_ms": library_ms, "bytes": nbytes, "ops": ops, "ops_peak": peak, **extra}


def frame_gemm_phase(torch, mods) -> dict:
    """B9, the raw CQT frame GEMM, through its entry point
    ``cqt_cuda.cqt_frame_gemm``: the training recipe (hop 1024) at B=256 at
    all three tiers and ``serving_cnn`` (hop 512, 130 frames, Kw=6,144) at
    B=64, ``default``.  The counters are set to 0 before the four calls and
    read after them: one launch each, every one on a tensor-core kernel
    (``frame_gemm_mma_launches`` by tier).  Then, per case: the kernel
    against ``frame_gemm_plain`` (TF32 off), per window max|err| <= 1e-4
    max|ref|; two runs identical; ``cqt_epilogue`` of the kernel's output
    against the fused B1 kernel's dB under the CQT limits; at ``highest``
    the per-window error against a float64 contraction of the same inputs
    at most HIGHEST_F64_FACTOR times the fp32 plain version's; times,
    bound, the kernels' occupancy and the library yardstick (one
    ``torch.matmul`` of the prebuilt frames: fp32 with TF32 off for
    ``highest`` and ``bf16x3``, bf16 for ``default``).  The rows: the
    training recipe at each tier."""
    cqt_cuda, cqt = mods["cqt_cuda"], mods["cqt"]
    CQTConfig = mods["CQTConfig"]
    F = torch.nn.functional
    cases = [("train", CQTConfig(), 256, p) for p in ("highest", "bf16x3", "default")]
    cases.append(("serving_cnn", CQTConfig.serving_cnn(), 64, "default"))
    inputs = []
    for name, base, batch, prec in cases:
        fe = mods["CQTFrontend"](dataclasses.replace(base, precision=prec))
        x = tone_windows(batch, base.window_samples, base.sample_rate, seed=31)
        kern = fe.kernels_on(x.device)
        kw = kern.shape[0]
        inputs.append((fe, x, F.pad(x, (kw // 2, kw // 2)), kern))
    torch.cuda.synchronize()

    def call(i):
        fe, _, padded, kern = inputs[i]
        return cqt_cuda.cqt_frame_gemm(padded, kern, hop_length=fe.cfg.hop_length,
                                       n_frames=fe.cfg.n_frames, precision=fe.cfg.precision)

    _reset_counts(mods)
    outs = [call(i) for i in range(len(cases))]
    torch.cuda.synchronize()
    counts = _counts(mods)
    want_counts = {key: 0 for key in counts}
    want_counts["cqt_frame_gemm"] = len(cases)
    for *_, prec in cases:
        want_counts[f"cqt_frame_gemm_mma_{prec}"] += 1
    if counts != want_counts:
        raise AssertionError(f"frame GEMM phase launches {counts}, expected {want_counts}")
    occupancy = cqt_cuda.frame_gemm_mma_kernel_info()
    print("cqt_frame_gemm tensor-core kernels on the card: " + json.dumps(occupancy), flush=True)

    rows = {}
    for i, ((name, base, batch, prec), (fe, x, padded, kern)) in enumerate(zip(cases, inputs)):
        cfg = fe.cfg
        got = outs[i]
        want = cqt.frame_gemm_plain(padded, kern, hop_length=cfg.hop_length,
                                    n_frames=cfg.n_frames, precision=prec)
        again = torch.equal(call(i), got)
        scale = want.abs().amax(dim=(1, 2)).clamp_min(1e-30)
        per_window = (got - want).abs().amax(dim=(1, 2)) / scale
        db = cqt.cqt_epilogue(got, n_bins=cfg.n_bins, magnitude_power=cfg.magnitude_power,
                              amin=cfg.amin, top_db=cfg.top_db,
                              gate_threshold_db=cfg.gate_threshold_db,
                              gate_floor_db=cfg.gate_floor_db)
        vs_b1 = compare_db(db, fe(x), cfg.gate_floor_db, cfg.gate_threshold_db)
        extra = {}
        if prec == "highest":  # both against float64: the tier must be as accurate as fp32
            ref = cqt.frame_gemm_plain(padded.double(), kern.double(), hop_length=cfg.hop_length,
                                       n_frames=cfg.n_frames, precision="highest")
            scale64 = ref.abs().amax(dim=(1, 2))
            extra["f64_err"] = float(((got.double() - ref).abs().amax(dim=(1, 2))
                                      / scale64).max())
            extra["plain_f64_err"] = float(((want.double() - ref).abs().amax(dim=(1, 2))
                                            / scale64).max())
            del ref
        ms = _kernel_ms(lambda: call(i), 10)
        plain_ms = _sync_ms(lambda: cqt.frame_gemm_plain(
            padded, kern, hop_length=cfg.hop_length, n_frames=cfg.n_frames, precision=prec), 3)
        # one torch.matmul of the prebuilt frames: fp32 for the fp32-class tiers
        dt = torch.bfloat16 if prec == "default" else torch.float32
        frames = padded.unfold(-1, kern.shape[0], cfg.hop_length)[:, :cfg.n_frames]
        frames = frames.reshape(-1, kern.shape[0]).to(dt).contiguous()
        kern_dt = kern.to(dt)
        library_ms = _kernel_ms(lambda: torch.matmul(frames, kern_dt), 10)
        del frames, kern_dt
        # bound: the fp32 inputs read once and the output written once; the
        # dense products at default one bf16 tensor-core pass, at bf16x3
        # three; at highest the least time of fp32-accurate work: the FP32
        # pipes, or six bf16 passes on the tensor cores, whichever is less
        products = 2 * got.shape[0] * got.shape[1] * got.shape[2] * kern.shape[0]
        ops, peak = {"highest": min((products, "fp32"), (6 * products, "bf16"),
                                    key=lambda op: op[0] / PEAK_FLOPS[op[1]]),
                     "bf16x3": (3 * products, "bf16"), "default": (products, "bf16")}[prec]
        route = cqt_cuda.frame_gemm_route(prec, cfg.hop_length)
        row = _row(ms, plain_ms, library_ms, 4 * (padded.numel() + kern.numel() + got.numel()),
                   ops, peak, float((got - want).abs().max()),
                   max_rel_err_per_window=float(per_window.max()), deterministic=again,
                   route=route, splits=cqt_cuda.frame_gemm_splits(
                       got.shape[0] * got.shape[1], got.shape[2], kern.shape[0], prec,
                       ring=route == "ring"),
                   epilogue_vs_b1=vs_b1, **extra)
        print(f"cqt_frame_gemm {name} {prec} B={batch}: " + json.dumps(row), flush=True)
        if (per_window.max() > FRAME_GEMM_REL_TOL or not again or vs_b1["bad_flips"]
                or vs_b1["max_err_db"] > DB_TOL
                or extra.get("f64_err", 0) > HIGHEST_F64_FACTOR * extra.get("plain_f64_err", 1)):
            raise AssertionError(f"frame GEMM kernel disagrees on {name}/{prec}: {row}")
        rows[(name, prec)] = row
        del got, want, db
    del outs, inputs
    torch.cuda.empty_cache()
    return {"rows": {"cqt_frame_gemm": rows[("train", "highest")]},
            "bf16x3": rows[("train", "bf16x3")], "default": rows[("train", "default")],
            "launches": counts}


def gemm_stats_phase(torch, mods, batch: int = 256) -> dict:
    """B8, the stem front's GEMM with statistics: the kernel against
    ``gemm_stats_plain`` on random operands at the tool's shape (hq [28672,
    70], sq [70, 7168] bf16) and on the real 224^2 front's operands at
    B=256 (``quadrant_operands`` of CQT-kernel features and a seeded conv1):
    y within one bf16 ulp of plain (share of equal bits printed), and on the
    front equal to ``precomposed_conv1_quadrant`` within one ulp; sums
    within 1e-5 of max|sum| of the float64 column sums of the kernel's own
    y, and folded to channels against B2's ``stem_stats`` kernel on that y;
    two runs identical.  Then the entry point: the ported
    ``profile_stem_pieces`` run once in this process, counters set to 0
    before it and read after (one launch a call of each piece).  The row
    takes the kernel's time and the bare GEMM's as the tool timed them."""
    stem_cuda, stem_tail, stem_fusion = mods["stem_cuda"], mods["stem_tail"], mods["stem_fusion"]
    gen = torch.Generator(device="cuda").manual_seed(41)
    m = batch * 112
    hq = torch.randn((m, 70), generator=gen, device="cuda").to(torch.bfloat16)
    sq = (0.05 * torch.randn((70, 7168), generator=gen, device="cuda")).to(torch.bfloat16)

    def sums_err(y, sums):
        y64 = y.double()
        ref = torch.stack([y64.sum(0), (y64 * y64).sum(0)])
        return float(((sums.double() - ref).abs().amax(1) / ref.abs().amax(1)).max())

    checks = {}
    y, sums = stem_cuda.gemm_stats(hq, sq)
    y_plain, sums_plain = stem_tail.gemm_stats_plain(hq, sq)
    y2, sums2 = stem_cuda.gemm_stats(hq, sq)
    torch.cuda.synchronize()
    checks["random"] = {**_within_one_bf16_ulp(torch, y, y_plain),
                        "sums_rel_err": sums_err(y, sums),
                        "sums_vs_plain_rel_err": _rel(sums, sums_plain),
                        "deterministic": torch.equal(y2, y) and torch.equal(sums2, sums)}
    err = float((y.float() - y_plain.float()).abs().max())
    del y_plain, y2

    # the real front at B=256, as the flagship's stem phase builds it
    cfg = mods["CQTConfig"]()
    model = mods["build_model"](mods["ModelConfig"](arch="resnet18", stem_fusion="fused"),
                                generator=torch.Generator().manual_seed(0)).cuda()
    x = tone_windows(batch, cfg.window_samples, cfg.sample_rate, seed=42)
    with torch.no_grad():
        feats = mods["db_to_unit"](mods["CQTFrontend"](cfg)(x))
        w = model.resnet.conv1.weight
        hq_f, sq_f = stem_fusion.quadrant_operands(feats, w, dtype=torch.bfloat16)
        yq = stem_fusion.precomposed_conv1_quadrant(feats, w, dtype=torch.bfloat16)
    y_f, sums_f = stem_cuda.gemm_stats(hq_f.reshape(-1, hq_f.shape[-1]).contiguous(),
                                       sq_f.contiguous())
    y_f2, sums_f2 = stem_cuda.gemm_stats(hq_f.reshape(-1, hq_f.shape[-1]).contiguous(),
                                         sq_f.contiguous())
    y_fq = y_f.reshape(yq.shape)
    per_channel = sums_f.double().reshape(2, -1, 64).sum(1)
    stem_stats = stem_cuda.stats(y_fq).double()
    torch.cuda.synchronize()
    checks["front"] = {**_within_one_bf16_ulp(torch, y_fq, yq),
                       "sums_rel_err": sums_err(y_f, sums_f),
                       "channels_vs_stem_stats_rel_err": _rel(per_channel, stem_stats),
                       "deterministic": torch.equal(y_f2, y_f) and torch.equal(sums_f2, sums_f)}
    del model, feats, yq, y_f, y_f2, y_fq, hq_f, sq_f
    print(f"gemm_stats vs plain, M={m}: " + json.dumps(checks), flush=True)
    for name, c in checks.items():
        if (not c["within_one_ulp"] or not c["deterministic"] or c["sums_rel_err"] > SUM_REL_TOL
                or c.get("channels_vs_stem_stats_rel_err", 0.0) > SUM_REL_TOL):
            raise AssertionError(f"gemm_stats kernel disagrees ({name}): {c}")

    plain_ms = _sync_ms(lambda: stem_tail.gemm_stats_plain(hq, sq), 3)
    n, k = sq.shape[1], hq.shape[1]
    del hq, sq, y, sums
    torch.cuda.empty_cache()

    _reset_counts(mods)
    tool_rows = mods["profile_stem_pieces"].profile(batch=batch, iters=TOOL_ITERS)
    torch.cuda.synchronize()
    counts = _counts(mods)
    calls = TOOL_ITERS + 1  # one warm-up, then the timed calls
    want = {key: 0 for key in counts}
    want.update(gemm_stats=calls, stem_stats=calls, stem_fwd=2 * calls, stem_bwd=2 * calls)
    print("profile_stem_pieces: " + json.dumps({"launches": counts, "rows": tool_rows}), flush=True)
    if counts != want:
        raise AssertionError(f"profile_stem_pieces launches {counts}, expected {want}")
    # the kernel's time and the bare-GEMM yardstick (no statistics), as the tool timed them
    tool_ms = {r["piece"].split(" (")[0].split(" [")[0]: r["ms"] for r in tool_rows}
    row = _row(tool_ms["GEMM+stats kernel"], plain_ms, tool_ms["bare GEMM"],
               2 * (m * k + k * n + m * n) + 8 * n, 2 * m * n * k, "bf16", err)
    row["occupancy"] = stem_cuda.gemm_stats_kernel_info(k, m, n)
    print("gemm_stats row: " + json.dumps(row), flush=True)
    torch.cuda.empty_cache()
    return {"rows": {"gemm_stats": row}, "launches": counts, "checks": checks}


def conv3x3_phase(torch, mods, batch: int = 256) -> dict:
    """B10, the 3x3 conv with a fused ReLU-affine: the probe's three cases
    at B=256 (each with its output block, the kernel's L2 reads and its
    occupancy) and four small odd ones ([3, 7, 7, 64] -> 64: ragged blocks
    and the halo of a small map; [2, 5, 9, 40] -> 136: C off the 16-channel
    chunk, F off the 64-column tile; [1, 1, 37, 8] -> 8: B=1, H=1, C=F=8;
    [2, 9, 13, 1024] -> 16: the largest C), each against ``conv3x3_plain``
    (TF32 off) within one bf16 ulp, and two runs identical.  Then the entry point: the ported ``probe_conv`` run once in
    this process, counters set to 0 before it and read after; every parity
    figure within one bf16 ulp of max|ref|.  The row is the (56, 64 -> 64)
    case: the kernel's time and cuDNN ``F.conv2d``'s on the same bf16
    relu(x*s + o) as the probe timed them, the plain time from here."""
    conv3x3, conv3x3_cuda = mods["conv3x3"], mods["conv3x3_cuda"]
    gen = torch.Generator(device="cuda").manual_seed(51)
    cases = [(batch, 56, 56, 64, 64), (batch, 28, 28, 128, 128), (batch, 14, 14, 256, 256),
             (3, 7, 7, 64, 64), (2, 5, 9, 40, 136), (1, 1, 37, 8, 8), (2, 9, 13, 1024, 16)]
    checks, first = {}, None
    for b, h, w, c, f in cases:
        x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
        w9 = (0.02 * torch.randn((9, c, f), generator=gen, device="cuda")).to(torch.bfloat16)
        s = (0.5 + torch.rand(c, generator=gen, device="cuda")).to(torch.bfloat16)
        o = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
        got = conv3x3_cuda.conv3x3(x, w9, s, o)
        want = conv3x3.conv3x3_plain(x, w9, s, o)
        again = torch.equal(conv3x3_cuda.conv3x3(x, w9, s, o), got)
        torch.cuda.synchronize()
        key = f"[{b}, {h}, {w}, {c}] -> {f}"
        checks[key] = {**_within_one_bf16_ulp(torch, got, want), "deterministic": again,
                       "block": conv3x3_cuda.tile_shape(h, w)}
        if b == batch:
            checks[key]["l2_bytes"] = conv3x3_cuda.l2_bytes(b, h, w, c, f)
            checks[key]["occupancy"] = conv3x3_cuda.conv3x3_kernel_info(c)
        if not checks[key]["within_one_ulp"] or not again:
            raise AssertionError(f"conv3x3 kernel disagrees at {key}: {checks[key]}")
        if first is None:  # the row's plain time, bytes, operations and error
            plain_ms = _sync_ms(lambda: conv3x3.conv3x3_plain(x, w9, s, o), 3)
            m = b * h * w
            first = (plain_ms, 2 * (x.numel() + w9.numel() + 2 * c + m * f),
                   2 * m * f * 9 * c, checks[key]["max_abs_err"])
        del x, got, want
    print("conv3x3 vs plain: " + json.dumps(checks), flush=True)
    torch.cuda.empty_cache()

    _reset_counts(mods)
    probe_rows = mods["probe_conv"].probe(batch=batch, iters=TOOL_ITERS)
    torch.cuda.synchronize()
    counts = _counts(mods)
    n_cases = len(mods["probe_conv"].CASES)
    want = {key: 0 for key in counts}
    # per case: the parity call, one call per further variant, one warm-up, the timed calls
    want["conv3x3"] = n_cases * (len(conv3x3.VARIANTS) + 1 + TOOL_ITERS)
    print("probe_conv: " + json.dumps({"launches": counts, "rows": probe_rows}), flush=True)
    parities = [r["parity"] for r in probe_rows if "parity" in r]
    if counts != want or max(parities) > 2.0**-7:
        raise AssertionError(f"probe_conv launches {counts} (expected {want}), parity {parities}")
    # the kernel's time and cuDNN's at the (56, 64 -> 64) case, as the probe timed them
    tool_ms = {r["route"].split()[0]: r["ms"] for r in probe_rows
               if r["case"] == probe_rows[0]["case"]}
    plain_ms, n_bytes, ops, err = first
    row = _row(tool_ms["kernel"], plain_ms, tool_ms["cuDNN"], n_bytes, ops, "bf16", err)
    print(f"conv3x3 row, [{batch}, 56, 56, 64] -> 64: " + json.dumps(row), flush=True)
    torch.cuda.empty_cache()
    return {"rows": {"conv3x3": row}, "launches": counts, "checks": checks}


# the kernels the train_cli phase's run must launch: B1 (the CQT of the
# synthetic loaders and, on the card, nowhere else), B6's three (the
# native fused stem) and B7's two (the trunk BatchNorms)
TRAIN_CLI_KERNELS = ("cqt_fused", "native_stats", "native_fwd", "native_bwd", "bn_sums",
                     "bn_grad_sums")


def _run_captured(torch, mods, main, argv: list, label: str,
                  show=lambda line: True) -> tuple[list, dict, float]:
    """``main(argv)`` in-process with its standard output captured, each
    line that ``show`` keeps printed again on a line of its own; the
    counters set to 0 just before and read just after.  Returns (lines,
    launches, seconds)."""
    _reset_counts(mods)
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = {k: v for k, v in _counts(mods).items() if v}
    lines = buf.getvalue().strip().splitlines()
    print(f"{label}: rc={rc} {seconds:.1f} s, launches {json.dumps(counts)}", flush=True)
    for line in filter(show, lines):
        print(line, flush=True)
    if rc != 0:
        raise AssertionError(f"{label}: exit code {rc}")
    return lines, counts, seconds


def _epoch_lines(lines: list) -> list:
    """The epoch messages of train.run's log lines: (epoch, epochs, train
    and val loss, seconds, segments/s)."""
    out = []
    for line in lines:
        found = re.search(r"msg=epoch (\d+)/(\d+): train ([\d.]+) val ([\d.]+) "
                          r".*\(([\d.]+)s, ([\d,]+) segments/s\)", line)
        if found:
            out.append({"epoch": int(found.group(1)), "epochs": int(found.group(2)),
                        "train_loss": float(found.group(3)), "val_loss": float(found.group(4)),
                        "seconds": float(found.group(5)),
                        "segments_per_s": float(found.group(6).replace(",", ""))})
    return out


# ``--eval-only`` of the train_cli checkpoint with the native stem's and the
# trunk BatchNorms' kernels against the same with their plain versions:
# the relative gap of the val loss.  The same weights and running averages
# go through both, eval mode runs no BatchNorm kernel, and the native stem
# forward is bit for bit its plain version, so the two agree exactly (run
# DH: 0.0); the limit leaves room for float64 rounding only.
TRAIN_CLI_EVAL_TOL = 1e-6


def train_cli_phase(torch, mods) -> dict:
    """16. The train entry point on the card: ``train.run.main`` trains
    ``native-best`` with the native fused stem and the fused trunk
    BatchNorm on 32 synthetic tracks at batch 32 for 3 epochs, resumes to
    4, evaluates with ``--eval-only`` (held to the same evaluation through
    the kernels' plain versions), and the serving CLI transcribes a
    synthetic track from the checkpoint.  (At 8 tracks, 16 validation
    windows and 4 steps an epoch, the val loss rises or falls after epoch
    1 with the seed and the rounding, on the CPU as on the card, and the
    resume starts after the best epoch; at 32 tracks, 16 steps an epoch
    and 64 validation windows, it falls every epoch.)"""
    from scipy.io import wavfile

    from guitar_tablature_classification_tpu_torch.data.synthetic import make_synthetic_dataset
    from guitar_tablature_classification_tpu_torch.train import run as train_run

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        base = ["--synthetic", "--synthetic-tracks", "32", "--batch-size", "32",
                "--recipe", "native-best",
                "--stem-fusion", "fused", "--bn-fusion", "on", "--checkpoint-dir", ck,
                "--device", "cuda"]
        lines, counts, seconds = _run_captured(torch, mods, train_run.main,
                                               [*base, "--epochs", "3"], "train_cli train")
        missing = [k for k in TRAIN_CLI_KERNELS if not counts.get(k)]
        if missing:
            raise AssertionError(f"train_cli: kernels {missing} not launched: {counts}")
        epochs = _epoch_lines(lines)
        final = json.loads(lines[-1])
        if [e["epoch"] for e in epochs] != [1, 2, 3] or not np.isfinite(final["best_val_loss"]):
            raise AssertionError(f"train_cli: epochs {epochs}, final {final}")
        with open(os.path.join(ck, "best_guitar_tab_model.meta.json")) as f:
            saved = json.load(f)
        out["train"] = {"seconds": seconds, "launches": counts, "epochs": epochs,
                        "final": final, "checkpoint_epoch": saved["epoch"] + 1,
                        "checkpoint_step": saved["step"]}

        lines, counts, seconds = _run_captured(
            torch, mods, train_run.main, [*base, "--epochs", "4", "--resume"], "train_cli resume")
        epochs = _epoch_lines(lines)
        start = saved["epoch"] + 2  # the epoch after the checkpoint's, 1-based
        resumed = f"resumed from epoch {saved['epoch'] + 1} (step {saved['step']})"
        if not any(resumed in ln for ln in lines) or not epochs or epochs[0]["epoch"] != start:
            raise AssertionError(f"train_cli: the resume did not start at epoch {start}: {epochs}")
        out["resume"] = {"seconds": seconds, "first_epoch": epochs[0]["epoch"], "epochs": epochs,
                         "final": json.loads(lines[-1])}
        with open(os.path.join(ck, "best_guitar_tab_model.meta.json")) as f:
            saved = json.load(f)

        lines, counts, seconds = _run_captured(
            torch, mods, train_run.main, [*base, "--eval-only"], "train_cli eval-only")
        evaluated = json.loads(lines[-1])
        if evaluated.get("checkpoint_step") != saved["step"] or \
                not np.isfinite(evaluated["val_loss"]):
            raise AssertionError(f"train_cli: --eval-only printed {evaluated}, "
                                 f"checkpoint step {saved['step']}")
        with plain_bn(mods["bn_fused"]), plain_native_stem(mods["stem_native"]):
            lines, counts_plain, _ = _run_captured(
                torch, mods, train_run.main, [*base, "--eval-only"],
                "train_cli eval-only, plain versions")
        plain = json.loads(lines[-1])
        gap = abs(evaluated["val_loss"] - plain["val_loss"]) / plain["val_loss"]
        if counts_plain.get("native_fwd") or gap > TRAIN_CLI_EVAL_TOL:
            raise AssertionError(f"train_cli: --eval-only with the kernels {evaluated}, with "
                                 f"their plain versions {plain} (launches {counts_plain})")
        out["eval_only"] = {"seconds": seconds, **evaluated, "launches": counts,
                            "plain": plain, "val_loss_gap": gap, "tol": TRAIN_CLI_EVAL_TOL}

        track = make_synthetic_dataset(np.random.default_rng(1234), 1)[0]
        wav, tab = os.path.join(tmp, "synth.wav"), os.path.join(tmp, "synth_tab.txt")
        wavfile.write(wav, 44100, (np.clip(track["audio"], -1, 1) * 32767).astype(np.int16))
        lines, counts, seconds = _run_captured(
            torch, mods, mods["cli"].main,
            [wav, "--recipe", "native-best", "--model", os.path.join(ck, "best_guitar_tab_model"),
             "--output", tab, "--device", "cuda"],
            "train_cli transcribe", show=lambda ln: ln[:2] in ("e|", "E|") or "written" in ln)
        with open(tab) as f:
            strings = [ln for ln in f if ln[:2] in ("e|", "B|", "G|", "D|", "A|", "E|")]
        if len(strings) != 6 or not counts.get("cqt_fused"):
            raise AssertionError(f"train_cli: transcription from the checkpoint failed "
                                 f"({len(strings)} tab lines, launches {counts})")
        out["transcribe"] = {"seconds": seconds, "launches": counts}
    print("train_cli: " + json.dumps(out), flush=True)
    return out


def bench_phase(torch, mods) -> dict:
    """17. The port's bench (``python -m ...bench``'s ``main``) in-process:
    its JSON line printed; each row must have launched B1 once a step, the
    flagship row B2's three kernels once a step too."""
    from guitar_tablature_classification_tpu_torch import bench

    lines, counts, seconds = _run_captured(torch, mods, bench.main, [], "bench")
    if len(lines) != 1:
        raise AssertionError(f"bench: expected one JSON line, got {lines}")
    result = json.loads(lines[0])
    detail = result["detail"]
    steps = detail["timed_steps"]
    rows = {"flagship": {**detail, "value": result["value"]}}
    rows.update({k: detail[k] for k in ("native_variant", "native_variant_default_tier",
                                        "native_variant_default_tier_b8192",
                                        "native_serving_default_tier")})
    for name, row in rows.items():
        want = {"cqt_fused": steps}
        if name == "flagship":
            want.update(stem_stats=steps, stem_fwd=steps, stem_bwd=steps)
        got = {k: row["launches"].get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"bench {name}: launches {row['launches']}, expected {want}")
        if not (row.get("step_ms") or row.get("batch_ms")) or not row["host_enqueue_ms"] > 0:
            raise AssertionError(f"bench {name}: no step or enqueue time: {row}")
    summary = {name: {"batch": row["batch"], "ms": row.get("step_ms", row.get("batch_ms")),
                      "host_enqueue_ms": row["host_enqueue_ms"], "segments_per_s": row["value"],
                      "launches": row["launches"]} for name, row in rows.items()}
    print("bench rows: " + json.dumps(summary), flush=True)
    return {"rows": summary, "seconds": seconds, "launches": counts}


# The runbook's tree: 48 excerpts of 24 s (120 windows each, 5,760 in
# all), so native-best's training split (80 %) holds two full batches of
# 2048; the extraction's chunk (the runbook's --cqt-batch default).
RUNBOOK_EXCERPTS = 48
RUNBOOK_SECONDS = 24.0
EXTRACT_BATCH = 512
# one track's extracted features against the plain CQT on the same windows
# (tests/test_cqt.py:214-224): off the gate's 0.5 dB boundary, within
# 0.02 dB, the gated cells the same
EXTRACT_TOL_DB, EXTRACT_BOUNDARY_DB = 0.02, 0.5
REPORT_PNGS = ("training_metrics.png", "sample_inputs.png", "prediction_overlay.png",
               "correct_incorrect.png", "confusion_matrices.png", "fret_accuracy.png",
               "model_architecture.png")


def runbook_phase(torch, mods, tree: str) -> dict:
    """18. The GuitarSet runbook on the card: the port's
    ``make_synthetic_guitarset`` renders RUNBOOK_EXCERPTS excerpts into
    ``tree``, then ``run_guitarset.main`` extracts their CQT features on
    the card (B1, one launch per chunk of EXTRACT_BATCH windows of a
    track), regenerates the labels from the JAMS, audits the pairing and
    trains ``native-best`` for 2 epochs with ``--report-dir``.  One
    track's features are held to the plain CQT on the same windows."""
    from guitar_tablature_classification_tpu_torch.data.audio import load_audio
    from guitar_tablature_classification_tpu_torch.labels.extractor import find_audio_for_jams
    from guitar_tablature_classification_tpu_torch.tools import (
        make_synthetic_guitarset,
        run_guitarset,
    )

    t = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        make_synthetic_guitarset.main(["--out", tree, "--excerpts", str(RUNBOOK_EXCERPTS),
                                       "--duration", str(RUNBOOK_SECONDS), "--seed", "42"])
    render_s = time.perf_counter() - t
    audio_dir, jams_dir = os.path.join(tree, "audio"), os.path.join(tree, "annotation")
    work, report = os.path.join(tree, "work"), os.path.join(tree, "report")
    # the report's PNGs need matplotlib, which a machine may lack (--report-dir
    # then exits before training); without it the report's arrays are
    # computed on the card from the checkpoint instead
    plots = importlib.util.find_spec("matplotlib") is not None
    lines, counts, seconds = _run_captured(
        torch, mods, run_guitarset.main,
        ["--audio", audio_dir, "--annotation", jams_dir, "--workdir", work,
         "--recipe", "native-best", "--epochs", "2", "--cqt-batch", str(EXTRACT_BATCH),
         "--device", "cuda", *(["--report-dir", report] if plots else [])],
        "runbook", show=lambda ln: ln.startswith(("[", "pairing", "  ", "best", "per-string")))

    # B1's launches: each track's windows in chunks of EXTRACT_BATCH, each
    # on the kernel cqt_route picks for the chunk (training reads features)
    cfg = mods["CQTConfig"]()
    cfg = dataclasses.replace(cfg, hop_seconds=cfg.window_seconds)
    frontend = mods["CQTFrontend"](cfg)
    features = os.path.join(work, "features")
    names = sorted(os.listdir(features))
    per_track = {}
    for name in names:
        base = name.rsplit("_segment_", 1)[0]
        per_track[base] = per_track.get(base, 0) + 1
    want = {}
    for n in per_track.values():
        for lo in range(0, n, EXTRACT_BATCH):
            chunk = min(EXTRACT_BATCH, n - lo)
            for k, v in _cqt_expect(_route(frontend, chunk), cfg.precision).items():
                want[k] = want.get(k, 0) + v
    got = {k: counts.get(k, 0) for k in _cqt_counts(mods["cqt_cuda"])}
    if got != {k: want.get(k, 0) for k in got}:
        raise AssertionError(f"runbook: CQT launches {got}, expected {want} "
                             f"({len(per_track)} tracks, {len(names)} windows)")

    # one track's features against the plain CQT on the same windows
    base = sorted(per_track)[0]
    audio, _ = load_audio(find_audio_for_jams(audio_dir, base), sample_rate=cfg.sample_rate)
    windows = np.array(mods["frame_track"](audio, cfg, hop_samples=cfg.hop_samples))
    with torch.no_grad():
        plain = frontend.plain(torch.from_numpy(windows).cuda()).cpu().numpy()
    rank = next(n for n in names if n.startswith(f"{base}_segment_")).split("_")[-2]
    got_db = np.stack([np.load(os.path.join(features, f"{base}_segment_{rank}_{k * 0.2:.2f}.npy"))
                       for k in range(len(windows))])
    off_boundary = np.abs(plain - cfg.gate_threshold_db) >= EXTRACT_BOUNDARY_DB
    err = float(np.abs(got_db - plain)[off_boundary].max())
    gated = int(((got_db == cfg.gate_floor_db) != (plain == cfg.gate_floor_db))[off_boundary].sum())
    if err > EXTRACT_TOL_DB or gated:
        raise AssertionError(f"runbook: {base}'s features against the plain CQT: max err "
                             f"{err} dB, {gated} gate flips off the boundary")

    if not any("exact match" in ln for ln in lines):
        raise AssertionError("runbook: the pairing audit did not print 'exact match'")
    final = json.loads(next(ln for ln in reversed(lines) if ln.startswith('{"test_accuracy"')))
    if len(final["per_string"]) != 6 or not np.isfinite(final["per_string"]).all():
        raise AssertionError(f"runbook: final JSON {final}")
    if plots:
        sizes = {png: os.path.getsize(os.path.join(report, png))
                 if os.path.exists(os.path.join(report, png)) else 0 for png in REPORT_PNGS}
        if not all(sizes.values()):
            raise AssertionError(f"runbook: report artifacts missing or empty: {sizes}")
        report_check = {"png_bytes": sizes}
    else:
        report_check = report_on_card(torch, mods, work, final)
    extract = next(re.search(r"wrote (\d+) CQT feature files in ([\d.]+) s", ln)
                   for ln in lines if ln.startswith("[2/4] wrote"))
    train_s = next(float(re.search(r"trained in ([\d.]+) s", ln).group(1))
                   for ln in lines if ln.startswith("[4/4] trained"))
    out = {"excerpts": RUNBOOK_EXCERPTS, "windows": len(names), "render_s": render_s,
           "extract_s": float(extract.group(2)),
           "extract_windows_per_s": int(extract.group(1)) / float(extract.group(2)),
           "train_s": train_s, "runbook_s": seconds, "launches": counts,
           "extract_vs_plain": {"track": base, "windows": len(windows), "max_err_db": err,
                                "gate_flips": gated, "tol_db": EXTRACT_TOL_DB},
           "report": report_check, "final": final}
    print("runbook: " + json.dumps(out), flush=True)
    return out


def report_on_card(torch, mods, work: str, final: dict) -> dict:
    """Without matplotlib: ``train.run.report_data`` (what the report
    plots) for the runbook's best checkpoint on its test split, on the
    card; its confusion matrices' diagonals must give the per-string test
    accuracy the runbook printed (both evaluate that state on that split)."""
    from guitar_tablature_classification_tpu_torch.data.guitarset import create_dataloaders
    from guitar_tablature_classification_tpu_torch.train import Checkpointer
    from guitar_tablature_classification_tpu_torch.train.run import report_data

    print("runbook: matplotlib is not installed on this machine, so no report PNGs: the "
          "report's arrays are computed on the card from the checkpoint (the PNGs are "
          "checked on the CPU by tests/test_torch_report.py)", flush=True)
    recipe = mods["RECIPES"]["native-best"]()
    _, _, test = create_dataloaders(os.path.join(work, "features"), os.path.join(work, "labels"),
                                    recipe.data.batch_size, config=recipe.data)
    model = mods["build_model"](recipe.model, generator=torch.Generator().manual_seed(0))
    state = mods["create_train_state"](model, recipe.optim, device="cuda")
    state, _ = Checkpointer(os.path.join(work, "checkpoints"), recipe.checkpoint_name).restore(
        state, expect_model=dataclasses.asdict(recipe.model))
    data = report_data(state, recipe, test)
    cm = data["confusion"]
    per_string = np.trace(cm, axis1=1, axis2=2) / cm.sum(axis=(1, 2))
    gap = float(np.abs(per_string - np.asarray(final["per_string"])).max())
    # the same bf16 model on the same windows: cuDNN may take another
    # algorithm for the fresh model, so a near tie may flip; two flips of
    # the test windows are allowed
    if cm.shape != (6, 19, 19) or data["preds"].shape != data["targets"].shape or \
            gap > 2.0 / cm[0].sum():
        raise AssertionError(f"runbook: report arrays {cm.shape}, per-string {per_string} "
                             f"against the runbook's {final['per_string']}")
    return {"png_bytes": None, "test_windows": int(cm[0].sum()),
            "per_string_from_confusion": per_string.tolist(), "gap_to_runbook": gap}


AUDIO_TRAIN_STEPS = 10
AUDIO_TRAIN_COMPARED = 3  # steps replayed through the plain versions


def audio_train_phase(torch, mods, tree: str) -> dict:
    """19. Raw-audio training on the card: an ``AudioWindowLoader`` (the
    native C++ loader) over the runbook's WAVs and labels at native-best's
    batch 2048 feeds ``as_device_batches(prefetch=2)`` into
    ``make_train_step`` (native-best with the native fused stem and the
    fused BatchNorms, the CQT kernel as the frontend): AUDIO_TRAIN_STEPS
    steps, path B's launches a step, every prefetched batch bit for bit the
    loader's.  Each of the first AUDIO_TRAIN_COMPARED steps is replayed
    from the state and generator the run had before it, through the plain
    versions (CQT, native stem, BatchNorm), and held to STEP_TOL: one step
    from one state, as compare_step holds path B (three steps of two bf16
    trajectories drift apart by more than one step's limits).  Then, for
    the host's wait beside the prefetch's, the same steps through
    ``batch_to_device`` twice and the prefetch again (the first run of a
    process pins host memory and takes device memory that later runs find
    cached)."""
    from guitar_tablature_classification_tpu_torch.data import (
        AudioWindowLoader,
        as_device_batches,
    )
    from guitar_tablature_classification_tpu_torch.labels.extractor import find_audio_for_jams
    from guitar_tablature_classification_tpu_torch.train import batch_to_device
    from guitar_tablature_classification_tpu_torch.train.engine import (
        _load_snapshot,
        _snapshot,
    )

    recipe = mods["RECIPES"]["native-best"]()
    batch = recipe.data.batch_size
    model_cfg = dataclasses.replace(recipe.model, stem_fusion="fused", bn_fusion="on")
    audio_dir = os.path.join(tree, "audio")
    bases = sorted(f[:-len(".jams")] for f in os.listdir(os.path.join(tree, "annotation")))
    tracks = [(find_audio_for_jams(audio_dir, b), b) for b in bases]
    loader = AudioWindowLoader(tracks, os.path.join(tree, "work", "labels"), batch, recipe.cqt,
                               seed=0)
    if not loader.native:
        raise AssertionError("audio_train: the loader runs the NumPy framing, not the native one")
    frontend = mods["CQTFrontend"](recipe.cqt)
    torch.cuda.empty_cache()

    def run(source, snaps: list | None = None):
        """AUDIO_TRAIN_STEPS steps from a fresh seeded state on the batches
        ``source`` yields: (state, generator, metrics, device batches, the
        host's ms waiting for each batch, step ms from the second step on);
        ``snaps`` collects (state, generator state) before the first
        AUDIO_TRAIN_COMPARED steps."""
        model = mods["build_model"](model_cfg, generator=torch.Generator().manual_seed(0))
        state = mods["create_train_state"](model, recipe.optim, device="cuda")
        step = mods["make_train_step"](model, mods["make_preprocess"](model_cfg),
                                       smoothing=recipe.optim.label_smoothing, frontend=frontend)
        gen = torch.Generator(device="cuda").manual_seed(7)
        metrics, device_batches, events, wait = [], [], [], []
        for i in range(AUDIO_TRAIN_STEPS):
            t = time.perf_counter()
            b = next(source)
            wait.append(1e3 * (time.perf_counter() - t))
            if snaps is not None and i < AUDIO_TRAIN_COMPARED:
                snaps.append((_snapshot(state), gen.get_state()))
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            metrics.append(step(state, b, gen, LR))
            device_batches.append(b)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        torch.cuda.synchronize()
        step_ms = events[1].elapsed_time(events[-1]) / (AUDIO_TRAIN_STEPS - 1)
        return state, gen, metrics, device_batches, wait, step_ms

    host = [loader.next_batch() for _ in range(AUDIO_TRAIN_STEPS)]
    snaps = []
    _reset_counts(mods)
    state, gen, metrics, device_batches, wait, step_ms = run(
        as_device_batches(iter(host), prefetch=2), snaps)
    counts = {k: v for k, v in _counts(mods).items() if v}
    per_step = {**_cqt_expect(_route(frontend, batch), recipe.cqt.precision),
                "native_stats": 1, "native_fwd": 1, "native_bwd": 1,
                "bn_sums": 19, "bn_grad_sums": 19}
    want = {k: AUDIO_TRAIN_STEPS * v for k, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"audio_train: launches {counts}, expected {want}")
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    same = all(torch.equal(d[k].cpu(), torch.from_numpy(h[k]))
               for d, h in zip(device_batches, host) for k in h)
    labelled = float(np.mean([h["weights"].mean() for h in host]))
    if not same or not np.isfinite(losses).all() or labelled < 1.0:
        raise AssertionError(f"audio_train: prefetched batches equal the loader's: {same}, "
                             f"losses {losses}, labelled share {labelled}")

    # each of the first steps again from its state, through the plain versions
    plain_step = mods["make_train_step"](state.model, mods["make_preprocess"](model_cfg),
                                         smoothing=recipe.optim.label_smoothing,
                                         frontend=frontend.plain)
    _reset_counts(mods)
    p_losses, p_norms = [], []
    with plain_bn(mods["bn_fused"]), plain_native_stem(mods["stem_native"]):
        for (snap, gen_state), b in zip(snaps, device_batches):
            _load_snapshot(state, snap)
            gen.set_state(gen_state)
            m = plain_step(state, b, gen, LR)
            p_losses.append(float(m["loss"]))
            p_norms.append(float(m["grad_norm"]))
    plain_counts = {k: v for k, v in _counts(mods).items() if v}
    n = AUDIO_TRAIN_COMPARED
    tol = STEP_TOL[model_cfg.dtype]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses[:n], p_losses)]
    norm_rel = [abs(a - b) / abs(b) for a, b in zip(norms[:n], p_norms)]
    if plain_counts or max(loss_rel) > tol["loss"] or max(norm_rel) > tol["grad_norm"]:
        raise AssertionError(f"audio_train: kernel steps {losses[:n]} / {norms[:n]}, plain "
                             f"{p_losses} / {p_norms} (launches {plain_counts})")
    del state, device_batches, snaps

    def timing(wait, step_ms):
        # the first batch's wait holds the prefetch's fill; the mean of the rest
        return {"step_ms": step_ms, "host_wait_ms_first": wait[0],
                "host_wait_ms_rest": float(np.mean(wait[1:]))}

    runs = {"prefetch": [timing(wait, step_ms)], "batch_to_device": []}
    for name in ("batch_to_device", "batch_to_device", "prefetch"):
        source = as_device_batches(iter(host), prefetch=2) if name == "prefetch" else \
            (batch_to_device(b, torch.device("cuda")) for b in host)
        *_, run_wait, run_ms = run(source)
        runs[name].append(timing(run_wait, run_ms))
    out = {"batch": batch, "steps": AUDIO_TRAIN_STEPS, "tracks": len(tracks),
           "windows": len(loader), "native_loader": loader.native, "launches": counts,
           "launches_per_step": per_step, "losses": losses, "grad_norms": norms,
           "prefetched_equal_host": same,
           "plain_replay": {"steps": n, "losses": p_losses, "grad_norms": p_norms,
                            "loss_rel": loss_rel, "grad_norm_rel": norm_rel,
                            "tol": {"loss": tol["loss"], "grad_norm": tol["grad_norm"]}},
           "step_ms": step_ms, "runs": runs}
    print("audio_train: " + json.dumps(out), flush=True)
    return out


STREAM_SECONDS = 60.0
STREAM_CHUNKS = (1000, 20001)  # seeded chunk sizes in samples, as JAX tests/test_infer.py:248


def _counting_buckets(t) -> list:
    """Record the row count of each ``predict_logits`` call of ``t`` (one a
    bucket of ``predict_windows``)."""
    calls, predict = [], t.predict_logits

    def counted(windows):
        calls.append(int(windows.shape[0]))
        return predict(windows)

    t.predict_logits = counted
    return calls


def _stream(stream, audio, sizes, rng=None) -> tuple:
    """Feed ``audio`` to ``stream`` in chunks (seeded sizes in ``sizes``, or
    all of ``sizes`` samples when ``rng`` is None), then flush: (frets,
    times, ms per feed)."""
    frets, times, ms, pos = [], [], [], 0
    while pos < len(audio):
        n = int(rng.integers(*sizes)) if rng is not None else sizes
        t = time.perf_counter()
        out = stream.feed(audio[pos:pos + n])  # returns host arrays: synchronised
        ms.append(1e3 * (time.perf_counter() - t))
        frets.append(out.frets)
        times.append(out.times)
        pos += n
    out = stream.flush()
    return np.concatenate(frets + [out.frets]), np.concatenate(times + [out.times]), ms


def _profile_feeds(torch, t, audio, sizes, rng) -> dict:
    """``audio`` streamed through ``t`` under ``torch.profiler``: per feed
    (the flush counted as one), its wall time (under the profiler), the
    device time of its kernels and copies and their count, the host's time
    in the CUDA runtime's launch calls, and its time in the calls that wait
    for the card (synchronise, blocking copies).  Device time far under the
    wall time, with the host seldom waiting, is a feed the host holds
    back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from guitar_tablature_classification_tpu_torch.infer import StreamingTranscriber

    torch.cuda.synchronize()
    t_all = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, ms = _stream(StreamingTranscriber(t), audio, sizes, rng)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA and _device_ms(e) > 0]
    host = [e for e in events if e.device_type != DeviceType.CUDA]

    def cpu_ms(keep):
        return sum(e.self_cpu_time_total for e in host if keep(e.key)) / 1e3

    feeds = len(ms) + 1  # and the flush
    dev = sum(_device_ms(e) for e in device)
    return {
        "feeds": feeds, "wall_ms_per_feed": wall / feeds,
        "device_ms_per_feed": dev / feeds,
        "device_ops_per_feed": sum(e.count for e in device) / feeds,
        "launch_api_ms_per_feed": cpu_ms(lambda k: "LaunchKernel" in k) / feeds,
        "host_wait_ms_per_feed": cpu_ms(
            lambda k: "Synchronize" in k or k in ("cudaMemcpy", "cudaMemcpyAsync")) / feeds,
        "device_busy_share": dev / wall if wall > 0 else None,
        "seconds": time.perf_counter() - t_all,  # the trace taken and read
    }


def streaming_phase(torch, mods) -> dict:
    """20. Streaming transcription: path B served (native-best,
    stem_fusion="fused", bn_fusion="on", batch 2048, its BatchNorms off the
    identity) through ``StreamingTranscriber``: a 60 s synthetic track in
    seeded chunks of 1,000-20,000 samples, then ``flush()``, must give the
    offline ``transcribe`` of the same Transcriber exactly (times within
    1e-9 s); B1's tensor-core launches and ``native_fwd``'s one each a
    bucket call; per-feed median and p90 ms and windows/s.  Then 2 s fed in
    single 8,820-sample windows (the 1-row bucket), against the offline
    path too; then both kinds of feed under the profiler
    (:func:`_profile_feeds`); then the CLI with ``--image``."""
    from guitar_tablature_classification_tpu_torch.infer import StreamingTranscriber

    recipe = mods["RECIPES"]["native-best"]()
    cfg = recipe.cqt
    model_cfg = dataclasses.replace(recipe.model, stem_fusion="fused", bn_fusion="on")
    t = mods["Transcriber"](None, model_cfg=model_cfg, cqt_cfg=cfg, batch_size=2048,
                            device="cuda", seed=0)
    off_identity(torch, t.model, 26)
    rng = np.random.default_rng(31)
    audio = synthetic_track(rng, STREAM_SECONDS, cfg.sample_rate)
    offline = t.transcribe(audio)  # also the warm-up
    calls = _counting_buckets(t)
    torch.cuda.synchronize()
    _reset_counts(mods)
    t0 = time.perf_counter()
    frets, times, ms = _stream(StreamingTranscriber(t), audio, STREAM_CHUNKS, rng)
    seconds = time.perf_counter() - t0
    counts = {k: v for k, v in _counts(mods).items() if v}
    want = {"native_fwd": len(calls)}
    for b in calls:
        for k, v in _cqt_expect(_route(t.frontend, b), cfg.precision).items():
            want[k] = want.get(k, 0) + v
    equal = bool(np.array_equal(frets, offline.frets))
    times_err = float(np.abs(times - offline.times).max()) if len(times) == len(offline.times) \
        else float("inf")
    out = {"track_s": STREAM_SECONDS, "windows": int(len(frets)), "feeds": len(ms),
           "bucket_calls": len(calls), "bucket_rows": sorted(set(calls)),
           "feed_ms_median": float(np.median(ms)), "feed_ms_p90": float(np.percentile(ms, 90)),
           "windows_per_s": len(frets) / seconds, "launches": counts,
           "frets_equal_offline": equal, "times_max_err_s": times_err}
    if not equal or times_err > 1e-9 or counts != want:
        raise AssertionError(f"streaming: {out}, expected launches {want}")

    # 2 s in single windows: each feed predicts 1 or 2 windows, in 1-row buckets
    short = audio[: int(2.0 * cfg.sample_rate)]
    want_short = t.transcribe(short)
    del calls[:]
    f1, t1, ms1 = _stream(StreamingTranscriber(t), short, cfg.window_samples)
    out["single_windows"] = {"feeds": len(ms1), "bucket_rows": sorted(set(calls)),
                             "feed_ms_median": float(np.median(ms1)),
                             "frets_equal_offline": bool(np.array_equal(f1, want_short.frets))}
    if not out["single_windows"]["frets_equal_offline"] or set(calls) != {1} \
            or np.abs(t1 - want_short.times).max() > 1e-9:
        raise AssertionError(f"streaming single windows: {out['single_windows']}")
    # where a feed's time goes: the first 3 s of the track in chunks, then
    # 1 s in single windows, each under the profiler (a longer trace costs
    # tens of seconds to take and read)
    out["profile"] = {
        "chunks": _profile_feeds(torch, t, audio[: int(3.0 * cfg.sample_rate)],
                                 STREAM_CHUNKS, np.random.default_rng(33)),
        "single_windows": _profile_feeds(torch, t, short[: int(1.0 * cfg.sample_rate)],
                                         cfg.window_samples, None)}
    out["cli_image"] = cli_image_check(mods)
    print("streaming: " + json.dumps(out), flush=True)
    del t
    torch.cuda.empty_cache()
    return out


def cli_image_check(mods) -> dict:
    """The serving CLI with ``--image``: a PNG of the tab image's size
    where PIL imports; else a non-zero exit before transcribing, with
    nothing written."""
    from scipy.io import wavfile

    seconds = 3.0
    audio = synthetic_track(np.random.default_rng(32), seconds, 44100)
    have_pil = importlib.util.find_spec("PIL") is not None
    with tempfile.TemporaryDirectory() as tmp:
        wav, png = os.path.join(tmp, "demo.wav"), os.path.join(tmp, "tab.png")
        wavfile.write(wav, 44100, (np.clip(audio, -1, 1) * 32767).astype(np.int16))
        argv = [wav, "--recipe", "native-best", "--batch-size", "64", "--device", "cuda",
                "--image", png]
        try:
            with contextlib.redirect_stdout(io.StringIO()):  # the tab's text
                rc = mods["cli"].main(argv)
        except SystemExit as e:
            rc = e.code
        written = sorted(os.listdir(tmp))
        size = None
        if have_pil and os.path.exists(png):
            from PIL import Image

            with Image.open(png) as img:
                size = list(img.size)
    windows = (len(audio) - 8820) // 4410 + 1  # the CLI's 0.2 s windows, 50 % overlap
    want_size = [1600, 60 + 60 + -(-windows // 32) * (40 * 7 + 30)]
    out = {"pil": have_pil, "rc": rc if isinstance(rc, int) else str(rc), "files": written,
           "png_size": size}
    ok = (rc == 0 and size == want_size) if have_pil else \
        (rc not in (0, None) and written == ["demo.wav"])
    if not ok:
        raise AssertionError(f"CLI --image: {out}, expected size {want_size}")
    return out


RGB_TRAIN_STEPS = 10
RGB_BATCH = 256


def rgb_renders(seed: int, batch: int) -> np.ndarray:
    """[batch, 224, 224, 3] uint8 spectrogram renders made in NumPy: seeded
    dB features [batch, 96, 9] through a fixed colour table (a
    blue-to-yellow ramp), nearest-neighbour to 224^2 (no matplotlib)."""
    rng = np.random.default_rng(seed)
    db = rng.uniform(-120.0, 0.0, (batch, 96, 9)).astype(np.float32)
    level = np.clip((db + 120.0) / 120.0 * 255.0, 0, 255).astype(np.uint8)
    v = np.arange(256) / 255.0
    table = (np.stack([v, np.sqrt(v), 1.0 - v], axis=1) * 255.0).astype(np.uint8)
    rows, cols = np.arange(224) * 96 // 224, np.arange(224) * 9 // 224
    return table[level[:, rows][:, :, cols]]


def rgb_train_phase(torch, mods) -> dict:
    """21. The rgb_image input kind on the card: the flagship resnet18
    (stem_fusion="fused", bn_fusion="on") trains on [256, 224, 224, 3] uint8
    renders: a 3-channel input takes the plain conv stem, so bn1 and the
    trunk run B7 (``bn_sums``, ``bn_grad_sums``: 20 a step each) and B1 and
    B2 never launch.  10 steps (step ms, host enqueue ms), then the first
    step from the same state with the kernels and with ``plain_bn``, held
    to STEP_TOL["bfloat16"]."""
    cfg = mods["ModelConfig"](arch="resnet18", stem_fusion="fused", bn_fusion="on")
    optim = mods["OptimConfig"]()
    preprocess = mods["make_preprocess"](cfg, 224, "rgb_image")
    torch.cuda.empty_cache()
    feats = [torch.from_numpy(rgb_renders(40 + i, RGB_BATCH)).cuda() for i in range(2)]
    g = torch.Generator(device="cuda").manual_seed(41)
    labels = [torch.randint(0, 19, (RGB_BATCH, 6), generator=g, device="cuda") for _ in range(2)]
    batches = [{"features": f, "labels": y} for f, y in zip(feats, labels)]
    model = mods["build_model"](cfg, generator=torch.Generator().manual_seed(0))
    state = mods["create_train_state"](model, optim, device="cuda")
    step = mods["make_train_step"](model, preprocess, smoothing=optim.label_smoothing)
    gen = torch.Generator(device="cuda").manual_seed(42)
    for i in range(2):  # warm-up
        step(state, batches[i], gen, LR)
    torch.cuda.synchronize()
    _reset_counts(mods)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t_host = time.perf_counter()
    losses = [step(state, batches[i % 2], gen, LR)["loss"] for i in range(RGB_TRAIN_STEPS)]
    t_host = time.perf_counter() - t_host
    end.record()
    torch.cuda.synchronize()
    counts = {k: v for k, v in _counts(mods).items() if v}
    losses = [float(x) for x in losses]
    n_bn = sum(isinstance(m, mods["FusedBatchNorm"]) for m in model.modules())
    per_step = {"bn_sums": n_bn, "bn_grad_sums": n_bn}
    out = {"batch": RGB_BATCH, "steps": RGB_TRAIN_STEPS, "fused_batchnorms": n_bn,
           "step_ms": start.elapsed_time(end) / RGB_TRAIN_STEPS,
           "host_enqueue_ms_per_step": 1e3 * t_host / RGB_TRAIN_STEPS,
           "launches": counts, "first_loss": losses[0], "last_loss": losses[-1]}
    del state, model
    torch.cuda.empty_cache()
    want = {k: RGB_TRAIN_STEPS * v for k, v in per_step.items()}
    if counts != want or n_bn != 20 or not np.isfinite(losses).all():
        raise AssertionError(f"rgb_train: {out}, expected launches {want}")
    out["kernel_vs_plain_step"] = compare_step(
        torch, mods, cfg, None, batches[0], optim_cfg=optim, smoothing=optim.label_smoothing,
        plain_ctx=lambda model: plain_bn(mods["bn_fused"]), expect=per_step,
        bn=lambda model: model.resnet.bn1, trunk_bn=lambda model: model.resnet.layer1[0].bn1,
        plain_cqt=False, preprocess=preprocess)
    print("rgb_train: " + json.dumps(out), flush=True)
    del feats, labels, batches
    torch.cuda.empty_cache()
    return out


DP_WORLD = 2
DP_BATCH = 2048
DP_TIMEOUT = 300


def _dp_case(torch, mods):
    """Path B's model config, the seeded global batch (host arrays) and the
    frontend, the same in every process."""
    recipe = mods["RECIPES"]["native-best"]()
    cfg = dataclasses.replace(recipe.model, stem_fusion="fused", bn_fusion="on")
    rng = np.random.default_rng(51)
    t = np.arange(recipe.cqt.window_samples) / recipe.cqt.sample_rate
    f0 = 80.0 * 2.0 ** rng.uniform(0, 4, (DP_BATCH, 1))
    audio = (0.5 * np.sin(2 * np.pi * f0 * t) + 0.01 * rng.standard_normal(
        (DP_BATCH, t.size))).astype(np.float32)
    batch = {"audio": audio, "labels": rng.integers(0, 19, (DP_BATCH, 6)).astype(np.int64)}
    return recipe, cfg, batch


def _dp_step(torch, mods, mesh=None) -> dict:
    """One path-B step from the seeded state on the global batch (this
    rank's rows under ``mesh``): metrics, launches, the state's names,
    parameters, running averages and Adam moments (on the host)."""
    recipe, cfg, batch = _dp_case(torch, mods)
    from guitar_tablature_classification_tpu_torch.parallel import shard_batch

    model = mods["build_model"](cfg, generator=torch.Generator().manual_seed(0))
    state = mods["create_train_state"](model, recipe.optim, device="cuda", mesh=mesh)
    frontend = mods["CQTFrontend"](recipe.cqt)
    step = mods["make_train_step"](model, mods["make_preprocess"](cfg),
                                   smoothing=recipe.optim.label_smoothing, frontend=frontend,
                                   mesh=mesh)
    dev_batch = shard_batch(mesh, batch) if mesh is not None else \
        {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    torch.cuda.synchronize()
    _reset_counts(mods)
    m = step(state, dev_batch, torch.Generator(device="cuda").manual_seed(7), LR)
    torch.cuda.synchronize()
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "launches": {k: v for k, v in _counts(mods).items() if v},
           "cqt_expect": _cqt_expect(_route(frontend, dev_batch["audio"].shape[0]),
                                     recipe.cqt.precision),
           "names": list(state.names), "params": state.params.cpu(),
           "mu": {k: v.cpu() for k, v in state.adam_state()["mu"].items()},
           "sd": {k: v.cpu() for k, v in model.state_dict().items()}}
    del state, model, dev_batch
    torch.cuda.empty_cache()
    return out


def _dp_serve(torch, mods, mesh=None) -> dict:
    recipe, cfg, _ = _dp_case(torch, mods)
    t = mods["Transcriber"](None, model_cfg=cfg, cqt_cfg=recipe.cqt, batch_size=DP_BATCH,
                            device="cuda", seed=0, mesh=mesh)
    off_identity(torch, t.model, 25)
    windows = tone_windows(DP_BATCH * 2, recipe.cqt.window_samples, recipe.cqt.sample_rate,
                           seed=52).cpu().numpy()
    _reset_counts(mods)
    logits = t.predict_windows(windows)
    out = {"logits": logits, "buckets": list(t.bucket_sizes),
           "launches": {k: v for k, v in _counts(mods).items() if v}}
    del t
    torch.cuda.empty_cache()
    return out


def dp_worker(rank: int, port: int, out_dir: str) -> int:
    """One of DP_WORLD ranks of the data_parallel phase (``chip_smoke.py
    --dp-worker RANK PORT DIR``): gloo on the one card; which CUDA
    collectives gloo carries; path B's step under dp=2 and under mp=2;
    ``Transcriber(mesh=...)`` at dp=2.  Writes ``DIR/rank{RANK}.pt``."""
    import torch
    import torch.distributed as dist

    mods = port_modules()
    from guitar_tablature_classification_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=DP_WORLD)
    probe = {}
    for name, op in (("all_reduce", lambda t: dist.all_reduce(t)),
                     ("all_gather", lambda t: dist.all_gather([torch.empty_like(t)
                                                               for _ in range(DP_WORLD)], t)),
                     ("broadcast", lambda t: dist.broadcast(t, 0))):
        try:
            op(torch.ones(4, device="cuda"))
            probe[name] = "carried on CUDA tensors"
        except RuntimeError as e:
            probe[name] = f"refused: {str(e).splitlines()[0][:120]}"
    refused = {k: v for k, v in probe.items() if v.startswith("refused")}
    if refused:  # the port calls these collectives on CUDA tensors directly
        raise AssertionError(f"gloo does not carry the port's collectives on CUDA tensors: "
                             f"{refused}")
    dp = make_mesh(mods["MeshConfig"](), device="cuda")
    mp = make_mesh(mods["MeshConfig"](model_parallel=2), device="cuda")
    out = {"probe": probe, "dp": _dp_step(torch, mods, dp), "mp": _dp_step(torch, mods, mp),
           "serve": _dp_serve(torch, mods, dp), "strings": mp.strings}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def _cosine(torch, a: dict, b: dict, names: list) -> float:
    x = torch.cat([a[n].flatten() for n in names])
    y = torch.cat([b[n].flatten() for n in names])
    return float(torch.nn.functional.cosine_similarity(x, y, dim=0))


def _running_rel(a: dict, b: dict, key: str) -> float:
    return max(float((a[f"{key}.running_{s}"] - b[f"{key}.running_{s}"]).abs().max()
                     / b[f"{key}.running_{s}"].abs().max()) for s in ("mean", "var"))


def data_parallel_phase(torch, mods) -> dict:
    """22. Data and string parallelism on the one card: two processes with
    the gloo backend (NCCL refuses two ranks on one device), each running
    :func:`dp_worker`.  Path B's step at a global B=2048 under dp=2 (each
    rank 1,024 rows) and under mp=2 (each rank 3 strings' heads) against
    the one-process step from the same state and batch, within
    STEP_TOL["bfloat16"] (loss, gradient norm, the Adam moments' cosine,
    bn1's running statistics; a trunk BatchNorm's within TRUNK_BN_TOL); the
    shared parameters bit-identical on both ranks; path B's launches on
    each rank; ``Transcriber(mesh=...)`` at dp=2 against one process within
    the fused serving phase's limits."""
    one = _dp_step(torch, mods)
    single_serve = _dp_serve(torch, mods)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        script = os.path.abspath(__file__)
        procs = [subprocess.Popen([sys.executable, script, "--dp-worker", str(r), str(port),
                                   out_dir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for r in range(DP_WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=DP_TIMEOUT)[0].decode())
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"data_parallel: rank {r} exit {p.returncode}: {log[-3000:]}")
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(DP_WORLD)]
    workers_s = time.perf_counter() - t0
    tol = STEP_TOL["bfloat16"]
    per_step = {**one["cqt_expect"], "native_stats": 1, "native_fwd": 1, "native_bwd": 1,
                "bn_sums": 19, "bn_grad_sums": 19}
    out = {"global_batch": DP_BATCH, "workers_s": workers_s, "gloo": ranks[0]["probe"],
           "one_process": {
               "loss": one["loss"], "grad_norm": one["grad_norm"], "launches": one["launches"]}}
    failures = []
    if one["launches"] != per_step:
        failures.append(f"one-process launches {one['launches']}")
    for kind in ("dp", "mp"):
        got = [r[kind] for r in ranks]
        rows = []
        for r, g in enumerate(got):
            want = {**g["cqt_expect"], **{k: v for k, v in per_step.items()
                                         if not k.startswith("cqt")}}
            rows.append({"loss_rel": abs(g["loss"] - one["loss"]) / abs(one["loss"]),
                         "grad_norm_rel": abs(g["grad_norm"] - one["grad_norm"])
                         / abs(one["grad_norm"]),
                         "launches": g["launches"], "launches_ok": g["launches"] == want})
        # the ranks' moments and state by name (a rank holds its strings only)
        mu, sd = {}, {}
        for g in got:
            mu.update(g["mu"])
            sd.update(g["sd"])
        shared = [n for n in got[0]["sd"] if n in got[1]["sd"]]
        entry = {"ranks": rows,
                 "adam_mu_cosine": _cosine(torch, mu, one["mu"], one["names"]),
                 "bn1_running_rel": _running_rel(sd, one["sd"], "resnet.bn1"),
                 "trunk_bn_running_rel": _running_rel(sd, one["sd"], "resnet.layer1.0.bn1"),
                 "shared_bit_identical": all(torch.equal(got[0]["sd"][n], got[1]["sd"][n])
                                             for n in shared)}
        if kind == "mp":
            heads = [[n for n in g["sd"] if n.startswith("branches.") and n.endswith(".8.weight")]
                     for g in got]
            entry["strings"] = [r["strings"] for r in ranks]
            entry["head_tensors_per_rank"] = [len(h) for h in heads]
            if entry["head_tensors_per_rank"] != [3, 3] \
                    or [tuple(x) for x in entry["strings"]] != [(0, 3), (3, 6)]:
                failures.append(f"mp strings {entry['strings']} heads {heads}")
        else:
            entry["params_bit_identical"] = bool(torch.equal(got[0]["params"], got[1]["params"]))
            if not entry["params_bit_identical"]:
                failures.append("dp: the ranks' parameters differ")
        if (max(r["loss_rel"] for r in rows) > tol["loss"]
                or max(r["grad_norm_rel"] for r in rows) > tol["grad_norm"]
                or entry["adam_mu_cosine"] < tol["cosine"] or entry["bn1_running_rel"] > tol["bn1"]
                or entry["trunk_bn_running_rel"] > TRUNK_BN_TOL["bfloat16"]
                or not all(r["launches_ok"] for r in rows) or not entry["shared_bit_identical"]):
            failures.append(f"{kind}: {entry}")
        out[kind] = entry
    serve = []
    for r in ranks:
        logits = r["serve"]["logits"]
        want = single_serve["logits"]
        serve.append({"buckets": r["serve"]["buckets"], "launches": r["serve"]["launches"],
                      "fret_agreement": float((logits.argmax(-1) == want.argmax(-1)).mean()),
                      "logit_max_abs_diff": float(np.abs(logits - want).max()),
                      "logit_scale": float(np.abs(want).max())})
        if (serve[-1]["fret_agreement"] < FRET_AGREEMENT_MIN
                or serve[-1]["logit_max_abs_diff"] > 5e-2 * serve[-1]["logit_scale"]
                or r["serve"]["buckets"] != [8, 32, DP_BATCH]):  # the 1-row bucket dropped
            failures.append(f"serving under the mesh: {serve[-1]}")
    out["serving"] = serve
    print("data_parallel: " + json.dumps(out), flush=True)
    if failures:
        raise AssertionError("data_parallel: " + "; ".join(failures))
    return out


# phases that need no earlier phase's result: ``chip_smoke.py --only a,b``
STANDALONE = {"streaming": streaming_phase, "rgb_train": rgb_train_phase,
              "data_parallel": data_parallel_phase}


def port_modules() -> dict:
    """The port's modules and entry points this script drives."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from guitar_tablature_classification_tpu_torch.config import (
        RECIPES,
        CQTConfig,
        MeshConfig,
        ModelConfig,
        OptimConfig,
    )
    from guitar_tablature_classification_tpu_torch.infer import Transcriber, cli
    from guitar_tablature_classification_tpu_torch.models import build_model
    from guitar_tablature_classification_tpu_torch.models.resnet import (
        FlaxBatchNorm,
        FusedBatchNorm,
    )
    from guitar_tablature_classification_tpu_torch.ops import (
        attention,
        attention_cuda,
        bn_cuda,
        bn_fused,
        conv3x3,
        conv3x3_cuda,
        cqt,
        cqt_cuda,
        stem_cuda,
        stem_fusion,
        stem_native,
        stem_native_cuda,
        stem_tail,
    )
    from guitar_tablature_classification_tpu_torch.ops.cqt import CQTFrontend
    from guitar_tablature_classification_tpu_torch.ops.framing import frame_track
    from guitar_tablature_classification_tpu_torch.ops.normalize import db_to_unit
    from guitar_tablature_classification_tpu_torch.tools import probe_conv, profile_stem_pieces
    from guitar_tablature_classification_tpu_torch.train import (
        create_train_state,
        make_preprocess,
        make_train_step,
    )

    return dict(
        RECIPES=RECIPES, CQTConfig=CQTConfig, ModelConfig=ModelConfig, MeshConfig=MeshConfig,
        OptimConfig=OptimConfig, Transcriber=Transcriber, cli=cli,
        build_model=build_model, cqt_cuda=cqt_cuda, stem_cuda=stem_cuda,
        attention=attention, attention_cuda=attention_cuda,
        stem_fusion=stem_fusion, stem_tail=stem_tail, CQTFrontend=CQTFrontend,
        bn_cuda=bn_cuda, bn_fused=bn_fused, stem_native=stem_native,
        stem_native_cuda=stem_native_cuda, FlaxBatchNorm=FlaxBatchNorm,
        FusedBatchNorm=FusedBatchNorm,
        frame_track=frame_track, db_to_unit=db_to_unit,
        create_train_state=create_train_state, make_preprocess=make_preprocess,
        make_train_step=make_train_step, cqt=cqt, conv3x3=conv3x3,
        conv3x3_cuda=conv3x3_cuda, profile_stem_pieces=profile_stem_pieces,
        probe_conv=probe_conv,
    )


def attention_build_report(mods, log: str) -> None:
    """The attention kernels' -Xptxas -v lines (stack, spills, registers,
    static shared memory) from this run's build, and each kernel as the
    card runs it (registers, local bytes, shared bytes with the dynamic
    part, CTAs per SM)."""
    from guitar_tablature_classification_tpu_torch.ops.nvcc import ptxas_report

    print("attention build, -Xptxas -v:" + ("" if log else " (library already built: no log)"))
    for entry, lines in ptxas_report(log).items():
        found = re.search(r"attn_\w*?kernel", entry)
        if found:
            label = found.group(0) + ("<float>" if entry[found.end():].startswith("If") else "")
            print(f"  {label}: {lines}")
    print("attention kernels on the card: " + json.dumps(mods["attention_cuda"].kernel_info()),
          flush=True)


def cqt_mma_build_report(builds: dict) -> None:
    """The -Xptxas -v lines (stack, spills, registers) of the tensor-core
    kernels of the CQT (B1, B9: frame_gemm_ring_kernel<parts> at each
    tier's count of bf16 pieces) and of the conv3x3 (B10) from this run's
    build (their occupancy on the card is printed with their phases)."""
    from guitar_tablature_classification_tpu_torch.ops.nvcc import ptxas_report

    for source in ("cqt_fused", "cqt_frame_gemm", "conv3x3"):
        log = builds[source][1]
        print(f"{source} build, -Xptxas -v:" + ("" if log else " (already built: no log)"))
        for entry, lines in ptxas_report(log).items():
            found = re.search(r"(cqt_mma|frame_gemm_mma|frame_gemm_ring|to_parts|conv3x3)_kernel"
                              r"(I(?:Lb[01]E)?(?:Li[123]E)?)?", entry)
            if found:  # template arguments: the load path, the bf16 pieces
                args = re.findall(r"L([bi])(\d)E", found.group(2) or "")
                names = [v if k == "i" else ("ldmatrix" if v == "1" else "16-bit") for k, v in args]
                label = f"{found.group(1)}_kernel" + (f"<{', '.join(names)}>" if names else "")
                print(f"  {label}: {lines}")
    sys.stdout.flush()


def stem_build_report(source: str, log: str) -> None:
    """The -Xptxas -v lines (stack, spills, registers) of the stem tails'
    kernels (csrc/stem.cu, csrc/stem_native.cu) and of the stem front's
    GEMM (csrc/stem_gemm.cu) from this run's build (stem_bwd's,
    native_fwd's, native_bwd's and gemm_stats' occupancy on the card are
    printed with their phases)."""
    from guitar_tablature_classification_tpu_torch.ops.nvcc import ptxas_report

    print(f"{source} build, -Xptxas -v:" + ("" if log else " (already built: no log)"))
    for entry, lines in ptxas_report(log).items():
        found = re.search(r"((?:stem|native)_(?:stats|fwd|bwd)_kernel|reduce_parts\w*_kernel)"
                          r"(?:I(13__nv_bfloat16|f)Li(\d+)E)?", entry)
        if found:
            name, dtype, n = found.groups()
            label = name + (f"<{'bf16' if dtype.startswith('13') else 'fp32'}, {n}>"
                            if dtype else "")
            print(f"  {label}: {lines}")
        found = re.search(r"(gemm_stats_kernel|fold_rows_kernel)(?:ILi(\d+)ELb([01])E)?", entry)
        if found:  # csrc/stem_gemm.cu: <k-steps, odd K>
            name, ks, odd = found.groups()
            label = f"<{ks}, {'odd' if odd == '1' else 'even'} K>" if ks else ""
            print(f"  {name}{label}: {lines}")
    sys.stdout.flush()


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--dp-worker"]:  # a rank of the data_parallel phase
        return dp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    mods = port_modules()
    cqt_cuda, stem_cuda = mods["cqt_cuda"], mods["stem_cuda"]
    RECIPES, CQTConfig, ModelConfig = mods["RECIPES"], mods["CQTConfig"], mods["ModelConfig"]
    CQTFrontend = mods["CQTFrontend"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    sources = (("cqt_fused", cqt_cuda.build), ("stem", stem_cuda.build),
               ("attention", mods["attention_cuda"].build), ("bn", mods["bn_cuda"].build),
               ("stem_native", mods["stem_native_cuda"].build),
               ("cqt_frame_gemm", cqt_cuda.build_frame_gemm),
               ("stem_gemm", stem_cuda.build_gemm_stats), ("conv3x3", mods["conv3x3_cuda"].build))
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:  # one nvcc per source
        builds = {name: pool.submit(build) for name, build in sources}
        builds = {name: fut.result() for name, fut in builds.items()}
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name, (path, log) in builds.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {name}: {os.path.relpath(path)} " + " | ".join(regs))
    attention_build_report(mods, builds["attention"][1])
    cqt_mma_build_report(builds)
    for source in ("stem", "stem_native", "stem_gemm"):
        stem_build_report(source, builds[source][1])

    phase_s = {}

    def timed(name, fn, *args, **kwargs):
        t = time.perf_counter()
        result = fn(*args, **kwargs)
        phase_s[name] = round(time.perf_counter() - t, 1)
        return result

    if sys.argv[1:2] == ["--only"]:  # after the build, these phases alone: no result lines
        for name in sys.argv[2].split(","):
            timed(name, STANDALONE[name], torch, mods)
        print("phase seconds: " + json.dumps(phase_s), flush=True)
        return 0

    timed("cqt_kernels", kernel_phase, torch, cqt_cuda, CQTConfig, CQTFrontend)
    timed("cqt_route_sweep", cqt_route_sweep, torch, cqt_cuda, CQTConfig, CQTFrontend)
    serving = timed("serving", serving_phase, torch, cqt_cuda, RECIPES, mods["Transcriber"],
                    mods["frame_track"])
    serving_row = timed("cqt_serving_row", cqt_kernel_row, torch, cqt_cuda,
                        CQTFrontend(RECIPES["native-best"]().cqt), 2048, "native-best serving")
    serving_row["launches"] = serving["tensor_core_launches"]
    timed("resnet18_cli", resnet18_phase, torch, cqt_cuda, mods["cli"])

    stem = timed("stem_kernels", stem_kernel_phase, torch, mods)

    def cqt_expect(cqt_cfg, batch):  # the CQT's counters a step of ``batch`` adds
        return _cqt_expect(_route(CQTFrontend(cqt_cfg), batch), cqt_cfg.precision)

    one_each = {**cqt_expect(CQTConfig(), 256), "stem_stats": 1, "stem_fwd": 1,
                "stem_bwd": 1}
    flagship = timed(
        "flagship_train", train_phase, torch, mods, "flagship resnet18+fused",
        ModelConfig(arch="resnet18", stem_fusion="fused"), CQTConfig(), 256,
        expect=one_each, profile={"stem": ("stem_", "reduce_partials"), "cqt": ("cqt_",)},
        compare=dict(plain_ctx=lambda model: plain_stem(mods["stem_tail"]),
                     bn=lambda model: model.resnet.bn1),
    )
    native_recipe = RECIPES["native-best"]()
    timed("native_train", train_phase, torch, mods, "native resnet18_native",
          native_recipe.model, native_recipe.cqt, 4096,
          expect=cqt_expect(native_recipe.cqt, 4096))
    # the CQT kernel at the flagship step's shape (training recipe, highest:
    # the route's kernel), at bf16x3 there, and highest on the tensor cores
    # at the kernel phase's B=4096; no model path runs the last two, so
    # their launches on a path are 0
    cqt_row = timed("cqt_train_row", cqt_kernel_row, torch, cqt_cuda,
                    CQTFrontend(CQTConfig()), 256, "flagship train")
    bf16x3_row = timed("cqt_train_row_bf16x3", cqt_kernel_row, torch, cqt_cuda,
                       CQTFrontend(CQTConfig(precision="bf16x3")), 256, "flagship train")
    highest_mma_row = timed("cqt_train_row_b4096", cqt_kernel_row, torch, cqt_cuda,
                            CQTFrontend(CQTConfig()), 4096, "kernel phase train")
    bf16x3_row["launches"] = highest_mma_row["launches"] = 0

    attn = timed("attention_kernels", attention_kernel_phase, torch, mods)
    vit_recipe = RECIPES["vit-reference"]()
    vit_expect = {**cqt_expect(vit_recipe.cqt, vit_recipe.data.batch_size), "attn_fwd": vit_recipe.model.vit_layers,
                  "attn_bwd": vit_recipe.model.vit_layers}
    vit = timed(
        "vit_s8_train", train_phase, torch, mods, "vit_s8 (vit-reference)",
        vit_recipe.model, vit_recipe.cqt, vit_recipe.data.batch_size,
        expect=vit_expect, optim_cfg=vit_recipe.optim,
        smoothing=vit_recipe.optim.label_smoothing, profile={"attention": ("attn_",)},
        compare=dict(plain_ctx=lambda model: plain_attention(model, mods["attention"])),
    )
    timed("vit_s8_serving", vit_serving_phase, torch, mods)
    small = RECIPES["vit-small-data"]()
    timed("vit_small_data_train", train_phase, torch, mods, "vit_native (vit-small-data)",
          small.model, small.cqt, small.data.batch_size,
          expect=cqt_expect(small.cqt, small.data.batch_size), optim_cfg=small.optim,
          smoothing=small.optim.label_smoothing, steps=5)

    bn = timed("bn_kernels", bn_kernel_phase, torch, mods)
    native_stem = timed("native_stem_kernels", native_stem_kernel_phase, torch, mods)
    sums_kernels = ("col_sums", "fold_partials")  # csrc/bn.cu
    trunk = {"bn_sums": 19, "bn_grad_sums": 19}  # 20 BatchNorms, bn1 in the fused stem
    plain_all = dict(plain_ctx=lambda model: plain_trunk_and_stems(mods),
                     bn=lambda model: model.resnet.bn1,
                     trunk_bn=lambda model: model.resnet.layer1[0].bn1)
    path_a = timed(
        "path_a_train", train_phase, torch, mods, "path A: resnet18+fused+bn_fusion",
        ModelConfig(arch="resnet18", stem_fusion="fused", bn_fusion="on"), CQTConfig(), 256,
        expect={**one_each, **trunk}, trunk_bn=True, compare=plain_all,
        profile={"column_sums": sums_kernels, "stem": ("stem_", "reduce_partials")},
    )
    native_fused = dataclasses.replace(native_recipe.model, stem_fusion="fused", bn_fusion="on")
    path_b = timed(
        "path_b_train", train_phase, torch, mods, "path B: native-best+fused+bn_fusion",
        native_fused, native_recipe.cqt, 4096,
        expect={**cqt_expect(native_recipe.cqt, 4096), "native_stats": 1, "native_fwd": 1,
                "native_bwd": 1, **trunk},
        trunk_bn=True, compare={**plain_all, "plain_cqt": False},
        profile={"column_sums": sums_kernels, "native_stem": ("native_", "reduce_parts"),
                 "native_bwd": ("native_bwd",)},
    )
    timed("path_b_serving", native_fused_serving_phase, torch, mods)
    frame_gemm = timed("frame_gemm", frame_gemm_phase, torch, mods)
    for tier in ("bf16x3", "default"):  # the tier's tensor-core launches in the entry point's run
        frame_gemm[tier]["launches"] = frame_gemm["launches"][f"cqt_frame_gemm_mma_{tier}"]
    gemm_stats = timed("gemm_stats", gemm_stats_phase, torch, mods)
    conv = timed("conv3x3", conv3x3_phase, torch, mods)
    timed("train_cli", train_cli_phase, torch, mods)
    timed("bench", bench_phase, torch, mods)
    with tempfile.TemporaryDirectory() as tree:
        runbook = timed("runbook", runbook_phase, torch, mods, tree)
        audio_train = timed("audio_train", audio_train_phase, torch, mods, tree)
    streaming = timed("streaming", streaming_phase, torch, mods)
    rgb_train = timed("rgb_train", rgb_train_phase, torch, mods)
    data_parallel = timed("data_parallel", data_parallel_phase, torch, mods)
    print("phase seconds: " + json.dumps(phase_s), flush=True)

    kernel_sources = {  # name -> (source, TPU kernel, rows, the main path's run)
        "cqt_fused": ("cqt.cu", "cqt_pallas.py:594", {"cqt_fused": cqt_row}, flagship),
        "stem_stats": ("stem.cu", "stem_pallas.py:388", stem["rows"], flagship),
        "stem_fwd": ("stem.cu", "stem_pallas.py:214", stem["rows"], flagship),
        "stem_bwd": ("stem.cu", "stem_pallas.py:262", stem["rows"], flagship),
        "attn_fwd": ("attention.cu", "attention_pallas.py:70", attn["rows"], vit),
        "attn_bwd": ("attention.cu", "attention_pallas.py:138", attn["rows"], vit),
        "bn_sums": ("bn.cu", "bn_pallas.py:71", bn["rows"], path_a),
        "bn_grad_sums": ("bn.cu", "bn_pallas.py:109", bn["rows"], path_a),
        "native_stats": ("bn.cu", "stem_native.py:347", native_stem["rows"], path_b),
        "native_fwd": ("stem_native.cu", "stem_native.py:232", native_stem["rows"], path_b),
        "native_bwd": ("stem_native.cu", "stem_native.py:280", native_stem["rows"], path_b),
        "cqt_frame_gemm": ("cqt_frame_gemm.cu", "cqt_pallas.py:153", frame_gemm["rows"],
                           frame_gemm),
        "gemm_stats": ("stem_gemm.cu", "stem_pallas.py:326", gemm_stats["rows"], gemm_stats),
        "conv3x3": ("conv3x3.cu", "tools/probe_pallas_conv.py:53", conv["rows"], conv),
    }
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": f"guitar_tablature_classification_tpu_torch/csrc/{src}",
        # the JAX package's ops/, or a path from the repo root
        "replaces": tpu if "/" in tpu else f"guitar_tablature_classification_tpu/ops/{tpu}",
        "launches": run["launches"][name],
        **{k: rows[name][k] for k in fields},
    } for name, (src, tpu, rows, run) in kernel_sources.items()]
    # the other tiers beside the highest tier's fields (B1 at the flagship
    # shape: the kernel its route picks there, the SIMT one): B1's default
    # tier at the native-best serving shape (launches: the serving phase's),
    # its bf16x3 tier at the flagship shape and highest on the tensor cores
    # at B=4096 (no model path runs either: launches 0), B9's bf16x3 and
    # default tiers at the training recipe (launches: its entry point's run)
    tiers = {"cqt_fused": {"default": serving_row, "bf16x3": bf16x3_row,
                           "highest_mma": highest_mma_row},
             "cqt_frame_gemm": {"bf16x3": frame_gemm["bf16x3"], "default": frame_gemm["default"]}}
    for entry in kernels:
        for tier, row in tiers.get(entry["name"], {}).items():
            entry[tier] = {k: row[k] for k in ("launches", *fields)}
        # the other paths' launches beside the main path's: the runbook's
        # extraction (B1), the raw-audio train step (B1, B6, B7), streaming
        # (B1, native_fwd), the rgb_image step (B7) and rank 0's step under
        # dp=2 (B1, B6, B7)
        for path, launches in (("runbook", runbook["launches"]),
                               ("audio_train", audio_train["launches"]),
                               ("streaming", streaming["launches"]),
                               ("rgb_train", rgb_train["launches"]),
                               ("data_parallel", data_parallel["dp"]["ranks"][0]["launches"])):
            if launches.get(entry["name"]):
                entry[f"{path}_launches"] = launches[entry["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
