#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Set-up: the card's name and power limit, torch and CUDA versions, and
   the build of the port's kernel source (one ``nvcc`` run).
2. Kernel against plain version (TF32 off): the fused CQT kernel at every
   precision tier on the training recipe (B=4096), the 3 s serving recipe,
   a reflect-padded recipe and a hop-1000 recipe, each against its plain
   PyTorch version on the same inputs, plus the kernel at highest against
   the repo's NumPy golden fixture.
3. The ``native-best`` serving path: a seeded random-init ``Transcriber``
   (batch 2048) transcribes synthetic tracks and one 4096-window batch;
   the kernel's launch count must rise; windows/s after a warm-up; the same
   windows through the plain CQT on the card must give the same logits.
4. A short ``--arch resnet18`` transcription through the CLI.

Then one JSON line of kernel measurements, and the status line last.
Any failed check raises, which exits non-zero.  Needs one CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

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


def _sync_ms(fn, iters: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def kernel_phase(torch, cqt_cuda, CQTConfig, CQTFrontend) -> dict:
    recipes = {
        "train": (CQTConfig(), 4096),
        "serving_cnn_3s": (CQTConfig.serving_cnn(), 256),
        "reflect": (dataclasses.replace(CQTConfig(), pad_mode="reflect"), 512),
        "hop1000": (dataclasses.replace(
            CQTConfig(), hop_length=1000, window_seconds=0.25,
            hop_seconds=0.125), 512),
    }
    results = {}
    for name, (base, batch) in recipes.items():
        x = tone_windows(batch, base.window_samples, base.sample_rate, seed=1)
        for prec in ("highest", "bf16x3", "default"):
            fe = CQTFrontend(dataclasses.replace(base, precision=prec))
            cqt_cuda.launches = 0
            got = fe(x)
            torch.cuda.synchronize()
            launches = cqt_cuda.launches
            want = fe.plain(x)
            torch.cuda.synchronize()
            r = compare_db(got, want, base.gate_floor_db, base.gate_threshold_db)
            r.update(
                batch=batch, launches=launches,
                kernel_ms=_sync_ms(lambda: fe(x), 5),
                plain_ms=_sync_ms(lambda: fe.plain(x), 3),
            )
            print(f"cqt {name} {prec} B={batch}: " + json.dumps(r), flush=True)
            if r["bad_flips"] or r["max_err_db"] > DB_TOL or launches != 1:
                raise AssertionError(f"CQT kernel disagrees on {name}/{prec}: {r}")
            results[(name, prec)] = r
            del got, want
        del x
        torch.cuda.empty_cache()

    # the kernel at highest against the float64 NumPy golden fixture
    root = os.path.dirname(os.path.abspath(__file__))
    golden = np.load(os.path.join(root, "tests", "data", "cqt_golden.npz"))
    fe = CQTFrontend(CQTConfig())
    got = fe(torch.from_numpy(golden["input"]).cuda()).cpu().numpy()
    want = golden["output"]
    off_gate = np.abs(want + 60.0) >= 0.5
    gerr = float(np.abs(got - want)[off_gate].max())
    print(f"cqt golden fixture: max_err_db={gerr} (tol {GOLDEN_TOL})", flush=True)
    if gerr > GOLDEN_TOL:
        raise AssertionError("CQT kernel disagrees with the golden fixture")
    return results


def main_path_kernel_row(torch, cqt_cuda, frontend, batch: int) -> dict:
    """The kernel at the main path's shape (native-best: training recipe,
    default tier, batch 2048): times, bound and the library yardstick."""
    cfg = frontend.cfg
    fb = frontend.filterbank
    x = tone_windows(batch, cfg.window_samples, cfg.sample_rate, seed=2)
    got, want = frontend(x), frontend.plain(x)
    r = compare_db(got, want, cfg.gate_floor_db, cfg.gate_threshold_db)
    kernel_ms = _sync_ms(lambda: frontend(x), 10)
    plain_ms = _sync_ms(lambda: frontend.plain(x), 5)
    # yardstick: one torch.matmul of the prebuilt bf16 frame stack with the
    # bf16 filterbank (the frame GEMM alone, without the epilogue)
    kw = fb.kernel_width
    padded = torch.nn.functional.pad(x, (kw // 2, kw // 2))
    frames = padded.unfold(-1, kw, cfg.hop_length)[:, :cfg.n_frames]
    frames = frames.reshape(-1, kw).to(torch.bfloat16).contiguous()
    kern = frontend.kernels_on(x.device).to(torch.bfloat16)
    library_ms = _sync_ms(lambda: torch.matmul(frames, kern), 10)
    del frames, padded
    # the bound at the default tier: bf16 operands, so the bf16 peak for the
    # products and 2 bytes for each filter value the window needs; the audio
    # is read as given (fp32) and the dB written as fp32
    assert cfg.precision == "default", cfg.precision
    macs = cqt_cuda.needed_macs(fb, cfg, cfg.window_samples) * batch
    ops_s = 2 * macs / PEAK_FLOPS["bf16"]
    filt_values = cqt_cuda.needed_filter_values(fb, cfg, cfg.window_samples)
    nbytes = (4 * x.numel() + 2 * filt_values
              + 4 * batch * cfg.n_bins * cfg.n_frames)
    bytes_s = nbytes / PEAK_BYTES_PER_S
    row = {
        "max_abs_err": r["max_err_db"], "flips": r["flips"],
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": 1e3 * max(ops_s, bytes_s),
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "macs": macs, "bytes": nbytes,
    }
    print(f"cqt main-path shape train default B={batch}: {json.dumps(row)}",
          flush=True)
    if r["bad_flips"] or r["max_err_db"] > DB_TOL:
        raise AssertionError(f"CQT kernel disagrees at the main-path shape: {r}")
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

    cqt_cuda.launches = 0
    results = [t.transcribe(a, keep_logits=True) for a in tracks]
    logits_big = t.predict_windows(big)
    torch.cuda.synchronize()
    launches = cqt_cuda.launches
    print(f"serving native-best: cqt kernel launches on the main path = "
          f"{launches}", flush=True)
    if launches <= 0:
        raise AssertionError("the serving path did not launch the CQT kernel")
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
        "launches": launches, "logit_max_abs_diff": diff,
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from guitar_tablature_classification_tpu_torch.config import RECIPES, CQTConfig
    from guitar_tablature_classification_tpu_torch.infer import Transcriber, cli
    from guitar_tablature_classification_tpu_torch.ops import cqt_cuda
    from guitar_tablature_classification_tpu_torch.ops.cqt import CQTFrontend
    from guitar_tablature_classification_tpu_torch.ops.framing import frame_track

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
    path, log = cqt_cuda.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    print(f"  cqt_fused: {os.path.relpath(path)} " + " | ".join(regs))

    kernel_phase(torch, cqt_cuda, CQTConfig, CQTFrontend)
    serving = serving_phase(torch, cqt_cuda, RECIPES, Transcriber, frame_track)
    main_row = main_path_kernel_row(
        torch, cqt_cuda, CQTFrontend(RECIPES["native-best"]().cqt), 2048
    )
    resnet18_phase(torch, cqt_cuda, cli)

    kernels = [{
        "name": "cqt_fused",
        "route": "cuda",
        "source": "guitar_tablature_classification_tpu_torch/csrc/cqt.cu",
        "replaces": "guitar_tablature_classification_tpu/ops/cqt_pallas.py:594",
        "launches": serving["launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
