"""The port's bench: the root ``bench.py``'s rows, on the card.

    python -m guitar_tablature_classification_tpu_torch.bench

Rows (``bench.py:65-273`` of the JAX package's root):

- the flagship train step: ``resnet18`` + ``stem_fusion="fused"`` (the
  quadrant conv1 GEMM and the stem-tail kernels of ``csrc/stem.cu``), bf16,
  with the CQT (``csrc/cqt.cu``) and preprocessing inside the step, B=256,
  4 rotating batches of seeded audio;
- the ``resnet18_native`` train step (the raw 96x9 CQT, no upsample) at
  B=4096 with the CQT at ``highest`` and at ``default``, and at B=8192 at
  ``default``: one batch fed as ``audio + prev_loss * 1e-24`` (a numerical
  no-op that makes each step's input depend on the step before);
- ``resnet18_native`` serving (forward only, ``default`` CQT) at B=4096 on
  2 rotating batches, each batch's argmax summed on the device.

Each row runs ``steps`` steps as a warm-up, then ``steps`` timed ones:
CUDA events around the timed run give the step time, and the host's
clock around the enqueueing loop gives ``host_enqueue_ms`` beside it (a
step whose enqueue time is close to its step time is host-bound).  Each
row also reports the kernel launches of its timed run, by the wrappers'
counters.  Prints ONE JSON line with the root bench's keys
(``metric``, ``value``, ``unit``, ``vs_baseline``, ``detail``).  A failing
row fails the run.  ``run_bench(batch=2, native_batch=2, steps=1,
device="cpu")`` runs the same rows on the CPU through the kernels' plain
versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .config import CQTConfig, ModelConfig, OptimConfig
from .device import resolve_device
from .models.tabnet import build_model
from .ops.cqt import CQTFrontend
from .train.engine import create_train_state, make_preprocess, make_train_step

# The reference-style single-core CPU pipeline (librosa CQT proxy + torch
# ResNet18 train step at batch 32), as the root bench.py states it and
# tools/measure_cpu_baseline.py measures it.
REFERENCE_CPU_SEGMENTS_PER_SEC = 4.4

BATCH = 256
NATIVE_BATCH = 4096
TIMED_STEPS = 20
LR = 5e-4


def launch_counts() -> dict[str, int]:
    """The kernel wrappers' launch counters that the bench's paths move: the
    fused CQT's (all, and those on the tensor cores) and the 224^2 stem
    tail's."""
    from .ops import cqt_cuda, stem_cuda

    return {"cqt_fused": cqt_cuda.launches, "cqt_fused_mma": cqt_cuda.mma_launches,
            **stem_cuda.launches}


def _launches_since(before: dict[str, int]) -> dict[str, int]:
    return {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}


def _timed(run, steps: int, dev: torch.device):
    """Enqueue ``run(i)`` for i < ``steps`` (after a warm-up of the same
    length); returns (device ms a step, host enqueue ms a step, the last
    result, the launches of the timed run)."""
    for i in range(steps):
        run(i)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    before = launch_counts()
    t_host = time.perf_counter()
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    for i in range(steps):
        last = run(i)
    enqueue_ms = 1e3 * (time.perf_counter() - t_host) / steps
    if dev.type == "cuda":
        end.record()
        torch.cuda.synchronize(dev)
        step_ms = start.elapsed_time(end) / steps
    else:
        step_ms = 1e3 * (time.perf_counter() - t_host) / steps
    return step_ms, enqueue_ms, last, _launches_since(before)


def _train_setup(model_cfg: ModelConfig, cqt_cfg: CQTConfig, dev: torch.device):
    frontend = CQTFrontend(cqt_cfg)
    model = build_model(model_cfg, generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, OptimConfig(), dev)
    train_step = make_train_step(
        model, make_preprocess(model_cfg), smoothing=0.05, frontend=frontend
    )
    return state, train_step, torch.Generator(device=dev).manual_seed(0)


def _host_audio(rng: np.random.Generator, shape, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)


def measure_flagship(
    batch: int = BATCH, steps: int = TIMED_STEPS, device=None
) -> dict:
    """The headline row: the fused flagship's train step on 4 rotating
    batches (``bench.py:205-236``)."""
    dev = resolve_device(device)
    cqt_cfg = CQTConfig()
    model_cfg = ModelConfig(arch="resnet18", stem_fusion="fused")
    state, train_step, gen = _train_setup(model_cfg, cqt_cfg, dev)
    rng = np.random.default_rng(0)
    audio = _host_audio(rng, (4, batch, cqt_cfg.window_samples), dev)
    labels = torch.from_numpy(rng.integers(0, 19, (4, batch, 6)).astype(np.int32)).to(dev)

    def run(i):
        return train_step(state, {"audio": audio[i % 4], "labels": labels[i % 4]}, gen, LR)["loss"]

    step_ms, enqueue_ms, loss, launches = _timed(run, steps, dev)
    return {
        "value": 1e3 * batch / step_ms,
        "step_ms": step_ms,
        "host_enqueue_ms": enqueue_ms,
        "batch": batch,
        "timed_steps": steps,
        "final_loss": float(loss),
        "model": "resnet18+string_heads bf16, 224x224, fused stem",
        "cqt_precision": cqt_cfg.precision,
        "launches": launches,
    }


def measure_native_variant(
    precision: str = "highest", batch: int = NATIVE_BATCH, steps: int = TIMED_STEPS,
    device=None,
) -> dict:
    """The ``resnet18_native`` train step (``bench.py:78-153``), one batch
    fed as ``audio + prev_loss * 1e-24``."""
    dev = resolve_device(device)
    cqt_cfg = dataclasses.replace(CQTConfig(), precision=precision)
    state, train_step, gen = _train_setup(ModelConfig(arch="resnet18_native"), cqt_cfg, dev)
    rng = np.random.default_rng(1)
    audio = _host_audio(rng, (batch, cqt_cfg.window_samples), dev)
    labels = torch.from_numpy(rng.integers(0, 19, (batch, 6)).astype(np.int32)).to(dev)
    carry = {"eps": torch.zeros((), device=dev)}

    def run(i):
        loss = train_step(state, {"audio": audio + carry["eps"], "labels": labels}, gen, LR)["loss"]
        carry["eps"] = loss * 1e-24
        return loss

    step_ms, enqueue_ms, loss, launches = _timed(run, steps, dev)
    return {
        "value": 1e3 * batch / step_ms,
        "step_ms": step_ms,
        "host_enqueue_ms": enqueue_ms,
        "batch": batch,
        "final_loss": float(loss),
        "model": "resnet18_native+string_heads bf16, 96x9 (no upsample)",
        "cqt_precision": precision,
        "launches": launches,
    }


def measure_native_serving(
    precision: str = "default", batch: int = NATIVE_BATCH, steps: int = TIMED_STEPS,
    device=None,
) -> dict:
    """``resnet18_native`` serving (``bench.py:156-200``): the forward of
    the CQT, preprocessing and model on 2 rotating batches, each batch's
    argmax summed on the device."""
    dev = resolve_device(device)
    cqt_cfg = dataclasses.replace(CQTConfig(), precision=precision)
    model_cfg = ModelConfig(arch="resnet18_native")
    frontend = CQTFrontend(cqt_cfg)
    model = build_model(model_cfg, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    preprocess = make_preprocess(model_cfg)
    audio = _host_audio(np.random.default_rng(2), (2, batch, cqt_cfg.window_samples), dev)
    acc = torch.zeros((), dtype=torch.int64, device=dev)  # each batch's result is used

    @torch.inference_mode()
    def run(i):
        logits = model(preprocess(frontend(audio[i % 2])))
        acc.add_(logits.argmax(-1).sum())

    batch_ms, enqueue_ms, _, launches = _timed(run, steps, dev)
    return {
        "value": 1e3 * batch / batch_ms,
        "batch_ms": batch_ms,
        "host_enqueue_ms": enqueue_ms,
        "batch": batch,
        "cqt_precision": precision,
        "launches": launches,
    }


def run_bench(
    *, batch: int = BATCH, native_batch: int = NATIVE_BATCH, steps: int = TIMED_STEPS,
    device=None,
) -> dict:
    """Every row, in the root bench's order; the one JSON object."""
    dev = resolve_device(device)
    flagship = measure_flagship(batch, steps, dev)
    detail = {
        "baseline": (
            "modeled single-core CPU proxy (4.4 seg/s) of the reference-style "
            "pipeline: see tools/measure_cpu_baseline.py"
        ),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "batch": batch,
        "timed_steps": steps,
        "step_ms": flagship["step_ms"],
        "host_enqueue_ms": flagship["host_enqueue_ms"],
        "final_loss": flagship["final_loss"],
        "model": flagship["model"],
        "includes": "on-device CQT + preprocess + fwd/bwd/update",
        "launches": flagship["launches"],
        "native_variant": measure_native_variant("highest", native_batch, steps, dev),
        "native_variant_default_tier": measure_native_variant(
            "default", native_batch, steps, dev),
        "native_variant_default_tier_b8192": measure_native_variant(
            "default", 2 * native_batch, steps, dev),
        "native_serving_default_tier": measure_native_serving(
            "default", native_batch, steps, dev),
    }
    return {
        "metric": "GuitarSet segments/sec/chip (CQT->CNN train)",
        "value": flagship["value"],
        "unit": "segments/sec",
        "vs_baseline": flagship["value"] / REFERENCE_CPU_SEGMENTS_PER_SEC,
        "detail": detail,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tab-bench", description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)
    print(json.dumps(run_bench(device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
