"""The fused Adam / AdamW update kernel for Hopper (``csrc/adam.cu``): build
and wrapper.

It replaces no TPU kernel (the JAX package leaves the update to optax and
XLA): on the card it does, in one launch over the flat fp32 buffers, what
:meth:`..train.engine.Optimizer.apply_plain` does as a chain of PyTorch
elementwise operations, with the same bits.  ``csrc/adam.cu`` explains the
design and the bound.  :meth:`..train.engine.Optimizer.apply` calls
:func:`update` for buffers on the card and the plain chain for buffers on
the CPU.

The source is built with ``nvcc`` on first use (:mod:`.nvcc`) and loaded
through ``ctypes``; nothing is compiled or loaded when this module is
imported.  ``launches`` counts the kernel's launches, and each launch also
counts ``train.update_kernel`` on the program's recorder
(:mod:`..utils.profiling`).
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from ..utils import profiling
from . import nvcc

SOURCE = os.path.join(nvcc.CSRC_DIR, "adam.cu")
NVCC_FLAGS = nvcc.BASE_FLAGS + ("-fmad=false",)
THREADS = 256  # csrc/adam.cu kThreads
CTAS_PER_SM = 4  # csrc/adam.cu kCtasPerSm: persistent CTAs walk the buffer
UNROLL = 2  # csrc/adam.cu kUnroll: 16-byte vectors of each buffer in flight a thread
VEC = 4  # fp32 elements of a 16-byte vector
DECAY = {None: 0, "adam": 1, "adamw": 2}  # csrc/adam.cu kNoDecay, kCoupled, kDecoupled

launches = {"adam_update": 0}
_lib = None


def build() -> tuple[str, str]:
    """Compile ``csrc/adam.cu`` unless this source is built already.
    Returns the library path and the compiler's ``-Xptxas -v`` log."""
    return nvcc.build(SOURCE, NVCC_FLAGS)


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.adam_update_launch.argtypes = [p] * 9 + [ll] * 3 + [i] * 3 + [f] * 9 + [p]
        lib.adam_update_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


class Plan(NamedTuple):
    """How the kernel walks n elements: ``vec`` elements a vector (4, or 1
    where the buffers' alignments differ), vectors from element ``head`` on
    (``nvec`` of them), the head and the tail singly."""

    vec: int
    head: int
    nvec: int


def plan(n: int, addresses: list[int], mask_address: int | None = None) -> Plan:
    """The walk of ``n`` elements of fp32 buffers at byte ``addresses`` (and
    of a bool mask at ``mask_address``): 16-byte vectors from the first
    element at which every buffer is 16-byte aligned, or single elements
    where no such element exists."""
    phase = addresses[0] % 16
    head = (16 - phase) % 16 // 4
    if any(a % 16 != phase for a in addresses) or (
            mask_address is not None and (mask_address + head) % VEC):
        return Plan(1, 0, n)
    head = min(n, head)
    return Plan(VEC, head, (n - head) // VEC)


def grid(p: Plan, n: int, sms: int) -> int:
    """CTAs of a launch: CTAS_PER_SM an SM, fewer where the work is small."""
    work = max(p.nvec, n - p.vec * p.nvec)
    return max(1, min(sms * CTAS_PER_SM, -(-work // (THREADS * UNROLL))))


def scalars(*, lr: float, betas: tuple[float, float], eps: float, weight_decay: float,
            max_norm: float, backbone_scale: float) -> list[float]:
    """The Python constants as the plain chain hands them to PyTorch: each
    computed in double as its expression there, then rounded to fp32 once
    (ctypes' ``c_float``, as PyTorch casts a Python scalar)."""
    b1, b2 = betas
    consts = [max_norm, 1 - b1, b1, 1 - b2, b2, eps, weight_decay, -1.0 * lr, backbone_scale]
    return [ctypes.c_float(float(c)).value for c in consts]


def _check(t: torch.Tensor, name: str, device: torch.device, dtype: torch.dtype,
           numel: int) -> None:
    if t.device != device:
        raise ValueError(f"{name} must lie on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.numel() != numel:
        raise ValueError(f"{name} must hold {numel} elements, got {t.numel()}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def update(grads: torch.Tensor, params: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, *,
           lr: float, betas: tuple[float, float], eps: float, bias1: torch.Tensor,
           bias2: torch.Tensor, decay: str | None, weight_decay: float,
           g_norm: torch.Tensor | None, max_norm: float,
           backbone: torch.Tensor | None, backbone_scale: float,
           ok: torch.Tensor | None) -> None:
    """One Adam step of ``params``, ``mu``, ``nu`` in place (flat fp32 on the
    card) from ``grads``: clip by ``g_norm`` against ``max_norm`` (none
    where ``g_norm`` is None), ``decay`` ``"adam"`` (coupled), ``"adamw"``
    (decoupled) or None, the bias corrections ``bias1`` = 1 - b1^t and
    ``bias2`` (0-dim fp32 on the card), the step scaled by ``backbone_scale``
    where ``backbone`` (bool) is True, nothing where ``ok`` (0-dim bool) is
    False.  One launch; raises where the tensors are not what the kernel
    takes."""
    if params.device.type != "cuda":
        raise ValueError(f"the Adam kernel runs on a CUDA device, got {params.device}")
    dev, n = params.device, params.numel()
    for name, t in (("grads", grads), ("params", params), ("mu", mu), ("nu", nu)):
        _check(t, name, dev, torch.float32, n)
    for name, t in (("bias1", bias1), ("bias2", bias2), ("g_norm", g_norm)):
        if t is not None:
            _check(t, name, dev, torch.float32, 1)
    if ok is not None:
        _check(ok, "ok", dev, torch.bool, 1)
    if backbone is not None:
        _check(backbone, "backbone", dev, torch.bool, n)
    if decay not in DECAY:
        raise ValueError(f"decay must be one of {list(DECAY)}, got {decay!r}")
    walk = plan(n, [t.data_ptr() for t in (grads, params, mu, nu)], _ptr(backbone))
    ctas = grid(walk, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    consts = scalars(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                     max_norm=max_norm, backbone_scale=backbone_scale)
    with torch.cuda.device(dev):
        rc = _library().adam_update_launch(
            grads.data_ptr(), params.data_ptr(), mu.data_ptr(), nu.data_ptr(), _ptr(backbone),
            _ptr(g_norm), bias1.data_ptr(), bias2.data_ptr(), _ptr(ok),
            n, walk.head, walk.nvec, walk.vec, ctas, DECAY[decay if weight_decay else None],
            *consts, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"Adam kernel launch failed: CUDA error {rc}")
    launches["adam_update"] += 1
    profiling.count("train.update_kernel")
