"""3x3 "same" convolution with a fused ReLU-affine on its input, NHWC.

The counterpart of the JAX repo's TPU probe kernel
``tools/probe_pallas_conv.py::pallas_conv3x3`` (a tool, not part of the JAX
package; the port keeps it under ``ops/`` beside its other kernels)::

    t   = relu(x*s + o)          bf16, rounded as JAX rounds it (below)
    out = conv3x3(t, w9)         zero padding of one pixel, fp32 sums,
                                 one rounding to bf16

with x [B, H, W, C] bf16, w9 [9, C, F] bf16 (tap ``dy*3 + dx``) and s, o
[C] bf16.  The affine rounds twice, ``bf16(bf16(x*s) + o)``: that is what a
jitted bf16 ``x*s + o`` gives on the JAX CPU backend (the Pallas kernel's
interpret mode), element for element.  The padding is zero after the ReLU.

:func:`conv3x3_plain` is the plain PyTorch version; :func:`conv3x3_affine_relu`
dispatches: a CPU tensor to the plain version, a CUDA tensor to the
hand-written kernel (:mod:`.conv3x3_cuda`, ``csrc/conv3x3.cu``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import on_card
from . import conv3x3_cuda
from .cqt import fp32_matmul

VARIANTS = ("sum9", "concat")


def affine_relu(x: torch.Tensor, s: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """relu(bf16(bf16(x*s) + o)) in bf16; the product and the sum each run
    in fp32 and round once to bf16, as ``csrc/conv3x3.cu`` computes them."""
    xs = (x.float() * s.float()).to(torch.bfloat16)
    z = (xs.float() + o.float()).to(torch.bfloat16)
    return torch.maximum(z, torch.zeros_like(z))


def conv3x3_plain(
    x: torch.Tensor, w9: torch.Tensor, s: torch.Tensor, o: torch.Tensor
) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W, F] bf16: nine fp32 tap products of the
    padded ``affine_relu(x)`` with ``w9``, added in tap order, rounded once."""
    b, h, w, c = x.shape
    t = F.pad(affine_relu(x, s, o).float(), (0, 0, 1, 1, 1, 1))  # [B, H+2, W+2, C]
    wf = w9.float()
    acc = None
    with fp32_matmul():
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            term = t[:, dy:dy + h, dx:dx + w, :] @ wf[tap]
            acc = term if acc is None else acc + term
    return acc.to(torch.bfloat16)


def conv3x3_affine_relu(
    x: torch.Tensor,
    w9: torch.Tensor,
    s: torch.Tensor,
    o: torch.Tensor,
    *,
    variant: str = "sum9",
    row_chunk: int | None = None,
    bt: int | None = None,
) -> torch.Tensor:
    """``conv3x3(relu(x*s + o), w9)``, NHWC bf16, with the probe's
    signature.  ``variant`` ("sum9": nine depth-C products; "concat": one
    product over 9*C patches), ``row_chunk`` and ``bt`` are the TPU kernel's
    formulations and tiling of the same function: they are checked and map
    to the one kernel (and the one plain version) here.  A ``bt`` that does
    not divide B raises, where the TPU grid ``B // bt`` would leave the last
    samples unwritten."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if x.ndim != 4 or w9.ndim != 3 or w9.shape[:2] != (9, x.shape[-1]):
        raise ValueError(
            f"expected x [B, H, W, C] and w9 [9, C, F], got {tuple(x.shape)} "
            f"and {tuple(w9.shape)}"
        )
    s, o = s.reshape(-1), o.reshape(-1)  # the probe passes [1, C] too
    if bt is not None and x.shape[0] % bt:
        raise ValueError(f"batch {x.shape[0]} not divisible by bt={bt}")
    if row_chunk is not None and x.shape[1] % row_chunk:
        raise ValueError(f"height {x.shape[1]} not divisible by row_chunk={row_chunk}")
    if on_card(x):
        return conv3x3_cuda.conv3x3(x, w9, s, o)
    return conv3x3_plain(x, w9, s, o)
