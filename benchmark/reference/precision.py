"""Arithmetic of the reference's products.

``Precision("fp32")`` leaves operands as they are (float32, TF32 off inside
:func:`fp32_products`).  ``Precision("fp8")`` is the control: every operand
of a backbone product (convolutions, dense layers, attention's two matrix
products, and the CQT's frame product where the configuration states it
in bf16, the ``default`` tier) is rounded to float8 e4m3 with one scale per tensor (its largest
magnitude maps to 448), the step below the configurations' bfloat16.  The
rounding passes gradients straight through, so a training control rounds
its forward and keeps float32 backward products.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


def round_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 at a per-tensor scale, in t's dtype."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


class Precision:
    """The rounding applied to each backbone product's operands."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32 or fp8, got {kind!r}")
        self.kind = kind

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return round_e4m3(t) if self.kind == "fp8" else t


@contextlib.contextmanager
def fp32_products():
    """Float32 matmuls and convolutions on the card: TF32 off in the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
