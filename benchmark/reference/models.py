"""The reference's models in plain float32, each with the reference
checkpoints' key layout, so one state dict loads into the port and here
alike.

A configuration's ``model["arch"]`` names its model's file here,
``arch_<arch>.py``, whose ``build(model)`` returns it; a new architecture
is a new file.  A model gives ``inputs(db)`` (the CQT's [B, F, T] dB
features -> its NCHW input), ``run(x, *, train, generator, prec)`` ->
[B, strings, frets] logits and, to be trained, ``logit_weights()`` (the
names of the weights of the layers that give the logits).

Train mode normalizes by the batch's statistics (biased variance), eval
mode by the running ones.  Dropout keeps a value where a uniform draw from
the step's generator is under 1 - p and scales it by 1 / (1 - p); the
draws are made in the order the layers run, one tensor per dropout.
"""

from __future__ import annotations

import importlib

import torch
import torch.nn.functional as F
from torch import nn

from .precision import Precision


def batch_norm(x: torch.Tensor, m: nn.modules.batchnorm._BatchNorm, train: bool) -> torch.Tensor:
    if train:
        return F.batch_norm(x, None, None, m.weight, m.bias, True, 0.0, m.eps)
    return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias, False, 0.0, m.eps)


def dropout(x: torch.Tensor, p: float, generator: torch.Generator | None) -> torch.Tensor:
    if generator is None or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def conv(x, m: nn.Conv2d, prec: Precision):
    return F.conv2d(prec(x), prec(m.weight), m.bias, m.stride, m.padding)


def linear(x, m: nn.Linear, prec: Precision):
    return F.linear(prec(x), prec(m.weight), m.bias)


def build(model: dict) -> nn.Module:
    """The reference model of a configuration's ``model`` group (fp32, on
    the meta device until weights are loaded with ``assign=True``), from
    ``arch_<arch>.py``."""
    arch = model["arch"]
    try:
        module = importlib.import_module(f".arch_{arch}", __package__)
    except ModuleNotFoundError as e:
        if e.name != f"{__package__}.arch_{arch}":
            raise
        raise ValueError(f"the reference has no model for arch {arch!r} "
                         f"(no benchmark/reference/arch_{arch}.py)") from None
    return module.build(model)
