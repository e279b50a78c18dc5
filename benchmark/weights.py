"""Weights from the seed, made on the device in one draw, in the reference
checkpoints' key layout (:func:`.reference.models.build`), so the port and
the reference load the same tensors.

One ``torch.randn`` over all the float entries, then each entry scaled by
its kind: conv and dense kernels by 1/sqrt(fan_in) (LeCun normal, as the
port's own initializer), biases by 0.02, normalization scales 1 + 0.1 n and
shifts 0.1 n, running means 0.1 n and running variances exp(0.2 n) (so that
eval-mode normalizations are not the identity), CLS and position
embeddings by 0.02; ``num_batches_tracked`` counters are 0.
"""

from __future__ import annotations

import torch

from .reference.models import build
from .seeds import derive


def make(model_cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    with torch.device("meta"):
        skeleton = build(model_cfg)
    entries = skeleton.state_dict()
    floats = {k: v for k, v in entries.items() if v.is_floating_point()}
    total = sum(v.numel() for v in floats.values())
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    draw = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, meta in entries.items():
        if not meta.is_floating_point():
            out[name] = torch.zeros(meta.shape, dtype=meta.dtype, device=device)
            continue
        n = draw[offset:offset + meta.numel()].view(meta.shape)
        offset += meta.numel()
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_mean":
            t = 0.1 * n
        elif leaf == "running_var":
            t = torch.exp(0.2 * n)
        elif leaf in ("cls_token", "position_embeddings"):
            t = 0.02 * n
        elif leaf == "weight" and meta.ndim >= 2:
            t = n / meta[0].numel() ** 0.5
        elif leaf == "weight":  # BatchNorm and LayerNorm scales
            t = 1.0 + 0.1 * n
        elif _is_norm(skeleton, name):
            t = 0.1 * n
        else:
            t = 0.02 * n
        out[name] = t.contiguous()
    return out


def _is_norm(model: torch.nn.Module, name: str) -> bool:
    module = model.get_submodule(name.rsplit(".", 1)[0])
    return isinstance(module, (torch.nn.modules.batchnorm._BatchNorm, torch.nn.LayerNorm))
