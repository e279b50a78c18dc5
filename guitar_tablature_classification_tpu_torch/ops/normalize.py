"""Normalization ops (the JAX package's ``ops/normalize.py``).

- ``db_to_unit``: (x + 120) / 120 with clip — ViT_dataloader.py:31-32.
- ``imagenet_normalize``: torchvision ImageNet mean/std, channels last —
  my_dataloader.py:21-30.
- ``min_max_normalize`` / ``z_score_normalize``: ViT_engine.py:96-110, with
  whole-batch statistics (the reference's ``batch.min()`` etc.).
- ``tile_channels``: the 1 -> 3 channel repeat of ViT_dataloader.py:50-51.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def db_to_unit(x: torch.Tensor, ref_db: float = -120.0) -> torch.Tensor:
    """Map dB in [ref_db, 0] to [0, 1], clipped."""
    return torch.clamp((x - ref_db) / (-ref_db), 0.0, 1.0)


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    """x: [..., 3] in [0, 1] (channels last)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def min_max_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(x - min) / (max - min) over the whole tensor; x as it is where the
    span is at most ``eps``."""
    lo, hi = x.min(), x.max()
    span = hi - lo
    return torch.where(span > eps, (x - lo) / torch.clamp(span, min=eps), x)


def z_score_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(x - mean) / std over the whole tensor (population std); only
    ``x - mean`` where the std is at most ``eps``."""
    mean = x.mean()
    std = torch.sqrt(torch.mean((x - mean) ** 2))  # jnp.std's two passes
    return torch.where(std > eps, (x - mean) / torch.clamp(std, min=eps), x - mean)


def tile_channels(x: torch.Tensor, channels: int = 3) -> torch.Tensor:
    """[..., H, W] -> [..., H, W, C] by channel repeat (channels last)."""
    return x[..., None].expand(*x.shape, channels)
