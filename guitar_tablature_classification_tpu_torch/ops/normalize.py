"""Normalization ops (the JAX package's ``ops/normalize.py``).

- ``db_to_unit``: (x + 120) / 120 with clip — ViT_dataloader.py:31-32.
- ``imagenet_normalize``: torchvision ImageNet mean/std, channels last —
  my_dataloader.py:21-30.
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


def tile_channels(x: torch.Tensor, channels: int = 3) -> torch.Tensor:
    """[..., H, W] -> [..., H, W, C] by channel repeat (channels last)."""
    return x[..., None].expand(*x.shape, channels)
