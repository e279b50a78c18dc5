"""Bicubic resize as two matmuls (the JAX package's ``ops/resize.py``).

The interpolation matrices are built in NumPy; a resize is then
``R_h @ x @ R_w^T``, run as two fp32 ``torch.matmul``s (TF32 off on the
card).  ``a=-0.75`` reproduces torch's bicubic kernel (align_corners=False,
edge-clamped taps); for the 96x9 -> 224x224 upscale no antialias filter is
involved.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .cqt import fp32_matmul


def _cubic_kernel(x: np.ndarray, a: float) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0,
        np.where(
            ax < 2.0,
            a * ax**3 - 5.0 * a * ax**2 + 8.0 * a * ax - 4.0 * a,
            0.0,
        ),
    )


@functools.lru_cache(maxsize=64)
def resize_matrix(in_size: int, out_size: int, a: float = -0.75) -> np.ndarray:
    """[out_size, in_size] bicubic interpolation matrix
    (align_corners=False source-center mapping, edge-clamped taps)."""
    scale = in_size / out_size
    out = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        base = int(np.floor(src))
        taps = np.arange(base - 1, base + 3)
        w = _cubic_kernel(src - taps, a)
        w = w / w.sum()
        np.add.at(out[i], np.clip(taps, 0, in_size - 1), w)
    return out.astype(np.float32)


def resize_bicubic(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bicubic-resize the last two dims of x ([..., H, W])."""
    rh = torch.from_numpy(resize_matrix(x.shape[-2], out_hw[0])).to(x.device)
    rw = torch.from_numpy(resize_matrix(x.shape[-1], out_hw[1])).to(x.device)
    with fp32_matmul():
        return torch.matmul(torch.matmul(rh, x), rw.T)
