"""Spectrogram augmentations, batched, drawn from an explicit generator
(the JAX package's ``ops/augment.py``).

The same four transforms as the reference suite (ViT_engine.py:28-93) and
the JAX package: a time shift with zero fill, Gaussian noise, and
SpecAugment-style frequency and time masks; and the same gate: each
sample is augmented with probability ``augment_prob`` by 1-3 distinct
transforms in a random order.  Every draw comes from the ``generator``
passed in (the train step's), so a seed fixes the augmentation; the
stream differs from the JAX package's ``jax.random`` one, so the two agree
in distribution, not bit for bit.

Inputs are [B, F, T] (bins x frames).  Each transform is computed for the
whole batch at once, and a per-sample select keeps the chosen ones.
"""

from __future__ import annotations

import torch


def time_shift(
    x: torch.Tensor, u: torch.Tensor, shift_range: float = 0.1
) -> torch.Tensor:
    """Shift each sample along the frame axis by ``trunc(s * T)`` frames,
    ``s = (2u - 1) * shift_range`` (``u`` [B] uniform in [0, 1)), zero
    filled (ViT_engine.py:28-42); a positive shift takes later frames."""
    t = x.shape[-1]
    shift = (((2.0 * u - 1.0) * shift_range) * t).to(torch.int64)  # toward zero
    idx = torch.arange(t, device=x.device) + shift[:, None]  # [B, T]
    valid = (idx >= 0) & (idx < t)
    gathered = torch.gather(
        x, -1, idx.clamp(0, t - 1)[:, None, :].expand(-1, x.shape[1], -1)
    )
    return torch.where(valid[:, None, :], gathered, torch.zeros((), dtype=x.dtype, device=x.device))


def add_noise(x: torch.Tensor, noise: torch.Tensor, noise_level: float = 0.005) -> torch.Tensor:
    """Gaussian noise, sigma 0.005 (ViT_engine.py:44-47); ``noise`` is
    standard normal of x's shape."""
    return x + noise_level * noise


def _span_keep(size: int, max_width: int, u_width, u_start, device) -> torch.Tensor:
    """[B, size] keep-mask with one zero span a sample, of width uniform in
    1..min(max_width, size) at a start uniform in 0..size - width."""
    top = min(max_width, size)
    width = 1 + (u_width * top).to(torch.int64).clamp(max=top - 1)
    start = (u_start * (size - width + 1)).to(torch.int64)
    start = torch.minimum(start, size - width)
    pos = torch.arange(size, device=device)
    return ~((pos >= start[:, None]) & (pos < (start + width)[:, None]))


def frequency_mask(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Zero a span of CQT bins (ViT_engine.py:49-63); ``keep`` [B, F]."""
    return x * keep[:, :, None]


def time_mask(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Zero a span of frames (ViT_engine.py:65-79); ``keep`` [B, T]."""
    return x * keep[:, None, :]


def augment_batch(
    generator: torch.Generator, batch: torch.Tensor, augment_prob: float = 0.5,
    *, freq_max_width: int = 5, time_max_width: int = 10,
) -> torch.Tensor:
    """batch: [B, F, T] float spectrograms -> augmented [B, F, T], on the
    batch's device (``generator`` must live there).  Per sample: a gate
    (probability ``augment_prob``), a count of 1-3 transforms
    (ViT_engine.py:87), a random order of the four, and each transform's
    own draws."""
    b, f, t = batch.shape
    dev = batch.device
    gate = torch.rand(b, generator=generator, device=dev) < augment_prob
    num = 1 + (torch.rand(b, generator=generator, device=dev) * 3).to(torch.int64).clamp(max=2)
    order = torch.argsort(torch.rand(b, 4, generator=generator, device=dev), dim=1)  # a permutation a sample
    u = torch.rand(b, 5, generator=generator, device=dev)
    noise = torch.randn(batch.shape, generator=generator, device=dev, dtype=batch.dtype)
    keep_f = _span_keep(f, freq_max_width, u[:, 1], u[:, 2], dev)
    keep_t = _span_keep(t, time_max_width, u[:, 3], u[:, 4], dev)
    transforms = (
        lambda v: time_shift(v, u[:, 0]),
        lambda v: add_noise(v, noise),
        lambda v: frequency_mask(v, keep_f),
        lambda v: time_mask(v, keep_t),
    )
    v = batch
    for slot in range(3):  # the transforms compose, slot by slot
        active = (slot < num) & gate
        chosen = order[:, slot]
        out = v
        for k, transform in enumerate(transforms):
            pick = (active & (chosen == k))[:, None, None]
            out = torch.where(pick, transform(v), out)
        v = out
    return v
