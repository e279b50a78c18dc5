"""The yardstick's arithmetic: the card's peaks and the least time a
kernel's shapes allow (its roofline bound).

Peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W), as
``chip_smoke.py`` states them.  A bound is the larger of the operations
over their type's peak and the bytes (each input read once, each output
written once) over the memory bandwidth; the byte and operation counts of
the stem tail and the attention kernels are ``chip_smoke.py``'s
(``stem_kernel_phase``, ``attention_kernel_phase``), frozen here; the
CQT's (B1) are worked out from the reference's filterbank as
``chip_smoke.py``'s ``cqt_phase`` counts them.

A model's nominal operations are its configuration's (``nominal`` in
``configs/<config>.json``), which ``tests/test_bench_counts.py`` works out
by hand.
"""

from __future__ import annotations

import numpy as np

from .reference.cqt import filterbank, window_samples

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}


def bound_s(nbytes: float, ops: float, peak: str) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[peak])


# ------------------------------------------------------------- stem tail


def stem_shapes(batch: int, h2: int = 56, channels: int = 64) -> tuple[int, int]:
    """(elements of conv1's output in the tail's quadrant layout, elements
    of the pooled output) of the 224^2 stem at ``batch``."""
    return batch * 4 * h2 * h2 * channels, batch * h2 * h2 * channels


def stem_bound_s(kernel: str, batch: int, el: int = 2, channels: int = 64) -> float:
    """Bound of ``stem_stats``, ``stem_fwd`` or ``stem_bwd`` (B2) at
    ``batch``, ``el`` bytes an element (bf16: 2)."""
    n_y, n_pool = stem_shapes(batch, channels=channels)
    c = channels
    nbytes = {"stem_stats": el * n_y + 8 * c,
              "stem_fwd": el * (n_y + n_pool) + 8 * c,
              "stem_bwd": el * (2 * n_y + n_pool) + 16 * c}[kernel]
    ops = {"stem_stats": 3 * n_y,
           "stem_fwd": 3 * n_y + 8 * n_pool,
           "stem_bwd": 7 * n_y + 17 * n_pool}[kernel]
    return bound_s(nbytes, ops, "fp32")


# ------------------------------------------------------------- attention


def attention_bound_s(kernel: str, batch: int, tokens: int, heads: int,
                      head_dim: int = 64, el: int = 2) -> float:
    """Bound of ``attn_fwd`` or ``attn_bwd`` (B5) on [batch, tokens, heads,
    head_dim] bf16 q, k, v."""
    elems = batch * tokens * heads * head_dim
    lse = 4 * batch * heads * tokens
    sq = batch * heads * tokens * tokens * head_dim
    if kernel == "attn_fwd":
        return bound_s(4 * el * elems + lse, 4 * sq, "bf16")
    return bound_s(8 * el * elems + lse, 10 * sq, "bf16")


# ------------------------------------------------------------------- CQT


def cqt_counts(cqt: dict) -> tuple[int, int]:
    """(multiply-adds, filter values) that one window of the fused CQT
    needs, re and im, under zero padding: per bin and frame, the nonzero
    filter rows that meet a sample of the window; per bin, the rows of its
    nonzero span that meet one in some frame."""
    if cqt["pad_mode"] != "constant":
        raise ValueError("the CQT's counts are for zero padding only")
    kernels = filterbank(cqt)
    n_bins, n, hop = cqt["n_bins"], window_samples(cqt), cqt["hop_length"]
    nonzero = (kernels[:, :n_bins] != 0) | (kernels[:, n_bins:] != 0)  # [width, bins]
    lo = np.argmax(nonzero, axis=0)
    hi = nonzero.shape[0] - np.argmax(nonzero[::-1], axis=0)
    frames = 1 + n // hop
    pad = kernels.shape[0] // 2
    starts = pad - np.arange(frames) * hop  # filter row of each frame's first sample
    a = np.maximum(lo[:, None], starts[None, :])
    b = np.minimum(hi[:, None], starts[None, :] + n)
    macs = 2 * int(np.maximum(b - a, 0).sum())
    lo_f = np.maximum(lo, pad - (frames - 1) * hop)
    hi_f = np.minimum(hi, pad + n)
    return macs, 2 * int(np.maximum(hi_f - lo_f, 0).sum())


def cqt_bound_s(batch: int, cqt: dict) -> float:
    """Bound of one call of the fused CQT (B1) at the ``default`` tier on
    ``batch`` windows: one bf16 tensor-core pass of the products, and the
    audio read (fp32), each filter value the windows need read once (bf16)
    and the dB features written (fp32)."""
    if cqt["precision"] != "default":
        raise ValueError(f"the CQT's bound is the default tier's, not {cqt['precision']!r}")
    macs, values = cqt_counts(cqt)
    frames = 1 + window_samples(cqt) // cqt["hop_length"]
    nbytes = 4 * batch * window_samples(cqt) + 2 * values + 4 * batch * cqt["n_bins"] * frames
    return bound_s(nbytes, 2 * macs * batch, "bf16")
