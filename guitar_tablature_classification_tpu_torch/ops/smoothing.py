"""Temporal smoothing of per-window fret predictions (the JAX package's
``ops/smoothing.py``).

Vectorized mode filter equivalent to the reference's
(``tablature_generator.py:695-737``): for each string, each window's fret
becomes the most common value in a +/- (window//2) neighbourhood; ties
resolve to the smallest fret.  The reference scans in place (later windows
see already-smoothed neighbours); :func:`mode_filter` is the standard
non-sequential filter, as in the JAX package, and
:func:`mode_filter_sequential` the reference's in-place scan, for parity
checks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def mode_filter(
    preds: torch.Tensor, window: int = 3, num_classes: int = 19
) -> torch.Tensor:
    """preds: [T, S] int frets -> mode-smoothed [T, S] on preds' device."""
    t = preds.shape[0]
    if t <= window:  # reference returns raw in this case (:707)
        return preds.clone()
    half = window // 2
    one_hot = F.one_hot(preds.long(), num_classes).to(torch.float32)  # [T,S,C]
    padded = F.pad(one_hot, (0, 0, 0, 0, half, half))
    votes = sum(padded[i : i + t] for i in range(2 * half + 1))
    # torch.argmax returns the first maximal index: the smallest fret
    return torch.argmax(votes, dim=-1).to(preds.dtype)


def mode_filter_np(
    preds: np.ndarray, window: int = 3, num_classes: int = 19
) -> np.ndarray:
    """NumPy twin of :func:`mode_filter` (same output)."""
    preds = np.asarray(preds)
    t = preds.shape[0]
    if t <= window:
        return preds.copy()
    half = window // 2
    one_hot = np.eye(num_classes, dtype=np.float32)[preds]  # [T, S, C]
    padded = np.pad(one_hot, ((half, half), (0, 0), (0, 0)))
    votes = sum(padded[i : i + t] for i in range(2 * half + 1))
    return np.argmax(votes, axis=-1).astype(preds.dtype)


def mode_filter_sequential(preds: np.ndarray, window: int = 3) -> np.ndarray:
    """Bit-faithful NumPy port of post_process_tablature
    (tablature_generator.py:695-737), including its in-place scan."""
    preds = np.asarray(preds)
    t = preds.shape[0]
    if t <= window:
        return preds.copy()
    out = preds.copy()
    half = window // 2
    for s in range(out.shape[1]):
        col = out[:, s]
        for j in range(t):
            lo, hi = max(0, j - half), min(t, j + half + 1)
            values, counts = np.unique(col[lo:hi], return_counts=True)
            col[j] = values[np.argmax(counts)]
    return out
