"""Sliding-window framing of full tracks into fixed analysis windows
(the JAX package's ``ops/framing.py``).

Segmentation semantics of reference ``cqt.py:26-49``: window
``window_seconds`` (0.2 s), hop ``hop_seconds`` (0.1 s), and only complete
windows are kept ("Drop segments smaller than 0.2s").
"""

from __future__ import annotations

import numpy as np

from ..config import CQTConfig


def num_windows(num_samples: int, window_samples: int, hop_samples: int) -> int:
    """Count of complete windows (cqt.py:30)."""
    if num_samples < window_samples:
        return 0
    return (num_samples - window_samples) // hop_samples + 1


def window_starts(
    num_samples: int, window_samples: int, hop_samples: int
) -> np.ndarray:
    n = num_windows(num_samples, window_samples, hop_samples)
    return np.arange(n, dtype=np.int64) * hop_samples


def frame_track(x, cfg: CQTConfig | None = None, *, hop_samples: int | None = None):
    """Frame a 1-D NumPy track into [num_windows, window_samples]: a
    read-only strided view (zero-copy)."""
    cfg = cfg or CQTConfig()
    w = cfg.window_samples
    h = hop_samples if hop_samples is not None else cfg.hop_samples
    n = num_windows(x.shape[-1], w, h)
    if n == 0:
        raise ValueError(f"track of {x.shape[-1]} samples shorter than window {w}")
    stride = x.strides[-1]
    return np.lib.stride_tricks.as_strided(
        x, shape=(n, w), strides=(h * stride, stride), writeable=False
    )


def window_times(
    num_samples: int, cfg: CQTConfig | None = None, *, hop_samples: int | None = None
) -> np.ndarray:
    """Start time (seconds) of each complete window."""
    cfg = cfg or CQTConfig()
    h = hop_samples if hop_samples is not None else cfg.hop_samples
    starts = window_starts(num_samples, cfg.window_samples, h)
    return starts / float(cfg.sample_rate)
