"""Streaming (chunked) transcription (the JAX package's
``infer/streaming.py``).

Feed audio in chunks of any size (a live input loop, a network stream) and
receive per-window fret predictions as soon as their window completes.
Mode smoothing over a window of W adds W//2 windows of latency: smoothed
frets for window t are emitted once window t + W//2 exists, and
``flush()`` drains the tail.  The ring buffer and the smoothing stay NumPy
on the host; each feed's complete windows go through
:meth:`.transcribe.Transcriber.predict_windows` on the transcriber's device.

Outputs are bit-identical to the offline :meth:`.transcribe.Transcriber.transcribe`
over the same audio.
"""

from __future__ import annotations

import numpy as np

from ..ops.smoothing import mode_filter_np
from .transcribe import Transcriber, Transcription


def _no_frets() -> np.ndarray:
    return np.zeros((0, 6), np.int32)


class StreamingTranscriber:
    """Wraps a :class:`.transcribe.Transcriber` with a sample ring buffer."""

    def __init__(self, transcriber: Transcriber, *, smooth_window: int = 3):
        self.transcriber = transcriber
        self.smooth_window = smooth_window
        cfg = transcriber.cqt_cfg
        self.window = cfg.window_samples
        self.hop = cfg.hop_samples
        self.sample_rate = cfg.sample_rate
        self._buffer = np.zeros(0, dtype=np.float32)
        self._buffer_start = 0  # absolute sample index of buffer[0]
        self._raw_frets: list[np.ndarray] = []  # all raw window predictions
        self._raw_times: list[float] = []
        self._emitted = 0  # windows already returned (smoothed)

    def feed(self, samples: np.ndarray) -> Transcription:
        """Append samples; return the newly available (smoothed) windows."""
        samples = np.asarray(samples, dtype=np.float32).reshape(-1)
        self._buffer = np.concatenate([self._buffer, samples])
        self._predict_ready()
        return self._emit(final=False)

    def flush(self) -> Transcription:
        """Emit everything still held back by the smoothing latency."""
        self._predict_ready()
        return self._emit(final=True)

    def _predict_ready(self) -> None:
        n = self._buffer.shape[0]
        if n < self.window:
            return
        count = (n - self.window) // self.hop + 1
        idx = np.arange(self.window)[None, :] + np.arange(count)[:, None] * self.hop
        logits = self.transcriber.predict_windows(self._buffer[idx])
        frets = np.argmax(logits, axis=-1)
        for i in range(count):
            self._raw_frets.append(frets[i])
            self._raw_times.append((self._buffer_start + i * self.hop) / self.sample_rate)
        consumed = count * self.hop
        self._buffer = self._buffer[consumed:]
        self._buffer_start += consumed

    def _emit(self, *, final: bool) -> Transcription:
        total = len(self._raw_frets)
        w = self.smooth_window
        if total == 0:
            return Transcription(frets=_no_frets(), times=np.zeros(0))
        if not w or w <= 1:
            ready = total
        elif total <= w:
            # the offline passthrough regime (tablature_generator.py:707):
            # hold everything until it is known whether smoothing applies
            ready = total if final else 0
        else:
            # window t's mode over raw[t-w//2 : t+w//2+1] is final once
            # window t + w//2 exists
            ready = total if final else total - (w // 2)
        lo, hi = self._emitted, max(self._emitted, ready)
        if hi <= lo:
            out = _no_frets()
        elif not w or w <= 1 or total <= w:
            out = np.stack(self._raw_frets[lo:hi])
        else:
            # smooth only the slice around the newly ready windows: vote
            # windows are local, and the slice is widened so that its edge
            # padding agrees with the whole history's
            half = w // 2
            a, b = max(0, lo - half), min(total, hi + half)
            if b - a <= w:  # escape mode_filter's passthrough regime
                a = max(0, b - (w + 1))
                b = min(total, a + (w + 1))
            seg = mode_filter_np(np.stack(self._raw_frets[a:b]), window=w)
            out = seg[lo - a:hi - a]
        self._emitted = hi
        return Transcription(frets=out, times=np.asarray(self._raw_times[lo:hi]))
