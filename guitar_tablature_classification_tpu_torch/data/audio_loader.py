"""Raw-audio training loader: WAV tracks + label dirs -> audio batches (the
JAX package's ``data/audio_loader.py``).

Closes the end-to-end raw-audio training loop (BASELINE config 2: "full
CNN training with on-device CQT"): windows are cut from decoded tracks by
the native C++ loader (or a NumPy fallback where it cannot be built), labels
are looked up from per-track (6, 19) label grids by window start time, and
batches arrive as {'audio' [B, W], 'labels' [B, 6], 'weights'} ready for a
train step whose ``frontend`` computes the CQT on the card.  No feature
files touch disk.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import numpy as np

from ..config import CQTConfig

_SEGMENT_RE = re.compile(r"^(?P<base>.+)_segment_\d+_(?P<start>[\d.]+)\.npy$")


def load_label_grid(labels_dir: str, track_base: str) -> dict[float, np.ndarray]:
    """{start_time: (6,) fret targets} for one track from fixture-named
    label files ({base}_segment_k_{start:.2f}.npy)."""
    grid: dict[float, np.ndarray] = {}
    for fname in os.listdir(labels_dir):
        m = _SEGMENT_RE.match(fname)
        if not m or m.group("base") != track_base:
            continue
        tab = np.load(os.path.join(labels_dir, fname))
        frets = np.argmax(tab, axis=-1) if tab.ndim == 2 else tab
        grid[round(float(m.group("start")), 2)] = frets.astype(np.int32)
    return grid


@dataclass
class AudioWindowLoader:
    """Infinite shuffled loader of (audio window, fret labels) batches.

    tracks: list of (wav_path, track_base).  Labels must exist on the
    fixture 0.2 s grid; windows are aligned to that grid (hop = window).
    ``native`` says which framing runs: True for the C++ loader, False for
    the NumPy fallback (no ``g++``).
    """

    tracks: list[tuple[str, str]]
    labels_dir: str
    batch_size: int
    cfg: CQTConfig
    seed: int = 0
    num_threads: int = 4

    def __post_init__(self):
        from . import native_loader

        window = self.cfg.window_samples
        # align the hop to the label grid (fixture labels lie on a
        # window-sized grid; see SURVEY C16)
        hop = self.cfg.window_samples
        paths = [p for p, _ in self.tracks]
        self._native = None
        if native_loader.ensure_built():
            self._native = native_loader.NativeWindowLoader(
                paths, window_samples=window, hop_samples=hop,
                batch_size=self.batch_size, seed=self.seed,
                num_threads=self.num_threads,
            )
        else:
            from ..ops.framing import frame_track
            from .audio import load_audio

            self._windows = []
            for t, (path, _) in enumerate(self.tracks):
                audio, _sr = load_audio(path, sample_rate=self.cfg.sample_rate)
                frames = np.asarray(frame_track(audio, self.cfg, hop_samples=hop))
                for i in range(frames.shape[0]):
                    self._windows.append((t, i * hop, frames[i]))
            self._rng = np.random.default_rng(self.seed)
            self._order = self._rng.permutation(len(self._windows))
            self._cursor = 0

        self._grids = [load_label_grid(self.labels_dir, base) for _, base in self.tracks]

    @property
    def native(self) -> bool:
        return self._native is not None

    def __len__(self) -> int:
        if self._native is not None:
            return len(self._native)
        return len(self._windows)

    def _labels_for(self, track_ids, starts):
        sr = self.cfg.sample_rate
        labels = np.zeros((len(track_ids), 6), np.int32)
        weights = np.zeros((len(track_ids), 6), np.float32)
        for row, (t, start) in enumerate(zip(track_ids, starts)):
            frets = self._grids[int(t)].get(round(start / sr, 2))
            if frets is not None:
                labels[row] = frets
                weights[row] = 1.0
        return labels, weights

    def next_batch(self) -> dict:
        if self._native is not None:
            audio, tracks, starts = self._native.next_batch()
        else:
            rows = []
            for _ in range(self.batch_size):
                if self._cursor >= len(self._order):
                    self._order = self._rng.permutation(len(self._windows))
                    self._cursor = 0
                rows.append(self._windows[self._order[self._cursor]])
                self._cursor += 1
            tracks = np.asarray([r[0] for r in rows], np.int32)
            starts = np.asarray([r[1] for r in rows], np.int64)
            audio = np.stack([r[2] for r in rows])
        labels, weights = self._labels_for(tracks, starts)
        return {"audio": audio, "labels": labels, "weights": weights}

    def batches(self, steps: int):
        for _ in range(steps):
            yield self.next_batch()


def discover_tracks(audio_dir: str) -> list[tuple[str, str]]:
    """All WAVs in a directory as (path, base) pairs."""
    out = []
    for fname in sorted(os.listdir(audio_dir)):
        if fname.endswith(".wav"):
            out.append((os.path.join(audio_dir, fname), os.path.splitext(fname)[0]))
    return out
