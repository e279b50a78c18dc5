"""Audio file loading (WAV native; no librosa/pydub dependency).

Replaces the reference's ``librosa.load(sr=None, mono=True)`` (cqt.py:23)
and pydub MP3 decode (tablature_generator.py:573-597).  WAV is read with
scipy; resampling (only needed when a file's rate differs from the
configured 44.1 kHz) uses scipy polyphase filtering.  MP3 decode is
gated on ffmpeg availability.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np


def load_wav(path: str, *, mono: bool = True) -> tuple[np.ndarray, int]:
    """-> (float32 samples in [-1, 1], sample_rate)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if mono and data.ndim == 2:
        data = data.mean(axis=1)
    return data, int(sr)


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return x
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(x, sr_out // g, sr_in // g).astype(np.float32)


def load_audio(
    path: str, *, sample_rate: int | None = None, mono: bool = True
) -> tuple[np.ndarray, int]:
    """Load WAV or (via ffmpeg, if present) MP3/other formats."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        data, sr = load_wav(path, mono=mono)
    else:
        data, sr = _load_via_ffmpeg(path, mono=mono)
    if sample_rate is not None and sr != sample_rate:
        data = resample(data, sr, sample_rate)
        sr = sample_rate
    return data, sr


def _load_via_ffmpeg(path: str, *, mono: bool) -> tuple[np.ndarray, int]:
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            f"cannot decode {path!r}: only WAV is supported without ffmpeg"
        )
    sr = 44100
    cmd = [
        ffmpeg, "-v", "error", "-i", path, "-f", "f32le",
        "-ac", "1" if mono else "2", "-ar", str(sr), "-",
    ]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    data = np.frombuffer(raw, dtype=np.float32)
    if not mono:
        data = data.reshape(-1, 2)
    return data, sr
