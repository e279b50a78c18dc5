"""Constant-Q filterbank construction (NumPy), a copy of the JAX package's
``ops/cqt_kernels.py`` kept so the port never imports that package.
``make_filterbank(cfg).stacked()`` is bit-identical to the JAX copy's.

The reference computes its CQT through librosa's recursive multi-rate
algorithm, one 0.2 s segment at a time on the CPU (``cqt.py:55``,
``tablature-generator (1).py:326``).  librosa is a *dependency* there, not
part of the repo; this framework owns the transform.  We use the direct
(single-rate) formulation — one complex windowed-exponential kernel per
bin, evaluated as a dense GEMM against frames of the signal — because a
single large matmul is the idiomatic mapping onto the TPU MXU
(nnAudio/MelT formulation; see PAPERS.md).

Numerics are librosa-0.10-faithful (the library the reference actually
calls): symmetric-alpha Q, float filter lengths ``Q * sr / f`` with
``arange(-l//2, l//2)`` support, periodic Hann, L1 normalization
(``norm=1``), and — because ``librosa.cqt`` defaults to ``scale=True`` —
a ``sqrt(length)`` per-bin gain (each bin's response to a unit sinusoid
is ~``sqrt(length)/2``).  That gain is a ~24 dB amplitude tilt across the
8 octaves which survives the ``ref=np.max`` dB scaling and the -60 dB
gate (``cqt.py:56-58``), so it is part of the feature definition, not a
free constant.  The single-rate direct form here is validated against a
full reimplementation of librosa's recursive multirate algorithm
(:mod:`.cqt_librosa`) in tests/test_cqt.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..config import CQTConfig


@dataclass(frozen=True)
class CQTFilterbank:
    """Dense time-domain CQT filterbank, centered in a common buffer.

    kernels_real/imag: [kernel_width, n_bins] float32, zero-padded so every
    bin's (length ``lengths[b]``) kernel is centered at kernel_width // 2.
    """

    kernels_real: np.ndarray
    kernels_imag: np.ndarray
    lengths: np.ndarray  # [n_bins] int32, true support length per bin
    frequencies: np.ndarray  # [n_bins] float64, center frequency (Hz)
    kernel_width: int
    hop_length: int
    sample_rate: int

    @property
    def n_bins(self) -> int:
        return self.kernels_real.shape[1]

    def stacked(self) -> np.ndarray:
        """[kernel_width, 2 * n_bins] — real block then imag block."""
        return np.concatenate([self.kernels_real, self.kernels_imag], axis=1)


def _hann_periodic(length: int) -> np.ndarray:
    n = np.arange(length, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / length)


def bin_frequencies(cfg: CQTConfig) -> np.ndarray:
    b = np.arange(cfg.n_bins, dtype=np.float64)
    return cfg.fmin * 2.0 ** (b / cfg.bins_per_octave)


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def make_filterbank(cfg: CQTConfig, align: int = 256) -> CQTFilterbank:
    """Build the dense CQT filterbank for ``cfg``.

    ``align`` pads kernel_width to a multiple (MXU-friendly contraction
    dim; also a multiple of hop_length so frame offsets stay aligned).
    """
    freqs = bin_frequencies(cfg)
    nyquist = cfg.sample_rate / 2.0
    if freqs[-1] > nyquist:
        raise ValueError(
            f"top CQT bin {freqs[-1]:.1f} Hz exceeds Nyquist {nyquist:.1f} Hz"
        )
    q = cfg.q_factor
    lengths_f = q * cfg.sample_rate / freqs  # float lengths, librosa-style
    width = _round_up(int(np.ceil(lengths_f.max())), max(align, cfg.hop_length))

    real = np.zeros((width, cfg.n_bins), dtype=np.float64)
    imag = np.zeros((width, cfg.n_bins), dtype=np.float64)
    center = width // 2
    for b in range(cfg.n_bins):
        lf = lengths_f[b]
        # librosa filters.wavelet support: arange(-l//2, l//2) on the
        # float length -> ceil(l/2) + floor(l/2) samples.
        length = int(np.ceil(lf / 2.0) + np.floor(lf / 2.0))
        n = np.arange(length, dtype=np.float64)
        # Phase referenced to the kernel center; only |CQT| is consumed
        # downstream (cqt.py:56) so the absolute phase origin is free.
        phase = 2.0 * np.pi * freqs[b] * (n - (length - 1) / 2.0) / cfg.sample_rate
        win = _hann_periodic(length)
        kernel = win * np.exp(1j * phase)
        kernel /= np.sum(np.abs(kernel))  # L1 normalization (librosa norm=1)
        if cfg.scale:
            # librosa.cqt(scale=True): response to a unit sinusoid is
            # ~sqrt(length)/2 per bin (raw octave response ~length/2,
            # final V /= sqrt(length)).
            kernel *= np.sqrt(lf)
        start = center - length // 2
        real[start : start + length, b] = kernel.real
        imag[start : start + length, b] = kernel.imag

    return CQTFilterbank(
        kernels_real=real.astype(np.float32),
        kernels_imag=imag.astype(np.float32),
        lengths=np.ceil(lengths_f).astype(np.int32),
        frequencies=freqs,
        kernel_width=width,
        hop_length=cfg.hop_length,
        sample_rate=cfg.sample_rate,
    )


def n_frames_for(num_samples: int, hop_length: int) -> int:
    """Centered-frame count, librosa convention: 1 + floor(N / hop)."""
    return 1 + num_samples // hop_length


def reflect_pad_np(x: np.ndarray, pad: int) -> np.ndarray:
    """np.pad(mode='reflect') along the last axis (supports pad >= length)."""
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")


def pad_np(x: np.ndarray, pad: int, mode: str) -> np.ndarray:
    """Centered-frame padding: 'constant' (librosa 0.10 cqt default) or
    'reflect' (older librosa)."""
    if mode == "constant":
        return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)])
    if mode == "reflect":
        return reflect_pad_np(x, pad)
    raise ValueError(f"unknown pad_mode {mode!r}")


def amplitude_to_db_np(
    s: np.ndarray, cfg: CQTConfig, ref: float | np.ndarray
) -> np.ndarray:
    """librosa.amplitude_to_db(S, ref=..., amin=1e-5, top_db=80) semantics."""
    amin = cfg.amin
    db = 20.0 * np.log10(np.maximum(amin, s)) - 20.0 * np.log10(
        np.maximum(amin, ref)
    )
    if cfg.top_db is not None:
        db = np.maximum(db, db.max(axis=(-2, -1), keepdims=True) - cfg.top_db)
    return db


def noise_gate_np(db: np.ndarray, cfg: CQTConfig) -> np.ndarray:
    """cqt_lim: values below -60 dB are floored to -120 dB (cqt.py:10-13)."""
    out = db.copy()
    out[out < cfg.gate_threshold_db] = cfg.gate_floor_db
    return out


def cqt_reference(x: np.ndarray, cfg: CQTConfig) -> np.ndarray:
    """Slow, obviously-correct NumPy CQT — the numerical spec for the
    TPU path.  Input [num_samples] or [batch, num_samples]; output
    [..., n_bins, n_frames] float32 dB, gated.

    Mirrors the full reference recipe cqt.py:55-58:
    CQT -> |.|**4 -> amplitude_to_db(ref=max) -> -60 dB gate.
    """
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    fb = make_filterbank(cfg)
    pad = fb.kernel_width // 2
    padded = pad_np(x.astype(np.float64), pad, cfg.pad_mode)
    t = n_frames_for(x.shape[-1], cfg.hop_length)
    kernels = fb.kernels_real.astype(np.float64) + 1j * fb.kernels_imag.astype(
        np.float64
    )
    out = np.zeros((x.shape[0], cfg.n_bins, t), dtype=np.float64)
    for i in range(t):
        frame = padded[:, i * cfg.hop_length : i * cfg.hop_length + fb.kernel_width]
        coeff = frame @ kernels  # [batch, n_bins] complex
        out[:, :, i] = np.abs(coeff) ** cfg.magnitude_power
    ref = out.max(axis=(-2, -1), keepdims=True)
    db = amplitude_to_db_np(out, cfg, ref)
    db = noise_gate_np(db, cfg)
    db = db.astype(np.float32)
    return db[0] if squeeze else db


def estimate_flops(cfg: CQTConfig, batch: int) -> int:
    """FLOPs of the framed GEMM for one batch of analysis windows."""
    fb_width = _round_up(
        int(math.ceil(cfg.q_factor * cfg.sample_rate / cfg.fmin)),
        max(256, cfg.hop_length),
    )
    frames = n_frames_for(cfg.window_samples, cfg.hop_length)
    return 2 * batch * frames * fb_width * 2 * cfg.n_bins
