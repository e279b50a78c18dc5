"""librosa-algorithm CQT oracle (NumPy/SciPy, host-side, test-only): the
port's copy of the JAX package's ``ops/cqt_librosa.py``, with its imports
pointed at the port's ``config`` and ``ops/cqt_kernels``.

The reference's features come from ``librosa.cqt`` (cqt.py:55,
tablature-generator (1).py:326) — the *recursive multirate* algorithm of
librosa 0.10.x (``librosa.core.constantq.vqt`` with ``gamma=0``):

1. bin frequencies ``fmin * 2**(k/bins_per_octave)``; relative bandwidth
   ``alpha = (2**(2/bpo) - 1) / (2**(2/bpo) + 1)`` (symmetric form),
   ``Q = filter_scale / alpha``; float filter lengths ``Q * sr / f``.
2. per octave (top first): build complex Hann wavelets at the *current*
   rate, L1-normalize (``norm=1``), zero-pad to a power-of-two ``n_fft``,
   scale by ``lengths / n_fft``, FFT, sparsify rows (quantile 0.01), and
   apply to a rectangular-window centered STFT of the signal
   (``pad_mode='constant'``); scale the basis by ``sqrt(sr / my_sr)``.
3. between octaves halve the rate: resample by 2 (librosa: soxr_hq;
   here: a 120 dB-stopband Kaiser half-band polyphase filter — soxr is
   not installable in this image, so the resampler is the one
   deliberately inexact piece) and multiply by ``sqrt(2)``
   (``resample(..., scale=True)`` energy preservation).
4. stack octaves, trim to the common frame count, and (``scale=True``)
   divide each bin by ``sqrt(length)``.

This module is a from-scratch reimplementation of that publicly
documented algorithm, used ONLY as a numerical oracle in tests
(tests/test_torch_cqt_librosa.py) to quantify how far the port's
single-rate direct-form filterbank (:mod:`.cqt_kernels`) diverges from
what librosa actually computes.  The port's CQT never imports this.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as _signal

from ..config import CQTConfig

#: Kaiser half-band decimation filter standing in for soxr_hq
#: (~120 dB stopband; taps chosen so the transition band is well inside
#: the guard band between adjacent octaves' filters).
_HALFBAND_TAPS = 193
_HALFBAND_BETA = 14.0


def relative_bandwidth(freqs: np.ndarray) -> np.ndarray:
    """librosa.filters._relative_bandwidth: symmetric relative bandwidth
    per bin estimated from neighbouring center frequencies."""
    if len(freqs) <= 1:
        raise ValueError("need at least 2 frequencies")
    bpo = np.empty_like(freqs)
    bpo[0] = 1.0 / np.log2(freqs[1] / freqs[0])
    bpo[-1] = 1.0 / np.log2(freqs[-1] / freqs[-2])
    if len(freqs) > 2:
        bpo[1:-1] = 2.0 / np.log2(freqs[2:] / freqs[:-2])
    return (2.0 ** (2.0 / bpo) - 1) / (2.0 ** (2.0 / bpo) + 1)


def wavelet_lengths(
    freqs: np.ndarray, sr: float, alpha: np.ndarray, filter_scale: float = 1.0
) -> np.ndarray:
    """librosa.filters.wavelet_lengths (gamma=0): float support length
    ``Q * sr / f`` per bin with ``Q = filter_scale / alpha``."""
    q = filter_scale / alpha
    return q * sr / freqs


def _pad_center(x: np.ndarray, size: int) -> np.ndarray:
    lpad = (size - len(x)) // 2
    return np.pad(x, (lpad, size - len(x) - lpad))


def wavelet_basis(
    freqs: np.ndarray,
    sr: float,
    alpha: np.ndarray,
    filter_scale: float = 1.0,
    window: str = "hann",
) -> tuple[np.ndarray, np.ndarray]:
    """librosa.filters.wavelet (norm=1, pad_fft=True): [n_bins, n_fft]
    complex basis + float lengths.  Support sampled at
    ``arange(-l//2, l//2)`` (floor semantics on the float length) with a
    periodic window, L1-normalized."""
    lengths = wavelet_lengths(freqs, sr, alpha, filter_scale)
    filters = []
    for ilen, freq in zip(lengths, freqs):
        t = np.arange(-ilen // 2, ilen // 2, dtype=np.float64)
        sig = np.exp(1j * 2.0 * np.pi * freq / sr * t)
        sig = sig * _signal.get_window(window, len(sig), fftbins=True)
        sig = sig / np.sum(np.abs(sig))  # norm=1
        filters.append(sig)
    max_len = int(2.0 ** np.ceil(np.log2(lengths.max())))
    basis = np.array([_pad_center(f, max_len) for f in filters])
    return basis, lengths


def sparsify_rows(x: np.ndarray, quantile: float = 0.01) -> np.ndarray:
    """librosa.util.sparsify_rows: per row, zero the smallest-magnitude
    entries whose cumulative L1 mass is below ``quantile``."""
    out = np.zeros_like(x)
    for i in range(x.shape[0]):
        mags = np.abs(x[i])
        norm = mags.sum()
        if norm == 0:
            continue
        order = np.argsort(mags)
        cum = np.cumsum(mags[order] / norm)
        threshold_idx = np.argmin(cum < quantile)
        keep = mags >= mags[order[threshold_idx]]
        out[i, keep] = x[i, keep]
    return out


def _vqt_filter_fft(
    sr: float,
    freqs: np.ndarray,
    alpha: np.ndarray,
    hop_length: int,
    filter_scale: float,
    window: str,
    sparsity: float = 0.01,
) -> tuple[np.ndarray, int]:
    """librosa.core.constantq.__vqt_filter_fft: frequency-domain basis.
    ``n_fft`` is the wavelet buffer's power of two; the kernels sit
    centered in it (growing n_fft after centering would time-shift the
    circular correlation, so any growth must precede pad_center — with
    the pow-2 buffer from wavelet_basis the centered form is correct)."""
    basis, lengths = wavelet_basis(freqs, sr, alpha, filter_scale, window)
    n_fft = basis.shape[1]
    basis = basis * (lengths[:, None] / float(n_fft))
    fft_basis = np.fft.fft(basis, n=n_fft, axis=1)[:, : (n_fft // 2) + 1]
    return sparsify_rows(fft_basis, sparsity), n_fft


def _stft_rect(
    y: np.ndarray, n_fft: int, hop_length: int, pad_mode: str
) -> np.ndarray:
    """Centered STFT with a rectangular ('ones') window — what
    __cqt_response uses.  Returns [n_fft//2+1, n_frames]."""
    pad = n_fft // 2
    if pad_mode == "constant" or pad >= len(y):
        # np.pad reflect needs pad < len; librosa cqt defaults to constant
        yp = np.pad(y, pad, mode="constant")
    else:
        yp = np.pad(y, pad, mode="reflect")
    n_frames = 1 + len(y) // hop_length
    frames = np.stack(
        [yp[t * hop_length : t * hop_length + n_fft] for t in range(n_frames)],
        axis=1,
    )
    return np.fft.rfft(frames, axis=0)


def _resample_half(y: np.ndarray) -> np.ndarray:
    """Downsample by 2 with energy scaling (resample(..., scale=True)):
    high-quality Kaiser half-band standing in for soxr_hq."""
    h = _signal.firwin(_HALFBAND_TAPS, 0.5, window=("kaiser", _HALFBAND_BETA))
    return _signal.resample_poly(y, 1, 2, window=h) * np.sqrt(2.0)


def cqt_multirate(
    y: np.ndarray,
    cfg: CQTConfig,
    *,
    scale: bool = True,
    sparsity: float = 0.01,
    pad_mode: str = "constant",
) -> np.ndarray:
    """librosa.cqt-algorithm magnitude-CQT of a single window.

    Input [num_samples] float; output [n_bins, n_frames] complex64.
    Parameters mirror ``librosa.cqt(y, sr, hop_length, fmin, n_bins,
    bins_per_octave, filter_scale, norm=1, window='hann', scale=scale,
    pad_mode=pad_mode)``; the reference uses all-default kwargs
    (cqt.py:55) = scale=True, pad_mode='constant' on librosa 0.10.x.
    """
    sr = float(cfg.sample_rate)
    hop = cfg.hop_length
    bpo = cfg.bins_per_octave
    n_bins = cfg.n_bins
    n_octaves = int(np.ceil(n_bins / bpo))
    n_filters = min(bpo, n_bins)
    if hop % (2 ** (n_octaves - 1)) != 0:
        raise ValueError(
            f"hop_length {hop} must be a multiple of 2**{n_octaves - 1}"
        )

    freqs = cfg.fmin * 2.0 ** (np.arange(n_bins) / bpo)
    alpha = relative_bandwidth(freqs)
    lengths_full = wavelet_lengths(freqs, sr, alpha, cfg.filter_scale)

    my_y, my_sr, my_hop = np.asarray(y, np.float64), sr, hop
    responses = []
    for i in range(n_octaves):
        sl = slice(-n_filters * (i + 1), -n_filters * i if i else None)
        fft_basis, n_fft = _vqt_filter_fft(
            my_sr, freqs[sl], alpha[sl], my_hop, cfg.filter_scale, cfg.window,
            sparsity,
        )
        fft_basis = fft_basis * np.sqrt(sr / my_sr)
        d = _stft_rect(my_y, n_fft, my_hop, pad_mode)
        responses.append(fft_basis @ d)
        if my_hop % 2 == 0:
            my_hop //= 2
            my_sr /= 2.0
            my_y = _resample_half(my_y)

    # __trim_stack: bottom of the stack is the LAST response computed
    n_frames = min(r.shape[-1] for r in responses)
    out = np.empty((n_bins, n_frames), np.complex128)
    end = n_bins
    for r in responses:
        n_oct = r.shape[0]
        if end < n_oct:
            out[:end] = r[-end:, :n_frames]
        else:
            out[end - n_oct : end] = r[:, :n_frames]
        end -= n_oct

    if scale:
        out = out / np.sqrt(lengths_full[:, None])
    return out


def cqt_multirate_db(y: np.ndarray, cfg: CQTConfig, **kwargs) -> np.ndarray:
    """Full reference recipe on the multirate oracle: |CQT|**p ->
    amplitude_to_db(ref=max) -> noise gate (cqt.py:55-58)."""
    from .cqt_kernels import amplitude_to_db_np, noise_gate_np

    c = np.abs(cqt_multirate(y, cfg, **kwargs)) ** cfg.magnitude_power
    db = amplitude_to_db_np(c, cfg, c.max())
    return noise_gate_np(db, cfg).astype(np.float32)
