"""The model input, worked out plainly: framing of a track, the constant-Q
transform of each 0.2 s window, dB scaling and the -60 dB gate, and the
224x224 image the 224^2 models take (bicubic resize, three channels, the
ImageNet normalization for the ResNet).

The transform is the direct one: each bin's kernel is a periodic-Hann
windowed complex exponential of librosa 0.10's length Q * sr / f, L1
normalized and scaled by sqrt(length) (``librosa.cqt(scale=True)``),
centered in a common buffer; a window is zero padded by half that buffer on
both sides, cut into centered frames at the hop, and each frame multiplied
by the kernels in float32.  Then |C|**4, dB against each window's maximum
with an amin of 1e-5, a floor at -80 dB, and every value under -60 dB set to
-120 dB.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .precision import Precision, fp32_products

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def filterbank(cqt: dict) -> np.ndarray:
    """[width, 2 * n_bins] float32 kernels (real block, then imaginary)."""
    sr, n_bins, bpo = cqt["sample_rate"], cqt["n_bins"], cqt["bins_per_octave"]
    freqs = cqt["fmin"] * 2.0 ** (np.arange(n_bins, dtype=np.float64) / bpo)
    r = 2.0 ** (2.0 / bpo)
    q = cqt["filter_scale"] * (r + 1.0) / (r - 1.0)
    lengths = q * sr / freqs
    align = max(256, cqt["hop_length"])
    width = -(-int(math.ceil(lengths.max())) // align) * align
    kernels = np.zeros((width, 2 * n_bins), np.float64)
    for b in range(n_bins):
        n_taps = int(np.ceil(lengths[b] / 2.0) + np.floor(lengths[b] / 2.0))
        n = np.arange(n_taps, dtype=np.float64)
        hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_taps)
        k = hann * np.exp(2j * np.pi * freqs[b] * (n - (n_taps - 1) / 2.0) / sr)
        k /= np.abs(k).sum()
        if cqt["scale"]:
            k *= np.sqrt(lengths[b])
        start = width // 2 - n_taps // 2
        kernels[start:start + n_taps, b] = k.real
        kernels[start:start + n_taps, n_bins + b] = k.imag
    return kernels.astype(np.float32)


def window_samples(cqt: dict) -> int:
    return int(cqt["window_seconds"] * cqt["sample_rate"])


def frame(track: np.ndarray, cqt: dict, hop_samples: int) -> np.ndarray:
    """[n, window] complete windows of a 1-D track at ``hop_samples``."""
    w = window_samples(cqt)
    n = (len(track) - w) // hop_samples + 1 if len(track) >= w else 0
    idx = np.arange(n)[:, None] * hop_samples + np.arange(w)[None, :]
    return track[idx]


class CQT:
    """The transform of ``cqt`` (a configuration's ``cqt`` group) on
    ``device``: [B, window] float32 -> [B, n_bins, frames] gated dB."""

    def __init__(self, cqt: dict, device):
        if cqt["pad_mode"] != "constant":
            raise ValueError("the reference transform pads with zeros only")
        self.cfg = cqt
        self.kernels = torch.from_numpy(filterbank(cqt)).to(device)

    def __call__(self, x: torch.Tensor, prec: Precision = Precision()) -> torch.Tensor:
        """``prec`` rounds the frame product's operands where the
        configuration states that product in bf16 (``precision``
        ``default``): the control's step below it.  At ``highest`` and
        ``bf16x3`` the product stays float32."""
        cfg, kw = self.cfg, self.kernels.shape[0]
        hop, n_bins = cfg["hop_length"], cfg["n_bins"]
        frames_n = 1 + x.shape[-1] // hop
        padded = F.pad(x.float(), (kw // 2, kw // 2))
        need = (frames_n - 1) * hop + kw
        if padded.shape[-1] < need:
            padded = F.pad(padded, (0, need - padded.shape[-1]))
        frames = padded.unfold(-1, kw, hop)[:, :frames_n]
        kernels = self.kernels
        if cfg["precision"] == "default":
            frames, kernels = prec(frames), prec(kernels)
        with fp32_products():
            coeff = frames @ kernels
        power = (coeff[..., :n_bins] ** 2 + coeff[..., n_bins:] ** 2) ** (cfg["magnitude_power"] / 2)
        ref = power.amax(dim=(1, 2), keepdim=True)
        amin = cfg["amin"]
        db = 20 * torch.log10(power.clamp_min(amin)) - 20 * torch.log10(ref.clamp_min(amin))
        db = db.clamp_min(-cfg["top_db"])
        db = torch.where(db < cfg["gate_threshold_db"], torch.full_like(db, cfg["gate_floor_db"]), db)
        return db.transpose(1, 2)


def bicubic_matrix(n_in: int, n_out: int, a: float = -0.75) -> np.ndarray:
    """[n_out, n_in] bicubic interpolation (half-pixel centers, clamped
    edge taps), torch's ``align_corners=False`` upscale."""
    def kernel(d):
        d = np.abs(d)
        return np.where(d <= 1, (a + 2) * d**3 - (a + 3) * d**2 + 1,
                        np.where(d < 2, a * d**3 - 5 * a * d**2 + 8 * a * d - 4 * a, 0.0))

    m = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        src = (i + 0.5) * n_in / n_out - 0.5
        taps = np.arange(int(np.floor(src)) - 1, int(np.floor(src)) + 3)
        w = kernel(src - taps)
        np.add.at(m[i], np.clip(taps, 0, n_in - 1), w / w.sum())
    return m.astype(np.float32)


def image(db: torch.Tensor, size: int, imagenet: bool) -> torch.Tensor:
    """[B, F, T] dB -> [B, 3, size, size]: dB to [0, 1] ((x + 120) / 120,
    clipped), bicubic resize, three equal channels, and with ``imagenet``
    the ImageNet mean and deviation."""
    unit = ((db + 120.0) / 120.0).clamp(0.0, 1.0)
    rh = torch.from_numpy(bicubic_matrix(db.shape[1], size)).to(db.device)
    rw = torch.from_numpy(bicubic_matrix(db.shape[2], size)).to(db.device)
    with fp32_products():
        img = rh @ unit @ rw.T
    img = img[:, None].expand(-1, 3, -1, -1)
    if imagenet:
        mean = torch.tensor(IMAGENET_MEAN, device=db.device).view(1, 3, 1, 1)
        std = torch.tensor(IMAGENET_STD, device=db.device).view(1, 3, 1, 1)
        img = (img - mean) / std
    return img
