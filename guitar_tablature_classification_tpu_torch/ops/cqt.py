"""Batched CQT frontend in PyTorch.

The counterpart of the JAX package's ``ops/cqt.py``: analysis windows
``[B, N]`` go in, gated dB features ``[B, n_bins, T]`` come out::

    centre pad -> frames -> frames @ filterbank -> |.|**p
    -> dB against each window's max over (T, F) -> top_db floor
    -> -60 dB gate to -120 dB

:class:`CQTFrontend` dispatches on the device of its input: a CUDA tensor
goes to the hand-written kernel (:mod:`.cqt_cuda`, ``csrc/cqt.cu``), a CPU
tensor to :func:`cqt_plain`, the plain version of the same function, which
builds the frame stack and runs one fp32 matmul.  The plain version is
also what the tests hold the kernel against on the card.

Precision tiers (``CQTConfig.precision``), the same in both versions:

- ``highest``: fp32 products, fp32 sums (TF32 off on the card);
- ``bf16x3``: each operand split into bf16 hi + lo, sum of hi*hi + hi*lo +
  lo*hi in fp32 (the JAX package's 3-pass split);
- ``default``: audio and filterbank rounded to bf16 (round to nearest
  even), products and sums in fp32.  The rounding happens on fp32 copies,
  so the matmul itself still accumulates and returns fp32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from ..config import CQTConfig
from .cqt_kernels import CQTFilterbank, make_filterbank, n_frames_for

PRECISIONS = ("highest", "bf16x3", "default")


def reflect_index(num_samples: int, pad: int) -> np.ndarray:
    """Gather indices implementing np.pad(mode='reflect') for any pad size
    (the CQT kernels are ~2.7x longer than a 0.2 s window, so pad >= N is
    the norm here)."""
    if num_samples < 2:
        raise ValueError("reflect padding needs at least 2 samples")
    period = 2 * (num_samples - 1)
    j = np.arange(-pad, num_samples + pad, dtype=np.int64)
    jm = np.mod(j, period)
    return np.where(jm >= num_samples, period - jm, jm).astype(np.int32)


def split_geometry(
    fb: CQTFilterbank, cfg: CQTConfig, num_samples: int
) -> tuple[int, int, int, int, int] | None:
    """The JAX package's zero-support split geometry
    ``(split_bin, k_b, b_off, data_lo, data_hi)``, or None when it does not
    apply (reflect padding, or a half wider than 64 bins).

    The port's kernel does not need it: it skips every bin's zero filter
    rows, and with constant padding the rows that meet only padding, for
    any recipe.  It is kept so the tests can show both packages agree on
    the data range ``[data_lo, data_hi)`` that the kernel also clips to.
    """
    if cfg.pad_mode != "constant":
        return None
    n_bins = cfg.n_bins
    split = n_bins // 2
    if 2 * (n_bins - split) > 128 or 2 * split > 128:
        return None
    kw = fb.kernel_width
    # slab for bins [split:): longest is bin `split` (lengths decrease
    # with frequency); +2 covers the ceil(l/2)+floor(l/2) support rule
    k_b = ((int(fb.lengths[split]) + 2 + 511) // 512) * 512
    if k_b * 4 > kw:  # upper half not meaningfully shorter: no win
        return None
    b_off = kw // 2 - k_b // 2
    if b_off < 0 or b_off % 128:
        return None
    t = n_frames_for(num_samples, cfg.hop_length)
    pad = kw // 2
    data_lo = max(0, pad - (t - 1) * cfg.hop_length)
    data_hi = min(kw, pad + num_samples)
    return (split, k_b, b_off, data_lo, data_hi)


@contextlib.contextmanager
def fp32_matmul():
    """Run matmuls on the card in full fp32 (TF32 off) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def round_bf16(a: torch.Tensor) -> torch.Tensor:
    """fp32 -> nearest bf16 (ties to even) -> fp32."""
    return a.to(torch.bfloat16).to(torch.float32)


def split_bf16(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 -> (hi, lo), both bf16-representable, hi + lo == a to ~16
    mantissa bits."""
    hi = round_bf16(a)
    return hi, round_bf16(a - hi)


def cqt_epilogue(
    coeff: torch.Tensor,
    *,
    n_bins: int,
    magnitude_power: float,
    amin: float,
    top_db: float,
    gate_threshold_db: float,
    gate_floor_db: float,
) -> torch.Tensor:
    """[B, T, 2F] raw coefficients (re | im) -> [B, F, T] gated dB."""
    re, im = coeff[..., :n_bins], coeff[..., n_bins:]
    mag2 = re * re + im * im
    s = mag2 ** (magnitude_power / 2.0)
    ref = torch.amax(s, dim=(1, 2), keepdim=True)
    db = 20.0 * torch.log10(torch.clamp(s, min=amin)) - 20.0 * torch.log10(
        torch.clamp(ref, min=amin)
    )
    db = torch.clamp(db, min=-top_db)
    db = torch.where(
        db < gate_threshold_db, torch.full_like(db, gate_floor_db), db
    )
    return db.transpose(1, 2).contiguous()


def cqt_plain(
    x: torch.Tensor,
    kernels: torch.Tensor,
    pad_index: torch.Tensor | None,
    *,
    hop_length: int,
    n_bins: int,
    magnitude_power: float,
    amin: float,
    top_db: float,
    gate_threshold_db: float,
    gate_floor_db: float,
    precision: str,
) -> torch.Tensor:
    """Plain version of the fused CQT: [B, N] fp32 -> [B, n_bins, T] dB.

    Materializes the [B, T, K] frame stack and contracts it with the
    [K, 2F] filterbank in one fp32 matmul (three for ``bf16x3``)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    kernel_width = kernels.shape[0]
    t = n_frames_for(x.shape[-1], hop_length)
    if pad_index is None:  # pad_mode='constant' (librosa 0.10 default)
        padded = F.pad(x, (kernel_width // 2, kernel_width // 2))
    else:  # pad_mode='reflect' via gather indices
        padded = x[:, pad_index]
    frames = padded.unfold(-1, kernel_width, hop_length)[:, :t]  # [B, T, K]
    with fp32_matmul():
        if precision == "bf16x3":
            f_hi, f_lo = split_bf16(frames)
            k_hi, k_lo = split_bf16(kernels)
            coeff = f_hi @ k_hi + f_hi @ k_lo + f_lo @ k_hi
        elif precision == "default":
            coeff = round_bf16(frames) @ round_bf16(kernels)
        else:
            coeff = frames @ kernels  # [B, T, 2F]
    return cqt_epilogue(
        coeff, n_bins=n_bins, magnitude_power=magnitude_power, amin=amin,
        top_db=top_db, gate_threshold_db=gate_threshold_db,
        gate_floor_db=gate_floor_db,
    )


class CQTFrontend:
    """Callable CQT for fixed-length analysis windows.

    >>> frontend = CQTFrontend(CQTConfig())
    >>> feats = frontend(windows)   # [B, 8820] -> [B, 96, 9] float32 dB

    The output lies on the input's device: a CUDA input runs the kernel of
    :mod:`.cqt_cuda`, a CPU input the plain version.  ``gemm_split`` and
    ``batch_block`` choose among the JAX package's TPU kernels; the port has
    one kernel that always skips exactly-zero terms, so they do not change
    what is computed (``gemm_split`` is still validated).
    """

    def __init__(self, cfg: CQTConfig | None = None):
        self.cfg = cfg or CQTConfig()
        if self.cfg.precision not in PRECISIONS:
            raise ValueError(
                f"CQTConfig.precision must be one of {PRECISIONS}, "
                f"got {self.cfg.precision!r}"
            )
        if self.cfg.pad_mode not in ("constant", "reflect"):
            raise ValueError(f"unknown pad_mode {self.cfg.pad_mode!r}")
        if self.cfg.gemm_split not in ("auto", "on", "off"):
            raise ValueError(
                f"gemm_split must be auto|on|off, got {self.cfg.gemm_split!r}"
            )
        self.filterbank: CQTFilterbank = make_filterbank(self.cfg)
        self._kernels: dict[torch.device, torch.Tensor] = {}
        self._pad_index: dict[tuple, torch.Tensor] = {}
        self._plans: dict[tuple, object] = {}

    def kernels_on(self, device: torch.device) -> torch.Tensor:
        """The [K, 2F] fp32 filterbank (real | imag) on ``device``."""
        if device not in self._kernels:
            self._kernels[device] = torch.from_numpy(
                self.filterbank.stacked()
            ).to(device)
        return self._kernels[device]

    def pad_index_on(
        self, num_samples: int, device: torch.device
    ) -> torch.Tensor | None:
        if self.cfg.pad_mode == "constant":
            return None
        key = (num_samples, device)
        if key not in self._pad_index:
            idx = reflect_index(num_samples, self.filterbank.kernel_width // 2)
            self._pad_index[key] = torch.from_numpy(idx.astype(np.int64)).to(
                device
            )
        return self._pad_index[key]

    def kernel_plan(self, num_samples: int, device: torch.device):
        """The CUDA kernel's launch plan for this window length (cached)."""
        from .cqt_cuda import make_plan

        key = (num_samples, device)
        if key not in self._plans:
            self._plans[key] = make_plan(
                self.filterbank, self.cfg, num_samples, device
            )
        return self._plans[key]

    @staticmethod
    def _as_batch(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        if x.ndim != 2:
            raise ValueError(f"expected [B, N] audio, got shape {tuple(x.shape)}")
        return x.to(torch.float32).contiguous(), squeeze

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """The plain version on any device (the reference for the kernel)."""
        x, squeeze = self._as_batch(x)
        cfg = self.cfg
        out = cqt_plain(
            x, self.kernels_on(x.device),
            self.pad_index_on(x.shape[-1], x.device),
            hop_length=cfg.hop_length, n_bins=cfg.n_bins,
            magnitude_power=cfg.magnitude_power, amin=cfg.amin,
            top_db=cfg.top_db, gate_threshold_db=cfg.gate_threshold_db,
            gate_floor_db=cfg.gate_floor_db, precision=cfg.precision,
        )
        return out[0] if squeeze else out

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, num_samples] (or [num_samples]) audio at cfg.sample_rate.
        Returns [B, n_bins, n_frames] float32 dB features."""
        from .cqt_cuda import cqt_fused

        x, squeeze = self._as_batch(x)
        out = cqt_fused(x, self)
        return out[0] if squeeze else out
