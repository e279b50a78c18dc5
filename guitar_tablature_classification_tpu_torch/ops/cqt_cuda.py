"""The CQT kernels for Hopper: the fused CQT (``csrc/cqt.cu``: host plan,
build and wrapper) and the raw frame GEMM (``csrc/cqt_frame_gemm.cu``).

The kernel replaces the JAX package's TPU kernel
``ops/cqt_pallas.py::cqt_fused_split_chunked``; it takes any hop and either
padding mode, so it also computes what ``cqt_fused`` and
``cqt_fused_split`` compute there.  ``csrc/cqt.cu`` explains its design
and its bound.

The source is compiled with ``nvcc`` on first use (:mod:`.nvcc`: into
``_build/`` beside the package, named by a hash of the source and flags)
and loaded through ``ctypes``.  Nothing is compiled or loaded when this
module is imported.

:func:`cqt_fused` is the wrapper: a CPU tensor goes to the plain version
(:func:`.cqt.cqt_plain`), a CUDA tensor to the kernel, which raises if it
cannot launch.  ``launches`` counts the wrapper's launches of the fused
transform; each is one call of ``cqt_fused_launch``, which enqueues two
kernels (the coefficients, then the per-window dB epilogue).

:func:`cqt_frame_gemm` is the port of the TPU kernel
``ops/cqt_pallas.py::cqt_frame_gemm`` and, as there, its own entry point:
raw coefficients ``[B, T, 2F]`` with no epilogue, for any filterbank.  It
is built from its own source (``build_frame_gemm``) and counted in
``frame_gemm_launches``.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..config import CQTConfig
from ..device import on_card
from . import nvcc
from .cqt import frame_gemm_plain
from .cqt_kernels import CQTFilterbank, n_frames_for

GROUP = 4  # bins per work item; csrc/cqt.cu kGroup
CHUNK = 4096  # filter rows per work item
TILE_FRAMES = 9  # frames per CTA; csrc/cqt.cu kTileFrames
PRECISION_CODES = {"highest": 0, "bf16x3": 1, "default": 2}
MAX_SMEM_BYTES = 232448  # dynamic shared memory a Hopper CTA may use

SOURCE = os.path.join(nvcc.CSRC_DIR, "cqt.cu")
FRAME_GEMM_SOURCE = os.path.join(nvcc.CSRC_DIR, "cqt_frame_gemm.cu")
NVCC_FLAGS = nvcc.BASE_FLAGS
FRAME_GEMM_TILE = 64  # output rows and columns per CTA; csrc/cqt_frame_gemm.cu kBM, kBN
FRAME_GEMM_STEP = 16  # filter rows per step; kBK
TARGET_CTAS = 2 * 132  # two CTAs on each of the H100's SMs

launches = 0  # fused launches since import (or since a caller reset it)
frame_gemm_launches = 0  # cqt_frame_gemm launches, counted the same way
_lib = None
_frame_gemm_lib = None


# ----------------------------------------------------------------- geometry


@dataclass(frozen=True)
class KernelGeometry:
    """Window-length-independent layout of the packed filterbank.

    Bins are grouped by ``GROUP``; group g covers filter rows
    ``[group_lo[g], group_hi[g])``, the union of its bins' nonzero rows,
    stored from packed row ``group_off[g]``.  Each group's span is cut into
    work items of at most ``CHUNK`` rows, listed group by group."""

    group_lo: np.ndarray
    group_hi: np.ndarray
    group_off: np.ndarray
    group_item_start: np.ndarray
    group_item_count: np.ndarray
    item_group: np.ndarray
    item_k0: np.ndarray
    item_k1: np.ndarray

    @property
    def n_groups(self) -> int:
        return len(self.group_lo)

    @property
    def n_items(self) -> int:
        return len(self.item_group)

    @property
    def k_lo(self) -> int:
        return int(self.group_lo.min())

    @property
    def k_hi(self) -> int:
        return int(self.group_hi.max())

    def meta(self) -> np.ndarray:
        """The int32 table the kernel reads (layout in csrc/cqt.cu)."""
        return np.concatenate([
            self.group_lo, self.group_off,
            self.group_item_start, self.group_item_count,
            self.item_group, self.item_k0, self.item_k1,
        ]).astype(np.int32)


def bin_rows(fb: CQTFilterbank) -> tuple[np.ndarray, np.ndarray]:
    """Per bin, the first and one-past-last filter row that is nonzero."""
    nz = (fb.kernels_real != 0) | (fb.kernels_imag != 0)  # [K, F]
    lo = np.argmax(nz, axis=0)
    hi = nz.shape[0] - np.argmax(nz[::-1], axis=0)
    return lo.astype(np.int64), hi.astype(np.int64)


def kernel_geometry(fb: CQTFilterbank, chunk: int = CHUNK) -> KernelGeometry:
    lo, hi = bin_rows(fb)
    n_groups = -(-fb.n_bins // GROUP)
    g_lo = np.array([lo[g * GROUP:(g + 1) * GROUP].min() for g in range(n_groups)])
    g_hi = np.array([hi[g * GROUP:(g + 1) * GROUP].max() for g in range(n_groups)])
    g_off = np.concatenate([[0], np.cumsum(g_hi - g_lo)[:-1]])
    items_g, items_k0, items_k1, start, count = [], [], [], [], []
    for g in range(n_groups):
        start.append(len(items_g))
        k0s = list(range(int(g_lo[g]), int(g_hi[g]), chunk))
        count.append(len(k0s))
        for k0 in k0s:
            items_g.append(g)
            items_k0.append(k0)
            items_k1.append(min(k0 + chunk, int(g_hi[g])))
    i32 = lambda a: np.asarray(a, dtype=np.int32)  # noqa: E731
    return KernelGeometry(
        i32(g_lo), i32(g_hi), i32(g_off), i32(start), i32(count),
        i32(items_g), i32(items_k0), i32(items_k1),
    )


def pack_filter(
    fb: CQTFilterbank, geom: KernelGeometry, precision: str
) -> np.ndarray:
    """Packed filterbank, one row per (group, filter row in its span):
    ``[re x GROUP | im x GROUP]`` (``highest``; ``default`` rounded to bf16)
    or ``[re_hi | re_lo | im_hi | im_lo]`` (``bf16x3``)."""
    from .cqt import round_bf16, split_bf16

    n_pad = geom.n_groups * GROUP - fb.n_bins
    re = np.pad(fb.kernels_real, ((0, 0), (0, n_pad)))
    im = np.pad(fb.kernels_imag, ((0, 0), (0, n_pad)))
    rows = []
    for g in range(geom.n_groups):
        sl = slice(int(geom.group_lo[g]), int(geom.group_hi[g]))
        cols = slice(g * GROUP, (g + 1) * GROUP)
        rows.append(np.concatenate([re[sl, cols], im[sl, cols]], axis=1))
    packed = torch.from_numpy(np.concatenate(rows).astype(np.float32))
    if precision == "default":
        packed = round_bf16(packed)
    elif precision == "bf16x3":
        hi, lo = split_bf16(packed)
        g = GROUP
        packed = torch.cat(
            [hi[:, :g], lo[:, :g], hi[:, g:], lo[:, g:]], dim=1
        )
    return np.ascontiguousarray(packed.numpy())


def tile_rows(
    geom: KernelGeometry, *, reflect: bool, pad: int, hop: int,
    num_samples: int, t0: int, tile_frames: int,
) -> tuple[int, int]:
    """Filter rows [k_lo, k_hi) a tile starting at frame t0 contracts: with
    constant padding, only rows that meet the audio for some frame of the
    tile (csrc/cqt.cu computes the same)."""
    k_lo, k_hi = geom.k_lo, geom.k_hi
    if not reflect:
        k_lo = max(k_lo, pad - (t0 + tile_frames - 1) * hop)
        k_hi = min(k_hi, pad + num_samples - t0 * hop)
    return k_lo, k_hi


def needed_macs(fb: CQTFilterbank, cfg: CQTConfig, num_samples: int) -> int:
    """Multiply-adds one window needs (re and im): per bin and frame, the
    nonzero filter rows that meet a nonzero-padded sample (every row with
    reflect padding).  The count behind the operation bound."""
    lo, hi = bin_rows(fb)
    t = n_frames_for(num_samples, cfg.hop_length)
    if cfg.pad_mode == "reflect":
        return int(2 * t * np.sum(hi - lo))
    pad = fb.kernel_width // 2
    starts = pad - np.arange(t) * cfg.hop_length  # audio rows of frame t
    a = np.maximum(lo[:, None], starts[None, :])
    b = np.minimum(hi[:, None], starts[None, :] + num_samples)
    return int(2 * np.sum(np.maximum(b - a, 0)))


def needed_filter_values(
    fb: CQTFilterbank, cfg: CQTConfig, num_samples: int
) -> int:
    """Filter values (re and im) one window needs: per bin, the rows of its
    nonzero span that meet a nonzero-padded sample in some frame (the whole
    span with reflect padding).  The filterbank's term of the byte bound."""
    lo, hi = bin_rows(fb)
    if cfg.pad_mode != "reflect":
        t = n_frames_for(num_samples, cfg.hop_length)
        pad = fb.kernel_width // 2
        lo = np.maximum(lo, pad - (t - 1) * cfg.hop_length)
        hi = np.minimum(hi, pad + num_samples)
    return int(2 * np.sum(np.maximum(hi - lo, 0)))


@dataclass
class KernelPlan:
    """Device tensors and launch parameters for one window length."""

    filt: torch.Tensor
    meta: torch.Tensor
    num_samples: int
    n_frames: int
    n_bins: int
    hop: int
    pad: int
    reflect: bool
    n_groups: int
    n_items: int
    k_lo: int
    k_hi: int
    tile_frames: int
    buf_cap: int
    precision: int
    smem_bytes: int


def make_plan(
    fb: CQTFilterbank, cfg: CQTConfig, num_samples: int, device: torch.device
) -> KernelPlan:
    reflect = cfg.pad_mode == "reflect"
    if reflect and num_samples < 2:
        raise ValueError("reflect padding needs at least 2 samples")
    geom = kernel_geometry(fb)
    hop = cfg.hop_length
    pad = fb.kernel_width // 2
    t = n_frames_for(num_samples, hop)
    tt = TILE_FRAMES
    buf = 0
    for t0 in range(0, t, tt):
        k_lo, k_hi = tile_rows(
            geom, reflect=reflect, pad=pad, hop=hop,
            num_samples=num_samples, t0=t0, tile_frames=tt,
        )
        buf = max(buf, (tt - 1) * hop + max(k_hi - k_lo, 0))
    buf_cap = -(-buf // 4) * 4
    smem = 4 * (buf_cap + geom.n_items * 2 * GROUP * tt)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"CQT kernel tile needs {smem} B of shared memory "
            f"(> {MAX_SMEM_BYTES}); recipe hop {hop}, kernel width "
            f"{fb.kernel_width}"
        )
    filt = pack_filter(fb, geom, cfg.precision)
    return KernelPlan(
        filt=torch.from_numpy(filt).to(device),
        meta=torch.from_numpy(geom.meta()).to(device),
        num_samples=num_samples, n_frames=t, n_bins=fb.n_bins, hop=hop,
        pad=pad, reflect=reflect, n_groups=geom.n_groups,
        n_items=geom.n_items, k_lo=geom.k_lo, k_hi=geom.k_hi,
        tile_frames=tt, buf_cap=buf_cap,
        precision=PRECISION_CODES[cfg.precision], smem_bytes=smem,
    )


# -------------------------------------------------------------------- build


def build() -> tuple[str, str]:
    """Compile ``csrc/cqt.cu`` unless this source is built already.
    Returns the library path and the compiler's log (``-Xptxas -v``:
    registers, shared memory and spills of each kernel)."""
    return nvcc.build(SOURCE, NVCC_FLAGS)


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        fn = lib.cqt_fused_launch
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14
            + [ctypes.c_float] * 5 + [ctypes.c_void_p]
        )
        _lib = lib
    return _lib


# ------------------------------------------------------------------ wrapper


def cqt_fused(x: torch.Tensor, frontend) -> torch.Tensor:
    """[B, N] fp32 audio windows -> [B, n_bins, T] gated dB, computed as
    ``frontend`` (a :class:`.cqt.CQTFrontend`) specifies.

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel.
    Each call on a CUDA tensor adds one to ``launches`` for its two kernels."""
    global launches
    if x.device.type == "cpu":
        return frontend.plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(
            "CQT kernel takes contiguous [B, N] float32 audio, got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    batch, num_samples = x.shape
    plan: KernelPlan = frontend.kernel_plan(num_samples, x.device)
    cfg = frontend.cfg
    out = torch.empty(
        (batch, plan.n_bins, plan.n_frames), device=x.device,
        dtype=torch.float32,
    )
    if batch == 0:
        return out
    fn = _library().cqt_fused_launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            x.data_ptr(), plan.filt.data_ptr(), plan.meta.data_ptr(),
            out.data_ptr(), batch, num_samples, plan.n_frames, plan.n_bins,
            plan.hop, plan.pad, int(plan.reflect), plan.n_groups,
            plan.n_items, plan.k_lo, plan.k_hi, plan.tile_frames,
            plan.buf_cap, plan.precision, cfg.magnitude_power, cfg.amin,
            cfg.top_db, cfg.gate_threshold_db, cfg.gate_floor_db, stream,
        )
    if rc != 0:
        raise RuntimeError(f"CQT kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


# -------------------------------------------------------- raw frame GEMM (B9)


def build_frame_gemm() -> tuple[str, str]:
    """Compile ``csrc/cqt_frame_gemm.cu`` unless this source is built
    already.  Returns the library path and the compiler's ``-Xptxas -v``
    log."""
    return nvcc.build(FRAME_GEMM_SOURCE, NVCC_FLAGS)


def _frame_gemm_library():
    global _frame_gemm_lib
    if _frame_gemm_lib is None:
        path, _ = build_frame_gemm()
        lib = ctypes.CDLL(path)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = lib.cqt_frame_gemm_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p, p, i, ll, i, i, i, i, i, i, p]
        _frame_gemm_lib = lib
    return _frame_gemm_lib


def frame_gemm_splits(rows: int, cols: int, depth: int) -> int:
    """Ranges the kernel cuts the depth into, so that about TARGET_CTAS
    CTAs run; fixed by the shape (two runs add in the same order)."""
    tiles = -(-rows // FRAME_GEMM_TILE) * -(-cols // FRAME_GEMM_TILE)
    most = max(1, depth // (32 * FRAME_GEMM_STEP))  # at least 512 rows a range
    return max(1, min(-(-TARGET_CTAS // tiles), most))


def cqt_frame_gemm(
    padded: torch.Tensor,
    kernels: torch.Tensor,
    *,
    hop_length: int,
    n_frames: int,
    batch_block: int = 16,
    k_tile: int = 2048,
    precision: str = "highest",
) -> torch.Tensor:
    """padded [B, P] fp32, kernels [Kw, 2F] fp32 -> raw coefficients
    [B, n_frames, 2F] fp32 (real block | imag block):
    ``out[b, t] = padded[b, t*hop : t*hop + Kw] @ kernels``, zeros read past
    ``P``.  The port of ``ops/cqt_pallas.py::cqt_frame_gemm``, with its
    signature and its ``ValueError`` when ``B % batch_block``.

    ``batch_block`` and ``k_tile`` are the TPU kernel's VMEM tiling; they
    change nothing on the GPU (``batch_block`` is still checked as there).
    A CPU tensor goes to :func:`.cqt.frame_gemm_plain`; a CUDA tensor to the
    kernel of ``csrc/cqt_frame_gemm.cu``, which raises if it cannot launch.
    Each launch adds one to ``frame_gemm_launches``."""
    global frame_gemm_launches
    if padded.ndim != 2 or kernels.ndim != 2:
        raise ValueError(
            f"expected padded [B, P] and kernels [Kw, 2F], got "
            f"{tuple(padded.shape)} and {tuple(kernels.shape)}"
        )
    b, p = padded.shape
    kw, two_f = kernels.shape
    if b % batch_block:
        raise ValueError(f"batch {b} not divisible by block {batch_block}")
    if precision not in PRECISION_CODES:
        raise ValueError(
            f"precision must be one of {tuple(PRECISION_CODES)}, got {precision!r}"
        )
    if hop_length < 1 or n_frames < 1 or k_tile < 1:
        raise ValueError("hop_length, n_frames and k_tile must be positive")
    if not on_card(padded):
        return frame_gemm_plain(
            padded, kernels, hop_length=hop_length, n_frames=n_frames,
            precision=precision,
        )
    for name, t in (("padded", padded), ("kernels", kernels)):
        if t.device != padded.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"the frame GEMM kernel takes contiguous float32 {name} on "
                f"{padded.device}, got {t.dtype} on {t.device} "
                f"contiguous={t.is_contiguous()}"
            )
    rows = b * n_frames
    if b == 0 or rows > 65535 * FRAME_GEMM_TILE:
        raise ValueError(f"the frame GEMM kernel takes 1 to {65535 * FRAME_GEMM_TILE} "
                         f"rows (B * n_frames), got {rows}")
    out = torch.empty((b, n_frames, two_f), device=padded.device, dtype=torch.float32)
    splits = frame_gemm_splits(rows, two_f, kw)
    partial = (torch.empty((splits, rows, two_f), device=padded.device,
                           dtype=torch.float32) if splits > 1 else None)
    with torch.cuda.device(padded.device):
        rc = _frame_gemm_library().cqt_frame_gemm_launch(
            padded.data_ptr(), kernels.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(), b, p, n_frames,
            hop_length, kw, two_f, splits, PRECISION_CODES[precision],
            torch.cuda.current_stream(padded.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"CQT frame GEMM kernel launch failed: CUDA error {rc}")
    frame_gemm_launches += 1
    return out
