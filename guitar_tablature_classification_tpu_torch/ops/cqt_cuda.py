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
cannot launch.  :func:`cqt_route` picks the kernel by tier, hop and
batch: the tensor-core kernel (``cqt_fused_mma_launch``, plan
:func:`make_mma_plan`; ``highest`` and ``bf16x3`` on three and two bf16
pieces of each operand) runs ``default`` at any hop, ``bf16x3`` at a hop
that is a multiple of 8, and ``highest`` there where its grid fills the
card's waves (``MMA_MIN_FILL``); the rest runs the SIMT kernel
(``cqt_fused_launch``, plan :func:`make_plan`).  ``launches``
counts the wrapper's launches of the fused transform, ``mma_launches``
those on the tensor cores and ``mma_launches_by_tier`` the same by tier;
each launch enqueues two kernels (the coefficients, then the per-window dB
epilogue).

:func:`cqt_frame_gemm` is the port of the TPU kernel
``ops/cqt_pallas.py::cqt_frame_gemm`` and, as there, its own entry point:
raw coefficients ``[B, T, 2F]`` with no epilogue, for any filterbank.  It
is built from its own source (``build_frame_gemm``) and counted in
``frame_gemm_launches``, and by tier in ``frame_gemm_mma_launches`` where
it ran on the tensor cores: every tier at a hop that is a multiple of 8
(the ring kernels on bf16 pieces of the operands, :func:`frame_gemm_copies`),
``default`` at any hop.
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
# the tensor-core kernels: rows, columns and filter rows a step
FRAME_GEMM_MMA_TILE = (128, 96, 32)  # csrc/cqt_frame_gemm.cu kMM, kMN, kMK
# bf16 pieces of each operand the tensor-core kernels take at a tier (the
# fused CQT's cqt_mma_kernel<ldm, parts>, the frame GEMM's
# frame_gemm_ring_kernel<parts>)
FRAME_GEMM_PARTS = {"highest": 3, "bf16x3": 2, "default": 1}
# the products of pieces (A piece, B piece) each tier issues, in both
# kernels' order (csrc/frame_mma.cuh prod_a, prod_b)
FRAME_GEMM_PRODUCTS = {
    "highest": ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0)),
    "bf16x3": ((1, 0), (0, 1), (0, 0)),
    "default": ((0, 0),),
}
SMS = 132  # the H100's SMs
TARGET_CTAS = 2 * SMS  # two CTAs on each SM

launches = 0  # fused launches since import (or since a caller reset it)
mma_launches = 0  # those of them on the tensor-core kernel
mma_launches_by_tier = {p: 0 for p in PRECISION_CODES}  # the same, by tier
frame_gemm_launches = 0  # cqt_frame_gemm launches, counted the same way
frame_gemm_mma_launches = {p: 0 for p in PRECISION_CODES}  # those on the tensor cores, by tier
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


# ------------------------------------------------- tensor-core plan

MMA_BAND_GROUPS = 4  # bin groups a band (a unit's columns); csrc/cqt.cu kBandGroups
MMA_UNIT_ROWS = 64  # rows a unit at one piece (four m16 tiles); csrc/cqt.cu unit_tiles
MMA_MAX_GROUPS = 64  # csrc/cqt.cu kMaxGroups (its static shared table)
MMA_MAX_ROWS = 128  # (window, frame) rows per CTA at most
MMA_PART_BYTES = MMA_UNIT_ROWS * 8 * MMA_BAND_GROUPS * 4  # one unit's partial sums at one piece
MMA_SMEM_BUDGET = MAX_SMEM_BYTES - 1024  # the rest: the kernel's static table
# the least share of its waves' SM slots a highest grid must fill to take
# the tensor cores (cqt_route): on the card it won at fills 0.73-0.97 and
# lost at 0.55-0.65 (chip_smoke.py's CQT route sweep)
MMA_MIN_FILL = 0.7


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def mma_takes(precision: str, hop: int) -> bool:
    """Whether ``cqt_mma_kernel`` runs the tier at this hop: ``default`` at
    any hop, ``highest`` and ``bf16x3`` at a hop that is a multiple of 8
    (elsewhere their staged bf16 pieces would lose ldmatrix's 16-byte
    rows)."""
    return precision == "default" or hop % 8 == 0


def cqt_route(precision: str, hop: int, batch: int, plan: MmaPlan | None = None) -> str:
    """The kernel a :func:`cqt_fused` call on ``batch`` windows runs: ``mma``
    (``cqt_mma_kernel`` on the tensor cores) or ``simt``
    (``cqt_coeff_kernel``).  ``default`` and ``bf16x3`` take the tensor
    cores wherever :func:`mma_takes` says so (they win at every measured
    shape).  ``highest`` takes them only where ``plan`` (the tensor-core
    plan of the window length) puts at least 2 windows in a CTA and fills
    its waves of ``SMS`` CTAs to ``MMA_MIN_FILL`` or more: its CTAs
    out-run the SIMT kernel's per SM, by about 1.3x at the training
    recipe, but one CTA holds an SM for the whole of a wave, so a grid
    that leaves many SMs idle in its last wave (the flagship's 86 CTAs at
    B=256), or a plan that reads the whole filter for each window
    (reflect padding), runs slower than the SIMT kernel."""
    if not mma_takes(precision, hop):
        return "simt"
    if precision != "highest":
        return "mma"
    if plan is None:
        raise ValueError("cqt_route: highest needs the tensor-core plan")
    ctas = plan.n_ctas(batch)
    fill = ctas / (SMS * _cdiv(ctas, SMS)) if ctas else 1.0
    return "mma" if plan.shape.windows >= 2 and fill >= MMA_MIN_FILL else "simt"


def mma_warps(parts: int) -> int:
    """Warps a CTA of the tensor-core kernel with ``parts`` bf16 pieces
    (csrc/cqt.cu mma_threads), one CTA an SM: 16 at one piece, 12 at two
    (bf16x3, up to 168 registers a thread) and 8 at three (highest, up to
    255), whose round-to-nearest totals and fragments of every piece take
    the registers."""
    return {1: 16, 2: 12, 3: 8}[parts]


def mma_unit_rows(parts: int) -> int:
    """Rows a unit of the tensor-core kernel with ``parts`` bf16 pieces
    (csrc/cqt.cu unit_tiles): 64 (four m16 tiles) at one piece, 32 at two or
    three, whose fragments of every piece take the registers and whose CTAs
    hold few rows."""
    return MMA_UNIT_ROWS if parts == 1 else MMA_UNIT_ROWS // 2


def mma_part_bytes(parts: int) -> int:
    """Shared bytes of one unit's partial sums: its rows x (re, im) x 4
    bins x the band's groups, fp32."""
    return mma_unit_rows(parts) * 8 * MMA_BAND_GROUPS * 4


@dataclass(frozen=True)
class MmaGeometry:
    """The tensor-core kernel's packed filterbank: group g (``GROUP`` bins)
    covers the 16-row chunks ``[c_lo[g], c_hi[g])`` of the filter rows,
    the union of its bins' nonzero rows rounded out to the 16-row grid,
    stored as blocks ``blk_off[g] ..`` of the fragment-order filter.  A band
    is ``MMA_BAND_GROUPS`` consecutive groups."""

    c_lo: np.ndarray
    c_hi: np.ndarray
    blk_off: np.ndarray

    @property
    def n_groups(self) -> int:
        return len(self.c_lo)

    @property
    def n_bands(self) -> int:
        return _cdiv(self.n_groups, MMA_BAND_GROUPS)

    def meta(self) -> np.ndarray:
        """The int32 group table the kernel reads (layout in csrc/cqt.cu;
        the plan appends the pieces per band)."""
        return np.concatenate([self.c_lo, self.c_hi, self.blk_off]).astype(np.int32)

    def nested(self) -> bool:
        """Whether within each band the groups' chunk ranges nest, each in
        the one before (csrc/cqt.cu walks a band's chunks in segments of
        1, 2, 3, 4, 3, 2, 1 live groups)."""
        for b in range(self.n_bands):
            g = slice(b * MMA_BAND_GROUPS, (b + 1) * MMA_BAND_GROUPS)
            if np.any(np.diff(self.c_lo[g]) < 0) or np.any(np.diff(self.c_hi[g]) > 0):
                return False
        return True

    def chunks(self, band: int | None = None) -> tuple[int, int]:
        """The chunk range of a band's groups, or of all groups."""
        g = slice(None) if band is None else slice(
            band * MMA_BAND_GROUPS, (band + 1) * MMA_BAND_GROUPS)
        return int(self.c_lo[g].min()), int(self.c_hi[g].max())


def mma_geometry(fb: CQTFilterbank) -> MmaGeometry:
    geom = kernel_geometry(fb)
    c_lo = geom.group_lo // 16
    c_hi = -(-geom.group_hi // 16)
    blk_off = np.concatenate([[0], np.cumsum(c_hi - c_lo)[:-1]])
    i32 = lambda a: np.asarray(a, dtype=np.int32)  # noqa: E731
    return MmaGeometry(i32(c_lo), i32(c_hi), i32(blk_off))


_LANE_K = 2 * (np.arange(32) % 4)[:, None] + np.array([0, 1, 8, 9])[None, :]  # [32, 4]
_LANE_N = np.broadcast_to((np.arange(32) // 4)[:, None], (32, 4))


def pack_filter_mma(fb: CQTFilterbank, geom: MmaGeometry, parts: int = 1) -> np.ndarray:
    """The filterbank's ``parts`` bf16 pieces (nearest even: piece 0 is the
    value rounded, each next one what the pieces before it leave, rounded;
    ``parts`` = 2 gives :func:`.cqt.split_bf16`'s hi and lo), as uint16
    bits ``[parts * blocks, 32 lanes, 4]``, piece after piece, each in the
    mma B-fragment order: block (g, c), lane l holds rows ``16c + 2(l%4) +
    (0, 1, 8, 9)`` of column ``l // 4``, where column ``2j`` is the real and
    ``2j + 1`` the imaginary part of bin ``4g + j``.  Rows past the filter
    and bins past ``n_bins`` are zero."""
    from .cqt import round_bf16

    n_pad = geom.n_groups * GROUP - fb.n_bins
    kw = fb.kernel_width
    rows = max(int(geom.c_hi.max()) * 16, kw)
    cols = np.zeros((rows, 2 * geom.n_groups * GROUP), np.float32)
    cols[:kw, 0::2] = np.pad(fb.kernels_real, ((0, 0), (0, n_pad)))
    cols[:kw, 1::2] = np.pad(fb.kernels_imag, ((0, 0), (0, n_pad)))
    rest = torch.from_numpy(cols)
    blocks = []
    for _ in range(parts):
        piece = round_bf16(rest)
        rest = rest - piece  # exact: the piece is the rest rounded
        bits = piece.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
        for g in range(geom.n_groups):  # bits: [rows, (re, im) x bins]
            c = np.arange(geom.c_lo[g], geom.c_hi[g])
            blocks.append(bits[16 * c[:, None, None] + _LANE_K[None], 8 * g + _LANE_N[None]])
    return np.ascontiguousarray(np.concatenate(blocks))


def mma_skew(hop: int) -> int:
    """Samples the staged audio skips after every ``hop``: a multiple of 8
    that makes a row step of ``hop + skew`` bf16 values 16 bytes past a
    multiple of 128, so an ldmatrix's 8 frames hit 8 bank groups.  0 when
    ``hop`` is not a multiple of 8 (the kernel's 16-bit load path)."""
    return (8 - hop) % 64 if hop % 8 == 0 else 0


def mma_tile_chunks(geom: MmaGeometry, *, reflect: bool, pad: int, hop: int,
                    num_samples: int, t0: int, frames: int,
                    band: int | None = None) -> tuple[int, int]:
    """The chunks ``[c_a, c_b)`` a CTA at frame tile ``t0`` contracts, of
    all groups (its staged audio) or of one band: with constant padding,
    only chunks that meet the audio in some frame of the tile (csrc/cqt.cu
    computes the same)."""
    c_s, c_e = geom.chunks()
    if not reflect:
        c_s = max(c_s, (pad - (t0 + frames - 1) * hop) // 16)
        c_e = max(min(c_e, _cdiv(pad + num_samples - t0 * hop, 16)), c_s)
    if band is None:
        return c_s, c_e
    c_a, c_b = geom.chunks(band)
    c_a = max(c_a, c_s)
    return c_a, max(min(c_b, c_e), c_a)


def _skewed_len(n: int, hop: int, skew: int) -> int:
    """Elements a buffer of n samples takes with the skew."""
    return n + skew * ((n - 1) // hop) if n else 0


def mma_stage_span(geom: MmaGeometry, *, reflect: bool, pad: int, hop: int,
                   num_samples: int, t0: int, frames: int) -> tuple[int, int, int, int]:
    """What a CTA at frame tile ``t0`` stages of each window: buffer
    indices ``[i0, i1)`` (8-aligned) of ``[0, len)``, where index i holds
    padded audio ``t0*hop + 16 c_s + i``, and the audio part ``[i_lo,
    i_hi)`` of them (csrc/cqt.cu computes the same)."""
    c_s, c_e = mma_tile_chunks(geom, reflect=reflect, pad=pad, hop=hop,
                               num_samples=num_samples, t0=t0, frames=frames)
    length = (frames - 1) * hop + 16 * (c_e - c_s)
    i_lo, i_hi = 0, length
    if not reflect:
        p0 = t0 * hop + 16 * c_s - pad
        i_lo = min(max(-p0, 0), length)
        i_hi = max(min(num_samples - p0, length), i_lo)
    i0 = i_lo // 8 * 8
    return i0, max(_cdiv(i_hi, 8) * 8, i0), i_lo, i_hi


@dataclass(frozen=True)
class MmaShape:
    """The CTA: ``windows`` x ``frames`` rows (m16 tiles, four to a unit),
    band b's chunks cut into ``pieces[b]``; for each of the tier's
    ``parts`` bf16 pieces of the audio ``wstride`` values per staged window,
    then 8 zeros (``piece_stride`` values a piece); the partial sums from
    byte ``part_off``; ``warps`` warps."""

    windows: int
    frames: int
    pieces: tuple[int, ...]
    wstride: int
    part_off: int
    smem_bytes: int
    parts: int = 1

    @property
    def warps(self) -> int:
        return mma_warps(self.parts)

    @property
    def piece_stride(self) -> int:
        return self.windows * self.wstride + 8

    @property
    def unit_rows(self) -> int:
        return mma_unit_rows(self.parts)

    @property
    def part_bytes(self) -> int:
        return mma_part_bytes(self.parts)

    @property
    def row_units(self) -> int:
        return _cdiv(self.windows * self.frames, self.unit_rows)

    @property
    def units(self) -> int:
        return self.row_units * sum(self.pieces)


def _split_pieces(work: list[float], units_m: int, n_units: int) -> tuple[int, ...]:
    """Pieces per band for about ``n_units`` units: each band one, then a
    piece more to the band whose pieces are the largest, while it fits."""
    pieces = [1] * len(work)
    while units_m * (sum(pieces) + 1) <= n_units:
        b = max(range(len(work)), key=lambda i: work[i] / pieces[i])
        pieces[b] += 1
    return tuple(pieces)


def mma_shape(geom: MmaGeometry, *, reflect: bool, pad: int, hop: int, num_samples: int,
              n_frames: int, parts: int = 1, budget: int = MMA_SMEM_BUDGET) -> MmaShape:
    """The CTA shape from the shared-memory budget: of the (frames,
    windows, units) that fit ``budget`` bytes with the tier's ``parts``
    staged copies of the audio, with at most ``MMA_MAX_ROWS`` rows, the one
    with the least modelled SM time a window (more windows, then fewer
    units, on a tie).  The units are cut from the bands by
    :func:`_split_pieces` on each band's chunks x the groups a chunk feeds.
    The model, in SM clocks of one CTA of ``w`` = :func:`mma_warps` warps:
    staging, W x (staged samples) / (4 w); products, the larger of the
    biggest unit and the units' sum over the w warps, a chunk costing (the
    m16 tiles a unit holds x the groups it feeds x the tier's products x 8
    clocks an mma.sync + 40 clocks a piece of its other instructions) x
    w / 4 warps a sub-partition."""
    skew = mma_skew(hop)
    warps, unit_rows, part_bytes = mma_warps(parts), mma_unit_rows(parts), mma_part_bytes(parts)
    products_n = {1: 1, 2: 3, 3: 6}[parts]  # len(FRAME_GEMM_PRODUCTS[tier])
    kw = dict(reflect=reflect, pad=pad, hop=hop, num_samples=num_samples)
    best, best_key = None, None
    for frames in range(n_frames, 0, -1):
        need, band_work = 0, []
        tiles = range(0, n_frames, frames)
        for t0 in tiles:
            i0, i1, _, _ = mma_stage_span(geom, t0=t0, frames=frames, **kw)
            need = max(need, i1 - i0)
        for band in range(geom.n_bands):
            nc, feeds = 0, 0.0
            g = slice(band * MMA_BAND_GROUPS, (band + 1) * MMA_BAND_GROUPS)
            for t0 in tiles:
                c_a, c_b = mma_tile_chunks(geom, t0=t0, frames=frames, band=band, **kw)
                live = np.minimum(geom.c_hi[g], c_b) - np.maximum(geom.c_lo[g], c_a)
                nc = max(nc, c_b - c_a)
                feeds = max(feeds, np.maximum(live, 0).sum() / max(c_b - c_a, 1))
            band_work.append((nc, feeds))
        wstride = _cdiv(_skewed_len(need, hop, skew), 64) * 64 + 8
        for windows in range(1, max(1, MMA_MAX_ROWS // frames) + 1):
            units_m = _cdiv(windows * frames, unit_rows)
            tiles_u = min(unit_rows // 16, _cdiv(windows * frames, 16))
            part_off = _cdiv(2 * parts * (windows * wstride + 8), 16) * 16  # + the zero blocks
            chunk = [tiles_u * f * 8 * products_n + 40 * parts for _, f in band_work]
            work = [nc * c for (nc, _), c in zip(band_work, chunk)]
            for n_units in range(units_m * geom.n_bands, 2 * warps + 1):
                pieces = _split_pieces(work, units_m, n_units)
                units = units_m * sum(pieces)
                smem = part_off + units * part_bytes
                if smem > budget:
                    break
                biggest = max(_cdiv(nc, p) * c for (nc, _), p, c in
                              zip(band_work, pieces, chunk))
                products = max(biggest, units_m * sum(work) / warps) * (warps / 4)
                clocks = windows * need / (4 * warps) + products
                key = (_cdiv(n_frames, frames) * clocks / windows, -windows, units)
                if best_key is None or key < best_key:
                    best_key = key
                    best = MmaShape(windows, frames, pieces, wstride, part_off, smem, parts)
    if best is None:
        raise ValueError(f"no CQT tensor-core tile fits {budget} B of shared memory "
                         f"(hop {hop}, kernel width {16 * geom.chunks()[1]})")
    return best


@dataclass
class MmaPlan:
    """Device tensors and launch parameters of the tensor-core kernel at a
    tier for one window length (``filt``: the shape's ``parts`` pieces of
    ``piece_blocks`` blocks each)."""

    filt: torch.Tensor
    gmeta: torch.Tensor
    geom: MmaGeometry
    shape: MmaShape
    num_samples: int
    n_frames: int
    n_bins: int
    hop: int
    pad: int
    reflect: bool
    skew: int
    piece_blocks: int

    def n_ctas(self, batch: int) -> int:
        return _cdiv(self.n_frames, self.shape.frames) * _cdiv(batch, self.shape.windows)


def make_mma_plan(
    fb: CQTFilterbank, cfg: CQTConfig, num_samples: int, device: torch.device
) -> MmaPlan:
    reflect = cfg.pad_mode == "reflect"
    if reflect and num_samples < 2:
        raise ValueError("reflect padding needs at least 2 samples")
    if not mma_takes(cfg.precision, cfg.hop_length):
        raise ValueError(f"the CQT tensor-core kernel takes {cfg.precision} only at a hop "
                         f"that is a multiple of 8, got {cfg.hop_length}")
    parts = FRAME_GEMM_PARTS[cfg.precision]
    geom = mma_geometry(fb)
    if geom.n_groups > MMA_MAX_GROUPS:
        raise ValueError(f"the CQT tensor-core kernel takes at most "
                         f"{GROUP * MMA_MAX_GROUPS} bins, got {fb.n_bins}")
    if not geom.nested():
        raise ValueError("the CQT tensor-core kernel needs each band's group spans to "
                         "nest (the kernels shorten with frequency about one centre)")
    hop, pad = cfg.hop_length, fb.kernel_width // 2
    t = n_frames_for(num_samples, hop)
    shape = mma_shape(geom, reflect=reflect, pad=pad, hop=hop, num_samples=num_samples,
                      n_frames=t, parts=parts)
    filt = pack_filter_mma(fb, geom, parts).view(np.int16)
    meta = np.concatenate([geom.meta(), np.asarray(shape.pieces, np.int32)])
    return MmaPlan(
        filt=torch.from_numpy(filt).to(device),
        gmeta=torch.from_numpy(meta).to(device),
        geom=geom, shape=shape, num_samples=num_samples, n_frames=t, n_bins=fb.n_bins,
        hop=hop, pad=pad, reflect=reflect, skew=mma_skew(hop),
        piece_blocks=int((geom.c_hi - geom.c_lo).sum()),
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
        fn = lib.cqt_fused_mma_launch
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 16
            + [ctypes.c_float] * 5 + [ctypes.c_void_p]
        )
        lib.cqt_mma_kernel_info.restype = ctypes.c_int
        lib.cqt_mma_kernel_info.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_int)]
        _lib = lib
    return _lib


_INFO_KEYS = ("registers", "local_bytes", "shared_bytes", "threads", "ctas_per_sm")


def mma_kernel_info(plan: MmaPlan) -> dict[str, int]:
    """The tensor-core kernel of ``plan``'s tier (its count of pieces) as
    the card runs it at the plan's shared bytes: registers a thread, local
    (spill) bytes a thread, shared bytes a CTA, threads a CTA, resident
    CTAs per SM."""
    info = (ctypes.c_int * 5)()
    rc = _library().cqt_mma_kernel_info(plan.shape.parts, plan.shape.smem_bytes, info)
    if rc != 0:
        raise RuntimeError(f"cqt_mma_kernel_info failed: CUDA error {rc}")
    return dict(zip(_INFO_KEYS, info))


# ------------------------------------------------------------------ wrapper


def cqt_fused(x: torch.Tensor, frontend, route: str | None = None) -> torch.Tensor:
    """[B, N] fp32 audio windows -> [B, n_bins, T] gated dB, computed as
    ``frontend`` (a :class:`.cqt.CQTFrontend`) specifies.

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel of
    :func:`cqt_route`, or of ``route`` where the caller names one (to time
    one kernel against the other; ``mma`` raises where :func:`mma_takes`
    says no).  Each call on a CUDA tensor adds one to ``launches`` for its
    two kernels, and on the tensor cores one to ``mma_launches`` and to
    ``mma_launches_by_tier`` at its tier."""
    global launches, mma_launches
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
    plan = frontend.kernel_plan(num_samples, x.device,
                                route or frontend.route(batch, num_samples, x.device))
    cfg = frontend.cfg
    out = torch.empty(
        (batch, plan.n_bins, plan.n_frames), device=x.device,
        dtype=torch.float32,
    )
    if batch == 0:
        return out
    if isinstance(plan, MmaPlan):
        _launch_mma(x, plan, cfg, out)
        mma_launches += 1
        mma_launches_by_tier[cfg.precision] += 1
        launches += 1
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


def _launch_mma(x: torch.Tensor, plan: MmaPlan, cfg: CQTConfig, out: torch.Tensor) -> None:
    sh = plan.shape
    with torch.cuda.device(x.device):
        rc = _library().cqt_fused_mma_launch(
            x.data_ptr(), plan.filt.data_ptr(), plan.gmeta.data_ptr(), out.data_ptr(),
            x.shape[0], plan.num_samples, plan.n_frames, plan.n_bins, plan.hop, plan.pad,
            int(plan.reflect), plan.geom.n_groups, plan.skew, sh.windows, sh.frames,
            sh.wstride, sh.part_off, sh.smem_bytes, sh.parts, plan.piece_blocks,
            cfg.magnitude_power,
            cfg.amin, cfg.top_db, cfg.gate_threshold_db, cfg.gate_floor_db,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"CQT tensor-core kernel launch failed: CUDA error {rc}")


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
        fn.argtypes = [p, p, p, p, p, p, i, ll, i, i, i, i, i, i, ll, p]
        lib.frame_gemm_mma_kernel_info.restype = ctypes.c_int
        lib.frame_gemm_mma_kernel_info.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
        _frame_gemm_lib = lib
    return _frame_gemm_lib


def frame_gemm_mma_kernel_info() -> dict[str, dict[str, int]]:
    """The frame GEMM's tensor-core kernels as the card runs them (the keys
    of :func:`mma_kernel_info`): ``ring`` (default), ``fp32_loads``
    (default at a hop off the 8-grid), ``ring_bf16x3`` and ``ring_highest``."""
    out = {}
    for which, name in enumerate(("ring", "fp32_loads", "ring_bf16x3", "ring_highest")):
        info = (ctypes.c_int * 5)()
        rc = _frame_gemm_library().frame_gemm_mma_kernel_info(which, info)
        if rc != 0:
            raise RuntimeError(f"frame_gemm_mma_kernel_info failed: CUDA error {rc}")
        out[name] = dict(zip(_INFO_KEYS, info))
    return out


def frame_gemm_route(precision: str, hop: int) -> str:
    """The kernel a call runs: ``ring`` (tensor cores on bf16 pieces, hop a
    multiple of 8), ``fp32_loads`` (default tier, any other hop) or
    ``simt`` (highest and bf16x3 at any other hop)."""
    if hop % 8 == 0:
        return "ring"
    return "fp32_loads" if precision == "default" else "simt"


def frame_gemm_tile(precision: str = "highest", ring: bool = False) -> tuple[int, int, int]:
    """(rows, columns, filter rows a step) of the kernel's CTA at a tier;
    ``ring``: the hop is a multiple of 8."""
    if precision == "default" or ring:
        return FRAME_GEMM_MMA_TILE
    return FRAME_GEMM_TILE, FRAME_GEMM_TILE, FRAME_GEMM_STEP


def frame_gemm_splits(rows: int, cols: int, depth: int, precision: str = "highest",
                      ring: bool = False) -> int:
    """Ranges the kernel cuts the depth into; fixed by the shape, tier and
    kernel (two runs add in the same order), each at least 512 rows.  The
    SIMT kernel: about TARGET_CTAS CTAs.  The default tier's tensor-core
    kernels: at most TARGET_CTAS (one wave of two an SM).  The split tiers'
    ring kernels (one CTA an SM): the count whose last wave is fullest, the
    least waves per unit of depth, the fewer ranges on a tie."""
    bm, bn, _ = frame_gemm_tile(precision, ring)
    tiles = _cdiv(rows, bm) * _cdiv(cols, bn)
    most = max(1, depth // 512)  # at least 512 rows a range
    if precision == "default":
        fill = TARGET_CTAS // tiles
    elif ring:
        return min(range(1, most + 1), key=lambda n: (_cdiv(tiles * n, SMS) / n, n))
    else:
        fill = _cdiv(TARGET_CTAS, tiles)
    return max(1, min(fill, most))


def frame_gemm_copies(p: int, n_frames: int, hop: int, kw: int, n: int,
                      precision: str) -> tuple[int, int, int] | None:
    """(P8, K32, N96) of the bf16 copies the ring kernels read (each of the
    tier's FRAME_GEMM_PARTS pieces of the audio in rows of P8, of the
    filterbank in K32 rows and N96 columns, zero padded;
    csrc/cqt_frame_gemm.cu), or None where they do not run: a hop that is
    not a multiple of 8."""
    if frame_gemm_route(precision, hop) != "ring":
        return None
    _, bn, bk = FRAME_GEMM_MMA_TILE
    k32 = _cdiv(kw, bk) * bk
    p8 = _cdiv(max(p, (n_frames - 1) * hop + k32), 8) * 8
    return p8, k32, _cdiv(n, bn) * bn


def frame_gemm_ranges(depth: int, splits: int, precision: str = "highest",
                      ring: bool = False) -> list[tuple[int, int]]:
    """The depth ranges [k_begin, k_end) of the splits, as
    ``cqt_frame_gemm_launch`` cuts them (each a multiple of the step long;
    trailing ranges may be empty)."""
    step = frame_gemm_tile(precision, ring)[2]
    chunk = _cdiv(_cdiv(depth, splits), step) * step
    return [(min(depth, z * chunk), min(depth, (z + 1) * chunk)) for z in range(splits)]


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
    Each launch adds one to ``frame_gemm_launches``, and one to
    ``frame_gemm_mma_launches[precision]`` where it ran on the tensor cores
    (:func:`frame_gemm_route`)."""
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
    route = frame_gemm_route(precision, hop_length)
    splits = frame_gemm_splits(rows, two_f, kw, precision, ring=route == "ring")
    partial = (torch.empty((splits, rows, two_f), device=padded.device,
                           dtype=torch.float32) if splits > 1 else None)
    copies = frame_gemm_copies(p, n_frames, hop_length, kw, two_f, precision)
    abf = kbf = None
    if copies is not None:
        p8, k32, n96 = copies
        parts = FRAME_GEMM_PARTS[precision]
        abf = torch.empty(parts * b * p8, device=padded.device, dtype=torch.bfloat16)
        kbf = torch.empty(parts * k32 * n96, device=padded.device, dtype=torch.bfloat16)
    with torch.cuda.device(padded.device):
        rc = _frame_gemm_library().cqt_frame_gemm_launch(
            padded.data_ptr(), kernels.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if abf is None else abf.data_ptr(), None if kbf is None else kbf.data_ptr(),
            b, p, n_frames, hop_length, kw, two_f, splits, PRECISION_CODES[precision],
            0 if copies is None else copies[0],
            torch.cuda.current_stream(padded.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"CQT frame GEMM kernel launch failed: CUDA error {rc}")
    frame_gemm_launches += 1
    if route != "simt":
        frame_gemm_mma_launches[precision] += 1
    return out
