"""The fused CQT kernel for Hopper (``csrc/cqt.cu``): host plan, build and
wrapper.

The kernel replaces the JAX package's TPU kernel
``ops/cqt_pallas.py::cqt_fused_split_chunked``; it takes any hop and either
padding mode, so it also computes what ``cqt_fused`` and
``cqt_fused_split`` compute there.  ``csrc/cqt.cu`` explains its design
and its bound.

The source is compiled with ``nvcc`` on first use into ``_build/`` beside
the package (listed in ``.gitignore``), named by a hash of the source and
flags, and loaded through ``ctypes``.  Nothing is compiled or loaded when
this module is imported.

:func:`cqt_fused` is the wrapper: a CPU tensor goes to the plain version
(:func:`.cqt.cqt_plain`), a CUDA tensor to the kernel, which raises if it
cannot launch.  ``launches`` counts the wrapper's launches of the fused
transform; each is one call of ``cqt_fused_launch``, which enqueues two
kernels (the coefficients, then the per-window dB epilogue).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass

import numpy as np
import torch

from ..config import CQTConfig
from .cqt_kernels import CQTFilterbank, n_frames_for

GROUP = 4  # bins per work item; csrc/cqt.cu kGroup
CHUNK = 4096  # filter rows per work item
TILE_FRAMES = 9  # frames per CTA; csrc/cqt.cu kTileFrames
PRECISION_CODES = {"highest": 0, "bf16x3": 1, "default": 2}
MAX_SMEM_BYTES = 232448  # dynamic shared memory a Hopper CTA may use

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "cqt.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches = 0  # fused launches since import (or since a caller reset it)
_lib = None


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


def nvcc_path() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libcqt_{tag.hexdigest()[:16]}.so")


def build() -> tuple[str, str]:
    """Compile ``csrc/cqt.cu`` unless this source is built already.
    Returns the library path and the compiler's log (``-Xptxas -v``:
    registers, shared memory and spills of each kernel)."""
    path = library_path()
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{proc.stderr}"
        )
    os.replace(tmp, path)
    return path, proc.stderr


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
