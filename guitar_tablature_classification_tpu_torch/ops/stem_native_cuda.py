"""The fused native stem-tail kernels for Hopper (``csrc/stem_native.cu``,
and ``csrc/bn.cu``'s column sums): build and wrappers.

They replace the JAX package's three TPU kernels of ``ops/stem_native.py``:
``_stats_pallas`` (:func:`stats`, served by the column sums of
:mod:`.bn_cuda`), ``_fwd_pallas`` (:func:`fwd`) and ``_bwd_pallas``
(:func:`bwd`).  ``csrc/stem_native.cu`` explains their design and bound;
:mod:`.stem_native` holds the plain versions and the ``autograd.Function``s
that call these wrappers for CUDA tensors.

The source is built with ``nvcc`` on first use (:mod:`.nvcc`), with
``-fmad=false``, and loaded through ``ctypes``; nothing is compiled or
loaded when this module is imported.  ``launches`` counts each wrapper's
launches.  :func:`stats` and :func:`bwd` enqueue two kernels per launch (the
per-CTA partial sums, then their fixed-order reduction); each counts as one.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import bn_cuda, nvcc

SOURCE = os.path.join(nvcc.CSRC_DIR, "stem_native.cu")
NVCC_FLAGS = nvcc.BASE_FLAGS + ("-fmad=false",)
THREADS = 256  # csrc/stem_native.cu kThreads
VEC_FWD, VEC_BWD = 8, 2  # channels per thread of each kernel
MAX_WP = 6  # widest plane in columns (csrc/stem_native.cu kMaxWp)
MAX_PARTS = 1024  # CTAs that write partial sums (fixed: deterministic sums)
MAX_FWD_CTAS = 132 * 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"native_stats": 0, "native_fwd": 0, "native_bwd": 0}
_lib = None


def build() -> tuple[str, str]:
    """Compile ``csrc/stem_native.cu`` unless this source is built already.
    Returns the library path and the compiler's ``-Xptxas -v`` log."""
    return nvcc.build(SOURCE, NVCC_FLAGS)


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.native_fwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.native_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        for fn in (lib.native_fwd_launch, lib.native_bwd_launch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_planes(ye: torch.Tensor, yo: torch.Tensor, c: int, vec: int) -> tuple[int, int, int]:
    """(B, H2, Wp) of the parity planes [B, H2, Wp*C]."""
    for name, t in (("ye", ye), ("yo", yo)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must lie on a CUDA device, got {t.device}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name}: the native stem kernels take float32 or bfloat16, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % (vec * t.element_size()):
            raise ValueError(f"{name} must be aligned to {vec} elements")
    if ye.ndim != 3 or yo.shape != ye.shape or yo.dtype != ye.dtype or yo.device != ye.device:
        raise ValueError(f"ye and yo must be [B, H2, Wp*C] of one dtype and device, got "
                         f"{tuple(ye.shape)} and {tuple(yo.shape)}")
    b, h2, lanes = ye.shape
    wp = lanes // c
    if wp * c != lanes or not 1 <= wp <= MAX_WP:
        raise ValueError(f"lanes {lanes} are not Wp*C with C={c} and Wp <= {MAX_WP}")
    if c % VEC_FWD or THREADS % (c // VEC_BWD):
        raise ValueError(f"the native stem kernels need C % 8 == 0 and "
                         f"{THREADS} % (C/2) == 0, got C={c}")
    return b, h2, wp


def _check_affine(se: torch.Tensor, oe: torch.Tensor, c: int, device) -> None:
    for name, t in (("se", se), ("oe", oe)):
        if t.shape != (c,) or t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"{name} must be [{c}] float32 on {device}, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_wreal(wreal: int, wp: int) -> int:
    if not 1 <= wreal <= wp:
        raise ValueError(f"wreal must lie in [1, {wp}], got {wreal}")
    return (wreal - 1) // 2 + 1


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_if(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def stats(ye: torch.Tensor, yo: torch.Tensor) -> torch.Tensor:
    """Parity planes [B, H2, L] -> [2, L] fp32 per lane: sum and sum of
    squares over both planes (pad columns included; the caller folds)."""
    if ye.shape != yo.shape or ye.ndim != 3:
        raise ValueError(f"ye and yo must be [B, H2, L] of one shape, got "
                         f"{tuple(ye.shape)} and {tuple(yo.shape)}")
    for name, t in (("ye", ye), ("yo", yo)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, h2, lanes = ye.shape
    out = bn_cuda.column_sums([ye, yo], b * h2, lanes, 1, lanes)
    launches["native_stats"] += 1
    return out


def fwd(ye: torch.Tensor, yo: torch.Tensor, se: torch.Tensor, oe: torch.Tensor,
        wreal: int) -> torch.Tensor:
    """max_pool3x3s2(relu(y*se + oe)) over the real columns -> pooled
    [B, H2, Wout, C] in y's dtype; se/oe [C] fp32."""
    c = se.shape[0]
    b, h2, wp = _check_planes(ye, yo, c, VEC_FWD)
    _check_affine(se, oe, c, ye.device)
    wout = _check_wreal(wreal, wp)
    out = torch.empty((b, h2, wout, c), device=ye.device, dtype=ye.dtype)
    ctas = max(1, min(MAX_FWD_CTAS, -(-b * h2 * wout * (c // VEC_FWD) // THREADS)))
    with torch.cuda.device(ye.device):
        rc = _library().native_fwd_launch(
            ye.data_ptr(), yo.data_ptr(), se.data_ptr(), oe.data_ptr(), out.data_ptr(),
            b, h2, wp, wreal, c, ctas, _DTYPES[ye.dtype], _stream(ye.device),
        )
    _raise_if(rc, "native stem forward")
    launches["native_fwd"] += 1
    return out


def bwd(ye: torch.Tensor, yo: torch.Tensor, g: torch.Tensor, se: torch.Tensor,
        oe: torch.Tensor, wreal: int):
    """Gradient of :func:`fwd` at the BN input: pooled gradient g
    [B, H2, Wout, C] (y's dtype) -> (dye, dyo like y: dz*se, sum dz [L],
    sum dz*y [L] fp32 per lane), dz the gradient at the BN output."""
    c = se.shape[0]
    b, h2, wp = _check_planes(ye, yo, c, VEC_BWD)
    _check_affine(se, oe, c, ye.device)
    wout = _check_wreal(wreal, wp)
    if g.shape != (b, h2, wout, c) or g.dtype != ye.dtype or g.device != ye.device:
        raise ValueError(f"g must be [{b}, {h2}, {wout}, {c}] {ye.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    if not g.is_contiguous() or g.data_ptr() % (VEC_BWD * g.element_size()):
        raise ValueError("g must be contiguous and aligned to 2 elements")
    lanes = wp * c
    items_per_cta = THREADS // (c // VEC_BWD)
    parts = max(1, min(MAX_PARTS, -(-b * h2 // items_per_cta)))
    dye, dyo = torch.empty_like(ye), torch.empty_like(yo)
    partial = torch.empty((parts, 2, lanes), device=ye.device, dtype=torch.float32)
    sums = torch.empty((2, lanes), device=ye.device, dtype=torch.float32)
    with torch.cuda.device(ye.device):
        rc = _library().native_bwd_launch(
            ye.data_ptr(), yo.data_ptr(), g.data_ptr(), se.data_ptr(), oe.data_ptr(),
            dye.data_ptr(), dyo.data_ptr(), partial.data_ptr(), sums.data_ptr(),
            b, h2, wp, wreal, c, parts, _DTYPES[ye.dtype], _stream(ye.device),
        )
    _raise_if(rc, "native stem backward")
    launches["native_bwd"] += 1
    return dye, dyo, sums[0], sums[1]
