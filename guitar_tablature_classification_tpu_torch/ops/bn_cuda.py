"""The column-sum kernels for Hopper (``csrc/bn.cu``): build and wrappers.

They replace the JAX package's TPU kernels ``ops/bn_pallas.py::_sums_pallas``
(:func:`sums`) and ``_grad_sums_pallas`` (:func:`grad_sums`), and serve the
native stem's ``ops/stem_native.py::_stats_pallas`` through
:func:`column_sums` (called by :mod:`.stem_native_cuda`, which counts that
launch).  ``csrc/bn.cu`` explains the design and bound; :mod:`.bn_fused`
holds the plain versions and the ``autograd.Function`` that calls these
wrappers for CUDA tensors.

A ``[B, C, ...]`` tensor is read through its memory as a row-major
``[rows, lanes]`` matrix (:func:`lane_view`), contiguous NCHW or channels
last, with no copy.  The source is built with ``nvcc`` on first use
(:mod:`.nvcc`) and loaded through ``ctypes``; nothing is compiled or loaded
when this module is imported.  ``launches`` counts each wrapper's launches;
a launch enqueues two kernels (per-CTA partial sums, then their
fixed-order fold), and counts as one.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from . import nvcc

SOURCE = os.path.join(nvcc.CSRC_DIR, "bn.cu")
NVCC_FLAGS = nvcc.BASE_FLAGS + ("-fmad=false",)
THREADS = 256  # csrc/bn.cu kThreads
VEC = 8  # lanes a thread loads at once (csrc/bn.cu kVec)
TARGET_CTAS = 132 * 8  # one full wave of 256-thread CTAs on the H100's SMs
MAX_PARTS = 1024  # row parts per lane tile (fixed for a shape: deterministic sums)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"bn_sums": 0, "bn_grad_sums": 0}
_lib = None


def build() -> tuple[str, str]:
    """Compile ``csrc/bn.cu`` unless this source is built already.  Returns
    the library path and the compiler's ``-Xptxas -v`` log."""
    return nvcc.build(SOURCE, NVCC_FLAGS)


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bn_sums_launch.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, i, p]
        lib.bn_sums_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def lane_view(y: torch.Tensor) -> tuple[int, int, int]:
    """(rows, lanes, div) of ``y`` [B, C, ...] read as a row-major
    [rows, lanes] matrix whose lane l holds channel (l // div) % C:
    channels last -> [B*H*W, C], div 1; contiguous NCHW -> [B, C*H*W],
    div H*W.  Another memory layout raises."""
    if y.ndim < 2:
        raise ValueError(f"expected [B, C, ...], got {tuple(y.shape)}")
    b, c = y.shape[0], y.shape[1]
    spatial = math.prod(y.shape[2:])
    if y.ndim == 4 and y.is_contiguous(memory_format=torch.channels_last):
        return b * spatial, c, 1
    if y.is_contiguous():
        return b, c * spatial, spatial
    raise ValueError(
        f"the sums kernel reads contiguous NCHW or channels-last tensors, got "
        f"shape {tuple(y.shape)} with strides {y.stride()}"
    )


def _check(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must lie on a CUDA device, got {t.device}")
    if t.dtype not in _DTYPES:
        raise ValueError(f"{name}: the sums kernel takes float32 or bfloat16, got {t.dtype}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _parts(rows: int, lanes: int, n_src: int) -> int:
    """Row parts of the first pass: about one wave of CTAs in all."""
    groups = lanes // VEC
    g = min(groups, THREADS)
    tiles = -(-groups // g)
    slots = THREADS // g
    want = -(-TARGET_CTAS // (tiles * n_src))
    return max(1, min(want, MAX_PARTS, -(-rows // slots)))


def column_sums(sources, rows: int, lanes: int, div: int, c_out: int,
                g: torch.Tensor | None = None) -> torch.Tensor:
    """[2, c_out] fp32 over one or two sources of the same [rows, lanes]
    view: (sum y, sum y*y), or with ``g`` (one source, same view)
    (sum g, sum g*y); lane l adds into column (l // div) % c_out.  Counts
    nothing (the callers do)."""
    first = sources[0]
    for i, t in enumerate(sources):
        _check(t, f"source {i}")
        if t.dtype != first.dtype or t.device != first.device or t.numel() != rows * lanes:
            raise ValueError("the sources must share dtype, device and the view's size")
    if g is not None:
        _check(g, "g")
        if g.dtype != first.dtype or g.device != first.device or g.numel() != rows * lanes:
            raise ValueError("g must match y's dtype, device and size")
    if lanes % VEC or lanes % (c_out * div):
        raise ValueError(f"the sums kernel needs lanes % {VEC} == 0, got {lanes} lanes")
    n_src = len(sources)
    parts = _parts(rows, lanes, n_src)
    partial = torch.empty((n_src * parts, 2, lanes), device=first.device, dtype=torch.float32)
    out = torch.empty((2, c_out), device=first.device, dtype=torch.float32)
    with torch.cuda.device(first.device):
        rc = _library().bn_sums_launch(
            first.data_ptr(), sources[-1].data_ptr() if n_src == 2 else None,
            None if g is None else g.data_ptr(), partial.data_ptr(), out.data_ptr(),
            rows, lanes, n_src, parts, div, c_out, _DTYPES[first.dtype],
            torch.cuda.current_stream(first.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sums kernel launch failed: CUDA error {rc}")
    return out


def sums(y: torch.Tensor) -> torch.Tensor:
    """[2, C] fp32 per channel of ``y`` [B, C, ...]: sum and sum of squares."""
    rows, lanes, div = lane_view(y)
    out = column_sums([y], rows, lanes, div, y.shape[1])
    launches["bn_sums"] += 1
    return out


def grad_sums(y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """[2, C] fp32 per channel: sum g and sum g*y, for ``y`` and ``g`` of
    one shape and memory layout."""
    if g.shape != y.shape:
        raise ValueError(f"g must have y's shape {tuple(y.shape)}, got {tuple(g.shape)}")
    view = lane_view(y)
    if lane_view(g) != view:
        raise ValueError("g must have y's memory layout")
    rows, lanes, div = view
    out = column_sums([y], rows, lanes, div, y.shape[1], g=g)
    launches["bn_grad_sums"] += 1
    return out
