"""The 3x3 conv with a fused ReLU-affine for Hopper (``csrc/conv3x3.cu``):
build and wrapper.

It replaces the TPU kernel ``tools/probe_pallas_conv.py::pallas_conv3x3``
(a probe in the JAX repo's ``tools/``, not in its package); ``csrc/conv3x3.cu``
explains its design and bound, and :mod:`.conv3x3` holds the plain version
and the dispatching :func:`.conv3x3.conv3x3_affine_relu`.

The source is built with ``nvcc`` on first use (:mod:`.nvcc`) and loaded
through ``ctypes``; nothing is compiled or loaded when this module is
imported.  ``launches["conv3x3"]`` counts the wrapper's launches.
:func:`tile_shape` picks the output block each CTA owns (the kernel stages
its halo once per 16-channel chunk), :func:`l2_bytes` counts what the
kernel reads at a shape, and :func:`conv3x3_kernel_info` reports its
registers and occupancy on the card.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from . import nvcc

SOURCE = os.path.join(nvcc.CSRC_DIR, "conv3x3.cu")
NVCC_FLAGS = nvcc.BASE_FLAGS
MAX_CHANNELS = 1024  # csrc/conv3x3.cu kMaxC
TILE_PIXELS = 256  # output pixel slots of a CTA; csrc/conv3x3.cu kBM
HALO_MAX = 336  # staged halo pixels of a CTA at most; kHaloMax
COLS = 64  # filters of a CTA; kBN
CHUNK = 16  # channels a ring stage; kKC

launches = {"conv3x3": 0}
_lib = None


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def tile_shape(h: int, w: int) -> tuple[int, int]:
    """(TH, TW) of the CTA's output block for an H x W map: at most
    TILE_PIXELS pixels and a halo block (TH+2) x (TW+2) of at most HALO_MAX.
    The fewest blocks a map, then the smallest halo, then a width that is a
    multiple of 8 (8 consecutive pixels of an ldmatrix on one row); TH is
    evened out over the map's rows."""
    best = None
    for tw in range(1, min(w, TILE_PIXELS) + 1):
        th_max = min(h, TILE_PIXELS // tw, HALO_MAX // (tw + 2) - 2)
        if th_max < 1:
            continue
        th = _cdiv(h, _cdiv(h, th_max))
        key = (_cdiv(h, th) * _cdiv(w, tw), (th + 2) * (tw + 2), tw % 8 != 0)
        if best is None or key < best[0]:
            best = (key, (th, tw))
    return best[1]


def l2_bytes(b: int, h: int, w: int, c: int, f: int) -> dict[str, int]:
    """Bytes the kernel reads from L2 (or device memory) at a shape: each
    CTA's in-image halo pixels of x (all C channels) and its 64-column
    slice of w9 (every tap, C rounded up to the chunk; zero-filled columns
    past F read nothing); the output is written once."""
    th, tw = tile_shape(h, w)
    n_tiles = _cdiv(f, COLS)
    rows = sum(min(h, h0 + th + 1) - max(0, h0 - 1) for h0 in range(0, h, th))
    cols = sum(min(w, w0 + tw + 1) - max(0, w0 - 1) for w0 in range(0, w, tw))
    ctas_per_map = _cdiv(h, th) * _cdiv(w, tw)
    w9_cols = sum(min(COLS, f - n0) for n0 in range(0, f, COLS))
    return {"x": 2 * b * rows * cols * c * n_tiles,
            "w9": 2 * b * ctas_per_map * 9 * c * w9_cols,
            "out": 2 * b * h * w * f}


def build() -> tuple[str, str]:
    """Compile ``csrc/conv3x3.cu`` unless this source is built already.
    Returns the library path and the compiler's ``-Xptxas -v`` log."""
    return nvcc.build(SOURCE, NVCC_FLAGS)


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.conv3x3_launch.restype = ctypes.c_int
        lib.conv3x3_kernel_info.argtypes = [i, ctypes.POINTER(i)]
        lib.conv3x3_kernel_info.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, device, align: int = 16) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must lie on {device}, got {t.device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def conv3x3(x: torch.Tensor, w9: torch.Tensor, s: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, C], w9 [9, C, F], s and o [C] (all bf16, on one card) ->
    [B, H, W, F] bf16.  Needs C and F multiples of 8, C <= MAX_CHANNELS."""
    if x.device.type != "cuda":
        raise ValueError(f"x must lie on a CUDA device, got {x.device}")
    _check(x, "x", x.device)
    _check(w9, "w9", x.device)
    _check(s, "s", x.device, align=2)
    _check(o, "o", x.device, align=2)
    if x.ndim != 4 or w9.ndim != 3:
        raise ValueError(f"expected x [B, H, W, C] and w9 [9, C, F], got "
                         f"{tuple(x.shape)} and {tuple(w9.shape)}")
    b, h, w, c = x.shape
    f = w9.shape[-1]
    if w9.shape[:2] != (9, c) or s.shape != (c,) or o.shape != (c,):
        raise ValueError(f"w9 must be [9, {c}, F] and s, o [{c}], got {tuple(w9.shape)}, "
                         f"{tuple(s.shape)}, {tuple(o.shape)}")
    if c % 8 or f % 8 or c > MAX_CHANNELS or min(b, h, w, c, f) < 1:
        raise ValueError(f"the conv3x3 kernel needs C and F multiples of 8 and C <= "
                         f"{MAX_CHANNELS}, got C={c}, F={f}")
    if b * h * w > 2**31 - 1:
        raise ValueError(f"the conv3x3 kernel takes at most 2^31 - 1 pixels, got {b * h * w}")
    out = torch.empty((b, h, w, f), device=x.device, dtype=torch.bfloat16)
    th, tw = tile_shape(h, w)
    with torch.cuda.device(x.device):
        rc = _library().conv3x3_launch(
            x.data_ptr(), w9.data_ptr(), s.data_ptr(), o.data_ptr(), out.data_ptr(),
            b, h, w, c, f, th, tw, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: CUDA error {rc}")
    launches["conv3x3"] += 1
    return out


_INFO_KEYS = ("registers", "local_bytes", "shared_bytes", "threads", "ctas_per_sm")


def conv3x3_kernel_info(c: int) -> dict[str, int]:
    """The kernel as the card runs it at C channels (its shared memory
    holds the ring and C values of s and o): registers and local (spill)
    bytes a thread, shared bytes and threads a CTA, resident CTAs per SM."""
    info = (ctypes.c_int * 5)()
    rc = _library().conv3x3_kernel_info(c, info)
    if rc != 0:
        raise RuntimeError(f"conv3x3_kernel_info failed: CUDA error {rc}")
    return dict(zip(_INFO_KEYS, info))
