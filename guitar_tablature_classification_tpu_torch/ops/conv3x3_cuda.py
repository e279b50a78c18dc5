"""The 3x3 conv with a fused ReLU-affine for Hopper (``csrc/conv3x3.cu``):
build and wrapper.

It replaces the TPU kernel ``tools/probe_pallas_conv.py::pallas_conv3x3``
(a probe in the JAX repo's ``tools/``, not in its package); ``csrc/conv3x3.cu``
explains its design and bound, and :mod:`.conv3x3` holds the plain version
and the dispatching :func:`.conv3x3.conv3x3_affine_relu`.

The source is built with ``nvcc`` on first use (:mod:`.nvcc`) and loaded
through ``ctypes``; nothing is compiled or loaded when this module is
imported.  ``launches["conv3x3"]`` counts the wrapper's launches.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import nvcc

SOURCE = os.path.join(nvcc.CSRC_DIR, "conv3x3.cu")
NVCC_FLAGS = nvcc.BASE_FLAGS
MAX_CHANNELS = 1024  # csrc/conv3x3.cu kMaxC

launches = {"conv3x3": 0}
_lib = None


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
        lib.conv3x3_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.conv3x3_launch.restype = ctypes.c_int
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
    out = torch.empty((b, h, w, f), device=x.device, dtype=torch.bfloat16)
    with torch.cuda.device(x.device):
        rc = _library().conv3x3_launch(
            x.data_ptr(), w9.data_ptr(), s.data_ptr(), o.data_ptr(), out.data_ptr(),
            b, h, w, c, f, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: CUDA error {rc}")
    launches["conv3x3"] += 1
    return out
