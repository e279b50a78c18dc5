"""The fused attention kernels for Hopper (``csrc/attention.cu``): build and
wrappers.

They replace the JAX package's two TPU kernels of
``ops/attention_pallas.py``: ``_attention_fwd_hd`` (:func:`fwd`) and
``_attention_bwd_hd`` (:func:`bwd`).  :mod:`.attention` holds the plain
version and the ``autograd.Function`` that calls these wrappers for CUDA
tensors.

bf16 runs on the tensor cores: ``mma.sync`` m16n8k16 with fp32
accumulation, FlashAttention-2's scheme.  A CTA of 4 warps takes a tile of
64 queries (forward, dQ) or 64 keys (dK/dV); each warp holds 16 rows of
the resident operand as registers; the streamed 64-row tiles go through a
2-stage ``cp.async`` ring of bf16 shared tiles (45-55 KB a CTA); the
rounded weights P and score gradients dS stay in registers as the next
product's operand.  fp32 runs on SIMT kernels (256 threads, FFMA): the
fp32 limits need fp32 products, which neither TF32 nor bf16 tensor cores
give, and no model path runs attention in fp32.  Both dtypes compute what
the TPU kernels compute (P and dS rounded to the input dtype before their
products, dq and dk scaled after them), and the backward is deterministic:
no atomics, one writer per output element.  The bound at ``vit_s8``'s
shape [64, 785, 6, 64] is the bf16 tensor-core rate: forward 60.6 GFLOP,
0.0613 ms; backward 151 GFLOP, 0.153 ms; ``csrc/attention.cu`` gives the
details.

The source is built with ``nvcc`` on first use (:mod:`.nvcc`) and loaded
through ``ctypes``.  Nothing is compiled or loaded when this module is
imported.  :func:`kernel_info` reads each kernel's registers, spill bytes,
shared memory and resident CTAs per SM from the card.

The wrappers take q, k, v (and o, g) as ``[B, N, H, 64]`` tensors with any
strides whose head-dim values are contiguous and 16-byte aligned, such as
the q, k and v views of one ``[B, N, 3*H*64]`` projection, and raise for
anything else.  ``launches`` counts each wrapper's launches; :func:`bwd`
enqueues three kernels per launch (the row dots, then dK/dV, then dQ) and
counts as one.

:func:`fwd_mla` and :func:`bwd_mla` run the same scheme at DeepSeek-V2's
latent-attention widths (q, k ``[B, N, H, 192]``, v ``[B, N, H, 128]``,
bf16) with an explicit scale and an optional causal mask, on kernels of
their own names (``attn_*_mla_kernel``), counted as ``attn_fwd_mla`` and
``attn_bwd_mla``.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import nvcc

SOURCE = os.path.join(nvcc.CSRC_DIR, "attention.cu")
NVCC_FLAGS = nvcc.BASE_FLAGS
HEAD_DIM = 64  # csrc/attention.cu kD
MLA_DIMS = (192, 128)  # csrc/attention.cu kMlaDqk, kMlaDv: query/key and value widths
THREADS = {torch.float32: 256, torch.bfloat16: 128}  # csrc/attention.cu kThreads, kMmaThreads
MAX_GRID_YZ = 65535  # heads and batch ride on gridDim.y / gridDim.z
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"attn_fwd": 0, "attn_bwd": 0, "attn_fwd_mla": 0, "attn_bwd_mla": 0}
_lib = None


def build() -> tuple[str, str]:
    """Compile ``csrc/attention.cu`` unless this source is built already.
    Returns the library path and the compiler's ``-Xptxas -v`` log."""
    return nvcc.build(SOURCE, NVCC_FLAGS)


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.attn_fwd_launch.argtypes = [p, p, p, p, p, p, i, i, i, f, i, p]
        lib.attn_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, f, i, p]
        lib.attn_fwd_mla_launch.argtypes = [p, p, p, p, p, p, i, i, i, f, i, p]
        lib.attn_bwd_mla_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, f, i, p]
        lib.attn_kernel_info.argtypes = [i, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(i)]
        for fn in (lib.attn_fwd_launch, lib.attn_bwd_launch, lib.attn_fwd_mla_launch,
                   lib.attn_bwd_mla_launch, lib.attn_kernel_info):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def kernel_info() -> dict[str, dict[str, int]]:
    """Each kernel of ``csrc/attention.cu`` as the card runs it: registers
    a thread, local (spill) bytes a thread, shared bytes a CTA, threads a
    CTA and resident CTAs per SM (``cudaFuncGetAttributes`` and the
    occupancy calculator)."""
    lib = _library()
    name, info = ctypes.c_char_p(), (ctypes.c_int * 5)()
    keys = ("registers", "local_bytes", "shared_bytes", "threads", "ctas_per_sm")
    out, which, count = {}, 0, 1
    while which < count:
        count = lib.attn_kernel_info(which, ctypes.byref(name), info)
        if count < 0:
            raise RuntimeError("attn_kernel_info failed: a CUDA error")
        out[name.value.decode()] = dict(zip(keys, info))
        which += 1
    return out


def _check(t: torch.Tensor, name: str, like: torch.Tensor | None = None,
           width: int = HEAD_DIM) -> None:
    """``t`` a [B, N, H, width] operand the kernels can read; with
    ``like``, of its batch, tokens, heads, dtype and device."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must lie on a CUDA device, got {t.device}")
    if t.dtype not in _DTYPES:
        raise ValueError(f"{name}: the attention kernels take float32 or bfloat16, got {t.dtype}")
    if t.ndim != 4:
        raise ValueError(f"{name} must be [B, N, H, Dh], got {tuple(t.shape)}")
    if t.shape[-1] != width:
        raise ValueError(f"{name}: the attention kernels take head dim {width} here, "
                         f"got {t.shape[-1]}")
    if like is not None and (t.shape[:3] != like.shape[:3] or t.dtype != like.dtype
                             or t.device != like.device):
        raise ValueError(
            f"{name} must match q: {tuple(like.shape)} {like.dtype} {like.device}, got "
            f"{tuple(t.shape)} {t.dtype} {t.device}")
    vec = 16 // t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
        raise ValueError(
            f"{name}: head-dim values must be contiguous and rows 16-byte aligned, "
            f"got strides {t.stride()}")


def _geometry(q: torch.Tensor) -> tuple[int, int, int]:
    b, n, h, _ = q.shape
    if b > MAX_GRID_YZ or h > MAX_GRID_YZ:
        raise ValueError(f"batch and heads must be <= {MAX_GRID_YZ}, got {b}, {h}")
    return b, n, h


def _strides(*tensors: torch.Tensor):
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_if(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k, v [B, N, H, 64] -> (out [B, N, H, 64] contiguous in q's dtype,
    lse [B, H, N] fp32: the log-sum-exp of each scaled score row)."""
    _check(q, "q")
    _check(k, "k", q)
    _check(v, "v", q)
    b, n, h = _geometry(q)
    out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, n), device=q.device, dtype=torch.float32)
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        rc = _library().attn_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _strides(q, k, v),
            out.data_ptr(), lse.data_ptr(), b, n, h, HEAD_DIM ** -0.5,
            _DTYPES[q.dtype], _stream(q.device),
        )
    _raise_if(rc, "attention forward")
    launches["attn_fwd"] += 1
    return out, lse


def bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, g: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`fwd` for the output gradient g (q's layout
    rules): (dq, dk, dv), each [B, N, H, 64] contiguous in q's dtype."""
    _check(q, "q")
    for name, t in (("k", k), ("v", v), ("out", out), ("g", g)):
        _check(t, name, q)
    b, n, h = _geometry(q)
    if lse.shape != (b, h, n) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous [{b}, {h}, {n}] float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    dq, dk, dv = (torch.empty(q.shape, device=q.device, dtype=q.dtype) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv
    dsum = torch.empty((b, h, n), device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        rc = _library().attn_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
            _strides(q, k, v, out, g), lse.data_ptr(), dsum.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, h, HEAD_DIM ** -0.5,
            _DTYPES[q.dtype], _stream(q.device),
        )
    _raise_if(rc, "attention backward")
    launches["attn_bwd"] += 1
    return dq, dk, dv


# ------------------------------------------------------------------- MLA


def _check_mla(q, k, v) -> None:
    dqk, dv = MLA_DIMS
    _check(q, "q", width=dqk)
    _check(k, "k", q, width=dqk)
    _check(v, "v", q, width=dv)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the MLA kernels take bfloat16, got {q.dtype}")


def fwd_mla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Latent attention's widths: q, k [B, N, H, 192] and v [B, N, H, 128]
    bf16 (head-dim values contiguous, rows 16-byte aligned) -> (out [B, N,
    H, 128] contiguous, lse [B, H, N] fp32), softmax(q k^T * scale) v
    with, under ``causal``, key s weighted in query row t only where
    s <= t."""
    _check_mla(q, k, v)
    b, n, h = _geometry(q)
    out = torch.empty((b, n, h, MLA_DIMS[1]), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, n), device=q.device, dtype=torch.float32)
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        rc = _library().attn_fwd_mla_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _strides(q, k, v),
            out.data_ptr(), lse.data_ptr(), b, n, h, float(scale), int(causal),
            _stream(q.device),
        )
    _raise_if(rc, "MLA attention forward")
    launches["attn_fwd_mla"] += 1
    return out, lse


def bwd_mla(q, k, v, out, lse, g, scale: float, causal: bool):
    """Gradients of :func:`fwd_mla` for the output gradient g ([B, N, H,
    128]): (dq, dk, dv) contiguous in q's dtype."""
    _check_mla(q, k, v)
    for name, t in (("out", out), ("g", g)):
        _check(t, name, q, width=MLA_DIMS[1])
    b, n, h = _geometry(q)
    if lse.shape != (b, h, n) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous [{b}, {h}, {n}] float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    dq, dk = (torch.empty(q.shape, device=q.device, dtype=q.dtype) for _ in range(2))
    dv = torch.empty(v.shape, device=q.device, dtype=q.dtype)
    if q.numel() == 0:
        return dq, dk, dv
    dsum = torch.empty((b, h, n), device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        rc = _library().attn_bwd_mla_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
            _strides(q, k, v, out, g), lse.data_ptr(), dsum.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, h, float(scale), int(causal),
            _stream(q.device),
        )
    _raise_if(rc, "MLA attention backward")
    launches["attn_bwd_mla"] += 1
    return dq, dk, dv
