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
:func:`fwd_plan` and :func:`bwd_plan` are the two kernels' tilings, which
the CPU tests walk.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import torch

from . import bn_cuda, nvcc

SOURCE = os.path.join(nvcc.CSRC_DIR, "stem_native.cu")
NVCC_FLAGS = nvcc.BASE_FLAGS + ("-fmad=false",)
MAX_WP = 6  # widest plane in columns (csrc/stem_native.cu kMaxWp)
FWD_THREADS = 256  # csrc/stem_native.cu kFwdThreads
FWD_STAGES = 2  # images in the forward kernel's ring (kFwdStages)
# forward CTAs the plan aims at: three on each of an H100's 132 SMs (a
# constant, not read from the card, as the backward's)
FWD_CTAS = 396
# dynamic shared bytes a forward CTA may take: three CTAs an SM (228 KB, 1
# KB reserved a CTA)
FWD_SMEM_BUDGET = 74 * 1024
BWD_THREADS = 256  # csrc/stem_native.cu kBwdThreads
# backward CTAs the plan aims at: two on each of an H100's 132 SMs.  A
# constant, not read from the card, so that the sums' order (and so their
# bits) is the same on every card
BWD_CTAS = 264
# dynamic shared bytes a backward CTA may take: two CTAs an SM (228 KB; 1 KB
# reserved a CTA and at most 512 static bytes)
BWD_SMEM_BUDGET = 112 * 1024
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
        lib.native_fwd_launch.argtypes = [p, p, p, p, p] + [i] * 9 + [p]
        lib.native_fwd_kernel_info.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
        lib.native_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, p] + [i] * 10 + [p]
        lib.native_bwd_kernel_info.argtypes = [i, i, i, i, i, i, ctypes.POINTER(i)]
        for fn in (lib.native_fwd_launch, lib.native_fwd_kernel_info, lib.native_bwd_launch,
                   lib.native_bwd_kernel_info):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_planes(ye: torch.Tensor, yo: torch.Tensor, c: int, vec: int) -> tuple[int, int, int]:
    """(B, H2, Wp) of the parity planes [B, H2, Wp*C], each aligned to
    ``vec`` elements."""
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
    if c < 8 or c % 8:
        raise ValueError(f"the native stem kernels need C % 8 == 0, got C={c}")
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


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """The forward kernel's tiling (``csrc/stem_native.cu``
    native_fwd_kernel).

    CTA ``(group, slice)`` (block index ``group * n_slices + slice``) walks
    images ``[group * images_per_cta, min(B, (group + 1) * images_per_cta))``
    in order through a ring of ``FWD_STAGES`` images, at channels ``[slice *
    cs, (slice + 1) * cs)``: one to eight 16-byte vectors a pixel, as wide
    as C and ``FWD_SMEM_BUDGET`` allow.  ``smem_bytes`` is its dynamic shared
    memory.  The launch takes ``cs``, ``images_per_cta`` and ``smem_bytes``
    from here; the source only checks that they fit the kernel."""

    cs: int
    n_slices: int
    images_per_cta: int
    parts: int  # the groups of images
    grid: int
    smem_bytes: int


def fwd_smem_bytes(h2: int, wp: int, cs: int, elem: int) -> int:
    """Dynamic shared bytes of the forward kernel: ``FWD_STAGES`` images'
    rows of both planes at Wp column slots (real ones filled)."""
    return FWD_STAGES * 2 * h2 * wp * (cs * elem // 16) * 16


def _slice_width(h2, wp, c, dtype, smem_bytes, budget, kernel) -> int:
    """The widest channel slice (at most 128 bytes a pixel) that divides C
    and whose CTA's ``smem_bytes(h2, wp, cs, elem)`` fits ``budget``.
    Raises a ValueError that names the limit where even a 16-byte slice does
    not fit (H2 too tall)."""
    elem = torch.finfo(dtype).bits // 8
    vec = 16 // elem
    nv = 8
    while (c // vec) % nv:
        nv //= 2
    while nv > 1 and smem_bytes(h2, wp, nv * vec, elem) > budget:
        nv //= 2
    if smem_bytes(h2, wp, nv * vec, elem) > budget:
        tallest = max(x for x in range(1, h2) if smem_bytes(x, wp, vec, elem) <= budget)
        raise ValueError(f"the native stem {kernel} kernel needs H2 <= {tallest} at {dtype}, "
                         f"Wp={wp} (two images' rows in {budget} shared bytes), got H2={h2}")
    return nv * vec


def _check_plan_shape(b, h2, wp, c, kernel) -> None:
    if b < 1 or h2 < 1 or not 1 <= wp <= MAX_WP or c < 8 or c % 8:
        raise ValueError(f"the native stem {kernel} kernel needs B, H2 >= 1, 1 <= Wp <= "
                         f"{MAX_WP} and C % 8 == 0, got B={b}, H2={h2}, Wp={wp}, C={c}")


def fwd_plan(b: int, h2: int, wp: int, c: int, dtype: torch.dtype) -> FwdPlan:
    """The tiling of :func:`fwd` at this shape: the widest channel slice
    that fits ``FWD_SMEM_BUDGET`` (:func:`_slice_width`), and runs of
    consecutive images spread over at most ``FWD_CTAS`` CTAs."""
    _check_plan_shape(b, h2, wp, c, "forward")
    cs = _slice_width(h2, wp, c, dtype, fwd_smem_bytes, FWD_SMEM_BUDGET, "forward")
    n_slices = c // cs
    ipc = max(1, -(-b * n_slices // FWD_CTAS))
    parts = -(-b // ipc)
    elem = torch.finfo(dtype).bits // 8
    return FwdPlan(cs=cs, n_slices=n_slices, images_per_cta=ipc, parts=parts,
                   grid=parts * n_slices, smem_bytes=fwd_smem_bytes(h2, wp, cs, elem))


def fwd(ye: torch.Tensor, yo: torch.Tensor, se: torch.Tensor, oe: torch.Tensor,
        wreal: int) -> torch.Tensor:
    """max_pool3x3s2(relu(y*se + oe)) over the real columns -> pooled
    [B, H2, Wout, C] in y's dtype; se/oe [C] fp32.  ye and yo are 16-byte
    aligned (the kernel copies 16-byte vectors)."""
    c = se.shape[0]
    b, h2, wp = _check_planes(ye, yo, c, 16 // ye.element_size())
    _check_affine(se, oe, c, ye.device)
    wout = _check_wreal(wreal, wp)
    out = torch.empty((b, h2, wout, c), device=ye.device, dtype=ye.dtype)
    if b == 0:
        return out
    plan = fwd_plan(b, h2, wp, c, ye.dtype)
    with torch.cuda.device(ye.device):
        rc = _library().native_fwd_launch(
            ye.data_ptr(), yo.data_ptr(), se.data_ptr(), oe.data_ptr(), out.data_ptr(),
            b, h2, wp, wreal, c, plan.cs, plan.images_per_cta, plan.smem_bytes,
            _DTYPES[ye.dtype], _stream(ye.device),
        )
    _raise_if(rc, "native stem forward")
    launches["native_fwd"] += 1
    return out


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The backward kernel's tiling (``csrc/stem_native.cu``
    native_bwd_kernel).

    CTA ``(group, slice)`` (block index ``group * n_slices + slice``) walks
    images ``[group * images_per_cta, min(B, (group + 1) * images_per_cta))``
    in order through a two-stage ring, at channels ``[slice * cs, (slice + 1)
    * cs)``: one to eight 16-byte vectors a pixel, as wide as C and the
    shared-memory budget allow.  ``smem_bytes`` is its dynamic shared memory;
    ``parts`` (= the groups) the rows of the partial-sum table, at most
    ``BWD_CTAS``.  The launch takes ``cs``, ``images_per_cta``,
    ``row_groups`` and ``smem_bytes`` from here; the source only checks that
    they fit the kernel."""

    cs: int
    n_slices: int
    images_per_cta: int
    parts: int
    grid: int
    smem_bytes: int
    row_groups: int  # rows of an image a gather thread's lanes are split into


def bwd_smem_bytes(h2: int, wp: int, cs: int, elem: int) -> int:
    """Dynamic shared bytes of the backward kernel (the layout in
    ``csrc/stem_native.cu`` above native_bwd_kernel): two stages of an
    image's rows (Wp column slots, real ones filled) and pooled gradient,
    one tap byte a window and channel; or the lane sums' table [2, row
    groups, Wp, cs] fp32 where that is larger."""
    nv = cs * elem // 16
    wg = (wp - 1) // 2 + 1
    stage = (2 * h2 * wp + h2 * wg) * nv * 16
    ring = 2 * stage + h2 * wg * cs
    return max(ring, 2 * bwd_row_groups(wp, nv) * wp * cs * 4)


def bwd_row_groups(wp: int, nv: int) -> int:
    """The row groups of the backward kernel's gather threads: the largest
    power of two whose groups of (column pair, vector) lanes fit
    ``BWD_THREADS`` (a power of two, so that a warp's threads share their
    column pair at the model shape)."""
    lanes = (wp + 1) // 2 * nv
    return 1 << ((BWD_THREADS // lanes).bit_length() - 1)


def bwd_plan(b: int, h2: int, wp: int, c: int, dtype: torch.dtype) -> BwdPlan:
    """The tiling of :func:`bwd` at this shape: the widest channel slice
    (at most 128 bytes a pixel) that divides C and whose CTA fits
    ``BWD_SMEM_BUDGET``, and runs of consecutive images spread over at most
    ``BWD_CTAS`` CTAs.  Raises a ValueError that names the limit where even a
    16-byte slice does not fit (H2 too tall)."""
    _check_plan_shape(b, h2, wp, c, "backward")
    cs = _slice_width(h2, wp, c, dtype, bwd_smem_bytes, BWD_SMEM_BUDGET, "backward")
    elem = torch.finfo(dtype).bits // 8
    nv = cs * elem // 16
    smem = bwd_smem_bytes(h2, wp, cs, elem)
    n_slices = c // cs
    ipc = max(1, -(-b * n_slices // BWD_CTAS))
    parts = -(-b // ipc)
    return BwdPlan(cs=cs, n_slices=n_slices, images_per_cta=ipc, parts=parts,
                   grid=parts * n_slices, smem_bytes=smem, row_groups=bwd_row_groups(wp, nv))


def bwd(ye: torch.Tensor, yo: torch.Tensor, g: torch.Tensor, se: torch.Tensor,
        oe: torch.Tensor, wreal: int):
    """Gradient of :func:`fwd` at the BN input: pooled gradient g
    [B, H2, Wout, C] (y's dtype) -> (dye, dyo like y: dz*se, sum dz [L],
    sum dz*y [L] fp32 per lane), dz the gradient at the BN output.  ye, yo
    and g are 16-byte aligned (the kernel copies 16-byte vectors)."""
    c = se.shape[0]
    vec = 16 // ye.element_size()
    b, h2, wp = _check_planes(ye, yo, c, vec)
    _check_affine(se, oe, c, ye.device)
    wout = _check_wreal(wreal, wp)
    if g.shape != (b, h2, wout, c) or g.dtype != ye.dtype or g.device != ye.device:
        raise ValueError(f"g must be [{b}, {h2}, {wout}, {c}] {ye.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    if not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("g must be contiguous and aligned to 16 bytes")
    lanes = wp * c
    dye, dyo = torch.empty_like(ye), torch.empty_like(yo)
    if b == 0:
        return dye, dyo, *torch.zeros((2, lanes), device=ye.device)
    plan = bwd_plan(b, h2, wp, c, ye.dtype)
    partial = torch.empty((plan.parts, 2, lanes), device=ye.device, dtype=torch.float32)
    sums = torch.empty((2, lanes), device=ye.device, dtype=torch.float32)
    with torch.cuda.device(ye.device):
        rc = _library().native_bwd_launch(
            ye.data_ptr(), yo.data_ptr(), g.data_ptr(), se.data_ptr(), oe.data_ptr(),
            dye.data_ptr(), dyo.data_ptr(), partial.data_ptr(), sums.data_ptr(),
            b, h2, wp, wreal, c, plan.cs, plan.images_per_cta, plan.row_groups,
            plan.smem_bytes, _DTYPES[ye.dtype], _stream(ye.device),
        )
    _raise_if(rc, "native stem backward")
    launches["native_bwd"] += 1
    return dye, dyo, sums[0], sums[1]


_INFO_KEYS = ("registers", "local_bytes", "shared_bytes", "threads", "ctas_per_sm")


def fwd_kernel_info(ye: torch.Tensor, c: int = 64) -> dict:
    """The forward kernel as the card runs it for parity planes of
    ``ye``'s shape and dtype with C channels (the source's
    ``native_fwd_kernel_info``): its plan, registers and local (spill) bytes
    a thread, shared bytes (static + dynamic) and threads a CTA, resident
    CTAs per SM."""
    b, h2, lanes = ye.shape
    plan = fwd_plan(b, h2, lanes // c, c, ye.dtype)
    info = (ctypes.c_int * 5)()
    rc = _library().native_fwd_kernel_info(h2, lanes // c, plan.cs, plan.smem_bytes,
                                           _DTYPES[ye.dtype], info)
    _raise_if(rc, "native_fwd_kernel_info")
    return {**dataclasses.asdict(plan), **dict(zip(_INFO_KEYS, info))}


def bwd_kernel_info(ye: torch.Tensor, c: int = 64) -> dict:
    """The backward kernel as the card runs it for parity planes of
    ``ye``'s shape and dtype with C channels (the source's
    ``native_bwd_kernel_info``): its plan, registers and local (spill) bytes
    a thread, shared bytes (static + dynamic) and threads a CTA, resident
    CTAs per SM."""
    b, h2, lanes = ye.shape
    plan = bwd_plan(b, h2, lanes // c, c, ye.dtype)
    info = (ctypes.c_int * 5)()
    rc = _library().native_bwd_kernel_info(h2, lanes // c, plan.cs, plan.row_groups,
                                           plan.smem_bytes, _DTYPES[ye.dtype], info)
    _raise_if(rc, "native_bwd_kernel_info")
    return {**dataclasses.asdict(plan), **dict(zip(_INFO_KEYS, info))}
