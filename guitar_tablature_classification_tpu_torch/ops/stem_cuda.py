"""The fused stem-tail kernels for Hopper (``csrc/stem.cu``) and the stem
front's GEMM with statistics (``csrc/stem_gemm.cu``): builds and wrappers.

They replace the JAX package's four TPU kernels of
``ops/stem_pallas.py``: ``_stats_pallas`` (:func:`stats`), ``_fwd_pallas``
(:func:`fwd`), ``_bwd_pallas`` (:func:`bwd`) and ``_gemm_stats_pallas``
(:func:`gemm_stats`, built by ``build_gemm_stats``).  The sources explain
their design and bound; :mod:`.stem_tail` holds the plain versions and the
``autograd.Function``s that call these wrappers for CUDA tensors.

Each source is built with ``nvcc`` on first use (:mod:`.nvcc`; ``stem.cu``
with ``-fmad=false`` so that no multiply-add is contracted) and loaded
through ``ctypes``.  Nothing is compiled or loaded when this module is
imported.

``launches`` counts each wrapper's launches.  :func:`stats`, :func:`bwd`
and :func:`gemm_stats` enqueue two kernels per launch (the per-CTA partial
sums, then their fixed-order reduction); each counts as one.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import torch

from . import nvcc

SOURCE = os.path.join(nvcc.CSRC_DIR, "stem.cu")
NVCC_FLAGS = nvcc.BASE_FLAGS + ("-fmad=false",)
GEMM_SOURCE = os.path.join(nvcc.CSRC_DIR, "stem_gemm.cu")
GEMM_TILE = 128  # rows and columns of a y tile; csrc/stem_gemm.cu kTile
GEMM_MAX_K = 128  # csrc/stem_gemm.cu kMaxK
GEMM_THREADS = 256  # csrc/stem_gemm.cu kThreads
GEMM_STAGES = 4  # hq tiles in the ring; csrc/stem_gemm.cu kStages
# GEMM CTAs the plan aims at: two on each of an H100's 132 SMs.  A constant,
# not read from the card, so that the sums' order (and so their bits) is the
# same on every card
GEMM_CTAS = 264
THREADS = 256  # csrc/stem.cu kThreads
VEC_STATS, VEC_FWD = 8, 8  # channels per thread of each kernel
MAX_PARTS = 1024  # CTAs that write partial sums (fixed: deterministic sums)
MAX_FWD_CTAS = 132 * 16
BWD_BAND = 8  # quad rows a backward CTA owns
# dynamic shared bytes a backward CTA may take: two CTAs an SM (228 KB, 1 KB
# reserved a CTA, 1 KB of static shared memory)
BWD_SMEM_BUDGET = 112 * 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"stem_stats": 0, "stem_fwd": 0, "stem_bwd": 0, "gemm_stats": 0}
_lib = None
_gemm_lib = None


def build() -> tuple[str, str]:
    """Compile ``csrc/stem.cu`` unless this source is built already.
    Returns the library path and the compiler's ``-Xptxas -v`` log."""
    return nvcc.build(SOURCE, NVCC_FLAGS)


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.stem_stats_launch.argtypes = [p, p, p, ll, i, i, i, p]
        lib.stem_fwd_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.stem_bwd_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.stem_bwd_kernel_info.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
        for fn in (lib.stem_stats_launch, lib.stem_fwd_launch, lib.stem_bwd_launch,
                   lib.stem_bwd_kernel_info):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _geometry(yq: torch.Tensor) -> tuple[int, int, int, int]:
    """(B, H2, W2, C) of a quadrant-layout tensor; C = L // (2*H2), as the
    JAX package reads it (square maps)."""
    if yq.ndim != 4 or yq.shape[1] != 2:
        raise ValueError(f"expected quadrant layout [B, 2, H2, L], got {tuple(yq.shape)}")
    b, _, h2, lanes = yq.shape
    c = lanes // (2 * h2)
    if c * 2 * h2 != lanes:
        raise ValueError(f"lanes {lanes} are not 2*H2*C for H2={h2}")
    return b, h2, h2, c


def _check(t: torch.Tensor, name: str, dtype=None, vec: int = 8) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must lie on a CUDA device, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dtype not in _DTYPES:
        raise ValueError(f"{name}: the stem kernels take float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % (vec * t.element_size()) != 0:
        raise ValueError(f"{name} must be aligned to {vec} elements")


def _check_channels(c: int) -> None:
    if c < 8 or c % 8 or THREADS % (c // 2):
        raise ValueError(
            f"the stem kernels need C % 8 == 0 and {THREADS} % (C/2) == 0, got C={c}"
        )


def _check_affine(se: torch.Tensor, oe: torch.Tensor, c: int, device) -> None:
    for name, t in (("se", se), ("oe", oe)):
        if t.shape != (c,) or t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"{name} must be [{c}] float32 on {device}, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _parts(n_items: int, lanes: int) -> int:
    return max(1, min(MAX_PARTS, -(-n_items // lanes)))


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_if(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def stats(yq: torch.Tensor) -> torch.Tensor:
    """Quadrant-layout y -> [2, C] fp32: per-channel sum and sum of squares."""
    _check(yq, "yq", vec=VEC_STATS)
    b, h2, w2, c = _geometry(yq)
    _check_channels(c)
    n_pix = b * 2 * h2 * 2 * w2
    parts = _parts(n_pix, THREADS // (c // VEC_STATS))
    partial = torch.empty((parts, 2, c), device=yq.device, dtype=torch.float32)
    sums = torch.empty((2, c), device=yq.device, dtype=torch.float32)
    with torch.cuda.device(yq.device):
        rc = _library().stem_stats_launch(
            yq.data_ptr(), partial.data_ptr(), sums.data_ptr(), n_pix, c,
            parts, _DTYPES[yq.dtype], _stream(yq.device),
        )
    _raise_if(rc, "stem stats")
    launches["stem_stats"] += 1
    return sums


def fwd(yq: torch.Tensor, se: torch.Tensor, oe: torch.Tensor) -> torch.Tensor:
    """max_pool3x3s2(relu(y*se + oe)): quadrant-layout y, per-channel se/oe
    [C] fp32 -> [B, H2, W2*C] in y's dtype."""
    _check(yq, "yq", vec=VEC_FWD)
    b, h2, w2, c = _geometry(yq)
    _check_channels(c)
    _check_affine(se, oe, c, yq.device)
    out = torch.empty((b, h2, w2 * c), device=yq.device, dtype=yq.dtype)
    n_threads = b * h2 * w2 * (c // VEC_FWD)
    ctas = max(1, min(MAX_FWD_CTAS, -(-n_threads // THREADS)))
    with torch.cuda.device(yq.device):
        rc = _library().stem_fwd_launch(
            yq.data_ptr(), se.data_ptr(), oe.data_ptr(), out.data_ptr(),
            b, h2, w2, c, ctas, _DTYPES[yq.dtype], _stream(yq.device),
        )
    _raise_if(rc, "stem forward")
    launches["stem_fwd"] += 1
    return out


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The backward kernel's tiling (``csrc/stem.cu`` stem_bwd_kernel).

    CTA ``(b, band, slice)`` (block index ``(b * n_bands + band) *
    n_slices + slice``) owns image b, quad rows ``[band * band_rows,
    min(H2, (band + 1) * band_rows))`` and channels ``[slice * cs, (slice +
    1) * cs)``: two 16-byte vectors a pixel (16 bf16 or 8 fp32 channels),
    or one where C is 8 in bf16.  ``smem_bytes`` is the dynamic shared
    memory of a full band; ``parts`` the rows of the partial-sum table."""

    cs: int
    band_rows: int
    n_bands: int
    n_slices: int
    smem_bytes: int
    parts: int
    grid: int


def bwd_smem_bytes(h2: int, w2: int, cs: int, elem: int, band_rows: int) -> int:
    """Dynamic shared bytes of a full band (``csrc/stem.cu``
    bwd_smem_bytes): 2R+3 source rows and R+1 gradient rows of the slice,
    and one tap byte per window and channel."""
    r = min(band_rows, h2)
    n_win = min(r + 1, h2)
    half_row = w2 * cs * elem  # one column-parity half of a row
    return (2 * r + 3) * 2 * half_row + n_win * half_row + n_win * w2 * cs


def bwd_plan(b: int, h2: int, w2: int, c: int, dtype: torch.dtype) -> BwdPlan:
    """The tiling of :func:`bwd` at this shape: the widest band of at most
    ``BWD_BAND`` quad rows whose CTA fits ``BWD_SMEM_BUDGET``.  Raises a
    ValueError where even one quad row does not fit (W2 too wide)."""
    elem = torch.finfo(dtype).bits // 8
    cs = min(c, 32 // elem)
    band = BWD_BAND
    while band > 1 and bwd_smem_bytes(h2, w2, cs, elem, band) > BWD_SMEM_BUDGET:
        band //= 2
    smem = bwd_smem_bytes(h2, w2, cs, elem, band)
    if smem > BWD_SMEM_BUDGET:
        widest = max(x for x in range(1, w2 + 1)
                     if bwd_smem_bytes(h2, x, cs, elem, 1) <= BWD_SMEM_BUDGET)
        raise ValueError(f"the stem backward kernel needs W2 <= {widest} at {dtype} "
                         f"(a band's rows in {BWD_SMEM_BUDGET} shared bytes), got W2={w2}")
    n_bands = -(-h2 // band)
    n_slices = c // cs
    return BwdPlan(cs=cs, band_rows=band, n_bands=n_bands, n_slices=n_slices,
                   smem_bytes=smem, parts=b * n_bands, grid=b * n_bands * n_slices)


def bwd(
    yq: torch.Tensor, g: torch.Tensor, se: torch.Tensor, oe: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradient of :func:`fwd` at the BN input: quadrant-layout y, pooled
    gradient g [B, H2, W2*C] (y's dtype) -> (dy like y, sum dz [C],
    sum dz*y [C]), dz the gradient at the BN output, dy = dz*se.  y, g are
    16-byte aligned (the kernel copies 16-byte vectors)."""
    _check(yq, "yq", vec=16 // yq.element_size())
    b, h2, w2, c = _geometry(yq)
    _check(g, "g", dtype=yq.dtype, vec=16 // yq.element_size())
    if g.shape != (b, h2, w2 * c):
        raise ValueError(f"g must be [{b}, {h2}, {w2 * c}], got {tuple(g.shape)}")
    _check_channels(c)
    _check_affine(se, oe, c, yq.device)
    plan = bwd_plan(b, h2, w2, c, yq.dtype)
    dy = torch.empty_like(yq)
    partial = torch.empty((plan.parts, 2, c), device=yq.device, dtype=torch.float32)
    sums = torch.empty((2, c), device=yq.device, dtype=torch.float32)
    with torch.cuda.device(yq.device):
        rc = _library().stem_bwd_launch(
            yq.data_ptr(), g.data_ptr(), se.data_ptr(), oe.data_ptr(),
            dy.data_ptr(), partial.data_ptr(), sums.data_ptr(), b, h2, w2, c,
            plan.cs, plan.band_rows, _DTYPES[yq.dtype], _stream(yq.device),
        )
    _raise_if(rc, "stem backward")
    launches["stem_bwd"] += 1
    return dy, sums[0], sums[1]


_INFO_KEYS = ("registers", "local_bytes", "shared_bytes", "threads", "ctas_per_sm")


def bwd_kernel_info(yq: torch.Tensor) -> dict:
    """The backward kernel as the card runs it for ``yq``'s shape and
    dtype: its plan, registers and local (spill) bytes a thread, shared
    bytes (static + dynamic) and threads a CTA, resident CTAs per SM."""
    b, h2, w2, c = _geometry(yq)
    plan = bwd_plan(b, h2, w2, c, yq.dtype)
    info = (ctypes.c_int * 5)()
    rc = _library().stem_bwd_kernel_info(h2, w2, plan.cs, plan.band_rows,
                                         _DTYPES[yq.dtype], info)
    _raise_if(rc, "stem_bwd_kernel_info")
    return {**dataclasses.asdict(plan), **dict(zip(_INFO_KEYS, info))}


# ------------------------------------------------- front GEMM + stats (B8)


def build_gemm_stats() -> tuple[str, str]:
    """Compile ``csrc/stem_gemm.cu`` unless this source is built already.
    Returns the library path and the compiler's ``-Xptxas -v`` log."""
    return nvcc.build(GEMM_SOURCE, nvcc.BASE_FLAGS)


def _gemm_library():
    global _gemm_lib
    if _gemm_lib is None:
        path, _ = build_gemm_stats()
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gemm_stats_launch.argtypes = [p, p, p, p, p] + [i] * 6 + [p]
        lib.gemm_stats_kernel_info.argtypes = [i, i, ctypes.POINTER(i)]
        for fn in (lib.gemm_stats_launch, lib.gemm_stats_kernel_info):
            fn.restype = ctypes.c_int
        _gemm_lib = lib
    return _gemm_lib


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """The GEMM kernel's tiling (``csrc/stem_gemm.cu`` gemm_stats_kernel).

    CTA ``(ct, s)`` (block index ``ct * splits + s``) owns the columns
    ``[ct * GEMM_TILE, (ct + 1) * GEMM_TILE)`` and the row tiles ``[s * run,
    min(row_tiles, (s + 1) * run))``, walked in order; it writes row ``ct *
    splits + s`` of the partial table [grid, 2, GEMM_TILE], and the fold
    adds a column's ``splits`` rows in that order.  ``k_steps`` is K rounded
    up to 16, in 16s; ``smem_bytes`` the dynamic shared memory.  The launch
    takes ``splits``, ``run`` and ``smem_bytes`` from here; the source only
    checks that they fit the kernel."""

    col_tiles: int
    row_tiles: int
    splits: int
    run: int
    grid: int
    k_steps: int
    smem_bytes: int


def gemm_smem_bytes(k: int) -> int:
    """Dynamic shared bytes of the GEMM kernel at depth K: the ring of hq
    tiles as they lie in memory (256*K bytes each), then, at a 1 KB
    boundary, the eight warps' two 2 KB staging blocks of y
    (``gemm_smem_need`` in the source)."""
    ring = -(-GEMM_STAGES * 2 * GEMM_TILE * k // 1024) * 1024
    return ring + 8 * 2 * 2048


def gemm_plan(m: int, n: int, k: int) -> GemmPlan:
    """The tiling of :func:`gemm_stats` at [M, K] x [K, N]: each column tile
    gets ``GEMM_CTAS // col_tiles`` CTAs (at least one, at most one a row
    tile), each a run of ``ceil(row_tiles / splits)`` row tiles; splits
    that would get none are dropped."""
    if m < 1 or n < 1 or not 1 <= k <= GEMM_MAX_K:
        raise ValueError(f"the GEMM kernel needs M, N >= 1 and 1 <= K <= {GEMM_MAX_K}, "
                         f"got M={m}, K={k}, N={n}")
    col_tiles, row_tiles = -(-n // GEMM_TILE), -(-m // GEMM_TILE)
    splits = max(1, min(row_tiles, GEMM_CTAS // col_tiles))
    run = -(-row_tiles // splits)
    splits = -(-row_tiles // run)
    return GemmPlan(col_tiles=col_tiles, row_tiles=row_tiles, splits=splits, run=run,
                    grid=col_tiles * splits, k_steps=-(-k // 16), smem_bytes=gemm_smem_bytes(k))


def check_gemm_shapes(hq: torch.Tensor, sq: torch.Tensor) -> None:
    """hq [M, K] and sq [K, N]."""
    if hq.ndim != 2 or sq.ndim != 2 or hq.shape[1] != sq.shape[0]:
        raise ValueError(f"expected hq [M, K] and sq [K, N], got {tuple(hq.shape)} "
                         f"and {tuple(sq.shape)}")


def gemm_stats(hq: torch.Tensor, sq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """hq [M, K] bf16, sq [K, N] bf16 -> (y = bf16(hq @ sq) [M, N], sums
    [2, N] fp32: per column, sum y and sum y*y of the rounded y).

    The kernel takes any M and needs K <= GEMM_MAX_K, N % 8 == 0, and hq and
    sq 16-byte aligned (it copies hq's row tiles as 16-byte vectors)."""
    check_gemm_shapes(hq, sq)
    _check(hq, "hq", dtype=torch.bfloat16, vec=8)
    _check(sq, "sq", dtype=torch.bfloat16, vec=8)
    if sq.device != hq.device:
        raise ValueError(f"sq must lie on {hq.device}, got {sq.device}")
    m, k = hq.shape
    n = sq.shape[1]
    if k > GEMM_MAX_K or n % 8 or m < 1:
        raise ValueError(f"the GEMM kernel needs K <= {GEMM_MAX_K}, N % 8 == 0 and M >= 1, "
                         f"got M={m}, K={k}, N={n}")
    plan = gemm_plan(m, n, k)
    y = torch.empty((m, n), device=hq.device, dtype=torch.bfloat16)
    partial = torch.empty((plan.grid, 2, GEMM_TILE), device=hq.device, dtype=torch.float32)
    sums = torch.empty((2, n), device=hq.device, dtype=torch.float32)
    with torch.cuda.device(hq.device):
        rc = _gemm_library().gemm_stats_launch(
            hq.data_ptr(), sq.data_ptr(), y.data_ptr(), partial.data_ptr(),
            sums.data_ptr(), m, n, k, plan.splits, plan.run, plan.smem_bytes,
            _stream(hq.device),
        )
    _raise_if(rc, "stem GEMM + stats")
    launches["gemm_stats"] += 1
    return y, sums


def gemm_stats_kernel_info(k: int = 70, m: int = 28672, n: int = 7168) -> dict:
    """The GEMM kernel as the card runs it at [M, K] x [K, N] (the source's
    ``gemm_stats_kernel_info``): its plan, registers and local (spill) bytes
    a thread, shared bytes (static + dynamic) and threads a CTA, resident
    CTAs per SM."""
    plan = gemm_plan(m, n, k)
    info = (ctypes.c_int * 5)()
    rc = _gemm_library().gemm_stats_kernel_info(k, plan.smem_bytes, info)
    _raise_if(rc, "gemm_stats_kernel_info")
    return {**dataclasses.asdict(plan), **dict(zip(_INFO_KEYS, info))}
