"""Fused ResNet stem tail: BatchNorm + ReLU + 3x3/s2 max-pool on conv1's
output in quadrant layout — the counterpart of the JAX package's
``ops/stem_pallas.py``.

Layout (``stem_pallas.py:11-24``): conv1's output ``[B, H, W, C]`` is held
as ``[B, 2, H2, L]`` with ``L = 2*W2*C``::

    yq[b, rp, h, cp*W2*C + j*C + f] == y[b, 2*h+rp, 2*j+cp, f]

so a 3x3/s2/pad-1 pooling window of output (i, j) reads rows
{O[i-1], E[i], O[i]} and columns {O[j-1], E[j], O[j]} of the even/odd
parity planes.  :func:`.stem_fusion.precomposed_conv1_quadrant` emits the
layout as its GEMM's column order, so it costs nothing.

Three computations, each with a plain PyTorch version here and a
hand-written Hopper kernel in ``csrc/stem.cu`` (:mod:`.stem_cuda`):

- :func:`stats` — per-channel sum and sum of squares (``_stats_pallas``);
- :func:`fwd` — BN affine, ReLU, max-pool (``_fwd_pallas``);
- :func:`bwd` — recompute the window max, route the pooled gradient to the
  first max tap in row-major window order, ReLU mask, ``dy = dz*se`` and
  the per-channel sums of dz and dz*y (``_bwd_pallas``);
- :func:`gemm_stats` — the quadrant front's GEMM with the per-column sum
  and sum of squares of its rounded output (``_gemm_stats_pallas``, kernel
  in ``csrc/stem_gemm.cu``).  No model path calls it, as in the JAX
  package: its entry point is ``tools/profile_stem_pieces.py``.

The plain versions follow the Pallas kernel bodies, not the XLA twin: the
kernels upcast y and g to fp32, compute in fp32 and round once at the end
(``stem_pallas.py:226-229,275-281``).  A CPU tensor goes to the plain
version; a CUDA tensor to the kernel, which raises if it cannot launch.

:func:`bn_relu_pool` and :func:`bn_relu_pool_train` are the differentiable
ops (``torch.autograd.Function``s with the JAX package's VJPs,
``stem_pallas.py:530-563,598-637``).
"""

from __future__ import annotations

import torch

from ..device import on_card
from ..parallel.collectives import data_count, data_sum, data_sums
from . import stem_cuda
from .cqt import fp32_matmul


def quadrant_pack(y: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] (H, W even) -> quadrant layout [B, 2, H//2, W*C]."""
    b, h, w, c = y.shape
    t = y.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 2, 1, 4, 3, 5)
    return t.reshape(b, 2, h // 2, w * c)


def quadrant_unpack(yq: torch.Tensor, channels: int) -> torch.Tensor:
    """Inverse of :func:`quadrant_pack`."""
    b, _, h2, lanes = yq.shape
    w2 = lanes // (2 * channels)
    t = yq.reshape(b, 2, h2, 2, w2, channels).permute(0, 2, 1, 4, 3, 5)
    return t.reshape(b, 2 * h2, 2 * w2, channels)


def _planes(yq: torch.Tensor) -> torch.Tensor:
    """[B, 2, H2, L] -> [B, 2 (row parity), H2, 2 (col parity), W2, C] view
    (C = L // (2*H2): square maps, as the JAX package reads the layout)."""
    b, _, h2, lanes = yq.shape
    c = lanes // (2 * h2)
    return yq.reshape(b, 2, h2, 2, lanes // (2 * c), c)


def _shift(x: torch.Tensor, dim: int, fill: float) -> torch.Tensor:
    """Shift by +1 along ``dim`` (index k shows k-1; index 0 <- fill)."""
    pad = torch.full_like(x.narrow(dim, 0, 1), fill)
    return torch.cat([pad, x.narrow(dim, 0, x.shape[dim] - 1)], dim=dim)


def _shift_back(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Shift by -1 along ``dim`` (index k shows k+1; last index <- 0)."""
    pad = torch.zeros_like(x.narrow(dim, 0, 1))
    return torch.cat([x.narrow(dim, 1, x.shape[dim] - 1), pad], dim=dim)


def _relu_planes(yq, se, oe):
    """(z, r) in fp32 as [B, 2, H2, 2, W2, C]: z = y*se + oe (a product,
    then a sum: no fused multiply-add), r = max(z, 0) with NaN kept."""
    z = _planes(yq).float() * se + oe
    return z, torch.maximum(z, torch.zeros_like(z))


def _taps(r):
    """The nine window taps of every output, [B, H2, W2, C] each, keyed by
    (a, b) = (row offset, col offset) + 1; taps outside the map hold -1."""
    # rows: a=0 O[i-1], a=1 E[i], a=2 O[i]; cols: b=0 O[j-1], b=1 E[j], b=2 O[j]
    rows = {0: _shift(r[:, 1], 1, -1.0), 1: r[:, 0], 2: r[:, 1]}
    taps = {}
    for a, plane in rows.items():  # plane [B, H2, 2, W2, C]
        taps[a, 0] = _shift(plane[:, :, 1], 2, -1.0)
        taps[a, 1] = plane[:, :, 0]
        taps[a, 2] = plane[:, :, 1]
    return taps


def _window_max(taps):
    """Max over the nine taps: the column maxima of rows E[i], O[i] and
    O[i-1], then their max (``stem_pallas.py:99-110``)."""
    col_max = [
        torch.maximum(torch.maximum(taps[a, 1], taps[a, 2]), taps[a, 0])
        for a in (1, 2, 0)
    ]
    return torch.maximum(torch.maximum(col_max[0], col_max[1]), col_max[2])


# ------------------------------------------------------------ plain versions


def stats_plain(yq: torch.Tensor) -> torch.Tensor:
    """[2, C] fp32: per-channel sum and sum of squares of y."""
    y = _planes(yq).float()
    c = y.shape[-1]
    y = y.reshape(-1, c)
    return torch.stack([y.sum(dim=0), (y * y).sum(dim=0)])


def fwd_plain(yq: torch.Tensor, se: torch.Tensor, oe: torch.Tensor) -> torch.Tensor:
    """max_pool3x3s2(relu(y*se + oe)) -> [B, H2, W2*C] in y's dtype."""
    _, r = _relu_planes(yq, se, oe)
    m = _window_max(_taps(r))
    b, h2, w2, c = m.shape
    return m.to(yq.dtype).reshape(b, h2, w2 * c)


def bwd_plain(
    yq: torch.Tensor, g: torch.Tensor, se: torch.Tensor, oe: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dy like y, sum dz [C], sum dz*y [C]) for the pooled gradient g
    [B, H2, W2*C]: dz is the gradient at the BN output, dy = dz*se."""
    z, r = _relu_planes(yq, se, oe)
    taps = _taps(r)
    m = _window_max(taps)
    gf = g.reshape(m.shape).float()
    zero = torch.zeros_like(gf)
    taken = torch.zeros(m.shape, dtype=torch.bool, device=m.device)
    # acc[rp][cp]: gradient landing on that source plane, added in tap order
    acc = [[zero, zero], [zero, zero]]
    for a in range(3):
        for b in range(3):
            eq = taps[a, b] == m
            sel = eq & ~taken
            taken = taken | eq
            contrib = torch.where(sel, gf, zero)
            if a == 0:  # source row i-1 gathers from output row i
                contrib = _shift_back(contrib, 1)
            if b == 0:  # source col j-1 gathers from output col j
                contrib = _shift_back(contrib, 2)
            rp, cp = (0 if a == 1 else 1), (0 if b == 1 else 1)
            acc[rp][cp] = acc[rp][cp] + contrib
    dz = torch.stack(
        [torch.stack(acc[0], dim=2), torch.stack(acc[1], dim=2)], dim=1
    )  # [B, 2, H2, 2, W2, C]
    dz = torch.where(z > 0, dz, torch.zeros_like(dz))
    c = dz.shape[-1]
    dy = (dz * se).to(yq.dtype).reshape(yq.shape)
    yf = _planes(yq).float()
    return dy, dz.reshape(-1, c).sum(dim=0), (dz * yf).reshape(-1, c).sum(dim=0)


def gemm_stats_plain(hq: torch.Tensor, sq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """hq [M, K] bf16, sq [K, N] bf16 -> (y [M, N] bf16, sums [2, N] fp32):
    y = bf16(hq @ sq) from fp32 products and sums (the operands upcast
    exactly to fp32, TF32 off), rounded once; sums = per column (sum y,
    sum y*y) of the rounded y in fp32."""
    with fp32_matmul():
        y = (hq.float() @ sq.float()).to(hq.dtype)
    yf = y.float()
    return y, torch.stack([yf.sum(dim=0), (yf * yf).sum(dim=0)])


# ----------------------------------------------------------------- dispatch


def stats(yq: torch.Tensor) -> torch.Tensor:
    if on_card(yq):
        return stem_cuda.stats(yq)
    return stats_plain(yq)


def fwd(yq: torch.Tensor, se: torch.Tensor, oe: torch.Tensor) -> torch.Tensor:
    if on_card(yq):
        return stem_cuda.fwd(yq, se, oe)
    return fwd_plain(yq, se, oe)


def bwd(yq, g, se, oe):
    if on_card(yq):
        return stem_cuda.bwd(yq, g, se, oe)
    return bwd_plain(yq, g, se, oe)


def gemm_stats(
    hq: torch.Tensor, sq: torch.Tensor, *, m_tile: int = 256
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, sums) of :func:`gemm_stats_plain`, with ``_gemm_stats_pallas``'s
    signature.  ``m_tile`` is the TPU grid's row tile: there the grid is
    ``M // m_tile`` and the last ``M % m_tile`` rows are never written, so
    here an ``M`` it does not divide raises.  It changes nothing else."""
    stem_cuda.check_gemm_shapes(hq, sq)
    if m_tile < 1 or hq.shape[0] % m_tile:
        raise ValueError(f"M={hq.shape[0]} is not a multiple of m_tile={m_tile}")
    if on_card(hq):
        return stem_cuda.gemm_stats(hq, sq)
    return gemm_stats_plain(hq, sq)


# ------------------------------------------------------------ public ops


def quadrant_batch_stats(yq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) [C] fp32 over a quadrant-layout conv output: Flax
    BatchNorm's fast variance E[x^2] - E[x]^2, unclipped as in
    ``stem_pallas.py:436-459``."""
    _, _, h2, lanes = yq.shape
    c = lanes // (2 * h2)
    n = data_count(yq.numel() // c)
    sums = data_sum(stats(yq))  # the global batch's under a mesh
    mean = sums[0] / n
    return mean, sums[1] / n - mean**2


def lane_affine(mean, var, scale, bias, eps):
    """Per-channel BN affine: (se, oe, rstd) with se = scale*rstd and
    oe = bias - mean*se, all fp32 (``stem_pallas.py:482-488``)."""
    rstd = torch.rsqrt(var.float() + eps)
    se = scale.float() * rstd
    oe = bias.float() - mean.float() * se
    return se.contiguous(), oe.contiguous(), rstd


def _pooled(yq, se, oe):
    b, _, h2, lanes = yq.shape
    c = lanes // (2 * h2)
    return fwd(yq, se, oe).reshape(b, h2, lanes // (2 * c), c)


def _pooled_grad(g, yq):
    b, _, h2, lanes = yq.shape
    return g.reshape(b, h2, lanes // 2).to(yq.dtype).contiguous()


class _BNReLUPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, yq, mean, var, scale, bias, eps):
        se, oe, _ = lane_affine(mean, var, scale, bias, eps)
        ctx.save_for_backward(yq, mean, var, scale, bias)
        ctx.eps = eps
        return _pooled(yq, se, oe)

    @staticmethod
    def backward(ctx, g):
        yq, mean, var, scale, bias = ctx.saved_tensors
        se, oe, rstd = lane_affine(mean, var, scale, bias, ctx.eps)
        dy, d_off, d_se = bwd(yq, _pooled_grad(g, yq), se, oe)
        mu = mean.float()
        dscale = rstd * (d_se - mu * d_off)  # = sum(dz * xhat)
        dvar = -0.5 * scale.float() * rstd**3 * (d_se - mu * d_off)
        return (
            dy.to(yq.dtype), (-se * d_off).to(mean.dtype), dvar.to(var.dtype),
            dscale.to(scale.dtype), d_off.to(bias.dtype), None,
        )


def bn_relu_pool(yq, mean, var, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    """``max_pool3x3s2(relu(batchnorm(y)))`` on quadrant-layout y [B, 2, H2, L]
    with given statistics; returns [B, H2, W2, C] in y's dtype.  Its
    gradient reaches y, mean, var, scale and bias."""
    return _BNReLUPool.apply(yq, mean, var, scale, bias, eps)


class _BNReLUPoolTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, yq, scale, bias, eps):
        mean, var = quadrant_batch_stats(yq)
        se, oe, _ = lane_affine(mean, var, scale, bias, eps)
        ctx.save_for_backward(yq, mean, var, scale, bias)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return _pooled(yq, se, oe), mean, var

    @staticmethod
    def backward(ctx, g, _gmean, _gvar):
        yq, mean, var, scale, bias = ctx.saved_tensors
        c = mean.shape[0]
        n = data_count(yq.numel() // c)
        se, oe, rstd = lane_affine(mean, var, scale, bias, ctx.eps)
        dy_direct, d_off, d_se = bwd(yq, _pooled_grad(g, yq), se, oe)
        mu = mean.float()
        sum_dzxhat = rstd * (d_se - mu * d_off)  # this rank's part of dscale
        all_off, all_se = data_sums(d_off, d_se)  # the global batch's under a mesh
        # batch-statistics term: dy += A + B*y per channel
        #   B = -se*rstd*sum(dz*xhat)/n,  A = -se*sum(dz)/n - B*mean
        bch = -se * rstd * (rstd * (all_se - mu * all_off)) / n
        ach = -se * all_off / n - bch * mu
        planes = _planes(yq)
        # dy_direct was rounded to y's dtype; the sum rounds again
        dy = (_planes(dy_direct).float() + ach) + bch * planes.float()
        return (
            dy.to(yq.dtype).reshape(yq.shape), sum_dzxhat.to(scale.dtype),
            d_off.to(bias.dtype), None,
        )


def bn_relu_pool_train(
    yq: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode stem tail: batch statistics from y, then
    ``max_pool(relu(batchnorm(y)))``.  Returns (pooled [B, H2, W2, C],
    mean [C], var [C]); mean and var feed the running averages and carry
    no gradient.  The backward gives the exact batch-statistics BatchNorm
    gradient (``stem_pallas.py:604-637``)."""
    return _BNReLUPoolTrain.apply(yq, scale, bias, eps)
