"""Fused ResNet stem tail at the NATIVE (96x9) geometry: the counterpart of
the JAX package's ``ops/stem_native.py``.

``resnet18_native`` with ``stem_fusion="fused"`` runs conv1 7x7/s2 on the
raw [B, 96, 9, 1] CQT as two stride-(4, 2) convolutions
(:func:`conv1_parity_native`), one for the even and one for the odd output
rows, so the row-parity planes ``ye``, ``yo`` [B, H2, Wp*C] (channels
fastest) arrive with no repacking.  ``Wp`` may carry one extra conv column
(``w_pad``) whose values are masked out of the pool, the statistics and the
gradients.  Then BN + ReLU + 3x3/s2 max-pool as three computations, each
with a plain PyTorch version here and a hand-written Hopper kernel
(:mod:`.stem_native_cuda`):

- :func:`stats` -- per-lane sum and sum of squares of both planes
  (``_stats_pallas``; the column sums of ``csrc/bn.cu``);
- :func:`fwd` -- BN affine, ReLU, pad-column mask, max-pool, written as the
  compact pooled [B, H2, Wout, C] (``_fwd_pallas``, whose full-lane output
  the JAX package slices to the same thing);
- :func:`bwd` -- recompute the window max, route each pooled gradient to the
  first max tap in row-major window order, ReLU and real-column mask,
  ``dy = dz*se`` and the per-lane sums of dz and dz*y (``_bwd_pallas``; it
  reads the compact pooled gradient, not the zero-expanded full-lane one).

The plain versions follow the Pallas kernel bodies: fp32 compute and one
rounding at the end (``stem_native.py:239-247,287-303``).  A CPU tensor
goes to the plain version; a CUDA tensor to the kernel, which raises if it
cannot launch.  :func:`native_bn_relu_pool` and
:func:`native_bn_relu_pool_train` are the differentiable ops
(``torch.autograd.Function``s with the JAX VJPs, ``stem_native.py:482-646``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import on_card
from ..parallel.collectives import data_count, data_sum, data_sums
from . import stem_native_cuda
from .stem_tail import _shift, _shift_back, lane_affine

_NEG = -1.0  # below every post-ReLU value: stands in for the pool's -inf pad


def stem_geometry(h: int, w: int) -> tuple[int, int]:
    """(H2, Wy) of the parity planes for an [H, W] input through conv1
    7x7/s2 pad 3 (torchvision arithmetic); the conv height must be even."""
    hy = (h + 6 - 7) // 2 + 1
    wy = (w + 6 - 7) // 2 + 1
    if hy % 2:
        raise ValueError(f"conv1 output height {hy} must be even (H={h})")
    return hy // 2, wy


def pool_out_width(wreal: int) -> int:
    return (wreal + 2 - 3) // 2 + 1


def conv1_parity_native(
    x: torch.Tensor, weight: torch.Tensor, *, w_pad: int = 1,
    dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """conv1 7x7/s2 as two stride-(4, 2) convolutions -> row-parity planes
    (ye, yo), each [B, H2, (Wy + w_pad) * C] in ``dtype``.

    x: [B, H, W, Cin] (the JAX layout); weight: the port's OIHW conv1
    weight [C, Cin, 7, 7].  ``ye[b, i] == conv(x)[b, 2i]`` and
    ``yo[b, i] == conv(x)[b, 2i+1]`` (``stem_native.py:70-109``): even rows
    are a stride-4 conv padded (3, .) at the top, odd rows one padded
    (1, .).  ``w_pad`` extra output columns read right padding; every
    consumer masks them."""
    from ..models.resnet import operands

    b, h, w, _ = x.shape
    kh, kw = weight.shape[2], weight.shape[3]
    c = weight.shape[0]
    h2, wy = stem_geometry(h, w)
    wp = wy + w_pad
    w_hi = 2 * (wp - 1) + kw - 3 - w
    pe_hi = max(0, 4 * (h2 - 1) + (kh - 3) - (h - 1))
    po_hi = max(0, 4 * (h2 - 1) + (kh - 1) - (h - 1))
    # padded in NHWC and seen as NCHW with channels-last strides, with a
    # channels-last weight: the convolutions then write NHWC, and the planes
    # are views of their outputs
    planes = []
    for top, bottom in ((3, pe_hi), (1, po_hi)):
        xp = F.pad(x.to(dtype), (0, 0, 3, w_hi, top, bottom)).permute(0, 3, 1, 2)
        xp, wt, _, out_dtype = operands(xp, weight, None)
        y = F.conv2d(xp, wt.contiguous(memory_format=torch.channels_last), stride=(4, 2))
        y = y.to(out_dtype)
        assert y.shape == (b, c, h2, wp), (tuple(y.shape), (b, c, h2, wp))
        planes.append(y.permute(0, 2, 3, 1).reshape(b, h2, wp * c).contiguous())
    return planes[0], planes[1]


# ------------------------------------------------------------ plain versions


def _cols(y: torch.Tensor, c: int) -> torch.Tensor:
    """[B, H2, Wp*C] -> [B, H2, Wp, C] view."""
    b, h2, lanes = y.shape
    return y.reshape(b, h2, lanes // c, c)


def _relu(y, se, oe, wreal):
    """(z, r) in fp32 as [B, H2, Wp, C]: z = y*se + oe (a product, then a
    sum), r = max(z, 0) with NaN kept, -1 on the pad columns."""
    z = _cols(y, se.shape[0]).float() * se + oe
    r = torch.maximum(z, torch.zeros_like(z))
    r[:, :, wreal:] = _NEG
    return z, r


def _taps(re, ro, wout):
    """The nine window taps of every pooled output, [B, H2, Wout, C] each,
    keyed (a, b) = (row offset, col offset) + 1: rows O[i-1], E[i], O[i];
    columns 2j-1, 2j, 2j+1 (-1 outside the map)."""
    rows = {0: _shift(ro, 1, _NEG), 1: re, 2: ro}  # row i shows O[i-1]
    taps = {}
    for a, r in rows.items():
        fill = torch.full_like(r[:, :, :1], _NEG)
        rp = torch.cat([fill, r, fill], dim=2)  # padded column w + 1
        for b in range(3):
            taps[a, b] = rp[:, :, b:b + 2 * wout - 1:2]
    return taps


def _window_max(taps):
    m = taps[0, 0]
    for key in sorted(taps)[1:]:
        m = torch.maximum(m, taps[key])
    return m


def stats_plain(ye: torch.Tensor, yo: torch.Tensor) -> torch.Tensor:
    """[2, L] fp32 per lane: sum and sum of squares over both planes."""
    yef, yof = ye.float(), yo.float()
    return torch.stack([yef.sum((0, 1)) + yof.sum((0, 1)),
                        (yef * yef).sum((0, 1)) + (yof * yof).sum((0, 1))])


def fwd_plain(ye, yo, se, oe, wreal: int) -> torch.Tensor:
    """max_pool3x3s2(relu(y*se + oe)) over the real columns -> pooled
    [B, H2, Wout, C] in y's dtype."""
    _, re = _relu(ye, se, oe, wreal)
    _, ro = _relu(yo, se, oe, wreal)
    return _window_max(_taps(re, ro, pool_out_width(wreal))).to(ye.dtype)


def bwd_plain(ye, yo, g, se, oe, wreal: int):
    """(dye, dyo like y, sum dz [L], sum dz*y [L] fp32 per lane) for the
    pooled gradient g [B, H2, Wout, C]: dz is the gradient at the BN
    output, dy = dz*se.  Each window's gradient goes to its first tap equal
    to the max in row-major (a, b) order; a source adds its windows'
    gradients in that order (``stem_native.py:180-205``)."""
    ze, re = _relu(ye, se, oe, wreal)
    zo, ro = _relu(yo, se, oe, wreal)
    wout = pool_out_width(wreal)
    taps = _taps(re, ro, wout)
    m = _window_max(taps)
    gf = g.float()
    zero = torch.zeros_like(gf)
    taken = torch.zeros(m.shape, dtype=torch.bool, device=m.device)
    # gradient on each plane's source columns, padded by one column a side
    b_, h2, wp, c = re.shape
    acc = {p: re.new_zeros(b_, h2, wp + 2, c) for p in ("e", "o")}
    for a in range(3):
        for b in range(3):
            eq = taps[a, b] == m
            sel = eq & ~taken
            taken = taken | eq
            contrib = torch.where(sel, gf, zero)
            if a == 0:  # source row i-1 gathers from pooled row i
                contrib = _shift_back(contrib, 1)
            plane = acc["e" if a == 1 else "o"]
            cols = plane[:, :, b:b + 2 * wout - 1:2]
            cols.copy_(cols + contrib)
    real = (torch.arange(wp, device=re.device) < wreal)[:, None]
    live = lambda z: (z > 0) & real  # noqa: E731
    dze = torch.where(live(ze), acc["e"][:, :, 1:wp + 1], 0.0)
    dzo = torch.where(live(zo), acc["o"][:, :, 1:wp + 1], 0.0)
    dye = (dze * se).to(ye.dtype).reshape(ye.shape)
    dyo = (dzo * se).to(yo.dtype).reshape(yo.shape)
    flat = lambda t: t.reshape(t.shape[0], t.shape[1], -1)  # noqa: E731
    sum_dz = flat(dze).sum((0, 1)) + flat(dzo).sum((0, 1))
    sum_dzy = (flat(dze) * ye.float()).sum((0, 1)) + (flat(dzo) * yo.float()).sum((0, 1))
    return dye, dyo, sum_dz, sum_dzy


# ----------------------------------------------------------------- dispatch


def stats(ye, yo):
    if on_card(ye):
        return stem_native_cuda.stats(ye, yo)
    return stats_plain(ye, yo)


def fwd(ye, yo, se, oe, wreal):
    if on_card(ye):
        return stem_native_cuda.fwd(ye, yo, se, oe, wreal)
    return fwd_plain(ye, yo, se, oe, wreal)


def bwd(ye, yo, g, se, oe, wreal):
    if on_card(ye):
        return stem_native_cuda.bwd(ye, yo, g, se, oe, wreal)
    return bwd_plain(ye, yo, g, se, oe, wreal)


# ------------------------------------------------------------ public ops


def _fold_real(per_lane: torch.Tensor, wreal: int, c: int) -> torch.Tensor:
    """Per-lane [L] -> per-channel [C], the pad columns left out."""
    return per_lane.reshape(-1, c)[:wreal].sum(dim=0)


def native_batch_stats(
    ye: torch.Tensor, yo: torch.Tensor, channels: int, wreal: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) [C] fp32 over both parity planes, pad columns excluded:
    Flax's fast variance E[x^2] - E[x]^2, unclipped
    (``stem_native.py:451-479``)."""
    b, h2, _ = ye.shape
    n = data_count(b * 2 * h2 * wreal)
    s = data_sum(stats(ye, yo))  # the global batch's under a mesh
    mean = _fold_real(s[0], wreal, channels) / n
    return mean, _fold_real(s[1], wreal, channels) / n - mean**2


def _grad_for_kernel(g, ye):
    return g.to(ye.dtype).contiguous()


def _param_grads(d_off, d_se, mean, rstd):
    """(sum dz*xhat, sum dz) per channel from the per-channel sums."""
    return rstd * (d_se - mean.float() * d_off), d_off


class _NativeBNReLUPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ye, yo, mean, var, scale, bias, wreal, eps):
        se, oe, _ = lane_affine(mean, var, scale, bias, eps)
        ctx.save_for_backward(ye, yo, mean, var, scale, bias)
        ctx.wreal, ctx.eps = wreal, eps
        return fwd(ye, yo, se, oe, wreal)

    @staticmethod
    def backward(ctx, g):
        ye, yo, mean, var, scale, bias = ctx.saved_tensors
        c = scale.shape[0]
        se, oe, rstd = lane_affine(mean, var, scale, bias, ctx.eps)
        dye, dyo, sdz, sdzy = bwd(ye, yo, _grad_for_kernel(g, ye), se, oe, ctx.wreal)
        d_off = _fold_real(sdz, ctx.wreal, c)  # sum dz
        d_se = _fold_real(sdzy, ctx.wreal, c)  # sum dz*y
        dscale, dbias = _param_grads(d_off, d_se, mean, rstd)
        dvar = -0.5 * scale.float() * rstd**3 * (d_se - mean.float() * d_off)
        return (
            dye, dyo, (-se * d_off).to(mean.dtype), dvar.to(var.dtype),
            dscale.to(scale.dtype), dbias.to(bias.dtype), None, None,
        )


def native_bn_relu_pool(ye, yo, mean, var, scale, bias, wreal: int,
                        eps: float = 1e-5) -> torch.Tensor:
    """``max_pool3x3s2(relu(batchnorm(y)))`` on the parity planes with given
    statistics -> [B, H2, Wout, C] in y's dtype.  Its gradient reaches ye,
    yo, mean, var, scale and bias (``stem_native.py:482-553``)."""
    return _NativeBNReLUPool.apply(ye, yo, mean, var, scale, bias, wreal, eps)


class _NativeBNReLUPoolTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ye, yo, scale, bias, wreal, eps):
        c = scale.shape[0]
        mean, var = native_batch_stats(ye, yo, c, wreal)
        se, oe, _ = lane_affine(mean, var, scale, bias, eps)
        ctx.save_for_backward(ye, yo, mean, var, scale, bias)
        ctx.wreal, ctx.eps = wreal, eps
        ctx.mark_non_differentiable(mean, var)
        return fwd(ye, yo, se, oe, wreal), mean, var

    @staticmethod
    def backward(ctx, g, _gmean, _gvar):
        ye, yo, mean, var, scale, bias = ctx.saved_tensors
        wreal = ctx.wreal
        b, h2, lanes = ye.shape
        c = scale.shape[0]
        n = data_count(b * 2 * h2 * wreal)
        se, oe, rstd = lane_affine(mean, var, scale, bias, ctx.eps)
        dye, dyo, sdz, sdzy = bwd(ye, yo, _grad_for_kernel(g, ye), se, oe, wreal)
        d_off = _fold_real(sdz, wreal, c)
        d_se = _fold_real(sdzy, wreal, c)
        sum_dzxhat, dbias = _param_grads(d_off, d_se, mean, rstd)  # this rank's parts
        all_off, all_se = data_sums(d_off, d_se)  # the global batch's under a mesh
        # batch-statistics term on the real columns: dy += A + B*y
        bch = -se * rstd * _param_grads(all_off, all_se, mean, rstd)[0] / n
        ach = -se * all_off / n - bch * mean.float()
        real = (torch.arange(lanes // c, device=ye.device) < wreal)[:, None]
        a_lane = torch.where(real, ach, 0.0).reshape(lanes)
        b_lane = torch.where(real, bch, 0.0).reshape(lanes)

        def corrected(direct, y):
            # the direct term was rounded to y's dtype; the sum rounds again
            return ((direct.float() + a_lane) + b_lane * y.float()).to(y.dtype)

        return (corrected(dye, ye), corrected(dyo, yo), sum_dzxhat.to(scale.dtype),
                dbias.to(bias.dtype), None, None)


def native_bn_relu_pool_train(
    ye: torch.Tensor, yo: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
    wreal: int, eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode native stem tail: batch statistics from both planes
    (pad columns excluded), then ``max_pool(relu(batchnorm(y)))``.  Returns
    (pooled [B, H2, Wout, C], mean [C], var [C]); mean and var feed the
    running averages and carry no gradient.  The backward is the exact
    batch-statistics BatchNorm gradient (``stem_native.py:598-643``)."""
    return _NativeBNReLUPoolTrain.apply(ye, yo, scale, bias, wreal, eps)
