"""Fused training-mode BatchNorm for the ResNet trunk: the counterpart of the
JAX package's ``ops/bn_pallas.py``.

Each direction's batch reductions take one pass over the activation:

- forward: per-channel sum and sum of squares of y (``_sums_pallas``) ->
  batch mean and variance;
- backward: per-channel sum g and sum g*y (``_grad_sums_pallas``), from
  which the batch-statistics BatchNorm gradient follows in closed form
  (``bn_pallas.py:208-236``).

Each reduction has a plain PyTorch version here (fp32 upcast before the
products, ``bn_pallas.py:82-84,120-123``) and a hand-written Hopper kernel in
``csrc/bn.cu`` (:mod:`.bn_cuda`).  A CPU tensor goes to the plain version; a
CUDA tensor to the kernel, which raises if it cannot launch.  The normalize
apply and the backward's elementwise ``dy`` stay plain PyTorch, as the JAX
package leaves them to XLA.

Tensors are ``[B, C, ...]`` (channels at dim 1, the port's NCHW modules),
contiguous or channels last.  The JAX package's 128-lane view
(``bn_pallas.py:46-53``), which rejects sizes that are not a multiple of
lcm(C, 128), is a TPU layout rule the port does not carry over.

Under a mesh with several data ranks (:mod:`..parallel`) both directions'
sums are summed over the data group (:func:`..parallel.collectives.data_sum`
on the kernels' outputs), so the statistics and the input gradient are the
global batch's; the scale and bias gradients stay this rank's parts.
"""

from __future__ import annotations

import torch

from ..device import on_card
from ..parallel.collectives import data_count, data_sum
from . import bn_cuda

def _dims(y: torch.Tensor) -> tuple[int, ...]:
    return (0,) + tuple(range(2, y.ndim))


def _per_channel(t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[C] -> a view broadcasting over y's channel dim."""
    return t.view((1, -1) + (1,) * (y.ndim - 2))


# ------------------------------------------------------------ plain versions


def sums_plain(y: torch.Tensor) -> torch.Tensor:
    """[2, C] fp32: per-channel sum and sum of squares of y [B, C, ...]."""
    yf = y.float()
    dims = _dims(y)
    return torch.stack([yf.sum(dims), (yf * yf).sum(dims)])


def grad_sums_plain(y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """[2, C] fp32: per-channel sum g and sum g*y."""
    yf, gf = y.float(), g.float()
    dims = _dims(y)
    return torch.stack([gf.sum(dims), (gf * yf).sum(dims)])


# ----------------------------------------------------------------- dispatch


def sums(y: torch.Tensor) -> torch.Tensor:
    if on_card(y):
        return bn_cuda.sums(y)
    return sums_plain(y)


def grad_sums(y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    if on_card(y):
        return bn_cuda.grad_sums(y, g)
    return grad_sums_plain(y, g)


# ----------------------------------------------------------------- public op


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, scale, bias, eps):
        c = y.shape[1]
        n = data_count(y.numel() // c)
        s = data_sum(sums(y))  # the global batch's under a mesh
        # fast variance, no clamp (bn_pallas.py:191-192)
        mean = s[0] / n
        var = s[1] / n - mean**2
        mul = (torch.rsqrt(var + eps) * scale.float()).to(y.dtype)
        out = (y - _per_channel(mean.to(y.dtype), y)) * _per_channel(mul, y)
        out = out + _per_channel(bias.to(y.dtype), y)
        ctx.save_for_backward(y, mean, var, scale)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, _gmean, _gvar):
        y, mean, var, scale = ctx.saved_tensors
        c = y.shape[1]
        n = data_count(y.numel() // c)
        g = g.to(y.dtype)
        if g.stride() != y.stride():  # the kernel reads both through one view
            g = torch.empty_like(y).copy_(g)
        s = grad_sums(y, g)
        sum_g, sum_gy = s[0], s[1]
        rstd = torch.rsqrt(var + ctx.eps)
        se = scale.float() * rstd
        sum_gxhat = rstd * (sum_gy - mean * sum_g)  # this rank's part of dscale
        total = data_sum(s)  # the global batch's sums under a mesh
        # dy = se*(g - sum_g/n - xhat*sum_gxhat/n) = se*g + B*y + A
        bch = -se * rstd * (rstd * (total[1] - mean * total[0])) / n
        ach = -se * total[0] / n - bch * mean
        # fp32 copies, updated in place: (g*se + y*B) + A, rounded once
        dy = g.to(torch.float32, copy=True).mul_(_per_channel(se, y))
        dy.add_(y.to(torch.float32, copy=True).mul_(_per_channel(bch, y)))
        dy.add_(_per_channel(ach, y))
        return dy.to(y.dtype), sum_gxhat.to(scale.dtype), sum_g.to(scale.dtype), None


def batch_norm_train(
    y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode BatchNorm over the channels (dim 1) of ``y``.

    Returns ``(out, mean, var)``: ``out`` in y's dtype, computed as
    ``(y - mean) * mul + bias`` in that dtype with ``mul = rsqrt(var + eps) *
    scale`` rounded to it (``bn_pallas.py:197-198``); ``mean`` and ``var``
    are the fp32 batch statistics (E[x^2] - E[x]^2) for the running
    averages, and carry no gradient.  The gradient reaching y is the full
    batch-statistics BatchNorm gradient, rounded once to y's dtype."""
    return _BatchNormTrain.apply(y, scale, bias, eps)


def batch_norm_eval(
    x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor,
    bias: torch.Tensor, eps: float = 1e-5,
) -> torch.Tensor:
    """Eval-mode affine of the JAX ``FusedBatchNorm`` (``models/resnet.py:
    72-79``): ``mul = rsqrt(var + eps) * scale`` rounded to x's dtype, then
    ``(x - mean) * mul + bias`` in x's dtype."""
    mul = (torch.rsqrt(var.float() + eps) * scale.float()).to(x.dtype)
    out = (x - _per_channel(mean.to(x.dtype), x)) * _per_channel(mul, x)
    return out + _per_channel(bias.to(x.dtype), x)
