"""ResNet18 backbone in PyTorch, the counterpart of the JAX package's
``models/resnet.py``.

Same topology as torchvision's ``resnet18`` with the reference's swaps
(``bestengine.py:23-25``): ``conv1`` over ``input_channels`` and ``fc``
512 -> ``num_features``.  Module names follow torchvision, so the state
dict has the reference layout (``conv1``, ``bn1``, ``layer{1..4}.{0,1}.*``,
``downsample.{0,1}``, ``fc``).

Parameters are fp32; the forward computes in ``dtype`` (bf16 by default)
as the Flax model does: convolutions and the fc run on bf16 operands, and
each BatchNorm normalizes in fp32 and rounds its output to ``dtype``
(Flax ``nn.BatchNorm`` with ``dtype=bfloat16`` promotes against its fp32
statistics).  In train mode the BatchNorms follow Flax, not
``torch.nn.BatchNorm*`` (:class:`FlaxBatchNorm`).

``fused_stem=224`` is the ``stem_fusion="fused"`` flagship
(``models/resnet.py:238-312,428-441`` of the JAX package): a single-channel
CQT input skips the 224^2 image, conv1 runs as the precomposed quadrant
GEMM (:mod:`..ops.stem_fusion`) and bn1 + ReLU + max-pool as the fused stem
tail (:mod:`..ops.stem_tail`, the Hopper kernels of ``csrc/stem.cu`` on the
card).  The fused stem keeps the keys ``conv1.weight`` and ``bn1.*``, so a
checkpoint loads into either stem.

``fused_native_stem`` is ``resnet18_native`` with ``stem_fusion="fused"``
(``models/resnet.py:315-369,453-473`` of the JAX package): conv1 runs as two
stride-(4, 2) convolutions giving the row-parity planes of its output, and
bn1 + ReLU + max-pool as the native fused stem tail (:mod:`..ops.stem_native`,
the Hopper kernels of ``csrc/stem_native.cu`` and ``csrc/bn.cu`` on the
card), with the same keys.  ``fused_bn`` is ``bn_fusion="on"``: every trunk
BatchNorm, and bn1 where no fused stem tail handles it, is a
:class:`FusedBatchNorm` (``models/resnet.py:25-80`` of the JAX package),
whose train-mode reductions run as the column-sum kernels of
``csrc/bn.cu``; the state dict is unchanged.

The JAX model's ``w1_conv`` modes only change how a 3x3 conv on a width-1
feature map is contracted (its side columns multiply zero padding), never
its output; here every mode runs the plain 3x3 convolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bn_fused import batch_norm_eval, batch_norm_train
from ..parallel.collectives import data_count, data_sum, row_slice
from ..ops.stem_fusion import precomposed_conv1_quadrant
from ..ops.stem_native import (
    conv1_parity_native,
    native_bn_relu_pool,
    native_bn_relu_pool_train,
    stem_geometry,
)
from ..ops.stem_tail import bn_relu_pool, bn_relu_pool_train


def operands(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None):
    """(x, weight, bias, out_dtype) for a product in x's dtype: bf16
    operands with fp32 accumulation.  On the CPU, where PyTorch's bf16
    convolution is unreliable (wrong values on some shapes), the bf16
    operands are upcast exactly to fp32 and the output rounded back,
    which is the same arithmetic."""
    dtype = x.dtype
    weight = weight.to(dtype)
    bias = None if bias is None else bias.to(dtype)
    if x.device.type == "cpu" and dtype == torch.bfloat16:
        x, weight = x.float(), weight.float()
        bias = None if bias is None else bias.float()
    return x, weight, bias, dtype


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype (fp32 weights are
    cast to it per call)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias, dtype = operands(x, self.weight, self.bias)
        return self._conv_forward(x, weight, bias).to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias, dtype = operands(x, self.weight, self.bias)
        return F.linear(x, weight, bias).to(dtype)


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode BatchNorm with Flax's numerics: fp32 batch statistics
    from the input, the fast variance max(0, E[x^2] - E[x]^2), and
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` rounded once to the
    input's dtype (``flax/linen/normalization.py`` ``_compute_stats``,
    ``_normalize``), computed in place on an fp32 copy of the input.  The
    backward is the batch-statistics BatchNorm gradient, which is what
    autodiff of that forward gives.

    Under a mesh with several data ranks (:mod:`..parallel`) the statistics
    are the global batch's: the per-channel sums are summed over the data
    group, forward and backward, and the scale and bias gradients are this
    rank's parts of the global ones (the step sums them)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dims = (0,) + tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        xf = x.to(torch.float32, copy=True)  # normalized in place below
        ctx.sharded = row_slice(x.shape[0]) is not None
        if ctx.sharded:
            n = data_count(x.numel() // x.shape[1])
            sums = data_sum(torch.stack([xf.sum(dims), (xf * xf).sum(dims)]))
            mean = sums[0] / n
            var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
        else:
            mean = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        mul = rstd * weight.float()
        y = xf.sub_(mean.view(shape)).mul_(mul.view(shape)).add_(bias.float().view(shape))
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, rstd = ctx.saved_tensors
        if ctx.sharded:
            return _sharded_bn_backward(gy, x, weight, mean, rstd) + (None,)
        dx, dw, db = torch.ops.aten.native_batch_norm_backward(
            gy.to(x.dtype), x, weight.float(), None, None, mean, rstd, True,
            ctx.eps, [True, True, True],
        )
        return dx, dw.to(weight.dtype), db.to(weight.dtype), None


def _sharded_bn_backward(gy, x, weight, mean, rstd):
    """The batch-statistics BatchNorm gradient with the global batch's sums
    g and g * xhat (summed over the data group); the scale and bias
    gradients from this rank's sums."""
    dims = (0,) + tuple(range(2, x.ndim))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    g = gy.float()
    xhat = (x.float() - mean.view(shape)) * rstd.view(shape)
    local = torch.stack([g.sum(dims), (g * xhat).sum(dims)])
    total = data_sum(local)
    n = data_count(x.numel() // x.shape[1])
    se = (weight.float() * rstd).view(shape)
    dx = se * (g - total[0].view(shape) / n - xhat * total[1].view(shape) / n)
    return dx.to(x.dtype), local[1].to(weight.dtype), local[0].to(weight.dtype)


class FlaxBatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm with Flax ``nn.BatchNorm`` semantics (momentum 0.9).

    Train mode normalizes with the batch statistics of
    :class:`_BatchNormTrain` and sets the running averages to
    ``0.9 * old + 0.1 * batch`` with the *biased* batch variance
    (``torch.nn.BatchNorm*`` would use the unbiased one).  Eval mode
    normalizes with the running averages in fp32.  Either returns the
    input's dtype.  The state dict is torch's: ``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked`` (the last is
    kept for the reference layout and not advanced)."""

    flax_momentum = 0.9

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=0.1)

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.ndim < 2 or x.shape[1] != self.num_features:
            raise ValueError(
                f"expected [B, {self.num_features}, ...], got {tuple(x.shape)}"
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if self.training:
            y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias, self.eps)
            self.update_running(mean, var)
            return y
        # one pass of PyTorch's inference kernel: bf16 input, fp32
        # statistics and parameters, fp32 arithmetic, one rounding
        return F.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias,
            False, 0.0, self.eps,
        )

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Flax's running-average update with this batch's mean and biased
        variance."""
        m = self.flax_momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)


class FusedBatchNorm(FlaxBatchNorm):
    """:class:`FlaxBatchNorm` with the JAX package's ``FusedBatchNorm``
    numerics (``models/resnet.py:25-80`` there), same state dict.

    Train mode is :func:`..ops.bn_fused.batch_norm_train`: the batch
    statistics in one pass (the ``bn_sums`` kernel on the card), the
    normalize in the input's dtype, and the closed-form gradient from one
    more pass (``bn_grad_sums``); then the Flax running-average update.
    Eval mode is the JAX bf16 affine: ``mul = rsqrt(var + eps) * scale``
    rounded to the input's dtype, then ``(x - mean) * mul + bias`` in that
    dtype (not ``F.batch_norm``'s fp32 normalize)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if self.training:
            y, mean, var = batch_norm_train(x, self.weight, self.bias, self.eps)
            self.update_running(mean, var)
            return y
        return batch_norm_eval(
            x, self.running_mean, self.running_var, self.weight, self.bias, self.eps
        )


def _bn(channels: int, fused: bool = False) -> FlaxBatchNorm:
    return (FusedBatchNorm if fused else FlaxBatchNorm)(channels, eps=1e-5)


class BasicBlock(nn.Module):
    """torchvision BasicBlock: 3x3 conv-bn-relu, 3x3 conv-bn, residual."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 fused_bn: bool = False):
        super().__init__()
        self.conv1 = Conv2d(in_channels, filters, 3, stride, 1, bias=False)
        self.bn1 = _bn(filters, fused_bn)
        self.conv2 = Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = _bn(filters, fused_bn)
        self.downsample = None
        if stride != 1 or in_channels != filters:
            self.downsample = nn.Sequential(
                Conv2d(in_channels, filters, 1, stride, 0, bias=False),
                _bn(filters, fused_bn),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNet18(nn.Module):
    """Feature extractor: NCHW [B, C, H, W] -> [B, num_features] fp32
    (fc 512 -> num_features: the reference's swap, bestengine.py:25)."""

    def __init__(
        self,
        num_features: int = 256,
        input_channels: int = 3,
        dtype: torch.dtype = torch.bfloat16,
        fused_stem: int | None = None,
        fused_bn: bool = False,
        fused_native_stem: bool = False,
    ):
        super().__init__()
        if fused_stem is not None and fused_native_stem:
            raise ValueError("fused_stem and fused_native_stem are two different stems")
        self.input_channels = input_channels
        self.dtype = dtype
        self.fused_stem = fused_stem
        self.fused_native_stem = fused_native_stem
        self.conv1 = Conv2d(input_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64, fused_bn)
        in_ch = 64
        for stage in range(4):  # two BasicBlocks per stage
            filters = 64 * 2**stage
            stride = 2 if stage > 0 else 1
            self.add_module(f"layer{stage + 1}", nn.Sequential(
                BasicBlock(in_ch, filters, stride, fused_bn),
                BasicBlock(filters, filters, fused_bn=fused_bn),
            ))
            in_ch = filters
        self.fc = Linear(in_ch, num_features)

    def _fused_stem(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 1, src_h, src_w] unit CQT -> pooled stem output [B, 64, 56,
        56] (a channels-last view of the tail's NHWC result)."""
        yq = precomposed_conv1_quadrant(
            x[:, 0], self.conv1.weight, out_size=self.fused_stem, dtype=self.dtype
        )
        bn = self.bn1
        if self.training:
            pooled, mean, var = bn_relu_pool_train(yq, bn.weight, bn.bias, bn.eps)
            bn.update_running(mean, var)
        else:
            pooled = bn_relu_pool(
                yq, bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps
            )
        return pooled.to(self.dtype).permute(0, 3, 1, 2)

    def _native_stem(self, x: torch.Tensor) -> torch.Tensor:
        """[B, Cin, H, W] -> pooled stem output [B, 64, H2, Wout] (a
        channels-last view of the native tail's NHWC result)."""
        _, wreal = stem_geometry(x.shape[2], x.shape[3])
        ye, yo = conv1_parity_native(x.permute(0, 2, 3, 1), self.conv1.weight, dtype=self.dtype)
        bn = self.bn1
        if self.training:
            pooled, mean, var = native_bn_relu_pool_train(ye, yo, bn.weight, bn.bias,
                                                          wreal, bn.eps)
            bn.update_running(mean, var)
        else:
            pooled = native_bn_relu_pool(ye, yo, bn.running_mean, bn.running_var,
                                         bn.weight, bn.bias, wreal, bn.eps)
        return pooled.to(self.dtype).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = self.fused_stem
        if size is not None and x.shape[1] == 1 and tuple(x.shape[2:]) != (size, size):
            x = self._fused_stem(x)
        elif x.shape[1] != self.input_channels:
            raise ValueError(
                f"expected {self.input_channels} channels (NCHW), got {tuple(x.shape)}"
            )
        elif self.fused_native_stem:
            x = self._native_stem(x)
        else:
            x = x.to(self.dtype)
            x = F.relu(self.bn1(self.conv1(x)))
            x = F.max_pool2d(x, 3, 2, 1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
        x = x.mean(dim=(2, 3))  # global average pool -> [B, 512]
        return self.fc(x).float()
