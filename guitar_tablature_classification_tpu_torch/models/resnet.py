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
statistics).

The JAX model's ``w1_conv`` modes only change how a 3x3 conv on a width-1
feature map is contracted (its side columns multiply zero padding), never
its output; here every mode runs the plain 3x3 convolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _operands(module: nn.Module, x: torch.Tensor):
    """(x, weight, bias, out_dtype) for a product in x's dtype: bf16
    operands with fp32 accumulation.  On the CPU, where PyTorch's bf16
    convolution is unreliable (wrong values on some shapes), the bf16
    operands are upcast exactly to fp32 and the output rounded back,
    which is the same arithmetic."""
    dtype = x.dtype
    weight = module.weight.to(dtype)
    bias = None if module.bias is None else module.bias.to(dtype)
    if x.device.type == "cpu" and dtype == torch.bfloat16:
        x, weight = x.float(), weight.float()
        bias = None if bias is None else bias.float()
    return x, weight, bias, dtype


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype (fp32 weights are
    cast to it per call)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias, dtype = _operands(self, x)
        return self._conv_forward(x, weight, bias).to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias, dtype = _operands(self, x)
        return F.linear(x, weight, bias).to(dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm that normalizes in fp32 and returns its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(x.dtype)


def _bn(channels: int) -> BatchNorm2d:
    # Flax momentum 0.9 on the running average == torch momentum 0.1
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    """torchvision BasicBlock: 3x3 conv-bn-relu, 3x3 conv-bn, residual."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_channels, filters, 3, stride, 1, bias=False)
        self.bn1 = _bn(filters)
        self.conv2 = Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = _bn(filters)
        self.downsample = None
        if stride != 1 or in_channels != filters:
            self.downsample = nn.Sequential(
                Conv2d(in_channels, filters, 1, stride, 0, bias=False),
                _bn(filters),
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
    ):
        super().__init__()
        self.input_channels = input_channels
        self.dtype = dtype
        self.conv1 = Conv2d(input_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        in_ch = 64
        for stage in range(4):  # two BasicBlocks per stage
            filters = 64 * 2**stage
            stride = 2 if stage > 0 else 1
            self.add_module(f"layer{stage + 1}", nn.Sequential(
                BasicBlock(in_ch, filters, stride), BasicBlock(filters, filters)
            ))
            in_ch = filters
        self.fc = Linear(in_ch, num_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != self.input_channels:
            raise ValueError(
                f"expected {self.input_channels} channels (NCHW), "
                f"got {tuple(x.shape)}"
            )
        x = x.to(self.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
        x = x.mean(dim=(2, 3))  # global average pool -> [B, 512]
        return self.fc(x).float()
