"""The reference model of ``arch`` ``resnet18_native``: GuitarTabNet
(:mod:`.arch_resnet18`) with conv1 over one channel, on the raw [96, 9]
CQT: dB to [0, 1] ((x + 120) / 120, clipped), with no resize, tile or
ImageNet normalization.  The feature maps run from 48x5 after conv1 down
to 3x1 in layer4.  Every 3x3 convolution is the plain one; the port's
``w1_conv`` modes only choose how a 3x3 convolution on a width-1 map is
contracted, never its output, so this is no departure."""

from __future__ import annotations

import torch
from torch import nn

from .arch_resnet18 import GuitarTabNet, ResNet18


class NativeTabNet(GuitarTabNet):
    """NCHW [B, 1, 96, 9] unit CQT -> [B, strings, frets] logits."""

    def __init__(self, strings: int = 6, frets: int = 19):
        super().__init__(strings, frets)
        self.resnet = ResNet18(in_channels=1)

    @staticmethod
    def inputs(db: torch.Tensor) -> torch.Tensor:
        return ((db + 120.0) / 120.0).clamp(0.0, 1.0)[:, None]


def build(model: dict) -> nn.Module:
    return NativeTabNet(model["num_strings"], model["num_frets"])
