"""The reference model of ``arch`` ``resnet18``: GuitarTabNet
(``bestengine.py:18-48`` of the reference repo), torchvision's ResNet-18
(7x7/2 conv, max-pool, four stages of two basic blocks, global average
pool), fc 512 -> 256, then per string Linear 256->128, ReLU, BatchNorm,
Dropout .3, Linear 128->64, ReLU, BatchNorm, Dropout .2, Linear 64->19.
It takes the CQT resized to 224^2, three channels, ImageNet-normalized."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .cqt import image
from .models import batch_norm, conv, dropout, linear
from .precision import Precision


class Block(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            nn.BatchNorm2d(cout))

    def run(self, x, train, prec):
        y = F.relu(batch_norm(conv(x, self.conv1, prec), self.bn1, train))
        y = batch_norm(conv(y, self.conv2, prec), self.bn2, train)
        if hasattr(self, "downsample"):
            x = batch_norm(conv(x, self.downsample[0], prec), self.downsample[1], train)
        return F.relu(y + x)


class ResNet18(nn.Module):
    def __init__(self, in_channels: int = 3, features: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for i in range(4):
            cout = 64 * 2**i
            setattr(self, f"layer{i + 1}", nn.Sequential(Block(cin, cout, 2 if i else 1),
                                                         Block(cout, cout, 1)))
            cin = cout
        self.fc = nn.Linear(cin, features)

    def run(self, x, train, prec):
        x = F.relu(batch_norm(conv(x, self.conv1, prec), self.bn1, train))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(4):
            for block in getattr(self, f"layer{i + 1}"):
                x = block.run(x, train, prec)
        return linear(x.mean(dim=(2, 3)), self.fc, prec)


class GuitarTabNet(nn.Module):
    """NCHW 224^2 image -> [B, strings, frets] logits."""

    def __init__(self, strings: int = 6, frets: int = 19):
        super().__init__()
        self.resnet = ResNet18()
        self.branches = nn.ModuleList(nn.Sequential(
            nn.Linear(256, 128), nn.ReLU(), nn.BatchNorm1d(128), nn.Dropout(0.3),
            nn.Linear(128, 64), nn.ReLU(), nn.BatchNorm1d(64), nn.Dropout(0.2),
            nn.Linear(64, frets)) for _ in range(strings))

    @staticmethod
    def inputs(db: torch.Tensor) -> torch.Tensor:
        return image(db, 224, imagenet=True)

    def logit_weights(self) -> list[str]:
        """The weights of the layers that give the logits, one a string."""
        return [f"branches.{i}.8.weight" for i in range(len(self.branches))]

    def run(self, x, *, train: bool, generator=None, prec: Precision = Precision()):
        h0 = self.resnet.run(x, train, prec)
        outs = []
        for br in self.branches:
            h = F.relu(br[0](h0))
            h = dropout(batch_norm(h, br[2], train), br[3].p, generator)
            h = F.relu(br[4](h))
            h = dropout(batch_norm(h, br[6], train), br[7].p, generator)
            outs.append(br[8](h))
        return torch.stack(outs, dim=1)


def build(model: dict) -> nn.Module:
    return GuitarTabNet(model["num_strings"], model["num_frets"])
