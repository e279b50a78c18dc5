"""Per-string classification heads, the counterpart of the JAX package's
``models/heads.py``: ``StringBranchHeads`` (GuitarTabNet) and
``SimpleStringHeads`` (the ViT's).

The reference runs six branch MLPs (``bestengine.py:28-40``); this module
keeps them as six ``nn.Sequential`` branches so the state dict has the
reference layout ``branches.{i}.{0,2,4,6,8}.*``.  Per string: Linear
256->128, ReLU, BatchNorm, Dropout .3, Linear 128->64, ReLU, BatchNorm,
Dropout .2, Linear 64->19.  Each BatchNorm runs per (string, feature), as
the JAX model's ``axis=(-2, -1)`` BatchNorm does, with Flax's train-mode
semantics (:class:`.resnet.FlaxBatchNorm`).  The heads compute in fp32.

In train mode the dropout masks are drawn from the ``torch.Generator``
the forward is given (the train step's), never from the global RNG.
"""

from __future__ import annotations

import torch
from torch import nn

from .resnet import FlaxBatchNorm


class Dropout(nn.Dropout):
    """Flax ``nn.Dropout``: keep each value with probability ``1 - p`` and
    scale it by ``1 / (1 - p)``, the mask drawn from ``generator``."""

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("train-mode dropout needs the step's torch.Generator")
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class StackedDense(nn.Module):
    """Independent Dense per string with stacked weights (``StackedDense``,
    ``heads.py:21-50`` of the JAX package): [B, F] (shared by the strings)
    or [B, num_strings, F] -> [B, num_strings, features], fp32.  ``weight``
    is [num_strings, F, features] and ``bias`` [num_strings, features], the
    Flax ``kernel`` and ``bias`` as they are."""

    def __init__(self, in_features: int, features: int, num_strings: int = 6):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_strings, in_features, features))
        self.bias = nn.Parameter(torch.zeros(num_strings, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if x.ndim == 2:  # shared trunk features: broadcast over strings
            return torch.einsum("bf,sfh->bsh", x, self.weight) + self.bias
        return torch.einsum("bsf,sfh->bsh", x, self.weight) + self.bias


class SimpleStringHeads(nn.ModuleList):
    """The ViT head stack (``SimpleStringHeads``, ``heads.py:92-113`` of the
    JAX package): per string Dropout then Linear in_features -> num_frets,
    [B, in_features] -> [B, num_strings, num_frets] fp32 logits.  The state
    dict has the reference layout ``{i}.1.*`` (``ViT_model.py:26-31``).  As
    in the JAX model, one dropout mask is drawn for the shared input and
    serves all six strings."""

    def __init__(
        self, in_features: int = 256, num_frets: int = 19, num_strings: int = 6,
        dropout: float = 0.15,
    ):
        super().__init__([
            nn.Sequential(Dropout(dropout), nn.Linear(in_features, num_frets))
            for _ in range(num_strings)
        ])

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        x = self[0][0](x.float(), generator)
        return torch.stack([branch[1](x) for branch in self], dim=1)


class StringBranchHeads(nn.ModuleList):
    """[B, trunk_dim] -> [B, num_strings, num_frets] fp32 logits."""

    def __init__(
        self, in_features: int = 256, num_frets: int = 19, num_strings: int = 6
    ):
        branches = []
        for _ in range(num_strings):
            layers: list[nn.Module] = []
            width = in_features
            for h, p in ((128, 0.3), (64, 0.2)):  # bestengine.py:28-40
                layers += [
                    nn.Linear(width, h), nn.ReLU(), FlaxBatchNorm(h), Dropout(p),
                ]
                width = h
            layers.append(nn.Linear(width, num_frets))
            branches.append(nn.Sequential(*layers))
        super().__init__(branches)

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        x = x.float()
        outs = []
        for branch in self:
            h = x
            for layer in branch:
                h = layer(h, generator) if isinstance(layer, Dropout) else layer(h)
            outs.append(h)
        return torch.stack(outs, dim=1)
