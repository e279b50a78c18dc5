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

Split over a mesh's model axis (:func:`..parallel.shard_model`), each head
list holds its rank's strings and gathers their logits over the model
group; ``StackedDense`` holds its rank's rows.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.collectives import gather_strings, row_slice
from .resnet import FlaxBatchNorm


class Dropout(nn.Dropout):
    """Flax ``nn.Dropout``: keep each value with probability ``1 - p`` and
    scale it by ``1 / (1 - p)``, the mask drawn from ``generator``.

    Under a mesh (:mod:`..parallel`) the mask is drawn at the global batch's
    shape and this rank keeps its rows, and, for a dropout over per-string
    values (``string_dim``: dim 1 is the string axis) in a model split over
    the strings, its strings: every rank draws what the one-process step
    draws."""

    string_dim = False
    strings: tuple[int, int] | None = None  # this rank's, set by parallel.shard_model
    num_strings = 6

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("train-mode dropout needs the step's torch.Generator")
        keep = 1.0 - self.p
        mask = self.draw(x.shape, generator, x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def draw(self, shape, generator: torch.Generator, device) -> torch.Tensor:
        """Uniform draws for a local tensor of ``shape``: this rank's part
        of the global tensor's."""
        shape, index = list(shape), [slice(None)] * len(shape)
        rows = row_slice(shape[0])
        if rows is not None:
            index[0] = slice(rows[1], rows[1] + shape[0])
            shape[0] = rows[0]
        if self.strings is not None:
            index[1] = slice(*self.strings)
            shape[1] = self.num_strings
        return torch.rand(shape, generator=generator, device=device)[tuple(index)]


class StringElsewhere(nn.Module):
    """Stands for a string's branch that another rank holds (a per-string
    head list split over the model axis): no parameters, and in train mode
    it draws the dropout masks the branch would have drawn, so the
    generator advances as in the one-process step.  ``drops``: the branch's
    dropouts with the width of their input (None for a dropout over the
    shared input, which the head list draws itself)."""

    def __init__(self, drops: list[tuple[Dropout, int | None]]):
        super().__init__()
        self.drops = nn.ModuleList([d for d, _ in drops])
        self.widths = [w for _, w in drops]

    @classmethod
    def of(cls, branch: nn.Sequential) -> "StringElsewhere":
        drops, width = [], None
        for layer in branch:
            if isinstance(layer, nn.Linear):
                width = layer.out_features
            elif isinstance(layer, Dropout):
                drops.append((layer, width))
        return cls(drops)

    def advance(self, rows: int, generator: torch.Generator | None, device) -> None:
        for drop, width in zip(self.drops, self.widths):
            if width is not None and drop.training and drop.p != 0.0:
                drop.draw((rows, width), generator, device)


class StackedDense(nn.Module):
    """Independent Dense per string with stacked weights (``StackedDense``,
    ``heads.py:21-50`` of the JAX package): [B, F] (shared by the strings)
    or [B, num_strings, F] -> [B, num_strings, features], fp32.  ``weight``
    is [num_strings, F, features] and ``bias`` [num_strings, features], the
    Flax ``kernel`` and ``bias`` as they are."""

    strings: tuple[int, int] | None = None  # this rank's rows, set by parallel.shard_model

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

    strings: tuple[int, int] | None = None  # this rank's, set by parallel.shard_model

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        drop = next(m for m in self.modules() if isinstance(m, Dropout))  # string 0's
        x = drop(x.float(), generator)
        out = torch.stack([b[1](x) for b in self if not isinstance(b, StringElsewhere)], dim=1)
        return gather_strings(out, self.strings)


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

    strings: tuple[int, int] | None = None  # this rank's, set by parallel.shard_model

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        x = x.float()
        outs = []
        for branch in self:
            if isinstance(branch, StringElsewhere):
                branch.advance(x.shape[0], generator, x.device)
                continue
            h = x
            for layer in branch:
                h = layer(h, generator) if isinstance(layer, Dropout) else layer(h)
            outs.append(h)
        return gather_strings(torch.stack(outs, dim=1), self.strings)
