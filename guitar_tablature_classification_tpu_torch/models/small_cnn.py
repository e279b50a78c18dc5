"""The notebook's 3-conv baseline CNN (the JAX package's
``models/small_cnn.py``).

Conv 1->32->64->64, 3x3 VALID, ReLU each, MaxPool 2, then six per-string
MLPs flatten->152->76->19 (CNN_firstTry_.pdf p.2; BASELINE.md), as stacked
weights (:class:`.heads.StackedDense`).  It takes the raw [B, 96, T, C]
spectrogram, channels last as the JAX model does; no 224x224 resize.

The convolutions run in ``dtype`` (bf16 by default) on fp32 parameters, the
dense layers in fp32.  The state dict uses the Flax names: ``conv{1,2,3}``
(``weight`` OIHW, ``bias``) and ``dense0``, ``dense1``, ``out`` (``weight``
[6, in, out], ``bias`` [6, out]).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import gather_strings
from .heads import Dropout, StackedDense
from .resnet import Conv2d


class SmallTabCNN(nn.Module):
    """[B, H, W, C] -> [B, num_strings, num_frets] fp32 logits.  In train
    mode the dropout masks come from the ``torch.Generator`` passed to
    ``forward``."""

    def __init__(
        self,
        num_frets: int = 19,
        num_strings: int = 6,
        input_channels: int = 1,
        input_hw: tuple[int, int] = (96, 9),
        hidden: tuple[int, int] = (152, 76),
        dropout: tuple[float, float] = (0.5, 0.2),
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.dtype = dtype
        width = input_channels
        for i, filters in enumerate((32, 64, 64)):
            setattr(self, f"conv{i + 1}", Conv2d(width, filters, 3))
            width = filters
        h, w = ((d - 6) // 2 for d in input_hw)  # three VALID 3x3, pool 2
        features = h * w * width
        for i, (units, p) in enumerate(zip(hidden, dropout)):
            setattr(self, f"dense{i}", StackedDense(features, units, num_strings))
            drop = Dropout(p)
            drop.string_dim = True  # [B, strings, units]
            setattr(self, f"dropout{i}", drop)
            features = units
        self.out = StackedDense(features, num_frets, num_strings)

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for conv in (self.conv1, self.conv2, self.conv3):
            x = F.relu(conv(x))
        x = F.max_pool2d(x, 2)
        # flatten in Flax's [B, H, W, C] order, as dense0's rows are laid out
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).float()
        for i in range(2):
            x = F.relu(getattr(self, f"dense{i}")(x))
            x = getattr(self, f"dropout{i}")(x, generator)
        return gather_strings(self.out(x), self.out.strings)
