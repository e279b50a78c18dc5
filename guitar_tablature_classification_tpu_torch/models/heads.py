"""Per-string classification heads, the counterpart of the JAX package's
``models/heads.py::StringBranchHeads``.

The reference runs six branch MLPs (``bestengine.py:28-40``); this module
keeps them as six ``nn.Sequential`` branches so the state dict has the
reference layout ``branches.{i}.{0,2,4,6,8}.*``.  Per string: Linear
256->128, ReLU, BatchNorm, Dropout .3, Linear 128->64, ReLU, BatchNorm,
Dropout .2, Linear 64->19.  Each BatchNorm runs per (string, feature), as
the JAX model's ``axis=(-2, -1)`` BatchNorm does.  The heads compute in
fp32.
"""

from __future__ import annotations

import torch
from torch import nn


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
                    nn.Linear(width, h), nn.ReLU(),
                    nn.BatchNorm1d(h, eps=1e-5, momentum=0.1), nn.Dropout(p),
                ]
                width = h
            layers.append(nn.Linear(width, num_frets))
            branches.append(nn.Sequential(*layers))
        super().__init__(branches)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return torch.stack([branch(x) for branch in self], dim=1)
