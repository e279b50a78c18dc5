"""Training engine of the port.  This slice ports only ``make_preprocess``
(the JAX package's ``train/engine.py:87-147``, its ``db_features`` input
kind), which serving needs."""

from __future__ import annotations

from typing import Callable

import torch

from ..config import ModelConfig
from ..ops.normalize import db_to_unit, imagenet_normalize, tile_channels
from ..ops.resize import resize_bicubic


def make_preprocess(
    model_cfg: ModelConfig, image_size: int = 224
) -> Callable[[torch.Tensor], torch.Tensor]:
    """[B, n_bins, n_frames] dB features -> channels-last model input.

    dB -> [0, 1]; the native archs take that as is ([B, 96, T, 1]);
    ``resnet18`` gets a bicubic resize to ``image_size``^2, a 3-channel tile
    and the ImageNet normalization.  ``resnet18`` with ``stem_fusion="on"``
    takes the same resized images: the JAX package folds resize/tile/
    normalize into its conv1 GEMMs there, which computes the same function.
    (The JAX package's ``rgb_image`` input kind, for PNG renders, is not
    ported: serving does not use it.)
    """
    arch = model_cfg.arch

    def preprocess(feats: torch.Tensor) -> torch.Tensor:
        x = db_to_unit(feats)
        if arch in ("small_cnn", "resnet18_native", "vit_native"):
            return x[..., None]  # raw [B, 96, T, 1], no resize needed
        x = resize_bicubic(x, (image_size, image_size))
        x = tile_channels(x, model_cfg.input_channels)
        if arch == "resnet18":
            x = imagenet_normalize(x)
        return x

    return preprocess
