"""GuitarTabNet and ``build_model``, the counterpart of the JAX package's
``models/tabnet.py`` for the two ResNet archs.

``GuitarTabNet`` maps channels-last spectrogram images ``[B, H, W, C]``
(the JAX model's layout, so both packages take the same tensors) to one
``[B, 6, num_frets]`` fp32 logits tensor.  Its state dict has the
reference ``GuitarTabNet`` layout (``bestengine.py:18-48``):
``resnet.*`` and ``branches.{i}.{0,2,4,6,8}.*``, so reference ``.pt``
checkpoints and the JAX package's ``save_torch_checkpoint`` output load
with ``strict=True``.  ``model.train()`` gives the JAX model's
``train=True``: batch statistics, Flax running averages, and dropout drawn
from the generator passed to ``forward``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from .heads import StringBranchHeads
from .resnet import ResNet18

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class GuitarTabNet(nn.Module):
    """ResNet18 -> 256-d trunk -> per-string branch MLPs."""

    def __init__(
        self,
        num_frets: int = 19,
        num_strings: int = 6,
        input_channels: int = 3,
        dtype: torch.dtype = torch.bfloat16,
        fused_stem: int | None = None,
    ):
        super().__init__()
        self.resnet = ResNet18(
            num_features=256, input_channels=input_channels, dtype=dtype,
            fused_stem=fused_stem,
        )
        self.branches = StringBranchHeads(
            256, num_frets=num_frets, num_strings=num_strings
        )

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """x: [B, H, W, C] -> [B, num_strings, num_frets] fp32 logits.
        ``generator`` draws the heads' dropout masks in train mode."""
        feats = self.resnet(x.permute(0, 3, 1, 2).contiguous())
        return self.branches(feats, generator)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialization: LeCun-normal (truncated at 2 sigma) conv and
    linear weights as Flax's default, zero biases, identity BatchNorms."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(
                    m.weight, std=std, a=-2 * std, b=2 * std,
                    generator=generator,
                )
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
    return model


def build_model(
    cfg: ModelConfig, *, generator: torch.Generator | None = None
) -> GuitarTabNet:
    """GuitarTabNet for ``cfg`` (``resnet18`` at 224^2 or
    ``resnet18_native`` on the raw 96x9 CQT), seeded from ``generator``
    (seed 0 when None).

    ``resnet18`` with ``stem_fusion="fused"`` builds the fused 224^2 stem
    (precomposed quadrant conv1 GEMM + the stem-tail kernels of
    ``csrc/stem.cu``).  Knobs that only choose how the JAX package computes
    the same output map to the plain formulation: every ``w1_conv`` mode,
    ``stem_fusion="on"`` (its precomposed resize/conv1 GEMMs equal resize ->
    conv1) and ``remat`` (rematerialization only matters for training
    memory).  Knobs that select a TPU kernel this port does not have yet
    raise ``NotImplementedError`` naming the ROADMAP item.
    """
    if cfg.stem_fusion not in ("on", "off", "fused"):
        raise ValueError(
            f"stem_fusion must be 'on', 'off' or 'fused', got {cfg.stem_fusion!r}"
        )
    if cfg.bn_fusion not in ("on", "off"):
        raise ValueError(f"bn_fusion must be 'on' or 'off', got {cfg.bn_fusion!r}")
    if cfg.w1_conv not in ("slim", "gemm", "dense", "full"):
        raise ValueError(
            f"w1_conv must be 'slim', 'gemm', 'dense' or 'full', got {cfg.w1_conv!r}"
        )
    if cfg.arch not in ("resnet18", "resnet18_native"):
        raise NotImplementedError(
            f"arch {cfg.arch!r} is not ported yet (ROADMAP A11 small_cnn, "
            "A12 ViT with kernel B5); the port serves resnet18 and "
            "resnet18_native"
        )
    if cfg.stem_fusion == "fused" and cfg.arch == "resnet18_native":
        raise NotImplementedError(
            "stem_fusion='fused' on resnet18_native needs the native fused "
            "stem kernels (ROADMAP B6), not ported yet"
        )
    if cfg.bn_fusion == "on":
        raise NotImplementedError(
            "bn_fusion='on' needs the fused BatchNorm kernel (ROADMAP B7), "
            "not ported yet"
        )
    if cfg.dtype not in _DTYPES or cfg.param_dtype != "float32":
        raise ValueError(
            f"dtype must be one of {tuple(_DTYPES)} with float32 params, "
            f"got {cfg.dtype!r}/{cfg.param_dtype!r}"
        )
    model = GuitarTabNet(
        num_frets=cfg.num_frets,
        num_strings=cfg.num_strings,
        input_channels=cfg.input_channels if cfg.arch == "resnet18" else 1,
        dtype=_DTYPES[cfg.dtype],
        fused_stem=224 if cfg.stem_fusion == "fused" else None,
    )
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return init_weights(model, generator)
