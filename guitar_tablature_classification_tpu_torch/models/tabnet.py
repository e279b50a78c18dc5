"""GuitarTabNet, ViTTab and ``build_model``, the counterpart of the JAX
package's ``models/tabnet.py``.

Both models map channels-last spectrogram images ``[B, H, W, C]`` (the JAX
models' layout, so both packages take the same tensors) to one
``[B, 6, num_frets]`` fp32 logits tensor.

``GuitarTabNet``'s state dict has the reference ``GuitarTabNet`` layout
(``bestengine.py:18-48``): ``resnet.*`` and ``branches.{i}.{0,2,4,6,8}.*``.
``ViTTab``'s has the reference ``ViTGuitarTabModel`` layout
(``ViT_model.py:6-53``): ``vit.*`` (Hugging Face ``ViTModel`` names),
``fc1``, ``bn_fc1``, ``fc2``, ``bn_fc2`` and ``string_heads.{i}.1.*``.  So
reference ``.pt`` checkpoints and the JAX package's ``save_torch_checkpoint``
output load with ``strict=True``.  ``model.train()`` gives the JAX model's
``train=True``: batch statistics, Flax running averages, and dropout drawn
from the generator passed to ``forward``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops.attention import resolve_attention
from .deepseek_v2 import DeepseekV2Tab, init_deepseek
from .heads import Dropout, SimpleStringHeads, StackedDense, StringBranchHeads
from .resnet import FlaxBatchNorm, ResNet18
from .small_cnn import SmallTabCNN
from .vit import ViTBackbone

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
        fused_bn: bool = False,
        fused_native_stem: bool = False,
    ):
        super().__init__()
        self.resnet = ResNet18(
            num_features=256, input_channels=input_channels, dtype=dtype,
            fused_stem=fused_stem, fused_bn=fused_bn, fused_native_stem=fused_native_stem,
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


class ViTTab(nn.Module):
    """ViT CLS -> fc1 512 -> fc2 256 (Flax BatchNorm + leaky ReLU 0.1) ->
    per-string heads (``ViTTab``, ``tabnet.py:62-112`` of the JAX package).
    The backbone computes in ``dtype``; the head from the fp32 CLS features
    on runs in fp32."""

    def __init__(
        self,
        num_frets: int = 19,
        num_strings: int = 6,
        input_channels: int = 3,
        hidden: int = 384,
        layers: int = 12,
        heads: int = 6,
        patch: int | tuple[int, int] = 8,
        input_hw: tuple[int, int] = (224, 224),
        dropout: float = 0.3,
        dtype: torch.dtype = torch.bfloat16,
        attention_impl: str = "xla",
        gelu: str = "auto",
        conv_stem: bool = False,
    ):
        super().__init__()
        self.vit = ViTBackbone(
            hidden=hidden, layers=layers, heads=heads, patch=patch, input_hw=input_hw,
            input_channels=input_channels, dtype=dtype, attention_impl=attention_impl,
            gelu=gelu, conv_stem=conv_stem,
        )
        self.dropout1 = Dropout(dropout)
        self.fc1 = nn.Linear(hidden, 512)
        self.bn_fc1 = FlaxBatchNorm(512)
        self.dropout2 = Dropout(dropout)
        self.fc2 = nn.Linear(512, 256)
        self.bn_fc2 = FlaxBatchNorm(256)
        self.string_heads = SimpleStringHeads(
            256, num_frets=num_frets, num_strings=num_strings, dropout=dropout / 2
        )

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """x: [B, H, W, C] -> [B, num_strings, num_frets] fp32 logits.
        ``generator`` draws the head's dropout masks in train mode."""
        h = self.dropout1(self.vit(x.permute(0, 3, 1, 2)), generator)
        h = F.leaky_relu(self.bn_fc1(self.fc1(h)), 0.1)
        h = self.dropout2(h, generator)
        h = F.leaky_relu(self.bn_fc2(self.fc2(h)), 0.1)
        return self.string_heads(h, generator)


def _trunc_normal(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialization: LeCun-normal (truncated at 2 sigma) conv and
    linear weights as Flax's default, zero biases, identity BatchNorms.  A
    stacked [S, F, H] dense kernel has Flax's fan-in S * F."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear, StackedDense)):
                stacked = isinstance(m, StackedDense)
                fan_in = m.weight.shape[0] * m.weight.shape[1] if stacked else m.weight[0].numel()
                _trunc_normal(m.weight, (1.0 / fan_in) ** 0.5 / 0.87962566103423978,
                              generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
    return model


def init_vittab(model: ViTTab, generator: torch.Generator) -> ViTTab:
    """Seeded ViTTab initialization with the JAX model's distributions:
    :func:`init_weights` (LeCun-normal Dense and Conv, zero biases, identity
    norms), then a zero ``cls_token``, truncated-normal 0.02
    ``pos_embed``, and Kaiming fan-out (variance 2 / fan_out, truncated
    normal) for ``fc1``, ``fc2`` and the string heads, whose Flax
    ``[6, 256, 19]`` kernel has fan_out 6 * 19."""
    init_weights(model, generator)
    with torch.no_grad():
        emb = model.vit.embeddings
        emb.cls_token.zero_()
        _trunc_normal(emb.position_embeddings, 0.02, generator)
        heads = model.string_heads
        fan_out = {model.fc1: model.fc1.out_features, model.fc2: model.fc2.out_features}
        for branch in heads:
            fan_out[branch[1]] = branch[1].out_features * len(heads)
        for linear, fan in fan_out.items():
            _trunc_normal(linear.weight, (2.0 / fan) ** 0.5 / 0.87962566103423978, generator)
    return model


def _vittab(cfg: ModelConfig) -> ViTTab:
    """The ViTTab of a ViT arch.  ``vit_s8`` takes the 224^2 image in square
    ``vit_patch`` patches; ``vit_native`` the raw [96, 9] CQT in
    (``vit_patch``, ``vit_native_patch_w``) patches, with one channel.  The
    token count (patches + CLS) picks the attention under ``"auto"``, as
    ``tabnet.py:164-196`` of the JAX package does.  Like the JAX ViTTab,
    which builds its backbone without it, ``vit_mlp_ratio`` is not read:
    the MLP is 4x the width (ROADMAP C)."""
    if cfg.arch == "vit_s8":
        patch, input_hw, channels = (cfg.vit_patch, cfg.vit_patch), (224, 224), cfg.input_channels
    else:
        patch, input_hw, channels = (cfg.vit_patch, cfg.vit_native_patch_w), (96, 9), 1
    tokens = (input_hw[0] // patch[0]) * (input_hw[1] // patch[1]) + 1
    return ViTTab(
        num_frets=cfg.num_frets, num_strings=cfg.num_strings, input_channels=channels,
        hidden=cfg.vit_hidden, layers=cfg.vit_layers, heads=cfg.vit_heads, patch=patch,
        input_hw=input_hw, dropout=cfg.dropout, dtype=_DTYPES[cfg.dtype],
        attention_impl=resolve_attention(cfg.attention_impl, tokens),
        gelu=cfg.gelu, conv_stem=cfg.vit_conv_stem,
    )


def build_model(
    cfg: ModelConfig, *, generator: torch.Generator | None = None,
    input_shape: tuple[int, int, int] | None = None,
) -> GuitarTabNet | ViTTab | SmallTabCNN | DeepseekV2Tab:
    """The model of ``cfg``, seeded from ``generator`` (seed 0 when None):
    GuitarTabNet for ``resnet18`` (224^2) and ``resnet18_native`` (the raw
    96x9 CQT), ViTTab for ``vit_s8`` (224^2, 785 tokens at patch 8) and
    ``vit_native`` (the raw CQT, with the conv stem under
    ``vit_conv_stem``), SmallTabCNN for ``small_cnn`` (the raw CQT),
    DeepseekV2Tab for ``deepseek_v2`` (224^2 in ``vit_patch`` patches, the
    sizes of ``cfg.deepseek``; :mod:`.deepseek_v2`).

    ``stem_fusion="fused"`` builds the fused stem of the arch, as the JAX
    ``build_model`` does (``models/tabnet.py:151-159,197-209`` there): on
    ``resnet18`` the 224^2 stem (precomposed quadrant conv1 GEMM + the
    stem-tail kernels of ``csrc/stem.cu``), on ``resnet18_native`` the
    native stem (row-parity conv1 + the kernels of ``csrc/stem_native.cu``
    and ``csrc/bn.cu``).  ``bn_fusion="on"`` makes every trunk BatchNorm a
    ``FusedBatchNorm`` (the column-sum kernels of ``csrc/bn.cu`` in train
    mode), with any stem.  Neither knob changes the state dict.  The ViT
    archs' attention follows ``attention_impl``
    (:func:`..ops.attention.resolve_attention`): the fused kernels of
    ``csrc/attention.cu`` above 128 tokens under ``"auto"``.  Knobs that
    only choose how the JAX package computes the same output map to the
    plain formulation: every ``w1_conv`` mode, ``stem_fusion="on"`` (its
    precomposed resize/conv1 GEMMs equal resize -> conv1) and ``remat``
    (rematerialization only matters for training memory).
    ``stem_fusion``, ``bn_fusion`` and ``w1_conv`` are validated and then
    ignored for the ViT archs and ``small_cnn``, as in the JAX package.

    ``input_shape`` (H, W, C) is the model input's, which only ``small_cnn``
    depends on (its flatten scales with the pixel count): the raw [96, 9, 1]
    CQT when None, the PNG render's shape on the ``rgb_image`` path (the
    Flax model takes it from its first input).
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
    vit = cfg.arch in ("vit_s8", "vit_native")
    if cfg.vit_conv_stem and not vit:
        raise ValueError(f"vit_conv_stem only applies to ViT archs, got {cfg.arch!r}")
    if cfg.arch not in ("resnet18", "resnet18_native", "small_cnn", "deepseek_v2") and not vit:
        raise ValueError(f"unknown arch {cfg.arch!r}")
    if (cfg.arch == "deepseek_v2") != (cfg.deepseek is not None):
        raise ValueError("ModelConfig.deepseek holds the sizes of arch 'deepseek_v2' alone, "
                         f"got arch {cfg.arch!r} with deepseek {cfg.deepseek!r}")
    if cfg.dtype not in _DTYPES or cfg.param_dtype != "float32":
        raise ValueError(
            f"dtype must be one of {tuple(_DTYPES)} with float32 params, "
            f"got {cfg.dtype!r}/{cfg.param_dtype!r}"
        )
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if vit:
        return init_vittab(_vittab(cfg), generator)
    if cfg.arch == "deepseek_v2":
        return init_deepseek(DeepseekV2Tab(
            cfg.deepseek, num_frets=cfg.num_frets, num_strings=cfg.num_strings,
            patch=cfg.vit_patch, input_channels=cfg.input_channels, dropout=cfg.dropout,
            dtype=_DTYPES[cfg.dtype]), generator)
    if cfg.arch == "small_cnn":
        h, w, c = input_shape or (96, 9, 1)
        return init_weights(SmallTabCNN(
            num_frets=cfg.num_frets, num_strings=cfg.num_strings, input_channels=c,
            input_hw=(h, w), dtype=_DTYPES[cfg.dtype],
        ), generator)
    model = GuitarTabNet(
        num_frets=cfg.num_frets,
        num_strings=cfg.num_strings,
        input_channels=cfg.input_channels if cfg.arch == "resnet18" else 1,
        dtype=_DTYPES[cfg.dtype],
        fused_stem=224 if cfg.arch == "resnet18" and cfg.stem_fusion == "fused" else None,
        fused_bn=cfg.bn_fusion == "on",
        fused_native_stem=cfg.arch == "resnet18_native" and cfg.stem_fusion == "fused",
    )
    return init_weights(model, generator)
