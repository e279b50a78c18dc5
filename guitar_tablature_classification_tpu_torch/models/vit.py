"""ViT-S backbone in PyTorch, the counterpart of the JAX package's
``models/vit.py`` (``EncoderBlock``, ``_stem_strides``, ``ViTBackbone``).

A pre-LN transformer encoder over patch tokens plus CLS.  Module names
follow Hugging Face's ``ViTModel`` (``embeddings.*``,
``encoder.layer.{i}.*``, ``layernorm``), so the state dict has the
reference layout of ``best_vit_guitar_tab_model.pt`` (``ViT_model.py:11-15``)
and such files load with ``strict=True``: the attention keeps separate
``query``, ``key`` and ``value`` Linears, and the forward concatenates them
into the one QKV GEMM the JAX block runs (``vit.py:47-48``).  The conv stem
(``conv_stem=True``, which has no reference layout) keeps the JAX names:
``stem_conv{i}``, ``stem_bn{i}``, ``stem_proj``.

Numerics follow the Flax model at its ``dtype`` (bf16 by default, fp32
parameters):

- every Dense and Conv casts its input and weights to ``dtype``
  (:mod:`.resnet`'s ``Linear`` and ``Conv2d``; on the CPU bf16 operands are
  upcast exactly, as there);
- LayerNorm is Flax's: fp32 statistics with the fast variance
  E[x^2] - E[x]^2, fp32 affine, one rounding to ``dtype``, eps 1e-12;
- GELU is the tanh form when ``gelu="tanh"``, or ``"auto"`` at bf16, and
  erf otherwise (``vit.py:66-72``);
- ``cls_token`` and ``pos_embed`` are cast to ``dtype`` before they join
  the tokens, and the CLS output is cast to fp32;
- the conv stem's BatchNorms are Flax BatchNorms (:class:`.resnet.FlaxBatchNorm`).

Attention follows the resolved ``attention_impl``: ``"pallas"`` is
:func:`..ops.attention.fused_attention` (the Hopper kernels on the card),
``"xla"`` the plain version.  The backbone has no dropout: the
JAX ``ViTTab`` builds its ``ViTBackbone`` with ``dropout=0``.  The JAX
``remat`` knob (rematerialization per block) only trades training memory
for recomputation; the port builds the plain model for it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_reference, fused_attention
from .resnet import Conv2d, FlaxBatchNorm, Linear, operands

LN_EPS = 1e-12  # vit.py:29 of the JAX package (PyTorch's default is 1e-5)
MLP_RATIO = 4  # the JAX ViTTab never sets its backbone's mlp_ratio


class LayerNorm(nn.LayerNorm):
    """Flax ``nn.LayerNorm``: fp32 mean and fast variance, fp32 affine, the
    output in the input's dtype."""

    def __init__(self, features: int):
        super().__init__(features, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


class _Dense(nn.Module):
    """A module holding one ``dense`` Linear (HF's ``*.dense`` keys)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.dense = Linear(in_features, out_features)


class SelfAttention(nn.Module):
    """HF ``ViTSelfAttention``'s parameters: query, key and value."""

    def __init__(self, hidden: int):
        super().__init__()
        self.query = Linear(hidden, hidden)
        self.key = Linear(hidden, hidden)
        self.value = Linear(hidden, hidden)


class Attention(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.attention = SelfAttention(hidden)
        self.output = _Dense(hidden, hidden)


class EncoderBlock(nn.Module):
    """Pre-LN block: x + proj(attention(LN(x))), then x + MLP(LN(x))."""

    def __init__(self, hidden: int, heads: int, *, attention_impl: str = "xla",
                 gelu_tanh: bool = True):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden {hidden} is not a multiple of heads {heads}")
        self.heads = heads
        self.gelu_tanh = gelu_tanh
        self.attend = fused_attention if attention_impl == "pallas" else attention_reference
        self.layernorm_before = LayerNorm(hidden)
        self.attention = Attention(hidden)
        self.layernorm_after = LayerNorm(hidden)
        self.intermediate = _Dense(hidden, MLP_RATIO * hidden)
        self.output = _Dense(MLP_RATIO * hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        sa = self.attention.attention
        y, weight, bias, dtype = operands(  # the JAX block's fused qkv Dense
            self.layernorm_before(x),
            torch.cat([sa.query.weight, sa.key.weight, sa.value.weight]),
            torch.cat([sa.query.bias, sa.key.bias, sa.value.bias]),
        )
        qkv = F.linear(y, weight, bias).to(dtype)  # one [3D, D] GEMM
        # strided [B, N, H, Dh] views of the [B, N, 3D] output, no copies
        q, k, v = (t.view(b, n, self.heads, d // self.heads) for t in qkv.split(d, dim=-1))
        x = x + self.attention.output.dense(self.attend(q, k, v).reshape(b, n, d))
        y = self.intermediate.dense(self.layernorm_after(x))
        y = F.gelu(y, approximate="tanh" if self.gelu_tanh else "none")
        return x + self.output.dense(y)


def stem_strides(ph: int, pw: int) -> list[tuple[int, int]]:
    """Per-stage 3x3 conv strides of a (ph, pw) patch (``_stem_strides``):
    the H factor split into 2s plus one odd rest, the W strides on the last
    stages."""
    def factors(p):
        out, rem = [], p
        while rem % 2 == 0 and rem > 1:
            out.append(2)
            rem //= 2
        if rem != 1:
            out.append(rem)
        return out

    hf, wf = factors(ph), factors(pw)
    n = max(len(hf), len(wf), 1)
    hf = hf + [1] * (n - len(hf))
    wf = [1] * (n - len(wf)) + wf
    return list(zip(hf, wf))


def _same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``padding="SAME"``: output ceil(size / stride), the odd pad
    at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class PatchEmbeddings(nn.Module):
    def __init__(self, in_channels: int, hidden: int, patch: tuple[int, int]):
        super().__init__()
        self.projection = Conv2d(in_channels, hidden, patch, stride=patch)


class Embeddings(nn.Module):
    """``cls_token`` [1, 1, D], ``position_embeddings`` [1, N + 1, D] and,
    without the conv stem, the patchify projection."""

    def __init__(self, hidden: int, tokens: int, patch_embeddings: PatchEmbeddings | None):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden))
        self.position_embeddings = nn.Parameter(torch.zeros(1, tokens + 1, hidden))
        if patch_embeddings is not None:
            self.patch_embeddings = patch_embeddings


class Encoder(nn.Module):
    def __init__(self, blocks: list[EncoderBlock]):
        super().__init__()
        self.layer = nn.ModuleList(blocks)


class ViTBackbone(nn.Module):
    """NCHW [B, C, H, W] -> [B, hidden] fp32 CLS features (final LN
    applied).  ``input_hw`` fixes the token grid, hence the shape of the
    position embeddings."""

    def __init__(
        self,
        hidden: int = 384,
        layers: int = 12,
        heads: int = 6,
        patch: int | tuple[int, int] = 8,
        input_hw: tuple[int, int] = (224, 224),
        input_channels: int = 3,
        dtype: torch.dtype = torch.bfloat16,
        attention_impl: str = "xla",
        gelu: str = "auto",
        conv_stem: bool = False,
    ):
        super().__init__()
        ph, pw = (patch, patch) if isinstance(patch, int) else tuple(patch)
        self.patch = (ph, pw)
        self.hidden = hidden
        self.dtype = dtype
        self.conv_stem = conv_stem
        gelu_tanh = gelu == "tanh" or (gelu == "auto" and dtype == torch.bfloat16)
        self.gelu_tanh = gelu_tanh
        tokens = (input_hw[0] // ph) * (input_hw[1] // pw)
        if conv_stem:
            self.stages = stem_strides(ph, pw)
            in_ch = input_channels
            for i, stride in enumerate(self.stages):
                ch = max(hidden >> (len(self.stages) - 1 - i), 16)
                self.add_module(f"stem_conv{i}", Conv2d(in_ch, ch, 3, stride=stride, bias=False))
                self.add_module(f"stem_bn{i}", FlaxBatchNorm(ch, eps=1e-5))
                in_ch = ch
            self.stem_proj = Conv2d(in_ch, hidden, 1)
            self.embeddings = Embeddings(hidden, tokens, None)
        else:
            self.embeddings = Embeddings(
                hidden, tokens, PatchEmbeddings(input_channels, hidden, (ph, pw)))
        self.encoder = Encoder([
            EncoderBlock(hidden, heads, attention_impl=attention_impl, gelu_tanh=gelu_tanh)
            for _ in range(layers)
        ])
        self.layernorm = LayerNorm(hidden)

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        for i, (sh, sw) in enumerate(self.stages):
            top, bottom = _same_padding(x.shape[2], 3, sh)
            left, right = _same_padding(x.shape[3], 3, sw)
            x = getattr(self, f"stem_conv{i}")(F.pad(x, (left, right, top, bottom)))
            x = getattr(self, f"stem_bn{i}")(x)
            x = F.gelu(x, approximate="tanh" if self.gelu_tanh else "none")
        return self.stem_proj(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        ph, pw = self.patch
        if h % ph or w % pw:
            raise ValueError(f"input {h}x{w} not divisible by patch {ph}x{pw}")
        x = x.to(self.dtype)
        if self.conv_stem:
            x = self._stem(x)
        else:
            x = self.embeddings.patch_embeddings.projection(x)
        x = x.flatten(2).transpose(1, 2)  # [B, N, D], tokens row-major over (h, w)
        emb = self.embeddings
        cls = emb.cls_token.to(self.dtype).expand(b, 1, self.hidden)
        x = torch.cat([cls, x], dim=1) + emb.position_embeddings.to(self.dtype)
        for block in self.encoder.layer:
            x = block(x)
        # LayerNorm is per token, so normalizing the CLS token alone gives
        # the JAX model's ln_final(x)[:, 0]
        return self.layernorm(x[:, 0]).float()
