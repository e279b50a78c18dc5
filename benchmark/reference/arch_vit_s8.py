"""The reference model of ``arch`` ``vit_s8``: ViTTab (``ViT_model.py:6-97``
of the reference repo), ViT-S/8 as Hugging Face's ``ViTModel`` names it
(patch 8 conv, CLS token, position embeddings, pre-LN blocks with
LayerNorm eps 1e-12, 4x MLP, final LayerNorm on CLS), then Dropout, fc1
384->512, BatchNorm, leaky ReLU .1, Dropout, fc2 512->256, BatchNorm,
leaky ReLU .1, and per string Dropout then Linear 256->19 (one mask for
the six strings).  It takes the CQT resized to 224^2, three channels."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .cqt import image
from .models import batch_norm, conv, dropout, linear
from .precision import Precision


class LayerNorm(nn.LayerNorm):
    def __init__(self, n: int):
        super().__init__(n, eps=1e-12)


class _Dense(nn.Module):
    def __init__(self, n_in, n_out):
        super().__init__()
        self.dense = nn.Linear(n_in, n_out)


class _SelfAttention(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.query, self.key, self.value = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d)


class _Attention(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.attention = _SelfAttention(d)
        self.output = _Dense(d, d)


class EncoderLayer(nn.Module):
    def __init__(self, d: int, heads: int, mlp: int, gelu: str):
        super().__init__()
        self.heads, self.gelu = heads, gelu
        self.layernorm_before = LayerNorm(d)
        self.attention = _Attention(d)
        self.layernorm_after = LayerNorm(d)
        self.intermediate = _Dense(d, mlp)
        self.output = _Dense(mlp, d)

    def run(self, x, prec):
        b, n, d = x.shape
        h, dh = self.heads, d // self.heads
        y = self.layernorm_before(x)
        sa = self.attention.attention
        q, k, v = (linear(y, m, prec).view(b, n, h, dh).transpose(1, 2)
                   for m in (sa.query, sa.key, sa.value))
        scores = (prec(q) @ prec(k).transpose(-1, -2)) / math.sqrt(dh)
        a = prec(torch.softmax(scores, dim=-1)) @ prec(v)
        x = x + linear(a.transpose(1, 2).reshape(b, n, d), self.attention.output.dense, prec)
        y = linear(self.layernorm_after(x), self.intermediate.dense, prec)
        y = F.gelu(y, approximate=self.gelu)
        return x + linear(y, self.output.dense, prec)


class _PatchEmbeddings(nn.Module):
    def __init__(self, c, d, p):
        super().__init__()
        self.projection = nn.Conv2d(c, d, p, p)


class _Embeddings(nn.Module):
    def __init__(self, c, d, p, tokens):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.position_embeddings = nn.Parameter(torch.zeros(1, tokens + 1, d))
        self.patch_embeddings = _PatchEmbeddings(c, d, p)


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layer = nn.ModuleList(layers)


class ViT(nn.Module):
    def __init__(self, d, layers, heads, patch, size, mlp, gelu, channels=3):
        super().__init__()
        self.embeddings = _Embeddings(channels, d, patch, (size // patch) ** 2)
        self.encoder = _Encoder([EncoderLayer(d, heads, mlp, gelu) for _ in range(layers)])
        self.layernorm = LayerNorm(d)

    def run(self, x, prec):
        e = self.embeddings
        x = conv(x, e.patch_embeddings.projection, prec).flatten(2).transpose(1, 2)
        x = torch.cat([e.cls_token.expand(x.shape[0], 1, -1), x], dim=1) + e.position_embeddings
        for layer in self.encoder.layer:
            x = layer.run(x, prec)
        return self.layernorm(x[:, 0])


class ViTTab(nn.Module):
    """NCHW 224^2 image -> [B, strings, frets] logits."""

    def __init__(self, d=384, layers=12, heads=6, patch=8, size=224, mlp=1536,
                 gelu="tanh", dropout=0.3, strings=6, frets=19):
        super().__init__()
        self.dropout = dropout
        self.vit = ViT(d, layers, heads, patch, size, mlp, gelu)
        self.fc1, self.bn_fc1 = nn.Linear(d, 512), nn.BatchNorm1d(512)
        self.fc2, self.bn_fc2 = nn.Linear(512, 256), nn.BatchNorm1d(256)
        self.string_heads = nn.ModuleList(
            nn.Sequential(nn.Dropout(dropout / 2), nn.Linear(256, frets)) for _ in range(strings))

    @staticmethod
    def inputs(db: torch.Tensor) -> torch.Tensor:
        return image(db, 224, imagenet=False)

    def logit_weights(self) -> list[str]:
        """The weights of the layers that give the logits, one a string."""
        return [f"string_heads.{i}.1.weight" for i in range(len(self.string_heads))]

    def run(self, x, *, train: bool, generator=None, prec: Precision = Precision()):
        g = generator if train else None
        h = dropout(self.vit.run(x, prec), self.dropout, g)
        h = F.leaky_relu(batch_norm(self.fc1(h), self.bn_fc1, train), 0.1)
        h = dropout(h, self.dropout, g)
        h = F.leaky_relu(batch_norm(self.fc2(h), self.bn_fc2, train), 0.1)
        h = dropout(h, self.dropout / 2, g)
        return torch.stack([head[1](h) for head in self.string_heads], dim=1)


def build(model: dict) -> nn.Module:
    gelu = model["gelu"]
    if gelu == "auto":  # the configurations state tanh at bfloat16, erf at float32
        gelu = "tanh" if model["dtype"] == "bfloat16" else "none"
    return ViTTab(model["vit_hidden"], model["vit_layers"], model["vit_heads"],
                  model["vit_patch"], 224, 4 * model["vit_hidden"],
                  "none" if gelu == "exact" else gelu, model["dropout"],
                  model["num_strings"], model["num_frets"])
