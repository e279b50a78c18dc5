"""The reference model of ``arch`` ``deepseek_v2``: DeepSeek-V2's decoder
layers as the published ``modeling_deepseek.py`` writes them
(``DeepseekV2RMSNorm``, ``DeepseekV2YarnRotaryEmbedding``,
``apply_rotary_pos_emb``, ``DeepseekV2Attention`` without query
compression, ``DeepseekV2MLP``, ``MoEGate`` with greedy top-k over a
softmax, ``DeepseekV2MoE`` with its shared experts, ``AddAuxiliaryLoss``
with the sequence balance loss), in plain float32: the causal softmax
written out, one loop over the experts.

Departures, the repo's own: a bias-free patch projection of the 224^2
three-channel image (8x8 patches) replaces the token embeddings; a learned
readout token is placed last (position 784), and the final RMSNorm of it
feeds ViTTab's tablature head (Dropout, fc1 2048->512, BatchNorm, leaky
ReLU .1, Dropout, fc2 512->256, BatchNorm, leaky ReLU .1, per string
Dropout then Linear 256->19, one mask for the six strings); no vocabulary,
no LM head.

In train mode the backbone runs in blocks of ``BLOCK`` windows, each under
``torch.utils.checkpoint`` (recomputed in the backward), so that the fp32
activations of a 2.4 B-parameter stage fit the card beside its Adam
state: every window is computed alone but for the balance loss, whose mean
over the batch each block adds its share of.  The head's BatchNorms see
the whole batch.  ``prec`` rounds the operands of every backbone product
(projections, attention's two products, experts, patch projection), not
the router's fp32 logits."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .cqt import image
from .models import batch_norm, dropout, linear
from .precision import Precision

BLOCK = 8  # windows a checkpointed block of the backbone takes in training


def rms_norm(x, m):
    return m.weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + m.eps))


class RMSNorm(nn.Module):
    def __init__(self, size, eps):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size))
        self.eps = eps


def yarn_get_mscale(scale, mscale):
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations, dim, base, positions):
    return (dim * math.log(positions / (rotations * 2 * math.pi))) / (2 * math.log(base))


def yarn_cos_sin(dim, seq_len, base, rope, device):
    factor = rope["factor"]
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (base ** exps)
    freq_inter = 1.0 / (factor * base ** exps)
    orig = rope["original_max_position_embeddings"]
    low = max(math.floor(_correction_dim(rope["beta_fast"], dim, base, orig)), 0)
    high = min(math.ceil(_correction_dim(rope["beta_slow"], dim, base, orig)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    inv_freq_mask = 1.0 - ramp
    inv_freq = freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask
    freqs = torch.outer(torch.arange(seq_len, dtype=torch.float32, device=device), inv_freq)
    m = yarn_get_mscale(factor, rope["mscale"]) / yarn_get_mscale(factor, rope["mscale_all_dim"])
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos() * m, emb.sin() * m


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat((-x[..., half:], x[..., :half]), dim=-1)


def rotary(x, cos, sin):
    """x [B, H, S, d]: the published interleave regrouped, then rotated."""
    b, h, s, d = x.shape
    x = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return x * cos + rotate_half(x) * sin


class Attention(nn.Module):
    def __init__(self, c):
        super().__init__()
        d, self.h = c["hidden_size"], c["num_attention_heads"]
        self.rank, self.nope, self.rope = c["kv_lora_rank"], c["qk_nope_head_dim"], c["qk_rope_head_dim"]
        self.v_dim = c["v_head_dim"]
        self.q_dim = self.nope + self.rope
        self.q_proj = nn.Linear(d, self.h * self.q_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(d, self.rank + self.rope, bias=False)
        self.kv_a_layernorm = RMSNorm(self.rank, c["rms_norm_eps"])
        self.kv_b_proj = nn.Linear(self.rank, self.h * (self.nope + self.v_dim), bias=False)
        self.o_proj = nn.Linear(self.h * self.v_dim, d, bias=False)
        rope = c["rope_scaling"]
        m = yarn_get_mscale(rope["factor"], rope["mscale_all_dim"])
        self.scale = self.q_dim ** -0.5 * m * m

    def run(self, x, cos, sin, prec):
        b, n, _ = x.shape
        q = linear(x, self.q_proj, prec).view(b, n, self.h, self.q_dim).transpose(1, 2)
        q_nope, q_pe = torch.split(q, [self.nope, self.rope], dim=-1)
        latent, k_pe = torch.split(linear(x, self.kv_a_proj_with_mqa, prec),
                                   [self.rank, self.rope], dim=-1)
        k_pe = k_pe.view(b, n, 1, self.rope).transpose(1, 2)
        kv = linear(rms_norm(latent, self.kv_a_layernorm), self.kv_b_proj, prec)
        kv = kv.view(b, n, self.h, self.nope + self.v_dim).transpose(1, 2)
        k_nope, v = torch.split(kv, [self.nope, self.v_dim], dim=-1)
        q = torch.cat([q_nope, rotary(q_pe, cos, sin)], dim=-1)
        k = torch.cat([k_nope, rotary(k_pe, cos, sin).expand(b, self.h, n, self.rope)], dim=-1)
        scores = (prec(q) @ prec(k).transpose(-1, -2)) * self.scale
        future = torch.ones(n, n, dtype=torch.bool, device=x.device).triu(1)
        scores = scores.masked_fill(future, float("-inf"))
        weights = torch.exp(scores - scores.amax(-1, keepdim=True))
        weights = weights / weights.sum(-1, keepdim=True)
        out = (prec(weights) @ prec(v)).transpose(1, 2).reshape(b, n, self.h * self.v_dim)
        return linear(out, self.o_proj, prec)


class MLP(nn.Module):
    def __init__(self, d, width):
        super().__init__()
        self.gate_proj = nn.Linear(d, width, bias=False)
        self.up_proj = nn.Linear(d, width, bias=False)
        self.down_proj = nn.Linear(width, d, bias=False)

    def run(self, x, prec):
        h = F.silu(linear(x, self.gate_proj, prec)) * linear(x, self.up_proj, prec)
        return linear(h, self.down_proj, prec)


class _Gate(nn.Module):
    def __init__(self, experts, d):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(experts, d))


class AddAuxiliaryLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, loss):
        ctx.needs, ctx.shape = loss.requires_grad, loss.shape
        return x

    @staticmethod
    def backward(ctx, g):
        return g, torch.ones(ctx.shape, device=g.device) if ctx.needs else None


class MoE(nn.Module):
    def __init__(self, c):
        super().__init__()
        d, width = c["hidden_size"], c["moe_intermediate_size"]
        self.n, self.k = c["n_routed_experts"], c["num_experts_per_tok"]
        self.alpha, self.scaling = c["aux_loss_alpha"], c["routed_scaling_factor"]
        self.experts = nn.ModuleList(MLP(d, width) for _ in range(self.n))
        self.gate = _Gate(self.n, d)
        self.shared_experts = MLP(d, width * c["n_shared_experts"])

    def run(self, x, prec, train, windows):
        """``windows``: the whole batch's, of which ``x`` holds a block."""
        b, s, d = x.shape
        flat = x.reshape(-1, d)
        scores = F.linear(flat, self.gate.weight).softmax(dim=-1)
        weight, idx = torch.topk(scores, self.k, dim=-1, sorted=True)
        weight = weight * self.scaling
        y = torch.zeros(flat.shape[0], self.k, d, device=x.device)
        for e, expert in enumerate(self.experts):  # an expert no row chose gets a zero gradient
            token, slot = torch.nonzero(idx == e, as_tuple=True)
            rows = expert.run(flat[token], prec if token.numel() else Precision())
            y = y.index_put((token, slot), rows)
        y = (y * weight.unsqueeze(-1)).sum(dim=1).view(b, s, d)
        if train and self.alpha > 0:
            ce = torch.zeros(b, self.n, device=x.device)
            ce.scatter_add_(1, idx.view(b, -1), torch.ones(b, s * self.k, device=x.device))
            ce = ce / (s * self.k / self.n)
            aux = (ce * scores.view(b, s, -1).mean(dim=1)).sum(dim=1).sum() / windows * self.alpha
            y = AddAuxiliaryLoss.apply(y, aux)
        return y + self.shared_experts.run(x, prec)


class DecoderLayer(nn.Module):
    def __init__(self, c, i):
        super().__init__()
        self.self_attn = Attention(c)
        dense = i < c["first_k_dense_replace"]
        self.mlp = MLP(c["hidden_size"], c["intermediate_size"]) if dense else MoE(c)
        self.input_layernorm = RMSNorm(c["hidden_size"], c["rms_norm_eps"])
        self.post_attention_layernorm = RMSNorm(c["hidden_size"], c["rms_norm_eps"])

    def run(self, x, cos, sin, prec, train, windows):
        x = x + self.self_attn.run(rms_norm(x, self.input_layernorm), cos, sin, prec)
        y = rms_norm(x, self.post_attention_layernorm)
        if isinstance(self.mlp, MoE):
            return x + self.mlp.run(y, prec, train, windows)
        return x + self.mlp.run(y, prec)


class Backbone(nn.Module):
    def __init__(self, c, patch=8, channels=3):
        super().__init__()
        d = c["hidden_size"]
        self.c = c
        self.patch_embed = nn.Conv2d(channels, d, patch, patch, bias=False)
        self.readout_token = nn.Parameter(torch.zeros(1, 1, d))
        self.layers = nn.ModuleList(DecoderLayer(c, i) for i in range(c["num_hidden_layers"]))
        self.norm = RMSNorm(d, c["rms_norm_eps"])

    def run(self, x, prec, train, windows):
        w = self.patch_embed
        x = F.conv2d(prec(x), prec(w.weight), None, w.stride).flatten(2).transpose(1, 2)
        x = torch.cat([x, self.readout_token.expand(x.shape[0], 1, -1)], dim=1)
        c = self.c
        cos, sin = yarn_cos_sin(c["qk_rope_head_dim"], x.shape[1], c["rope_theta"],
                                c["rope_scaling"], x.device)
        for layer in self.layers:
            x = layer.run(x, cos, sin, prec, train, windows)
        return rms_norm(x[:, -1], self.norm)


class DeepseekV2Tab(nn.Module):
    """NCHW 224^2 image -> [B, strings, frets] logits."""

    def __init__(self, c, patch=8, dropout=0.3, strings=6, frets=19):
        super().__init__()
        self.dropout = dropout
        self.model = Backbone(c, patch)
        d = c["hidden_size"]
        self.fc1, self.bn_fc1 = nn.Linear(d, 512), nn.BatchNorm1d(512)
        self.fc2, self.bn_fc2 = nn.Linear(512, 256), nn.BatchNorm1d(256)
        self.string_heads = nn.ModuleList(
            nn.Sequential(nn.Dropout(dropout / 2), nn.Linear(256, frets)) for _ in range(strings))

    @staticmethod
    def inputs(db: torch.Tensor) -> torch.Tensor:
        return image(db, 224, imagenet=False)

    def logit_weights(self) -> list[str]:
        return [f"string_heads.{i}.1.weight" for i in range(len(self.string_heads))]

    def features(self, x, train: bool, prec: Precision):
        """The backbone's readout features, in checkpointed blocks of
        ``BLOCK`` windows in train mode."""
        b = x.shape[0]
        if not train:
            return self.model.run(x, prec, False, b)
        return torch.cat([checkpoint(self.model.run, x[lo:lo + BLOCK], prec, True, b,
                                     use_reentrant=False)
                          for lo in range(0, b, BLOCK)])

    def run(self, x, *, train: bool, generator=None, prec: Precision = Precision()):
        g = generator if train else None
        h = dropout(self.features(x, train, prec), self.dropout, g)
        h = F.leaky_relu(batch_norm(self.fc1(h), self.bn_fc1, train), 0.1)
        h = dropout(h, self.dropout, g)
        h = F.leaky_relu(batch_norm(self.fc2(h), self.bn_fc2, train), 0.1)
        h = dropout(h, self.dropout / 2, g)
        return torch.stack([head[1](h) for head in self.string_heads], dim=1)


def build(model: dict) -> nn.Module:
    return DeepseekV2Tab(model["deepseek"], model["vit_patch"], model["dropout"],
                         model["num_strings"], model["num_frets"])
