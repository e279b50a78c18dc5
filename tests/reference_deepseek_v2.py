"""A plain float32 reference of the ``deepseek_v2`` arch, for the CPU tests:
DeepSeek-V2's decoder layers as written in the published
``modeling_deepseek.py`` (``DeepseekV2RMSNorm``,
``DeepseekV2YarnRotaryEmbedding``, ``apply_rotary_pos_emb``,
``DeepseekV2Attention`` with ``q_lora_rank`` null, ``DeepseekV2MLP``,
``MoEGate`` greedy top-k over a softmax, ``DeepseekV2MoE`` with its shared
experts and ``AddAuxiliaryLoss``), in plain ``torch`` operations: the
causal softmax written out, one loop over the experts, TF32 off.  It
imports neither JAX nor any kernel of the port.

Departures from the published model, the repo's own (the same as the
port's): a bias-free patch projection of the 224^2 image replaces the
token embeddings; a learned readout token is placed last, and the final
RMSNorm of it feeds ViTTab's tablature head (fc1 512, BatchNorm, leaky
ReLU 0.1, fc2 256, BatchNorm, leaky ReLU 0.1, six 19-way heads, with their
dropouts); there is no vocabulary and no LM head.

Keys: ``model.patch_embed.weight``, ``model.readout_token``,
``model.layers.{i}.*`` as published, ``model.norm.weight``, then ``fc1``,
``bn_fc1``, ``fc2``, ``bn_fc2``, ``string_heads.{i}.1``, so one state dict
loads here and into the port.  ``forward(x, generator)`` takes the port's
channels-last image; dropout keeps a value where a uniform draw from the
generator is under 1 - p (the port's ``Dropout``'s draws, in its order).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, weight, eps):
    variance = x.pow(2).mean(-1, keepdim=True)
    return weight * (x * torch.rsqrt(variance + eps))


class RMSNorm(nn.Module):
    def __init__(self, size, eps):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size))
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


def yarn_get_mscale(scale=1.0, mscale=1.0):
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_find_correction_dim(num_rotations, dim, base=10000, max_position_embeddings=2048):
    return (dim * math.log(max_position_embeddings / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base))


def yarn_find_correction_range(low_rot, high_rot, dim, base, max_position_embeddings):
    low = math.floor(yarn_find_correction_dim(low_rot, dim, base, max_position_embeddings))
    high = math.ceil(yarn_find_correction_dim(high_rot, dim, base, max_position_embeddings))
    return max(low, 0), min(high, dim - 1)


def yarn_linear_ramp_mask(lo, hi, dim):
    if lo == hi:
        hi += 0.001
    return torch.clamp((torch.arange(dim, dtype=torch.float32) - lo) / (hi - lo), 0, 1)


def yarn_cos_sin(dim, seq_len, base, rope):
    """``DeepseekV2YarnRotaryEmbedding._set_cos_sin_cache``."""
    factor = rope["factor"]
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    low, high = yarn_find_correction_range(rope["beta_fast"], rope["beta_slow"], dim, base,
                                           rope["original_max_position_embeddings"])
    inv_freq_mask = 1.0 - yarn_linear_ramp_mask(low, high, dim // 2)
    inv_freq = freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask
    t = torch.arange(seq_len, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    mscale = yarn_get_mscale(factor, rope["mscale"]) / yarn_get_mscale(factor, rope["mscale_all_dim"])
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos() * mscale, emb.sin() * mscale


def rotate_half(x):
    x1 = x[..., : x.shape[-1] // 2]
    x2 = x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    """q, k [B, H, S, d]; cos, sin [S, d]."""
    cos, sin = cos[None, None], sin[None, None]
    b, h, s, d = q.shape
    q = q.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    b, h, s, d = k.shape
    k = k.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


class Attention(nn.Module):
    def __init__(self, c):
        super().__init__()
        d = c["hidden_size"]
        self.h = c["num_attention_heads"]
        self.rank, self.nope, self.rope = c["kv_lora_rank"], c["qk_nope_head_dim"], c["qk_rope_head_dim"]
        self.v_dim = c["v_head_dim"]
        self.q_dim = self.nope + self.rope
        self.q_proj = nn.Linear(d, self.h * self.q_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(d, self.rank + self.rope, bias=False)
        self.kv_a_layernorm = RMSNorm(self.rank, c["rms_norm_eps"])
        self.kv_b_proj = nn.Linear(self.rank, self.h * (self.nope + self.v_dim), bias=False)
        self.o_proj = nn.Linear(self.h * self.v_dim, d, bias=False)
        self.softmax_scale = self.q_dim ** -0.5
        rope = c["rope_scaling"]
        mscale = yarn_get_mscale(rope["factor"], rope["mscale_all_dim"])
        self.softmax_scale = self.softmax_scale * mscale * mscale

    def forward(self, x, cos, sin, causal=True):
        bsz, q_len, _ = x.shape
        q = self.q_proj(x).view(bsz, q_len, self.h, self.q_dim).transpose(1, 2)
        q_nope, q_pe = torch.split(q, [self.nope, self.rope], dim=-1)
        compressed_kv = self.kv_a_proj_with_mqa(x)
        compressed_kv, k_pe = torch.split(compressed_kv, [self.rank, self.rope], dim=-1)
        k_pe = k_pe.view(bsz, q_len, 1, self.rope).transpose(1, 2)
        kv = (self.kv_b_proj(self.kv_a_layernorm(compressed_kv))
              .view(bsz, q_len, self.h, self.nope + self.v_dim).transpose(1, 2))
        k_nope, value_states = torch.split(kv, [self.nope, self.v_dim], dim=-1)
        q_pe, k_pe = apply_rotary_pos_emb(q_pe, k_pe, cos, sin)
        query_states = torch.cat([q_nope, q_pe], dim=-1)
        key_states = torch.cat([k_nope, k_pe.expand(bsz, self.h, q_len, self.rope)], dim=-1)
        scores = torch.matmul(query_states, key_states.transpose(2, 3)) * self.softmax_scale
        if causal:
            future = torch.ones(q_len, q_len, dtype=torch.bool, device=x.device).triu(1)
            scores = scores.masked_fill(future, float("-inf"))
        weights = torch.exp(scores - scores.amax(-1, keepdim=True))
        weights = weights / weights.sum(-1, keepdim=True)
        out = torch.matmul(weights, value_states).transpose(1, 2).reshape(bsz, q_len, -1)
        return self.o_proj(out)


class MLP(nn.Module):
    def __init__(self, d, width):
        super().__init__()
        self.gate_proj = nn.Linear(d, width, bias=False)
        self.up_proj = nn.Linear(d, width, bias=False)
        self.down_proj = nn.Linear(width, d, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class MoEGate(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.top_k, self.n = c["num_experts_per_tok"], c["n_routed_experts"]
        self.alpha, self.scaling = c["aux_loss_alpha"], c["routed_scaling_factor"]
        self.weight = nn.Parameter(torch.empty(self.n, c["hidden_size"]))

    def forward(self, x, top_k=None):
        bsz, seq_len, h = x.shape
        top_k = self.top_k if top_k is None else top_k
        logits = F.linear(x.reshape(-1, h).float(), self.weight.float())
        scores = logits.softmax(dim=-1)
        topk_weight, topk_idx = torch.topk(scores, k=top_k, dim=-1, sorted=True)
        topk_weight = topk_weight * self.scaling
        aux_loss = None
        if self.training and self.alpha > 0.0:
            ce = torch.zeros(bsz, self.n, device=x.device)
            ce.scatter_add_(1, topk_idx.view(bsz, -1),
                            torch.ones(bsz, seq_len * top_k, device=x.device))
            ce = ce / (seq_len * top_k / self.n)
            aux_loss = (ce * scores.view(bsz, seq_len, -1).mean(dim=1)).sum(dim=1).mean() * self.alpha
        return topk_idx, topk_weight, aux_loss


class AddAuxiliaryLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, loss):
        ctx.required_aux_loss = loss.requires_grad
        ctx.shape = loss.shape
        return x

    @staticmethod
    def backward(ctx, grad_output):
        grad_loss = None
        if ctx.required_aux_loss:
            grad_loss = torch.ones(ctx.shape, device=grad_output.device)
        return grad_output, grad_loss


class MoE(nn.Module):
    def __init__(self, c):
        super().__init__()
        d, width = c["hidden_size"], c["moe_intermediate_size"]
        self.experts = nn.ModuleList(MLP(d, width) for _ in range(c["n_routed_experts"]))
        self.gate = MoEGate(c)
        self.shared_experts = MLP(d, width * c["n_shared_experts"])

    def forward(self, x, top_k=None):
        identity, shape = x, x.shape
        topk_idx, topk_weight, aux_loss = self.gate(x, top_k)
        flat = x.reshape(-1, shape[-1])
        y = torch.zeros(flat.shape[0], topk_idx.shape[1], shape[-1], device=x.device)
        for e, expert in enumerate(self.experts):  # one loop over the experts
            token, slot = torch.nonzero(topk_idx == e, as_tuple=True)
            if token.numel():
                y = y.index_put((token, slot), expert(flat[token]))
        y = (y * topk_weight.unsqueeze(-1)).sum(dim=1).view(*shape)
        if aux_loss is not None:
            y = AddAuxiliaryLoss.apply(y, aux_loss)
        return y + self.shared_experts(identity)


class DecoderLayer(nn.Module):
    def __init__(self, c, i):
        super().__init__()
        self.self_attn = Attention(c)
        self.mlp = MLP(c["hidden_size"], c["intermediate_size"]) if i < c["first_k_dense_replace"] \
            else MoE(c)
        self.input_layernorm = RMSNorm(c["hidden_size"], c["rms_norm_eps"])
        self.post_attention_layernorm = RMSNorm(c["hidden_size"], c["rms_norm_eps"])

    def forward(self, x, cos, sin, causal=True, top_k=None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, causal)
        if isinstance(self.mlp, MoE):
            return x + self.mlp(self.post_attention_layernorm(x), top_k)
        return x + self.mlp(self.post_attention_layernorm(x))


class Backbone(nn.Module):
    def __init__(self, c, patch, size, channels):
        super().__init__()
        d = c["hidden_size"]
        self.patch_embed = nn.Conv2d(channels, d, patch, patch, bias=False)
        self.readout_token = nn.Parameter(torch.zeros(1, 1, d))
        self.layers = nn.ModuleList(DecoderLayer(c, i) for i in range(c["num_hidden_layers"]))
        self.norm = RMSNorm(d, c["rms_norm_eps"])
        self.tokens = (size // patch) ** 2 + 1
        self.c = c

    def forward(self, x, causal=True, top_k=None):
        x = self.patch_embed(x).flatten(2).transpose(1, 2)
        x = torch.cat([x, self.readout_token.expand(x.shape[0], 1, -1)], dim=1)
        cos, sin = yarn_cos_sin(self.c["qk_rope_head_dim"], x.shape[1], self.c["rope_theta"],
                                self.c["rope_scaling"])
        cos, sin = cos.to(x.device), sin.to(x.device)
        for layer in self.layers:
            x = layer(x, cos, sin, causal, top_k)
        return self.norm(x[:, -1])


def _dropout(x, p, generator):
    if generator is None or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class DeepseekV2TabReference(nn.Module):
    def __init__(self, c, *, patch=8, size=224, channels=3, dropout=0.3, strings=6, frets=19):
        super().__init__()
        self.model = Backbone(c, patch, size, channels)
        self.dropout = dropout
        d = c["hidden_size"]
        self.fc1, self.bn_fc1 = nn.Linear(d, 512), nn.BatchNorm1d(512)
        self.fc2, self.bn_fc2 = nn.Linear(512, 256), nn.BatchNorm1d(256)
        self.string_heads = nn.ModuleList(
            nn.Sequential(nn.Dropout(dropout / 2), nn.Linear(256, frets)) for _ in range(strings))

    def _bn(self, x, m):
        if self.training:
            return F.batch_norm(x, None, None, m.weight, m.bias, True, 0.0, m.eps)
        return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias, False, 0.0, m.eps)

    def forward(self, x, generator=None, causal=True, top_k=None):
        """x [B, H, W, C] -> [B, strings, frets]."""
        g = generator if self.training else None
        h = _dropout(self.model(x.permute(0, 3, 1, 2), causal, top_k), self.dropout, g)
        h = F.leaky_relu(self._bn(self.fc1(h), self.bn_fc1), 0.1)
        h = _dropout(h, self.dropout, g)
        h = F.leaky_relu(self._bn(self.fc2(h), self.bn_fc2), 0.1)
        h = _dropout(h, self.dropout / 2, g)
        return torch.stack([head[1](h) for head in self.string_heads], dim=1)
