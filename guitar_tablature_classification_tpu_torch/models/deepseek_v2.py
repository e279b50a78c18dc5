"""DeepSeek-V2's decoder layers as the tablature backbone (arch
``deepseek_v2``): latent attention (MLA) with YaRN rotary positions, a
leading dense SwiGLU layer, then routed and shared SwiGLU experts.

The layers follow the published modeling code (``modeling_deepseek.py``:
``DeepseekV2RMSNorm``, ``DeepseekV2YarnRotaryEmbedding``,
``apply_rotary_pos_emb``, ``DeepseekV2Attention`` without query
compression, ``DeepseekV2MLP``, ``MoEGate``, ``DeepseekV2MoE``,
``DeepseekV2DecoderLayer``), with the sizes of ``ModelConfig.deepseek``,
the published ``config.json`` keys under their own names.  The state dict
keeps the published layout, ``model.layers.{i}.self_attn.q_proj.weight``,
``model.layers.{i}.mlp.experts.{e}.gate_proj.weight`` and so on, so the
published checkpoint's layers load by name.

Departures, the repo's own, for a model over spectrogram patches:

- the patch projection ``model.patch_embed`` (a bias-free ``patch``-wide
  convolution of the 224^2, three-channel image) replaces the token
  embedding table, and there is no vocabulary;
- a learned readout token ``model.readout_token`` is placed last (token
  784 at patch 8): under the causal mask only the last token sees every
  patch, and the published model classifies a sequence from its last token
  (``DeepseekV2ForSequenceClassification``);
- ``model.norm`` is applied to the readout token alone, and ViTTab's
  tablature head (fc1, BatchNorm, leaky ReLU, fc2, BatchNorm, leaky ReLU,
  six string heads, dropout) replaces the LM head.

Numerics: fp32 parameters, products in ``dtype`` (bf16: every projection
casts its weight per call, fp32 accumulation); RMSNorm's statistics in
fp32 and its weight applied after the cast back; the rotary tables
rounded to ``dtype``; the softmax of attention in fp32 with its weights
rounded to ``dtype``; the router in fp32.  Attention runs through
:func:`..ops.attention.fused_attention` (the MLA kernels of
``csrc/attention.cu`` on the card, the plain version on the CPU); the
experts through :mod:`..ops.moe`.  Train mode adds the balance loss's
gradient (``aux_loss_alpha``) to the router's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import moe
from ..ops.attention import fused_attention
from ..utils import profiling
from .heads import Dropout, SimpleStringHeads
from .resnet import Conv2d, FlaxBatchNorm, Linear, operands

# the keys of ModelConfig.deepseek that the layers read (config.json names)
KEYS = (
    "hidden_size", "num_hidden_layers", "num_attention_heads", "q_lora_rank", "kv_lora_rank",
    "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "intermediate_size",
    "moe_intermediate_size", "n_routed_experts", "n_shared_experts", "num_experts_per_tok",
    "first_k_dense_replace", "moe_layer_freq", "norm_topk_prob", "routed_scaling_factor",
    "scoring_func", "topk_method", "seq_aux", "aux_loss_alpha", "rms_norm_eps", "rope_theta",
    "rope_scaling", "hidden_act", "attention_bias",
)


def check_config(c: dict) -> None:
    """Raise for a ``deepseek`` group the port cannot run as published."""
    missing = [k for k in KEYS if k not in c]
    if missing:
        raise ValueError(f"ModelConfig.deepseek lacks {missing}")
    fixed = {"q_lora_rank": None, "scoring_func": "softmax", "topk_method": "greedy",
             "hidden_act": "silu", "attention_bias": False, "norm_topk_prob": False,
             "moe_layer_freq": 1, "seq_aux": True}
    wrong = {k: c[k] for k, v in fixed.items() if c[k] != v}
    if wrong:
        raise ValueError(f"the deepseek_v2 arch runs {fixed}; got {wrong}")
    rope = c["rope_scaling"]
    if rope is None or rope.get("type") != "yarn":
        raise ValueError(f"the deepseek_v2 arch runs YaRN rotary scaling, got {rope!r}")


# ------------------------------------------------------------------ norms


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return weight.to(x.dtype) * (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)).to(x.dtype)


class _RMSNorm(torch.autograd.Function):
    """``DeepseekV2RMSNorm``: x * rsqrt(mean(x^2) + eps) in fp32, cast back
    to x's dtype, times the weight in that dtype.  Saves x, not its fp32
    copy: the backward recomputes the forward."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms_norm(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        with torch.enable_grad():
            xx, ww = x.detach().requires_grad_(), weight.detach().requires_grad_()
            dx, dw = torch.autograd.grad(_rms_norm(xx, ww, ctx.eps), (xx, ww), g)
        return dx, dw, None


class RMSNorm(nn.Module):
    def __init__(self, size: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size))
        self.variance_epsilon = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _RMSNorm.apply(x, self.weight, self.variance_epsilon)


# ----------------------------------------------------------------- rotary


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, dim: int, base: float, positions: int) -> float:
    return (dim * math.log(positions / (rotations * 2 * math.pi))) / (2 * math.log(base))


def yarn_tables(dim: int, positions: int, base: float, rope: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """``DeepseekV2YarnRotaryEmbedding``'s cos and sin [positions, dim] in
    fp32: the extrapolated and interpolated frequencies blended by the
    linear ramp between the correction dimensions of ``beta_fast`` and
    ``beta_slow``, times mscale(mscale) / mscale(mscale_all_dim)."""
    factor = rope["factor"]
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    freq_extra = 1.0 / (base ** exps)
    freq_inter = 1.0 / (factor * base ** exps)
    orig = rope["original_max_position_embeddings"]
    low = max(math.floor(_correction_dim(rope["beta_fast"], dim, base, orig)), 0)
    high = min(math.ceil(_correction_dim(rope["beta_slow"], dim, base, orig)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    mask = 1.0 - ramp
    inv_freq = freq_inter * (1 - mask) + freq_extra * mask
    freqs = torch.outer(torch.arange(positions, dtype=torch.float32), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    m = yarn_mscale(factor, rope["mscale"]) / yarn_mscale(factor, rope["mscale_all_dim"])
    return emb.cos() * m, emb.sin() * m


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, N, H, d] -> the published ``apply_rotary_pos_emb`` of it: the
    interleaved pairs regrouped as halves, then x cos + rotate_half(x)
    sin (cos, sin [N, d] in x's dtype)."""
    b, n, h, d = x.shape
    x = x.view(b, n, h, d // 2, 2).transpose(-1, -2).reshape(b, n, h, d)
    return x * cos[:, None] + rotate_half(x) * sin[:, None]


# -------------------------------------------------------------- attention


class Attention(nn.Module):
    """``DeepseekV2Attention`` without query compression: q_proj,
    kv_a_proj_with_mqa (the latent and one rotary key for all heads),
    kv_a_layernorm, kv_b_proj (the latent to each head's key and value)
    and o_proj; causal, scaled by q_head_dim^-1/2 * mscale(mscale_all_dim)^2."""

    def __init__(self, c: dict):
        super().__init__()
        d, h = c["hidden_size"], c["num_attention_heads"]
        self.heads, self.rank = h, c["kv_lora_rank"]
        self.nope, self.rope, self.v_dim = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
        self.q_dim = self.nope + self.rope
        self.q_proj = Linear(d, h * self.q_dim, bias=False)
        self.kv_a_proj_with_mqa = Linear(d, self.rank + self.rope, bias=False)
        self.kv_a_layernorm = RMSNorm(self.rank, c["rms_norm_eps"])
        self.kv_b_proj = Linear(self.rank, h * (self.nope + self.v_dim), bias=False)
        self.o_proj = Linear(h * self.v_dim, d, bias=False)
        rope = c["rope_scaling"]
        m = yarn_mscale(rope["factor"], rope["mscale_all_dim"])
        self.scale = self.q_dim ** -0.5 * m * m

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        h = self.heads
        q = self.q_proj(x).view(b, n, h, self.q_dim)
        q_nope, q_pe = q.split([self.nope, self.rope], dim=-1)
        latent, k_pe = self.kv_a_proj_with_mqa(x).split([self.rank, self.rope], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(latent)).view(b, n, h, self.nope + self.v_dim)
        k_nope, v = kv.split([self.nope, self.v_dim], dim=-1)
        q = torch.cat([q_nope, apply_rotary(q_pe, cos, sin)], dim=-1)
        k_pe = apply_rotary(k_pe.view(b, n, 1, self.rope), cos, sin)
        k = torch.cat([k_nope, k_pe.expand(b, n, h, self.rope)], dim=-1)
        out = fused_attention(q, k, v, scale=self.scale, causal=True)
        return self.o_proj(out.reshape(b, n, h * self.v_dim))


# ------------------------------------------------------------------ MLPs


class MLP(nn.Module):
    """``DeepseekV2MLP``: down(silu(gate(x)) * up(x)), gate and up as one
    product."""

    def __init__(self, d: int, width: int):
        super().__init__()
        self.gate_proj = Linear(d, width, bias=False)
        self.up_proj = Linear(d, width, bias=False)
        self.down_proj = Linear(width, d, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, _, dtype = operands(x, torch.cat([self.gate_proj.weight, self.up_proj.weight]), None)
        return self.down_proj(moe.SwiGLU.apply(F.linear(x, w).to(dtype)))


class Gate(nn.Module):
    def __init__(self, d: int, experts: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(experts, d))


class ExpertLayer(nn.Module):
    """``DeepseekV2MoE``: the router's top-k of ``n_routed_experts`` routed
    SwiGLU experts, weighted by their scores, plus the shared experts (one
    SwiGLU of ``n_shared_experts`` times the expert width)."""

    def __init__(self, c: dict):
        super().__init__()
        d, width = c["hidden_size"], c["moe_intermediate_size"]
        self.top_k, self.n = c["num_experts_per_tok"], c["n_routed_experts"]
        self.scaling, self.alpha = c["routed_scaling_factor"], c["aux_loss_alpha"]
        self.experts = nn.ModuleList(MLP(d, width) for _ in range(self.n))
        self.gate = Gate(d, self.n)
        self.shared_experts = MLP(d, width * c["n_shared_experts"])
        self.register_buffer("rows", torch.zeros(self.n, dtype=torch.int64), persistent=False)
        moe.LAYERS.add(self)

    def stacked(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """Every expert's (gate | up) [E, 2I, D] and down [E, D, I] weights
        in ``dtype``, stacked from their own parameters."""
        gate_up = torch.stack([w for e in self.experts
                               for w in (e.gate_proj.weight, e.up_proj.weight)])
        down = torch.stack([e.down_proj.weight for e in self.experts])
        e, width, d = self.n, gate_up.shape[1], gate_up.shape[2]
        return gate_up.view(e, 2 * width, d).to(dtype), down.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        flat = x.reshape(b * n, d)
        with profiling.span("model.moe.route"):
            weights, ids, scores = moe.route(flat, self.gate.weight, self.top_k, self.scaling)
            order, ends, inverse = moe.dispatch(ids, self.n)
            self.rows.copy_(torch.diff(ends, prepend=ends.new_zeros(1)))
            rows = moe.gather_rows(flat, order, self.top_k)
        with profiling.span("model.moe.experts"):
            gate_up, down = self.stacked(x.dtype)
            out = moe.expert_outputs(rows, gate_up, down, ends)
            y = moe.Combine.apply(out[inverse].view(b * n, self.top_k, d), weights)
        if self.training and self.alpha > 0:
            y = moe.AddAuxiliaryLoss.apply(y, moe.balance_loss(scores, ids, b, self.alpha))
        return y.view(b, n, d) + self.shared_experts(x)


class DecoderLayer(nn.Module):
    def __init__(self, c: dict, index: int):
        super().__init__()
        self.self_attn = Attention(c)
        dense = index < c["first_k_dense_replace"]
        self.mlp = MLP(c["hidden_size"], c["intermediate_size"]) if dense else ExpertLayer(c)
        self.input_layernorm = RMSNorm(c["hidden_size"], c["rms_norm_eps"])
        self.post_attention_layernorm = RMSNorm(c["hidden_size"], c["rms_norm_eps"])

    def forward(self, x, cos, sin):
        with profiling.span("model.attn"):
            x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class DeepseekV2Backbone(nn.Module):
    """NCHW image -> [B, hidden] fp32: patch tokens and the readout token
    last, the decoder layers, the final norm of the readout token."""

    def __init__(self, c: dict, patch: int, input_hw: tuple[int, int], channels: int,
                 dtype: torch.dtype):
        super().__init__()
        d = c["hidden_size"]
        self.dtype = dtype
        self.tokens = (input_hw[0] // patch) * (input_hw[1] // patch) + 1
        self.patch_embed = Conv2d(channels, d, patch, stride=patch, bias=False)
        self.readout_token = nn.Parameter(torch.zeros(1, 1, d))
        self.layers = nn.ModuleList(DecoderLayer(c, i) for i in range(c["num_hidden_layers"]))
        self.norm = RMSNorm(d, c["rms_norm_eps"])
        cos, sin = yarn_tables(c["qk_rope_head_dim"], self.tokens, c["rope_theta"], c["rope_scaling"])
        self.register_buffer("cos", cos, persistent=False)
        self.register_buffer("sin", sin, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = self.patch_embed(x.to(self.dtype)).flatten(2).transpose(1, 2)
        x = torch.cat([x, self.readout_token.to(self.dtype).expand(b, 1, -1)], dim=1)
        cos, sin = self.cos.to(self.dtype), self.sin.to(self.dtype)
        for layer in self.layers:
            x = layer(x, cos, sin)
        return self.norm(x[:, -1]).float()


class DeepseekV2Tab(nn.Module):
    """The DeepSeek-V2 backbone -> ViTTab's head: fc1 512 -> fc2 256 (Flax
    BatchNorm + leaky ReLU 0.1) -> per-string heads, with its dropouts."""

    def __init__(self, c: dict, *, num_frets: int = 19, num_strings: int = 6, patch: int = 8,
                 input_hw: tuple[int, int] = (224, 224), input_channels: int = 3,
                 dropout: float = 0.3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        check_config(c)
        self.model = DeepseekV2Backbone(c, patch, input_hw, input_channels, dtype)
        d = c["hidden_size"]
        self.dropout1 = Dropout(dropout)
        self.fc1 = nn.Linear(d, 512)
        self.bn_fc1 = FlaxBatchNorm(512)
        self.dropout2 = Dropout(dropout)
        self.fc2 = nn.Linear(512, 256)
        self.bn_fc2 = FlaxBatchNorm(256)
        self.string_heads = SimpleStringHeads(
            256, num_frets=num_frets, num_strings=num_strings, dropout=dropout / 2)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """x: [B, H, W, C] -> [B, num_strings, num_frets] fp32 logits."""
        h = self.dropout1(self.model(x.permute(0, 3, 1, 2)), generator)
        h = F.leaky_relu(self.bn_fc1(self.fc1(h)), 0.1)
        h = self.dropout2(h, generator)
        h = F.leaky_relu(self.bn_fc2(self.fc2(h)), 0.1)
        return self.string_heads(h, generator)


def init_deepseek(model: DeepseekV2Tab, generator: torch.Generator, std: float = 0.02) -> DeepseekV2Tab:
    """Seeded initialization: every projection, the router and the patch
    projection normal with the published ``initializer_range`` (0.02),
    RMSNorm weights 1, a zero readout token; the head as ViTTab's
    (LeCun-normal fc1 and fc2 and string heads, zero biases, identity
    BatchNorms)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name == "model.readout_token":
                p.zero_()
            elif name.startswith("model."):
                p.normal_(0.0, std, generator=generator) if p.ndim >= 2 else p.fill_(1.0)
        for m in (model.fc1, model.fc2, *(h[1] for h in model.string_heads)):
            fan_in = m.weight.shape[1]
            nn.init.trunc_normal_(m.weight, std=fan_in ** -0.5, a=-2 * fan_in ** -0.5,
                                  b=2 * fan_in ** -0.5, generator=generator)
            m.bias.zero_()
    return model
