"""Multi-head attention of the ViT blocks: the plain version, the fused path
through the Hopper kernels of ``csrc/attention.cu``, and the dispatch rule.

The counterpart of the JAX package's ``ops/attention_pallas.py``
(``fused_attention`` with its custom VJP) and of ``_resolve_attention``
(``models/tabnet.py:115-131``).  Both take the layout of
``jax.nn.dot_product_attention``: q, k, v ``[B, N, H, Dh]`` -> ``[B, N, H,
Dh]``, scale ``Dh**-0.5``.  Both also take DeepSeek-V2's latent attention
(MLA): query/key width 192 against value width 128, an explicit ``scale``
and a ``causal`` mask (key s weighted in query row t only where s <= t).

- :func:`attention_reference` is the plain version: the function of
  ``jax.nn.dot_product_attention`` (its XLA path).  The score GEMM takes the
  input dtype's operands with fp32 results, the softmax runs in fp32, its
  weights are rounded to the input dtype, and the value GEMM accumulates in
  fp32 and rounds once to the input dtype.  The bf16 score GEMM runs on
  exactly upcast fp32 operands (the same products; PyTorch's bf16
  ``matmul`` would round the scores to bf16), and so does the value GEMM on
  the CPU, whose bf16 products PyTorch gets wrong on some shapes.
- :func:`fused_attention` sends CPU tensors to the plain version, whose
  backward is autograd through it.  CUDA tensors go to the kernels of
  :mod:`.attention_cuda` through :class:`FusedAttention`; the wrappers
  raise for a tensor they cannot take, and nothing falls back.
"""

from __future__ import annotations

import torch

from . import attention_cuda

TOKEN_THRESHOLD = 128  # models/tabnet.py:131 of the JAX package


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float | None = None, causal: bool = False) -> torch.Tensor:
    """softmax(q k^T * scale) v over q, k [B, N, H, Dqk] and v [B, N, H,
    Dv] (the plain version; ``jax.nn.dot_product_attention``'s numerics);
    ``scale`` Dqk^-1/2 when None, and under ``causal`` the scores of keys
    past their query are -inf."""
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    scores = torch.einsum("btnh,bsnh->bnts", q.float(), k.float()) * scale
    if causal:
        n = q.shape[1]
        future = torch.ones(n, n, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(future, float("-inf"))
    weights = torch.softmax(scores, dim=-1).to(dtype)
    if q.device.type == "cpu":  # PyTorch's CPU bf16 products are unreliable
        return torch.einsum("bnts,bsnh->btnh", weights.float(), v.float()).to(dtype)
    return torch.einsum("bnts,bsnh->btnh", weights, v)  # fp32 accumulation


class FusedMLAAttention(torch.autograd.Function):
    """Latent attention's widths on the card (:func:`.attention_cuda.fwd_mla`
    and ``bwd_mla``), the same scheme as :class:`FusedAttention`."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, lse = attention_cuda.fwd_mla(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return (*attention_cuda.bwd_mla(q, k, v, out, lse, g.contiguous(), ctx.scale, ctx.causal),
                None, None)


class FusedAttention(torch.autograd.Function):
    """Attention on the card: the forward kernel saves the per-(row, head)
    log-sum-exp, and the backward kernels recompute the weights from it
    (``_fused_attention_fwd`` / ``_fused_attention_bwd`` of the JAX
    package)."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = attention_cuda.fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        # autograd may hand over an expanded gradient (stride 0); the kernel
        # reads contiguous head-dim rows.  No copy when g already is one.
        return attention_cuda.bwd(q, k, v, out, lse, g.contiguous())


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None, causal: bool = False) -> torch.Tensor:
    """q, k, v: [B, N, H, Dh] -> [B, N, H, Dh], the layout of the JAX
    package's ``fused_attention``.  Its TPU knobs ``q_tile`` and
    ``interpret`` have no counterpart: the card's kernels choose their own
    tiles, and the CPU runs the plain version.  Query/key width 192 with
    value width 128 (latent attention) takes the MLA kernels, with
    ``scale`` and ``causal``; every other shape the 64-wide kernels, which
    take neither a mask nor another scale than Dh^-1/2."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return attention_reference(q, k, v, scale=scale, causal=causal)
    if (q.shape[-1], v.shape[-1]) == attention_cuda.MLA_DIMS:
        return FusedMLAAttention.apply(q, k, v, q.shape[-1] ** -0.5 if scale is None else scale,
                                       causal)
    if causal or (scale is not None and scale != q.shape[-1] ** -0.5):
        raise ValueError("the 64-wide attention kernels take no mask and scale by Dh^-1/2")
    return FusedAttention.apply(q, k, v)


def resolve_attention(impl: str, tokens: int) -> str:
    """The port of ``_resolve_attention``: ``"auto"`` gives ``"pallas"``
    (the fused path, :func:`fused_attention`) above 128 tokens and
    ``"xla"`` (the plain version) at or below it; an explicit choice is
    kept.  The 128-token threshold is the JAX package's TPU crossover,
    kept as it is; ``chip_smoke.py`` prints the card's times at 19, 197
    and 785 tokens beside it."""
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"attention_impl must be 'auto', 'pallas' or 'xla', got {impl!r}")
    if impl != "auto":
        return impl
    return "pallas" if tokens > TOKEN_THRESHOLD else "xla"
