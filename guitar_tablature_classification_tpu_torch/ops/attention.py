"""Multi-head attention of the ViT blocks: the plain version, the fused path
through the Hopper kernels of ``csrc/attention.cu``, and the dispatch rule.

The counterpart of the JAX package's ``ops/attention_pallas.py``
(``fused_attention`` with its custom VJP) and of ``_resolve_attention``
(``models/tabnet.py:115-131``).  Both take the layout of
``jax.nn.dot_product_attention``: q, k, v ``[B, N, H, Dh]`` -> ``[B, N, H,
Dh]``, scale ``Dh**-0.5``.

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


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T * Dh^-1/2) v over [B, N, H, Dh] tensors (the plain
    version; ``jax.nn.dot_product_attention``'s numerics)."""
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("btnh,bsnh->bnts", q.float(), k.float()) * scale
    weights = torch.softmax(scores, dim=-1).to(dtype)
    if q.device.type == "cpu":  # PyTorch's CPU bf16 products are unreliable
        return torch.einsum("bnts,bsnh->btnh", weights.float(), v.float()).to(dtype)
    return torch.einsum("bnts,bsnh->btnh", weights, v)  # fp32 accumulation


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


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: [B, N, H, Dh] -> [B, N, H, Dh], the layout of the JAX
    package's ``fused_attention``.  Its TPU knobs ``q_tile`` and
    ``interpret`` have no counterpart: the card's kernels choose their own
    tiles, and the CPU runs the plain version."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return attention_reference(q, k, v)
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
