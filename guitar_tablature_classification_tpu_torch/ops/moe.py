"""Routed experts: DeepSeek-V2's router (``MoEGate``), the permutation of
tokens by expert, grouped expert GEMMs, the weighted combine and the
sequence balance loss (``DeepseekV2MoE``, ``AddAuxiliaryLoss``).

- :func:`route`: fp32 gate logits and softmax over all experts, greedy
  top-k, the raw softmax scores as the combine weights times
  ``routed_scaling_factor`` (``norm_topk_prob`` false).  No capacity: every
  (token, choice) row is computed.
- :func:`dispatch`: the rows sorted by expert (stable), the end offset of
  each expert's row group, and the inverse permutation, all on the device
  from a sort and a ``searchsorted``: nothing is read on the host, so a
  routed forward enqueues without a sync and captures into a CUDA graph.
- :class:`GroupedMM`: one ``torch._grouped_mm`` per projection over the
  experts' row groups (CUTLASS's grouped GEMM on sm90, bf16 operands with
  fp32 accumulation), and the two grouped products of its backward.  The
  experts' weights are stacked per call from their own parameters, so the
  state dict keeps the published per-expert layout.
- :class:`SwiGLU`: ``silu(g) * u`` of a fused gate/up output, saving only
  that output (its backward recomputes the SiLU).
- :class:`Combine`: each token's rows weighted by their scores and summed
  in fp32, rounded once to the compute dtype (``moe_infer``'s order); it
  saves the rows in the compute dtype, not their fp32 copy.
- :func:`balance_loss` and :class:`AddAuxiliaryLoss`: ``alpha * mean_b
  sum_e ce[b, e] * mean_t p[b, t, e]`` with ``ce`` window b's count of
  choices of expert e over ``tokens * k / experts``; its gradient enters in
  the backward, so the loss the step reports is the tab loss alone.

The permutation and the combine are deterministic: every output element
has one writer, and the repeated tokens' gradients are summed by the
expand's backward, not by atomics.

Each routing layer keeps ``rows`` (a device tensor, one count an expert)
updated in place by every forward, and :data:`LAYERS` holds the live
layers, so a reader can take the last forward's load without a sync in the
step.
"""

from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F

# every live layer that routes (ExpertLayer in models/deepseek_v2.py): its
# ``rows`` is the last forward's rows per expert
LAYERS: "weakref.WeakSet[torch.nn.Module]" = weakref.WeakSet()


def route(x: torch.Tensor, gate_weight: torch.Tensor, top_k: int,
          scaling: float = 1.0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [T, D] -> (weights [T, k] fp32, ids [T, k] int64, scores [T, E]
    fp32): the fp32 softmax over ``F.linear(x, gate_weight)`` and its top
    k in descending order."""
    scores = F.linear(x.float(), gate_weight.float()).softmax(dim=-1)
    weights, ids = torch.topk(scores, top_k, dim=-1, sorted=True)
    return weights * scaling, ids, scores


def balance_loss(scores: torch.Tensor, ids: torch.Tensor, windows: int, alpha: float) -> torch.Tensor:
    """The sequence balance loss (``seq_aux``) of scores [windows * tokens,
    E] and choices ids [windows * tokens, k]."""
    experts, k = scores.shape[-1], ids.shape[-1]
    tokens = scores.shape[0] // windows
    ce = torch.zeros(windows, experts, device=scores.device, dtype=torch.float32)
    ce.scatter_add_(1, ids.view(windows, tokens * k),
                    torch.ones(windows, tokens * k, device=scores.device))
    ce = ce / (tokens * k / experts)
    return (ce * scores.view(windows, tokens, experts).mean(dim=1)).sum(dim=1).mean() * alpha


class AddAuxiliaryLoss(torch.autograd.Function):
    """x unchanged forward; backward adds ``loss``'s gradient (one) to the
    graph, as the published ``AddAuxiliaryLoss``."""

    @staticmethod
    def forward(ctx, x, loss):
        ctx.needs = loss.requires_grad
        ctx.save_for_backward(loss)
        return x

    @staticmethod
    def backward(ctx, g):
        (loss,) = ctx.saved_tensors
        return g, torch.ones_like(loss) if ctx.needs else None


def dispatch(ids: torch.Tensor, experts: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ids [T, k] -> (order [T*k]: the (token, choice) rows sorted by
    expert, stable; ends [E] int32: each expert's end offset in that
    order; inverse [T*k]: where each (token, choice) row lands)."""
    flat = ids.reshape(-1)
    sorted_ids, order = torch.sort(flat, stable=True)
    bounds = torch.arange(1, experts + 1, device=ids.device, dtype=sorted_ids.dtype)
    ends = torch.searchsorted(sorted_ids, bounds).to(torch.int32)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=order.device)
    return order, ends, inverse


def gather_rows(x: torch.Tensor, order: torch.Tensor, k: int) -> torch.Tensor:
    """x [T, D] -> its rows in ``order`` (indices into the T*k (token,
    choice) rows), each token repeated k times first: the backward sums a
    token's k gradients in the expand's reduction."""
    t, d = x.shape
    return x.unsqueeze(1).expand(t, k, d).reshape(t * k, d)[order]


class GroupedMM(torch.autograd.Function):
    """rows [M, K] sorted by group, weights [E, N, K] (the ``nn.Linear``
    layout), ends [E] int32 -> [M, N]: group e's rows times weights[e]^T.
    Backward: d rows = g W (grouped), d W[e] = g_e^T rows_e (grouped over
    the rows)."""

    @staticmethod
    def forward(ctx, rows, weights, ends):
        ctx.save_for_backward(rows, weights, ends)
        return torch._grouped_mm(rows, weights.transpose(-2, -1), offs=ends)

    @staticmethod
    def backward(ctx, g):
        rows, weights, ends = ctx.saved_tensors
        g = g.contiguous()
        d_rows = torch._grouped_mm(g, weights, offs=ends)
        d_weights = torch._grouped_mm(g.t(), rows, offs=ends)
        return d_rows, d_weights, None


class SwiGLU(torch.autograd.Function):
    """h [M, 2I] (gate | up) -> silu(gate) * up [M, I] in h's dtype."""

    @staticmethod
    def forward(ctx, h):
        ctx.save_for_backward(h)
        gate, up = h.chunk(2, dim=-1)
        return F.silu(gate) * up

    @staticmethod
    def backward(ctx, g):
        (h,) = ctx.saved_tensors
        with torch.enable_grad():
            hh = h.detach().requires_grad_()
            gate, up = hh.chunk(2, dim=-1)
            out = F.silu(gate) * up
        (dh,) = torch.autograd.grad(out, hh, g)
        return dh


class Combine(torch.autograd.Function):
    """rows [T, k, D] (each token's k expert outputs), weights [T, k] fp32
    -> sum_k weights * rows in fp32, rounded to the rows' dtype."""

    @staticmethod
    def forward(ctx, rows, weights):
        ctx.save_for_backward(rows, weights)
        return (rows.float() * weights.unsqueeze(-1)).sum(dim=1).to(rows.dtype)

    @staticmethod
    def backward(ctx, g):
        rows, weights = ctx.saved_tensors
        gf = g.float().unsqueeze(1)
        d_rows = (gf * weights.unsqueeze(-1)).to(rows.dtype)
        d_weights = (gf * rows.float()).sum(dim=-1)
        return d_rows, d_weights


def expert_outputs(rows: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor,
                   ends: torch.Tensor) -> torch.Tensor:
    """Routed SwiGLU experts over rows sorted by expert: gate_up [E, 2I, D]
    (each expert's gate rows, then its up rows) and down [E, D, I], in the
    rows' dtype -> [M, D]."""
    h = GroupedMM.apply(rows, gate_up, ends)
    return GroupedMM.apply(SwiGLU.apply(h), down, ends)
