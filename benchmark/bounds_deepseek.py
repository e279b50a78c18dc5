"""Roofline bounds of the kernels that DeepSeek-V2's layers add: the MLA
attention kernels (B5 at query/key width 192, value width 128, causal) and
the grouped expert GEMMs.  Each counts the operations the algorithm needs
and each input byte read once and each output byte written once, at bf16
(:func:`.peaks.bound_s`: the larger of bytes over HBM bandwidth and
operations over the bf16 tensor-core peak)."""

from __future__ import annotations

from .peaks import bound_s


def mla_bound_s(kernel: str, batch: int, tokens: int, heads: int, dqk: int = 192, dv: int = 128,
                causal: bool = True, el: int = 2) -> float:
    """``attn_fwd_mla`` or ``attn_bwd_mla`` on q, k [batch, tokens, heads,
    dqk] and v [.., dv]; causal: N(N+1)/2 score pairs a head.  Forward:
    S = Q K^T and O = P V, dqk + dv multiply-adds a pair; reads q, k, v and
    writes o and the fp32 lse.  Backward, as one pass needs it: S again
    (dqk), dP = dO V^T (dv), dV = P^T dO (dv), dQ = dS K (dqk), dK = dS^T Q
    (dqk), 3 dqk + 2 dv a pair; reads q, k, v, o, dO and lse, writes dq,
    dk and dv."""
    pairs = batch * heads * (tokens * (tokens + 1) // 2 if causal else tokens * tokens)
    rows = batch * tokens * heads
    lse = 4 * batch * heads * tokens
    if kernel == "attn_fwd_mla":
        return bound_s(el * rows * (2 * dqk + 2 * dv) + lse, 2 * pairs * (dqk + dv), "bf16")
    return bound_s(el * rows * (4 * dqk + 4 * dv) + lse,
                   2 * pairs * (3 * dqk + 2 * dv), "bf16")


def expert_gemm_bound_s(tokens: int, k: int, experts: int, hidden: int, width: int,
                        backward: bool, el: int = 2) -> float:
    """One expert layer's grouped GEMMs for ``tokens`` tokens routed to
    ``k`` experts each (every row computed): gate and up ([rows, hidden] x
    [hidden, 2 width]) and down ([rows, width] x [width, hidden]),
    rows * k * 3 * hidden * width multiply-adds forward and twice that
    backward (the rows' and the weights' gradients).  Bytes: every expert's
    bf16 weights and the routed rows, each read or written once: forward
    reads the rows (hidden), writes gate|up (2 width), reads the SwiGLU
    output (width), writes the down output (hidden); backward reads and
    writes those again with the weights read and their gradients written."""
    rows = tokens * k
    macs = rows * 3 * hidden * width
    weights = experts * 3 * hidden * width * el
    fwd_bytes = weights + rows * el * (hidden + 2 * width + width + hidden)
    if not backward:
        return bound_s(fwd_bytes, 2 * macs, "bf16")
    bwd_bytes = 2 * weights + 2 * rows * el * (hidden + 2 * width + width + hidden)
    return bound_s(bwd_bytes, 4 * macs, "bf16")
