"""The port's kernel launch counters, read as one flat dict (``cqt_fused``,
``cqt_fused_mma``, ``stem_stats``, ``stem_fwd``, ``stem_bwd``, ...,
``attn_fwd``, ``attn_bwd``)."""

from __future__ import annotations

# kernel names in the device trace that each wrapper's launch gives
KERNELS = {
    # each fused CQT launch (B1) enqueues its coefficients kernel, then the
    # dB epilogue; on the tensor cores the coefficients are cqt_mma_kernel's
    "cqt_fused": ("cqt_db_kernel",),
    "cqt_fused_mma": ("cqt_mma_kernel",),
    "stem_stats": ("stem_stats_kernel", "reduce_partials_kernel"),
    "stem_fwd": ("stem_fwd_kernel",),
    "stem_bwd": ("stem_bwd_kernel", "reduce_partials_kernel"),
    "attn_fwd": ("attn_fwd_mma_kernel",),
    "attn_bwd": ("attn_rowdot_mma_kernel", "attn_bwd_kv_mma_kernel", "attn_bwd_q_mma_kernel"),
}


def launches() -> dict[str, int]:
    from guitar_tablature_classification_tpu_torch.ops import attention_cuda, cqt_cuda, stem_cuda

    return {"cqt_fused": cqt_cuda.launches, "cqt_fused_mma": cqt_cuda.mma_launches,
            **stem_cuda.launches, **attention_cuda.launches}


def missing(trace, wrappers: tuple[str, ...]) -> dict[str, tuple[int, int]]:
    """{kernel: (records, launches)} where the trace holds fewer or more
    records of a wrapper's kernel than the counters say it launched in the
    stretch."""
    counts = trace.extra["counts"]
    want: dict[str, int] = {}
    for w in wrappers:
        for k in KERNELS[w]:
            want[k] = want.get(k, 0) + counts.get(w, 0)
    got = {k: trace.kernel_count(k) for k in want}
    return {k: (got[k], want[k]) for k in want if got[k] != want[k]}


def check_trace(trace, wrappers: tuple[str, ...]) -> None:
    """Raise unless the trace holds, for each wrapper in ``wrappers``, as
    many records of each of its kernels as the counters say it launched in
    the stretch: a share read from a trace that lost records would be
    wrong."""
    lost = missing(trace, wrappers)
    if lost:
        raise RuntimeError(f"the trace's kernel records do not match the launch counters "
                           f"of {wrappers}: {{kernel: (records, launches)}} {lost}")
