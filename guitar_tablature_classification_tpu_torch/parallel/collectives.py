"""The collectives a step runs under a mesh, and the context that names it.

A train or eval step under a :class:`.mesh.Mesh` runs its forward and
backward inside :func:`use_mesh`.  The training BatchNorms (``FlaxBatchNorm``,
the fused trunk BatchNorm and both fused stem tails) then sum their
per-channel statistics over the data group through :func:`data_sum`, in
both directions, so the statistics are those of the global batch, as the
JAX package's SPMD step computes them.  Outside :func:`use_mesh` every
helper here returns its input: a one-process step runs exactly as before.

The collectives are ``torch.distributed``'s own, called directly, so any
error of theirs (a refused tensor, a timeout, a lost peer) reaches the
caller on that rank.  The ``gloo`` backend, the one that runs several
ranks on one card where NCCL refuses, carries all three on CUDA tensors
(the ``data_parallel`` phase of ``chip_smoke.py`` checks it).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.distributed as dist

_active = None  # the Mesh of the running step, or None


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[None]:
    """Run the block as one rank's part of a step under ``mesh`` (None: as
    one process)."""
    global _active
    saved, _active = _active, mesh
    try:
        yield
    finally:
        _active = saved


def active_mesh():
    """The mesh of the running step, or None."""
    return _active


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place."""
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, size: int) -> list[torch.Tensor]:
    """The ``size`` ranks' ``t`` of ``group``, in group-rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return parts


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` of global rank ``src``, in place on every rank of ``group``."""
    dist.broadcast(t, src, group=group)
    return t


# ------------------------------------------------------- inside a step


def data_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the running step's data group (a new tensor), or
    ``t`` itself outside a mesh or with one data rank."""
    mesh = _active
    if mesh is None or mesh.dp == 1:
        return t
    return all_reduce_(t.clone(), mesh.data_group)


def data_sums(*ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Tensors of one shape, each summed over the running step's data group
    in one collective; the tensors themselves outside a mesh or with one
    data rank."""
    mesh = _active
    if mesh is None or mesh.dp == 1:
        return ts
    return tuple(all_reduce_(torch.stack(ts), mesh.data_group).unbind(0))


def data_count(n: int) -> int:
    """The global batch's count of a per-rank count ``n`` (the ranks hold
    equal shards)."""
    mesh = _active
    return n if mesh is None else n * mesh.dp


def row_slice(rows: int) -> tuple[int, int] | None:
    """(global rows, this rank's first row) for a local batch of ``rows``
    rows, or None outside a mesh or with one data rank."""
    mesh = _active
    if mesh is None or mesh.dp == 1:
        return None
    return rows * mesh.dp, rows * mesh.data_index


class _GatherStrings(torch.autograd.Function):
    """[B, k, ...] of this rank's strings -> [B, k * mp, ...] of all strings
    over the model group.  Every rank of the group computes the same loss
    from the gathered tensor, so the gradient of a rank's own strings is
    its slice of the gathered gradient, unreduced."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.index, ctx.k = index, x.shape[1]
        return torch.cat(all_gather(x, group, size), dim=1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.k
        return g[:, lo:lo + ctx.k], None, None, None


def gather_strings(x: torch.Tensor, strings: tuple[int, int] | None) -> torch.Tensor:
    """A string-sharded module's output ``x`` [B, k, ...] for its strings
    ``strings`` -> all strings' [B, num_strings, ...], differentiably; ``x``
    itself where the module holds every string (``strings`` None)."""
    if strings is None:
        return x
    mesh = _active
    if mesh is None:
        raise RuntimeError("a string-sharded model runs only inside use_mesh(mesh)")
    return _GatherStrings.apply(x, mesh.model_group, mesh.mp, mesh.model_index)
