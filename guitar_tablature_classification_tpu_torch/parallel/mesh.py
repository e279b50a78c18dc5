"""The mesh over ranks and its sharding rules (the JAX package's
``parallel/mesh.py``).

The JAX package lays a named mesh over devices, ``data`` x ``model``, and
lets XLA insert the collectives.  Here the mesh is over ranks, one process
per device (PyTorch's idiom, with ``torch.distributed``): rank
``data_index * mp + model_index``, a data group per model index (the ranks
that hold the same strings and split the batch) and a model group per data
index (the ranks that hold the same rows and split the strings).  The
train step (:func:`..train.engine.make_train_step` with ``mesh=``) then
computes what the one-process step computes on the global batch:

- the batch is split over the data axis (:func:`shard_batch`);
- the per-string heads are split over the model axis when ``mp`` divides
  the string count (:func:`param_shardings`, :func:`shard_model`): each
  rank holds, and updates, only its strings' tensors and their Adam
  moments, and the logits are gathered over the model group;
- the training BatchNorms' statistics and the gradients are reduced over
  the groups (:mod:`.collectives`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..config import MeshConfig
from ..device import resolve_device
from .collectives import broadcast_


def maybe_initialize_distributed(backend: str | None = None) -> bool:
    """``torch.distributed.init_process_group`` from the environment, where a
    launcher such as ``torchrun`` set ``RANK``, ``WORLD_SIZE`` and
    ``MASTER_ADDR`` (and ``MASTER_PORT``); nothing otherwise, as the JAX
    package initialises only under a multi-host launcher.  ``backend``
    defaults to NCCL where the card is available, else gloo.  Returns
    whether a process group is initialised."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method="env://")
    return True


@dataclass
class Mesh:
    """One rank's view of the ``data`` x ``model`` mesh.  ``data_group`` and
    ``model_group`` are None where no process group is initialised (a mesh
    planned without processes)."""

    shape: dict[str, int]
    rank: int
    data_index: int
    model_index: int
    device: torch.device
    data_group: Any = None
    model_group: Any = None
    num_strings: int = 6

    @property
    def dp(self) -> int:
        return self.shape["data"]

    @property
    def mp(self) -> int:
        return self.shape["model"]

    @property
    def world_size(self) -> int:
        return self.dp * self.mp

    @property
    def strings(self) -> tuple[int, int] | None:
        """This rank's strings [lo, hi) where the heads are split over the
        model axis (``mp > 1`` dividing the string count), else None: every
        rank holds every string, as the JAX rule replicates them."""
        mp = self.mp
        if mp == 1 or self.num_strings % mp:
            return None
        k = self.num_strings // mp
        return self.model_index * k, (self.model_index + 1) * k


def make_mesh(
    cfg: MeshConfig | None = None, world_size: int | None = None, *,
    rank: int | None = None, device: str | torch.device | None = None,
    num_strings: int = 6,
) -> Mesh:
    """The mesh of ``cfg`` over ``world_size`` ranks (the process group's
    size when initialised, else 1), seen from ``rank`` (the process group's
    rank, else 0).  ``data_parallel=-1`` takes ``world // model_parallel``.
    Where the process group is initialised, every rank must call this, in
    the same order, since it creates the groups.  ``device``: the card
    (``cuda:LOCAL_RANK`` modulo the cards visible) unless the caller asks
    for the CPU."""
    cfg = cfg or MeshConfig()
    initialised = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if initialised else 1
    if rank is None:
        rank = dist.get_rank() if initialised else 0
    n = world_size
    mp = max(1, cfg.model_parallel)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n // mp
    if dp * mp != n:
        raise ValueError(
            f"mesh {dp}x{mp} does not cover {n} devices; set "
            f"MeshConfig.data_parallel/model_parallel to factor {n}"
        )
    grid = np.arange(n).reshape(dp, mp)  # rank = data_index * mp + model_index
    data_index, model_index = (int(i) for i in np.argwhere(grid == rank)[0])
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           % torch.cuda.device_count())
    data_group = model_group = None
    if initialised and n > 1:
        if dist.get_world_size() != n:
            raise ValueError(f"the process group has {dist.get_world_size()} ranks, not {n}")
        for m in range(mp):  # every rank creates every group, in one order
            g = dist.new_group(grid[:, m].tolist())
            if m == model_index:
                data_group = g
        for d in range(dp):
            g = dist.new_group(grid[d].tolist())
            if d == data_index:
                model_group = g
    return Mesh(
        shape={cfg.data_axis: dp, cfg.model_axis: mp}, rank=rank, data_index=data_index,
        model_index=model_index, device=dev, data_group=data_group,
        model_group=model_group, num_strings=num_strings,
    )


def contiguous_rows(batch_size: int, index: int, count: int, axis: str) -> slice:
    """Part ``index`` of a batch of ``batch_size`` rows cut into ``count``
    contiguous parts; ``axis`` names the cut in the error where ``count``
    does not divide the batch."""
    if batch_size % count:
        raise ValueError(f"batch {batch_size} not divisible by {axis}")
    per = batch_size // count
    return slice(index * per, (index + 1) * per)


def batch_sharding(mesh: Mesh, batch_size: int) -> slice:
    """The rows of a global batch of ``batch_size`` that this rank holds:
    a contiguous run by data index, the same on every rank of a model
    group."""
    return contiguous_rows(batch_size, mesh.data_index, mesh.dp, f"the data axis ({mesh.dp})")


def host_rows(mesh: Mesh, batch: Mapping[str, Any]) -> dict[str, Any]:
    """A global host batch cut to this rank's rows (:func:`batch_sharding`),
    still on the host."""
    return {key: value[batch_sharding(mesh, len(value))] for key, value in batch.items()}


def shard_batch(mesh: Mesh, batch: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A global host batch -> this rank's rows (:func:`host_rows`) on its
    device."""
    out = {}
    for key, value in host_rows(mesh, batch).items():
        t = torch.as_tensor(value)
        if mesh.device.type == "cuda" and t.device.type == "cpu":
            t = t.contiguous().pin_memory().to(mesh.device, non_blocking=True)
        else:
            t = t.to(mesh.device)
        out[key] = t
    return out


def replicated(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Every rank's ``module`` set to rank 0's parameters and buffers (the
    JAX package's replicated placement), in place; ``module`` itself."""
    if mesh.world_size > 1 and dist.is_initialized():
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                broadcast_(t.data, 0)
    return module


# ----------------------------------------------------------- string axis


def _string_members(model: nn.Module, num_strings: int) -> dict[str, int]:
    """Names of the tensors that belong to one string's branch of a
    per-string head list (``StringBranchHeads``, ``SimpleStringHeads``:
    the reference layout stores each string's row of the JAX package's
    stacked tensors as tensors of its own), with their string."""
    from ..models.heads import SimpleStringHeads, StringBranchHeads

    out = {}
    for prefix, module in model.named_modules():
        if isinstance(module, (StringBranchHeads, SimpleStringHeads)):
            if len(module) != num_strings:
                raise ValueError(f"{prefix}: {len(module)} branches, not {num_strings}")
            for s, branch in enumerate(module):
                for name, _ in [*branch.named_parameters(), *branch.named_buffers()]:
                    out[f"{prefix}.{s}.{name}"] = s
    return out


def _is_string_stacked(t: torch.Tensor, num_strings: int) -> bool:
    """The JAX package's shape rule: a leading dim of the string count and
    ndim >= 2 (``StackedDense``'s kernel [6, in, out] and bias [6, out])."""
    return t.ndim >= 2 and t.shape[0] == num_strings


def param_shardings(mesh: Mesh, model: nn.Module) -> dict[str, torch.Tensor | None]:
    """This rank's part of each string-stacked tensor of ``model``, by name:
    rows [lo, hi) of a tensor under the shape rule, and, for a tensor of one
    string's branch, the tensor where this rank holds the string, else
    None.  Empty where the heads are not split (``mesh.strings`` None)."""
    strings = mesh.strings
    if strings is None:
        return {}
    lo, hi = strings
    tensors = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    out: dict[str, torch.Tensor | None] = {
        name: tensors[name] if lo <= s < hi else None
        for name, s in _string_members(model, mesh.num_strings).items()
    }
    for name, p in model.named_parameters():
        if name not in out and _is_string_stacked(p, mesh.num_strings):
            out[name] = p.detach()[lo:hi]
    return out


def string_param_names(model: nn.Module) -> set[str]:
    """The parameters of ``model`` that belong to this rank's strings only
    (after :func:`shard_model`): empty for a model whose heads hold every
    string."""
    from ..models.heads import SimpleStringHeads, StackedDense, StringBranchHeads

    names = set()
    for prefix, module in model.named_modules():
        if isinstance(module, (StackedDense, StringBranchHeads, SimpleStringHeads)) \
                and module.strings is not None:
            names.update(f"{prefix}.{n}" if prefix else n for n, _ in module.named_parameters())
    return names


def shard_model(mesh: Mesh, model: nn.Module) -> nn.Module:
    """``model`` (on every rank the same, see :func:`replicated`) cut to this
    rank's strings in place, by :func:`param_shardings`: each
    ``StackedDense`` keeps its rows [lo, hi), each per-string head list
    keeps its strings' branches (the others become ``StringElsewhere``
    placeholders, which draw the dropout masks those branches would have
    drawn), and the modules that return per-string outputs gather them
    over the model group.  Nothing changes where ``mesh.strings`` is None.
    State-dict names stay the global ones."""
    from ..models.heads import Dropout, SimpleStringHeads, StackedDense, StringBranchHeads
    from ..models.heads import StringElsewhere

    strings = mesh.strings
    if strings is None:
        return model
    lo, hi = strings
    parts = param_shardings(mesh, model)
    stacked = {n for n, t in parts.items() if t is not None and n not in
               _string_members(model, mesh.num_strings)}
    for prefix, module in list(model.named_modules()):
        if isinstance(module, (StringBranchHeads, SimpleStringHeads)):
            for s in range(mesh.num_strings):
                if not lo <= s < hi:
                    module[s] = StringElsewhere.of(module[s])
            module.strings = strings
        elif isinstance(module, StackedDense):
            for leaf in ("weight", "bias"):
                name = f"{prefix}.{leaf}" if prefix else leaf
                if name not in stacked:
                    raise ValueError(f"{name}: not split over the strings")
                setattr(module, leaf, nn.Parameter(parts[name].clone()))
            module.strings = strings
    for name, p in model.named_parameters():
        if name in stacked and p.shape[0] != hi - lo:
            raise ValueError(f"{name}: a string-stacked tensor outside a StackedDense")
    for module in model.modules():
        if isinstance(module, Dropout) and module.string_dim:
            module.strings, module.num_strings = strings, mesh.num_strings
    return model
