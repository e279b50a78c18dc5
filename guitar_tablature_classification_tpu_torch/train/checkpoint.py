"""Checkpoints on ``torch.save``: best-val policy and mid-run resume (the
JAX package's ``train/checkpoint.py``, which writes Orbax directories).

A checkpoint is two files in ``directory``:

- ``{name}.pt``: ``{"model_state_dict", "optimizer_state_dict", "step"}``.
  The model's state dict is the reference layout (its BatchNorm running
  averages included), so :func:`..models.convert.load_torch_checkpoint`
  and ``--model {name}.pt`` serve the file as they serve the reference's
  ``best_guitar_tab_model.pt``; the optimizer entry is
  :meth:`..train.engine.TrainState.adam_state` (``count``, ``mu``, ``nu``).
- ``{name}.meta.json``: the epoch, the step, the validation metrics and
  the model's configuration, as the JAX package writes it.

The port reads no Orbax directory (it imports nothing of Orbax): restoring
from one raises :class:`OrbaxCheckpointError`.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any

import numpy as np
import torch

from .engine import TrainState


class CheckpointMismatchError(RuntimeError):
    """Restoring a checkpoint into a model it was not trained with."""


class OrbaxCheckpointError(RuntimeError):
    """The checkpoint is an Orbax directory of the JAX package, which the
    port cannot read."""


# ModelConfig fields that determine the parameter tree / serving
# semantics.  Formulation knobs (w1_conv, stem_fusion, bn_fusion,
# attention_impl, remat) are exact-equivalent reformulations sharing one
# variable tree by design (DESIGN.md), so a checkpoint may legitimately
# be trained and served under different settings of those.
_IDENTITY_FIELDS = (
    "arch", "input_channels", "num_strings", "num_frets", "trunk_dim",
    "vit_hidden", "vit_layers", "vit_heads", "vit_patch",
    "vit_native_patch_w", "vit_conv_stem", "vit_mlp_ratio", "param_dtype",
    "deepseek",
)


def _to_host(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


class Checkpointer:
    """Best-val checkpoint manager over ``torch.save``."""

    def __init__(self, directory: str, name: str = "best_guitar_tab_model"):
        self.directory = os.path.abspath(directory)
        self.name = name
        os.makedirs(self.directory, exist_ok=True)

    @property
    def path(self) -> str:
        return os.path.join(self.directory, f"{self.name}.pt")

    @property
    def orbax_path(self) -> str:
        """Where the JAX package's Checkpointer of the same directory and
        name writes its Orbax directory."""
        return os.path.join(self.directory, self.name)

    @property
    def meta_path(self) -> str:
        return os.path.join(self.directory, f"{self.name}.meta.json")

    def save(
        self, state: TrainState, *, epoch: int, metrics: dict,
        model_meta: dict | None = None,
    ) -> None:
        tree = _to_host({
            "model_state_dict": state.model.state_dict(),
            "optimizer_state_dict": state.adam_state(),
            "step": int(state.step),
        })
        tmp = self.path + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, self.path)
        meta = {
            "epoch": epoch,
            "step": int(state.step),
            "metrics": {
                k: (np.asarray(v).tolist() if np.ndim(v) else float(v))
                for k, v in metrics.items()
            },
        }
        if model_meta is not None:
            # model identity (arch + shape-relevant knobs): a restore under
            # a different --arch/--recipe fails with a named mismatch
            # instead of a state-dict key traceback
            meta["model"] = model_meta
        with open(self.meta_path, "w") as f:
            json.dump(meta, f, indent=2)

    def exists(self) -> bool:
        """A checkpoint of this name is here: the port's file, or an Orbax
        directory (which :meth:`restore` refuses by name)."""
        return os.path.isfile(self.path) or os.path.isdir(self.orbax_path)

    def load_meta(self) -> dict:
        if os.path.exists(self.meta_path):
            with open(self.meta_path) as f:
                return json.load(f)
        return {}

    def _check_identity(self, meta: dict, expect_model: dict | None) -> None:
        saved_model = meta.get("model")
        if expect_model is None or saved_model is None:
            return
        diffs = {
            k: (saved_model[k], expect_model.get(k))
            for k in _IDENTITY_FIELDS
            if k in saved_model and k in expect_model
            and saved_model[k] != expect_model[k]
        }
        if diffs:
            detail = ", ".join(
                f"{k}: checkpoint={a!r} requested={b!r}"
                for k, (a, b) in sorted(diffs.items())
            )
            raise CheckpointMismatchError(
                f"checkpoint at {self.path} was trained with a different "
                f"model configuration ({detail}); pass the matching "
                f"--arch/--recipe"
            )

    def load(self, *, expect_model: dict | None = None) -> tuple[dict, dict]:
        """(the file's contents, meta), after the identity check against
        ``expect_model`` (the model-config dict the caller is about to
        serve or train): a differing field raises
        :class:`CheckpointMismatchError` naming it."""
        if not os.path.isfile(self.path) and os.path.isdir(self.orbax_path):
            raise OrbaxCheckpointError(
                f"{self.orbax_path} is an Orbax checkpoint directory (the JAX "
                "package's); the PyTorch port reads its own .pt checkpoints "
                "only. Export the weights with the JAX package's "
                "models.torch_export.save_torch_checkpoint and serve the .pt "
                "file, or retrain with the port."
            )
        meta = self.load_meta()
        self._check_identity(meta, expect_model)
        tree = torch.load(self.path, map_location="cpu", weights_only=True)
        return tree, meta

    def load_model(
        self, model: torch.nn.Module, *, expect_model: dict | None = None,
    ) -> tuple[dict, dict]:
        """Load the checkpoint's state dict into ``model``, strictly.
        Returns :meth:`load`'s (contents, meta).  A model whose state dict
        does not match the file's raises :class:`CheckpointMismatchError`."""
        tree, meta = self.load(expect_model=expect_model)
        with self._mismatch(meta):
            model.load_state_dict(tree["model_state_dict"], strict=True)
        return tree, meta

    def restore(
        self, state: TrainState, *, expect_model: dict | None = None,
    ) -> tuple[TrainState, dict]:
        """Load the checkpoint into ``state`` (from a fresh
        ``create_train_state`` of the same model), in place: parameters,
        running averages, Adam moments and step.  Returns (state, meta).
        A model whose state dict does not match the file's raises
        :class:`CheckpointMismatchError`."""
        tree, meta = self.load_model(state.model, expect_model=expect_model)
        with self._mismatch(meta):
            state.load_adam_state(tree["optimizer_state_dict"])
        state.step = int(tree["step"])
        return state, meta

    @contextlib.contextmanager
    def _mismatch(self, meta: dict):
        """A state dict or optimizer state that does not fit the model
        becomes a :class:`CheckpointMismatchError` naming the file."""
        try:
            yield
        except (RuntimeError, KeyError) as e:
            arch = (meta.get("model") or {}).get("arch")
            hint = (
                f" (checkpoint records arch={arch!r}; is the requested "
                f"--arch/--recipe the one it was trained with?)"
                if arch else
                " (likely an arch/config mismatch: the checkpoint has no "
                "model-identity metadata)"
            )
            raise CheckpointMismatchError(
                f"failed to restore {self.path}: its state dict does not "
                f"match the requested model{hint}"
            ) from e


def find_checkpoint(path: str) -> Checkpointer | None:
    """The checkpoint that ``path`` names, as the serving CLI's ``--model``
    takes it: ``dir/best_guitar_tab_model`` (as the JAX CLI takes its
    Orbax one) or that name's ``.pt`` file, with the meta file beside it.
    None where there is no such meta file (a bare ``.pt`` state dict, for
    example)."""
    directory, base = os.path.split(os.path.abspath(path.rstrip("/")))
    name = base.removesuffix(".pt")
    if not os.path.isfile(os.path.join(directory, f"{name}.meta.json")):
        return None
    return Checkpointer(directory, name)
