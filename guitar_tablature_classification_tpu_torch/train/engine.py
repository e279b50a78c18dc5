"""Training engine of the port: the JAX package's ``train/engine.py``
(``make_optimizer``, ``make_preprocess``, ``TrainState``,
``create_train_state``, ``make_train_step``, ``make_eval_step``,
``validate_model``, ``test_model``, ``train_model``).

The JAX step is one jitted pure function; here the step runs eagerly and
updates the state in place (the parameters, moments and running averages
live in flat fp32 buffers, so on the card the whole optimizer update is one
kernel over all of them).  Nothing in a step reads a device value on the
host: the non-finite-loss skip is a device-side select, and the metrics
come back as device tensors.  The loops above the steps read the device
once an epoch (the summed train loss) and once a validation pass.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig, OptimConfig, TrainConfig
from ..device import resolve_device
from ..ops import adam_cuda
from ..ops.loss import label_smoothing_loss, per_string_accuracy
from ..ops.normalize import db_to_unit, imagenet_normalize, tile_channels
from ..ops.resize import resize_bicubic
from ..parallel.collectives import (
    active_mesh,
    all_reduce_,
    data_count,
    data_sum,
    row_slice,
    use_mesh,
)
from ..utils import profiling

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.scale_by_adam defaults
UPDATE_CHUNK = 1 << 26  # elements a pass of Optimizer.apply_plain (256 MB of fp32)


def make_preprocess(
    model_cfg: ModelConfig, image_size: int = 224, input_kind: str = "db_features"
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Raw batch features -> channels-last model input (``engine.py:87-152``
    of the JAX package).

    ``db_features``: [B, n_bins, n_frames] dB features.  dB -> [0, 1]; the
    native archs take that as is ([B, 96, T, 1]), and so does ``resnet18``
    with ``stem_fusion="fused"`` at 224^2: its fused stem folds resize, tile
    and normalize into conv1's GEMM (``engine.py:132-140`` of the JAX
    package).  Other ``resnet18`` configurations get a bicubic resize to
    ``image_size``^2, a 3-channel tile and the ImageNet normalization;
    ``stem_fusion="on"`` takes those images too (the JAX package folds them
    into GEMMs that compute the same function).

    ``rgb_image``: [B, H, W, 3] uint8 spectrogram renders (the reference
    CNN's cqt_images/*.png path) -> [0, 1], a bicubic resize to
    ``image_size``^2 for every arch but ``small_cnn`` (which takes its
    native resolution), and the ImageNet normalization for ``resnet18``.
    The native archs consume the raw 1-channel dB map, which a colour map
    cannot give back, so they refuse this kind.
    """
    arch = model_cfg.arch
    if input_kind == "rgb_image" and arch in ("resnet18_native", "vit_native"):
        raise ValueError(
            f"arch {arch!r} consumes raw 1-channel CQT features; the "
            "PNG image path is only supported by the 224^2 archs "
            "(resnet18, vit_s8) and small_cnn"
        )
    fused = arch == "resnet18" and image_size == 224 and model_cfg.stem_fusion == "fused"

    def rgb(feats: torch.Tensor) -> torch.Tensor:
        x = feats.to(torch.float32) / 255.0
        if arch != "small_cnn" and tuple(x.shape[1:3]) != (image_size, image_size):
            x = resize_bicubic(x, (image_size, image_size), channels_last=True)
        if arch == "resnet18":
            x = imagenet_normalize(x)
        return x

    def preprocess(feats: torch.Tensor) -> torch.Tensor:
        x = db_to_unit(feats)
        if fused or arch in ("small_cnn", "resnet18_native", "vit_native"):
            return x[..., None]  # raw [B, 96, T, 1], no resize needed
        x = resize_bicubic(x, (image_size, image_size))
        x = tile_channels(x, model_cfg.input_channels)
        if arch == "resnet18":
            x = imagenet_normalize(x)
        return x

    return rgb if input_kind == "rgb_image" else preprocess


def input_kind_of(features: Any) -> str:
    """``rgb_image`` for rank-4 features (PNG renders), else
    ``db_features`` (``train/run.py:258-262`` of the JAX package)."""
    return "rgb_image" if np.ndim(features) == 4 else "db_features"


def model_input_shape(batch: Mapping[str, Any]) -> tuple[int, int, int] | None:
    """The (H, W, C) of a PNG batch's renders, which ``small_cnn`` takes at
    their own resolution (:func:`..models.tabnet.build_model`'s
    ``input_shape``); None for dB features and audio."""
    feats = batch.get("features")
    return tuple(feats.shape[1:]) if feats is not None and np.ndim(feats) == 4 else None


# ---------------------------------------------------------------- optimizer


@dataclass
class AdamState:
    """optax ``ScaleByAdamState`` over flat fp32 buffers: ``count`` (int32
    scalar on the device) and the first and second moments."""

    count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor


class Optimizer:
    """The JAX package's optax chains over one flat parameter vector
    (``engine.py:55-84``):

    - ``adam``:  clip by global norm -> add ``weight_decay * p`` to the
      gradient -> Adam -> ``-lr`` (torch ``Adam(weight_decay)``);
    - ``adamw``: clip -> Adam -> add ``weight_decay * p`` -> ``-lr``;

    then, when ``backbone_lr_scale != 1``, the backbone's updates (names
    under ``resnet.`` or ``vit.``) are scaled by it.  The clip divides by
    the norm itself: unlike ``torch.nn.utils.clip_grad_norm_`` it adds no
    1e-6.  Adam uses eps 1e-8, no eps inside the root, and bias correction
    from count 1."""

    def __init__(self, cfg: OptimConfig, names: Sequence[str], sizes: Sequence[int]):
        if cfg.name not in ("adam", "adamw"):
            raise ValueError(f"unknown optimizer {cfg.name!r}")
        self.cfg = cfg
        self.backbone = None
        if cfg.backbone_lr_scale != 1.0:
            self.backbone = torch.cat([
                torch.full((n,), name.split(".")[0] in ("resnet", "vit"))
                for name, n in zip(names, sizes)
            ])

    def init(self, params: torch.Tensor) -> AdamState:
        if self.backbone is not None:
            self.backbone = self.backbone.to(params.device)
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=params.device),
            mu=torch.zeros_like(params), nu=torch.zeros_like(params),
        )

    def _update(self, grads, mu, nu, params, t, g_norm, lr, backbone):
        """(new params, mu, nu) of one span of the flat buffers: every
        operation is elementwise but the global norm ``g_norm``."""
        cfg = self.cfg
        u = grads
        if cfg.grad_clip_norm:
            max_norm = cfg.grad_clip_norm
            u = torch.where(g_norm < max_norm, u, (u / g_norm) * max_norm)
        if cfg.name == "adam" and cfg.weight_decay:
            u = u + cfg.weight_decay * params
        mu = (1 - ADAM_B1) * u + ADAM_B1 * mu
        nu = (1 - ADAM_B2) * (u * u) + ADAM_B2 * nu
        mu_hat = mu / (1 - ADAM_B1**t)
        nu_hat = nu / (1 - ADAM_B2**t)
        u = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)
        if cfg.name == "adamw" and cfg.weight_decay:
            u = u + cfg.weight_decay * params
        u = (-1.0 * lr) * u
        if backbone is not None:
            u = torch.where(backbone, cfg.backbone_lr_scale * u, u)
        return params + u, mu, nu

    def apply(
        self, grads: torch.Tensor, state: AdamState, params: torch.Tensor, lr: float,
        g_norm: torch.Tensor | None = None, ok: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """One update of ``params`` and ``state`` in place.  ``g_norm``: the
        raw gradients' global norm where ``grads`` hold only part of the
        parameters (a rank's strings under a mesh); computed from ``grads``
        when None.  Where ``ok`` (a 0-dim bool tensor) is False, params and
        state keep their values.  Returns the global norm.

        On the card one launch of the fused update kernel
        (:func:`..ops.adam_cuda.update`) does the whole buffer, with the
        bits of :meth:`apply_plain`, which buffers on the CPU take."""
        if params.device.type != "cuda":
            return self.apply_plain(grads, state, params, lr, g_norm, ok)
        cfg = self.cfg
        if g_norm is None:
            g_norm = torch.linalg.vector_norm(grads)
        count = state.count + 1
        t = count.float()
        adam_cuda.update(
            grads, params, state.mu, state.nu, lr=lr, betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS,
            bias1=1 - ADAM_B1**t, bias2=1 - ADAM_B2**t, decay=cfg.name,
            weight_decay=cfg.weight_decay, g_norm=g_norm if cfg.grad_clip_norm else None,
            max_norm=cfg.grad_clip_norm or 0.0, backbone=self.backbone,
            backbone_scale=cfg.backbone_lr_scale, ok=ok,
        )
        state.count.copy_(count if ok is None else torch.where(ok, count, state.count))
        return g_norm

    def apply_plain(
        self, grads: torch.Tensor, state: AdamState, params: torch.Tensor, lr: float,
        g_norm: torch.Tensor | None = None, ok: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """:meth:`apply` as a chain of PyTorch elementwise operations on any
        device, ``UPDATE_CHUNK`` elements at a time, so that no temporary is
        larger than a chunk (a model of billions of parameters has no room
        for whole-buffer temporaries beside its parameters, moments and
        gradients); every operation is elementwise but the global norm, so
        the chunks change no bit."""
        if g_norm is None:
            g_norm = torch.linalg.vector_norm(grads)
        count = state.count + 1
        t = count.float()
        for lo in range(0, params.numel(), UPDATE_CHUNK):
            part = slice(lo, lo + UPDATE_CHUNK)
            backbone = None if self.backbone is None else self.backbone[part]
            olds = (params[part], state.mu[part], state.nu[part])
            news = self._update(grads[part], olds[1], olds[2], olds[0], t, g_norm, lr, backbone)
            for old, new in zip(olds, news):
                old.copy_(new if ok is None else torch.where(ok, new, old))
        state.count.copy_(count if ok is None else torch.where(ok, count, state.count))
        return g_norm

    def update(
        self, grads: torch.Tensor, state: AdamState, params: torch.Tensor, lr: float,
        g_norm: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, AdamState, torch.Tensor]:
        """(new params, new state, global norm of the raw gradients), with
        ``params`` and ``state`` left as they were: ``apply`` on copies."""
        params = params.clone()
        state = AdamState(state.count.clone(), state.mu.clone(), state.nu.clone())
        return params, state, self.apply(grads, state, params, lr, g_norm)


def make_optimizer(
    cfg: OptimConfig, names: Sequence[str], sizes: Sequence[int]
) -> Optimizer:
    """The optimizer of ``cfg`` for parameters with these names and sizes
    (in flat-buffer order)."""
    return Optimizer(cfg, names, sizes)


# -------------------------------------------------------------------- state


def _flatten(tensors: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Move ``tensors`` into one flat fp32 buffer on ``device``: each
    becomes a view of its slice, so an in-place update of the buffer
    updates them all.  No tensors (a model without BatchNorm) give an
    empty buffer."""
    flat = torch.cat([torch.zeros(0, device=device)]
                     + [t.detach().reshape(-1).float() for t in tensors])
    offset = 0
    for t in tensors:
        n = t.numel()
        t.data = flat[offset:offset + n].view(t.shape)
        offset += n
    return flat


def _running_stats(model: nn.Module) -> list[torch.Tensor]:
    return [
        buf for m in model.modules()
        if isinstance(m, nn.modules.batchnorm._BatchNorm)
        for buf in (m.running_mean, m.running_var)
    ]


@dataclass
class TrainState:
    """What the JAX package's ``TrainState`` holds, for a model whose
    parameters and running averages this state owns.

    ``params`` and ``buffers`` are flat fp32 buffers that the model's
    parameters and BatchNorm running averages are views of (so the model
    must not be moved to another device afterwards); ``opt_state`` holds
    the Adam moments over ``params``; ``step`` counts train steps, skipped
    ones included.  Under a mesh (``mesh``) the model holds this rank's
    strings only, and ``string_mask`` marks their elements of ``params``
    (None where the heads are not split)."""

    model: nn.Module
    tx: Optimizer
    names: list[str]
    params: torch.Tensor
    buffers: torch.Tensor
    opt_state: AdamState
    step: int = 0
    param_list: list[torch.Tensor] = field(default_factory=list)
    mesh: Any = None
    string_mask: torch.Tensor | None = None  # params of this rank's strings only

    def _split(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        out, offset = {}, 0
        for name, p in zip(self.names, self.param_list):
            out[name] = flat[offset:offset + p.numel()].view(p.shape)
            offset += p.numel()
        return out

    def adam_state(self) -> dict[str, Any]:
        """``{"count": int, "mu": {name: tensor}, "nu": {...}}`` (views)."""
        s = self.opt_state
        return {"count": int(s.count), "mu": self._split(s.mu), "nu": self._split(s.nu)}

    def load_adam_state(self, state: Mapping[str, Any]) -> None:
        """Set the moments from :meth:`adam_state`'s form (for example
        :func:`..models.convert.adam_state_from_optax`)."""
        self.opt_state.count.fill_(int(state["count"]))
        for kind in ("mu", "nu"):
            views = self._split(getattr(self.opt_state, kind))
            for name, view in views.items():
                view.copy_(state[kind][name].reshape(view.shape))


def create_train_state(
    model: nn.Module, optim_cfg: OptimConfig, device: str | torch.device | None = None,
    *, mesh=None,
) -> TrainState:
    """Move ``model`` to ``device`` (the card unless the caller asks for
    the CPU), gather its parameters and running averages into flat
    buffers, and set up the optimizer with zero moments.

    Under ``mesh`` (:func:`..parallel.make_mesh`) the model goes to the
    mesh's device, every rank takes rank 0's weights
    (:func:`..parallel.replicated`), and the heads are cut to this rank's
    strings (:func:`..parallel.shard_model`) before the buffers are made."""
    if mesh is not None:
        from ..parallel import replicated, shard_model, string_param_names

        device = mesh.device
        shard_model(mesh, replicated(mesh, model.to(device)))
    dev = resolve_device(device)
    model.to(dev)
    named = list(model.named_parameters())
    names = [n for n, _ in named]
    param_list = [p for _, p in named]
    if any(p.dtype != torch.float32 for p in param_list):
        raise ValueError("the train state holds fp32 parameters only")
    params = _flatten(param_list, dev)
    buffers = _flatten(_running_stats(model), dev)
    tx = make_optimizer(optim_cfg, names, [p.numel() for p in param_list])
    string_mask = None
    if mesh is not None and mesh.strings is not None:
        mine = string_param_names(model)
        string_mask = torch.cat([torch.zeros(0, dtype=torch.bool, device=dev)] + [
            torch.full((p.numel(),), n in mine, device=dev) for n, p in named])
    return TrainState(
        model=model, tx=tx, names=names, params=params, buffers=buffers,
        opt_state=tx.init(params), param_list=param_list, mesh=mesh,
        string_mask=string_mask,
    )


# -------------------------------------------------------------------- steps


def _features(batch, frontend, preprocess, augment=None, generator=None):
    feats = frontend(batch["audio"]) if "audio" in batch else batch["features"]
    if augment is not None:
        rows = row_slice(feats.shape[0])
        if rows is None:
            feats = augment(generator, feats)
        else:  # under a mesh: this rank's rows of the global batch's draws
            n, (total, first) = feats.shape[0], rows
            full = feats.new_zeros((total,) + feats.shape[1:])
            full[first:first + n] = feats
            feats = augment(generator, full)[first:first + n]
    return preprocess(feats) if preprocess is not None else feats


def _loss_part(logits, labels, smoothing, weights):
    """This rank's part of the global batch's loss (the one-process loss
    itself outside a mesh): its weighted sum over the global weight total
    (``label_smoothing_loss``'s denominator)."""
    loss = label_smoothing_loss(logits, labels, smoothing, weights=weights)
    if row_slice(labels.shape[0]) is None:
        return loss
    if weights is None:
        return loss / active_mesh().dp
    w = weights.float().sum()
    return loss * torch.clamp(w, min=1.0) / torch.clamp(data_sum(w), min=1.0)


def _reduce_grads(flat: torch.Tensor, state: TrainState) -> tuple[torch.Tensor, torch.Tensor]:
    """A rank's gradients -> the global batch's, and their global norm:
    the replicated parameters' summed over the model group where the heads
    are split (each rank's strings gave their part), then everything summed
    over the data group; the norm counts each string once."""
    mesh, mask = state.mesh, state.string_mask
    if mask is not None:
        shared = flat[~mask]
        flat[~mask] = all_reduce_(shared, mesh.model_group)
    if mesh.dp > 1:
        all_reduce_(flat, mesh.data_group)
    if mask is None:
        return flat, torch.linalg.vector_norm(flat)
    own = all_reduce_(flat[mask].square().sum(), mesh.model_group)
    return flat, torch.sqrt(flat[~mask].square().sum() + own)


def _accuracy(logits, labels):
    """``per_string_accuracy`` over the global batch."""
    if row_slice(labels.shape[0]) is None:
        return per_string_accuracy(logits, labels)
    correct = data_sum((logits.argmax(dim=-1) == labels).float().sum(dim=0))
    rows = data_count(labels.shape[0])
    return correct / rows, correct.sum() / (rows * labels.shape[1])


def _state_mesh(state: TrainState, mesh):
    """The state's mesh, which a step's own ``mesh`` (None: any) must be:
    the state's buffers, string mask and heads were cut on it."""
    if mesh is not None and mesh is not state.mesh:
        raise ValueError("the step's mesh is not the state's; make the state with "
                         "create_train_state(..., mesh=mesh)")
    return state.mesh


def make_train_step(
    model: nn.Module,
    preprocess: Callable | None = None,
    *,
    smoothing: float = 0.05,
    skip_nonfinite: bool = True,
    frontend: Callable | None = None,
    augment: Callable | None = None,
    mesh=None,
):
    """The train step ``train_step(state, batch, generator, lr) -> metrics``.

    ``batch``: either ``audio`` [B, W] raw windows (through ``frontend``,
    the CQT) or ``features`` [B, F, T] dB, plus ``labels`` [B, 6] int frets
    and optional ``weights`` [B, 6].  ``generator`` draws the dropout masks
    and, with ``augment`` (``augment(generator, feats) -> feats``, for
    example :func:`..ops.augment.augment_batch`), the augmentation of the
    [B, F, T] features before ``preprocess`` (``engine.py:157,171-172`` of
    the JAX package); ``lr`` is this step's learning rate.  Forward and
    backward in train mode, the label-smoothed loss, one optimizer update,
    in place.  With ``skip_nonfinite``, a non-finite loss leaves the
    parameters, moments and running averages as they were
    (``engine.py:208-215``); ``step`` advances either way.  Metrics (device tensors): ``loss``,
    ``accuracy``, ``per_string_accuracy`` and ``grad_norm`` (of the raw
    gradients).

    Under the state's mesh (a state made with ``create_train_state(...,
    mesh=mesh)``, and this rank's rows of the batch,
    :func:`..parallel.shard_batch`; a ``mesh`` given here must be that
    mesh, else the step raises ``ValueError``) the step computes the one-process step's function on the global batch, as
    the JAX package's SPMD step does: the training BatchNorms' statistics
    are the global batch's (:mod:`..parallel.collectives`), the dropout
    masks and augmentation are this rank's rows of the global batch's
    draws, the loss is this rank's part of the global one, and the
    gradients are summed over the groups before the clip and Adam, whose
    global norm counts each string once.  The metrics are the global
    batch's on every rank."""

    step_mesh = mesh

    def train_step(state: TrainState, batch, generator: torch.Generator, lr: float):
        with profiling.span("train.step", request=state.step):
            return _step(state, batch, generator, lr)

    def _step(state: TrainState, batch, generator: torch.Generator, lr: float):
        model.train()
        mesh = _state_mesh(state, step_mesh)
        with use_mesh(mesh):
            with torch.no_grad(), profiling.span("train.features"):
                images = _features(batch, frontend, preprocess, augment, generator)
            labels = batch["labels"]
            saved = state.buffers.clone() if skip_nonfinite else None
            with profiling.span("train.forward"):
                logits = model(images, generator)
                loss = _loss_part(logits, labels, smoothing, batch.get("weights"))
            with profiling.span("train.backward"):
                grads = torch.autograd.grad(loss, state.param_list)
        with torch.no_grad(), use_mesh(mesh), profiling.span("train.update"):
            flat = torch.cat([g.reshape(-1) for g in grads])
            del grads
            g_norm = None
            if mesh is not None:
                flat, g_norm = _reduce_grads(flat, state)
                loss = data_sum(loss.detach())
            ok = None
            if skip_nonfinite:
                ok = torch.isfinite(loss)
                state.buffers.copy_(torch.where(ok, state.buffers, saved))
            grad_norm = state.tx.apply(flat, state.opt_state, state.params, lr, g_norm, ok)
            per_string, overall = _accuracy(logits, labels)
        state.step += 1
        return {
            "loss": loss.detach(), "accuracy": overall,
            "per_string_accuracy": per_string, "grad_norm": grad_norm,
        }

    return train_step


def make_eval_step(
    model: nn.Module,
    preprocess: Callable | None = None,
    *,
    smoothing: float = 0.05,
    frontend: Callable | None = None,
    mesh=None,
):
    """``eval_step(state, batch) -> metrics``: the eval-mode forward, with
    ``weights`` [B, 6] masking padded rows out of the loss and accuracies
    (``engine.py:228-255``).  Metrics: ``loss``, ``accuracy``,
    ``per_string_accuracy``, ``correct`` and ``count`` per string.  Under
    the state's mesh (a ``mesh`` given here must be it) the batch is this
    rank's rows and the metrics are the global batch's."""

    step_mesh = mesh

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        model.eval()
        mesh = _state_mesh(state, step_mesh)
        with use_mesh(mesh):
            logits = model(_features(batch, frontend, preprocess))
            labels = batch["labels"]
            weights = batch.get("weights")
            if weights is None:
                weights = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
            weights = weights.float()
            loss = _loss_part(logits, labels, smoothing, weights)
            if mesh is not None:
                loss = data_sum(loss)
            correct = data_sum((logits.argmax(dim=-1) == labels).float() * weights)
            count = data_sum(weights.sum(dim=0))
            weights = data_sum(weights)
        return {
            "loss": loss,
            "accuracy": correct.sum() / torch.clamp(weights.sum(), min=1.0),
            "per_string_accuracy": correct.sum(dim=0) / torch.clamp(count, min=1.0),
            "correct": correct.sum(dim=0),
            "count": count,
        }

    return eval_step


# -------------------------------------------------------------------- loops


def batch_to_device(batch: Mapping[str, Any], device: torch.device) -> dict[str, torch.Tensor]:
    """A loader's batch of NumPy arrays on ``device``: to the card through
    pinned memory with ``non_blocking`` copies, so the host goes on
    enqueueing while the copy runs."""
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(value)
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[key] = t
    return out


def _to_device(state: TrainState, batch: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A loader's global batch on the state's device: this rank's rows of it
    under the state's mesh."""
    if state.mesh is not None:
        from ..parallel import shard_batch

        return shard_batch(state.mesh, batch)
    return batch_to_device(batch, state.params.device)


def validate_model(state: TrainState, eval_step, loader: Iterable) -> dict[str, Any]:
    """Aggregate eval metrics over a loader (``engine.py:275-298`` of the
    JAX package): per-string accuracy is the exact correct/total ratio,
    and the loss the exact weighted mean over all (sample, string) cells
    (each batch's weighted-mean loss re-scaled by its weight total, so a
    padded or short last batch counts in proportion).  The sums stay on
    the device in float64 and are read once.  Under the state's mesh each
    rank evaluates its rows of every batch."""
    dev = state.params.device
    loss_sum = torch.zeros((), dtype=torch.float64, device=dev)
    correct = count = None
    for batch in loader:
        m = eval_step(state, _to_device(state, batch))
        c = m["count"].double()
        # eval_step's loss = weighted_sum / weight_total and c.sum() =
        # weight_total, so this recovers the weighted sum
        loss_sum += m["loss"].double() * c.sum()
        correct = m["correct"].double() if correct is None else correct + m["correct"]
        count = c if count is None else count + c
    if count is None:
        raise ValueError("validate_model: the loader yielded no batch")
    correct, count = correct.cpu().numpy(), count.cpu().numpy()
    total = max(count.sum(), 1.0)
    return {
        "loss": float(loss_sum) / total,
        "per_string_accuracy": correct / np.maximum(count, 1.0),
        "accuracy": float(correct.sum() / total),
    }


def test_model(state: TrainState, eval_step, loader: Iterable) -> dict[str, Any]:
    """Per-string + overall test accuracy (bestengine.py:331-380)."""
    return validate_model(state, eval_step, loader)


def _snapshot(state: TrainState, into: dict | None = None) -> dict:
    """A copy of what the train step changes in place (parameters, running
    averages, Adam moments) and ``step``; ``into`` is refilled, not
    reallocated."""
    live = {"params": state.params, "buffers": state.buffers,
            "count": state.opt_state.count, "mu": state.opt_state.mu,
            "nu": state.opt_state.nu}
    if into is None:
        into = {k: v.clone() for k, v in live.items()}
    else:
        for k, v in live.items():
            into[k].copy_(v)
    into["step"] = state.step
    return into


def _load_snapshot(state: TrainState, snap: dict) -> None:
    with torch.no_grad():
        state.params.copy_(snap["params"])
        state.buffers.copy_(snap["buffers"])
        state.opt_state.count.copy_(snap["count"])
        state.opt_state.mu.copy_(snap["mu"])
        state.opt_state.nu.copy_(snap["nu"])
    state.step = snap["step"]


def train_model(
    train_loader: Iterable,
    val_loader: Iterable,
    config: TrainConfig | None = None,
    *,
    model: nn.Module | None = None,
    state: TrainState | None = None,
    frontend: Callable | None = None,
    checkpointer=None,
    resume: bool = False,
    log: Callable[[str], None] = print,
    on_epoch_end: Callable[[int, dict, TrainState], None] | None = None,
    device: str | torch.device | None = None,
    mesh=None,
) -> tuple[TrainState, dict]:
    """Reference-compatible training loop (bestengine.py:870-1016; JAX
    ``engine.py:305-444``): epoch loop, validation, LR schedule on the val
    loss, best-val checkpoint, early stopping.  ``resume=True`` restarts
    from the checkpointer's last saved state and epoch.  Returns
    (best_state, history).

    The model is ``state.model``, else ``model``, else built from
    ``config.model`` with a generator seeded by ``config.optim.seed``; a
    new state lives on ``device`` (the card unless the caller asks for
    the CPU).  Each step's generator (dropout, augmentation) is seeded
    from (seed, step) (:func:`..utils.prng.step_generator`), so a resumed
    run draws what an uninterrupted one would have.  The train step
    changes the state in place, so the best epoch's parameters, running
    averages, moments and step are copied aside when the val loss
    improves, and loaded back into the returned state at the end.

    Under ``mesh`` (:func:`..parallel.make_mesh`; every rank runs this with
    the same loaders) a new state is made on the mesh
    (``create_train_state(..., mesh=mesh)``), each rank trains and
    evaluates on its rows of every batch, and rank 0 alone writes the
    checkpoints.  The rows go to the card as a one-process run's batches
    do (:func:`_to_device`), without prefetch, so that both loops move
    their data alike; a loop of the caller's own prefetches them with
    ``as_device_batches(loader, mesh=mesh)``.  A state split over the strings holds only its rank's
    heads, so it takes no checkpointer."""
    from ..models.tabnet import build_model
    from ..utils.prng import step_generator
    from .schedules import make_scheduler

    config = config or TrainConfig()
    ocfg = config.optim
    init_batch = next(iter(train_loader))  # as the JAX loop: a shuffled loader's epoch advances
    input_kind = input_kind_of(init_batch["features"]) if "features" in init_batch \
        else "db_features"
    if state is None:
        if model is None:
            model = build_model(
                config.model, generator=torch.Generator().manual_seed(ocfg.seed),
                input_shape=model_input_shape(init_batch),
            )
        state = create_train_state(model, ocfg, device, mesh=mesh)
    elif mesh is not None and state.mesh is not mesh:
        raise ValueError("train_model(mesh=...): pass no state, or one made on that mesh")
    mesh = state.mesh
    if mesh is not None and mesh.strings is not None and checkpointer is not None:
        raise ValueError("a state split over the strings holds only this rank's heads; "
                         "train it without a checkpointer")
    checkpointer_save = checkpointer if mesh is None or mesh.rank == 0 else None
    model = state.model
    dev = state.params.device
    preprocess = make_preprocess(config.model, config.data.image_size, input_kind)

    start_epoch = 0
    resumed_best = None
    model_meta = dataclasses.asdict(config.model)
    if resume and checkpointer is not None and checkpointer.exists():
        state, meta = checkpointer.restore(state, expect_model=model_meta)
        start_epoch = int(meta.get("epoch", -1)) + 1
        resumed_best = meta.get("metrics", {}).get("loss")
        log(f"resumed from epoch {start_epoch} (step {int(state.step)})")

    augment = None
    if ocfg.augment:
        from functools import partial

        from ..ops.augment import augment_batch

        augment = partial(augment_batch, augment_prob=ocfg.augment_prob)
    train_step = make_train_step(
        model, preprocess, smoothing=ocfg.label_smoothing, frontend=frontend,
        augment=augment,
    )
    eval_step = make_eval_step(
        model, preprocess, smoothing=ocfg.label_smoothing, frontend=frontend
    )
    scheduler = make_scheduler(ocfg)
    generator = torch.Generator(device=dev)

    lr = ocfg.learning_rate
    best_val = float(resumed_best) if resumed_best is not None else float("inf")
    best = _snapshot(state)
    patience = 0
    history: dict[str, list] = {
        "train_loss": [], "val_loss": [], "val_accuracy": [], "lr": [],
        "val_per_string": [], "epoch_time": [],
    }

    for epoch in range(start_epoch, ocfg.epochs):
        t0 = time.perf_counter()
        running = torch.zeros((), dtype=torch.float64, device=dev)
        steps, seen = 0, 0
        for batch in train_loader:
            gen = step_generator(ocfg.seed, state.step, generator=generator)
            metrics = train_step(state, _to_device(state, batch), gen, lr)
            running += metrics["loss"]
            steps += 1
            seen += int(batch["labels"].shape[0])
        train_loss = float(running) / max(steps, 1)  # the epoch's one read
        train_time = time.perf_counter() - t0

        val = validate_model(state, eval_step, val_loader)
        lr = scheduler(epoch, val["loss"], lr)
        dt = time.perf_counter() - t0

        history["train_loss"].append(train_loss)
        history["val_loss"].append(val["loss"])
        history["val_accuracy"].append(val["accuracy"])
        history["val_per_string"].append(val["per_string_accuracy"].tolist())
        history["lr"].append(lr)
        history["epoch_time"].append(dt)
        segments_per_sec = seen / max(train_time, 1e-9)
        history.setdefault("segments_per_sec", []).append(segments_per_sec)
        log(
            f"epoch {epoch + 1}/{ocfg.epochs}: train {train_loss:.4f} "
            f"val {val['loss']:.4f} acc {val['accuracy']:.4f} "
            f"lr {lr:.2e} ({dt:.1f}s, {segments_per_sec:,.0f} segments/s)"
        )

        if on_epoch_end is not None:
            on_epoch_end(epoch, history, state)

        if val["loss"] < best_val:
            best_val = val["loss"]
            _snapshot(state, into=best)
            patience = 0
            if checkpointer_save is not None:
                checkpointer_save.save(
                    state, epoch=epoch, metrics=val, model_meta=model_meta,
                )
        else:
            patience += 1
            if patience >= ocfg.early_stop_patience:
                log(f"early stopping at epoch {epoch + 1}")
                break

    _load_snapshot(state, best)
    history["best_val_loss"] = best_val
    return state, history
