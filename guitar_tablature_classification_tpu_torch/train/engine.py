"""Training engine of the port: the JAX package's ``train/engine.py``
(``make_optimizer``, ``make_preprocess``, ``TrainState``,
``create_train_state``, ``make_train_step``, ``make_eval_step``).

The JAX step is one jitted pure function; here the step runs eagerly and
updates the state in place (the parameters, moments and running averages
live in flat fp32 buffers, so each optimizer operation is one kernel over
all of them).  Nothing in a step reads a device value on the host: the
non-finite-loss skip is a device-side select, and the metrics come back as
device tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

import torch
from torch import nn

from ..config import ModelConfig, OptimConfig
from ..device import resolve_device
from ..ops.loss import label_smoothing_loss, per_string_accuracy
from ..ops.normalize import db_to_unit, imagenet_normalize, tile_channels
from ..ops.resize import resize_bicubic

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.scale_by_adam defaults


def make_preprocess(
    model_cfg: ModelConfig, image_size: int = 224
) -> Callable[[torch.Tensor], torch.Tensor]:
    """[B, n_bins, n_frames] dB features -> channels-last model input.

    dB -> [0, 1]; the native archs take that as is ([B, 96, T, 1]), and so
    does ``resnet18`` with ``stem_fusion="fused"`` at 224^2: its fused stem
    folds resize, tile and normalize into conv1's GEMM (``engine.py:132-140``
    of the JAX package).  Other ``resnet18`` configurations get a bicubic
    resize to ``image_size``^2, a 3-channel tile and the ImageNet
    normalization; ``stem_fusion="on"`` takes those images too (the JAX
    package folds them into GEMMs that compute the same function).  (The
    JAX package's ``rgb_image`` input kind, for PNG renders, is not ported.)
    """
    arch = model_cfg.arch
    fused = arch == "resnet18" and image_size == 224 and model_cfg.stem_fusion == "fused"

    def preprocess(feats: torch.Tensor) -> torch.Tensor:
        x = db_to_unit(feats)
        if fused or arch in ("small_cnn", "resnet18_native", "vit_native"):
            return x[..., None]  # raw [B, 96, T, 1], no resize needed
        x = resize_bicubic(x, (image_size, image_size))
        x = tile_channels(x, model_cfg.input_channels)
        if arch == "resnet18":
            x = imagenet_normalize(x)
        return x

    return preprocess


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

    def update(
        self, grads: torch.Tensor, state: AdamState, params: torch.Tensor, lr: float
    ) -> tuple[torch.Tensor, AdamState, torch.Tensor]:
        """(new params, new state, global norm of the raw gradients)."""
        cfg = self.cfg
        g_norm = torch.linalg.vector_norm(grads)
        u = grads
        if cfg.grad_clip_norm:
            max_norm = cfg.grad_clip_norm
            u = torch.where(g_norm < max_norm, u, (u / g_norm) * max_norm)
        if cfg.name == "adam" and cfg.weight_decay:
            u = u + cfg.weight_decay * params
        mu = (1 - ADAM_B1) * u + ADAM_B1 * state.mu
        nu = (1 - ADAM_B2) * (u * u) + ADAM_B2 * state.nu
        count = state.count + 1
        t = count.float()
        mu_hat = mu / (1 - ADAM_B1**t)
        nu_hat = nu / (1 - ADAM_B2**t)
        u = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)
        if cfg.name == "adamw" and cfg.weight_decay:
            u = u + cfg.weight_decay * params
        u = (-1.0 * lr) * u
        if self.backbone is not None:
            u = torch.where(self.backbone, cfg.backbone_lr_scale * u, u)
        return params + u, AdamState(count, mu, nu), g_norm


def make_optimizer(
    cfg: OptimConfig, names: Sequence[str], sizes: Sequence[int]
) -> Optimizer:
    """The optimizer of ``cfg`` for parameters with these names and sizes
    (in flat-buffer order)."""
    return Optimizer(cfg, names, sizes)


# -------------------------------------------------------------------- state


def _flatten(tensors: list[torch.Tensor]) -> torch.Tensor:
    """Move ``tensors`` into one flat fp32 buffer: each becomes a view of
    its slice, so an in-place update of the buffer updates them all."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
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
    ones included."""

    model: nn.Module
    tx: Optimizer
    names: list[str]
    params: torch.Tensor
    buffers: torch.Tensor
    opt_state: AdamState
    step: int = 0
    param_list: list[torch.Tensor] = field(default_factory=list)

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
    model: nn.Module, optim_cfg: OptimConfig, device: str | torch.device | None = None
) -> TrainState:
    """Move ``model`` to ``device`` (the card unless the caller asks for
    the CPU), gather its parameters and running averages into flat
    buffers, and set up the optimizer with zero moments."""
    model.to(resolve_device(device))
    named = list(model.named_parameters())
    names = [n for n, _ in named]
    param_list = [p for _, p in named]
    if any(p.dtype != torch.float32 for p in param_list):
        raise ValueError("the train state holds fp32 parameters only")
    params = _flatten(param_list)
    buffers = _flatten(_running_stats(model))
    tx = make_optimizer(optim_cfg, names, [p.numel() for p in param_list])
    return TrainState(
        model=model, tx=tx, names=names, params=params, buffers=buffers,
        opt_state=tx.init(params), param_list=param_list,
    )


# -------------------------------------------------------------------- steps


def _features(batch, frontend, preprocess):
    feats = frontend(batch["audio"]) if "audio" in batch else batch["features"]
    return preprocess(feats) if preprocess is not None else feats


def make_train_step(
    model: nn.Module,
    preprocess: Callable | None = None,
    *,
    smoothing: float = 0.05,
    skip_nonfinite: bool = True,
    frontend: Callable | None = None,
):
    """The train step ``train_step(state, batch, generator, lr) -> metrics``.

    ``batch``: either ``audio`` [B, W] raw windows (through ``frontend``,
    the CQT) or ``features`` [B, F, T] dB, plus ``labels`` [B, 6] int frets
    and optional ``weights`` [B, 6].  ``generator`` draws the dropout masks;
    ``lr`` is this step's learning rate.  Forward and backward in train
    mode, the label-smoothed loss, one optimizer update, in place.  With
    ``skip_nonfinite``, a non-finite loss leaves the parameters, moments
    and running averages as they were (``engine.py:208-215``); ``step``
    advances either way.  Metrics (device tensors): ``loss``,
    ``accuracy``, ``per_string_accuracy`` and ``grad_norm`` (of the raw
    gradients)."""

    def train_step(state: TrainState, batch, generator: torch.Generator, lr: float):
        model.train()
        with torch.no_grad():
            images = _features(batch, frontend, preprocess)
        labels = batch["labels"]
        saved = state.buffers.clone() if skip_nonfinite else None
        logits = model(images, generator)
        loss = label_smoothing_loss(logits, labels, smoothing, weights=batch.get("weights"))
        grads = torch.autograd.grad(loss, state.param_list)
        with torch.no_grad():
            flat = torch.cat([g.reshape(-1) for g in grads])
            new_params, new_opt, grad_norm = state.tx.update(
                flat, state.opt_state, state.params, lr
            )
            old = state.opt_state
            if skip_nonfinite:
                ok = torch.isfinite(loss)
                new_params = torch.where(ok, new_params, state.params)
                new_opt = AdamState(*(
                    torch.where(ok, n, o) for n, o in
                    ((new_opt.count, old.count), (new_opt.mu, old.mu), (new_opt.nu, old.nu))
                ))
                state.buffers.copy_(torch.where(ok, state.buffers, saved))
            state.params.copy_(new_params)
            old.count.copy_(new_opt.count)
            old.mu.copy_(new_opt.mu)
            old.nu.copy_(new_opt.nu)
            per_string, overall = per_string_accuracy(logits, labels)
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
):
    """``eval_step(state, batch) -> metrics``: the eval-mode forward, with
    ``weights`` [B, 6] masking padded rows out of the loss and accuracies
    (``engine.py:228-255``).  Metrics: ``loss``, ``accuracy``,
    ``per_string_accuracy``, ``correct`` and ``count`` per string."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        model.eval()
        logits = model(_features(batch, frontend, preprocess))
        labels = batch["labels"]
        weights = batch.get("weights")
        if weights is None:
            weights = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        weights = weights.float()
        loss = label_smoothing_loss(logits, labels, smoothing, weights=weights)
        correct = (logits.argmax(dim=-1) == labels).float() * weights
        count = weights.sum(dim=0)
        return {
            "loss": loss,
            "accuracy": correct.sum() / torch.clamp(weights.sum(), min=1.0),
            "per_string_accuracy": correct.sum(dim=0) / torch.clamp(count, min=1.0),
            "correct": correct.sum(dim=0),
            "count": count,
        }

    return eval_step
