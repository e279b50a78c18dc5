"""Training engine of the port: the JAX package's ``train/engine.py``
(``make_optimizer``, ``make_preprocess``, ``TrainState``,
``create_train_state``, ``make_train_step``, ``make_eval_step``,
``validate_model``, ``test_model``, ``train_model``).

The JAX step is one jitted pure function; here the step runs eagerly and
updates the state in place (the parameters, moments and running averages
live in flat fp32 buffers, so each optimizer operation is one kernel over
all of them).  Nothing in a step reads a device value on the host: the
non-finite-loss skip is a device-side select, and the metrics come back as
device tensors.  The loops above the steps read the device once an epoch
(the summed train loss) and once a validation pass.
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
    return TrainState(
        model=model, tx=tx, names=names, params=params, buffers=buffers,
        opt_state=tx.init(params), param_list=param_list,
    )


# -------------------------------------------------------------------- steps


def _features(batch, frontend, preprocess, augment=None, generator=None):
    feats = frontend(batch["audio"]) if "audio" in batch else batch["features"]
    if augment is not None:
        feats = augment(generator, feats)
    return preprocess(feats) if preprocess is not None else feats


def make_train_step(
    model: nn.Module,
    preprocess: Callable | None = None,
    *,
    smoothing: float = 0.05,
    skip_nonfinite: bool = True,
    frontend: Callable | None = None,
    augment: Callable | None = None,
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
    gradients)."""

    def train_step(state: TrainState, batch, generator: torch.Generator, lr: float):
        model.train()
        with torch.no_grad():
            images = _features(batch, frontend, preprocess, augment, generator)
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


def validate_model(state: TrainState, eval_step, loader: Iterable) -> dict[str, Any]:
    """Aggregate eval metrics over a loader (``engine.py:275-298`` of the
    JAX package): per-string accuracy is the exact correct/total ratio,
    and the loss the exact weighted mean over all (sample, string) cells
    (each batch's weighted-mean loss re-scaled by its weight total, so a
    padded or short last batch counts in proportion).  The sums stay on
    the device in float64 and are read once."""
    dev = state.params.device
    loss_sum = torch.zeros((), dtype=torch.float64, device=dev)
    correct = count = None
    for batch in loader:
        m = eval_step(state, batch_to_device(batch, dev))
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
    improves, and loaded back into the returned state at the end."""
    from ..models.tabnet import build_model
    from ..utils.prng import step_generator
    from .schedules import make_scheduler

    config = config or TrainConfig()
    ocfg = config.optim
    init_batch = next(iter(train_loader))  # as the JAX loop: a shuffled loader's epoch advances
    if "features" in init_batch and np.ndim(init_batch["features"]) == 4:
        raise NotImplementedError(
            "the rgb_image input kind (PNG spectrogram renders) is not ported "
            "yet (ROADMAP A3); train on [B, n_bins, n_frames] dB features"
        )
    if state is None:
        if model is None:
            model = build_model(
                config.model, generator=torch.Generator().manual_seed(ocfg.seed)
            )
        state = create_train_state(model, ocfg, device)
    model = state.model
    dev = state.params.device
    preprocess = make_preprocess(config.model, config.data.image_size)

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
            metrics = train_step(state, batch_to_device(batch, dev), gen, lr)
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
            if checkpointer is not None:
                checkpointer.save(
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
