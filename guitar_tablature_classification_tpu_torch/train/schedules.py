"""Host-side learning-rate schedules.

The reference uses torch's epoch-granular schedulers:
``ReduceLROnPlateau(factor=0.5, patience=3)`` for the CNN
(bestengine.py:875, stepped on val loss at :969) and
``CosineAnnealingWarmRestarts(T_0=5, T_mult=2, eta_min=1e-6)`` for the
ViT (ViT_engine.py:254).  Both are tiny pieces of *control* logic, so
they stay on the host; the chosen lr is passed to the train step each
step.  A copy of the JAX package's ``train/schedules.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..config import OptimConfig


@dataclass
class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics (mode='min',
    threshold 1e-4 relative)."""

    factor: float = 0.5
    patience: int = 3
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = field(default=math.inf, init=False)
    num_bad_epochs: int = field(default=0, init=False)

    def step(self, metric: float, lr: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            return max(lr * self.factor, self.min_lr)
        return lr


@dataclass
class CosineAnnealingWarmRestarts:
    """torch CosineAnnealingWarmRestarts, stepped per epoch."""

    base_lr: float
    t_0: int = 5
    t_mult: int = 2
    eta_min: float = 1e-6

    def lr_at(self, epoch: int) -> float:
        t_i, t_cur = self.t_0, epoch
        while t_cur >= t_i:
            t_cur -= t_i
            t_i *= self.t_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * t_cur / t_i)
        ) / 2


def make_scheduler(cfg: OptimConfig):
    """Returns (per-epoch lr callback) f(epoch, val_loss, lr) -> lr."""
    if cfg.schedule == "plateau":
        plateau = ReduceLROnPlateau(
            factor=cfg.plateau_factor, patience=cfg.plateau_patience
        )
        return lambda epoch, val_loss, lr: plateau.step(val_loss, lr)
    if cfg.schedule == "cosine_warm_restarts":
        cosine = CosineAnnealingWarmRestarts(
            base_lr=cfg.learning_rate, t_0=cfg.cosine_t0,
            t_mult=cfg.cosine_t_mult, eta_min=cfg.cosine_eta_min,
        )
        return lambda epoch, val_loss, lr: cosine.lr_at(epoch + 1)
    if cfg.schedule == "constant":
        return lambda epoch, val_loss, lr: lr
    raise ValueError(f"unknown schedule {cfg.schedule!r}")
