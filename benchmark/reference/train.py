"""Training, plainly: the label-smoothed loss, the clipped Adam or AdamW
update, and the first steps of a run.

Loss (``bestengine.py:63-87``): every class gets smoothing / (classes - 1),
the target class 1 - smoothing; the mean over (row, string) of the cross
entropy against that distribution.  Update (``engine.py:55-84`` of the
JAX package, optax's chain): the gradients scaled to norm 1 where their
global norm exceeds it; Adam adds weight_decay * p to the gradient first,
AdamW after the moments; moments with b1 .9, b2 .999, bias correction from
step 1, eps 1e-8 outside the root; the step -lr times that, and times
backbone_lr_scale for the parameters under ``resnet.`` or ``vit.``.
"""

from __future__ import annotations

import torch

from .cqt import CQT
from .precision import Precision, fp32_products

B1, B2, EPS = 0.9, 0.999, 1e-8


def smoothed_loss(logits: torch.Tensor, labels: torch.Tensor, smoothing: float) -> torch.Tensor:
    c = logits.shape[-1]
    target = torch.full_like(logits, smoothing / (c - 1))
    target.scatter_(-1, labels.long().clamp(0, c - 1)[..., None], 1.0 - smoothing)
    return -(target * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def adam_update(params: dict, grads: dict, state: dict, optim: dict, step: int) -> None:
    """One update of ``params`` (name -> tensor, in place)."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
    clip = optim["grad_clip_norm"]
    factor = clip / norm if clip and norm >= clip else 1.0
    wd, lr = optim["weight_decay"], optim["learning_rate"]
    for name, p in params.items():
        u = grads[name] * factor
        if optim["name"] == "adam":
            u = u + wd * p
        m, v = state.setdefault(name, (torch.zeros_like(p), torch.zeros_like(p)))
        m = (1 - B1) * u + B1 * m
        v = (1 - B2) * u * u + B2 * v
        state[name] = (m, v)
        d = (m / (1 - B1**step)) / (torch.sqrt(v / (1 - B2**step)) + EPS)
        if optim["name"] == "adamw":
            d = d + wd * p
        d = -lr * d
        if name.split(".")[0] in ("resnet", "vit"):
            d = d * optim["backbone_lr_scale"]
        p.add_(d)


class Trainer:
    """The reference's train steps over ``model`` (a :func:`.models.build`
    with weights loaded) from the configuration ``cfg``."""

    def __init__(self, model, cfg: dict, device, prec: Precision = Precision()):
        self.model, self.cfg, self.prec = model, cfg, prec
        self.cqt = CQT(cfg["cqt"], device)
        self.params = dict(model.named_parameters())
        self.moments: dict = {}
        self.t = 0

    def loss(self, audio, labels, generator, rows: slice | None = None):
        with fp32_products():
            x = self.model.inputs(self.cqt(audio, self.prec))
            logits = self.model.run(x, train=True, generator=generator, prec=self.prec)
        if rows is not None:  # a fault to read: part of the batch in the mean
            logits, labels = logits[rows], labels[rows]
        return smoothed_loss(logits, labels, self.cfg["optim"]["label_smoothing"])

    def step(self, audio, labels, generator, rows: slice | None = None) -> dict:
        """One step in place: {"loss", "grads" (raw)}."""
        names = list(self.params)
        loss = self.loss(audio, labels, generator, rows)
        with fp32_products():
            grads = torch.autograd.grad(loss, [self.params[n] for n in names])
        grads = dict(zip(names, grads))
        self.t += 1
        with torch.no_grad():
            adam_update(self.params, grads, self.moments, self.cfg["optim"], self.t)
        return {"loss": float(loss.detach()), "grads": grads}
