"""Training traffic: the port's train step fed through its prefetch.

Set-up builds one train state (the port's model with the seed's weights,
``create_train_state``, ``make_train_step`` with the CQT in the step),
renders ``batches`` distinct host batches of ``batch`` windows, and feeds
them round robin through ``device_prefetch(size=prefetch)``.  The first
``check_steps`` steps go through that same feed and call and are the ones
the reference follows; ``warm_steps`` more run before the window.  What
the check reads of them is public: each step's returned loss and gradient
norm, and the model's parameters before the first step, after it and
after the last (the change of step 1, whose direction under Adam is the
gradient's sign, and the norms of the whole change).  Every
step's dropout generator is re-seeded from (seed, step), as the port's
training loop does.  The window enqueues steps until ``--seconds`` have
passed, then waits for the device: segments trained / wall seconds.
"""

from __future__ import annotations

import itertools
import time

import torch

from .. import audio, weights
from ..seeds import derive


class Driver:
    kind = "train"

    def __init__(self, cell, seed: int, device, spans):
        self.cell, self.seed, self.device, self.spans = cell, seed, device, spans
        self.traffic, self.cfg = cell.traffic, cell.config

    # ----------------------------------------------------------- set-up

    def setup(self) -> None:
        from guitar_tablature_classification_tpu_torch.config import (
            CQTConfig, ModelConfig, OptimConfig)
        from guitar_tablature_classification_tpu_torch.data.pipeline import device_prefetch
        from guitar_tablature_classification_tpu_torch.models.tabnet import build_model
        from guitar_tablature_classification_tpu_torch.ops.cqt import CQTFrontend
        from guitar_tablature_classification_tpu_torch.train.engine import (
            create_train_state, make_preprocess, make_train_step)

        cfg, t = self.cfg, self.traffic
        model_cfg, cqt_cfg = ModelConfig(**cfg["model"]), CQTConfig(**cfg["cqt"])
        optim_cfg = OptimConfig(**cfg["optim"])
        self.lr = optim_cfg.learning_rate
        model = build_model(model_cfg)
        model.load_state_dict(weights.make(cfg["model"], self.seed, self.device), strict=True)
        self.state = create_train_state(model, optim_cfg, self.device)
        self.step_fn = make_train_step(model, make_preprocess(model_cfg),
                                       smoothing=optim_cfg.label_smoothing,
                                       frontend=CQTFrontend(cqt_cfg))
        self.batches = audio.train_batches(
            t, cqt_cfg.window_samples, int(t["hop_seconds"] * cqt_cfg.sample_rate),
            cqt_cfg.sample_rate, self.seed, self.device)
        self.feed = device_prefetch(itertools.cycle(self.batches), size=t["prefetch"],
                                    device=self.device)
        self.gen = torch.Generator(device=self.device)
        self.steps = 0
        # the first steps, which the reference follows
        params = dict(model.named_parameters())
        p0 = {n: p.detach().clone() for n, p in params.items()}
        losses, norms = [], []
        for i in range(t["check_steps"]):
            out = self._step()
            losses.append(out["loss"])
            norms.append(out["grad_norm"])
            if i == 0:
                step1 = {n: (p.detach() - p0[n]).cpu() for n, p in params.items()}
        self.readings = {"loss": torch.stack(losses).cpu().tolist(),
                         "grad_norm": float(norms[0]), "step1": step1,
                         "change": _norms({n: p.detach() - p0[n] for n, p in params.items()})}
        del p0, params
        for _ in range(t["warm_steps"]):
            self._step()
        torch.cuda.synchronize(self.device) if self.device.type == "cuda" else None

    def _step(self):
        with self.spans("prefetch_wait"):
            batch = next(self.feed)
        self.gen.manual_seed(derive(self.seed, "dropout", self.steps))
        with self.spans("step"):
            out = self.step_fn(self.state, batch, self.gen, self.lr)
        self.steps += 1
        return out

    # ----------------------------------------------------------- window

    def window(self, seconds: float) -> dict:
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda d: None)
        first = self.steps
        t0 = time.perf_counter()
        while True:
            self._step()
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        wall = time.perf_counter() - t0
        steps = self.steps - first
        return {"wall_s": wall, "steps": steps, "segments": steps * self.traffic["batch"]}

    def stretch(self) -> dict:
        """``trace_steps`` steps from a mark (after two that refill the
        device's queue) to a synchronize."""
        from ..counters import launches
        from ..devtrace import mark

        for _ in range(2):
            self._step()
        before = launches()
        t = mark(self.device)
        for _ in range(self.traffic["trace_steps"]):
            self._step()
        torch.cuda.synchronize(self.device)
        after = launches()
        n = self.traffic["trace_steps"]
        return {"counts": {k: after[k] - before[k] for k in after},
                "forward_batches": [self.traffic["batch"]] * n, "units": n, "backward": True, "mark": t}

    def free(self) -> None:
        del self.state, self.step_fn, self.feed
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ----------------------------------------------------------- reference

    def reference(self, kind: str = "fp32", rows_fault: bool = False) -> dict:
        """The reference's readings over the same first steps, in the
        port's form (losses, the step-1 gradient's global norm, the change
        of step 1 on the host, the norms of the whole change per leaf) and
        its own: the step-1 gradient's norm per leaf and the names of the
        logit layers' weights.  ``kind`` ``fp8`` is the control;
        ``rows_fault`` takes half of each batch into the mean (a fault to
        read)."""
        from ..reference import models
        from ..reference.precision import Precision
        from ..reference.train import Trainer

        w = weights.make(self.cfg["model"], self.seed, self.device)
        with torch.device("meta"):
            model = models.build(self.cfg["model"])
        model.load_state_dict(w, assign=True)
        trainer = Trainer(model, self.cfg, self.device, Precision(kind))
        logit_weights = model.logit_weights()
        p0 = {n: p.detach().clone() for n, p in trainer.params.items()}
        gen = torch.Generator(device=self.device)
        losses = []
        half = slice(0, self.traffic["batch"] // 2) if rows_fault else None
        for i in range(self.traffic["check_steps"]):
            b = self.batches[i]
            gen.manual_seed(derive(self.seed, "dropout", i))
            out = trainer.step(torch.from_numpy(b["audio"]).to(self.device),
                               torch.from_numpy(b["labels"]).to(self.device), gen, half)
            losses.append(out["loss"])
            if i == 0:
                grad = _norms(out["grads"])
                g_norm = float(torch.sqrt(sum(torch.linalg.vector_norm(g.double()) ** 2
                                              for g in out["grads"].values())))
                step1 = {n: (p.detach() - p0[n]).cpu() for n, p in trainer.params.items()}
            del out
        change = _norms({n: p.detach() - p0[n] for n, p in trainer.params.items()})
        del trainer, model, w, p0
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return {"loss": losses, "grad_norm": g_norm, "step1": step1, "change": change,
                "grad": grad, "logit_weights": logit_weights}


def _norms(leaves: dict) -> dict[str, float]:
    names = list(leaves)
    norms = torch.stack([torch.linalg.vector_norm(leaves[n].detach().float()) for n in names])
    return dict(zip(names, norms.cpu().tolist()))
