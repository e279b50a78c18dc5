"""Serving traffic: one client transcribing whole tracks, closed loop.

Set-up builds the port's ``Transcriber`` with the seed's weights
(``batch_size``, ``buckets``), renders one track per entry of
``track_seconds`` (the same cycle of lengths for every seed; the audio
from the seed) and transcribes each once, which warms every bucket shape
the cycle uses.  The window sends the tracks in turn, each after the last
came back, until ``--seconds`` have passed; a track's time runs from the
``transcribe`` call to its host ``frets``.  Every track of the window
completes.  A forward pre-hook on the Transcriber's model counts its calls
and their batch sizes.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import audio, weights
from ..seeds import derive


class Driver:
    kind = "serve"

    def __init__(self, cell, seed: int, device, spans):
        self.cell, self.seed, self.device, self.spans = cell, seed, device, spans
        self.traffic, self.cfg = cell.traffic, cell.config
        self.forward_batches: list[int] = []

    def setup(self) -> None:
        from guitar_tablature_classification_tpu_torch.config import CQTConfig, ModelConfig
        from guitar_tablature_classification_tpu_torch.infer.transcribe import Transcriber

        t = self.traffic
        cqt_cfg = CQTConfig(**self.cfg["cqt"])
        self.transcriber = Transcriber(
            weights.make(self.cfg["model"], self.seed, self.device),
            model_cfg=ModelConfig(**self.cfg["model"]), cqt_cfg=cqt_cfg,
            batch_size=t["batch_size"], bucket_sizes=tuple(t["buckets"]), device=self.device)
        self.hop = int(t["hop_seconds"] * cqt_cfg.sample_rate)
        self.tracks = [x.cpu().numpy() for x in audio.tracks(
            t["track_seconds"], cqt_cfg.sample_rate, self.seed, self.device)]
        self.transcriber.model.register_forward_pre_hook(
            lambda _m, args: self.forward_batches.append(int(args[0].shape[0])))
        self.sent = 0
        for _ in self.tracks:
            self._transcribe()
        self.results: list[tuple[int, object]] = []
        self.latency: list[float] = []
        self.windows: list[int] = []
        self.forward_batches.clear()

    def _transcribe(self):
        i = self.sent % len(self.tracks)
        self.sent += 1
        with self.spans("transcribe"):
            out = self.transcriber.transcribe(self.tracks[i], smooth_window=self.traffic["smooth_window"],
                                              hop_samples=self.hop, keep_logits=True)
        return i, out

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            i, out = self._transcribe()
            self.latency.append(time.perf_counter() - t)
            self.windows.append(int(out.frets.shape[0]))
            self.results.append((i, out))
        return {"wall_s": time.perf_counter() - t0, "tracks": len(self.latency),
                "windows": sum(self.windows), "latency_s": list(self.latency),
                "forward_calls": len(self.forward_batches)}

    def stretch(self) -> dict:
        """``trace_tracks`` tracks from a mark (after one before it) to a
        synchronize."""
        from ..counters import launches
        from ..devtrace import mark

        self._transcribe()
        self.forward_batches.clear()
        before = launches()
        t = mark(self.device)
        for _ in range(self.traffic["trace_tracks"]):
            self._transcribe()
        torch.cuda.synchronize(self.device)
        after = launches()
        return {"counts": {k: after[k] - before[k] for k in after},
                "forward_batches": list(self.forward_batches),
                "units": self.traffic["trace_tracks"], "backward": False, "mark": t}

    def free(self) -> None:
        del self.transcriber
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ----------------------------------------------------------- reference

    def sample(self) -> list[int]:
        """Indices into the window's results: the first of the longest
        tracks, and ``check_tracks`` - 1 more drawn from the seed."""
        n = len(self.results)
        longest = max(range(n), key=lambda k: (len(self.tracks[self.results[k][0]]), -k))
        rng = np.random.default_rng(derive(self.seed, "sample"))
        rest = [k for k in rng.permutation(n).tolist() if k != longest]
        return [longest] + rest[: self.traffic["check_tracks"] - 1]

    def reference_logits(self, track: np.ndarray, kind: str = "fp32") -> torch.Tensor:
        """[windows, strings, frets] logits of the reference over a track's
        windows, in blocks of ``batch_size``."""
        from ..reference import cqt as rcqt
        from ..reference import models
        from ..reference.precision import Precision, fp32_products

        if getattr(self, "_ref", None) is None:
            w = weights.make(self.cfg["model"], self.seed, self.device)
            with torch.device("meta"):
                model = models.build(self.cfg["model"])
            model.load_state_dict(w, assign=True)
            self._ref = (model.eval(), rcqt.CQT(self.cfg["cqt"], self.device))
        model, transform = self._ref
        windows = rcqt.frame(track, self.cfg["cqt"], self.hop)
        outs = []
        with torch.no_grad(), fp32_products():
            for lo in range(0, len(windows), self.traffic["batch_size"]):
                x = torch.from_numpy(windows[lo:lo + self.traffic["batch_size"]]).to(self.device)
                img = model.inputs(transform(x, Precision(kind)))
                outs.append(model.run(img, train=False, prec=Precision(kind)).cpu())
        return torch.cat(outs)
