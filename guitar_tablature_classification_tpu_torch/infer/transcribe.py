"""Batched audio -> tablature transcription (the JAX package's
``infer/transcribe.py``).

A track is framed once, then CQT'd and classified in bucketed batch shapes
(full batches at ``batch_size``; the tail pads only to the smallest bucket
that fits), argmaxed and mode-smoothed.  On the card the CQT runs in the
hand-written kernel of ``ops/cqt_cuda.py``, the flagship's fused stem
(``resnet18`` with ``stem_fusion="fused"``, ``entry()``'s configuration)
in the stem-tail forward kernel of ``ops/stem_cuda.py``, and ``vit_s8``'s
attention (785 tokens) in the forward kernel of ``ops/attention_cuda.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from ..config import CQTConfig, ModelConfig
from ..device import resolve_device
from ..models.tabnet import build_model
from ..ops.cqt import CQTFrontend
from ..ops.framing import frame_track, window_times
from ..ops.smoothing import mode_filter
from ..train.engine import make_preprocess


@dataclass
class Transcription:
    frets: np.ndarray  # [T, 6] int
    times: np.ndarray  # [T] seconds (window starts)
    logits: np.ndarray | None = None


class Transcriber:
    """Load once, transcribe many tracks.

    ``state_dict``: GuitarTabNet or ViTTab weights in the reference layout (from
    :func:`..models.convert.load_torch_checkpoint` or
    :func:`..models.convert.state_dict_from_flax`); None initializes the
    model from ``seed``.  ``device`` defaults to the card; the CPU is used
    only when asked for (``device="cpu"``).

    ``mesh`` (:func:`..parallel.make_mesh`; every rank constructs its
    Transcriber and calls it with the same audio): the weights are rank
    0's on every rank, each rank predicts its rows of every bucket on the
    mesh's device, the data group gathers the logits, and every rank
    returns the whole transcription (``infer/transcribe.py:71-83,122-123``
    of the JAX package).
    """

    def __init__(
        self,
        state_dict: Mapping[str, torch.Tensor] | None = None,
        *,
        model_cfg: ModelConfig | None = None,
        cqt_cfg: CQTConfig | None = None,
        batch_size: int = 128,
        image_size: int = 224,
        bucket_sizes: tuple[int, ...] | None = None,
        device: str | torch.device | None = None,
        seed: int = 0,
        mesh=None,
    ):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.model_cfg = model_cfg or ModelConfig()
        self.cqt_cfg = cqt_cfg or CQTConfig()
        model = build_model(
            self.model_cfg, generator=torch.Generator().manual_seed(seed)
        )
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        if mesh is not None:
            from ..parallel import replicated

            replicated(mesh, self.model)
        self.frontend = CQTFrontend(self.cqt_cfg)
        self.preprocess = make_preprocess(self.model_cfg, image_size)
        self.batch_size = batch_size
        # Bucketed batch shapes: a short tail (or a single streaming
        # window) pads only to the smallest bucket that fits.
        # Under a mesh every bucket must split over the data axis: the
        # others are dropped (all of them: just batch_size).
        if bucket_sizes is None:
            bucket_sizes = (1, 8, 32, batch_size)
        buckets = sorted({min(int(b), batch_size) for b in bucket_sizes})
        if mesh is not None:
            buckets = [b for b in buckets if b % mesh.dp == 0] or [batch_size]
        self.bucket_sizes = tuple(buckets)

    @torch.inference_mode()
    def predict_logits(self, windows: torch.Tensor) -> torch.Tensor:
        """[B, window_samples] audio on the device -> [B, 6, 19] logits."""
        images = self.preprocess(self.frontend(windows))
        return self.model(images)

    def _bucket_for(self, remaining: int) -> int:
        # largest bucket the remainder fills completely (no padding) ...
        for b in reversed(self.bucket_sizes):
            if remaining >= b:
                return b
        # ... else the smallest bucket (minimal padding for the tail)
        return self.bucket_sizes[0]

    def predict_windows(self, windows: np.ndarray) -> np.ndarray:
        """[N, window_samples] -> [N, 6, 19] logits, in bucketed batch
        shapes (the tail pads only to the smallest bucket that fits)."""
        windows = np.asarray(windows, dtype=np.float32)
        n = windows.shape[0]
        outs = []
        lo = 0
        while lo < n:
            b = self._bucket_for(n - lo)
            chunk = windows[lo : lo + b]
            take = chunk.shape[0]
            if take < b:  # pad to the bucket's shape
                chunk = np.concatenate(
                    [chunk, np.zeros((b - take, chunk.shape[1]), chunk.dtype)]
                )
            if self.mesh is None:
                x = torch.from_numpy(np.require(chunk, np.float32, ["C", "W"]))
                outs.append(self.predict_logits(x.to(self.device))[:take])
            else:
                outs.append(self._predict_sharded(chunk)[:take])
            lo += take
        return torch.cat(outs).cpu().numpy()

    def _predict_sharded(self, chunk: np.ndarray) -> torch.Tensor:
        """A bucket's logits under the mesh: this rank predicts its rows,
        and the data group gathers every rank's."""
        from ..parallel import batch_sharding
        from ..parallel.collectives import all_gather

        rows = np.require(chunk[batch_sharding(self.mesh, len(chunk))], np.float32, ["C", "W"])
        logits = self.predict_logits(torch.from_numpy(rows).to(self.device))
        if self.mesh.dp == 1:
            return logits
        return torch.cat(all_gather(logits, self.mesh.data_group, self.mesh.dp))

    def transcribe(
        self,
        audio: np.ndarray,
        *,
        smooth_window: int = 3,
        hop_samples: int | None = None,
        keep_logits: bool = False,
    ) -> Transcription:
        """audio: 1-D float track at cqt_cfg.sample_rate."""
        windows = frame_track(
            np.asarray(audio, dtype=np.float32), self.cqt_cfg,
            hop_samples=hop_samples,
        )
        logits = self.predict_windows(windows)
        frets = np.argmax(logits, axis=-1)  # [T, 6]
        if smooth_window and frets.shape[0] > smooth_window:
            frets = mode_filter(
                torch.from_numpy(frets), window=smooth_window
            ).numpy()
        times = window_times(audio.shape[0], self.cqt_cfg, hop_samples=hop_samples)
        return Transcription(
            frets=frets, times=times, logits=logits if keep_logits else None
        )


def transcriber_from_torch_checkpoint(
    path: str, *, arch: str = "resnet18", **kwargs
) -> Transcriber:
    """Serve a reference ``.pt`` checkpoint (best_guitar_tab_model.pt,
    best_vit_guitar_tab_model.pt, or the JAX package's
    ``save_torch_checkpoint`` output).  The file's keys must match the
    model of ``arch`` exactly.  A conv-stem ViT has no reference layout, so
    it cannot be served from such a file: that raises the JAX package's
    error (``infer/transcribe.py:171-176`` there)."""
    from ..models.convert import load_torch_checkpoint

    model_cfg = kwargs.pop("model_cfg", None) or ModelConfig(arch=arch)
    if model_cfg.vit_conv_stem:
        raise ValueError(
            "torch checkpoints carry the reference patchify layout; a "
            "conv-stem ViT (vit_conv_stem=True) cannot be served from "
            "one. Serve the Orbax checkpoint it was trained to, or "
            "retrain with vit_conv_stem=False for torch portability."
        )
    return Transcriber(load_torch_checkpoint(path), model_cfg=model_cfg, **kwargs)
