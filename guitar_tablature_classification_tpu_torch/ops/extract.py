"""Batch CQT feature extraction over a dataset directory (the JAX package's
``ops/extract.py``, ``tab-extract-cqt``).

Reference-compatible replacement for ``process_all_audio``
(cqt.py:5-67) and the process-pool variant ``process_all_files_parallel``
(new_cqt.py:46-61): same signature, same per-segment ``.npy`` outputs and
naming, but all segments of a track go through the CQT in a few calls on
the card (the fused CQT kernel of ``csrc/cqt.cu``) instead of one librosa
call per 0.2 s window.

    python -m guitar_tablature_classification_tpu_torch.ops.extract \\
        audio/ cqt_features/ --fixture-naming [--device cpu]
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..config import CQTConfig
from ..device import resolve_device
from .cqt import CQTFrontend
from .framing import frame_track, window_times


def process_all_audio(
    dataset_path: str,
    window_size: float = 0.2,
    hop_size: float = 0.1,
    save_path: str = "output",
    *,
    cfg: CQTConfig | None = None,
    batch_size: int = 512,
    fixture_naming: bool = False,
    max_segments: int | None = None,
    device=None,
) -> list[str]:
    """Extract CQT features for every ``.wav`` under ``dataset_path`` on
    ``device`` (the card unless the caller asks for the CPU).

    Naming follows cqt.py:62 (``{base}_segment_{k}.npy``); with
    ``fixture_naming`` it matches the shipped tablatures' scheme
    (``{base}_segment_{file_rank}_{start:.2f}.npy``, new_cqt.py:40 —
    ``file_rank`` is the file's position in sorted processing order) so
    features pair 1:1 by exact filename with the reference label fixtures.
    ``max_segments`` caps total output, budgeted evenly per file (the
    ``max_images`` semantics of new_cqt.py:46-61).
    """
    from ..data.audio import load_audio

    cfg = cfg or CQTConfig()
    if window_size != cfg.window_seconds or hop_size != cfg.hop_seconds:
        cfg = dataclasses.replace(cfg, window_seconds=window_size, hop_seconds=hop_size)
    dev = resolve_device(device)
    os.makedirs(save_path, exist_ok=True)
    frontend = CQTFrontend(cfg)
    written: list[str] = []

    wavs = sorted(f for f in os.listdir(dataset_path) if f.endswith(".wav"))
    per_file_budget = max(1, max_segments // len(wavs)) if (max_segments and wavs) else None
    for file_rank, wav in enumerate(wavs):
        audio, _ = load_audio(os.path.join(dataset_path, wav), sample_rate=cfg.sample_rate)
        windows = frame_track(audio, cfg)
        times = window_times(audio.shape[0], cfg)
        if per_file_budget is not None:
            windows = windows[:per_file_budget]
            times = times[:per_file_budget]
        base = os.path.splitext(wav)[0]
        feats = extract_windows(frontend, windows, batch_size=batch_size, device=dev)
        for k in range(feats.shape[0]):
            if fixture_naming:
                name = f"{base}_segment_{file_rank}_{times[k]:.2f}.npy"
            else:
                name = f"{base}_segment_{k}.npy"
            path = os.path.join(save_path, name)
            np.save(path, feats[k])
            written.append(path)
    return written


def extract_windows(
    frontend: CQTFrontend, windows: np.ndarray, *, batch_size: int = 512, device=None
) -> np.ndarray:
    """[N, window_samples] -> [N, n_bins, n_frames] float32 in chunks of
    ``batch_size`` windows, each one CQT call on ``device`` (the card unless
    the caller asks for the CPU).  The last chunk is not padded: the kernel
    takes any batch, and each window's features do not depend on the
    others'."""
    dev = resolve_device(device)
    outs = []
    with torch.no_grad():
        for lo in range(0, windows.shape[0], batch_size):
            chunk = torch.from_numpy(np.array(windows[lo : lo + batch_size], np.float32))
            outs.append(frontend(chunk.to(dev)).cpu().numpy())
    return np.concatenate(outs)


def main(argv=None) -> int:
    """CLI: python -m guitar_tablature_classification_tpu_torch.ops.extract ..."""
    import argparse

    p = argparse.ArgumentParser(prog="tab-extract-cqt")
    p.add_argument("dataset_path", help="directory of .wav files")
    p.add_argument("save_path", help="output directory for .npy features")
    p.add_argument("--window-size", type=float, default=0.2)
    p.add_argument("--hop-size", type=float, default=0.1)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--fixture-naming", action="store_true",
                   help="name outputs like the reference label fixtures")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)
    written = process_all_audio(
        args.dataset_path, args.window_size, args.hop_size, args.save_path,
        batch_size=args.batch_size, fixture_naming=args.fixture_naming,
        device=args.device,
    )
    print(f"wrote {len(written)} feature files to {args.save_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
