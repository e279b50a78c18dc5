"""Command-line transcription: audio file -> ASCII tab (the JAX package's
``infer/cli.py``, ``tab-transcribe``).

Same flags as the JAX CLI, plus ``--device`` (default ``cuda``).
``--model`` takes a reference-layout ``.pt`` file, or a checkpoint of the
port's trainer (``train.run``): its directory, its name in that directory
(``checkpoints/best_guitar_tab_model``, as the JAX CLI takes its Orbax
one) or its ``.pt`` file, checked against the requested model
configuration.  The JAX package's Orbax directories are not read
(convert them to ``.pt`` first).  ``--image`` renders the tab as a PNG
(PIL) and ``--visualize`` the per-string activation plot (matplotlib);
where the flag's package does not import, the CLI exits non-zero before it
transcribes, naming the package.

    python -m guitar_tablature_classification_tpu_torch.infer.cli track.wav \\
        --recipe native-best --model best_guitar_tab_model.pt
    python -m guitar_tablature_classification_tpu_torch.infer.cli track.wav \\
        --arch vit_s8 --model best_vit_guitar_tab_model.pt

Every arch serves: ``resnet18``, ``resnet18_native``, ``small_cnn``,
``vit_s8`` and ``vit_native`` (the recipes ``cnn-reference``,
``native-best``, ``vit-reference`` and ``vit-small-data``); ``small_cnn``
has no reference ``.pt`` layout, so its ``--model`` is a checkpoint of the
port's trainer.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tab-transcribe",
        description="Transcribe guitar audio to tablature on an NVIDIA GPU",
    )
    p.add_argument("audio", help="input audio file (WAV; MP3 with ffmpeg)")
    p.add_argument("--model", default=None,
                   help="checkpoint: reference-layout .pt file, or a "
                        "checkpoint directory (or name) of the port's "
                        "trainer")
    p.add_argument("--arch", default=None,
                   choices=["resnet18", "resnet18_native", "vit_s8",
                            "vit_native", "small_cnn"],
                   help="architecture (default resnet18; mutually "
                        "exclusive with --recipe)")
    p.add_argument("--recipe", default=None,
                   choices=["cnn-reference", "vit-reference",
                            "native-best", "vit-small-data"],
                   help="named training preset (config.RECIPES): serve "
                        "with the preset's model and CQT config")
    p.add_argument("--output", default=None, help="output .txt path")
    p.add_argument("--image", default=None, help="render tab image PNG")
    p.add_argument("--visualize", default=None,
                   help="render per-string activation plot PNG")
    p.add_argument("--segment-duration", type=float, default=0.2)
    p.add_argument("--overlap", type=float, default=0.5,
                   help="window overlap fraction (0.5 -> 0.1 s hop)")
    p.add_argument("--no-smooth", action="store_true",
                   help="disable mode smoothing")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--serving-recipe", action="store_true",
                   help="use the reference CNN inference CQT recipe "
                        "(84 bins, 22.05 kHz, fmin C2; "
                        "tablature_generator.py:619)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    return p


def load_transcriber(args):
    from ..config import RECIPES, CQTConfig, ModelConfig
    from .transcribe import Transcriber, transcriber_from_torch_checkpoint

    if args.recipe is not None and args.arch is not None:
        raise SystemExit("--recipe implies an arch; pass one or the other")
    if args.recipe is not None:
        recipe_cfg = RECIPES[args.recipe]()
        model_cfg, base = recipe_cfg.model, recipe_cfg.cqt
    else:
        model_cfg = ModelConfig(arch=args.arch or "resnet18")
        base = CQTConfig.serving_cnn() if args.serving_recipe else CQTConfig()
    cqt_cfg = dataclasses.replace(
        base,
        window_seconds=args.segment_duration,
        hop_seconds=args.segment_duration * (1.0 - args.overlap),
    )
    common = dict(
        model_cfg=model_cfg, cqt_cfg=cqt_cfg, batch_size=args.batch_size,
        device=args.device,
    )
    if args.model:
        from ..train.checkpoint import (
            CheckpointMismatchError,
            OrbaxCheckpointError,
            find_checkpoint,
        )

        try:
            ckpt = find_checkpoint(args.model)
            if ckpt is not None:  # the port's trainer's checkpoint
                transcriber = Transcriber(None, **common)
                ckpt.load_model(transcriber.model,
                                expect_model=dataclasses.asdict(model_cfg))
                return transcriber
        except (CheckpointMismatchError, OrbaxCheckpointError) as e:
            raise SystemExit(f"--model: {e}")
        if args.model.endswith(".pt"):
            return transcriber_from_torch_checkpoint(
                args.model, arch=model_cfg.arch, **common
            )
        raise SystemExit(
            f"--model {args.model}: neither a reference-layout .pt file nor "
            "a checkpoint of the port's trainer. Convert an Orbax checkpoint "
            "with the JAX package's models.torch_export.save_torch_checkpoint "
            "first."
        )
    return Transcriber(None, **common)  # seeded random init (smoke/demo)


def _require(args) -> None:
    """Exit before transcribing where ``--image`` or ``--visualize`` is
    given and the package it renders with does not import."""
    import importlib

    for flag, value, package in (("--image", args.image, "PIL"),
                                 ("--visualize", args.visualize, "matplotlib")):
        if value:
            try:
                importlib.import_module(package)
            except ImportError:
                raise SystemExit(f"{flag} needs {package}, which is not installed")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _require(args)
    from ..data.audio import load_audio
    from .tab_image import create_tablature_image, plot_string_activations
    from .tab_text import write_tablature_file

    transcriber = load_transcriber(args)
    audio, _ = load_audio(args.audio, sample_rate=transcriber.cqt_cfg.sample_rate)
    result = transcriber.transcribe(audio, smooth_window=0 if args.no_smooth else 3)

    out_path = args.output or os.path.splitext(args.audio)[0] + "_tab.txt"
    title = os.path.basename(args.audio)
    text = write_tablature_file(out_path, result.frets, result.times, title=title)
    print(text)
    print(f"tablature written to {out_path}")
    if args.image:
        create_tablature_image(result.frets, result.times, args.image, title=title)
        print(f"tab image written to {args.image}")
    if args.visualize:
        plot_string_activations(result.frets, result.times, args.visualize)
        print(f"activation plot written to {args.visualize}")
    return 0

if __name__ == "__main__":
    sys.exit(main())
