"""Training entry point (the JAX package's ``train/run.py``, ``tab-train``),
driven by the config system.

    python -m guitar_tablature_classification_tpu_torch.train.run \\
        --features cqt_features/ --labels tablatures/ --arch resnet18
    python -m guitar_tablature_classification_tpu_torch.train.run \\
        --synthetic --recipe native-best --epochs 3

The same flags as the JAX CLI, plus ``--device`` (default ``cuda``; the CPU
only when asked for).  With ``--synthetic`` (no GuitarSet on disk) it
renders a synthetic performance dataset (audio + JAMS -> CQT features +
labels) from the seed and trains on that end to end.  ``--report-dir``
writes the visualization suite of :mod:`..report` after training (or after
``--eval-only``), and ``--report-every N`` the metric curves and
validation confusion matrices every N epochs during training, under the
JAX CLI's file names.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tab-train")
    p.add_argument("--features", default=None, help="CQT feature .npy dir")
    p.add_argument("--labels", default=None, help="tablature .npy dir")
    p.add_argument("--arch", default=None,
                   choices=["resnet18", "resnet18_native", "vit_s8",
                            "vit_native", "small_cnn"],
                   help="architecture (default resnet18; mutually "
                        "exclusive with --recipe, which implies one)")
    p.add_argument("--recipe", default=None,
                   choices=["cnn-reference", "vit-reference",
                            "native-best", "vit-small-data"],
                   help="named preset (config.RECIPES): 'native-best' = "
                        "resnet18_native + default-tier CQT + batch 2048; "
                        "'vit-small-data' = vit_native with (16,3) patches "
                        "and the conv stem")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--config", default=None, help="TrainConfig JSON file")
    p.add_argument("--report-dir", default=None,
                   help="write the visualization artifact suite here")
    p.add_argument("--report-every", type=int, default=0, metavar="N",
                   help="also emit metric curves + confusion matrices "
                        "into --report-dir every N epochs during training "
                        "(reference: metric plots every 5 epochs, "
                        "bestengine.py:1006-1007; per-epoch confusion "
                        "matrices, ViT_engine.py:473)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthesized audio/labels (no dataset needed)")
    p.add_argument("--synthetic-tracks", type=int, default=8)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the training run "
                        "(trace.json and an ops table)")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise where the backward pass produces a NaN "
                        "(torch.autograd.set_detect_anomaly); unlike the JAX "
                        "package's jax_debug_nans it checks neither the "
                        "forward pass nor the optimizer update")
    p.add_argument("--stem-fusion", default=None,
                   choices=["off", "on", "fused"],
                   help="stem mode: 'fused' = resnet18's quadrant GEMM "
                        "front + the stem-tail kernels, resnet18_native's "
                        "native stem kernels (ModelConfig.stem_fusion)")
    p.add_argument("--bn-fusion", default=None, choices=["off", "on"],
                   help="resnet trunk BatchNorms with their statistics in "
                        "the column-sum kernels (ModelConfig.bn_fusion)")
    p.add_argument("--cqt-precision", default=None,
                   choices=["highest", "bf16x3", "default"],
                   help="CQT frame-GEMM precision tier: 'default' is one "
                        "bf16 pass, with rare gate flips "
                        "(CQTConfig.precision)")
    p.add_argument("--cqt-split", default=None,
                   choices=["auto", "off"],
                   help="zero-support split of the CQT's GEMM "
                        "(CQTConfig.gemm_split; the port's kernels always "
                        "skip exactly-zero terms, so it is validated only)")
    p.add_argument("--augment", action="store_true", default=None,
                   help="enable the spectrogram augmentation suite "
                        "(OptimConfig.augment; ViT_engine.py:28-93 "
                        "equivalents)")
    p.add_argument("--augment-prob", type=float, default=None,
                   help="per-window augmentation probability "
                        "(OptimConfig.augment_prob, default 0.5; "
                        "implies --augment)")
    p.add_argument("--seed", type=int, default=None,
                   help="training seed (OptimConfig.seed: init, dropout, "
                        "augmentation and synthetic-data streams; the "
                        "data split keeps DataConfig.split_seed)")
    p.add_argument("--eval-only", action="store_true",
                   help="skip training: restore the checkpoint from "
                        "--checkpoint-dir and run validation + test on "
                        "the standard split (reference equivalent: the "
                        "final test_model pass, bestengine.py:1090-1093, "
                        "without retraining); honors --report-dir")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    return p


def make_config(args):
    from ..config import (
        RECIPES,
        ModelConfig,
        TrainConfig,
        train_config_from_json,
    )

    # Precedence (as the JAX CLI, tests/test_cli_config.py): the base
    # config comes from exactly ONE of --config / --recipe / --arch
    # (conflicts are errors, never silent); explicit flags then override
    # individual fields of that base.
    if args.recipe is not None and args.arch is not None:
        raise SystemExit("--recipe implies an arch; pass one or the other")
    if args.config and args.recipe is not None:
        raise SystemExit(
            "--config and --recipe both define a full base config; pass "
            "one or the other (flags like --epochs still override fields)"
        )
    if args.config and args.arch is not None:
        raise SystemExit(
            "--config already pins the arch; pass one or the other"
        )
    if args.config:
        with open(args.config) as f:
            cfg = train_config_from_json(f.read())
    elif args.recipe is not None:
        cfg = RECIPES[args.recipe]()
    elif args.arch in ("vit_s8", "vit_native"):
        cfg = TrainConfig.vit_default()
        if args.arch != cfg.model.arch:
            cfg = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, arch=args.arch)
            )
    else:
        arch = args.arch or "resnet18"
        cfg = TrainConfig.cnn_default()
        if arch != cfg.model.arch:
            cfg = dataclasses.replace(cfg, model=ModelConfig(arch=arch))
    optim = cfg.optim
    if args.epochs is not None:
        optim = dataclasses.replace(optim, epochs=args.epochs)
    if args.learning_rate is not None:
        optim = dataclasses.replace(optim, learning_rate=args.learning_rate)
    if args.augment:
        optim = dataclasses.replace(optim, augment=True)
    if args.augment_prob is not None:
        # a probability is explicit intent: it implies --augment, so
        # `--augment-prob 0.9` alone cannot silently train unaugmented
        optim = dataclasses.replace(
            optim, augment=True, augment_prob=args.augment_prob
        )
    if args.seed is not None:
        optim = dataclasses.replace(optim, seed=args.seed)
    data = cfg.data
    if args.batch_size is not None:
        data = dataclasses.replace(data, batch_size=args.batch_size)
    model = cfg.model
    if args.stem_fusion is not None:
        model = dataclasses.replace(model, stem_fusion=args.stem_fusion)
    if args.bn_fusion is not None:
        model = dataclasses.replace(model, bn_fusion=args.bn_fusion)
    cqt = cfg.cqt
    if args.cqt_precision is not None:
        cqt = dataclasses.replace(cqt, precision=args.cqt_precision)
    if args.cqt_split is not None:
        cqt = dataclasses.replace(cqt, gemm_split=args.cqt_split)
    return dataclasses.replace(
        cfg, optim=optim, data=data, model=model, cqt=cqt,
        checkpoint_dir=args.checkpoint_dir,
    )


def synthetic_loaders(cfg, num_tracks: int, device=None):
    """Render tracks -> CQT features on ``device`` (the card unless the
    caller asks for the CPU) + window labels -> loaders.  Each track's
    windows (hop = the window length) go through the CQT in one call; the
    features come back to the host as float32 for the loaders."""
    import torch

    from ..data.guitarset import ArrayDataset, ArrayLoader, torch_random_split_indices
    from ..data.synthetic import make_synthetic_dataset
    from ..device import resolve_device
    from ..labels.jams_io import parse_jams
    from ..labels.tablature import tablature_first_fit_window
    from ..ops.cqt import CQTFrontend
    from ..ops.framing import frame_track

    dev = resolve_device(device)
    frontend = CQTFrontend(cfg.cqt)
    rng = np.random.default_rng(cfg.optim.seed)
    tracks = make_synthetic_dataset(rng, num_tracks, duration=4.0, cfg=cfg.cqt)

    feats_list, labels_list = [], []
    hop = cfg.cqt.window_samples  # non-overlapping 0.2 s grid (fixture grid)
    for track in tracks:
        windows = np.array(frame_track(track["audio"], cfg.cqt, hop_samples=hop))
        with torch.no_grad():
            feats = frontend(torch.from_numpy(windows).to(dev))
        feats_list.append(feats.float().cpu().numpy())
        jam = parse_jams(track["jams"])
        for i in range(len(windows)):
            start = i * cfg.cqt.window_seconds
            # the shipped-fixture label convention (first-fit pooling),
            # argmaxed like the reference loaders (my_dataloader.py:40-44)
            tab = tablature_first_fit_window(jam, start, cfg.cqt.window_seconds)
            labels_list.append(np.argmax(tab, axis=-1).astype(np.int32))
    features = np.concatenate(feats_list)
    labels = np.stack(labels_list)
    dataset = ArrayDataset(features, labels)
    tr, va, te = torch_random_split_indices(
        len(features), (0.8, 0.1, 0.1), cfg.data.split_seed
    )
    batch = min(cfg.data.batch_size, max(8, len(tr) // 4))

    def make(idx, shuffle):
        return ArrayLoader(dataset, idx, batch, shuffle=shuffle, seed=cfg.data.shuffle_seed)

    return make(tr, True), make(va, False), make(te, False)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = make_config(args)
    if args.report_dir:  # before training, not after it
        import importlib.util

        if importlib.util.find_spec("matplotlib") is None:
            raise SystemExit("--report-dir needs matplotlib, which is not installed")

    import torch

    from ..device import resolve_device
    from ..utils.logging import MetricsLogger

    device = resolve_device(args.device)
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    logger = MetricsLogger(os.path.join(cfg.checkpoint_dir, "train_log.jsonl"))
    # --debug-nans: anomaly mode for this run only (set_detect_anomaly
    # restores the previous mode when the block ends)
    debug = torch.autograd.set_detect_anomaly(True) if args.debug_nans else contextlib.nullcontext()
    try:
        with debug:
            return _run(args, cfg, device, logger)
    finally:
        logger.close()


def _run(args, cfg, device, logger) -> int:
    import torch

    from ..data.guitarset import create_dataloaders
    from ..models.tabnet import build_model
    from ..utils.profiling import trace
    from .checkpoint import Checkpointer, CheckpointMismatchError, OrbaxCheckpointError
    from .engine import create_train_state, make_eval_step, model_input_shape, test_model
    from .engine import train_model, validate_model

    if args.synthetic:
        train_loader, val_loader, test_loader = synthetic_loaders(
            cfg, args.synthetic_tracks, device
        )
    else:
        if not (args.features and args.labels):
            raise SystemExit("--features and --labels required (or --synthetic)")
        train_loader, val_loader, test_loader = create_dataloaders(
            args.features, args.labels, cfg.data.batch_size, config=cfg.data
        )

    ckpt = Checkpointer(cfg.checkpoint_dir, cfg.checkpoint_name)

    def eval_step_of(model, loader):
        return make_eval_step(
            model, preprocess_for(cfg, loader), smoothing=cfg.optim.label_smoothing,
        )

    if args.eval_only:
        if not ckpt.exists():
            raise SystemExit(f"--eval-only: no checkpoint in {cfg.checkpoint_dir}")
        model = build_model(
            cfg.model, generator=torch.Generator().manual_seed(cfg.optim.seed),
            input_shape=model_input_shape(next(iter(val_loader))),
        )
        state = create_train_state(model, cfg.optim, device)
        try:
            state, _ = ckpt.restore(state, expect_model=dataclasses.asdict(cfg.model))
        except (CheckpointMismatchError, OrbaxCheckpointError) as e:
            raise SystemExit(f"--eval-only: {e}")
        eval_step = eval_step_of(model, val_loader)
        val = validate_model(state, eval_step, val_loader)
        test = test_model(state, eval_step, test_loader)
        logger.log(
            "eval_only", val_loss=val["loss"], accuracy=test["accuracy"],
            per_string=test["per_string_accuracy"],
        )
        print(json.dumps({
            "test_accuracy": test["accuracy"],
            "per_string": test["per_string_accuracy"].tolist(),
            "val_loss": val["loss"],
            "val_accuracy": val["accuracy"],
            "checkpoint_step": int(state.step),
        }))
        if args.report_dir:
            history = {"epochs": [], "train_loss": [], "val_loss": [],
                       "val_accuracy": [], "lr": [], "best_val_loss": val["loss"]}
            write_report(args.report_dir, history, state, cfg, test_loader)
        return 0

    on_epoch_end = None
    if args.report_every:
        if not args.report_dir:
            raise SystemExit("--report-every requires --report-dir")
        on_epoch_end = make_periodic_reporter(
            args.report_dir, args.report_every, cfg, val_loader
        )

    try:
        with trace(args.profile_dir):
            state, history = train_model(
                train_loader, val_loader, cfg, checkpointer=ckpt,
                resume=args.resume, log=lambda s: logger.log("epoch", msg=s),
                on_epoch_end=on_epoch_end, device=device,
            )
    except (CheckpointMismatchError, OrbaxCheckpointError) as e:
        raise SystemExit(f"--resume: {e}")

    test = test_model(state, eval_step_of(state.model, test_loader), test_loader)
    logger.log(
        "test", accuracy=test["accuracy"],
        per_string=test["per_string_accuracy"],
    )
    print(json.dumps({
        "test_accuracy": test["accuracy"],
        "per_string": test["per_string_accuracy"].tolist(),
        "best_val_loss": history["best_val_loss"],
    }))
    if args.report_dir:
        write_report(args.report_dir, history, state, cfg, test_loader)
    return 0


def preprocess_for(cfg, loader):
    """The model-input preprocess for ``loader``'s batches: the input kind
    follows the rank of its first batch's features (rank 4: PNG renders),
    as at ``train/run.py:258-262,319-321,358-359`` of the JAX package."""
    from .engine import input_kind_of, make_preprocess

    kind = input_kind_of(next(iter(loader))["features"])
    return make_preprocess(cfg.model, cfg.data.image_size, kind)


def predict(state, preprocess, loader) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Eval-mode argmax frets of ``state.model`` over ``loader`` on the
    state's device: (preds [N, 6], targets [N, 6], the first batch's
    features [<= 8, F, T]), padded rows (weight 0) left out.  The model's
    mode is restored afterwards, so a reporter called between epochs leaves
    BatchNorm and dropout in train mode."""
    import torch

    model = state.model
    dev = state.params.device
    was_training = model.training
    model.eval()
    preds, targets, feats0 = [], [], None
    try:
        with torch.no_grad():
            for batch in loader:
                feats = torch.as_tensor(batch["features"]).to(dev)
                p = model(preprocess(feats)).argmax(-1).cpu().numpy()
                weights = batch.get("weights")
                mask = (np.ones(p.shape[0], bool) if weights is None
                        else np.asarray(weights)[:, 0] > 0)
                preds.append(p[mask])
                targets.append(np.asarray(batch["labels"])[mask])
                if feats0 is None:
                    feats0 = np.asarray(batch["features"])[mask][:8]
    finally:
        model.train(was_training)
    return np.concatenate(preds), np.concatenate(targets), feats0


def make_periodic_reporter(report_dir, every: int, cfg, val_loader):
    """Mid-training artifact emitter for ``--report-every N``: every N
    epochs, write the metric curves so far plus validation confusion
    matrices (epoch-stamped filenames).  Reference behavior: metric plots
    every 5 epochs (bestengine.py:1006-1007) and confusion matrices during
    every validation pass (ViT_engine.py:473)."""
    from ..report import plot_confusion_matrices, plot_training_metrics
    from .metrics import confusion_matrices

    os.makedirs(report_dir, exist_ok=True)
    preprocess = preprocess_for(cfg, val_loader)

    def on_epoch_end(epoch, history, state):
        if (epoch + 1) % every:
            return
        preds, targets, _ = predict(state, preprocess, val_loader)
        tag = f"epoch{epoch + 1:03d}"
        plot_training_metrics(history, os.path.join(report_dir, f"training_metrics_{tag}.png"))
        cm = confusion_matrices(preds, targets).numpy()
        plot_confusion_matrices(cm, os.path.join(report_dir, f"confusion_matrices_{tag}.png"))

    return on_epoch_end


def report_data(state, cfg, loader) -> dict:
    """What the report plots, computed with ``state.model`` in eval mode on
    the state's device: ``preds`` and ``targets`` [N, 6] (padded rows left
    out), ``features`` (the first batch's, at most 8), ``confusion``
    [6, 19, 19], ``fret_accuracy`` and ``fret_support`` [6, 19]."""
    from .metrics import confusion_matrices, per_fret_accuracy

    preds, targets, feats0 = predict(state, preprocess_for(cfg, loader), loader)
    cm = confusion_matrices(preds, targets).numpy()
    acc, support = per_fret_accuracy(cm)
    return {"preds": preds, "targets": targets, "features": feats0, "confusion": cm,
            "fret_accuracy": acc, "fret_support": support}


def write_report(report_dir, history, state, cfg, test_loader) -> dict:
    """Emit the full visualization artifact suite (reference C13 set) for
    ``state.model`` on the test loader.  Returns :func:`report_data`'s
    arrays, which it plotted, and each artifact's ``paths``."""
    from ..report import (
        plot_confusion_matrices,
        plot_correct_incorrect_distribution,
        plot_model_architecture,
        plot_per_fret_accuracy,
        plot_prediction_overlay,
        plot_sample_inputs,
        plot_training_metrics,
    )

    os.makedirs(report_dir, exist_ok=True)
    data = report_data(state, cfg, test_loader)
    preds, targets, feats0 = data["preds"], data["targets"], data["features"]

    def path(name):
        return os.path.join(report_dir, name)

    paths = [
        plot_training_metrics(history, path("training_metrics.png")),
        plot_sample_inputs(feats0, path("sample_inputs.png"), labels=targets[:8]),
        plot_prediction_overlay(feats0, preds[:8], targets[:8], path("prediction_overlay.png")),
        plot_correct_incorrect_distribution(preds, targets, path("correct_incorrect.png")),
        plot_confusion_matrices(data["confusion"], path("confusion_matrices.png")),
        plot_per_fret_accuracy(data["fret_accuracy"], data["fret_support"],
                               path("fret_accuracy.png")),
        plot_model_architecture(state.model, path("model_architecture.png")),
    ]
    return {**data, "paths": paths}


if __name__ == "__main__":
    sys.exit(main())
