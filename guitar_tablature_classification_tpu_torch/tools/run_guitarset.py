"""One-shot GuitarSet runbook: WAV + JAMS directories in, trained model +
BASELINE.md metric table out (the JAX repo's ``tools/run_guitarset.py``).

Reproducing the reference recipe (bestengine.py:1019-1093 + README
methodology) on the card is ONE command:

    python -m guitar_tablature_classification_tpu_torch.tools.run_guitarset \
        --audio /data/guitarset/audio \
        --annotation /data/guitarset/annotation \
        --workdir /data/guitarset/work \
        [--fixtures tablatures/]      # use the shipped labels instead of
                                      # regenerating from JAMS
        [--device cpu]                # the CPU instead of the card

Steps (each idempotent; re-runs reuse what exists in --workdir):
  1. pair every ``.jams`` with its WAV (GuitarSet naming variants probed,
     jam_to_tablature.py:358-367 semantics),
  2. batched CQT on the card (the fused CQT kernel) over the
     non-overlapping 0.2 s label grid, fixture-named
     ``{jams_base}_segment_{rank}_{start:.2f}.npy``,
  3. labels: the shipped fixtures (``--fixtures``) or regeneration via
     the label extractor (jam_to_tablature.py:55-178 semantics),
  4. feature/label filename-parity audit (the pairing contract of
     my_dataloader.py:10-13); divergences are listed and the paired
     intersection is materialized so training still proceeds,
  5. train + eval via the port's training CLI (train.run), printing the
     per-string accuracy table against the published baseline
     (CNN_firstTry_.pdf p.3 — BASELINE.md).

Steps 2 and 4 print their seconds.  ``make_synthetic_guitarset`` renders
a GuitarSet-shaped tree to run it on.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

# Published reference baseline (CNN_firstTry_.pdf p.3, see BASELINE.md).
BASELINE_PER_STRING = (82.03, 75.96, 71.65, 72.49, 78.02, 83.64)


def extract_features(
    jams_files: list[str], audio_dir: str, out_dir: str, cqt_cfg=None,
    batch_size: int = 512, device=None,
) -> tuple[int, list[str]]:
    """Fixture-named CQT features on the 0.2 s label grid, keyed by each
    JAMS file's base name (so features pair 1:1 by filename with labels
    produced from the same JAMS), computed on ``device`` (the card unless
    the caller asks for the CPU)."""
    import dataclasses

    from ..config import CQTConfig
    from ..data.audio import load_audio
    from ..labels.extractor import find_audio_for_jams
    from ..ops.cqt import CQTFrontend
    from ..ops.extract import extract_windows
    from ..ops.framing import frame_track

    cfg = cqt_cfg or CQTConfig()
    # non-overlapping windows: the shipped fixtures walk a 0.2 s grid
    cfg = dataclasses.replace(cfg, hop_seconds=cfg.window_seconds)
    frontend = CQTFrontend(cfg)
    os.makedirs(out_dir, exist_ok=True)
    written, missing_audio = 0, []
    for rank, jams_path in enumerate(jams_files):
        base = os.path.splitext(os.path.basename(jams_path))[0]
        wav = find_audio_for_jams(audio_dir, base)
        if wav is None:
            missing_audio.append(base)
            continue
        audio, _ = load_audio(wav, sample_rate=cfg.sample_rate)
        windows = frame_track(audio, cfg, hop_samples=cfg.hop_samples)
        feats = extract_windows(frontend, windows, batch_size=batch_size, device=device)
        for k in range(feats.shape[0]):
            start = k * cfg.window_seconds
            np.save(
                os.path.join(
                    out_dir, f"{base}_segment_{rank}_{start:.2f}.npy"
                ),
                feats[k],
            )
            written += 1
    return written, missing_audio


def audit_pairing(features_dir: str, labels_dir: str, workdir: str):
    """Filename-parity audit; on divergence, materialize the paired
    intersection so sorted-order pairing (my_dataloader.py:10-13) is
    guaranteed correct."""
    feats = {f for f in os.listdir(features_dir) if f.endswith(".npy")}
    labels = {f for f in os.listdir(labels_dir) if f.endswith(".npy")}
    if feats == labels:
        print(f"pairing audit: {len(feats)} feature/label pairs, exact match")
        return features_dir, labels_dir
    only_f, only_l = sorted(feats - labels), sorted(labels - feats)
    common = sorted(feats & labels)
    print(
        f"pairing audit: {len(common)} paired, {len(only_f)} feature-only, "
        f"{len(only_l)} label-only"
    )
    for name in only_f[:5]:
        print(f"  feature without label: {name}")
    for name in only_l[:5]:
        print(f"  label without feature: {name}")
    if not common:
        raise SystemExit("no paired feature/label files — check naming")
    fdir = os.path.join(workdir, "paired_features")
    ldir = os.path.join(workdir, "paired_labels")
    for d, src, names in ((fdir, features_dir, common), (ldir, labels_dir, common)):
        os.makedirs(d, exist_ok=True)
        for name in names:
            dst = os.path.join(d, name)
            if not os.path.exists(dst):
                try:
                    os.link(os.path.join(src, name), dst)
                except OSError:
                    shutil.copy2(os.path.join(src, name), dst)
    return fdir, ldir


def print_table(result: dict) -> None:
    per = [100.0 * a for a in result["per_string"]]
    mean = float(np.mean(per))
    base_mean = float(np.mean(BASELINE_PER_STRING))
    print()
    print("per-string test accuracy vs published baseline "
          "(CNN_firstTry_.pdf p.3):")
    print("  string |    this run | reference |   delta")
    for i, (got, ref) in enumerate(zip(per, BASELINE_PER_STRING), 1):
        print(f"       {i} | {got:10.2f}% | {ref:8.2f}% | {got - ref:+6.2f}")
    print(f"    mean | {mean:10.2f}% | {base_mean:8.2f}% | "
          f"{mean - base_mean:+6.2f}")
    print(f"best val loss: {result['best_val_loss']:.4f} "
          f"(reference: 0.8282)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="run-guitarset", description=__doc__.split("\n\n")[0],
    )
    p.add_argument("--audio", required=True, help="GuitarSet WAV dir")
    p.add_argument("--annotation", required=True, help="GuitarSet JAMS dir")
    p.add_argument("--workdir", required=True,
                   help="features/labels/checkpoints land here")
    p.add_argument("--fixtures", default=None,
                   help="use this shipped tablatures/ dir as labels "
                        "instead of regenerating from JAMS")
    p.add_argument("--arch", default=None)
    p.add_argument("--recipe", default=None,
                   help="named preset (config.RECIPES, e.g. native-best, "
                        "vit-small-data) instead of --arch; its training "
                        "hyperparameters apply unless overridden here")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--cqt-batch", type=int, default=512)
    p.add_argument("--augment", action="store_true",
                   help="enable the spectrogram augmentation suite "
                        "(passed through to train.run)")
    p.add_argument("--seed", type=int, default=None,
                   help="training seed (passed through to train.run)")
    p.add_argument("--report-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the extraction and the training "
                        "(default cuda; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)

    if args.recipe is not None and args.arch is not None:
        raise SystemExit("--recipe implies an arch; pass one or the other")
    if args.recipe is None:
        # historical runbook defaults (the reference recipe's literals)
        args.arch = args.arch or "resnet18_native"
        args.epochs = 20 if args.epochs is None else args.epochs
        args.batch_size = 64 if args.batch_size is None else args.batch_size
        args.learning_rate = (
            5e-4 if args.learning_rate is None else args.learning_rate
        )

    from ..labels.extractor import GuitarTablatureExtractor
    from ..train.run import main as train_main

    os.makedirs(args.workdir, exist_ok=True)
    jams_files = sorted(
        os.path.join(args.annotation, f)
        for f in os.listdir(args.annotation)
        if f.endswith(".jams")
    )
    if not jams_files:
        raise SystemExit(f"no .jams files in {args.annotation}")
    print(f"[1/4] {len(jams_files)} JAMS files")

    features_dir = os.path.join(args.workdir, "features")
    if os.path.isdir(features_dir) and os.listdir(features_dir):
        print(f"[2/4] features exist in {features_dir}, reusing")
    else:
        t0 = time.perf_counter()
        written, missing = extract_features(
            jams_files, args.audio, features_dir, batch_size=args.cqt_batch,
            device=args.device,
        )
        seconds = time.perf_counter() - t0
        print(f"[2/4] wrote {written} CQT feature files in {seconds:.2f} s "
              f"({written / seconds:.0f} windows/s)")
        for base in missing[:10]:
            print(f"  WARNING: no audio found for {base}")

    if args.fixtures:
        labels_dir = args.fixtures
        print(f"[3/4] using shipped label fixtures: {labels_dir}")
    else:
        labels_dir = os.path.join(args.workdir, "labels")
        if os.path.isdir(labels_dir) and os.listdir(labels_dir):
            print(f"[3/4] labels exist in {labels_dir}, reusing")
        else:
            ex = GuitarTablatureExtractor(args.annotation, labels_dir)
            stats = ex.process_all_files()
            print(
                f"[3/4] generated {stats.total_segments} labels "
                f"({len(stats.errors)} errors)"
            )

    features_dir, labels_dir = audit_pairing(
        features_dir, labels_dir, args.workdir
    )

    print("[4/4] training...")
    ckpt_dir = os.path.join(args.workdir, "checkpoints")
    train_argv = [
        "--features", features_dir,
        "--labels", labels_dir,
        "--checkpoint-dir", ckpt_dir,
        "--device", args.device,
    ]
    if args.recipe is not None:
        train_argv += ["--recipe", args.recipe]
    else:
        train_argv += ["--arch", args.arch]
    for flag, val in (
        ("--epochs", args.epochs),
        ("--batch-size", args.batch_size),
        ("--learning-rate", args.learning_rate),
        ("--seed", args.seed),
    ):
        if val is not None:
            train_argv += [flag, str(val)]
    if args.augment:
        train_argv += ["--augment"]
    if args.report_dir:
        train_argv += ["--report-dir", args.report_dir]

    import contextlib
    import io

    buf = io.StringIO()
    outer = sys.stdout  # the training CLI's lines go on to the caller's stdout

    class Tee(io.TextIOBase):
        def write(self, s):
            buf.write(s)
            outer.write(s)
            return len(s)

        def flush(self):
            outer.flush()

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(Tee()):
        rc = train_main(train_argv)
    if rc != 0:
        return rc
    print(f"[4/4] trained in {time.perf_counter() - t0:.2f} s")
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    print_table(result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
