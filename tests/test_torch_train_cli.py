"""The port's train CLI (``train.run``), the serving CLI's checkpoint
``--model``, augmentation and the port's bench, on the CPU.

``make_config`` is held to the JAX CLI's for the flag sets of
tests/test_cli_config.py (the same TrainConfig dict).  ``main`` trains on
synthetic data, resumes and evaluates; the augmentation draws from the
step's generator (its stream differs from ``jax.random``'s), so its tests
hold invariants, not bits.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu.config import TrainConfig as JaxTrainConfig
from guitar_tablature_classification_tpu.config import to_json
from guitar_tablature_classification_tpu.train import run as jax_run
from guitar_tablature_classification_tpu_torch import bench
from guitar_tablature_classification_tpu_torch.infer import cli
from guitar_tablature_classification_tpu_torch.ops import augment
from guitar_tablature_classification_tpu_torch.train import run


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the suite runs in six processes at once,
    and PyTorch's default of one spinning thread per core in each makes
    them fight for the cores (3.5x the wall time of these files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

FLAG_SETS = [
    ["--synthetic"],
    ["--synthetic", "--arch", "resnet18", "--stem-fusion", "fused", "--bn-fusion", "on",
     "--cqt-precision", "default", "--cqt-split", "off"],
    ["--synthetic", "--recipe", "vit-small-data", "--augment", "--augment-prob", "0.3"],
    ["--synthetic", "--augment-prob", "0.9"],
    ["--synthetic", "--seed", "43"],
    ["--synthetic", "--arch", "vit_native"],
    ["--synthetic", "--arch", "vit_s8"],
    ["--synthetic", "--arch", "resnet18_native", "--learning-rate", "1e-3"],
    ["--synthetic", "--recipe", "native-best"],
    ["--synthetic", "--recipe", "vit-reference", "--checkpoint-dir", "ck"],
    ["--synthetic", "--recipe", "cnn-reference"],
    ["--synthetic", "--recipe", "native-best", "--batch-size", "64",
     "--cqt-precision", "highest", "--epochs", "3"],
]
CONFLICTS = [
    (["--synthetic", "--recipe", "native-best", "--arch", "vit_s8"], "recipe"),
    (["--config", "{cfg}", "--recipe", "native-best"], "recipe"),
    (["--config", "{cfg}", "--arch", "small_cnn"], "arch"),
]


def _make(mod, argv):
    return mod.make_config(mod.build_parser().parse_args(argv))


@pytest.mark.parametrize("argv", FLAG_SETS, ids=lambda a: " ".join(a[1:]) or "default")
def test_make_config_matches_jax(argv):
    got, want = _make(run, argv), _make(jax_run, argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_config_file_and_conflicts_match_jax(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(to_json(JaxTrainConfig.cnn_default()))
    argv = ["--config", str(path), "--epochs", "2"]
    assert dataclasses.asdict(_make(run, argv)) == dataclasses.asdict(_make(jax_run, argv))
    for argv, match in CONFLICTS:
        argv = [a.format(cfg=path) for a in argv]
        with pytest.raises(SystemExit, match=match) as got:
            _make(run, argv)
        with pytest.raises(SystemExit) as want:
            _make(jax_run, argv)
        assert str(got.value) == str(want.value)


def test_parser_keeps_every_jax_flag():
    port = {a.dest for a in run.build_parser()._actions}
    jax_flags = {a.dest for a in jax_run.build_parser()._actions}
    assert port - jax_flags == {"device"}
    assert jax_flags <= port


@pytest.mark.parametrize("flag", [["--report-every", "2"], ["--report-every", "1", "--epochs", "1"]])
def test_report_flags_are_refused_by_name(flag, tmp_path):
    """--report-every without --report-dir exits with the JAX CLI's message
    (the report flags themselves run: tests/test_torch_report.py)."""
    with pytest.raises(SystemExit, match="--report-every requires --report-dir"):
        run.main(["--synthetic", "--synthetic-tracks", "1", "--device", "cpu",
                  "--checkpoint-dir", str(tmp_path), *flag])


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def test_main_trains_resumes_and_evaluates(tmp_path, capsys):
    """Two epochs of native-best on two synthetic tracks, a resume to three
    (it starts at epoch 3), then --eval-only from the checkpoint; the
    serving CLI transcribes from the same checkpoint directory."""
    ck = str(tmp_path / "ck")
    base = ["--synthetic", "--synthetic-tracks", "2", "--recipe", "native-best",
            "--device", "cpu", "--checkpoint-dir", ck]
    assert run.main([*base, "--epochs", "2"]) == 0
    out = _lines(capsys)
    assert sum(" epoch: msg=epoch " in ln for ln in out) == 2
    final = json.loads(out[-1])
    assert set(final) == {"test_accuracy", "per_string", "best_val_loss"}
    assert len(final["per_string"]) == 6 and np.isfinite(final["best_val_loss"])

    saved = json.load(open(os.path.join(ck, "best_guitar_tab_model.meta.json")))
    assert run.main([*base, "--epochs", "3", "--resume"]) == 0
    out = _lines(capsys)
    # the run goes on after the checkpoint's (best) epoch, from its step
    assert any(f"resumed from epoch {saved['epoch'] + 1} (step {saved['step']})" in ln
               for ln in out)
    epochs = [ln.split("msg=")[1].split(":")[0] for ln in out if " epoch: msg=epoch " in ln]
    assert epochs[0] == f"epoch {saved['epoch'] + 2}/3" and epochs[-1] == "epoch 3/3"
    meta = json.load(open(os.path.join(ck, "best_guitar_tab_model.meta.json")))

    assert run.main([*base, "--eval-only"]) == 0
    evaluated = json.loads(_lines(capsys)[-1])
    assert evaluated["checkpoint_step"] == meta["step"] > 0
    assert np.isclose(evaluated["val_loss"], meta["metrics"]["loss"], rtol=1e-6)
    log = [json.loads(ln) for ln in open(os.path.join(ck, "train_log.jsonl"))]
    assert [r["event"] for r in log].count("eval_only") == 1

    with pytest.raises(SystemExit, match="no checkpoint"):
        run.main([*base, "--eval-only", "--checkpoint-dir", str(tmp_path / "empty")])


def _wav(path, seconds=1.0):
    from scipy.io import wavfile

    audio = np.random.default_rng(0).standard_normal(int(44100 * seconds)) * 3000
    wavfile.write(path, 44100, audio.astype(np.int16))
    return path


def test_serving_cli_takes_the_trainers_checkpoint(tmp_path, capsys):
    """--model takes the checkpoint's name in its directory or its .pt
    file; another arch exits with the named mismatch (as the JAX CLI's
    test_transcribe_cli_checkpoint_mismatch expects of the JAX CLI); the
    bare directory is no checkpoint and exits too."""
    ck = str(tmp_path / "ck")
    assert run.main(["--synthetic", "--synthetic-tracks", "1", "--arch", "resnet18_native",
                     "--epochs", "1", "--device", "cpu", "--checkpoint-dir", ck]) == 0
    wav = _wav(str(tmp_path / "x.wav"))
    out = str(tmp_path / "x_tab.txt")
    name = os.path.join(ck, "best_guitar_tab_model")
    assert cli.main([wav, "--arch", "resnet18_native", "--model", name, "--device", "cpu",
                     "--output", out]) == 0
    assert sum(ln[:2] in ("e|", "E|") for ln in open(out)) == 2
    logits = []
    for model in (name, name + ".pt"):
        args = cli.build_parser().parse_args(["x.wav", "--arch", "resnet18_native",
                                              "--model", model, "--device", "cpu"])
        t = cli.load_transcriber(args)
        logits.append(t.predict_windows(np.zeros((2, 8820), np.float32)))
    assert np.array_equal(logits[0], logits[1])
    for argv, match in ((["--arch", "resnet18", "--model", name], "resnet18_native"),
                        (["--recipe", "vit-small-data", "--model", name], "vit_native"),
                        (["--model", ck], "neither a reference-layout")):
        args = cli.build_parser().parse_args(["x.wav", *argv, "--device", "cpu"])
        with pytest.raises(SystemExit, match=match):
            cli.load_transcriber(args)
    capsys.readouterr()


def test_augment_invariants():
    """Deterministic for a seed; probability 0 is the identity; at
    probability 1 every sample draws 1-3 transforms (a time shift of
    +-10 % of 9 frames truncates to 0, so a sample may still come out
    equal); each mask zeroes one contiguous span within its width."""
    x = torch.randn(512, 96, 9)
    g = torch.Generator().manual_seed(0)
    assert torch.equal(augment.augment_batch(g, x, 0.0), x)
    a = augment.augment_batch(torch.Generator().manual_seed(1), x, 0.5)
    b = augment.augment_batch(torch.Generator().manual_seed(1), x, 0.5)
    assert torch.equal(a, b) and a.shape == x.shape and a.dtype == x.dtype
    changed = (a != x).flatten(1).any(1).float().mean()
    assert 0.35 < float(changed) < 0.57  # 0.5 * 11/12 expected
    ones = torch.ones(4000, 7, 30)
    u = torch.rand(4000, 2, generator=torch.Generator().manual_seed(2))
    keep = augment._span_keep(7, 5, u[:, 0], u[:, 1], "cpu")
    widths = (~keep).sum(1)
    assert widths.min() == 1 and widths.max() == 5
    assert set(widths.tolist()) == {1, 2, 3, 4, 5}
    starts = (~keep).float().argmax(1)
    assert torch.equal((~keep).sum(1), ((~keep).cumsum(1).max(1).values))
    assert bool(((starts + widths) <= 7).all())
    masked = augment.frequency_mask(ones, keep)
    assert torch.equal(masked.sum((1, 2)), 30 * (7 - widths).float())
    shifted = augment.time_shift(torch.arange(30.0).expand(2, 7, 30),
                                 torch.tensor([1.0, 0.0]), shift_range=0.5)
    assert shifted[0, 0, 0] == 15 and shifted[0, 0, -1] == 0  # later frames, zero tail
    assert shifted[1, 0, 0] == 0 and shifted[1, 0, -1] == 14  # earlier frames, zero head
    noisy = augment.add_noise(ones, torch.randn(ones.shape, generator=g))
    assert abs(float((noisy - ones).std()) - 0.005) < 2e-4


def test_train_step_augments_from_the_step_generator():
    """make_train_step's augment hook gets the step's generator and the
    [B, F, T] features before preprocess."""
    from guitar_tablature_classification_tpu_torch.config import ModelConfig, OptimConfig
    from guitar_tablature_classification_tpu_torch.models import build_model
    from guitar_tablature_classification_tpu_torch.train import (
        create_train_state,
        make_preprocess,
        make_train_step,
    )

    cfg = ModelConfig(arch="resnet18_native", dtype="float32")
    model = build_model(cfg)
    state = create_train_state(model, OptimConfig(), device="cpu")
    calls = []

    def spy(generator, feats):
        calls.append((generator, tuple(feats.shape)))
        return feats

    step = make_train_step(model, make_preprocess(cfg), augment=spy)
    gen = torch.Generator().manual_seed(0)
    batch = {"features": torch.full((2, 96, 9), -40.0), "labels": torch.zeros(2, 6, dtype=torch.int32)}
    step(state, batch, gen, 1e-4)
    assert calls == [(gen, (2, 96, 9))]


def test_bench_row_on_the_cpu():
    """One bench row at B=2, one step: its keys, a finite loss, and no
    kernel launch (the CPU takes the plain versions)."""
    row = bench.measure_native_variant("default", batch=2, steps=1, device="cpu")
    assert {"value", "step_ms", "host_enqueue_ms", "batch", "cqt_precision", "launches"} <= set(row)
    assert row["batch"] == 2 and row["launches"] == {} and np.isfinite(row["final_loss"])
    assert row["step_ms"] > 0 and row["value"] > 0


def test_bench_main_prints_every_row(capsys, monkeypatch):
    """The whole bench at B=2, one step, on the CPU: one JSON line with
    the root bench's keys and all five rows."""
    monkeypatch.setattr(bench, "run_bench", functools.partial(
        bench.run_bench, batch=2, native_batch=2, steps=1))
    assert bench.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert {"metric", "value", "unit", "vs_baseline", "detail"} <= set(line)
    detail = line["detail"]
    for key in ("native_variant", "native_variant_default_tier",
                "native_variant_default_tier_b8192", "native_serving_default_tier"):
        assert detail[key]["host_enqueue_ms"] > 0, key
    assert detail["native_variant_default_tier_b8192"]["batch"] == 4
    assert detail["step_ms"] > 0 and detail["host_enqueue_ms"] > 0


def test_profile_dir_and_debug_nans(tmp_path, capsys, monkeypatch):
    """--profile-dir writes a torch.profiler trace, with the program's spans
    on the trace's clock, and its ops table; --debug-nans turns anomaly mode
    on for the run only."""
    seen = []
    real = run._run

    def spy(*args):
        seen.append(torch.is_anomaly_enabled())
        return real(*args)

    monkeypatch.setattr(run, "_run", spy)
    assert run.main(["--synthetic", "--synthetic-tracks", "1", "--arch", "resnet18_native",
                     "--epochs", "1", "--device", "cpu", "--debug-nans",
                     "--checkpoint-dir", str(tmp_path / "ck"),
                     "--profile-dir", str(tmp_path / "prof")]) == 0
    assert seen == [True] and not torch.is_anomaly_enabled()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert "convolution" in (tmp_path / "prof" / "ops.txt").read_text()
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    steps = [e for e in events if e.get("cat") == "program_span" and e["name"] == "train.step"]
    assert steps
    for step in steps:  # the step's own ops lie inside it on the trace's clock
        inside = [e for e in ops if step["ts"] <= e["ts"] <= step["ts"] + step["dur"]]
        assert any("convolution" in e["name"] for e in inside)
    capsys.readouterr()


def test_main_trains_on_npy_trees(tmp_path, capsys):
    """--features/--labels: a small tree of per-window .npy files (packed
    on first use beside the labels) trains one epoch; without them or
    --synthetic the CLI exits."""
    rng = np.random.default_rng(0)
    for d in ("features", "labels"):
        os.makedirs(tmp_path / d)
    for i in range(13):
        np.save(tmp_path / "features" / f"seg_{i:02d}.npy",
                rng.uniform(-120, 0, (96, 9)).astype(np.float32))
        np.save(tmp_path / "labels" / f"seg_{i:02d}.npy",
                np.eye(19, dtype=np.int8)[rng.integers(0, 19, 6)])
    argv = ["--arch", "resnet18_native", "--epochs", "1", "--batch-size", "4",
            "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck")]
    assert run.main(["--features", str(tmp_path / "features"),
                     "--labels", str(tmp_path / "labels"), *argv]) == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(final["best_val_loss"]) and len(final["per_string"]) == 6
    assert (tmp_path / "_packed" / "features.npy").exists()
    with pytest.raises(SystemExit, match="--features and --labels required"):
        run.main(argv)
