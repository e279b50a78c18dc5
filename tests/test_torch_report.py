"""The port's visualization suite (``report/plots.py``) and ``train.run``'s
``--report-dir`` / ``--report-every``, on the CPU.

Every artifact renders (after tests/test_report.py); the parameter counts
equal the Flax models'; ``write_report``'s confusion matrices and per-fret
accuracy on a converted model equal those the JAX package computes from the
Flax model's argmax on the same weights and test batches (samples whose top
two logits lie within 1e-5 on some string are left out of the batches: the
two frameworks' fp32 orders may split such a tie either way); and the
periodic reporter leaves training as it was.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu.config import ModelConfig as JaxModelConfig
from guitar_tablature_classification_tpu.models import build_model as jax_build_model
from guitar_tablature_classification_tpu.train import confusion_matrices as jax_confusion
from guitar_tablature_classification_tpu.train import make_preprocess as jax_make_preprocess
from guitar_tablature_classification_tpu.train import per_fret_accuracy as jax_per_fret
from guitar_tablature_classification_tpu_torch.config import (
    DataConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
)
from guitar_tablature_classification_tpu_torch.data.guitarset import ArrayDataset, ArrayLoader
from guitar_tablature_classification_tpu_torch.models import build_model, state_dict_from_flax
from guitar_tablature_classification_tpu_torch.report import (
    parameter_counts,
    plot_confusion_matrices,
    plot_correct_incorrect_distribution,
    plot_model_architecture,
    plot_per_fret_accuracy,
    plot_prediction_overlay,
    plot_sample_inputs,
    plot_training_metrics,
    render_spectrogram_png,
)
from guitar_tablature_classification_tpu_torch.train import (
    confusion_matrices,
    create_train_state,
    per_fret_accuracy,
    train_model,
)
from guitar_tablature_classification_tpu_torch.train import run

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_models import perturbed_variables  # noqa: E402

ARTIFACTS = ("training_metrics.png", "sample_inputs.png", "prediction_overlay.png",
             "correct_incorrect.png", "confusion_matrices.png", "fret_accuracy.png",
             "model_architecture.png")


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_all_plot_artifacts(tmp_path):
    rng = np.random.default_rng(0)
    history = {
        "train_loss": [3.0, 2.0, 1.5], "val_loss": [3.1, 2.2, 1.8],
        "val_accuracy": [0.3, 0.5, 0.6], "lr": [5e-4, 5e-4, 2.5e-4],
        "val_per_string": rng.uniform(0, 1, (3, 6)).tolist(),
    }
    feats = rng.uniform(-120, 0, (8, 96, 9))
    preds = rng.integers(0, 19, (64, 6))
    targets = rng.integers(0, 19, (64, 6))
    cm = confusion_matrices(torch.from_numpy(preds), torch.from_numpy(targets)).numpy()
    assert np.array_equal(cm, np.asarray(jax_confusion(jnp.asarray(preds), jnp.asarray(targets))))
    acc, support = per_fret_accuracy(cm)
    paths = [
        plot_training_metrics(history, str(tmp_path / "metrics.png")),
        plot_sample_inputs(feats, str(tmp_path / "samples.png"), labels=targets[:8]),
        plot_prediction_overlay(feats, preds[:8], targets[:8], str(tmp_path / "overlay.png")),
        plot_correct_incorrect_distribution(preds, targets, str(tmp_path / "dist.png")),
        plot_confusion_matrices(cm, str(tmp_path / "confusion.png")),
        plot_per_fret_accuracy(acc, support, str(tmp_path / "per_fret.png")),
        plot_model_architecture(build_model(ModelConfig(arch="small_cnn")),
                                str(tmp_path / "arch.png")),
        render_spectrogram_png(feats[0], str(tmp_path / "seg.png")),
    ]
    for p in paths:
        assert os.path.getsize(p) > 0


def test_plot_artifacts_edge_cases(tmp_path):
    """Single-epoch history without optional keys, one sample without
    labels, all-correct predictions, frets with zero support."""
    rng = np.random.default_rng(1)
    paths = [plot_training_metrics({"train_loss": [2.0], "val_loss": [2.1], "val_accuracy": [0.4]},
                                   str(tmp_path / "m1.png")),
             plot_sample_inputs(rng.uniform(-120, 0, (1, 96, 9)), str(tmp_path / "s1.png"))]
    preds = rng.integers(0, 19, (16, 6))
    paths.append(plot_correct_incorrect_distribution(preds, preds.copy(), str(tmp_path / "d1.png")))
    cm = confusion_matrices(torch.zeros(16, 6, dtype=torch.long),
                            torch.zeros(16, 6, dtype=torch.long)).numpy()
    acc, support = per_fret_accuracy(cm)
    assert support[:, 1:].sum() == 0
    paths += [plot_confusion_matrices(cm, str(tmp_path / "c1.png")),
              plot_per_fret_accuracy(acc, support, str(tmp_path / "f1.png"))]
    for p in paths:
        assert os.path.getsize(p) > 0


@pytest.mark.parametrize("arch", ["resnet18_native", "small_cnn"])
def test_parameter_counts_equal_flax(arch):
    """Parameters only: BatchNorm's running statistics (Flax batch_stats)
    are not counted."""
    variables = jax.eval_shape(
        lambda x: jax_build_model(JaxModelConfig(arch=arch)).init(
            jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((1, 96, 9, 1), jnp.float32))
    want = {k: sum(int(np.prod(x.shape)) for x in jax.tree.leaves(v))
            for k, v in variables["params"].items()}
    got = parameter_counts(build_model(ModelConfig(arch=arch)))
    assert sum(got.values()) == sum(want.values())
    if arch == "small_cnn":  # the same top-level names
        assert got == want


def _report_case(seed=0, n=40):
    """resnet18_native at fp32 with perturbed BatchNorms: Flax variables,
    and the features, labels and JAX argmax frets of the samples without
    a near tie."""
    jmodel, variables = perturbed_variables("resnet18_native", "float32", seed=seed)
    rng = np.random.default_rng(seed)
    feats = rng.uniform(-120, 0, (n, 96, 9)).astype(np.float32)
    labels = rng.integers(0, 19, (n, 6)).astype(np.int32)
    jpre = jax_make_preprocess(JaxModelConfig(arch="resnet18_native", dtype="float32"))
    logits = np.asarray(jmodel.apply(variables, jpre(jnp.asarray(feats)), train=False))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    keep = (top2[..., 1] - top2[..., 0] > 1e-5).all(axis=1)
    return variables, feats[keep], labels[keep], logits[keep].argmax(-1)


def test_write_report_matches_jax_argmax(tmp_path):
    variables, feats, labels, jax_preds = _report_case()
    assert len(feats) >= 30
    cfg = TrainConfig(model=ModelConfig(arch="resnet18_native", dtype="float32"))
    model = build_model(cfg.model)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    state = create_train_state(model, cfg.optim, device="cpu")
    loader = ArrayLoader(ArrayDataset(feats, labels), np.arange(len(feats)), 8)  # padded last
    history = {"train_loss": [1.0], "val_loss": [1.1], "val_accuracy": [0.1], "lr": [1e-3],
               "val_per_string": [[0.1] * 6]}
    out = run.write_report(str(tmp_path), history, state, cfg, loader)
    assert np.array_equal(out["targets"], labels) and np.array_equal(out["preds"], jax_preds)
    want_cm = np.asarray(jax_confusion(jnp.asarray(jax_preds), jnp.asarray(labels)))
    want_acc, want_support = jax_per_fret(want_cm)
    assert np.array_equal(out["confusion"], want_cm)
    assert np.array_equal(out["fret_accuracy"], np.asarray(want_acc))
    assert np.array_equal(out["fret_support"], np.asarray(want_support))
    assert sorted(os.listdir(tmp_path)) == sorted(ARTIFACTS)
    assert all(os.path.getsize(p) > 0 for p in out["paths"])
    assert model.training  # predict restored the mode it found


def _tiny_cfg(epochs):
    return TrainConfig(model=ModelConfig(arch="resnet18_native"),
                       optim=OptimConfig(epochs=epochs), data=DataConfig(batch_size=8))


def test_periodic_reporter_leaves_training_unchanged(tmp_path):
    """Two epochs with the reporter writing after each against two without:
    the same history (the reporter's eval-mode pass must not leave
    BatchNorm or dropout in eval mode for the next epoch), and the
    epoch-stamped artifacts."""
    cfg = _tiny_cfg(2)
    histories = []
    for report in (True, False):
        train, val, _ = run.synthetic_loaders(cfg, 1, "cpu")
        hook = run.make_periodic_reporter(str(tmp_path), 1, cfg, val) if report else None
        _, history = train_model(train, val, cfg, on_epoch_end=hook, device="cpu",
                                 log=lambda s: None)
        histories.append({k: v for k, v in history.items()
                          if k not in ("epoch_time", "segments_per_sec")})
    assert histories[0] == histories[1] and len(histories[0]["train_loss"]) == 2
    assert sorted(os.listdir(tmp_path)) == [
        f"{kind}_epoch{e:03d}.png" for kind in ("confusion_matrices", "training_metrics")
        for e in (1, 2)]


def test_cli_report_dir_after_training_and_eval_only(tmp_path, capsys):
    ck, rep = str(tmp_path / "ck"), tmp_path / "report"
    base = ["--synthetic", "--synthetic-tracks", "1", "--arch", "small_cnn", "--device", "cpu",
            "--checkpoint-dir", ck]
    assert run.main([*base, "--epochs", "2", "--report-dir", str(rep / "train"),
                     "--report-every", "2"]) == 0
    assert sorted(os.listdir(rep / "train")) == sorted(
        ARTIFACTS + ("training_metrics_epoch002.png", "confusion_matrices_epoch002.png"))
    assert run.main([*base, "--eval-only", "--report-dir", str(rep / "eval")]) == 0
    assert sorted(os.listdir(rep / "eval")) == sorted(ARTIFACTS)
    capsys.readouterr()


def test_report_dir_without_matplotlib_exits_before_training(tmp_path, monkeypatch):
    import importlib.util

    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else find_spec(name, *a))
    with pytest.raises(SystemExit, match="--report-dir needs matplotlib"):
        run.main(["--synthetic", "--device", "cpu", "--checkpoint-dir", str(tmp_path),
                  "--report-dir", str(tmp_path / "r")])
    assert os.listdir(tmp_path) == []  # nothing rendered, trained or logged
