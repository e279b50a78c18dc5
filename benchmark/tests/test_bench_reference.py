"""The benchmark's plain reference against the port's plain path on the
CPU, at small sizes, with shared weights: the reference must compute what
the configurations state, so that on the card only rounding separates the
two."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import check, harness, weights
from benchmark.reference import cqt as rcqt
from benchmark.reference import models
from benchmark.reference.precision import Precision
from benchmark.reference.train import adam_update, smoothed_loss

from .bench_helpers import TINY_TRAIN

CPU = torch.device("cpu")


def _port():
    from guitar_tablature_classification_tpu_torch import config
    from guitar_tablature_classification_tpu_torch.models.tabnet import build_model
    from guitar_tablature_classification_tpu_torch.train import engine

    return config, build_model, engine


def _cfg(name: str, **model) -> dict:
    cfg = harness.load_cell(name).config
    cfg["model"].update(model)
    return cfg


def _models(cfg: dict, seed: int = 3):
    config, build_model, _ = _port()
    w = weights.make(cfg["model"], seed, CPU)
    port = build_model(config.ModelConfig(**cfg["model"]))
    port.load_state_dict(w, strict=True)
    with torch.device("meta"):
        ref = models.build(cfg["model"])
    ref.load_state_dict(w, assign=True)
    return port, ref


@pytest.mark.parametrize("cell", ["flagship_train", "vit_train", "native_train"])
def test_reference_has_the_ports_keys(cell):
    config, build_model, _ = _port()
    cfg = _cfg(cell)
    port = build_model(config.ModelConfig(**cfg["model"])).state_dict()
    with torch.device("meta"):
        ref = models.build(cfg["model"]).state_dict()
    assert list(ref) == list(port)
    assert all(tuple(ref[k].shape) == tuple(port[k].shape) for k in ref)


def _audio(batch: int, seed: int = 0) -> torch.Tensor:
    from benchmark import audio

    (track,) = audio.tracks([0.25 * batch + 0.3], 44100, seed, CPU)
    starts = torch.arange(batch)[:, None] * 11025
    return track[starts + torch.arange(8820)]


def test_cqt_matches_the_ports_plain_transform():
    from guitar_tablature_classification_tpu_torch.config import CQTConfig
    from guitar_tablature_classification_tpu_torch.ops.cqt import CQTFrontend

    cfg = _cfg("flagship_train")
    x = _audio(6)
    want = CQTFrontend(CQTConfig(**cfg["cqt"])).plain(x)
    got = rcqt.CQT(cfg["cqt"], CPU)(x)
    gated_w, gated_g = want == -120.0, got == -120.0
    flips = gated_w != gated_g
    assert int(flips.sum()) <= 2  # a cell within rounding of the -60 dB gate may flip
    ungated_side = torch.where(gated_g, want, got)[flips]
    assert all(abs(float(v) + 60.0) < 1e-2 for v in ungated_side)
    both = ~gated_w & ~gated_g
    assert float((got - want)[both].abs().max()) < 2e-3


@pytest.mark.parametrize("arch", ["resnet18", "vit_s8", "resnet18_native"])
def test_image_matches_the_ports_preprocess(arch):
    config, _, engine = _port()
    cell = {"resnet18": "flagship_train", "vit_s8": "vit_train",
            "resnet18_native": "native_train"}[arch]
    cfg = _cfg(cell, stem_fusion="off")
    db = torch.rand(3, 96, 9) * 100 - 110
    want = engine.make_preprocess(config.ModelConfig(**cfg["model"]))(db).permute(0, 3, 1, 2)
    with torch.device("meta"):
        ref = models.build(cfg["model"])
    got = ref.inputs(db)
    assert tuple(got.shape) == ((3, 1, 96, 9) if arch == "resnet18_native" else (3, 3, 224, 224))
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


def test_framing_matches_the_port():
    from guitar_tablature_classification_tpu_torch.config import CQTConfig
    from guitar_tablature_classification_tpu_torch.ops.framing import frame_track

    cfg = _cfg("vit_serve")
    track = np.random.default_rng(0).standard_normal(44100 * 2 + 123).astype(np.float32)
    want = frame_track(track, CQTConfig(**cfg["cqt"]), hop_samples=4410)
    np.testing.assert_array_equal(rcqt.frame(track, cfg["cqt"], 4410), want)


# the native cells' CQT runs at the default tier (bf16 operands), which the
# port's plain version rounds too: these compare the models, on the float32
# transform of both sides
HIGHEST = {"precision": "highest"}


@pytest.mark.parametrize("cell,model,cqt", [
    ("flagship_serve", {"dtype": "float32"}, {}),
    ("flagship_serve", {"dtype": "float32", "stem_fusion": "off"}, {}),
    ("vit_serve", {"dtype": "float32", "vit_layers": 2}, {}),
    ("native_serve", {"dtype": "float32"}, HIGHEST),
], ids=["flagship_serve-model0", "flagship_serve-model1", "vit_serve-model2",
        "native_serve-model3"])
def test_eval_logits_match_the_port_at_float32(cell, model, cqt):
    config, _, engine = _port()
    cfg = _cfg(cell, **model)
    cfg["cqt"].update(cqt)
    port, ref = _models(cfg)
    port.eval()
    from guitar_tablature_classification_tpu_torch.ops.cqt import CQTFrontend

    x = _audio(3, seed=5)
    with torch.no_grad():
        want = port(engine.make_preprocess(config.ModelConfig(**cfg["model"]))(
            CQTFrontend(config.CQTConfig(**cfg["cqt"]))(x)))
        got = ref.run(ref.inputs(rcqt.CQT(cfg["cqt"], CPU)(x)), train=False)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("cell,model,limit", [
    # the fused stem's trunk gradients differ from the plain stem's by ~0.7 %
    # on the CPU at float32 (the port's own two paths do too), which turns a
    # few signs of the trunk's first update; the logit layers and the loss
    # agree to rounding
    ("flagship_train", {"dtype": "float32"}, 0.1),
    ("vit_train", {"dtype": "float32", "vit_layers": 1}, 0.01),
    # at B=4 a few entries of the native trunk's BatchNorm biases have step-1
    # gradients that are nought to rounding; one turned sign of 128 reads 1/64
    ("native_train", {"dtype": "float32"}, 0.05),
], ids=["flagship_train-model0-0.1", "vit_train-model1-0.01", "native_train-model2-0.05"])
def test_train_steps_match_the_port_at_float32(cell, model, limit):
    c = harness.load_cell(cell)
    c.config["model"].update(model)
    if cell == "native_train":
        c.config["cqt"].update(HIGHEST)
    c.traffic = dict(TINY_TRAIN)
    from benchmark.spans import Spans

    drv = harness.driver(c, 987654321987, CPU, Spans())
    drv.setup()
    port = drv.readings
    drv.free()
    ref = drv.reference()
    assert abs(port["loss"][0] - ref["loss"][0]) <= 1e-5 * ref["loss"][0]
    assert abs(port["grad_norm"] - ref["grad_norm"]) <= 1e-2 * ref["grad_norm"]
    numbers = check.train_numbers(port, ref)
    assert numbers["logit_direction_error"] <= 1e-4
    assert numbers["direction_error"] <= limit
    assert numbers["change_gap"] <= 0.1


@pytest.mark.parametrize("name,backbone", [("adam", 1.0), ("adamw", 0.1)])
def test_adam_matches_the_ports_optimizer(name, backbone):
    config, _, engine = _port()
    optim = dict(harness.load_cell("vit_train").config["optim"], name=name,
                 backbone_lr_scale=backbone)
    g = torch.Generator().manual_seed(0)
    names, sizes = ["vit.a", "fc1.weight"], [5, 7]
    params = torch.randn(12, generator=g)
    state = {}
    ref = dict(zip(names, params.clone().split(sizes)))
    tx = engine.make_optimizer(config.OptimConfig(**optim), names, sizes)
    opt = tx.init(params)
    for step in (1, 2, 3):
        grads = torch.randn(12, generator=g) * (3.0 if step == 1 else 0.1)
        params, opt, _ = tx.update(grads, opt, params, optim["learning_rate"])
        adam_update(ref, dict(zip(names, grads.split(sizes))), state, optim, step)
    assert torch.allclose(torch.cat([ref[n] for n in names]), params, atol=1e-7, rtol=1e-6)


def test_loss_and_mode_filter_match_the_port():
    from guitar_tablature_classification_tpu_torch.ops.loss import label_smoothing_loss
    from guitar_tablature_classification_tpu_torch.ops.smoothing import mode_filter

    g = torch.Generator().manual_seed(1)
    logits, labels = torch.randn(8, 6, 19, generator=g), torch.randint(0, 19, (8, 6), generator=g)
    assert torch.allclose(smoothed_loss(logits, labels, 0.1),
                          label_smoothing_loss(logits, labels, 0.1), rtol=1e-6)
    preds = torch.randint(0, 4, (40, 6), generator=g)
    np.testing.assert_array_equal(check.mode_filter(preds.numpy(), 3, 19),
                                  mode_filter(preds, 3).numpy())


def test_control_rounds_to_e4m3():
    x = torch.linspace(-3, 3, 101)
    q = Precision("fp8")(x)
    assert (q - x).abs().max() <= 3 / 448 * 16  # half an e4m3 step at the top binade
    assert len(torch.unique(q)) < len(x)
    assert torch.equal(Precision("fp32")(x), x)
