"""The port's ``rgb_image`` input kind (PNG spectrogram renders) and its
normalizers, held to the JAX package on the same NumPy inputs: the
whole-batch min-max and z-score normalizers (atol 1e-6), the PNG
preprocess (the port's preprocess tolerance, tests/test_torch_models.py:
atol 1e-5), one train step on uint8 renders against JAX ``make_train_step``
(as tests/test_torch_train.py holds steps), and ``train.run`` on a PNG
tree."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from guitar_tablature_classification_tpu.config import ModelConfig as JaxModelConfig
from guitar_tablature_classification_tpu.config import OptimConfig as JaxOptimConfig
from guitar_tablature_classification_tpu.train import create_train_state as jax_create_state
from guitar_tablature_classification_tpu.train import make_preprocess as jax_make_preprocess
from guitar_tablature_classification_tpu.train import make_train_step as jax_make_train_step
from guitar_tablature_classification_tpu_torch.config import ModelConfig, OptimConfig
from guitar_tablature_classification_tpu_torch.models import build_model, state_dict_from_flax
from guitar_tablature_classification_tpu_torch.models.heads import Dropout
from guitar_tablature_classification_tpu_torch.ops import min_max_normalize, z_score_normalize
from guitar_tablature_classification_tpu_torch.train import (
    create_train_state,
    make_preprocess,
    make_train_step,
)


def _renders(seed, shape=(4, 60, 80, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


# --------------------------------------------------------------- normalizers


@pytest.mark.parametrize("kind", ["random", "constant", "tiny_span"])
@pytest.mark.parametrize("name", ["min_max", "z_score"])
def test_normalizers_match_jax(name, kind):
    from guitar_tablature_classification_tpu.ops import normalize as jax_normalize

    rng = np.random.default_rng(0)
    x = {"random": rng.standard_normal((3, 96, 9)),
         "constant": np.full((3, 96, 9), -37.5),
         "tiny_span": -5 + rng.uniform(0, 1e-9, (3, 96, 9))}[kind].astype(np.float32)
    got = {"min_max": min_max_normalize, "z_score": z_score_normalize}[name](torch.from_numpy(x))
    want = getattr(jax_normalize, f"{name}_normalize")(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    if kind != "random":  # the eps branch: min-max leaves x, z-score centers it
        ref = x if name == "min_max" else x - x.mean()
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["min_max", "z_score"])
def test_normalizers_on_db_features_match_float64(name):
    """At the dB features' scale (mean -40, std 20) fp32 statistics carry
    ulps of 4e-6: the port's result is held to the float64 normalization
    at 1e-6 (the JAX package's fp32 mean lies 5 ulps off on this input and
    its z-scores 1.2e-6 from float64)."""
    x = (np.random.default_rng(0).standard_normal((3, 96, 9)) * 20 - 40).astype(np.float32)
    x64 = x.astype(np.float64)
    ref = (x64 - x64.min()) / np.ptp(x64) if name == "min_max" else \
        (x64 - x64.mean()) / x64.std()
    got = {"min_max": min_max_normalize, "z_score": z_score_normalize}[name](torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- preprocess


@pytest.mark.parametrize("arch", ["resnet18", "vit_s8", "small_cnn"])
def test_rgb_preprocess_matches_jax(arch):
    renders = _renders(0)
    cfg = ModelConfig(arch=arch, stem_fusion="fused" if arch == "resnet18" else "off")
    got = make_preprocess(cfg, 224, "rgb_image")(torch.from_numpy(renders)).numpy()
    want = np.asarray(jax_make_preprocess(JaxModelConfig(arch=arch), 224, "rgb_image")(renders))
    assert got.shape == want.shape == ((4, 60, 80, 3) if arch == "small_cnn" else (4, 224, 224, 3))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["resnet18_native", "vit_native"])
def test_native_archs_refuse_renders_as_jax_does(arch):
    with pytest.raises(ValueError) as jax_err:
        jax_make_preprocess(JaxModelConfig(arch=arch), 224, "rgb_image")
    with pytest.raises(ValueError) as err:
        make_preprocess(ModelConfig(arch=arch), 224, "rgb_image")
    assert str(err.value) == str(jax_err.value)


def test_fused_flagship_takes_renders_through_the_plain_stem():
    """resnet18 with the fused stem and the fused BatchNorms sends a
    3-channel render through the plain conv stem (the JAX model's rule):
    its logits are those of the unfused model on the same weights."""
    cfg = ModelConfig(arch="resnet18", dtype="float32")
    plain = build_model(cfg).eval()
    fused = build_model(ModelConfig(arch="resnet18", stem_fusion="fused", bn_fusion="on",
                                    dtype="float32")).eval()
    fused.load_state_dict(plain.state_dict())
    x = make_preprocess(cfg, 64, "rgb_image")(torch.from_numpy(_renders(1, (2, 60, 80, 3))))
    with torch.no_grad():
        torch.testing.assert_close(fused(x), plain(x), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- train step


class _JaxTabNet(fnn.Module):
    """The JAX 224^2 GuitarTabNet (fp32) with its heads' dropout at 0, as
    tests/test_torch_train.py builds the native one."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        from guitar_tablature_classification_tpu.models.heads import StringBranchHeads
        from guitar_tablature_classification_tpu.models.resnet import ResNet18

        feats = ResNet18(num_features=256, input_channels=3, dtype=jnp.float32,
                         name="resnet")(x, train=train)
        return StringBranchHeads(dropout=(0.0, 0.0), name="heads")(feats, train=train)


@pytest.mark.parametrize("arch", ["small_cnn", "resnet18"])
def test_rgb_train_step_matches_jax(arch):
    """One step on uint8 renders (resnet18: B=8, resized to 64^2 to keep
    the CPU run short; small_cnn: B=4 at the renders' own size, 20 x 24, so
    that its flatten stays small) against the
    JAX make_train_step from the same weights: loss rtol 1e-5, raw gradient
    norm rtol 1e-3 (resnet18: 0.03, the gradient bound the repo holds the
    224^2 trunk to, tests/test_torch_fused_train.py: its 20 batch-statistics
    BatchNorms amplify fp32 noise and flip the odd ReLU), then the state as
    tests/test_torch_train.py holds it."""
    from guitar_tablature_classification_tpu.models.small_cnn import SmallTabCNN
    from test_torch_train import _assert_state_matches

    size = 64
    cfg = ModelConfig(arch=arch, dtype="float32")
    jmodel = SmallTabCNN(dtype=jnp.float32, dropout=(0.0, 0.0)) if arch == "small_cnn" \
        else _JaxTabNet()
    jpre = jax_make_preprocess(JaxModelConfig(arch=arch), size, "rgb_image")
    renders = _renders(2, (4, 20, 24, 3)) if arch == "small_cnn" else _renders(2, (8, 60, 80, 3))
    labels = np.random.default_rng(3).integers(0, 19, (len(renders), 6)).astype(np.int32)
    jstate = jax.jit(lambda x: jax_create_state(  # jitted init: far faster on the CPU
        jmodel, JaxOptimConfig(), jax.random.PRNGKey(0), x))(jpre(renders[:1]))
    model = build_model(cfg, input_shape=renders.shape[1:])
    model.load_state_dict(state_dict_from_flax(jax.tree.map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats})), strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0  # as on the JAX side, in this test only
    state = create_train_state(model, OptimConfig(), device="cpu")
    lr = 5e-4
    jstate, jm = jax_make_train_step(jmodel, jpre)(
        jstate, {"features": jnp.asarray(renders), "labels": jnp.asarray(labels)},
        jax.random.PRNGKey(1), lr)
    m = make_train_step(model, make_preprocess(cfg, size, "rgb_image"))(
        state, {"features": torch.from_numpy(renders), "labels": torch.from_numpy(labels)},
        torch.Generator().manual_seed(0), lr)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-3 if arch == "small_cnn" else 0.03)
    _assert_state_matches(state, jstate, 1, lr)


# ------------------------------------------------------------------ train.run


def test_train_run_on_a_png_tree(tmp_path, capsys):
    """train.run over PIL-rendered PNGs and one-hot .npy labels: the tree
    packs into uint8 shards, small_cnn trains on the renders' own size,
    and --eval-only reads the checkpoint back."""
    from PIL import Image

    from guitar_tablature_classification_tpu_torch.train import run

    feats, tabs = tmp_path / "cqt_images", tmp_path / "tabs"
    feats.mkdir()
    tabs.mkdir()
    rng = np.random.default_rng(0)
    for i in range(12):
        Image.fromarray(_renders(i, (40, 30, 3))).save(feats / f"seg_{i:03d}.png")
        tab = np.zeros((6, 19), np.int8)
        tab[np.arange(6), rng.integers(0, 19, 6)] = 1
        np.save(tabs / f"seg_{i:03d}.npy", tab)
    args = ["--features", str(feats), "--labels", str(tabs), "--arch", "small_cnn",
            "--batch-size", "4", "--epochs", "2", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / "ckpt")]
    assert run.main(args) == 0
    trained = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(trained["best_val_loss"]) and len(trained["per_string"]) == 6
    assert run.main(args + ["--eval-only"]) == 0
    evaluated = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert evaluated["checkpoint_step"] > 0
    np.testing.assert_allclose(evaluated["test_accuracy"], trained["test_accuracy"], atol=1e-6)
