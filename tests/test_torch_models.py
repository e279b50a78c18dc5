"""The port's GuitarTabNet, weight conversion and preprocessing held to the
JAX package's Flax model on the same NumPy weights and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu.config import ModelConfig as JaxModelConfig
from guitar_tablature_classification_tpu.models import build_model as jax_build_model
from guitar_tablature_classification_tpu.ops import resize_matrix as jax_resize_matrix
from guitar_tablature_classification_tpu.train import make_preprocess as jax_make_preprocess
from guitar_tablature_classification_tpu_torch.config import ModelConfig
from guitar_tablature_classification_tpu_torch.models import (
    build_model,
    load_torch_checkpoint,
    state_dict_from_flax,
)
from guitar_tablature_classification_tpu_torch.ops import resize_matrix
from guitar_tablature_classification_tpu_torch.train import make_preprocess

INPUT_SHAPES = {"resnet18_native": (96, 9, 1), "resnet18": (224, 224, 3)}


def perturbed_variables(arch, dtype, seed=0):
    """Flax GuitarTabNet variables as NumPy, with BatchNorm scales, biases
    and running statistics moved off their identity init (so eval-mode BN
    is exercised)."""
    model = jax_build_model(JaxModelConfig(arch=arch, dtype=dtype))
    x = jnp.zeros((1,) + INPUT_SHAPES[arch], jnp.float32)
    variables = jax.tree.map(
        np.asarray, model.init(jax.random.PRNGKey(seed), x, train=False)
    )
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
            elif key in ("scale", "var"):
                tree[key] = (val * rng.uniform(0.5, 1.5, val.shape)).astype(np.float32)
            elif key == "mean" or (key == "bias" and "bn" in "".join(path)):
                tree[key] = (val + rng.normal(0, 0.1, val.shape)).astype(np.float32)

    walk(variables)
    return model, variables


def port_model(arch, dtype, variables):
    model = build_model(ModelConfig(arch=arch, dtype=dtype))
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.eval()


def _logits_pair(arch, dtype, batch=3, seed=0):
    jmodel, variables = perturbed_variables(arch, dtype, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.uniform(0, 1, (batch,) + INPUT_SHAPES[arch]).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = port_model(arch, dtype, variables)(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("arch", ["resnet18_native", "resnet18"])
def test_logits_match_flax_fp32(arch):
    """fp32: the two frameworks' convolutions sum in other orders only."""
    got, want = _logits_pair(arch, "float32")
    assert got.shape == want.shape == (3, 6, 19)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("arch", ["resnet18_native", "resnet18"])
def test_logits_match_flax_bf16(arch):
    """bf16 compute: each of ~20 layers rounds its activations to 8 bits
    of mantissa (2^-8 relative), at places that differ between XLA and
    PyTorch, so the logits agree to a few percent of their scale."""
    got, want = _logits_pair(arch, "bfloat16")
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2 * scale)


@pytest.mark.parametrize("arch", ["resnet18_native", "resnet18"])
def test_save_torch_checkpoint_loads_strict(tmp_path, arch):
    from guitar_tablature_classification_tpu.models.torch_export import (
        save_torch_checkpoint,
    )

    _, variables = perturbed_variables(arch, "float32", seed=2)
    path = str(tmp_path / "best_guitar_tab_model.pt")
    save_torch_checkpoint(path, variables, arch=arch, meta={"epoch": 1})
    sd = load_torch_checkpoint(path)
    model = build_model(ModelConfig(arch=arch, dtype="float32"))
    model.load_state_dict(sd, strict=True)
    converted = state_dict_from_flax(variables)
    assert set(sd) == set(converted)
    for key, val in converted.items():
        # the export writes num_batches_tracked as shape [1]; torch's
        # BatchNorm loads that into its 0-d buffer
        assert torch.equal(sd[key].reshape(val.shape), val), key
    # DataParallel-prefixed raw state dicts load too
    torch.save({"module." + k: v for k, v in sd.items()}, str(tmp_path / "dp.pt"))
    assert set(load_torch_checkpoint(str(tmp_path / "dp.pt"))) == set(sd)


@pytest.mark.parametrize("overrides, match", [
    (dict(arch="resnet18", stem_fusion="fused"), "B2"),
    (dict(arch="resnet18_native", stem_fusion="fused"), "B6"),
    (dict(arch="resnet18_native", bn_fusion="on"), "B7"),
    (dict(arch="vit_s8"), "A12"),
    (dict(arch="vit_native"), "A12"),
    (dict(arch="small_cnn"), "A11"),
])
def test_unported_knobs_raise(overrides, match):
    with pytest.raises(NotImplementedError, match=match):
        build_model(ModelConfig(**overrides))


@pytest.mark.parametrize("w1_conv", ["dense", "slim", "gemm", "full"])
def test_output_only_knobs_map_to_plain_model(w1_conv):
    """w1_conv, stem_fusion='on' and remat change how the JAX model
    computes, not what: the port builds the same plain model for each."""
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    base = build_model(ModelConfig(arch="resnet18_native"), generator=gen())
    other = build_model(
        ModelConfig(arch="resnet18_native", w1_conv=w1_conv, remat=True,
                    stem_fusion="on"),
        generator=gen(),
    )
    for (k, a), (_, b) in zip(base.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("arch, stem_fusion", [
    ("resnet18_native", "off"), ("resnet18", "off"), ("resnet18", "on"),
])
def test_preprocess_matches_jax(arch, stem_fusion):
    rng = np.random.default_rng(0)
    feats = rng.uniform(-130, 0, (2, 96, 9)).astype(np.float32)
    got = make_preprocess(ModelConfig(arch=arch, stem_fusion=stem_fusion))(
        torch.from_numpy(feats)
    ).numpy()
    # the JAX "on" branch hands the raw unit CQT to a fused conv1; its
    # resized-image twin is the "off" branch
    want = np.asarray(jax_make_preprocess(JaxModelConfig(arch=arch))(feats))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_resize_matrix_equal():
    for n_in, n_out in ((96, 224), (9, 224), (130, 224)):
        assert np.array_equal(resize_matrix(n_in, n_out), jax_resize_matrix(n_in, n_out))
