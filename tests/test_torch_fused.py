"""The port's fused 224^2 flagship (``resnet18``, ``stem_fusion="fused"``)
in eval mode, held to the JAX package's fused model on the same NumPy
weights and CQT features.

On the CPU the JAX model runs its stem tail through the XLA twin and the
port through its plain versions.  Tolerances are
tests/test_torch_models.py's: logits to 1e-4 of their scale at fp32 and
5e-2 at bf16 (the twin rounds z to bf16 where the port keeps fp32, as the
Pallas kernels do; each of ~20 layers rounds activations to bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu.config import ModelConfig as JaxModelConfig
from guitar_tablature_classification_tpu.models import build_model as jax_build_model
from guitar_tablature_classification_tpu.train import make_preprocess as jax_make_preprocess
from guitar_tablature_classification_tpu_torch.config import ModelConfig
from guitar_tablature_classification_tpu_torch.models import build_model, state_dict_from_flax
from guitar_tablature_classification_tpu_torch.ops import stem_cuda
from guitar_tablature_classification_tpu_torch.train import make_preprocess
from test_torch_models import perturbed_variables

FUSED = dict(arch="resnet18", stem_fusion="fused")


def _port(dtype, variables):
    model = build_model(ModelConfig(**FUSED, dtype=dtype))
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.eval()


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_fused_logits_match_flax(dtype, tol):
    # the fused model shares the plain model's variable tree
    _, variables = perturbed_variables("resnet18", dtype)
    jcfg = JaxModelConfig(**FUSED, dtype=dtype)
    feats = np.random.default_rng(1).uniform(-120, 0, (3, 96, 9)).astype(np.float32)
    x = jax_make_preprocess(jcfg)(jnp.asarray(feats))
    assert x.shape == (3, 96, 9, 1)
    want = np.asarray(jax_build_model(jcfg).apply(variables, x, train=False))
    cfg = ModelConfig(**FUSED, dtype=dtype)
    tx = make_preprocess(cfg)(torch.from_numpy(feats))
    assert tuple(tx.shape) == (3, 96, 9, 1)
    before = dict(stem_cuda.launches)
    with torch.inference_mode():
        got = _port(dtype, variables)(tx).numpy()
    assert stem_cuda.launches == before  # CPU tensors: plain versions only
    assert got.shape == want.shape == (3, 6, 19)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def test_fused_model_on_images_takes_the_plain_stem():
    """Given 3-channel 224^2 images, the fused model runs conv1 -> bn1 ->
    ReLU -> max-pool, as the JAX model does (resnet.py:423-427): the same
    logits as the plain model with the same weights."""
    _, variables = perturbed_variables("resnet18", "float32", seed=3)
    plain = build_model(ModelConfig(arch="resnet18", dtype="float32"))
    plain.load_state_dict(state_dict_from_flax(variables), strict=True)
    images = torch.rand(2, 224, 224, 3)
    with torch.inference_mode():
        assert torch.equal(_port("float32", variables)(images), plain.eval()(images))


def test_transcriber_serves_the_fused_flagship_on_the_cpu():
    """The fused configuration through ``Transcriber`` on the CPU (plain
    versions): the same logits as the eval forward of the same weights."""
    from guitar_tablature_classification_tpu_torch.infer import Transcriber

    cfg = ModelConfig(**FUSED)
    t = Transcriber(None, model_cfg=cfg, batch_size=4, device="cpu", seed=0)
    audio = np.random.default_rng(2).standard_normal(
        t.cqt_cfg.window_samples * 2).astype(np.float32)
    out = t.transcribe(audio, keep_logits=True)
    assert out.frets.shape == (out.logits.shape[0], 6) and np.isfinite(out.logits).all()
    model = build_model(cfg, generator=torch.Generator().manual_seed(0)).eval()
    windows = torch.from_numpy(np.stack([audio[:t.cqt_cfg.window_samples]]))
    with torch.inference_mode():
        want = model(make_preprocess(cfg)(t.frontend(windows)))
    np.testing.assert_allclose(out.logits[:1], want.numpy(), rtol=0, atol=1e-6)
