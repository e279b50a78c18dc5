"""The port's ``small_cnn`` (``models/small_cnn.py``) held to the JAX
package's Flax ``SmallTabCNN`` on the same NumPy weights and inputs, at the
fp32 tolerances of tests/test_torch_train.py: eval-mode logits, and train
steps through ``make_train_step`` (dropout at 0 on both sides, so the
steps are deterministic).  The flatten before ``dense0`` is where NCHW and
Flax's NHWC orders part: a wrong permutation fails the logits check."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu.config import ModelConfig as JaxModelConfig
from guitar_tablature_classification_tpu.config import OptimConfig as JaxOptimConfig
from guitar_tablature_classification_tpu.models.small_cnn import SmallTabCNN as JaxSmallTabCNN
from guitar_tablature_classification_tpu.train import create_train_state as jax_create_state
from guitar_tablature_classification_tpu.train import make_preprocess as jax_make_preprocess
from guitar_tablature_classification_tpu.train import make_train_step as jax_make_train_step
from guitar_tablature_classification_tpu_torch.config import ModelConfig, OptimConfig
from guitar_tablature_classification_tpu_torch.models import (
    SmallTabCNN,
    adam_state_from_optax,
    build_model,
    state_dict_from_flax,
)
from guitar_tablature_classification_tpu_torch.models.heads import Dropout
from guitar_tablature_classification_tpu_torch.train import (
    create_train_state,
    make_preprocess,
    make_train_step,
)

CFG = ModelConfig(arch="small_cnn", dtype="float32")


def _variables(jmodel, seed=0):
    """Flax variables as NumPy, biases moved off their zero init."""
    x = jnp.zeros((1, 96, 9, 1), jnp.float32)
    variables = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed), x))
    rng = np.random.default_rng(seed)
    for layer in variables["params"].values():
        layer["bias"] = rng.normal(0, 0.1, layer["bias"].shape).astype(np.float32)
    return variables


def _feats(seed, batch=8):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-120, 0, (batch, 96, 9)).astype(np.float32),
            rng.integers(0, 19, (batch, 6)).astype(np.int32))


def _port(variables, **kw):
    model = build_model(CFG, **kw)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


def test_build_model_and_state_dict_layout():
    model = build_model(ModelConfig(arch="small_cnn"))
    assert isinstance(model, SmallTabCNN) and model.dtype == torch.bfloat16
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {
        "conv1.weight": (32, 1, 3, 3), "conv1.bias": (32,),
        "conv2.weight": (64, 32, 3, 3), "conv2.bias": (64,),
        "conv3.weight": (64, 64, 3, 3), "conv3.bias": (64,),
        "dense0.weight": (6, 45 * 1 * 64, 152), "dense0.bias": (6, 152),
        "dense1.weight": (6, 152, 76), "dense1.bias": (6, 76),
        "out.weight": (6, 76, 19), "out.bias": (6, 19),
    }
    # seeded: the same generator seed gives the same weights
    again = build_model(ModelConfig(arch="small_cnn"))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_flax(dtype):
    jmodel = JaxSmallTabCNN(dtype=getattr(jnp, dtype))
    variables = _variables(jmodel)
    feats, _ = _feats(0)
    jpre = jax_make_preprocess(JaxModelConfig(arch="small_cnn", dtype=dtype))
    want = np.asarray(jmodel.apply(variables, jpre(jnp.asarray(feats))))
    cfg = ModelConfig(arch="small_cnn", dtype=dtype)
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        got = model.eval()(make_preprocess(cfg)(torch.from_numpy(feats))).numpy()
    assert got.shape == want.shape == (8, 6, 19) and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:  # bf16 convs: the same roundings up to summation order
        assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.95
        np.testing.assert_allclose(got, want, atol=0.05 * np.abs(want).max())


@pytest.mark.parametrize("steps, lr", [(1, 5e-4), (3, 1e-4)])
def test_train_steps_match_jax(steps, lr):
    """Loss (rtol 1e-5) and the raw gradients' norm (rtol 1e-3) at every
    step; then the parameters (atol 1e-5) and Adam moments (relative L2
    1e-2 per tensor), as tests/test_torch_train.py holds resnet18_native."""
    jmodel = JaxSmallTabCNN(dtype=jnp.float32, dropout=(0.0, 0.0))
    variables = _variables(jmodel, seed=1)
    jpre = jax_make_preprocess(JaxModelConfig(arch="small_cnn", dtype="float32"))
    feats, _ = _feats(0)
    jstate = jax_create_state(jmodel, JaxOptimConfig(), jax.random.PRNGKey(0),
                              jpre(jnp.asarray(feats[:1])))
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, variables["params"]))
    model = _port(variables)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0  # as on the JAX side, in this test only
    state = create_train_state(model, OptimConfig(), device="cpu")
    assert state.buffers.numel() == 0  # no BatchNorm
    jstep = jax_make_train_step(jmodel, jpre)
    step = make_train_step(model, make_preprocess(CFG))
    gen = torch.Generator().manual_seed(0)
    for i in range(steps):
        feats, labels = _feats(i)
        jstate, jm = jstep(jstate, {"features": jnp.asarray(feats), "labels": jnp.asarray(labels)},
                           jax.random.PRNGKey(1), lr)
        m = step(state, {"features": torch.from_numpy(feats),
                         "labels": torch.from_numpy(labels)}, gen, lr)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    sd = model.state_dict()
    want = state_dict_from_flax({"params": jax.tree.map(np.asarray, jstate.params)})
    for key, val in want.items():
        np.testing.assert_allclose(sd[key].numpy(), val.numpy(), atol=1e-5, err_msg=key)
    adam = adam_state_from_optax(jstate.opt_state)
    mine = state.adam_state()
    assert mine["count"] == adam["count"] == steps
    for kind in ("mu", "nu"):
        for name, val in adam[kind].items():
            ref = val.numpy()
            err = np.linalg.norm(mine[kind][name].numpy() - ref) / np.linalg.norm(ref)
            assert err <= 1e-2, f"{kind} {name} relative error {err}"


def test_train_mode_dropout_comes_from_the_step_generator():
    model = build_model(CFG).train()
    x = make_preprocess(CFG)(torch.from_numpy(_feats(0)[0]))
    a = model(x, torch.Generator().manual_seed(3))
    b = model(x, torch.Generator().manual_seed(3))
    c = model(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="torch.Generator"):
        model(x)
