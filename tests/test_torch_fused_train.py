"""The port's fused 224^2 flagship in train mode, held to the JAX package's
fused model (Flax ``ResNet18(fused_front=224, fused_tail=True)``) on the
same NumPy weights and CQT features, at fp32.

Tolerances are tests/test_stem_pallas.py:236-260's for the same kind of
comparison: loss rtol 1e-3, gradients to 0.03, bn1's running statistics
to 1e-5.  The gradient bound applies to each leaf's relative L2 error, not
to each element: across frameworks fp32 noise flips the occasional ReLU
mask, and one flip moves a single element by the whole upstream gradient,
a few percent of a leaf's largest value.  The loss is the train step's
label-smoothed loss: with the JAX test's sum(out^2) the heads' last biases
get no gradient beyond rounding, since BatchNorm centres every feature over
the batch.  The heads' dropout is set to 0 on both sides, in this test
only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as fnn

from guitar_tablature_classification_tpu.models.heads import StringBranchHeads as JaxHeads
from guitar_tablature_classification_tpu.models.resnet import ResNet18 as JaxResNet18
from guitar_tablature_classification_tpu.ops import label_smoothing_loss as jax_loss
from guitar_tablature_classification_tpu.train import make_preprocess as jax_make_preprocess
from guitar_tablature_classification_tpu_torch.config import ModelConfig, OptimConfig
from guitar_tablature_classification_tpu_torch.models import build_model, state_dict_from_flax
from guitar_tablature_classification_tpu_torch.models.heads import Dropout
from guitar_tablature_classification_tpu_torch.ops.loss import label_smoothing_loss
from guitar_tablature_classification_tpu_torch.train import (
    create_train_state,
    make_preprocess,
    make_train_step,
)

CFG = ModelConfig(arch="resnet18", stem_fusion="fused", dtype="float32")


class _FusedNoDropout(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        feats = JaxResNet18(num_features=256, input_channels=3, dtype=jnp.float32,
                            fused_front=224, fused_tail=True, name="resnet")(x, train=train)
        return JaxHeads(dropout=(0.0, 0.0), name="heads")(feats, train=train)


def _port(variables):
    model = build_model(CFG)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, variables)),
                          strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


def test_fused_train_gradients_and_bn1_stats_match_flax():
    rng = np.random.default_rng(5)
    feats = rng.uniform(-120, 0, (8, 96, 9)).astype(np.float32)
    labels = rng.integers(0, 19, (8, 6)).astype(np.int32)
    jmodel = _FusedNoDropout()
    x = jax_make_preprocess(CFG)(jnp.asarray(feats))
    variables = jmodel.init(jax.random.PRNGKey(7), x, train=False)

    def loss(params):
        out, upd = jmodel.apply({**variables, "params": params}, x, train=True,
                                mutable=["batch_stats"])
        return jax_loss(out, jnp.asarray(labels)), upd["batch_stats"]

    (jl, stats), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    model = _port(variables).train()
    out = model(make_preprocess(CFG)(torch.from_numpy(feats)), torch.Generator())
    tl = label_smoothing_loss(out, torch.from_numpy(labels))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    want = state_dict_from_flax(jax.tree.map(
        np.asarray, {"params": grads, "batch_stats": stats}))
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - ref) / np.linalg.norm(ref)
        assert err <= 0.03, f"{name}: relative L2 error {err}"
    bn1 = model.resnet.bn1
    np.testing.assert_allclose(bn1.running_mean.numpy(), want["resnet.bn1.running_mean"].numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bn1.running_var.numpy(), want["resnet.bn1.running_var"].numpy(),
                               atol=1e-5, rtol=1e-5)


def test_fused_flagship_train_step_on_the_cpu():
    """The flagship's train step end to end on raw audio, at B=2 and bf16:
    the CQT, the fused stem's plain versions, the trunk and the update.
    The loss is finite, every parameter moves, bn1's running statistics
    move, and two runs from the same seed agree exactly."""
    from guitar_tablature_classification_tpu_torch.config import CQTConfig
    from guitar_tablature_classification_tpu_torch.ops.cqt import CQTFrontend

    cfg = ModelConfig(arch="resnet18", stem_fusion="fused")
    frontend = CQTFrontend(CQTConfig())
    audio = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, frontend.cfg.window_samples)).astype(np.float32))
    labels = torch.randint(0, 19, (2, 6), generator=torch.Generator().manual_seed(0))
    runs = []
    for _ in range(2):
        model = build_model(cfg, generator=torch.Generator().manual_seed(0))
        state = create_train_state(model, OptimConfig(), device="cpu")
        before = state.params.clone(), state.buffers.clone()
        step = make_train_step(model, make_preprocess(cfg), frontend=frontend)
        m = step(state, {"audio": audio, "labels": labels}, torch.Generator().manual_seed(1), 5e-4)
        assert np.isfinite(float(m["loss"]))
        offset = 0
        for name, p in zip(state.names, state.param_list):
            old = before[0][offset:offset + p.numel()]
            offset += p.numel()
            assert not torch.equal(p.detach().reshape(-1), old), name
        assert not torch.equal(model.resnet.bn1.running_var, before[1][64:128])
        runs.append((float(m["loss"]), state.params.clone()))
    assert runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])
