"""The port's ViTTab (``vit_s8`` at 224^2, 785 tokens, and ``vit_native``
with the conv stem) held to the JAX package's Flax ViTTab on the same
NumPy weights and inputs: eval logits, train-mode batch statistics, AdamW
train steps, weight and optimizer-state conversion, checkpoint serving.

The models are cut to 2 layers of width 64 with 2 heads.  The Flax model
runs with ``attention_impl="xla"`` (``jax.nn.dot_product_attention``, the
function its fused kernel computes, as its own tests hold); the port keeps
``"auto"``, which picks the fused path at 785 tokens, and on the CPU that
path is the plain version.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu.config import ModelConfig as JaxModelConfig
from guitar_tablature_classification_tpu.config import OptimConfig as JaxOptimConfig
from guitar_tablature_classification_tpu.infer import Transcriber as JaxTranscriber
from guitar_tablature_classification_tpu.models import build_model as jax_build_model
from guitar_tablature_classification_tpu.models.torch_export import (
    save_torch_checkpoint,
    vittab_state_dict,
)
from guitar_tablature_classification_tpu.models.vit import _stem_strides as jax_stem_strides
from guitar_tablature_classification_tpu.train import create_train_state as jax_create_state
from guitar_tablature_classification_tpu.train import make_optimizer as jax_make_optimizer
from guitar_tablature_classification_tpu.train import make_preprocess as jax_make_preprocess
from guitar_tablature_classification_tpu.train import make_train_step as jax_make_train_step
from guitar_tablature_classification_tpu_torch.config import ModelConfig, OptimConfig
from guitar_tablature_classification_tpu_torch.infer import (
    Transcriber,
    transcriber_from_torch_checkpoint,
)
from guitar_tablature_classification_tpu_torch.models import (
    ViTTab,
    adam_state_from_optax,
    build_model,
    load_torch_checkpoint,
    state_dict_from_flax,
)
from guitar_tablature_classification_tpu_torch.models.vit import stem_strides
from guitar_tablature_classification_tpu_torch.train import (
    create_train_state,
    make_preprocess,
    make_train_step,
)
from test_torch_serve import _assert_same_frets, _audio
from test_torch_train import _assert_state_matches

SMALL = dict(vit_hidden=64, vit_layers=2, vit_heads=2)
ARCHS = {  # arch -> (extra config, input shape [H, W, C])
    "vit_s8": ({}, (224, 224, 3)),
    "vit_native": ({"vit_patch": 16, "vit_conv_stem": True}, (96, 9, 1)),
}
# the vit-reference recipe's optimizer (config.py:299-313)
VIT_OPTIM = dict(name="adamw", label_smoothing=0.1, backbone_lr_scale=0.1)


def _cfgs(arch, dtype, **kw):
    extra = {**SMALL, **ARCHS[arch][0], **kw}
    return (JaxModelConfig(arch=arch, dtype=dtype, attention_impl="xla", **extra),
            ModelConfig(arch=arch, dtype=dtype, **extra))


def vit_variables(arch, dtype, seed=0, **kw):
    """Flax ViTTab variables as NumPy, with norm scales and biases, BatchNorm
    running statistics and the CLS token moved off their init."""
    jcfg, cfg = _cfgs(arch, dtype, **kw)
    variables = jax.tree.map(np.copy, _init_variables(arch, seed, tuple(sorted(kw.items()))))
    return jax_build_model(jcfg), variables, cfg


@functools.lru_cache(maxsize=None)
def _init_variables(arch, seed, kw):
    """vit_variables' tree, shared by the tests that ask for it.  The
    parameters are fp32 at any compute dtype and drawn from the same keys,
    so the fp32 model initialises them for both."""
    model = jax_build_model(_cfgs(arch, "float32", **dict(kw))[0])
    x = jnp.zeros((1,) + ARCHS[arch][1], jnp.float32)
    # jitted: Flax's op-by-op init and apply take seconds each on the CPU
    init = jax.jit(functools.partial(model.init, train=False))
    variables = jax.tree.map(np.array, init(jax.random.PRNGKey(seed), x))
    rng = np.random.default_rng(seed)

    def walk(tree, path=""):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, path + "/" + key)
            elif key in ("scale", "var"):
                tree[key] = (val * rng.uniform(0.5, 1.5, val.shape)).astype(np.float32)
            elif key in ("mean", "cls_token") or (
                    key == "bias" and ("bn" in path or "ln" in path)):
                tree[key] = (val + rng.normal(0, 0.1, val.shape)).astype(np.float32)

    walk(variables)
    return variables


def port_vittab(cfg, variables):
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


def _images(arch, batch, seed):
    """Noise images with a brightness and contrast of their own, so the CLS
    features (which average over every token) differ across the batch and
    the head's batch-statistics BatchNorms are well conditioned."""
    rng = np.random.default_rng(seed)
    shape = (batch,) + ARCHS[arch][1]
    gain = rng.uniform(0.2, 2.0, (batch, 1, 1, 1))
    offset = rng.uniform(-1.0, 1.0, (batch, 1, 1, 1))
    return (gain * rng.uniform(0, 1, shape) + offset).astype(np.float32)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vittab_logits_match_flax(arch, dtype):
    """Eval logits.  fp32: the JAX package's HF-parity tolerance (atol 2e-4,
    rtol 1e-3, tests/test_models.py:178); the two frameworks sum in other
    orders only.  bf16: every layer rounds its activations to 8 mantissa
    bits at places that differ between XLA and PyTorch (Dense bias adds,
    GELU), so the logits agree to a few percent of their scale, as the
    ResNet's do (test_torch_models.test_logits_match_flax_bf16)."""
    jmodel, variables, cfg = vit_variables(arch, dtype)
    x = _images(arch, 3, seed=1)
    want = np.asarray(jax.jit(functools.partial(jmodel.apply, train=False))(
        variables, jnp.asarray(x)))
    model = port_vittab(cfg, variables).eval()
    assert model.vit.encoder.layer[0].attend.__name__ == (
        "fused_attention" if arch == "vit_s8" else "attention_reference")
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 6, 19)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-2 * np.abs(want).max())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_mode_batch_stats_match_flax(arch):
    """One train-mode forward at fp32 (dropout 0): logits and the Flax
    running averages of every BatchNorm (the head's and the conv stem's),
    0.9 * old + 0.1 * batch with the biased variance, to 1e-5."""
    jmodel, variables, cfg = vit_variables(arch, "float32", dropout=0.0)
    x = _images(arch, 4, seed=2)
    want, mutated = jax.jit(functools.partial(jmodel.apply, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    model = port_vittab(cfg, variables).train()
    got = model(torch.from_numpy(x), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-4 * np.abs(np.asarray(want)).max())
    new = state_dict_from_flax({"params": variables["params"],
                                "batch_stats": jax.tree.map(np.asarray, mutated["batch_stats"])})
    sd = model.state_dict()
    running = [k for k in new if "running" in k]
    assert len(running) == (4 + 8 if arch == "vit_native" else 4)
    for key in running:
        np.testing.assert_allclose(sd[key].numpy(), new[key].numpy(), rtol=0, atol=1e-5,
                                   err_msg=key)


def _feats(seed, batch=16):
    """dB features like a CQT's: a quiet floor with a few loud bins of each
    window's own, so the windows differ and the head's batch-statistics
    BatchNorms are well conditioned (see _images)."""
    rng = np.random.default_rng(seed)
    feats = rng.uniform(-120, -90, (batch, 96, 9))
    for row in feats:
        row[rng.choice(96, 6, replace=False)] = rng.uniform(-30, 0, (6, 9))
    return feats.astype(np.float32), rng.integers(0, 19, (batch, 6)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_vit_s8_step():
    """The Flax vit_s8's initial train state (vit-reference optimizer),
    its preprocess and its jitted train step, made once for both cases of
    test_adamw_train_step_matches_jax (the learning rate is an argument of
    the step; the step donates its state, so each case takes a copy)."""
    jcfg, _ = _cfgs("vit_s8", "float32", dropout=0.0)
    jmodel = jax_build_model(jcfg)
    jpre = jax_make_preprocess(jcfg)
    # jitted: create_train_state's op-by-op Flax init takes seconds on the CPU
    jstate = jax.jit(lambda x: jax_create_state(
        jmodel, JaxOptimConfig(**VIT_OPTIM), jax.random.PRNGKey(0), x))(
        jpre(jnp.asarray(_feats(0)[0][:1])))
    return jstate, jax_make_train_step(jmodel, jpre, smoothing=0.1)


@pytest.mark.parametrize("steps, lr", [(1, 5e-4), (3, 1e-5)])
def test_adamw_train_step_matches_jax(steps, lr):
    """vit_s8 at 224^2 (785 tokens), fp32, dropout 0, the vit-reference
    optimizer (AdamW, smoothing 0.1, backbone lr x 0.1): loss (rtol 1e-5)
    and gradient norm (rtol 1e-3) at every step, then parameters, running
    averages and Adam moments as test_torch_train._assert_state_matches
    holds them.  Three steps run at lr 1e-5, as the ResNet's do.

    The running averages of bn_fc2 are held to 1e-4, not 1e-5: at init the
    CLS features vary little across a batch, so some fc1 outputs have a
    batch variance ~1e-4 of their squared mean (measured at B=16), and
    Flax's fast variance E[x^2] - E[x]^2 turns the frameworks' fp32
    summation-order noise there into ~1e-2 relative noise in bn_fc1's
    output, which fc2 carries into bn_fc2's batch mean (measured 2.5e-5
    after 3 steps).  bn_fc1's own statistics agree to 1e-7.

    Three kinds of parameters have gradients that are zero in exact
    arithmetic, and are held as _assert_state_matches's ``zero_grad``
    tensors: the biases of fc1, fc2 and the final LayerNorm (they reach the
    loss only through a batch-statistics BatchNorm, whose backward sums to
    zero over the batch), and every key bias (q . b_k is the same for every key
    of a query, and the softmax drops it)."""
    _, cfg = _cfgs("vit_s8", "float32", dropout=0.0)
    jstate, jstep = _jax_vit_s8_step()
    jstate = jax.tree.map(jnp.copy, jstate)
    model = port_vittab(cfg, jax.tree.map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    state = create_train_state(model, OptimConfig(**VIT_OPTIM), device="cpu")
    backbone = [n for n in state.names if n.startswith("vit.")]
    assert backbone and int(state.tx.backbone.sum()) == sum(
        p.numel() for n, p in model.named_parameters() if n.startswith("vit."))
    step = make_train_step(model, make_preprocess(cfg), smoothing=0.1)
    gen = torch.Generator().manual_seed(0)
    for i in range(steps):
        feats, labels = _feats(i)
        jstate, jm = jstep(jstate, {"features": jnp.asarray(feats),
                                    "labels": jnp.asarray(labels)},
                           jax.random.PRNGKey(1), lr)
        m = step(state, {"features": torch.from_numpy(feats),
                         "labels": torch.from_numpy(labels)}, gen, lr)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    _assert_state_matches(state, jstate, steps, lr, running_atol=1e-4,
                          zero_grad=("fc1.bias", "fc2.bias", "vit.layernorm.bias", *(
                              f"vit.encoder.layer.{i}.attention.attention.key.bias"
                              for i in range(SMALL["vit_layers"]))))


def test_preprocess_vit_s8_matches_jax():
    """dB -> unit, bicubic 224^2, three channels, no ImageNet normalize."""
    feats, _ = _feats(3, batch=2)
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch, "float32")
        got = make_preprocess(cfg)(torch.from_numpy(feats)).numpy()
        want = np.asarray(jax_make_preprocess(jcfg)(feats))
        assert got.shape == want.shape == (2,) + ARCHS[arch][1]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_state_dict_from_flax_matches_torch_export():
    """A patchify ViTTab: the port's mapping gives the JAX package's
    reference export (vittab_state_dict), key for key and value for value,
    with the fused qkv kernel split into query, key and value."""
    _, variables, cfg = vit_variables("vit_s8", "float32", seed=3)
    got = state_dict_from_flax(variables)
    want = vittab_state_dict(variables)
    assert set(got) == set(want) == set(build_model(cfg).state_dict())
    for key, val in want.items():
        assert np.array_equal(got[key].numpy().reshape(np.shape(val)), val), key
    qkv = variables["params"]["vit"]["block1"]["qkv"]["kernel"]
    key_w = got["vit.encoder.layer.1.attention.attention.key.weight"].numpy()
    assert np.array_equal(key_w, qkv[:, 64:128].T)


def test_conv_stem_weights_and_adam_state_convert():
    """A conv-stem ViTTab (no reference layout): the port's own names load
    strictly, and the Adam moments of the JAX vit-reference optimizer (a
    masked chain) map onto the port's parameter names.  One update with the
    parameters as their own gradient makes every first moment c * param with
    one c (clipping scales the whole tree), so each moment is checked in
    value, transposes included."""
    _, variables, cfg = vit_variables("vit_native", "float32")
    model = port_vittab(cfg, variables)
    stem = variables["params"]["vit"]["stem_conv2"]["kernel"]
    assert torch.equal(model.vit.stem_conv2.weight,
                       torch.from_numpy(stem.transpose(3, 2, 0, 1).copy()))
    assert torch.equal(model.vit.stem_bn3.running_var, torch.from_numpy(
        np.array(variables["batch_stats"]["vit"]["stem_bn3"]["var"])))
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = jax_make_optimizer(JaxOptimConfig(**VIT_OPTIM), params)
    _, opt_state = jax.jit(tx.update)(params, tx.init(params), params)
    adam = adam_state_from_optax(opt_state)
    names = dict(model.named_parameters())
    assert adam["count"] == 1
    for kind in ("mu", "nu"):
        assert set(adam[kind]) == set(names)
        for name, val in adam[kind].items():
            assert val.shape == names[name].shape, name
    ref = "vit.stem_proj.weight"
    c = float(adam["mu"][ref].flatten()[0] / names[ref].detach().flatten()[0])
    assert c > 0
    for name, mu in adam["mu"].items():
        want = c * names[name].detach()
        np.testing.assert_allclose(mu.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()), err_msg=name)


def test_knobs_map_to_the_plain_vit():
    """bn_fusion, stem_fusion and w1_conv are validated and then ignored for
    the ViT archs; remat builds the plain model; vit_conv_stem is refused on
    a ResNet arch (tabnet.py:137-163 of the JAX package)."""
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    base = build_model(ModelConfig(arch="vit_native", **SMALL), generator=gen())
    other = build_model(ModelConfig(arch="vit_native", bn_fusion="on", stem_fusion="fused",
                                    w1_conv="slim", remat=True, **SMALL), generator=gen())
    assert isinstance(other, ViTTab)
    for (k, a), (_, b) in zip(base.state_dict().items(), other.state_dict().items()):
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="bn_fusion"):
        build_model(ModelConfig(arch="vit_s8", bn_fusion="maybe"))
    with pytest.raises(ValueError, match="vit_conv_stem"):
        build_model(ModelConfig(arch="resnet18", vit_conv_stem=True))


def test_vit_mlp_ratio_is_not_read_as_in_jax():
    """The JAX ViTTab builds its backbone without ModelConfig.vit_mlp_ratio
    (tabnet.py:85-91 there), so the MLP stays 4x the width whatever it says;
    the port does the same (ROADMAP C logs the JAX package's fault)."""
    jcfg, cfg = _cfgs("vit_native", "float32", vit_mlp_ratio=2.0)
    variables = jax.eval_shape(functools.partial(jax_build_model(jcfg).init, train=False),
                               jax.random.PRNGKey(0), jnp.zeros((1, 96, 9, 1)))
    assert variables["params"]["vit"]["block0"]["mlp_in"]["kernel"].shape == (64, 256)
    model = build_model(cfg)
    assert model.vit.encoder.layer[0].intermediate.dense.weight.shape == (256, 64)


@pytest.mark.parametrize("patch", [(8, 3), (16, 3), (8, 1), (16, 9), (3, 3), (8, 8)])
def test_stem_strides_match_jax(patch):
    assert stem_strides(*patch) == jax_stem_strides(*patch)


def test_patch_divisibility_error():
    model = build_model(ModelConfig(arch="vit_native", vit_native_patch_w=2, **SMALL))
    with pytest.raises(ValueError, match="not divisible"):
        model.eval()(torch.zeros(1, 96, 9, 1))


def test_vit_checkpoint_serves_the_same_frets(tmp_path):
    """A JAX save_torch_checkpoint(arch="vit_s8") file loads strictly into
    the port and serves, on the CPU, the frets the JAX Transcriber serves
    from the same weights (fp32, highest-precision CQT: logits to 1e-4 of
    their scale)."""
    _, variables, cfg = vit_variables("vit_s8", "float32", seed=5)
    jcfg, _ = _cfgs("vit_s8", "float32")
    path = str(tmp_path / "best_vit_guitar_tab_model.pt")
    save_torch_checkpoint(path, variables, arch="vit_s8", meta={"epoch": 3})
    model = build_model(cfg)
    model.load_state_dict(load_torch_checkpoint(path), strict=True)
    audio = _audio(0.9)  # 8 windows: one batch, one JAX compile
    want = JaxTranscriber(variables, model_cfg=jcfg, batch_size=8).transcribe(
        audio, smooth_window=0, keep_logits=True)
    port = transcriber_from_torch_checkpoint(path, arch="vit_s8", model_cfg=cfg,
                                             batch_size=8, device="cpu")
    got = port.transcribe(audio, smooth_window=0, keep_logits=True)
    tol = 1e-4 * np.abs(want.logits).max()
    np.testing.assert_allclose(got.logits, want.logits, rtol=0, atol=tol)
    _assert_same_frets(got.logits, want.logits, tol)


def test_conv_stem_checkpoint_raises_the_named_error(tmp_path):
    """The JAX package's error for serving a conv-stem ViT from a torch
    checkpoint (infer/transcribe.py:171-176 there)."""
    path = tmp_path / "ref.pt"
    torch.save({"model_state_dict": {}}, str(path))
    cfg = ModelConfig(arch="vit_native", vit_patch=16, vit_conv_stem=True)
    with pytest.raises(ValueError, match="conv-stem"):
        transcriber_from_torch_checkpoint(str(path), arch="vit_native", model_cfg=cfg,
                                          device="cpu")


def test_vit_small_data_recipe_serves_on_cpu():
    """The vit-small-data recipe's model (conv stem, 19 tokens, the plain
    attention under "auto") through the port's Transcriber."""
    from guitar_tablature_classification_tpu_torch.config import RECIPES

    recipe = RECIPES["vit-small-data"]()
    model_cfg = ModelConfig(**{**recipe.model.__dict__, **SMALL})
    t = Transcriber(None, model_cfg=model_cfg, cqt_cfg=recipe.cqt, batch_size=8, device="cpu")
    assert t.model.vit.embeddings.position_embeddings.shape == (1, 19, 64)
    out = t.transcribe(_audio(1.0), keep_logits=True)
    assert out.logits.shape == (9, 6, 19) and np.isfinite(out.logits).all()
