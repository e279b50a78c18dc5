"""The port's fused trunk BatchNorm (``ops/bn_fused.py``,
``models/resnet.py::FusedBatchNorm``) held to the JAX package's
``ops/bn_pallas.py`` and ``FusedBatchNorm`` on the same NumPy inputs, and
the fused 224^2 flagship with ``bn_fusion="on"`` held to the Flax model.

The JAX side runs as its own tests run it: the Pallas kernels in interpret
mode, the XLA twin, and the models' CPU default.  Tolerances are the JAX
package's (tests/test_bn_pallas.py): 1e-5 on the forward (:43-54), atol 2e-5
and rtol 1e-4 on the gradients (:74-76); sums to fp32 summation order (rtol
1e-5).  At bf16, PyTorch rounds ``(y - mean) * mul + bias`` to bf16 after
each operation, while XLA on the CPU may keep fp32 between the fused
operations: the outputs are held to two bf16 ulps of their scale
(``BF16_ULP``).

``tests/test_bn_pallas.py::test_lane_view_rejects_misaligned`` has no
counterpart: the 128-lane view is a TPU layout rule; the port's kernel reads
any size through the tensor's own memory layout
(``test_lane_view_folds_to_channel_sums``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu.models.resnet import FusedBatchNorm as JaxFusedBN
from guitar_tablature_classification_tpu.ops import bn_pallas as jax_bn
from guitar_tablature_classification_tpu_torch.models.resnet import FusedBatchNorm
from guitar_tablature_classification_tpu_torch.ops import bn_cuda, bn_fused

EPS = 1e-5
BF16_ULP = 2.0**-7  # bf16 spacing at [1, 2)
IMPLS = [("xla", False), ("pallas", True)]


def _case(seed, b=2, h=4, w=4, c=8, dtype="float32"):
    """NHWC y, per-channel scale and bias, and a cotangent like y."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((b, h, w, c)) * 1.5 + 0.3
    g = rng.standard_normal((b, h, w, c))
    scale = rng.uniform(0.5, 1.5, c)
    bias = rng.standard_normal(c) * 0.1
    if dtype == "bfloat16":  # bf16-representable values for both frameworks
        y, g = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (y, g))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(y), f32(g), f32(scale), f32(bias)


def _nchw(a, dtype=torch.float32, channels_last=False, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype).permute(0, 3, 1, 2)
    t = t.contiguous(memory_format=torch.channels_last if channels_last
                     else torch.contiguous_format)
    return t.requires_grad_(grad)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [8, 64, 128, 512])
def test_sums_match_pallas_and_xla(c, dtype):
    """sums_plain and grad_sums_plain against _sums_pallas and
    _grad_sums_pallas in interpret mode and the XLA twin, on the JAX
    package's lane view folded to channels."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    y, g, _, _ = _case(c, c=c, dtype=dtype)
    y2, _ = jax_bn._lane_view(jnp.asarray(y, jdt), c)
    g2, _ = jax_bn._lane_view(jnp.asarray(g, jdt), c)
    fold = lambda s: np.stack([np.asarray(jax_bn._fold(s[k], c)) for k in (0, 1)])  # noqa: E731
    got = bn_fused.sums_plain(_nchw(y, tdt)).numpy()
    got_g = bn_fused.grad_sums_plain(_nchw(y, tdt), _nchw(g, tdt)).numpy()
    for want, want_g in ((jax_bn._sums_pallas(y2, interpret=True),
                          jax_bn._grad_sums_pallas(y2, g2, interpret=True)),
                         (jax_bn._xla_sums(y2), jax_bn._xla_grad_sums(y2, g2))):
        np.testing.assert_allclose(got, fold(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_g, fold(want_g), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("shape", [(3, 16, 5, 7), (4, 64, 24, 3), (2, 128, 6, 1), (2, 512, 3, 1)])
def test_lane_view_folds_to_channel_sums(shape, layout):
    """What the kernel reads: the tensor's memory as a row-major
    [rows, lanes] matrix whose per-lane sums, folded by lane l -> channel
    (l // div) % C, are the channel sums.  Covers the native trunk's
    spatial sizes (72, 24, 6, 3 values a channel) in both memory formats;
    another layout raises."""
    rng = np.random.default_rng(1)
    y = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if layout == "channels_last":
        y = y.contiguous(memory_format=torch.channels_last)
    rows, lanes, div = bn_cuda.lane_view(y)
    c = shape[1]
    assert rows * lanes == y.numel() and lanes % (c * div) == 0
    mem = torch.as_strided(y, (rows, lanes), (lanes, 1))
    channel = (torch.arange(lanes) // div) % c
    folded = torch.zeros(c).index_add_(0, channel, mem.sum(0))
    torch.testing.assert_close(folded, bn_fused.sums_plain(y)[0], rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="channels-last"):
        bn_cuda.lane_view(y.transpose(0, 1))


def _jax_bn_train(y, scale, bias, impl, interpret, g):
    def loss(y, scale, bias):
        out = jax_bn.batch_norm_train(y, scale, bias, EPS, impl, interpret)
        return jnp.sum(out[0].astype(jnp.float32) * jnp.asarray(g)), out

    return jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(y, scale, bias)


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("impl, interpret", IMPLS)
def test_batch_norm_train_matches_jax_fp32(impl, interpret, layout):
    """(out, mean, var) to 1e-5 and the VJP for y, scale and bias to atol
    2e-5, rtol 1e-4, from either memory format."""
    y, g, scale, bias = _case(2, c=128)
    (_, want), grads = _jax_bn_train(*map(jnp.asarray, (y, scale, bias)), impl, interpret, g)
    ty = _nchw(y, channels_last=layout == "channels_last", grad=True)
    ts, tb = (torch.from_numpy(a).requires_grad_(True) for a in (scale, bias))
    out, mean, var = bn_fused.batch_norm_train(ty, ts, tb, EPS)
    assert not mean.requires_grad and not var.requires_grad
    if layout == "channels_last":
        assert out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(out), np.asarray(want[0]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want[1]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(want[2]), atol=1e-5, rtol=1e-5)
    out.backward(_nchw(g, channels_last=layout == "nchw"))  # the other layout than y
    np.testing.assert_allclose(_nhwc(ty.grad), np.asarray(grads[0]), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(grads[1]), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(grads[2]), atol=2e-5, rtol=1e-4)


def test_batch_norm_train_matches_pallas_interpret_bf16():
    """At bf16 against the Pallas kernels in interpret mode: out and dy to
    two bf16 ulps of their scale (rounding places differ, see the module
    docstring; dy is one fp32 expression rounded once on both sides, so it
    differs only where the statistics' last fp32 bit moves a rounding);
    mean and var to 1e-5; dscale and dbias (fp32 sums over bf16 products)
    to rtol 1e-4."""
    y, g, scale, bias = _case(3, b=4, c=64, dtype="bfloat16")
    (_, want), grads = _jax_bn_train(jnp.asarray(y, jnp.bfloat16), jnp.asarray(scale),
                                     jnp.asarray(bias), "pallas", True, g)
    ty = _nchw(y, torch.bfloat16, grad=True)
    ts, tb = (torch.from_numpy(a).requires_grad_(True) for a in (scale, bias))
    out, mean, var = bn_fused.batch_norm_train(ty, ts, tb, EPS)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(want[0].astype(jnp.float32))
    np.testing.assert_allclose(_nhwc(out), ref, rtol=0, atol=2 * BF16_ULP * np.abs(ref).max())
    np.testing.assert_allclose(mean.numpy(), np.asarray(want[1]), atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(want[2]), atol=1e-5)
    out.float().backward(_nchw(g))
    dref = np.asarray(grads[0].astype(jnp.float32))
    np.testing.assert_allclose(_nhwc(ty.grad), dref, rtol=0, atol=2 * BF16_ULP * np.abs(dref).max())
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(grads[1]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(grads[2]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False])
def test_module_matches_jax_fused_batchnorm(train, dtype):
    """FusedBatchNorm against the JAX FusedBatchNorm (impl 'xla'), from
    perturbed running statistics: outputs (1e-5 at fp32; two bf16 ulps of
    the scale at bf16, where eval mode is the JAX bf16 affine, not an fp32
    normalize) and the running statistics (1e-5)."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    y, _, scale, bias = _case(4, b=4, c=64, dtype=dtype)
    rng = np.random.default_rng(5)
    ra_mean = (rng.standard_normal(64) * 0.3).astype(np.float32)
    ra_var = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    jm = JaxFusedBN(use_running_average=not train, dtype=jdt, impl="xla")
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": ra_mean, "var": ra_var}}
    want, upd = jm.apply(variables, jnp.asarray(y, jdt), mutable=["batch_stats"])
    mod = FusedBatchNorm(64)
    with torch.no_grad():
        for name, val in (("weight", scale), ("bias", bias), ("running_mean", ra_mean),
                          ("running_var", ra_var)):
            getattr(mod, name).copy_(torch.from_numpy(val))
    mod.train(train)
    out = mod(_nchw(y, tdt))
    assert out.dtype == tdt
    ref = np.asarray(want.astype(jnp.float32))
    atol = 1e-5 if dtype == "float32" else 2 * BF16_ULP * np.abs(ref).max()
    np.testing.assert_allclose(_nhwc(out), ref, rtol=1e-5 if dtype == "float32" else 0, atol=atol)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(mod, name).numpy(), np.asarray(upd["batch_stats"][key]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the dispatchers run the plain versions and launch
    nothing; another device type raises."""
    y, g, _, _ = _case(6)
    ty, tg = _nchw(y), _nchw(g)
    before = dict(bn_cuda.launches)
    assert torch.equal(bn_fused.sums(ty), bn_fused.sums_plain(ty))
    assert torch.equal(bn_fused.grad_sums(ty, tg), bn_fused.grad_sums_plain(ty, tg))
    assert bn_cuda.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        bn_fused.sums(ty.to("meta"))


# ------------------------------------------------ model: the 224^2 flagship


@functools.lru_cache(maxsize=None)
def _flagship_case():
    """The JAX fused flagship with fused BatchNorms (heads' dropout at 0),
    its variables, and, from one CQT batch (B=4, fp32), its eval logits and
    its train-mode loss, gradients and batch statistics."""
    from flax import linen as fnn

    from guitar_tablature_classification_tpu.models.heads import StringBranchHeads
    from guitar_tablature_classification_tpu.models.resnet import ResNet18
    from guitar_tablature_classification_tpu.ops import label_smoothing_loss
    from guitar_tablature_classification_tpu.train import make_preprocess as jax_make_preprocess
    from guitar_tablature_classification_tpu_torch.config import ModelConfig

    class Net(fnn.Module):
        @fnn.compact
        def __call__(self, x, train: bool = False):
            feats = ResNet18(num_features=256, input_channels=3, dtype=jnp.float32,
                             fused_front=224, fused_tail=True, fused_bn=True,
                             name="resnet")(x, train=train)
            return StringBranchHeads(dropout=(0.0, 0.0), name="heads")(feats, train=train)

    rng = np.random.default_rng(8)
    feats = rng.uniform(-120, 0, (4, 96, 9)).astype(np.float32)
    labels = rng.integers(0, 19, (4, 6)).astype(np.int32)
    cfg = ModelConfig(arch="resnet18", stem_fusion="fused", bn_fusion="on", dtype="float32")
    x = jax_make_preprocess(cfg)(jnp.asarray(feats))
    net = Net()
    init = jax.jit(functools.partial(net.init, train=False))  # jitted: far faster on the CPU
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(3), x))

    def loss(params):
        out, upd = net.apply({**variables, "params": params}, x, train=True,
                             mutable=["batch_stats"])
        return label_smoothing_loss(out, jnp.asarray(labels)), upd["batch_stats"]

    (jl, stats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    logits = np.asarray(jax.jit(functools.partial(net.apply, train=False))(variables, x))
    return cfg, feats, labels, variables, logits, float(jl), grads, stats


def test_flagship_with_fused_bn_matches_flax():
    """resnet18 + stem_fusion="fused" + bn_fusion="on" at fp32 against the
    Flax model on the same weights: eval logits (atol 1e-4 of their scale,
    as tests/test_torch_models.py), train-mode loss (rtol 1e-3), every
    gradient by tests/test_bn_pallas.py:169-192's percentile-based check
    (mean normalized error < 5e-3, max < 0.2), and the batch statistics of
    every BatchNorm (atol 1e-4, rtol 1e-3)."""
    from guitar_tablature_classification_tpu_torch.models import build_model, state_dict_from_flax
    from guitar_tablature_classification_tpu_torch.models.heads import Dropout
    from guitar_tablature_classification_tpu_torch.ops.loss import label_smoothing_loss
    from guitar_tablature_classification_tpu_torch.train import make_preprocess

    cfg, feats, labels, variables, logits, jl, grads, stats = _flagship_case()
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    assert sum(isinstance(m, FusedBatchNorm) for m in model.modules()) == 20
    x = make_preprocess(cfg)(torch.from_numpy(feats))
    with torch.no_grad():
        got = model.eval()(x).numpy()
    np.testing.assert_allclose(got, logits, rtol=0, atol=1e-4 * np.abs(logits).max())
    model.train()
    tl = label_smoothing_loss(model(x, torch.Generator()), torch.from_numpy(labels))
    tl.backward()
    np.testing.assert_allclose(float(tl), jl, rtol=1e-3)
    want = state_dict_from_flax(jax.tree.map(np.asarray, {"params": grads, "batch_stats": stats}))
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        diff = np.abs(p.grad.numpy() - ref) / max(1e-6, np.abs(ref).max())
        assert diff.mean() < 5e-3 and diff.max() < 0.2, (name, diff.mean(), diff.max())
    sd = model.state_dict()
    for key, ref in want.items():
        if "running" in key:
            np.testing.assert_allclose(sd[key].numpy(), ref.numpy(), atol=1e-4, rtol=1e-3,
                                       err_msg=key)
