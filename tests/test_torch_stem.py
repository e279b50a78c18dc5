"""The port's fused stem (``ops/stem_fusion.py``, ``ops/stem_tail.py``) held
to the JAX package's ``ops/stem_fusion.py`` and ``ops/stem_pallas.py`` on
the same NumPy inputs.

The port's plain versions follow the Pallas kernel bodies, so they are
compared with the Pallas kernels in interpret mode (which runs bf16 on the
CPU) and, at fp32, with the XLA twin too.  Tolerances are the JAX
package's (tests/test_stem_pallas.py): 1e-5 forward (:64-66), 2e-5 and
rtol 1e-4 for the ``bn_relu_pool`` VJP (:91-93), 1e-5 / 3e-5 and rtol 1e-4
for ``bn_relu_pool_train`` (:141-165), 1e-4 for the quadrant front
(:180-185).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu.ops import stem_fusion as jax_front
from guitar_tablature_classification_tpu.ops import stem_pallas as jax_tail
from guitar_tablature_classification_tpu_torch.ops import stem_cuda, stem_fusion, stem_tail

EPS = 1e-5
IMPLS = [("xla", False), ("pallas", True)]
BF16_ULP = 2.0**-7  # bf16 spacing at [1, 2)


def _case(seed, b=3, h=8, w=8, c=8, quantize=False):
    """NHWC y and per-channel BN terms; ``quantize`` puts y on a 1/4 grid
    so pooling windows hold many exact ties."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((b, h, w, c))
    if quantize:
        y = np.round(y * 4) / 4
    mean = rng.standard_normal(c) * 0.1
    var = rng.uniform(0.5, 2.0, c)
    scale = rng.uniform(0.5, 1.5, c)
    bias = rng.standard_normal(c) * 0.1
    g = rng.standard_normal((b, h // 2, w // 2, c))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(y), f32(mean), f32(var), f32(scale), f32(bias), f32(g)


def _to_bf16(a):
    """NumPy fp32 holding bf16-representable values (the bf16 cases feed
    both frameworks the same bf16 numbers)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a, dtype=torch.float32, grad=False):
    return torch.tensor(np.asarray(a), dtype=dtype, requires_grad=grad)


def test_quadrant_pack_matches_jax_and_round_trips():
    y, *_ = _case(0, b=2, h=6, w=10, c=4)
    got = stem_tail.quadrant_pack(_t(y))
    want = np.asarray(jax_tail.quadrant_pack(jnp.asarray(y)))
    assert got.shape == (2, 2, 3, 40)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(stem_tail.quadrant_unpack(got, 4), _t(y))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_bodies_match_pallas_interpret(dtype):
    """stats, fwd and bwd plain versions against the Pallas kernels run in
    interpret mode, on tie-rich input: pooled output and dy equal to one
    ulp of their dtype (at bf16: bit for bit, the same fp32 arithmetic and
    one rounding), channel sums to fp32 summation order."""
    y, mean, var, scale, bias, g = _case(1, quantize=True)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    if dtype == "bfloat16":
        y, g = _to_bf16(y), _to_bf16(g)
    c, h2 = y.shape[-1], y.shape[1] // 2
    yq = jax_tail.quadrant_pack(jnp.asarray(y, jdt))
    tyq = stem_tail.quadrant_pack(_t(y, tdt))
    se, oe, _, _ = jax_tail._lane_affine(*map(jnp.asarray, (mean, var, scale, bias)), EPS,
                                         yq.shape[-1])
    tse, toe, _ = stem_tail.lane_affine(*map(_t, (mean, var, scale, bias)), EPS)
    gq = jnp.asarray(g, jdt).reshape(g.shape[0], h2, -1)
    tg = _t(g, tdt).reshape(g.shape[0], h2, -1)

    sums = np.asarray(jax_tail._stats_pallas(yq, interpret=True)).reshape(2, -1, c).sum(1)
    np.testing.assert_allclose(stem_tail.stats(tyq).numpy(), sums, rtol=1e-5, atol=1e-5)

    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    tol = 0.0 if dtype == "bfloat16" else 1e-6
    pooled = jax_tail._fwd_pallas(yq, se, oe, h2=h2, c=c, interpret=True)
    np.testing.assert_allclose(stem_tail.fwd(tyq, tse, toe).float().numpy(), f32(pooled),
                               rtol=0, atol=tol)
    dy, sdz, sdzy = jax_tail._bwd_pallas(yq, gq, se, oe, h2=h2, c=c, interpret=True)
    tdy, tsdz, tsdzy = stem_tail.bwd(tyq, tg, tse, toe)
    np.testing.assert_allclose(tdy.float().numpy(), f32(dy), rtol=0, atol=tol)
    np.testing.assert_allclose(tsdz.numpy(), np.asarray(sdz).reshape(-1, c).sum(0),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tsdzy.numpy(), np.asarray(sdzy).reshape(-1, c).sum(0),
                               rtol=1e-5, atol=1e-5)


def test_ties_route_to_the_first_max_tap():
    """A map of equal values: every window is a 9-way tie, so the whole
    pooled gradient lands on its first tap in row-major order, O[i-1] x
    O[j-1] (E x E for the top-left window, whose first three taps are
    padding)."""
    tyq = stem_tail.quadrant_pack(torch.ones(1, 4, 4, 1))
    one, zero = torch.ones(1), torch.zeros(1)
    g = torch.arange(1.0, 5.0).reshape(1, 2, 2)
    dy, sdz, _ = stem_tail.bwd_plain(tyq, g, one, zero)
    grad = stem_tail.quadrant_unpack(dy, 1)[0, :, :, 0]
    want = torch.zeros(4, 4)
    want[0, 0] = 1.0  # window (0, 0): taps O[-1], O[-1]-col are padding -> E[0] x E[0]
    want[0, 1] = 2.0  # window (0, 1): first real tap E[0] x O[0] (row 0, col 1)
    want[1, 0] = 3.0  # window (1, 0): O[0] x E[0] (row 1, col 0)
    want[1, 1] = 4.0  # window (1, 1): O[0] x O[0] (row 1, col 1)
    assert torch.equal(grad, want)
    assert float(sdz) == 10.0


@pytest.mark.parametrize("impl, interpret", IMPLS)
def test_bn_relu_pool_matches_jax(impl, interpret):
    """Forward (atol 1e-5) and the VJP for y, mean, var, scale and bias
    (atol 2e-5, rtol 1e-4) at fp32."""
    y, mean, var, scale, bias, g = _case(2)
    args = [jnp.asarray(a) for a in (y, mean, var, scale, bias)]

    def jax_loss(y, mean, var, scale, bias):
        out = jax_tail.bn_relu_pool(jax_tail.quadrant_pack(y), mean, var, scale, bias,
                                    EPS, impl, interpret)
        return jnp.sum(out * g), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(*args)
    targs = [_t(a, grad=True) for a in (y, mean, var, scale, bias)]
    out = stem_tail.bn_relu_pool(stem_tail.quadrant_pack(targs[0]), *targs[1:], EPS)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5)
    out.backward(_t(g))
    for name, t, want_g in zip(("y", "mean", "var", "scale", "bias"), targs, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), atol=2e-5, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("impl, interpret", IMPLS)
def test_bn_relu_pool_train_matches_jax(impl, interpret):
    """Outputs (pooled, mean, var: atol 1e-5) and the VJP for y, scale and
    bias (atol 3e-5, rtol 1e-4) at fp32."""
    y, _, _, scale, bias, g = _case(3, b=2)
    args = [jnp.asarray(a) for a in (y, scale, bias)]

    def jax_loss(y, scale, bias):
        out = jax_tail.bn_relu_pool_train(jax_tail.quadrant_pack(y), scale, bias, EPS,
                                          impl, interpret)
        return jnp.sum(out[0] * g), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(*args)
    targs = [_t(a, grad=True) for a in (y, scale, bias)]
    out = stem_tail.bn_relu_pool_train(stem_tail.quadrant_pack(targs[0]), *targs[1:], EPS)
    for got, ref in zip(out, want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5)
    assert not out[1].requires_grad and not out[2].requires_grad
    out[0].backward(_t(g))
    for name, t, want_g in zip(("y", "scale", "bias"), targs, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), atol=3e-5, rtol=1e-4,
                                   err_msg=name)


def test_bn_relu_pool_train_bf16_matches_pallas_interpret():
    """At bf16, against the Pallas kernels in interpret mode.  The
    statistics are reduced in other orders, so se and oe may differ in
    their last fp32 bit and move a bf16 rounding: pooled values and the
    gradient are held to one bf16 ulp of their scale; mean, var (fp32) to
    1e-5; dscale and dbias (fp32 sums over bf16 dz) to rtol 1e-4."""
    y, _, _, scale, bias, g = _case(4, b=2, quantize=True)
    y, g = _to_bf16(y), _to_bf16(g)
    args = [jnp.asarray(y, jnp.bfloat16), jnp.asarray(scale), jnp.asarray(bias)]

    def jax_loss(y, scale, bias):
        out = jax_tail.bn_relu_pool_train(jax_tail.quadrant_pack(y), scale, bias, EPS,
                                          "pallas", True)
        return jnp.sum(out[0].astype(jnp.float32) * g), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(*args)
    ty = _t(y, torch.bfloat16, grad=True)
    ts, tb = _t(scale, grad=True), _t(bias, grad=True)
    out = stem_tail.bn_relu_pool_train(stem_tail.quadrant_pack(ty), ts, tb, EPS)
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    ref = f32(want[0])
    np.testing.assert_allclose(out[0].detach().float().numpy(), ref, rtol=0,
                               atol=BF16_ULP * np.abs(ref).max())
    np.testing.assert_allclose(out[1].numpy(), np.asarray(want[1]), atol=1e-5)
    np.testing.assert_allclose(out[2].numpy(), np.asarray(want[2]), atol=1e-5)
    out[0].float().backward(_t(g))
    dref = f32(grads[0])
    np.testing.assert_allclose(ty.grad.float().numpy(), dref, rtol=0,
                               atol=BF16_ULP * np.abs(dref).max())
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(grads[1]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(grads[2]), rtol=1e-4, atol=1e-4)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrappers run the plain versions and launch nothing;
    another device type raises."""
    y, mean, var, scale, bias, g = _case(5)
    tyq = stem_tail.quadrant_pack(_t(y))
    before = dict(stem_cuda.launches)
    se, oe, _ = stem_tail.lane_affine(*map(_t, (mean, var, scale, bias)), EPS)
    assert torch.equal(stem_tail.fwd(tyq, se, oe), stem_tail.fwd_plain(tyq, se, oe))
    assert torch.equal(stem_tail.stats(tyq), stem_tail.stats_plain(tyq))
    assert stem_cuda.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        stem_tail.stats(tyq.to("meta"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quadrant", [True, False])
def test_precomposed_front_matches_jax(dtype, quadrant):
    """atol and rtol 1e-4 at fp32 (tests/test_stem_pallas.py:180-185); at
    bf16 the output is rounded once from an fp32 sum whose order differs,
    so it may sit one bf16 ulp away."""
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (2, 96, 9)).astype(np.float32)
    w = (rng.standard_normal((7, 7, 3, 64)) * 0.05).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jfn = jax_front.precomposed_conv1_quadrant if quadrant else jax_front.precomposed_conv1
    tfn = stem_fusion.precomposed_conv1_quadrant if quadrant else stem_fusion.precomposed_conv1
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(w), dtype=jdt).astype(jnp.float32))
    got = tfn(_t(x), _t(w.transpose(3, 2, 0, 1)), dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_ULP, atol=1e-4)


def test_precomposed_front_gradient_reaches_conv1_weight():
    """Gradients flow to the OIHW conv1 weight through the factorization,
    as JAX's do to its HWIO kernel (atol 1e-4, fp32)."""
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (2, 96, 9)).astype(np.float32)
    w = (rng.standard_normal((7, 7, 3, 64)) * 0.05).astype(np.float32)
    g = rng.standard_normal((2, 2, 56, 112 * 64)).astype(np.float32)
    want = jax.grad(lambda w: jnp.sum(jax_front.precomposed_conv1_quadrant(
        jnp.asarray(x), w, dtype=jnp.float32) * g))(jnp.asarray(w))
    tw = _t(w.transpose(3, 2, 0, 1), grad=True)
    (stem_fusion.precomposed_conv1_quadrant(_t(x), tw, dtype=torch.float32) * _t(g)).sum().backward()
    ref = np.asarray(want).transpose(3, 2, 0, 1)
    np.testing.assert_allclose(tw.grad.numpy(), ref, atol=1e-4 * np.abs(ref).max(), rtol=1e-4)
