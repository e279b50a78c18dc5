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


# ------------------------------------------- the backward kernel's plan walk


def _bwd_case(b, h2, c, dtype, seed, mixed_sign=False):
    """Quadrant-layout y on a quarter grid (tie-rich windows in either
    dtype), a pooled gradient and BN affine terms, as the card test's."""
    rng = np.random.default_rng(seed)
    y = np.round(rng.standard_normal((b, 2, h2, 2 * h2 * c)) * 4) / 4
    lo = -1.5 if mixed_sign else 0.5
    se = rng.uniform(lo, 1.5, c).astype(np.float32)
    oe = (rng.standard_normal(c) * 0.1).astype(np.float32)
    g = rng.standard_normal((b, h2, h2 * c)).astype(np.float32)
    return (torch.from_numpy(y).to(dtype), torch.from_numpy(se), torch.from_numpy(oe),
            torch.from_numpy(g).to(dtype))


def _walk_bwd(yq, g, se, oe, fault=None):
    """``csrc/stem.cu`` stem_bwd_kernel walked CTA by CTA over its plan
    (``stem_cuda.bwd_plan``) in fp32 on the CPU, vectorised over a row's
    columns and the CTA's channels: stage the slice of source rows 2*h0-1
    .. 2*h1+1 (slots outside the map stay NaN and are read as the -1 fill
    only), find each window's first-max tap once, gather each source from
    its windows (h+1, w+1), (h+1, w), (h, w+1), (h, w), mask, write dy.
    ``fault`` plants a bug the walk must not hide: "halo" treats O[h0-1] as
    outside the map, "order" gathers in the reverse window order, "slice"
    stages y from the next channel slice.  Returns (dy, float64 partial
    table [parts, 2, C])."""
    b, _, h2, lanes = yq.shape
    c = lanes // (2 * h2)
    w2 = h2
    plan = stem_cuda.bwd_plan(b, h2, w2, c, yq.dtype)
    assert plan.smem_bytes <= stem_cuda.BWD_SMEM_BUDGET
    R, cs = plan.band_rows, plan.cs
    assert cs * yq.element_size() in (16, 32) and c % cs == 0
    y6 = yq.reshape(b, 2, h2, 2, w2, c)
    g4 = g.reshape(b, h2, w2, c)
    dy = torch.zeros_like(y6)
    written = torch.zeros(y6.shape, dtype=torch.int64)
    partial = torch.zeros((plan.parts, 2, c), dtype=torch.float64)
    part_written = torch.zeros((plan.parts, 2, c), dtype=torch.int64)
    order = [(1, 1), (1, 0), (0, 1), (0, 0)]
    if fault == "order":
        order = order[::-1]
    left = (torch.arange(w2) > 0)[:, None]
    for cta in range(plan.grid):
        sl = cta % plan.n_slices
        band = (cta // plan.n_slices) % plan.n_bands
        bi = cta // (plan.n_slices * plan.n_bands)
        h0, h1 = band * R, min(h2, band * R + R)
        last = min(h1, h2 - 1)
        n_win, n_slots = last - h0 + 1, 2 * (h1 - h0) + 3
        ch = slice(sl * cs, (sl + 1) * cs)
        s, o = se[ch], oe[ch]
        # 1. stage: slot k holds image row 2*h0 - 1 + k, [2 col parities, W2, cs]
        ych = ch if fault != "slice" else slice((sl + 1) % plan.n_slices * cs,
                                                 (sl + 1) % plan.n_slices * cs + cs)
        ys = torch.full((n_slots, 2, w2, cs), float("nan"))
        for k in range(n_slots):
            q = 2 * h0 - 1 + k
            if 0 <= q < 2 * h2:
                ys[k] = y6[bi, q % 2, q // 2, :, :, ych].float()
        gs = g4[bi, h0:last + 1, :, ch].float()
        # 2. first-max tap of windows (h0 + i, j): rows O[h-1], E[h], O[h] =
        #    slots 2i..2i+2, columns O[j-1], E[j], O[j]
        taps = torch.empty((n_win, w2, cs), dtype=torch.int64)
        for i in range(n_win):
            top = h0 + i > 0 and not (fault == "halo" and i == 0)
            rows = ys[2 * i:2 * i + 3]
            o_prev = torch.cat([rows[:, 1, :1], rows[:, 1, :-1]], dim=1)  # O[j-1]
            cols = (o_prev, rows[:, 0], rows[:, 1])
            r, m = [], torch.full((w2, cs), -1.0)
            for a in range(3):
                for bb in range(3):
                    t = torch.maximum(cols[bb][a] * s + o, torch.zeros(()))
                    inside = (a > 0 or top) & (left if bb == 0 else torch.ones((), dtype=bool))
                    t = torch.where(inside, t, torch.full((), -1.0))
                    r.append(t)
                    m = torch.maximum(m, t)
            first = torch.full((w2, cs), 9, dtype=torch.int64)
            for tap in reversed(range(9)):
                first = torch.where(r[tap] == m, tap, first)
            taps[i] = first
        # 3. gather, mask, dy, sums
        for hl in range(h1 - h0):
            h = h0 + hl
            for sr in range(2):
                for sc in range(2):
                    acc = torch.zeros((w2, cs))
                    for di, dj in order:
                        a, bb = sr + 1 - 2 * di, sc + 1 - 2 * dj
                        if a < 0 or bb < 0 or h + di >= h2:
                            continue
                        tw = torch.full((w2, cs), 9, dtype=torch.int64)
                        gw = torch.zeros((w2, cs))
                        tw[:w2 - dj] = taps[hl + di, dj:]
                        gw[:w2 - dj] = gs[hl + di, dj:]
                        acc = torch.where(tw == a * 3 + bb, acc + gw, acc)
                    yk = ys[2 * hl + 1 + sr, sc]
                    dz = torch.where(yk * s + o > 0, acc, torch.zeros(()))
                    dy[bi, sr, h, sc, :, ch] = (dz * s).to(yq.dtype)
                    written[bi, sr, h, sc, :, ch] += 1
                    row = bi * plan.n_bands + band
                    partial[row, 0, ch] += dz.double().sum(0)
                    partial[row, 1, ch] += (dz.double() * yk.double()).sum(0)
        part_written[bi * plan.n_bands + band, :, ch] += 1
    assert torch.all(written == 1), "every source is written by exactly one CTA"
    assert torch.all(part_written == 1), "every partial cell is written once"
    return dy.reshape(yq.shape), partial


BWD_WALKS = {  # name: (B, H2, C, dtype, mixed-sign se)
    "flagship_bf16": (1, 56, 64, torch.bfloat16, False),
    "flagship_fp32": (1, 56, 64, torch.float32, False),
    "h2_1": (2, 1, 16, torch.bfloat16, False),
    "h2_3_fp32": (2, 3, 16, torch.float32, True),
    "h2_9": (2, 9, 16, torch.bfloat16, False),
    "c8_bf16": (2, 9, 8, torch.bfloat16, True),
    "c8_fp32": (2, 5, 8, torch.float32, False),
    "c128": (1, 12, 128, torch.bfloat16, False),
}


@pytest.mark.parametrize("name", list(BWD_WALKS))
def test_bwd_kernel_plan_walk_matches_plain(name):
    """The backward kernel's tiling, walked on the CPU, against bwd_plain:
    dy equal (torch.equal: the same fp32 ops in the same order, one
    rounding), the partial table's float64 column sums against the plain
    version's fp32 sums (rtol 1e-5, the card test's)."""
    b, h2, c, dtype, mixed = BWD_WALKS[name]
    yq, se, oe, g = _bwd_case(b, h2, c, dtype, seed=h2 + c, mixed_sign=mixed)
    dy, partial = _walk_bwd(yq, g, se, oe)
    want_dy, want_sdz, want_sdzy = stem_tail.bwd_plain(yq, g, se, oe)
    assert torch.equal(dy, want_dy)
    sums = partial.sum(0)
    torch.testing.assert_close(sums[0], want_sdz.double(), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(sums[1], want_sdzy.double(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("fault", ["halo", "order", "slice"])
def test_bwd_kernel_plan_walk_catches_planted_faults(fault):
    """The walk's comparison sees a dropped halo row (O[h0-1] taken as
    padding), a gather in the wrong window order (fp32 adds do not
    associate where three or four windows route to one source) and y
    staged from the wrong channel slice."""
    yq, se, oe, g = _bwd_case(1, 56, 64, torch.float32, seed=3)
    want_dy, _, _ = stem_tail.bwd_plain(yq, g, se, oe)
    dy, _ = _walk_bwd(yq, g, se, oe, fault=fault)
    assert not torch.equal(dy, want_dy)


def test_bwd_plan_fits_two_ctas_an_sm_and_names_its_limit():
    """The flagship's plan (8-row bands, 16 bf16 channels: 92,288 shared
    bytes, 7 bands x 4 slices an image) and the budget's narrower bands and
    its named limit on wide maps."""
    plan = stem_cuda.bwd_plan(256, 56, 56, 64, torch.bfloat16)
    assert (plan.cs, plan.band_rows, plan.n_bands, plan.n_slices) == (16, 8, 7, 4)
    assert plan.smem_bytes == 92288 and plan.grid == 256 * 28 and plan.parts == 256 * 7
    assert stem_cuda.bwd_plan(1, 56, 56, 64, torch.float32).cs == 8
    assert stem_cuda.bwd_plan(1, 56, 56, 8, torch.bfloat16).cs == 8
    wide = stem_cuda.bwd_plan(1, 200, 200, 64, torch.bfloat16)
    assert wide.band_rows < 8 and wide.smem_bytes <= stem_cuda.BWD_SMEM_BUDGET
    with pytest.raises(ValueError, match=r"needs W2 <= \d+"):
        stem_cuda.bwd_plan(1, 400, 400, 64, torch.bfloat16)
