"""The port's fused native stem (``ops/stem_native.py``) held to the JAX
package's ``ops/stem_native.py`` on the same NumPy inputs, and
``resnet18_native`` with ``stem_fusion="fused"`` and ``bn_fusion="on"``
held to the Flax model.

The port's plain versions follow the Pallas kernel bodies, so they are
compared with the Pallas kernels in interpret mode (which runs bf16 on the
CPU); the differentiable ops with the XLA twin and the interpreted kernels.
Tolerances are the JAX package's (tests/test_stem_native.py): 1e-5 for
conv1 (:57-71) and the forward (:101-103), atol 2e-5 and rtol 1e-4 for the
VJPs (:137-140, :190-194), 1e-5 for the statistics (:156-161); the model as
:227-267 (logits atol 1e-4, rtol 1e-3; loss rtol 1e-5; conv1 and bn1
gradients atol 1e-4, rtol 1e-3; bn1's running mean atol 1e-6, rtol 1e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu.ops import stem_native as jax_sn
from guitar_tablature_classification_tpu_torch.ops import stem_native, stem_native_cuda
from guitar_tablature_classification_tpu_torch.ops.stem_tail import lane_affine

EPS = 1e-5
IMPLS = [("xla", False), ("pallas", True)]


def _case(seed, b=3, h=24, w=9, c=64, quantize=False):
    """conv1 output y [B, H/2, 5, C] of a random input (as the JAX tests
    make it), BN terms, and a pooled cotangent; ``quantize`` puts y on a
    1/4 grid so pooling windows hold many exact ties."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, 1)).astype(np.float32)
    kernel = (rng.standard_normal((7, 7, 1, c)) * 0.2).astype(np.float32)
    y = np.asarray(jax.lax.conv_general_dilated(
        x, kernel, window_strides=(2, 2), padding=[(3, 3), (3, 3)],
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    if quantize:
        y = np.round(y * 4) / 4
    mean = rng.standard_normal(c) * 0.1
    var = rng.uniform(0.5, 2.0, c)
    scale = rng.uniform(0.5, 1.5, c)
    bias = rng.standard_normal(c) * 0.1
    g = rng.standard_normal((b, y.shape[1] // 2, 3, c))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return x, kernel, f32(y), f32(mean), f32(var), f32(scale), f32(bias), f32(g)


def _planes(y, w_pad):
    """[B, Hy, Wy, C] -> (ye, yo) [B, Hy/2, (Wy+w_pad)*C], pad columns 7.7
    (to prove they are masked), as tests/test_stem_native.py:79-87."""
    b, hy, wy, c = y.shape
    yw = np.concatenate([y, np.full((b, hy, w_pad, c), 7.7, y.dtype)], axis=2)
    return (np.ascontiguousarray(yw[:, 0::2]).reshape(b, hy // 2, -1),
            np.ascontiguousarray(yw[:, 1::2]).reshape(b, hy // 2, -1))


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a, dtype=torch.float32, grad=False):
    return torch.tensor(np.asarray(a), dtype=dtype, requires_grad=grad)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("w_pad", [0, 1])
def test_conv1_parity_matches_jax(w_pad):
    """Both planes against conv1_parity_native (atol 1e-5, fp32), from the
    port's OIHW weight."""
    x, kernel, *_ = _case(0, b=2, h=96)
    want = jax_sn.conv1_parity_native(jnp.asarray(x), jnp.asarray(kernel), w_pad=w_pad,
                                      dtype=jnp.float32)
    got = stem_native.conv1_parity_native(_t(x), _t(kernel.transpose(3, 2, 0, 1)),
                                          w_pad=w_pad, dtype=torch.float32)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape == (2, 24, (5 + w_pad) * 64)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_stem_geometry_rejects_odd_conv_height():
    assert stem_native.stem_geometry(96, 9) == jax_sn.stem_geometry(96, 9) == (24, 5)
    with pytest.raises(ValueError):
        stem_native.stem_geometry(94, 9)  # conv1 out 47 rows: no parity split


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_bodies_match_pallas_interpret(dtype, quantize):
    """stats, fwd and bwd plain versions against _stats_pallas, _fwd_pallas
    (sliced to the pooled columns) and _bwd_pallas (fed the zero-expanded
    gradient) in interpret mode: pooled output and dye, dyo equal to one ulp
    of their dtype (at bf16 bit for bit: the same fp32 arithmetic and one
    rounding), per-lane sums to fp32 summation order."""
    *_, y, mean, var, scale, bias, g = _case(1, quantize=quantize)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    if dtype == "bfloat16":
        y, g = _bf16(y), _bf16(g)
    ye, yo = _planes(y, 1)
    c, wreal, wp = 64, 5, 6
    jye, jyo = jnp.asarray(ye, jdt), jnp.asarray(yo, jdt)
    tye, tyo = _t(ye, tdt), _t(yo, tdt)
    # the same per-channel affine on both sides (rsqrt may differ in its
    # last bit between the frameworks), tiled to lanes for the JAX kernels
    tse, toe, _ = lane_affine(*map(_t, (mean, var, scale, bias)), EPS)
    se, oe = (jnp.asarray(np.tile(t.numpy(), wp)) for t in (tse, toe))

    want = np.asarray(jax_sn._stats_pallas(jye, jyo, interpret=True))
    np.testing.assert_allclose(stem_native.stats(tye, tyo).numpy(), want, rtol=1e-5, atol=1e-4)

    tol = 0.0 if dtype == "bfloat16" else 1e-6
    pooled = jax_sn._fwd_pallas(jye, jyo, se, oe, wreal=wreal, wp=wp, c=c, interpret=True)
    got = stem_native.fwd(tye, tyo, tse, toe, wreal)
    assert got.dtype == tdt and tuple(got.shape) == (3, 6, 3, c)
    np.testing.assert_allclose(got.float().numpy(), _f32(jax_sn._slice_pooled(pooled, wreal, c)),
                               rtol=0, atol=tol)
    gq = jax_sn._expand_pool_grad(jnp.asarray(g, jdt), wp, c)
    dye, dyo, sdz, sdzy = jax_sn._bwd_pallas(jye, jyo, gq, se, oe, wreal=wreal, wp=wp, c=c,
                                             interpret=True)
    tdye, tdyo, tsdz, tsdzy = stem_native.bwd(tye, tyo, _t(g, tdt), tse, toe, wreal)
    np.testing.assert_allclose(tdye.float().numpy(), _f32(dye), rtol=0, atol=tol)
    np.testing.assert_allclose(tdyo.float().numpy(), _f32(dyo), rtol=0, atol=tol)
    np.testing.assert_allclose(tsdz.numpy(), np.asarray(sdz), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tsdzy.numpy(), np.asarray(sdzy), rtol=1e-5, atol=1e-4)


def test_ties_route_to_the_first_max_tap():
    """Equal values everywhere: every window is a 9-way tie, so its whole
    gradient lands on its first real tap in row-major order (row 2i-1, col
    2j-1; the top row and left column fall back to the next real tap), and
    the pad column gets nothing."""
    ye = torch.ones(1, 2, 3 * 1)  # H2=2, Wp=3 (wreal 2 + one pad column), C=1
    yo = torch.ones(1, 2, 3 * 1)
    one, zero = torch.ones(1), torch.zeros(1)
    g = torch.tensor([1.0, 2.0]).reshape(1, 2, 1, 1)  # Wout = 1
    dye, dyo, sdz, _ = stem_native.bwd_plain(ye, yo, g, one, zero, 2)
    # window (0, 0): rows {-1, 0, 1}, cols {-1, 0, 1}: first real tap E[0] col 0
    # window (1, 0): rows {1, 2, 3}: first tap O[0] (row 1) col 0
    assert dye.tolist() == [[[1.0, 0.0, 0.0], [0.0, 0.0, 0.0]]]
    assert dyo.tolist() == [[[2.0, 0.0, 0.0], [0.0, 0.0, 0.0]]]
    assert sdz.tolist() == [3.0, 0.0, 0.0]


@pytest.mark.parametrize("impl, interpret", IMPLS)
@pytest.mark.parametrize("w_pad", [0, 1])
def test_native_batch_stats_exclude_pad(impl, interpret, w_pad):
    *_, y, _, _, _, _, _ = _case(3)
    ye, yo = _planes(y, w_pad)
    want = jax_sn.native_batch_stats(jnp.asarray(ye), jnp.asarray(yo), 64, 5, impl=impl,
                                     interpret=interpret)
    got = stem_native.native_batch_stats(_t(ye), _t(yo), 64, 5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl, interpret", IMPLS)
@pytest.mark.parametrize("w_pad", [0, 1])
def test_native_bn_relu_pool_matches_jax(impl, interpret, w_pad):
    """Forward (1e-5) and the eval-mode VJP with its dmean/dvar cotangents:
    ye, yo, mean, var, scale and bias (atol 2e-5, rtol 1e-4)."""
    *_, y, mean, var, scale, bias, g = _case(2)
    ye, yo = _planes(y, w_pad)
    args = [jnp.asarray(a) for a in (ye, yo, mean, var, scale, bias)]

    def jax_loss(ye, yo, mean, var, scale, bias):
        out = jax_sn.native_bn_relu_pool(ye, yo, mean, var, scale, bias, 5, EPS, impl, interpret)
        return jnp.sum(out * g), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=tuple(range(6)), has_aux=True)(*args)
    targs = [_t(a, grad=True) for a in (ye, yo, mean, var, scale, bias)]
    out = stem_native.native_bn_relu_pool(*targs, 5, EPS)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    out.backward(_t(g))
    for name, t, want_g in zip(("ye", "yo", "mean", "var", "scale", "bias"), targs, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), atol=2e-5, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("impl, interpret", IMPLS)
@pytest.mark.parametrize("w_pad", [0, 1])
def test_native_bn_relu_pool_train_matches_jax(impl, interpret, w_pad):
    """Outputs (pooled, mean, var: 1e-5) and the VJP with the batch
    statistics' term for ye, yo, scale and bias (atol 2e-5, rtol 1e-4);
    mean and var carry no gradient."""
    *_, y, _, _, scale, bias, g = _case(4, b=2)
    ye, yo = _planes(y, w_pad)
    args = [jnp.asarray(a) for a in (ye, yo, scale, bias)]

    def jax_loss(ye, yo, scale, bias):
        out = jax_sn.native_bn_relu_pool_train(ye, yo, scale, bias, 5, EPS, impl, interpret)
        return jnp.sum(out[0] * g), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(*args)
    targs = [_t(a, grad=True) for a in (ye, yo, scale, bias)]
    out = stem_native.native_bn_relu_pool_train(*targs, 5, EPS)
    for got, ref in zip(out, want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    assert not out[1].requires_grad and not out[2].requires_grad
    out[0].backward(_t(g))
    for name, t, want_g in zip(("ye", "yo", "scale", "bias"), targs, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), atol=2e-5, rtol=1e-4,
                                   err_msg=name)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the dispatchers run the plain versions and launch
    nothing; another device type raises."""
    *_, y, mean, var, scale, bias, g = _case(5)
    tye, tyo = (_t(p) for p in _planes(y, 1))
    se, oe, _ = lane_affine(*map(_t, (mean, var, scale, bias)), EPS)
    before = dict(stem_native_cuda.launches)
    assert torch.equal(stem_native.stats(tye, tyo), stem_native.stats_plain(tye, tyo))
    assert torch.equal(stem_native.fwd(tye, tyo, se, oe, 5),
                       stem_native.fwd_plain(tye, tyo, se, oe, 5))
    assert stem_native_cuda.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        stem_native.stats(tye.to("meta"), tyo.to("meta"))


# ------------------------------------------- the backward kernel's tiling walk


def _bwd_walk_case(b, h2, wp, wreal, c, dtype, seed, mixed_sign=False, nan=False):
    """Parity planes on a quarter grid (tie-rich windows in either dtype)
    with pad columns of 7.7, a pooled gradient and BN affine terms; ``nan``
    puts one NaN in a real column of yo."""
    rng = np.random.default_rng(seed)
    planes = np.round(rng.standard_normal((2, b, h2, wp, c)) * 4) / 4
    planes[:, :, :, wreal:] = 7.7
    if nan:
        planes[1, b // 2, h2 // 2, wreal // 2, c // 3] = np.nan
    lo = -1.5 if mixed_sign else 0.5
    se = rng.uniform(lo, 1.5, c).astype(np.float32)
    oe = (rng.standard_normal(c) * 0.1).astype(np.float32)
    g = rng.standard_normal((b, h2, stem_native.pool_out_width(wreal), c))
    ye, yo = (torch.from_numpy(p.reshape(b, h2, wp * c)).to(dtype) for p in planes)
    return ye, yo, torch.from_numpy(g).to(dtype), torch.from_numpy(se), torch.from_numpy(oe)


def _walk_native_bwd(ye, yo, g, se, oe, wreal, fault=None):
    """``csrc/stem_native.cu`` native_bwd_kernel walked CTA by CTA over its
    plan (``stem_native_cuda.bwd_plan``) in fp32 on the CPU, vectorised over
    a CTA's channel slice: each CTA walks its run of images in order; an
    image's real columns are staged (the other slots stay NaN, so a read of
    one shows), each window's first-max tap is found once by the kernel's
    scan (a tap only where z exceeds all before it, from 0 at the first
    real tap; a NaN window none), and each gather thread's quads (rows rg,
    rg + RG, ..., column pair q) add their windows (i+1, q+1), (i+1, q),
    (i, q+1), (i, q), mask, and write dye, dyo and the lane sums.
    ``fault`` plants a bug the walk must not hide: "order" gathers in the
    reverse window order, "slice" and "image" stage y from the next channel
    slice or image, "pad" reads the pad column as a real one.  Returns
    (dye, dyo, float64 partial table [parts, 2, Wp*C])."""
    b, h2, lanes = ye.shape
    c = se.shape[0]
    wp, wout = lanes // c, stem_native.pool_out_width(wreal)
    plan = stem_native_cuda.bwd_plan(b, h2, wp, c, ye.dtype)
    assert plan.smem_bytes <= stem_native_cuda.BWD_SMEM_BUDGET
    assert plan.parts <= stem_native_cuda.BWD_CTAS
    cs, ipc = plan.cs, plan.images_per_cta
    nv = cs * ye.element_size() // 16
    assert nv in (1, 2, 4, 8) and c % cs == 0 and stem_native_cuda.BWD_THREADS % nv == 0
    wq = (wp + 1) // 2
    rg_n = plan.row_groups
    assert rg_n * wq * nv <= stem_native_cuda.BWD_THREADS
    real = wp if fault == "pad" else wreal
    planes = [p.reshape(b, h2, wp, c) for p in (ye, yo)]
    g4 = g.reshape(b, h2, wout, c)
    dy = [torch.zeros_like(planes[0]) for _ in range(2)]
    written = torch.zeros((2, b, h2, wp, c), dtype=torch.int64)
    walked = torch.zeros((b, plan.n_slices), dtype=torch.int64)
    partial = torch.zeros((plan.parts, 2, wp, c), dtype=torch.float64)
    part_written = torch.zeros((plan.parts, 2, wp, c), dtype=torch.int64)
    order = [(1, 1), (1, 0), (0, 1), (0, 0)]
    if fault == "order":
        order = order[::-1]
    zero = torch.zeros(())
    for cta in range(plan.grid):
        sl, grp = cta % plan.n_slices, cta // plan.n_slices
        ch = slice(sl * cs, (sl + 1) * cs)
        s, o = se[ch], oe[ch]
        ych = ch
        if fault == "slice":
            nxt = (sl + 1) % plan.n_slices
            ych = slice(nxt * cs, (nxt + 1) * cs)
        sums = torch.zeros((2, wp, cs), dtype=torch.float64)
        for bi in range(grp * ipc, min(b, (grp + 1) * ipc)):  # the ring, in order
            walked[bi, sl] += 1
            # 1. stage: ys [2 planes, H2, Wp, cs], real columns only
            src = (bi + 1) % b if fault == "image" else bi
            ys = torch.full((2, h2, wp, cs), float("nan"))
            for p in range(2):
                ys[p, :, :real] = planes[p][src, :, :real, ych].float()
            gs = g4[bi, :, :, ch].float()
            # 2. each window's first-max tap, vectorised over (i, j)
            yp = torch.full((2, h2 + 1, wp + 2, cs), float("nan"))  # row -1, cols -1 and Wp
            yp[:, 1:, 1:wp + 1] = ys
            i_ = torch.arange(h2)[:, None, None]
            j_ = torch.arange(wout)[None, :, None]
            first = (torch.where(i_ > 0, 0, 3) + torch.where(j_ > 0, 0, 1)).expand(h2, wout, cs)
            m = torch.zeros((h2, wout, cs))
            for a in range(3):
                p, dh = (0, 0) if a == 1 else (1, -1 if a == 0 else 0)
                for bb in range(3):
                    inside = ((a > 0) | (i_ > 0)) & ((bb != 0) | (j_ > 0)) & (
                        (bb != 2) | (2 * j_ + 1 < real))
                    y = yp[p, 1 + dh:1 + dh + h2, bb:bb + 2 * wout - 1:2]
                    z = torch.where(inside, y * s + o, torch.full((), -1.0))
                    first = torch.where(z > m, a * 3 + bb, first)
                    m = torch.maximum(m, z)
            taps = torch.where(torch.isnan(m), 9, first)
            # 3. the gather threads' quads
            for rg in range(rg_n):
                for q in range(wq):
                    for i in range(rg, h2, rg_n):
                        tw, gw = {}, {}
                        for di in range(2):
                            for dj in range(2):
                                inw = (di == 0 or i + 1 < h2) and q + dj < wout
                                tw[di, dj] = taps[i + di, q + dj] if inw else torch.full((cs,), 9)
                                gw[di, dj] = gs[i + di, q + dj] if inw else torch.zeros(cs)
                        for sr in range(2):
                            for sc in range(2):
                                w = 2 * q + sc
                                if w >= wp:
                                    continue
                                acc = torch.zeros(cs)
                                for di, dj in order:
                                    a, bb = sr + 1 - 2 * di, sc + 1 - 2 * dj
                                    if a >= 0 and bb >= 0:
                                        acc = torch.where(tw[di, dj] == a * 3 + bb,
                                                          acc + gw[di, dj], acc)
                                yk = ys[sr, i, w] if w < real else torch.zeros(cs)
                                dz = torch.where((w < real) & (yk * s + o > 0), acc, zero)
                                dy[sr][bi, i, w, ch] = (dz * s).to(ye.dtype)
                                written[sr, bi, i, w, ch] += 1
                                sums[0, w] += dz.double()
                                sums[1, w] += dz.double() * yk.double()
        # 4. this CTA's row of the partial table, at its slice
        partial[grp, :, :, ch] = sums
        part_written[grp, :, :, ch] += 1
    assert torch.all(walked == 1), "every image is walked once at every slice"
    assert torch.all(written == 1), "every source is written by exactly one thread"
    assert torch.all(part_written == 1), "every partial cell is written once"
    return dy[0].reshape(ye.shape), dy[1].reshape(yo.shape), partial.reshape(plan.parts, 2, -1)


NATIVE_BWD_WALKS = {  # name: (B, H2, Wp, Wreal, C, dtype, CTAs, mixed-sign se, NaN)
    "model_bf16": (5, 24, 6, 5, 64, torch.bfloat16, 2, False, False),  # runs of 3 and 2
    "model_fp32": (5, 24, 6, 5, 64, torch.float32, 4, True, False),  # two 32-channel slices
    "b1": (1, 24, 6, 5, 64, torch.bfloat16, 264, False, False),
    "h2_1": (3, 1, 6, 5, 16, torch.bfloat16, 2, True, False),
    "w_pad0_bf16": (4, 24, 5, 5, 64, torch.bfloat16, 3, False, False),
    "w_pad0_fp32": (3, 7, 5, 5, 16, torch.float32, 264, True, False),
    "c8_bf16": (3, 24, 6, 5, 8, torch.bfloat16, 2, True, False),
    "c8_fp32": (2, 9, 6, 5, 8, torch.float32, 264, False, False),
    "c128": (3, 12, 6, 5, 128, torch.bfloat16, 4, True, False),
    "narrow_odd": (2, 5, 4, 3, 24, torch.bfloat16, 264, False, False),  # Wout 2, a pad pair
    "nan": (3, 24, 6, 5, 64, torch.bfloat16, 2, False, True),
    "nan_fp32": (2, 24, 6, 5, 16, torch.float32, 264, True, True),
}


@pytest.mark.parametrize("name", list(NATIVE_BWD_WALKS))
def test_native_bwd_walk_matches_plain(name, monkeypatch):
    """The backward kernel's tiling, walked on the CPU, against bwd_plain:
    dye and dyo equal (torch.equal: the same fp32 ops in the same order,
    one rounding), the partial table's float64 column sums against the
    plain version's fp32 sums (rtol 1e-5, the card test's; a NaN lane in
    both)."""
    b, h2, wp, wreal, c, dtype, ctas, mixed, nan = NATIVE_BWD_WALKS[name]
    monkeypatch.setattr(stem_native_cuda, "BWD_CTAS", ctas)  # runs of images at B <= 8
    ye, yo, g, se, oe = _bwd_walk_case(b, h2, wp, wreal, c, dtype, seed=h2 + c + b,
                                       mixed_sign=mixed, nan=nan)
    dye, dyo, partial = _walk_native_bwd(ye, yo, g, se, oe, wreal)
    want_dye, want_dyo, want_sdz, want_sdzy = stem_native.bwd_plain(ye, yo, g, se, oe, wreal)
    assert torch.equal(dye, want_dye) and torch.equal(dyo, want_dyo)
    sums = partial.sum(0)
    torch.testing.assert_close(sums[0], want_sdz.double(), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(sums[1], want_sdzy.double(), rtol=1e-5, atol=1e-4,
                               equal_nan=nan)
    assert torch.isnan(sums[1]).any() == nan


@pytest.mark.parametrize("fault", ["order", "slice", "image", "pad"])
def test_native_bwd_walk_catches_planted_faults(fault, monkeypatch):
    """The walk's comparison sees a gather in the wrong window order (fp32
    adds do not associate where three or four windows route to one source),
    y staged from the wrong channel slice or image, and the pad column (7.7)
    read as a real one."""
    ye, yo, g, se, oe = _bwd_walk_case(4, 24, 6, 5, 64, torch.float32, seed=3)
    want_dye, want_dyo, _, _ = stem_native.bwd_plain(ye, yo, g, se, oe, 5)
    monkeypatch.setattr(stem_native_cuda, "BWD_CTAS", 3)
    assert stem_native_cuda.bwd_plan(4, 24, 6, 64, torch.float32).n_slices == 2
    dye, dyo, _ = _walk_native_bwd(ye, yo, g, se, oe, 5, fault=fault)
    assert not (torch.equal(dye, want_dye) and torch.equal(dyo, want_dyo))


def test_native_bwd_plan_fits_two_ctas_an_sm_and_names_its_limit():
    """The model shape's plan (all 64 bf16 channels a CTA, 16 images a CTA
    on 256 CTAs, 96,768 shared bytes: two CTAs an SM), fp32's two slices,
    the narrower slices of tall maps and the named limit."""
    plan = stem_native_cuda.bwd_plan(4096, 24, 6, 64, torch.bfloat16)
    assert (plan.cs, plan.n_slices, plan.images_per_cta, plan.parts, plan.grid) == (
        64, 1, 16, 256, 256)
    assert plan.smem_bytes == 96768 and plan.row_groups == 8
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
    assert stem_native_cuda.bwd_plan(4096, 24, 5, 64, torch.bfloat16).smem_bytes == 84480
    fp32 = stem_native_cuda.bwd_plan(4096, 24, 6, 64, torch.float32)
    assert (fp32.cs, fp32.n_slices, fp32.grid) == (32, 2, 256)
    assert stem_native_cuda.bwd_plan(37, 24, 6, 64, torch.bfloat16).parts == 37
    ragged = stem_native_cuda.bwd_plan(529, 24, 6, 64, torch.bfloat16)
    assert ragged.images_per_cta == 3 and ragged.parts == 177  # the last CTA takes one
    tall = stem_native_cuda.bwd_plan(2, 100, 6, 64, torch.bfloat16)
    assert tall.cs < 64 and tall.smem_bytes <= stem_native_cuda.BWD_SMEM_BUDGET
    with pytest.raises(ValueError, match=r"needs H2 <= \d+"):
        stem_native_cuda.bwd_plan(1, 400, 6, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="C % 8"):
        stem_native_cuda.bwd_plan(1, 24, 6, 12, torch.bfloat16)


# -------------------------------------------- the forward kernel's tiling walk


def _fwd_thread_cover(h2, wreal, nv):
    """The forward kernel's per-thread walkers (``csrc/stem_native.cu``
    native_fwd_kernel): thread tid keeps vector u = tid % NV; it copies, and
    turns into r, the (row, real column) pairs tid / NV, + FWD_THREADS / NV,
    ... stepped without division (``step``), and pools rows tid / NV, +
    FWD_THREADS / NV, ...  Returns how often each (row, column, vector) is
    copied and each (pooled row, vector) is pooled."""
    threads = stem_native_cuda.FWD_THREADS
    copied = torch.zeros((2 * h2, wreal, nv), dtype=torch.int64)
    pooled = torch.zeros((h2, nv), dtype=torch.int64)
    p_step = threads // nv
    dq, dr = divmod(p_step, wreal)
    for tid in range(threads):
        u = tid % nv
        r, w = divmod(tid // nv, wreal)
        while r < 2 * h2:
            copied[r, w, u] += 1
            w, r = w + dr, r + dq
            if w >= wreal:
                w, r = w - wreal, r + 1
        for i in range(tid // nv, h2, p_step):
            pooled[i, u] += 1
    return copied, pooled


def _walk_native_fwd(ye, yo, se, oe, wreal, fault=None):
    """``csrc/stem_native.cu`` native_fwd_kernel walked CTA by CTA over its
    plan (``stem_native_cuda.fwd_plan``) on the CPU, vectorised over a CTA's
    channel slice: each CTA walks its run of images in order; an image's
    real columns are staged (the other slots stay NaN, so a read of one
    shows), turned into r = max(y*se + oe, 0) in place and held in y's dtype
    (step 1), and each pooled row takes each real column's max over rows
    O[i-1], E[i], O[i], then each window's over columns 2j-1, 2j, 2j+1
    (step 2).  ``fault`` plants a bug the walk must not hide: "image" and
    "slice" stage y from the next image or channel slice, "pad" reads the
    pad column as a real one.  Returns the pooled output [B, H2, Wout, C]."""
    b, h2, lanes = ye.shape
    c = se.shape[0]
    wp, wout = lanes // c, stem_native.pool_out_width(wreal)
    plan = stem_native_cuda.fwd_plan(b, h2, wp, c, ye.dtype)
    assert plan.smem_bytes <= stem_native_cuda.FWD_SMEM_BUDGET
    assert plan.parts <= stem_native_cuda.FWD_CTAS
    cs, ipc = plan.cs, plan.images_per_cta
    nv = cs * ye.element_size() // 16
    assert nv in (1, 2, 4, 8) and c % cs == 0 and stem_native_cuda.FWD_THREADS % nv == 0
    copied, pooled = _fwd_thread_cover(h2, wreal, nv)
    assert torch.all(copied == 1) and torch.all(pooled == 1)
    real = wp if fault == "pad" else wreal
    planes = [p.reshape(b, h2, wp, c) for p in (ye, yo)]
    out = torch.zeros((b, h2, wout, c), dtype=ye.dtype)
    written = torch.zeros((b, h2, wout, c), dtype=torch.int64)
    walked = torch.zeros((b, plan.n_slices), dtype=torch.int64)
    for cta in range(plan.grid):
        sl, grp = cta % plan.n_slices, cta // plan.n_slices
        ch = slice(sl * cs, (sl + 1) * cs)
        ych = ch
        if fault == "slice":
            nxt = (sl + 1) % plan.n_slices
            ych = slice(nxt * cs, (nxt + 1) * cs)
        s, o = se[ch], oe[ch]
        for bi in range(grp * ipc, min(b, (grp + 1) * ipc)):  # the ring, in order
            walked[bi, sl] += 1
            src = (bi + 1) % b if fault == "image" else bi
            ys = torch.full((2, h2, wp, cs), float("nan"))
            for p in range(2):
                ys[p, :, :real] = planes[p][src, :, :real, ych].float()
            # 1. r in place, a product then a sum, NaN kept, held in T
            r = torch.maximum(ys * s + o, torch.zeros(()))
            r = r.to(ye.dtype).float()
            # 2. columns over rows O[i-1], E[i], O[i]; windows over columns
            cm = torch.maximum(r[0], r[1])
            cm[1:] = torch.maximum(cm[1:], r[1, :-1])
            for j in range(wout):
                cols = [w for w in (2 * j - 1, 2 * j, 2 * j + 1) if 0 <= w < real]
                m = cm[:, cols[0]]
                for w in cols[1:]:
                    m = torch.maximum(m, cm[:, w])
                out[bi, :, j, ch] = m.to(ye.dtype)
                written[bi, :, j, ch] += 1
    assert torch.all(walked == 1), "every image is walked once at every slice"
    assert torch.all(written == 1), "every pooled output is written once"
    return out


@pytest.mark.parametrize("name", list(NATIVE_BWD_WALKS))
def test_native_fwd_walk_matches_plain(name, monkeypatch):
    """The forward kernel's tiling, walked on the CPU, against fwd_plain at
    the backward walk's shapes: equal bit for bit (the same fp32 ops, a
    rounding to y's dtype that is monotone, so it commutes with the max; a
    NaN where the plain version has one)."""
    b, h2, wp, wreal, c, dtype, ctas, mixed, nan = NATIVE_BWD_WALKS[name]
    monkeypatch.setattr(stem_native_cuda, "FWD_CTAS", ctas)  # runs of images at B <= 8
    ye, yo, _, se, oe = _bwd_walk_case(b, h2, wp, wreal, c, dtype, seed=h2 + c + b,
                                       mixed_sign=mixed, nan=nan)
    got = _walk_native_fwd(ye, yo, se, oe, wreal)
    want = stem_native.fwd_plain(ye, yo, se, oe, wreal)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isnan(got).any()) == nan


@pytest.mark.parametrize("fault", ["image", "slice", "pad"])
def test_native_fwd_walk_catches_planted_faults(fault, monkeypatch):
    """The walk's comparison sees y staged from the wrong image or channel
    slice, and the pad column (7.7) read as a real one."""
    ye, yo, _, se, oe = _bwd_walk_case(4, 24, 6, 5, 64, torch.float32, seed=3)
    want = stem_native.fwd_plain(ye, yo, se, oe, 5)
    monkeypatch.setattr(stem_native_cuda, "FWD_CTAS", 3)
    assert stem_native_cuda.fwd_plan(4, 24, 6, 64, torch.float32).n_slices == 2
    got = _walk_native_fwd(ye, yo, se, oe, 5, fault=fault)
    assert not torch.equal(got, want)


def test_native_fwd_plan_fits_three_ctas_an_sm_and_names_its_limit():
    """The model shape's plan (all 64 bf16 channels a CTA, 11 images a CTA
    on 373 CTAs, 73,728 shared bytes: three CTAs an SM), fp32's two slices,
    serving's batch, the narrower slices of tall maps and the named limit."""
    plan = stem_native_cuda.fwd_plan(4096, 24, 6, 64, torch.bfloat16)
    assert (plan.cs, plan.n_slices, plan.images_per_cta, plan.parts, plan.grid) == (
        64, 1, 11, 373, 373)
    assert plan.smem_bytes == 73728 and plan.smem_bytes <= stem_native_cuda.FWD_SMEM_BUDGET
    assert 3 * (stem_native_cuda.FWD_SMEM_BUDGET + 1024) <= 228 * 1024
    assert stem_native_cuda.fwd_plan(4096, 24, 5, 64, torch.bfloat16).smem_bytes == 61440
    fp32 = stem_native_cuda.fwd_plan(4096, 24, 6, 64, torch.float32)
    assert (fp32.cs, fp32.n_slices, fp32.grid) == (32, 2, 392)
    assert stem_native_cuda.fwd_plan(2048, 24, 6, 64, torch.bfloat16).images_per_cta == 6
    tall = stem_native_cuda.fwd_plan(2, 100, 6, 64, torch.bfloat16)
    assert tall.cs < 64 and tall.smem_bytes <= stem_native_cuda.FWD_SMEM_BUDGET
    with pytest.raises(ValueError, match=r"forward kernel needs H2 <= \d+"):
        stem_native_cuda.fwd_plan(1, 400, 6, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="C % 8"):
        stem_native_cuda.fwd_plan(1, 24, 6, 12, torch.bfloat16)


# ------------------------------------------------- model: native-best fused


def _jax_native_net(fused):
    """The JAX resnet18_native GuitarTabNet (fp32), heads' dropout at 0;
    ``fused``: stem_fusion="fused" and bn_fusion="on"."""
    from flax import linen as fnn

    from guitar_tablature_classification_tpu.models.heads import StringBranchHeads
    from guitar_tablature_classification_tpu.models.resnet import ResNet18

    class Net(fnn.Module):
        @fnn.compact
        def __call__(self, x, train: bool = False):
            feats = ResNet18(num_features=256, input_channels=1, dtype=jnp.float32,
                             fused_bn=fused, fused_native_stem=fused, name="resnet")(x, train=train)
            return StringBranchHeads(dropout=(0.0, 0.0), name="heads")(feats, train=train)

    return Net()


def _port_native(variables, cfg):
    from guitar_tablature_classification_tpu_torch.models import build_model, state_dict_from_flax
    from guitar_tablature_classification_tpu_torch.models.heads import Dropout

    model = build_model(cfg)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, variables)), strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


@functools.lru_cache(maxsize=None)
def _native_case():
    """Flax variables of the fused native model, one batch of 8 raw CQT
    windows, and the JAX eval logits, train-mode loss, gradients and
    batch statistics."""
    from guitar_tablature_classification_tpu.ops import label_smoothing_loss

    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (8, 96, 9, 1)).astype(np.float32)
    labels = rng.integers(0, 19, (8, 6)).astype(np.int32)
    net = _jax_native_net(True)
    init = jax.jit(functools.partial(net.init, train=False))  # jitted: far faster on the CPU
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(2), x))

    def loss(params):
        out, upd = net.apply({**variables, "params": params}, x, train=True,
                             mutable=["batch_stats"])
        return label_smoothing_loss(out, jnp.asarray(labels)), upd["batch_stats"]

    (jl, stats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    logits = np.asarray(jax.jit(functools.partial(net.apply, train=False))(variables, x))
    return x, labels, variables, logits, float(jl), grads, stats


def test_native_fused_model_matches_flax():
    """resnet18_native + stem_fusion="fused" + bn_fusion="on" at fp32 on
    the Flax model's weights: eval logits (atol 1e-4, rtol 1e-3), train
    loss (rtol 1e-5), bn1's gradients (atol 1e-4, rtol 1e-3), every
    gradient by tests/test_bn_pallas.py:169-192's percentile-based check,
    and the batch statistics (bn1's mean atol 1e-6, rtol 1e-5; every
    BatchNorm's atol 1e-4, rtol 1e-3)."""
    from guitar_tablature_classification_tpu_torch.config import ModelConfig
    from guitar_tablature_classification_tpu_torch.models import state_dict_from_flax
    from guitar_tablature_classification_tpu_torch.models.resnet import FusedBatchNorm
    from guitar_tablature_classification_tpu_torch.ops.loss import label_smoothing_loss

    x, labels, variables, logits, jl, grads, stats = _native_case()
    cfg = ModelConfig(arch="resnet18_native", stem_fusion="fused", bn_fusion="on",
                      dtype="float32")
    model = _port_native(variables, cfg)
    assert model.resnet.fused_native_stem
    assert sum(isinstance(m, FusedBatchNorm) for m in model.modules()) == 20
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, logits, atol=1e-4, rtol=1e-3)
    model.train()
    tl = label_smoothing_loss(model(torch.from_numpy(x), torch.Generator()),
                              torch.from_numpy(labels))
    tl.backward()
    np.testing.assert_allclose(float(tl), jl, rtol=1e-5)
    want = state_dict_from_flax(jax.tree.map(np.asarray, {"params": grads, "batch_stats": stats}))
    params = dict(model.named_parameters())
    # bn1's gradients are channel sums: held element for element.  conv1's
    # are held by the percentile check below, as every gradient: across the
    # two frameworks fp32 noise may flip a ReLU or pool decision in the
    # trunk, and one flip moves a single weight gradient past atol 1e-4
    for name in ("resnet.bn1.weight", "resnet.bn1.bias"):
        np.testing.assert_allclose(params[name].grad.numpy(), want[name].numpy(), atol=1e-4,
                                   rtol=1e-3, err_msg=name)
    for name, p in params.items():
        ref = want[name].numpy()
        diff = np.abs(p.grad.numpy() - ref) / max(1e-6, np.abs(ref).max())
        assert diff.mean() < 5e-3 and diff.max() < 0.2, (name, diff.mean(), diff.max())
    sd = model.state_dict()
    np.testing.assert_allclose(sd["resnet.bn1.running_mean"].numpy(),
                               want["resnet.bn1.running_mean"].numpy(), atol=1e-6, rtol=1e-5)
    for key, ref in want.items():
        if "running" in key:
            np.testing.assert_allclose(sd[key].numpy(), ref.numpy(), atol=1e-4, rtol=1e-3,
                                       err_msg=key)


def test_native_fused_train_step_matches_jax():
    """One make_train_step step of path B's model (fp32, B=8) against the
    JAX make_train_step from the same state, as tests/test_torch_train.py
    holds the plain native-best: loss (rtol 1e-5), raw gradient norm (rtol
    1e-3), then parameters, running averages and Adam moments."""
    from test_torch_train import _assert_state_matches, _batch

    from guitar_tablature_classification_tpu.config import OptimConfig as JaxOptimConfig
    from guitar_tablature_classification_tpu.train import create_train_state as jax_create_state
    from guitar_tablature_classification_tpu.train import make_preprocess as jax_make_preprocess
    from guitar_tablature_classification_tpu.train import make_train_step as jax_make_train_step
    from guitar_tablature_classification_tpu_torch.config import ModelConfig, OptimConfig
    from guitar_tablature_classification_tpu_torch.train import (
        create_train_state,
        make_preprocess,
        make_train_step,
    )

    cfg = ModelConfig(arch="resnet18_native", stem_fusion="fused", bn_fusion="on",
                      dtype="float32")
    jmodel = _jax_native_net(True)
    jpre = jax_make_preprocess(cfg)
    feats, labels = _batch(0)
    jstate = jax.jit(lambda x: jax_create_state(  # jitted init: far faster on the CPU
        jmodel, JaxOptimConfig(), jax.random.PRNGKey(0), x))(jpre(jnp.asarray(feats[:1])))
    model = _port_native({"params": jstate.params, "batch_stats": jstate.batch_stats}, cfg)
    state = create_train_state(model, OptimConfig(), device="cpu")
    lr = 5e-4
    jstate, jm = jax_make_train_step(jmodel, jpre)(
        jstate, {"features": jnp.asarray(feats), "labels": jnp.asarray(labels)},
        jax.random.PRNGKey(1), lr)
    m = make_train_step(model, make_preprocess(cfg))(
        state, {"features": torch.from_numpy(feats), "labels": torch.from_numpy(labels)},
        torch.Generator().manual_seed(0), lr)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    _assert_state_matches(state, jstate, 1, lr)
