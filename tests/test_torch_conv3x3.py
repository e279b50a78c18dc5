"""The port's 3x3 conv with a fused ReLU-affine (``ops/conv3x3.py``) held to
the JAX repo's TPU probe kernel ``tools/probe_pallas_conv.py::
pallas_conv3x3``, run under ``force_tpu_interpret_mode`` on the CPU, on the
same NumPy inputs.

Tolerance: within one bf16 ulp (of the larger magnitude) plus 1e-5 of
max|out|.  Both sides take the same bf16 affine (checked bit for bit
below) and the same exact fp32 products, and round once from fp32 sums
whose order may differ; the floor covers outputs near zero.  At these
sizes, on the CPU, the two agree bit for bit.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu_torch.ops import conv3x3, conv3x3_cuda
from guitar_tablature_classification_tpu_torch.tools import probe_conv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def probe():
    """tools/probe_pallas_conv.py, loaded from its path.  At load it makes a
    fixed cache directory and sets two JAX cache options for the whole
    process (:22-24); both calls are no-ops while it loads, so the test
    writes nothing outside its checkout and the other tests of this worker
    keep their JAX config."""
    spec = importlib.util.spec_from_file_location(
        "probe_pallas_conv", os.path.join(ROOT, "tools", "probe_pallas_conv.py"))
    module = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "makedirs", lambda *a, **k: None)
        mp.setattr(jax.config, "update", lambda *a, **k: None)
        spec.loader.exec_module(module)
    return module


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _t(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()


def _case(seed, b=2, h=8, w=8, c=16, f=32):
    """The probe's input recipe (rng.standard_normal x, 0.02-scaled HWIO
    weights, s in [0.5, 1.5], o ~ 0.1 N(0, 1)) at a small size."""
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((b, h, w, c)))
    wk = _bf16(rng.standard_normal((3, 3, c, f)) * 0.02)
    s = _bf16(rng.uniform(0.5, 1.5, c))
    o = _bf16(rng.standard_normal(c) * 0.1)
    return x, wk.reshape(9, c, f), s, o


def _assert_within_one_ulp(got, want):
    _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)).astype(np.float32))
    limit = np.ldexp(np.float32(1.0), e - 8) + 1e-5 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= limit), np.abs(got - want).max()


@pytest.mark.parametrize("variant", ["sum9", "concat"])
def test_matches_pallas_interpret(probe, variant):
    from jax.experimental.pallas import tpu as pltpu

    x, w9, s, o = _case(0)
    with pltpu.force_tpu_interpret_mode():
        want = probe.pallas_conv3x3(x, w9, s, o, row_chunk=4, bt=1, variant=variant)
    want = np.asarray(want.astype(jnp.float32))
    got = conv3x3.conv3x3_affine_relu(_t(x), _t(w9), _t(s), _t(o), variant=variant,
                                      row_chunk=4, bt=1)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _assert_within_one_ulp(got.float().numpy(), want)


def test_affine_rounds_twice_as_jax_does():
    """A jitted bf16 x*s + o on the JAX CPU backend rounds the product,
    then the sum: the port's affine equals it on every element, where one
    rounding of the exact x*s + o does not."""
    rng = np.random.default_rng(1)
    x, s, o = (_bf16(a) for a in (rng.standard_normal(8192), rng.uniform(0.5, 1.5, 8192),
                                  rng.standard_normal(8192) * 0.1))
    want = np.asarray(jax.jit(lambda x, s, o: jnp.maximum(x * s + o, 0.0))(x, s, o)
                      .astype(jnp.float32))
    got = conv3x3.affine_relu(_t(x), _t(s), _t(o)).float().numpy()
    assert np.array_equal(got, want)
    f32 = [np.asarray(a.astype(jnp.float32)) for a in (x, s, o)]
    once = np.asarray(_bf16(np.maximum(f32[0] * f32[1] + f32[2], 0)).astype(jnp.float32))
    assert not np.array_equal(once, want)


def test_halo_is_zero_after_the_affine():
    """Padding lies in the post-ReLU domain: with o > 0 everywhere the
    affine of a zero input is not zero, yet the border outputs see zeros
    (a 1x1 image reduces to the centre tap)."""
    c, f = 8, 8
    x = torch.zeros((1, 1, 1, c), dtype=torch.bfloat16)
    w9 = torch.ones((9, c, f), dtype=torch.bfloat16)
    s = torch.ones(c, dtype=torch.bfloat16)
    o = torch.full((c,), 0.5, dtype=torch.bfloat16)
    out = conv3x3.conv3x3_affine_relu(x, w9, s, o)
    assert torch.equal(out, torch.full((1, 1, 1, f), 0.5 * c, dtype=torch.bfloat16))


def test_probe_options_map_to_one_function_and_cpu_launches_nothing():
    x, w9, s, o = (_t(a) for a in _case(2, b=4, h=6, w=5))
    want = conv3x3.conv3x3_plain(x, w9, s, o)
    before = dict(conv3x3_cuda.launches)
    for kw in ({}, dict(variant="concat"), dict(variant="sum9", row_chunk=3, bt=2)):
        assert torch.equal(conv3x3.conv3x3_affine_relu(x, w9, s.reshape(1, -1),
                                                       o.reshape(1, -1), **kw), want)
    assert conv3x3_cuda.launches == before
    with pytest.raises(ValueError, match="variant"):
        conv3x3.conv3x3_affine_relu(x, w9, s, o, variant="im2col")
    with pytest.raises(ValueError, match="bt=3"):
        conv3x3.conv3x3_affine_relu(x, w9, s, o, bt=3)
    with pytest.raises(ValueError, match="w9"):
        conv3x3.conv3x3_affine_relu(x, w9[:, :8], s, o)
    with pytest.raises(ValueError, match="unsupported device"):
        conv3x3.conv3x3_affine_relu(x.to("meta"), w9, s, o)


def test_probe_conv_runs_on_the_cpu():
    """The probe that is the kernel's entry point: per case the yardstick
    (alone and with the affine) and one kernel row for both variants (the
    probe checks they give the same bits), its parity figure within one
    bf16 ulp of max|ref|; on the CPU nothing launches."""
    before = dict(conv3x3_cuda.launches)
    rows = probe_conv.probe(device="cpu", batch=2, iters=1, cases=((6, 16, 24, 4, 3),))
    assert [r["route"] for r in rows] == ["cuDNN", "cuDNN+affine", "kernel sum9/concat"]
    assert rows[2]["parity"] <= 2.0**-7
    assert conv3x3_cuda.launches == before


# ---- the kernel's tile plan (csrc/conv3x3.cu), walked in float64 NumPy

def _walk_kernel_plan(t, w9, f_cols=None):
    """float64 walk of csrc/conv3x3.cu's plan on the affine's output ``t``
    [B, H, W, C] (what the kernel's transform leaves in shared memory) and
    w9 [9, C, F]: per CTA a TH x TW block of one image (tile_shape) and 64
    filters; per 16-channel chunk the halo block (TH+2) x (TW+2) staged once
    (zero outside the image and past C), w9's [9][16][64] slice (zero past C
    and F); the nine taps as shifted halo addresses of the kernel's lane
    formula (a padding slot reads halo pixel 0); chunks in order, taps in
    order.  Returns the output and how often each output was written."""
    b, h, w, c = t.shape
    f = w9.shape[-1]
    th, tw = conv3x3_cuda.tile_shape(h, w)
    bm, bn, kc = conv3x3_cuda.TILE_PIXELS, conv3x3_cuda.COLS, conv3x3_cuda.CHUNK
    hw2, halo = tw + 2, (th + 2) * (tw + 2)
    assert th * tw <= bm and halo <= conv3x3_cuda.HALO_MAX
    p = np.arange(bm)
    a_hp = np.where(p < th * tw, (p // tw) * hw2 + p % tw, 0)
    taps = [(tap // 3) * hw2 + tap % 3 for tap in range(9)]
    assert a_hp.max() + max(taps) < halo
    out = np.zeros((b, h, w, f))
    written = np.zeros((b, h, w, f), np.int32)
    steps = -(-c // kc)
    for bi in range(b):
        for h0 in range(0, h, th):
            for w0 in range(0, w, tw):
                hp = np.arange(halo)
                hh, ww = h0 - 1 + hp // hw2, w0 - 1 + hp % hw2
                inside = (hh >= 0) & (hh < h) & (ww >= 0) & (ww < w)
                for n0 in range(0, f, bn):
                    acc = np.zeros((bm, bn))
                    for step in range(steps):
                        c0 = step * kc
                        chans = c0 + np.arange(kc)
                        stage = np.zeros((halo, kc))
                        cl = chans < c
                        stage[np.ix_(inside, cl)] = t[bi, hh[inside], ww[inside]][:, chans[cl]]
                        cols = n0 + np.arange(bn)
                        ws = np.zeros((9, kc, bn))
                        fl = cols < f
                        ws[np.ix_(np.arange(9), cl, fl)] = w9[:, chans[cl]][:, :, cols[fl]]
                        for tap in range(9):
                            acc += stage[a_hp + taps[tap]] @ ws[tap]
                    r = p[p < th * tw]
                    oh, ow = h0 + r // tw, w0 + r % tw
                    keep = (oh < h) & (ow < w)
                    cols = n0 + np.arange(bn)
                    fl = cols < f
                    out[bi, oh[keep][:, None], ow[keep][:, None], cols[fl][None, :]] = \
                        acc[r[keep]][:, fl]
                    written[bi, oh[keep][:, None], ow[keep][:, None], cols[fl][None, :]] += 1
    return out, written


def _dense_conv64(t, w9):
    b, h, w, c = t.shape
    tp = np.pad(t, ((0, 0), (1, 1), (1, 1), (0, 0)))
    return sum(tp[:, dy:dy + h, dx:dx + w] @ w9[dy * 3 + dx]
               for dy in range(3) for dx in range(3))


@pytest.mark.parametrize("shape", [
    (1, 56, 56, 64, 64), (1, 28, 28, 128, 128), (1, 14, 14, 256, 256),  # the probe's maps
    (3, 7, 7, 64, 64), (2, 5, 9, 40, 136),  # ragged blocks, C off the chunk, F off the tile
    (1, 1, 37, 8, 8), (2, 40, 3, 24, 16), (1, 2, 300, 8, 72),  # H or W under the block
])
def test_kernel_plan_matches_dense_conv(shape):
    """The kernel's blocks, halo addressing, channel chunks and w9 slices
    sum exactly the dense conv of the affine's output (float64, rtol
    1e-9), each output written once."""
    b, h, w, c, f = shape
    rng = np.random.default_rng(sum(shape))
    x, w9, s, o = (torch.from_numpy(a) for a in (
        rng.standard_normal((b, h, w, c)).astype(np.float32),
        (0.05 * rng.standard_normal((9, c, f))).astype(np.float32),
        rng.uniform(0.5, 1.5, c).astype(np.float32),
        (0.1 * rng.standard_normal(c)).astype(np.float32)))
    x, w9, s, o = (a.to(torch.bfloat16) for a in (x, w9, s, o))
    t = conv3x3.affine_relu(x, s, o).double().numpy()
    w9d = w9.double().numpy()
    got, written = _walk_kernel_plan(t, w9d)
    assert written.min() == 1 and written.max() == 1
    want = _dense_conv64(t, w9d)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12 * np.abs(want).max())


def test_tile_plan_at_the_probe_shapes():
    """The blocks the kernel takes at the probe's maps, and the L2 reads
    they imply at B=256: x 129 / 118 / 103 MB (a design that stages one tap
    of 128 pixels a step reads 925 / 462 / 462), w9 264 / 302 / 302 MB (462
    when each 128 pixels read it)."""
    assert conv3x3_cuda.tile_shape(56, 56) == (28, 8)
    assert conv3x3_cuda.tile_shape(28, 28) == (14, 14)
    assert conv3x3_cuda.tile_shape(14, 14) == (14, 14)
    for (h, c), x_mb, w9_mb in (((56, 64), 129, 264), ((28, 128), 118, 302),
                                ((14, 256), 103, 302)):
        got = conv3x3_cuda.l2_bytes(256, h, h, c, c)
        assert round(got["x"] / 1e6) == x_mb and round(got["w9"] / 1e6) == w9_mb
    for h in range(1, 80):
        for w in (1, 2, 7, 8, 9, 37, 56, 200, 300):
            th, tw = conv3x3_cuda.tile_shape(h, w)
            assert th <= h and tw <= w and th * tw <= conv3x3_cuda.TILE_PIXELS
            assert (th + 2) * (tw + 2) <= conv3x3_cuda.HALO_MAX
