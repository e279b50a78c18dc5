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
