"""The port's attention (plain version and dispatch rule) held to the JAX
package's ``fused_attention`` (Pallas, interpret mode) and to
``jax.nn.dot_product_attention`` on the same NumPy inputs.

Shapes and tolerances are the JAX package's own
(``tests/test_models.py:304-377,713-737``): fp32 output atol 2e-5 and
gradients atol 1e-4 (5e-5 for the multi-tile case); bf16 output
atol = rtol = 3e-2 and gradients atol 0.25, rtol 0.1.  On the CPU the
port's ``fused_attention`` is its plain version, and its gradients come
from autograd through it.
"""

import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu.ops.attention_pallas import (
    fused_attention as jax_fused_attention,
)
from guitar_tablature_classification_tpu_torch.ops import attention as port_attention
from guitar_tablature_classification_tpu_torch.ops import attention_cuda
from guitar_tablature_classification_tpu_torch.ops.attention import (
    attention_reference,
    fused_attention,
    resolve_attention,
)

TOL = {
    "float32": {"out": dict(atol=2e-5, rtol=0), "grad": dict(atol=1e-4, rtol=0)},
    "bfloat16": {"out": dict(atol=3e-2, rtol=3e-2), "grad": dict(atol=0.25, rtol=0.1)},
}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    # round through the working dtype once, so both sides see the same values
    arrays = [np.array(jnp.asarray(a, JNP[dtype]), np.float32) for a in arrays]
    return arrays


def _port(arrays, dtype, fn, loss):
    ts = [torch.from_numpy(a).to(TORCH[dtype]).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    loss(out.float()).backward()
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in ts]


def _jax(arrays, dtype, fn, loss):
    js = [jnp.asarray(a, JNP[dtype]) for a in arrays]
    out = jax.jit(fn)(*js)  # jitted: op-by-op dispatch is slow on the CPU
    grads = jax.jit(jax.grad(lambda *x: loss(fn(*x).astype(jnp.float32)),
                             argnums=(0, 1, 2)))(*js)
    return np.asarray(out, np.float32), [np.asarray(g, np.float32) for g in grads]


SQUARE = (lambda x: (x ** 2).sum(), lambda x: jnp.sum(x ** 2))
TANH = (lambda x: torch.tanh(x).sum(), lambda x: jnp.sum(jnp.tanh(x)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape, seed, losses, grad_atol", [
    ((2, 50, 4, 64), 7, SQUARE, None),    # N not tile-aligned
    ((1, 40, 2, 64), 8, SQUARE, None),    # the gradient tests' shape
    ((1, 200, 2, 64), 11, TANH, 5e-5),    # two q-tiles at q_tile=128
])
def test_fused_attention_matches_pallas_interpret(dtype, shape, seed, losses, grad_atol):
    """The port's fused_attention (the plain version on the CPU) against
    the Pallas kernels in interpret mode (q_tile=128), values and
    gradients."""
    arrays = _qkv(shape, dtype, seed)
    got, got_g = _port(arrays, dtype, fused_attention, losses[0])
    want, want_g = _jax(arrays, dtype,
                        lambda q, k, v: jax_fused_attention(q, k, v, q_tile=128, interpret=True),
                        losses[1])
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, **TOL[dtype]["out"])
    grad_tol = dict(TOL[dtype]["grad"])
    if grad_atol is not None and dtype == "float32":
        grad_tol["atol"] = grad_atol
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, **grad_tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape, seed", [((2, 50, 4, 64), 7), ((1, 200, 2, 32), 3)])
def test_attention_reference_matches_dot_product_attention(dtype, shape, seed):
    """The plain version is jax.nn.dot_product_attention's function (any
    head dim), values and gradients."""
    arrays = _qkv(shape, dtype, seed)
    got, got_g = _port(arrays, dtype, attention_reference, SQUARE[0])
    want, want_g = _jax(arrays, dtype, jax.nn.dot_product_attention, SQUARE[1])
    np.testing.assert_allclose(got, want, **TOL[dtype]["out"])
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, **TOL[dtype]["grad"])


def test_fused_attention_on_strided_views():
    """q, k and v as strided views of one [B, N, 3*H*Dh] projection (the
    ViT block's layout) give what contiguous copies give."""
    rng = np.random.default_rng(5)
    b, n, h, dh = 2, 37, 3, 64
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * dh)).astype(np.float32))
    views = [t.view(b, n, h, dh) for t in qkv.split(h * dh, dim=-1)]
    assert views[1].stride() == (n * 3 * h * dh, 3 * h * dh, dh, 1)
    got = fused_attention(*views)
    want = fused_attention(*(t.contiguous() for t in views))
    assert torch.equal(got, want)


@pytest.mark.parametrize("impl, tokens, want", [
    ("auto", 785, "pallas"),
    ("auto", 197, "pallas"),
    ("auto", 129, "pallas"),
    ("auto", 128, "xla"),
    ("auto", 65, "xla"),
    ("auto", 37, "xla"),
    ("auto", 19, "xla"),
    ("pallas", 37, "pallas"),   # explicit choices are never overridden
    ("xla", 785, "xla"),
])
def test_resolve_attention_token_aware(impl, tokens, want):
    """The JAX package's rule (tests/test_models.py:591-607), with the
    fused path available: on the card it is the Hopper kernels, on the CPU
    the plain version."""
    assert resolve_attention(impl, tokens=tokens) == want


def test_resolve_attention_rejects_unknown_impl():
    with pytest.raises(ValueError, match="attention_impl"):
        resolve_attention("flash", tokens=785)


def test_cpu_tensors_never_reach_the_kernels():
    """On the CPU fused_attention takes the plain version: no kernel is
    built or launched, and the kernel wrappers refuse CPU tensors."""
    before = dict(attention_cuda.launches)
    q = torch.zeros(1, 3, 2, 64)
    fused_attention(q, q, q)
    assert attention_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        attention_cuda.fwd(q, q, q)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 785, 6), (2, 50, 4), (1, 300, 2)])
def test_chip_smoke_limits_reject_faulty_attention(dtype, shape):
    """chip_smoke.py's relative limits on the plain version's own inputs:
    each faulty version it must reject (a halved dV, dS without its rowsum
    term, the last key left out) is rejected, and the value GEMM on
    unrounded weights, a rounding-order difference, is not.  At [1, 785, 6]
    in bf16 the JAX package's limits alone pass the halved dV."""
    smoke = _chip_smoke()
    b, n, h = shape
    rng = np.random.default_rng(11)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * 64)).astype(np.float32))
    leaf = qkv.to(TORCH[dtype]).requires_grad_(True)
    views = [t.view(b, n, h, 64) for t in leaf.split(h * 64, dim=-1)]
    g = torch.from_numpy(rng.standard_normal((b, n, h, 64)).astype(np.float32)).to(TORCH[dtype])
    want = attention_reference(*views)
    want_grads = torch.autograd.grad(want, views, g)
    q, k, v = (t.detach() for t in views)
    controls = smoke.attention_controls(
        torch, port_attention, q, k, v, g, want.detach(), want_grads, dtype)
    assert all(controls[name]["rejected"] for name in smoke.ATTN_MUST_FAIL), controls
    assert not controls["p_unrounded"]["rejected"], controls
    if n == 785 and dtype == "bfloat16":
        assert controls["dv_halved"]["jax_limits_pass"], controls


PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115attn_fwd_kernelIfEEvNS_4ViewES1_S1_PT_Pfiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115attn_fwd_kernelIfEEvNS_4ViewES1_S1_PT_Pfiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119attn_fwd_mma_kernelENS_4ViewES0_S0_P13__nv_bfloat16Pfiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119attn_fwd_mma_kernelENS_4ViewES0_S0_P13__nv_bfloat16Pfiif
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z12other_kernelPf' for 'sm_90a'
ptxas info    : Function properties for _Z12other_kernelPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 16 registers, used 0 barriers
"""


def test_chip_smoke_reports_each_attention_kernels_registers_and_spills(capsys):
    """chip_smoke.py's build report (a log shaped like the H100 build's):
    each attn_ kernel's -Xptxas -v lines by name, the fp32 instantiations
    marked, other kernels left out, and the card's occupancy beside them."""
    smoke = _chip_smoke()
    fake = types.SimpleNamespace(kernel_info=lambda: {"attn_fwd_mma_kernel": {"ctas_per_sm": 4}})
    smoke.attention_build_report({"attention_cuda": fake}, PTXAS_LOG)
    out = capsys.readouterr().out
    assert ("attn_fwd_kernel<float>: 0 bytes stack frame, 0 bytes spill stores, 0 bytes "
            "spill loads; Used 64 registers, used 1 barriers") in out
    assert ("attn_fwd_mma_kernel: 8 bytes stack frame, 8 bytes spill stores, 8 bytes spill "
            "loads; Used 128 registers, used 1 barriers, 8 bytes cumulative stack size") in out
    assert "other_kernel" not in out
    assert '"ctas_per_sm": 4' in out
