"""The rounding plan of ``csrc/attention.cu``'s bf16 tensor-core kernels,
emulated in plain PyTorch and held to the JAX package's ``fused_attention``
(Pallas, interpret mode) and to the port's plain version, under
``chip_smoke.py``'s limits.

The kernels do not follow the plain version's order of operations.  The
forward walks 64-key tiles with an online softmax and rounds the weights P
to bf16 at the running max before P V (FlashAttention-2's scheme), then
divides by the running sum.  The backward recomputes P = exp(S scale -
lse) per tile, rounds dS = P (dP - D) to bf16 before dS K and dS^T Q, and
scales dq and dk after those products.  ``_emulate`` does the same on the
CPU in fp32 (the products of bf16 values are exact in fp32; only the order
of the sums differs from the tensor cores'), so this test shows without a
card that the rounding the kernels do fits the limits the smoke holds them
to: ``ATTN_TOL["bfloat16"]`` and ``ATTN_REL_TOL``.  The emulation lives
here only; no path of the port runs it.
"""

import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu.ops.attention_pallas import (
    fused_attention as jax_fused_attention,
)
from guitar_tablature_classification_tpu_torch.ops.attention import attention_reference

TILE = 64  # csrc/attention.cu kTile: keys per streamed tile
LOG2E = 1.4426950408889634


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _emulate(q, k, v, g):
    """q, k, v, g: [B, N, H, 64] bf16 -> (out, dq, dk, dv), bf16, in the
    kernels' order: exp2 with the scale folded into log2 e (fp32, as the
    kernel receives it), P rounded at the running max, lse in natural log,
    D = rowsum(dO * O) of the rounded output, dS rounded, scale after."""
    scale = q.shape[-1] ** -0.5
    scale_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    qf, kf, vf, gf = (t.float().transpose(1, 2) for t in (q, k, v, g))  # [B, H, N, Dh]
    b, h, n, dh = qf.shape
    m = torch.full((b, h, n), -math.inf)
    l = torch.zeros((b, h, n))
    acc = torch.zeros((b, h, n, dh))
    for k0 in range(0, n, TILE):
        kt, vt = kf[:, :, k0:k0 + TILE], vf[:, :, k0:k0 + TILE]
        s = (qf @ kt.transpose(-1, -2)) * scale_log2
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)  # 0 on the first tile
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.bfloat16().float() @ vt
        m = m_new
    out = (acc / l[..., None]).bfloat16()
    lse = (m + torch.log2(l)) * math.log(2.0)

    d = (gf * out.float()).sum(-1)
    dq = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for k0 in range(0, n, TILE):
        kt, vt = kf[:, :, k0:k0 + TILE], vf[:, :, k0:k0 + TILE]
        p = torch.exp2((qf @ kt.transpose(-1, -2)) * scale_log2 - (lse * LOG2E)[..., None])
        ds = (p * (gf @ vt.transpose(-1, -2) - d[..., None])).bfloat16().float()
        dq += ds @ kt
        dk[:, :, k0:k0 + TILE] = ds.transpose(-1, -2) @ qf
        dv[:, :, k0:k0 + TILE] = p.bfloat16().float().transpose(-1, -2) @ gf
    grads = [(scale * dq), (scale * dk), dv]
    return (out.transpose(1, 2), *[t.bfloat16().transpose(1, 2) for t in grads])


def _inputs(b, n, h, seed):
    """q, k, v as [B, N, H, 64] views of one bf16 [B, N, 3*H*64] projection
    and an output gradient, from NumPy."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * 64), np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((b, n, h, 64), np.float32)).bfloat16()
    return [t.view(b, n, h, 64) for t in qkv.split(h * 64, dim=-1)], g


def _pallas(q, k, v, g):
    js = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v, g)]
    fn = jax.jit(lambda a, b, c: jax_fused_attention(a, b, c, q_tile=128, interpret=True))
    out, vjp = jax.vjp(fn, *js[:3])
    grads = vjp(js[3])
    return [torch.from_numpy(np.asarray(t, np.float32)) for t in (out, *grads)]


def _plain(q, k, v, g):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attention_reference(*leaves)
    grads = torch.autograd.grad(out, leaves, g)
    return [t.detach().float() for t in (out, *grads)]


@pytest.mark.parametrize("reference", ["pallas_interpret", "plain"])
@pytest.mark.parametrize("shape, seed", [((2, 50, 4), 11), ((1, 300, 2), 12)])
def test_tensor_core_rounding_plan_fits_the_smoke_limits(shape, seed, reference):
    """The kernels' bf16 schedule against the Pallas kernels in interpret
    mode and the plain version: the JAX package's bf16 tolerances and the
    smoke's relative limits on the output and on dq, dk and dv."""
    smoke = _chip_smoke()
    (q, k, v), g = _inputs(*shape, seed)
    got = [t.float() for t in _emulate(q, k, v, g)]
    want = (_pallas if reference == "pallas_interpret" else _plain)(q, k, v, g)
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == w.shape == q.shape
        atol, rtol = smoke.ATTN_TOL["bfloat16"]["out" if name == "out" else "grad"]
        torch.testing.assert_close(a, w, atol=atol, rtol=rtol, msg=name)
        err = smoke._rel_err(a, w)
        assert err["max"] <= smoke.ATTN_REL_TOL["max"], (name, err)
        assert err["l2"] <= smoke.ATTN_REL_TOL["l2"], (name, err)
