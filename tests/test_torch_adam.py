"""The fused Adam / AdamW update (``ops/adam_cuda.py``, ``csrc/adam.cu``) on
the CPU: buffers there take ``Optimizer.apply_plain``'s chain and launch
nothing; the kernel's walk of the buffers (``adam_cuda.plan``) covers each
element once with aligned vectors; and a float32 NumPy copy of the kernel's
arithmetic (``adam_element``'s order, the wrapper's fp32 constants) gives
the chain's bits, where two planted faults do not.  The card tests in
``tests/test_torch_cuda.py`` hold the kernel itself to the chain.
JAX-free, under a second."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu_torch.config import OptimConfig
from guitar_tablature_classification_tpu_torch.ops import adam_cuda
from guitar_tablature_classification_tpu_torch.train import engine
from guitar_tablature_classification_tpu_torch.utils import profiling

N = 1001  # ragged: not a multiple of 4
NAMES, SIZES = ["vit.w", "heads.b"], [600, 401]
LR = 1e-2


def _case(name: str, clip: bool, mask: bool, seed: int = 0):
    cfg = OptimConfig(name=name, weight_decay=1e-2, backbone_lr_scale=0.1 if mask else 1.0)
    g = torch.Generator().manual_seed(seed)
    scale = 5.0 if clip else 1e-4 / N**0.5  # global norm ~160 or ~1e-4 against the clip's 1
    grads, params = scale * torch.randn(N, generator=g), torch.randn(N, generator=g)
    return engine.make_optimizer(cfg, NAMES, SIZES), grads, params


VARIANTS = [(name, clip, mask) for name in ("adam", "adamw") for clip in (True, False)
            for mask in (True, False)]


@pytest.mark.parametrize("ok", [True, False])
@pytest.mark.parametrize("name,clip,mask", VARIANTS)
def test_cpu_buffers_take_the_plain_chain(name, clip, mask, ok):
    """``apply`` on CPU buffers is ``apply_plain`` bit for bit (params,
    moments, count), launches no kernel and counts no
    ``train.update_kernel``; ``ok`` False keeps every buffer."""
    tx, grads, params = _case(name, clip, mask)
    before = adam_cuda.launches["adam_update"]
    outs = []
    with profiling.recording() as rec:
        for apply in (tx.apply, tx.apply_plain):
            p = params.clone()
            state = tx.init(p)
            for _ in range(2):
                norm = apply(grads, state, p, LR)
            kept = [t.clone() for t in (p, state.mu, state.nu, state.count)]
            apply(grads, state, p, LR, ok=torch.tensor(ok))
            now = (p, state.mu, state.nu, state.count)
            if not ok:
                assert all(torch.equal(a, b) for a, b in zip(kept, now))
            outs.append(now)
    assert (float(norm) > tx.cfg.grad_clip_norm) == clip
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert adam_cuda.launches["adam_update"] == before
    assert rec.drain()[1] == {}


def _kernel_numpy(tx, grads, p, m, v, count: int, fault: str | None = None):
    """``csrc/adam.cu``'s ``adam_element`` in float32 NumPy (each operation
    rounded once, none fused), with the wrapper's constants and the device
    scalars as apply computes them."""
    cfg = tx.cfg
    consts = adam_cuda.scalars(lr=LR, betas=(engine.ADAM_B1, engine.ADAM_B2),
                               eps=engine.ADAM_EPS, weight_decay=cfg.weight_decay,
                               max_norm=cfg.grad_clip_norm, backbone_scale=cfg.backbone_lr_scale)
    max_norm, omb1, b1, omb2, b2, eps, wd, neg_lr, scale = (np.float32(c) for c in consts)
    t = torch.tensor(count, dtype=torch.int32).float()
    bias1 = np.float32((1 - engine.ADAM_B1**t).item())
    bias2 = np.float32((1 - engine.ADAM_B2**t).item())
    g_norm = np.float32(torch.linalg.vector_norm(grads).item())
    u = grads.numpy()
    if not g_norm < max_norm:
        u = (u / g_norm) * max_norm
    if cfg.name == "adam":
        u = u + p * wd
    if fault == "fused_moment":  # one rounding of the whole sum, as an FMA would give
        m = (u.astype(np.float64) * omb1 + m.astype(np.float64) * b1).astype(np.float32)
    else:
        m = u * omb1 + m * b1
    v = (u * u) * omb2 + v * b2
    m_hat = m * (np.float32(1) / bias1) if fault == "reciprocal" else m / bias1
    # the kernel's __fsqrt_rn is the card's torch.sqrt; on the CPU PyTorch's
    # float32 root is not always correctly rounded (AVX-512), so the copy
    # takes the chain's own root there
    u = m_hat / (torch.sqrt(torch.from_numpy(v / bias2)).numpy() + eps)
    if cfg.name == "adamw":
        u = u + p * wd
    u = u * neg_lr
    if tx.backbone is not None:
        u = np.where(tx.backbone.numpy(), u * scale, u)
    return p + u, m, v


@pytest.mark.parametrize("fault", [None, "fused_moment", "reciprocal"])
@pytest.mark.parametrize("name,clip,mask", VARIANTS)
def test_kernel_arithmetic_gives_the_chains_bits(name, clip, mask, fault):
    """Two steps of the kernel's arithmetic against two of the plain chain:
    the same bits; a moment rounded once (FMA contraction) or a division by
    a reciprocal's product changes some."""
    tx, grads, params = _case(name, clip, mask, seed=1)
    p = params.clone()
    state = tx.init(p)
    got = (params.numpy(), np.zeros(N, np.float32), np.zeros(N, np.float32))
    for count in (1, 2):
        tx.apply_plain(grads, state, p, LR)
        got = _kernel_numpy(tx, grads, *got, count, fault)
    same = all(np.array_equal(a, b.numpy()) for a, b in zip(got, (p, state.mu, state.nu)))
    assert same == (fault is None)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 17, 1001])
@pytest.mark.parametrize("phases", [(0, 0, 0, 0, 0), (4, 4, 4, 4, 1), (12, 12, 12, 12, 3),
                                    (0, 4, 0, 0, 0), (8, 8, 8, 8, 1), (0, 0, 0, 0, 2)])
def test_plan_covers_each_element_once(n, phases):
    """``adam_cuda.plan``'s head, vectors and tail cover 0..n-1 once each,
    every vector at a 16-byte boundary of every buffer (and at a 4-byte one
    of the mask); buffers whose alignments differ go singly."""
    base = 1 << 20
    addrs, mask = [base + ph for ph in phases[:4]], base + phases[4]
    walk = adam_cuda.plan(n, addrs, mask)
    tail = walk.head + walk.vec * walk.nvec
    covered = list(range(walk.head)) + list(range(walk.head, tail)) + list(range(tail, n))
    assert covered == list(range(n))
    assert walk.head < 4 and n - tail < walk.vec
    if walk.vec == 4 and walk.nvec:
        assert all((a + 4 * walk.head) % 16 == 0 for a in addrs)
        assert (mask + walk.head) % 4 == 0
    head = (16 - phases[0]) % 16 // 4
    aligned = len(set(phases[:4])) == 1 and (phases[4] + head) % 4 == 0
    assert walk == ((4, min(n, head), (n - min(n, head)) // 4) if aligned else (1, 0, n))


def test_grid_fills_the_card_and_no_more():
    """CTAS_PER_SM an SM at DeepSeek-V2-Lite's 2,422,007,154 parameters,
    one CTA for a few elements."""
    big = adam_cuda.plan(2_422_007_154, [0, 0, 0, 0])
    assert adam_cuda.grid(big, 2_422_007_154, 132) == 132 * adam_cuda.CTAS_PER_SM
    assert adam_cuda.grid(adam_cuda.plan(5, [4, 4, 4, 4]), 5, 132) == 1
    assert adam_cuda.grid(adam_cuda.plan(0, [0, 0, 0, 0]), 0, 132) == 1


def test_constants_round_as_pytorch_casts_python_scalars():
    """Each constant is its double expression rounded to fp32 once, the
    value a float32 tensor times that Python scalar is multiplied by."""
    cfg = dataclasses.replace(OptimConfig(), weight_decay=1e-5, backbone_lr_scale=0.1)
    consts = adam_cuda.scalars(lr=5e-4, betas=(engine.ADAM_B1, engine.ADAM_B2),
                               eps=engine.ADAM_EPS, weight_decay=cfg.weight_decay,
                               max_norm=cfg.grad_clip_norm, backbone_scale=cfg.backbone_lr_scale)
    exprs = [1.0, 1 - engine.ADAM_B1, engine.ADAM_B1, 1 - engine.ADAM_B2, engine.ADAM_B2,
             engine.ADAM_EPS, 1e-5, -1.0 * 5e-4, 0.1]
    one = torch.ones(1)
    assert consts == [float(x * one) for x in exprs]


def test_kernel_wrapper_refuses_cpu_tensors():
    tx, grads, params = _case("adamw", True, False)
    state = tx.init(params)
    one = torch.ones(())
    with pytest.raises(ValueError, match="CUDA"):
        adam_cuda.update(grads, params, state.mu, state.nu, lr=LR, betas=(0.9, 0.999),
                         eps=1e-8, bias1=one, bias2=one, decay="adamw", weight_decay=1e-2,
                         g_norm=None, max_norm=1.0, backbone=None, backbone_scale=1.0, ok=None)
