"""The ``deepseek_v2`` arch (``models/deepseek_v2.py``, ``ops/moe.py``, the
generalised plain attention) against the plain float32 reference of
``tests/reference_deepseek_v2.py`` on seeded weights, at a tiny shape:
hidden 64, 4 heads, latent rank 16, 8 experts top-2, one shared expert,
one dense and two expert layers, a 32^2 image in 8x8 patches (16 patches
and the readout token).  JAX-free, a few seconds."""

from __future__ import annotations

import dataclasses
import math

import pytest
import torch
import torch.nn.functional as F

from guitar_tablature_classification_tpu_torch.config import ModelConfig, OptimConfig
from guitar_tablature_classification_tpu_torch.models.deepseek_v2 import (
    DeepseekV2Tab,
    init_deepseek,
)
from guitar_tablature_classification_tpu_torch.models.tabnet import build_model
from guitar_tablature_classification_tpu_torch.ops import moe
from guitar_tablature_classification_tpu_torch.ops.attention import attention_reference
from guitar_tablature_classification_tpu_torch.train.checkpoint import (
    CheckpointMismatchError,
    Checkpointer,
)
from guitar_tablature_classification_tpu_torch.train.engine import create_train_state

from reference_deepseek_v2 import DeepseekV2TabReference, MoE

TINY = dict(
    hidden_size=64, num_hidden_layers=3, num_attention_heads=4, q_lora_rank=None,
    kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    intermediate_size=96, moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=1,
    num_experts_per_tok=2, first_k_dense_replace=1, moe_layer_freq=1, norm_topk_prob=False,
    routed_scaling_factor=1.0, scoring_func="softmax", topk_method="greedy", seq_aux=True,
    aux_loss_alpha=0.001, rms_norm_eps=1e-6, rope_theta=10000, hidden_act="silu",
    attention_bias=False,
    rope_scaling=dict(beta_fast=32, beta_slow=1, factor=40, mscale=0.707, mscale_all_dim=0.707,
                      original_max_position_embeddings=4096, type="yarn"))
SIZE = 32


def _models(dtype=torch.float32, seed=0, **changes):
    cfg = {**TINY, **changes}
    port = init_deepseek(DeepseekV2Tab(cfg, input_hw=(SIZE, SIZE), dtype=dtype),
                         torch.Generator().manual_seed(seed))
    with torch.no_grad():  # random norms and BatchNorm statistics, so none is the identity
        for name, t in port.state_dict().items():
            if t.is_floating_point() and t.ndim == 1:
                t.add_(0.1 * torch.randn(t.shape, generator=torch.Generator().manual_seed(len(name))))
                t.abs_() if "running_var" in name else None
    ref = DeepseekV2TabReference(cfg, patch=8, size=SIZE)
    ref.load_state_dict(port.state_dict(), strict=True)
    return port, ref


def _image(b=3, seed=1):
    return torch.rand(b, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(seed))


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


# a float32 port differs from the reference by the order of its sums
# (fused gate|up products, grouped GEMMs, the expand-summed dispatch):
# ~1e-6 relative.  The mask dropped, the top-2 cut to one expert or bf16
# products all move the logits by 1e-2 or more (test_the_limits_catch_faults)
FP32_LOGITS = 1e-4
# train mode adds the head's batch statistics, which the port takes with
# Flax's fast variance E[x^2] - E[x]^2 and the reference with torch's
# two-pass one: ~1.5e-4 relative at a batch of 3
FP32_TRAIN_LOGITS = 1e-3
# bf16 operands (8 bits of mantissa) through three layers and the head:
# ~4e-3 relative RMS of the logits here; twice that is the limit
BF16_LOGITS = 1e-2


@pytest.mark.parametrize("train", [False, True])
def test_logits_match_the_reference_at_fp32(train):
    port, ref = _models()
    x = _image()
    port.train(train)
    ref.train(train)
    with torch.no_grad():
        got = port(x, torch.Generator().manual_seed(5))
        want = ref(x, torch.Generator().manual_seed(5))
    assert got.shape == (3, 6, 19)
    assert _rel(got, want) < (FP32_TRAIN_LOGITS if train else FP32_LOGITS)


def test_logits_at_bf16_within_rounding():
    port, ref = _models(dtype=torch.bfloat16)
    port.eval()
    ref.eval()
    with torch.no_grad():
        assert _rel(port(_image()), ref(_image())) < BF16_LOGITS


def test_the_limits_catch_faults():
    """The mask dropped, the router's last expert dropped, and bf16
    products each read over FP32_LOGITS (the first two over BF16_LOGITS)."""
    port, ref = _models()
    port.eval()
    ref.eval()
    x = _image()
    with torch.no_grad():
        want = ref(x)
        assert _rel(ref(x, causal=False), want) > BF16_LOGITS
        assert _rel(ref(x, top_k=1), want) > BF16_LOGITS
        low, _ = _models(dtype=torch.bfloat16)
        assert _rel(low.eval()(x), want) > FP32_LOGITS


def _smoothed(logits, labels):
    return F.cross_entropy(logits.reshape(-1, 19), labels.reshape(-1), label_smoothing=0.1)


def test_gradients_match_the_reference():
    """Every parameter's gradient of a train-mode loss, the router's (which
    takes the balance loss's gradient through AddAuxiliaryLoss) among
    them; the loss itself is the tab loss alone."""
    port, ref = _models()
    port.train()
    ref.train()
    x, labels = _image(4), torch.randint(0, 19, (4, 6), generator=torch.Generator().manual_seed(2))
    lp = _smoothed(port(x, torch.Generator().manual_seed(3)), labels)
    lr = _smoothed(ref(x, torch.Generator().manual_seed(3)), labels)
    assert abs(float(lp.detach() - lr.detach())) < 1e-5
    names = [n for n, _ in port.named_parameters()]
    gp = dict(zip(names, torch.autograd.grad(lp, list(port.parameters()))))
    # an expert no row chose takes no part in the reference's loop
    gr = torch.autograd.grad(lr, list(ref.parameters()), allow_unused=True)
    gr = {n: torch.zeros_like(gp[n]) if g is None else g for n, g in zip(names, gr)}
    scale = max(float(g.norm()) for g in gr.values())
    for n in names:  # pre-BatchNorm biases have a gradient of rounding only
        if float(gr[n].norm()) > 1e-4 * scale:
            assert _rel(gp[n], gr[n]) < 2e-3, n
        elif float(gr[n].norm()) == 0:
            assert float(gp[n].norm()) == 0, n
    gate = "model.layers.1.mlp.gate.weight"
    without, _ = _models(aux_loss_alpha=0.0)
    without.train()
    g0 = torch.autograd.grad(_smoothed(without(x, torch.Generator().manual_seed(3)), labels),
                             without.get_parameter(gate))[0]
    assert _rel(g0, gp[gate]) > 1e-3  # the balance loss moves the router


def test_balance_loss_is_the_published_formula():
    scores = torch.softmax(torch.randn(2 * 5, 8, generator=torch.Generator().manual_seed(0)), -1)
    _, ids = torch.topk(scores, 2, dim=-1)
    got = moe.balance_loss(scores, ids, 2, 0.001)
    want = 0.0
    for b in range(2):
        counts = torch.bincount(ids[5 * b:5 * b + 5].reshape(-1), minlength=8).float()
        want += float((counts / (5 * 2 / 8) * scores[5 * b:5 * b + 5].mean(0)).sum())
    assert math.isclose(float(got), 0.001 * want / 2, rel_tol=1e-6)


def test_attention_reference_generalised():
    """Query/key width 12 against value width 8, an explicit scale and the
    causal mask, against the masked softmax written out row by row."""
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(2, 7, 3, 12, generator=g), torch.randn(2, 7, 3, 12, generator=g)
    v = torch.randn(2, 7, 3, 8, generator=g)
    got = attention_reference(q, k, v, scale=0.3, causal=True)
    want = torch.empty(2, 7, 3, 8)
    for t in range(7):
        s = torch.einsum("bhd,bshd->bhs", q[:, t], k[:, :t + 1]) * 0.3
        want[:, t] = torch.einsum("bhs,bshd->bhd", torch.softmax(s, -1), v[:, :t + 1])
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    assert not torch.allclose(attention_reference(q, k, v, scale=0.3), got, atol=1e-2)


def test_routed_combine_matches_the_expert_loop():
    """One expert layer: the sorted rows, grouped GEMMs and combine against
    the per-expert loop, every (token, choice) row routed; the counter
    holds each expert's rows."""
    port, ref = _models()
    layer, ref_layer = port.model.layers[1].mlp, ref.model.layers[1].mlp
    assert isinstance(ref_layer, MoE)
    layer.eval()
    ref_layer.eval()
    x = torch.randn(3, 11, 64, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        torch.testing.assert_close(layer(x), ref_layer(x), atol=1e-5, rtol=1e-5)
    ids = torch.topk(F.linear(x.reshape(-1, 64), layer.gate.weight).softmax(-1), 2, -1)[1]
    assert layer.rows.tolist() == torch.bincount(ids.reshape(-1), minlength=8).tolist()
    assert int(layer.rows.sum()) == 3 * 11 * 2
    order, ends, inverse = moe.dispatch(ids, 8)
    assert torch.equal(ids.reshape(-1)[order].sort().values, ids.reshape(-1)[order])
    assert torch.equal(order[inverse], torch.arange(order.numel()))
    assert ends.tolist() == torch.bincount(ids.reshape(-1), minlength=8).cumsum(0).tolist()


def test_checkpoint_round_trip_refuses_another_shape(tmp_path):
    cfg = ModelConfig(arch="deepseek_v2", dtype="float32", deepseek=TINY)
    state = create_train_state(build_model(cfg), OptimConfig(), device="cpu")
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(state, epoch=0, metrics={"loss": 1.0}, model_meta=dataclasses.asdict(cfg))
    fresh = create_train_state(build_model(cfg, generator=torch.Generator().manual_seed(9)),
                               OptimConfig(), device="cpu")
    ckpt.restore(fresh, expect_model=dataclasses.asdict(cfg))
    assert torch.equal(fresh.params, state.params)
    other = dataclasses.replace(cfg, deepseek={**TINY, "n_routed_experts": 4})
    with pytest.raises(CheckpointMismatchError, match="deepseek"):
        ckpt.restore(fresh, expect_model=dataclasses.asdict(other))


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_optimizer_chunks_change_no_bit(monkeypatch, name):
    """``Optimizer.apply`` over chunks of 7 elements (a ragged last one)
    against one chunk: the same bits, the clip engaged; a step whose loss
    is not finite leaves params and moments as they were."""
    from guitar_tablature_classification_tpu_torch.train import engine

    g = torch.Generator().manual_seed(0)
    grads, params = 5 * torch.randn(30, generator=g), torch.randn(30, generator=g)
    cfg = OptimConfig(name=name, weight_decay=1e-2, backbone_lr_scale=0.1)
    outs = []
    for chunk in (1 << 26, 7):
        monkeypatch.setattr(engine, "UPDATE_CHUNK", chunk)
        tx = engine.make_optimizer(cfg, ["vit.w", "heads.b"], [20, 10])
        p = params.clone()
        state = tx.init(p)
        for _ in range(2):
            norm = tx.apply(grads, state, p, 1e-2)
        assert float(norm) > cfg.grad_clip_norm
        outs.append((p, state.mu, state.nu, state.count))
        kept = [t.clone() for t in (p, state.mu, state.nu, state.count)]
        tx.apply(grads, state, p, 1e-2, ok=torch.tensor(False))
        assert all(torch.equal(a, b) for a, b in zip(kept, (p, state.mu, state.nu, state.count)))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
