"""Card-only tests of the port's CUDA kernel and its wrapper.

They skip where there is no CUDA card (the kernel has no CPU mode).  This
file imports neither JAX nor the JAX package, so it also runs on a machine
without them; there ``tests/conftest.py`` (which sets JAX up) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu_torch.config import RECIPES, CQTConfig
from guitar_tablature_classification_tpu_torch.infer import Transcriber
from guitar_tablature_classification_tpu_torch.ops import cqt_cuda, stem_cuda, stem_tail
from guitar_tablature_classification_tpu_torch.ops.cqt import CQTFrontend

RECIPE_CFGS = {
    "train": CQTConfig(),
    "reflect": dataclasses.replace(CQTConfig(), pad_mode="reflect"),
    "hop1000": dataclasses.replace(
        CQTConfig(), hop_length=1000, window_seconds=0.25, hop_seconds=0.125
    ),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _windows(cfg, batch, seed, device):
    rng = np.random.default_rng(seed)
    t = np.arange(cfg.window_samples) / cfg.sample_rate
    f = 60.0 * (2000.0 / 60.0) ** rng.random((batch, 1))
    x = np.sin(2 * np.pi * f * t) + 0.01 * rng.standard_normal((batch, t.size))
    return torch.from_numpy(x.astype(np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("name", list(RECIPE_CFGS))
def test_kernel_matches_plain(card, name, precision):
    """Same precision, fp32 summation order only: no gate flips, 2e-3 dB
    where neither side is gated (tests/test_cqt.py:317-319)."""
    cfg = dataclasses.replace(RECIPE_CFGS[name], precision=precision)
    fe = CQTFrontend(cfg)
    x = _windows(cfg, 32, seed=0, device=card)
    before = cqt_cuda.launches
    got = fe(x)
    assert cqt_cuda.launches == before + 1
    want = fe.plain(x)
    gate = cfg.gate_floor_db
    assert int(((got == gate) != (want == gate)).sum()) == 0
    both = (got != gate) & (want != gate)
    assert float((got - want).abs()[both].max()) <= 2e-3


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    fe = CQTFrontend(CQTConfig())
    x = _windows(fe.cfg, 4, seed=1, device=card)
    with pytest.raises(ValueError, match="float32"):
        cqt_cuda.cqt_fused(x.double(), fe)
    with pytest.raises(ValueError, match="contiguous"):
        cqt_cuda.cqt_fused(x.t().contiguous().t(), fe)
    assert cqt_cuda.cqt_fused(x[:0], fe).shape == (0, 96, 9)


def _stem_case(dtype, device, batch=4, seed=0):
    """Quadrant-layout conv1 output at the flagship's widths (H2=56, C=64)
    on a quarter grid, so bf16 and fp32 pooling windows hold many ties,
    plus per-channel BN affine terms."""
    rng = np.random.default_rng(seed)
    y = np.round(rng.standard_normal((batch, 2, 56, 2 * 56 * 64)) * 4) / 4
    se = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    oe = (rng.standard_normal(64) * 0.1).astype(np.float32)
    g = rng.standard_normal((batch, 56, 56 * 64))
    to = lambda a, dt: torch.from_numpy(np.asarray(a)).to(device, dt)  # noqa: E731
    return (to(y, dtype), to(se, torch.float32), to(oe, torch.float32),
            to(g, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stem_kernels_match_plain(card, dtype):
    """The three stem-tail kernels against their plain versions on the same
    card tensors: the pooled output and dy bit for bit (same fp32 rounding
    and tie-break, no FMA contraction), the channel sums to fp32 summation
    order (rtol 1e-5), and every launch counted."""
    yq, se, oe, g = _stem_case(dtype, card)
    before = dict(stem_cuda.launches)
    sums = stem_tail.stats(yq)
    pooled = stem_tail.fwd(yq, se, oe)
    dy, sdz, sdzy = stem_tail.bwd(yq, g, se, oe)
    torch.cuda.synchronize()
    assert {k: stem_cuda.launches[k] - before[k] for k in before} == {
        "stem_stats": 1, "stem_fwd": 1, "stem_bwd": 1}
    torch.testing.assert_close(sums, stem_tail.stats_plain(yq), rtol=1e-5, atol=1e-2)
    assert torch.equal(pooled, stem_tail.fwd_plain(yq, se, oe))
    want_dy, want_sdz, want_sdzy = stem_tail.bwd_plain(yq, g, se, oe)
    assert torch.equal(dy, want_dy)
    torch.testing.assert_close(sdz, want_sdz, rtol=1e-5, atol=1e-2)
    torch.testing.assert_close(sdzy, want_sdzy, rtol=1e-5, atol=1e-2)
    # the fixed-order cross-CTA reduction is deterministic
    again = stem_tail.bwd(yq, g, se, oe)
    assert torch.equal(again[1], sdz) and torch.equal(again[2], sdzy)


@pytest.mark.cuda
def test_stem_train_op_on_card_matches_cpu(card):
    """bn_relu_pool_train through its autograd.Function: card (kernels)
    against CPU (plain versions) on the same bf16 input; outputs to one bf16
    ulp where the statistics' summation order moves a rounding, gradients
    to bf16 resolution."""
    yq, _, _, g = _stem_case(torch.bfloat16, "cpu", batch=2, seed=1)
    scale = torch.linspace(0.5, 1.5, 64)
    bias = torch.linspace(-0.1, 0.1, 64)
    outs = {}
    for dev in ("cpu", card):
        y, s, b = (t.to(dev).clone().requires_grad_(True) for t in (yq, scale, bias))
        pooled, mean, var = stem_tail.bn_relu_pool_train(y, s, b)
        pooled.backward(g.to(dev).reshape(pooled.shape))
        outs[str(dev)] = [t.detach().float().cpu() for t in (pooled, mean, var, y.grad, s.grad, b.grad)]
    cpu, gpu = outs["cpu"], outs[str(card)]
    for name, a, b, tol in zip(("pooled", "mean", "var", "dy", "dscale", "dbias"),
                               gpu, cpu, (1e-2, 1e-5, 1e-5, 1e-2, 1e-3, 1e-3)):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol * max(1.0, float(b.abs().max())),
                                   msg=name)


@pytest.mark.cuda
def test_stem_wrappers_reject_what_the_kernels_do_not_take(card):
    yq, se, oe, g = _stem_case(torch.bfloat16, card, batch=1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        stem_cuda.stats(yq.half())
    with pytest.raises(ValueError, match="contiguous"):
        stem_cuda.fwd(yq.transpose(2, 3).contiguous().transpose(2, 3), se, oe)
    with pytest.raises(ValueError, match="se must be"):
        stem_cuda.fwd(yq, se.double(), oe)
    with pytest.raises(ValueError, match="g must be"):
        stem_cuda.bwd(yq, g[:, :1], se, oe)


@pytest.mark.cuda
def test_fused_flagship_serving_launches_the_stem_kernel(card):
    """entry()'s configuration through Transcriber on the card: the eval
    forward runs the stem-tail forward kernel, never the train kernels."""
    from guitar_tablature_classification_tpu_torch.config import ModelConfig

    t = Transcriber(None, model_cfg=ModelConfig(arch="resnet18", stem_fusion="fused"),
                    batch_size=8)
    audio = _windows(t.cqt_cfg, 1, seed=3, device="cpu").numpy().repeat(3)
    before = dict(stem_cuda.launches)
    out = t.transcribe(audio, keep_logits=True)
    assert stem_cuda.launches["stem_fwd"] > before["stem_fwd"]
    assert stem_cuda.launches["stem_stats"] == before["stem_stats"]
    assert stem_cuda.launches["stem_bwd"] == before["stem_bwd"]
    assert np.isfinite(out.logits).all()


@pytest.mark.cuda
def test_serving_path_launches_the_kernel(card):
    cfg = RECIPES["native-best"]()
    t = Transcriber(None, model_cfg=cfg.model, cqt_cfg=cfg.cqt, batch_size=64)
    assert t.device.type == "cuda"
    audio = _windows(cfg.cqt, 1, seed=2, device="cpu").numpy().repeat(3)
    before = cqt_cuda.launches
    out = t.transcribe(audio, keep_logits=True)
    assert cqt_cuda.launches > before
    assert np.isfinite(out.logits).all()
