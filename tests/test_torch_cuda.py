"""Card-only tests of the port's CUDA kernels and their wrappers.

They skip where there is no CUDA card (the kernel has no CPU mode).  This
file imports neither JAX nor the JAX package, so it also runs on a machine
without them; there ``tests/conftest.py`` (which sets JAX up) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import ctypes
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu_torch.config import (
    RECIPES,
    CQTConfig,
    ModelConfig,
    OptimConfig,
)
from guitar_tablature_classification_tpu_torch.infer import Transcriber
from guitar_tablature_classification_tpu_torch.ops import (
    adam_cuda,
    attention,
    attention_cuda,
    bn_cuda,
    bn_fused,
    conv3x3,
    conv3x3_cuda,
    cqt_cuda,
    stem_cuda,
    stem_native,
    stem_native_cuda,
    stem_tail,
)
from guitar_tablature_classification_tpu_torch.ops.cqt import CQTFrontend, frame_gemm_plain
from guitar_tablature_classification_tpu_torch.train import engine
from guitar_tablature_classification_tpu_torch.utils import profiling

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


MMA_CFGS = {
    **RECIPE_CFGS,
    "serving_cnn": CQTConfig.serving_cnn(),  # T = 130 frames a window
    "hop333": dataclasses.replace(CQTConfig(), hop_length=333),  # the 16-bit load path
}


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 37])
@pytest.mark.parametrize("name", list(MMA_CFGS))
def test_default_tier_runs_on_tensor_cores(card, name, batch):
    """The default tier's tensor-core kernel against the plain version:
    no gate flip, 2e-3 dB where neither side is gated, two runs identical,
    one tensor-core launch a call.  37 windows: a multiple of no band's
    windows per CTA."""
    cfg = dataclasses.replace(MMA_CFGS[name], precision="default")
    fe = CQTFrontend(cfg)
    x = _windows(cfg, batch, seed=11, device=card)
    before = (cqt_cuda.launches, cqt_cuda.mma_launches)
    got = fe(x)
    assert (cqt_cuda.launches, cqt_cuda.mma_launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(fe(x), got)
    want = fe.plain(x)
    gate = cfg.gate_floor_db
    assert got.shape == (batch, cfg.n_bins, cfg.n_frames)
    assert int(((got == gate) != (want == gate)).sum()) == 0
    both = (got != gate) & (want != gate)
    assert float((got - want).abs()[both].max()) <= 2e-3
    assert fe(x[:0]).shape == (0, cfg.n_bins, cfg.n_frames)


@pytest.mark.cuda
def test_default_tier_kernel_occupancy(card):
    plan = CQTFrontend(CQTConfig(precision="default")).kernel_plan(8820, card)
    info = cqt_cuda.mma_kernel_info(plan)
    assert info["threads"] == 512 and info["ctas_per_sm"] >= 1
    assert info["shared_bytes"] >= plan.shape.smem_bytes
    for info in cqt_cuda.frame_gemm_mma_kernel_info().values():
        assert info["ctas_per_sm"] >= 1


SPLIT_CQT_CFGS = {
    "train": CQTConfig(),  # hop 1024
    "serving_cnn_0.5s": dataclasses.replace(
        CQTConfig(), sample_rate=22050, hop_length=512, n_bins=84,
        fmin=65.40639132514966, window_seconds=0.5, hop_seconds=0.25),
    "reflect": RECIPE_CFGS["reflect"],
    "hop1000": RECIPE_CFGS["hop1000"],
    "serving_cnn": CQTConfig.serving_cnn(),  # hop 512, T = 130 frames a window
}


def _launch_counts():
    return cqt_cuda.launches, cqt_cuda.mma_launches, dict(cqt_cuda.mma_launches_by_tier)


def _launches_since(before):
    now = _launch_counts()
    return now[0] - before[0], now[1] - before[1], {
        k: v - before[2][k] for k, v in now[2].items() if v != before[2][k]}


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 37])
@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
@pytest.mark.parametrize("name", list(SPLIT_CQT_CFGS))
def test_split_tiers_run_on_tensor_cores(card, name, precision, batch):
    """highest and bf16x3 at a hop that is a multiple of 8 on the
    tensor-core kernel (three and two bf16 pieces; named to the wrapper,
    since at these batches the route sends highest to the SIMT kernel)
    against the plain version: no gate flip, 2e-3 dB where neither side is
    gated, two runs identical, one tensor-core launch of the tier a call;
    a call left to the route launches the kernel the route names; B=0
    launches nothing."""
    cfg = dataclasses.replace(SPLIT_CQT_CFGS[name], precision=precision)
    fe = CQTFrontend(cfg)
    x = _windows(cfg, batch, seed=12, device=card)
    before = _launch_counts()
    got = cqt_cuda.cqt_fused(x, fe, route="mma")
    assert _launches_since(before) == (1, 1, {precision: 1})
    assert torch.equal(cqt_cuda.cqt_fused(x, fe, route="mma"), got)
    before = _launch_counts()
    routed = fe(x)
    if fe.route(batch, cfg.window_samples, card) == "mma":
        assert _launches_since(before) == (1, 1, {precision: 1})
        assert torch.equal(routed, got)
    else:
        assert _launches_since(before) == (1, 0, {})
    want = fe.plain(x)
    gate = cfg.gate_floor_db
    assert got.shape == (batch, cfg.n_bins, cfg.n_frames)
    assert int(((got == gate) != (want == gate)).sum()) == 0
    both = (got != gate) & (want != gate)
    assert float((got - want).abs()[both].max()) <= 2e-3
    before = _launch_counts()
    assert fe(x[:0]).shape == (0, cfg.n_bins, cfg.n_frames)
    assert _launches_since(before) == (0, 0, {})


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
def test_split_tiers_off_the_hop_grid_run_simt(card, precision):
    """At hop 333 highest and bf16x3 run the SIMT kernel (cqt_route): one
    launch, none on the tensor cores, within the CQT limits."""
    cfg = dataclasses.replace(CQTConfig(), hop_length=333, precision=precision)
    assert cqt_cuda.cqt_route(precision, 333, 5) == "simt"
    fe = CQTFrontend(cfg)
    x = _windows(cfg, 5, seed=13, device=card)
    before = _launch_counts()
    got = fe(x)
    assert _launches_since(before) == (1, 0, {})
    want = fe.plain(x)
    gate = cfg.gate_floor_db
    assert int(((got == gate) != (want == gate)).sum()) == 0
    both = (got != gate) & (want != gate)
    assert float((got - want).abs()[both].max()) <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
def test_split_tier_kernels_hold_without_spills(card, precision):
    """The split tiers' kernels (highest: 8 warps at up to 255 registers;
    bf16x3: 12 at up to 168) at the training recipe's plan: no local
    memory, one CTA an SM."""
    plan = CQTFrontend(CQTConfig(precision=precision)).kernel_plan(8820, card)
    info = cqt_cuda.mma_kernel_info(plan)
    assert info["threads"] == 32 * plan.shape.warps and info["ctas_per_sm"] == 1, info
    assert info["local_bytes"] == 0 and info["registers"] <= 255, info
    assert info["shared_bytes"] >= plan.shape.smem_bytes


def _tone_windows(batch, cfg, seed):
    """Three tones a window plus noise, made with NumPy from ``seed``."""
    rng = np.random.default_rng(seed)
    t = np.arange(cfg.window_samples) / cfg.sample_rate
    f = 60.0 * (2000.0 / 60.0) ** rng.random((batch, 3, 1))
    amp = rng.random((batch, 3, 1))
    x = (amp * np.sin(2 * np.pi * f * t)).sum(axis=1)
    return (x + 0.01 * rng.standard_normal((batch, cfg.window_samples))).astype(np.float32)


DIGEST_CFGS = {  # recipe: (configuration, batch)
    "train": (CQTConfig(), 256),
    "serving_cnn": (CQTConfig.serving_cnn(), 64),
    "reflect": (RECIPE_CFGS["reflect"], 64),
    "hop1000": (RECIPE_CFGS["hop1000"], 64),
    "hop333": (dataclasses.replace(CQTConfig(), hop_length=333), 64),
}
# sha256 of the output bytes of the kernels as they stood before highest
# and bf16x3 came to the tensor cores, on an H100 (sm_90a build): the
# default tier's tensor-core kernel, and the SIMT kernel where the route
# keeps highest (and bf16x3 off the hop grid) on it
CQT_DIGESTS = {
    "train/default": "723ba26ff3fcc06ca60a1df25dc0205f6d0708e900c9c4e19b5a26597adfce4f",
    "serving_cnn/default": "ac5ed2e558fcbc3cbd93f3fea8e97619e06fab2941dd1ab3b38024d6a07c7a42",
    "reflect/default": "2dba5d36b65206d49e0fbd607456079a031de6a3b5de342bdfe62216451bc4e4",
    "hop1000/default": "fbbcbfb21d480eee9aec7f8c45fb700f85d2a469fd0dfb9b0ab23c24a9700ff7",
    "hop333/default": "ba30963f36227f6f87e71356d7d6f7eca2cbe3c5b2ee5b66f432af3ed080e3c2",
    "train/highest": "35f8341c3bae8b729000845f9d666dd179bfc3d3f29adfe027889148e627fe7c",
    "reflect/highest": "7e6ad8d55fbd90d9cb7ff88b9eb706326bb088b4506cf83e49c15d26eff0248d",
    "hop1000/highest": "b368cbbe3067598ee3f804739525f8f06ad8d4436101be37d2c6d2dba4be6f19",
    "hop333/highest": "d23cbe442afef68ab5750c59e6d62b2d3d8122fd5df6eea73334e350d297028e",
    "hop333/bf16x3": "7b5e6d504dd4d0c37bbe1ff96b3952d9a9849d6bc810efb18b013ae319ad3d81",
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CQT_DIGESTS))
def test_cqt_bits_unchanged(card, case):
    """The default tier's bits, and the SIMT kernel's at the shapes the
    route keeps it, are those recorded before the split tiers' tensor-core
    kernels came: seeded tones (NumPy), the output's sha256."""
    if "H100" not in torch.cuda.get_device_name(card):
        pytest.skip("the digests were recorded on an H100")
    name, precision = case.split("/")
    base, batch = DIGEST_CFGS[name]
    fe = CQTFrontend(dataclasses.replace(base, precision=precision))
    want_route = "mma" if precision == "default" else "simt"
    assert fe.route(batch, base.window_samples, card) == want_route
    x = torch.from_numpy(_tone_windows(batch, base, seed=3)).to(card)
    digest = hashlib.sha256(fe(x).cpu().numpy().tobytes()).hexdigest()
    assert digest == CQT_DIGESTS[case]


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
        "stem_stats": 1, "stem_fwd": 1, "stem_bwd": 1, "gemm_stats": 0}
    torch.testing.assert_close(sums, stem_tail.stats_plain(yq), rtol=1e-5, atol=1e-2)
    assert torch.equal(pooled, stem_tail.fwd_plain(yq, se, oe))
    want_dy, want_sdz, want_sdzy = stem_tail.bwd_plain(yq, g, se, oe)
    assert torch.equal(dy, want_dy)
    torch.testing.assert_close(sdz, want_sdz, rtol=1e-5, atol=1e-2)
    torch.testing.assert_close(sdzy, want_sdzy, rtol=1e-5, atol=1e-2)
    # the fixed-order cross-CTA reduction is deterministic
    again = stem_tail.bwd(yq, g, se, oe)
    assert torch.equal(again[1], sdz) and torch.equal(again[2], sdzy)


STEM_BWD_EDGES = {  # name: (B, H2, C): the cuts of the backward kernel's tiling
    "b1_flagship": (1, 56, 64),  # one image: 7 bands x 4 slices
    "h2_1": (2, 1, 16),  # one quad row: no window below, no halo above
    "h2_off_band": (2, 9, 64),  # a full band and a band of one row
    "c8": (2, 3, 8),  # one vector a pixel in bf16
    "c128": (1, 12, 128),  # eight bf16 slices
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(STEM_BWD_EDGES))
def test_stem_bwd_edge_shapes_match_plain(card, name, dtype):
    """stem_bwd at the shapes that cut its bands and channel slices, on
    tie-rich quarter-grid input: dy equal to the plain version, the channel
    sums to rtol 1e-5, and two runs identical."""
    b, h2, c = STEM_BWD_EDGES[name]
    rng = np.random.default_rng(h2 + c)
    y = np.round(rng.standard_normal((b, 2, h2, 2 * h2 * c)) * 4) / 4
    g = rng.standard_normal((b, h2, h2 * c))
    se = rng.uniform(-1.5, 1.5, c)
    oe = rng.standard_normal(c) * 0.1
    to = lambda a, dt: torch.from_numpy(np.asarray(a)).to(card, dt)  # noqa: E731
    yq, gq, se, oe = to(y, dtype), to(g, dtype), to(se, torch.float32), to(oe, torch.float32)
    before = stem_cuda.launches["stem_bwd"]
    dy, sdz, sdzy = stem_cuda.bwd(yq, gq, se, oe)
    again = stem_cuda.bwd(yq, gq, se, oe)
    want_dy, want_sdz, want_sdzy = stem_tail.bwd_plain(yq, gq, se, oe)
    torch.cuda.synchronize()
    assert stem_cuda.launches["stem_bwd"] - before == 2
    assert torch.equal(dy, want_dy)
    torch.testing.assert_close(sdz, want_sdz, rtol=1e-5, atol=1e-2)
    torch.testing.assert_close(sdzy, want_sdzy, rtol=1e-5, atol=1e-2)
    assert all(torch.equal(a, w) for a, w in zip(again, (dy, sdz, sdzy)))


@pytest.mark.cuda
def test_stem_bwd_holds_two_ctas_an_sm_without_spills(card):
    """The backward kernel at the flagship shape: at most 128 registers, no
    local memory, two 93 KB CTAs an SM."""
    yq = torch.empty((256, 2, 56, 2 * 56 * 64), device=card, dtype=torch.bfloat16)
    info = stem_cuda.bwd_kernel_info(yq)
    assert info["registers"] <= 128 and info["local_bytes"] == 0
    assert info["ctas_per_sm"] >= 2 and info["band_rows"] == 8


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
    unaligned = torch.empty(g.numel() + 8, device=card, dtype=g.dtype)[1:g.numel() + 1]
    with pytest.raises(ValueError, match="aligned"):
        stem_cuda.bwd(yq, unaligned.view(g.shape), se, oe)
    wide = torch.empty((1, 2, 400, 2 * 400 * 64), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"needs W2 <= \d+"):
        stem_cuda.bwd(wide, wide[:, 0, :, :400 * 64].contiguous(),
                      torch.ones(64, device=card), torch.zeros(64, device=card))


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


# attention: (atol, rtol) of the JAX package's tests (test_models.py:304-377)
ATTN_TOL = {
    torch.float32: {"out": (2e-5, 0.0), "grad": (1e-4, 0.0)},
    torch.bfloat16: {"out": (3e-2, 3e-2), "grad": (0.25, 0.1)},
}
# and, since those were set at N=40 and pass a halved dV at N=785 in bf16,
# each tensor relative to the plain version: max|err| <= max * max|ref| and
# ||err||_2 <= l2 * ||ref||_2 (chip_smoke.py's ATTN_REL_TOL)
ATTN_REL_TOL = {"max": 0.05, "l2": 0.015}


def _assert_rel_close(got, want):
    got, want = got.float(), want.float()
    err = got - want
    assert float(err.abs().max()) <= ATTN_REL_TOL["max"] * float(want.abs().max())
    assert float(err.norm()) <= ATTN_REL_TOL["l2"] * float(want.norm())


def _qkv(b, n, h, dtype, device, seed=0):
    """q, k, v as strided [B, N, H, 64] views of one [B, N, 3*H*64]
    projection (the ViT block's layout), and an output gradient."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * 64), np.float32)).to(device, dtype)
    g = torch.from_numpy(rng.standard_normal((b, n, h, 64), np.float32)).to(device, dtype)
    return qkv, [t.view(b, n, h, 64) for t in qkv.split(h * 64, dim=-1)], g


# the tile edges of the kernels' 64-token tiles: N of one token, below,
# at and past one tile, two and four tiles; one head (B=2) and six (B=1)
ATTN_EDGE_SHAPES = [(2 if h == 1 else 1, n, h)
                    for n in (1, 16, 17, 63, 64, 65, 129, 197) for h in (1, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 50, 4), (1, 300, 2), (4, 785, 6)] + ATTN_EDGE_SHAPES)
def test_attention_kernels_match_plain(card, dtype, shape):
    """attn_fwd and attn_bwd against the plain version on strided views:
    the JAX package's tolerances and the relative limits, each launch
    counted, and two backward runs giving identical gradients (no
    atomics).  At N=1 the plain dq and dk are exactly 0 (dS = P (dP - D)
    with P = 1 and D = dP), so the relative limits ask the kernels for 0."""
    b, n, h = shape
    qkv, (q, k, v), g = _qkv(b, n, h, dtype, card)
    before = dict(attention_cuda.launches)
    out, lse = attention_cuda.fwd(q, k, v)
    grads = attention_cuda.bwd(q, k, v, out, lse, g)
    again = attention_cuda.bwd(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    assert {k_: attention_cuda.launches[k_] - before[k_] for k_ in before} == {
        "attn_fwd": 1, "attn_bwd": 2, "attn_fwd_mla": 0, "attn_bwd_mla": 0}
    leaf = qkv.clone().requires_grad_(True)
    views = [t.view(b, n, h, 64) for t in leaf.split(h * 64, dim=-1)]
    want = attention.attention_reference(*views)
    want_grads = torch.autograd.grad(want, views, g)
    atol, rtol = ATTN_TOL[dtype]["out"]
    torch.testing.assert_close(out.float(), want.detach().float(), atol=atol, rtol=rtol)
    _assert_rel_close(out, want.detach())
    atol, rtol = ATTN_TOL[dtype]["grad"]
    for got, ref, rerun in zip(grads, want_grads, again):
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)
        _assert_rel_close(got, ref)
        assert torch.equal(got, rerun)


@pytest.mark.cuda
def test_fused_attention_function_on_card(card):
    """fused_attention's autograd.Function launches both kernels and gives
    the kernels' gradients, assembled into the projection's gradient."""
    b, n, h = 2, 129, 2
    qkv, (q, k, v), g = _qkv(b, n, h, torch.bfloat16, card, seed=1)
    out, lse = attention_cuda.fwd(q, k, v)
    direct = attention_cuda.bwd(q, k, v, out, lse, g)
    leaf = qkv.clone().requires_grad_(True)
    before = dict(attention_cuda.launches)
    fused = attention.fused_attention(*[t.view(b, n, h, 64) for t in leaf.split(h * 64, -1)])
    (dqkv,) = torch.autograd.grad(fused, leaf, g)
    assert attention_cuda.launches == {k_: v_ + ("mla" not in k_) for k_, v_ in before.items()}
    assert torch.equal(fused, out)
    assert torch.equal(dqkv, torch.cat([d.reshape(b, n, h * 64) for d in direct], -1))


@pytest.mark.cuda
def test_attention_wrappers_reject_what_the_kernels_do_not_take(card):
    _, (q, k, v), g = _qkv(1, 20, 2, torch.bfloat16, card)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        attention_cuda.fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="CUDA"):
        attention_cuda.fwd(q.cpu(), k, v)
    with pytest.raises(ValueError, match="head dim"):
        attention_cuda.fwd(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="must match q"):
        attention_cuda.fwd(q, k.float(), v)
    with pytest.raises(ValueError, match="contiguous"):
        attention_cuda.fwd(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    out, lse = attention_cuda.fwd(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        attention_cuda.bwd(q, k, v, out, lse.double(), g)
    with pytest.raises(ValueError, match="head dim"):  # no fallback through the Function
        attention.fused_attention(q[..., :32], k[..., :32], v[..., :32])


@pytest.mark.cuda
def test_vit_s8_serving_launches_the_attention_kernel(card):
    """vit_s8 through Transcriber on the card, cut to 2 layers: each batch
    launches attn_fwd once per layer and never attn_bwd."""
    from guitar_tablature_classification_tpu_torch.config import ModelConfig

    cfg = ModelConfig(arch="vit_s8", vit_layers=2)
    t = Transcriber(None, model_cfg=cfg, batch_size=8)
    audio = _windows(t.cqt_cfg, 1, seed=4, device="cpu").numpy().repeat(5)
    windows = (len(audio) - t.cqt_cfg.window_samples) // t.cqt_cfg.hop_samples + 1
    before = dict(attention_cuda.launches)
    out = t.transcribe(audio, keep_logits=True)
    batches, lo = 0, 0  # the transcriber's bucketed batches
    while lo < windows:
        lo += min(t._bucket_for(windows - lo), windows - lo)
        batches += 1
    assert attention_cuda.launches["attn_fwd"] - before["attn_fwd"] == 2 * batches
    assert attention_cuda.launches["attn_bwd"] == before["attn_bwd"]
    assert out.logits.shape == (windows, 6, 19) and np.isfinite(out.logits).all()


def _trunk_case(shape, dtype, device, channels_last, seed=0):
    """A trunk activation [B, C, H, W] and its gradient in one memory format."""
    rng = np.random.default_rng(seed)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    y, g = (torch.from_numpy(rng.standard_normal(shape, np.float32) * 2 + 0.5)
            .to(device, dtype).contiguous(memory_format=fmt) for _ in range(2))
    return y, g


@pytest.mark.cuda
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(16, 64, 56, 56), (32, 128, 24, 3), (64, 512, 3, 1)])
def test_bn_sums_kernels_match_plain(card, shape, dtype, channels_last):
    """bn_sums and bn_grad_sums against their plain versions on the same
    card tensors, read through either memory format with no copy: rtol 1e-5
    (fp32 summation order), two runs identical, each launch counted."""
    y, g = _trunk_case(shape, dtype, card, channels_last)
    before = dict(bn_cuda.launches)
    sums, gsums = bn_fused.sums(y), bn_fused.grad_sums(y, g)
    torch.cuda.synchronize()
    assert {k: bn_cuda.launches[k] - before[k] for k in before} == {
        "bn_sums": 1, "bn_grad_sums": 1}
    scale = lambda t: 1e-5 * float(t.abs().max())  # noqa: E731
    want, gwant = bn_fused.sums_plain(y), bn_fused.grad_sums_plain(y, g)
    torch.testing.assert_close(sums, want, rtol=1e-5, atol=scale(want))
    torch.testing.assert_close(gsums, gwant, rtol=1e-5, atol=scale(gwant))
    assert torch.equal(bn_cuda.sums(y), sums) and torch.equal(bn_cuda.grad_sums(y, g), gsums)


@pytest.mark.cuda
def test_batch_norm_train_on_card_matches_cpu(card):
    """batch_norm_train through its autograd.Function, card (kernels)
    against CPU (plain versions), bf16 channels-last input: outputs and dy
    to one bf16 ulp of their scale (the statistics' summation order may
    move a rounding), mean and var to 1e-5, dscale and dbias to 1e-3."""
    y, g = _trunk_case((8, 64, 28, 28), torch.bfloat16, "cpu", True, seed=1)
    scale, bias = torch.linspace(0.5, 1.5, 64), torch.linspace(-0.1, 0.1, 64)
    outs = {}
    for dev in ("cpu", card):
        y_, s_, b_ = (t.to(dev).clone().requires_grad_(True) for t in (y, scale, bias))
        out, mean, var = bn_fused.batch_norm_train(y_, s_, b_)
        out.backward(g.to(dev))
        outs[str(dev)] = [t.detach().float().cpu() for t in (out, mean, var, y_.grad, s_.grad, b_.grad)]
    for name, a, b, tol in zip(("out", "mean", "var", "dy", "dscale", "dbias"),
                               outs[str(card)], outs["cpu"], (1e-2, 1e-5, 1e-5, 1e-2, 1e-3, 1e-3)):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol * max(1.0, float(b.abs().max())),
                                   msg=name)


@pytest.mark.cuda
def test_bn_wrappers_reject_what_the_kernel_does_not_take(card):
    y, g = _trunk_case((2, 64, 4, 4), torch.bfloat16, card, False)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bn_cuda.sums(y.half())
    with pytest.raises(ValueError, match="channels-last"):
        bn_cuda.sums(y.transpose(0, 1))
    with pytest.raises(ValueError, match="memory layout"):
        bn_cuda.grad_sums(y, g.contiguous(memory_format=torch.channels_last))
    with pytest.raises(ValueError, match="lanes"):
        bn_cuda.sums(torch.zeros(4, 3, device=card))


def _native_case(dtype, device, batch=64, seed=0, h2=24, wp=6, wreal=5, c=64, nan=False):
    """Parity planes [B, H2, Wp*C] on a quarter grid (many exact ties in
    the pooling windows), pad columns of 7.7, BN affine terms (mixed signs
    where ``nan``) and a pooled gradient [B, H2, Wout, C]; ``nan`` puts one
    NaN in a real column of yo."""
    rng = np.random.default_rng(seed)
    planes = np.round(rng.standard_normal((2, batch, h2, wp, c)) * 4) / 4
    planes[:, :, :, wreal:] = 7.7
    if nan:
        planes[1, batch // 2, h2 // 2, wreal // 2, c // 3] = np.nan
    se = rng.uniform(-1.5 if nan else 0.5, 1.5, c).astype(np.float32)
    oe = (rng.standard_normal(c) * 0.1).astype(np.float32)
    g = rng.standard_normal((batch, h2, stem_native.pool_out_width(wreal), c))
    to = lambda a, dt: torch.from_numpy(np.asarray(a)).to(device, dt)  # noqa: E731
    ye, yo = (to(p.reshape(batch, h2, wp * c), dtype) for p in planes)
    return ye, yo, to(se, torch.float32), to(oe, torch.float32), to(g, dtype)


NATIVE_EDGES = {  # name: (B, H2, Wp, Wreal, C, NaN): the cuts of the backward kernel's plan
    "b64": (64, 24, 6, 5, 64, False),
    "b1": (1, 24, 6, 5, 64, False),
    "ragged_37": (37, 24, 6, 5, 64, False),  # one image a CTA
    "ragged_529": (529, 24, 6, 5, 64, False),  # three images a CTA, the last CTA one
    "b4096": (4096, 24, 6, 5, 64, False),  # the model shape: 16 images a CTA
    "h2_1": (3, 1, 6, 5, 16, False),
    "w_pad0": (64, 24, 5, 5, 64, False),
    "c8": (5, 24, 6, 5, 8, False),
    "c128": (9, 24, 6, 5, 128, False),  # two bf16 slices, four fp32 ones
    "nan": (64, 24, 6, 5, 64, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(NATIVE_EDGES))
def test_native_stem_kernels_match_plain(card, name, dtype):
    """native_stats, native_fwd and native_bwd against their plain versions
    on tie-rich card tensors at the shapes that cut the backward kernel's
    plan: pooled output, dye and dyo bit for bit (same fp32 rounding and
    tie-break, no FMA contraction; a NaN where the plain version has one),
    per-lane sums to rtol 1e-5, two runs identical, each launch counted."""
    b, h2, wp, wreal, c, nan = NATIVE_EDGES[name]
    ye, yo, se, oe, g = _native_case(dtype, card, b, h2=h2, wp=wp, wreal=wreal, c=c, nan=nan)
    before = dict(stem_native_cuda.launches)
    sums = stem_native.stats(ye, yo)
    pooled = stem_native.fwd(ye, yo, se, oe, wreal)
    dye, dyo, sdz, sdzy = stem_native.bwd(ye, yo, g, se, oe, wreal)
    torch.cuda.synchronize()
    assert {k: stem_native_cuda.launches[k] - before[k] for k in before} == {
        "native_stats": 1, "native_fwd": 1, "native_bwd": 1}

    def close(got, ref, exact=False):
        tol = 0.0 if exact else 1e-5
        atol = tol * float(ref.nan_to_num().abs().max())
        torch.testing.assert_close(got, ref, rtol=tol, atol=atol, equal_nan=nan)

    close(sums, stem_native.stats_plain(ye, yo))
    close(pooled, stem_native.fwd_plain(ye, yo, se, oe, wreal), exact=True)
    wdye, wdyo, wsdz, wsdzy = stem_native.bwd_plain(ye, yo, g, se, oe, wreal)
    assert torch.equal(dye, wdye) and torch.equal(dyo, wdyo)
    close(sdz, wsdz)
    close(sdzy, wsdzy)
    assert bool(torch.isnan(sdzy).any()) == nan
    again = stem_native.bwd(ye, yo, g, se, oe, wreal)
    for a, w in zip((*again, stem_native.stats(ye, yo)), (dye, dyo, sdz, sdzy, sums)):
        torch.testing.assert_close(a, w, rtol=0, atol=0, equal_nan=True)  # NaNs in place


@pytest.mark.cuda
def test_native_bwd_holds_two_ctas_an_sm_without_spills(card):
    """The backward kernel at the model shape (bf16 [4096, 24, 384]): at most
    128 registers, no local memory, two CTAs an SM, 16 images a CTA."""
    ye = torch.empty((4096, 24, 384), device=card, dtype=torch.bfloat16)
    info = stem_native_cuda.bwd_kernel_info(ye)
    assert info["registers"] <= 128 and info["local_bytes"] == 0
    assert info["ctas_per_sm"] >= 2 and info["threads"] == stem_native_cuda.BWD_THREADS
    assert info["images_per_cta"] == 16 and info["cs"] == 64


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_native_bwd_plan_is_what_the_kernel_addresses(card, dtype):
    """The plan owns the backward kernel's row groups and shared bytes; the
    source checks them against the layout the kernel addresses: at every
    edge shape it takes the plan's bytes and refuses 16 fewer, and refuses
    more row groups than its threads hold."""
    lib, info = stem_native_cuda._library(), (ctypes.c_int * 5)()
    code = 1 if dtype == torch.bfloat16 else 0
    for b, h2, wp, _, c, _ in NATIVE_EDGES.values():
        plan = stem_native_cuda.bwd_plan(b, h2, wp, c, dtype)
        args = (h2, wp, plan.cs, plan.row_groups)
        assert lib.native_bwd_kernel_info(*args, plan.smem_bytes, code, info) == 0
        assert info[2] >= plan.smem_bytes
        assert lib.native_bwd_kernel_info(*args, plan.smem_bytes - 16, code, info) != 0
        assert lib.native_bwd_kernel_info(h2, wp, plan.cs, 2 * plan.row_groups,
                                          1 << 20, code, info) != 0


@pytest.mark.cuda
def test_native_fwd_holds_three_ctas_an_sm_without_spills(card):
    """The forward kernel at the model shape (bf16 [4096, 24, 384]) and at
    fp32: no local memory, the planned three CTAs an SM (at most 85
    registers), 11 images a CTA at bf16."""
    for dtype in (torch.bfloat16, torch.float32):
        ye = torch.empty((4096, 24, 384), device=card, dtype=dtype)
        info = stem_native_cuda.fwd_kernel_info(ye)
        assert info["local_bytes"] == 0 and info["registers"] <= 85
        assert info["ctas_per_sm"] >= 3 and info["threads"] == stem_native_cuda.FWD_THREADS
    bf16 = stem_native_cuda.fwd_kernel_info(torch.empty((4096, 24, 384), device=card,
                                                        dtype=torch.bfloat16))
    assert bf16["images_per_cta"] == 11 and bf16["cs"] == 64


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_native_fwd_plan_is_what_the_kernel_addresses(card, dtype):
    """The plan owns the forward kernel's slice and shared bytes; the source
    checks them against the layout the kernel addresses: at every edge shape
    it takes the plan's bytes and refuses 16 fewer, and refuses a slice
    wider than 128 bytes a pixel."""
    lib, info = stem_native_cuda._library(), (ctypes.c_int * 5)()
    code = 1 if dtype == torch.bfloat16 else 0
    for b, h2, wp, _, c, _ in NATIVE_EDGES.values():
        plan = stem_native_cuda.fwd_plan(b, h2, wp, c, dtype)
        assert lib.native_fwd_kernel_info(h2, wp, plan.cs, plan.smem_bytes, code, info) == 0
        assert info[2] >= plan.smem_bytes
        assert lib.native_fwd_kernel_info(h2, wp, plan.cs, plan.smem_bytes - 16, code, info) != 0
        assert lib.native_fwd_kernel_info(h2, wp, 2 * 128 // (2 if code else 4), 1 << 20,
                                          code, info) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("wp", [6, 5])
def test_native_fwd_matches_plain_at_serving_batch(card, dtype, wp):
    """native_fwd at serving's batch (2048: runs of 6 images), with and
    without the pad column, tie-rich: bit for bit with fwd_plain, one
    launch."""
    ye, yo, se, oe, _ = _native_case(dtype, card, 2048, seed=7, wp=wp)
    before = stem_native_cuda.launches["native_fwd"]
    pooled = stem_native.fwd(ye, yo, se, oe, 5)
    torch.cuda.synchronize()
    assert stem_native_cuda.launches["native_fwd"] == before + 1
    assert torch.equal(pooled, stem_native.fwd_plain(ye, yo, se, oe, 5))


@pytest.mark.cuda
def test_native_stem_wrappers_reject_what_the_kernels_do_not_take(card):
    ye, yo, se, oe, g = _native_case(torch.bfloat16, card, batch=2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        stem_native_cuda.fwd(ye.half(), yo.half(), se, oe, 5)
    with pytest.raises(ValueError, match="contiguous"):
        stem_native_cuda.fwd(ye.transpose(0, 1).contiguous().transpose(0, 1), yo, se, oe, 5)
    with pytest.raises(ValueError, match="wreal"):
        stem_native_cuda.fwd(ye, yo, se, oe, 7)
    with pytest.raises(ValueError, match="se must be"):
        stem_native_cuda.fwd(ye, yo, se.double(), oe, 5)
    with pytest.raises(ValueError, match="g must be"):
        stem_native_cuda.bwd(ye, yo, g[:, :1], se, oe, 5)

    def unaligned(t):  # contiguous, one element off a 16-byte boundary
        return torch.empty(t.numel() + 8, device=card, dtype=t.dtype)[1:t.numel() + 1].view(t.shape)

    with pytest.raises(ValueError, match="aligned"):
        stem_native_cuda.bwd(ye, yo, unaligned(g), se, oe, 5)
    with pytest.raises(ValueError, match="aligned"):
        stem_native_cuda.bwd(unaligned(ye), yo, g, se, oe, 5)
    tall = torch.zeros((1, 400, 384), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"needs H2 <= \d+"):
        stem_native_cuda.bwd(tall, tall.clone(), torch.zeros((1, 400, 3, 64), device=card,
                                                              dtype=torch.bfloat16), se, oe, 5)


@pytest.mark.cuda
def test_native_fused_serving_launches_the_stem_kernel(card):
    """native-best with stem_fusion="fused", bn_fusion="on" through
    Transcriber on the card: each batch launches native_fwd once, and no
    train-mode kernel (the fused BatchNorm has none in eval mode)."""
    cfg = RECIPES["native-best"]()
    model_cfg = dataclasses.replace(cfg.model, stem_fusion="fused", bn_fusion="on")
    t = Transcriber(None, model_cfg=model_cfg, cqt_cfg=cfg.cqt, batch_size=16)
    windows = _windows(cfg.cqt, 40, seed=5, device="cpu").numpy()
    before = dict(stem_native_cuda.launches), dict(bn_cuda.launches)
    logits = t.predict_windows(windows)
    batches, lo = 0, 0  # the transcriber's bucketed batches
    while lo < len(windows):
        lo += min(t._bucket_for(len(windows) - lo), len(windows) - lo)
        batches += 1
    assert stem_native_cuda.launches["native_fwd"] - before[0]["native_fwd"] == batches
    assert stem_native_cuda.launches["native_stats"] == before[0]["native_stats"]
    assert stem_native_cuda.launches["native_bwd"] == before[0]["native_bwd"]
    assert bn_cuda.launches == before[1]
    assert logits.shape == (40, 6, 19) and np.isfinite(logits).all()


def _assert_within_one_bf16_ulp(got, want):
    """One bf16 ulp of the larger magnitude, plus 1e-5 of max|want| for
    outputs near zero: both sides round once from fp32 sums of the same
    exact products, in another order."""
    got, want = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    limit = torch.ldexp(torch.ones_like(got), e - 8) + 1e-5 * want.abs().max()
    assert bool(((got - want).abs() <= limit).all()), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("shape", ["train", "ragged"])
def test_frame_gemm_kernel_matches_plain(card, shape, precision):
    """The raw frame GEMM against frame_gemm_plain (TF32 off): per window,
    max|err| <= 1e-4 max|ref| (fp32 summation order); two runs identical;
    one launch a call.  "ragged": any K, Kw and N off the tiles, P short,
    the depth split into ranges."""
    if shape == "train":
        fe = CQTFrontend(CQTConfig())
        cfg = fe.cfg
        kernels = fe.kernels_on(card)
        x = _windows(cfg, 16, seed=7, device=card)
        kw = kernels.shape[0]
        padded = torch.nn.functional.pad(x, (kw // 2, kw // 2))
        hop, t = cfg.hop_length, cfg.n_frames
    else:
        gen = torch.Generator(device=card).manual_seed(8)
        kernels = torch.randn((5000, 20), generator=gen, device=card)
        padded = torch.randn((4, 6000), generator=gen, device=card)
        hop, t = 333, 7  # P < 6*333 + 5000: zeros past the end; 9 depth ranges
    before = cqt_cuda.frame_gemm_launches
    got = cqt_cuda.cqt_frame_gemm(padded, kernels, hop_length=hop, n_frames=t,
                                  batch_block=4, precision=precision)
    torch.cuda.synchronize()
    assert cqt_cuda.frame_gemm_launches == before + 1
    want = frame_gemm_plain(padded, kernels, hop_length=hop, n_frames=t, precision=precision)
    err = (got - want).abs().amax(dim=(1, 2))
    assert bool((err <= 1e-4 * want.abs().amax(dim=(1, 2))).all()), err
    again = cqt_cuda.cqt_frame_gemm(padded, kernels, hop_length=hop, n_frames=t,
                                    batch_block=4, precision=precision)
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["train", "serving_cnn", "ragged", "ragged_ring"])
def test_frame_gemm_default_runs_on_tensor_cores(card, shape):
    """The default tier's tensor-core frame GEMM: per window max|err| <=
    1e-4 max|ref| against frame_gemm_plain, two runs identical, one
    tensor-core launch a call; serving_cnn has 130 frames a window.  The
    ragged cases: Kw 5000, N 20, P short; hop 333 (the kernel that loads
    the fp32 operands) and hop 512 (the ring kernel's padded copies)."""
    if shape.startswith("ragged"):
        gen = torch.Generator(device=card).manual_seed(12)
        kernels = torch.randn((5000, 20), generator=gen, device=card)
        padded = torch.randn((4, 6000), generator=gen, device=card)
        hop, t = (333 if shape == "ragged" else 512), 7
    else:
        fe = CQTFrontend(CQTConfig() if shape == "train" else CQTConfig.serving_cnn())
        kernels = fe.kernels_on(card)
        x = _windows(fe.cfg, 4, seed=13, device=card)
        kw = kernels.shape[0]
        padded = torch.nn.functional.pad(x, (kw // 2, kw // 2))
        hop, t = fe.cfg.hop_length, fe.cfg.n_frames
    before = (cqt_cuda.frame_gemm_launches, cqt_cuda.frame_gemm_mma_launches["default"])
    got = cqt_cuda.cqt_frame_gemm(padded, kernels, hop_length=hop, n_frames=t,
                                  batch_block=4, precision="default")
    assert (cqt_cuda.frame_gemm_launches, cqt_cuda.frame_gemm_mma_launches["default"]) == (
        before[0] + 1, before[1] + 1)
    want = frame_gemm_plain(padded, kernels, hop_length=hop, n_frames=t, precision="default")
    err = (got - want).abs().amax(dim=(1, 2))
    assert bool((err <= 1e-4 * want.abs().amax(dim=(1, 2))).all()), err
    again = cqt_cuda.cqt_frame_gemm(padded, kernels, hop_length=hop, n_frames=t,
                                    batch_block=4, precision="default")
    assert torch.equal(again, got)
    one = cqt_cuda.cqt_frame_gemm(padded[:1], kernels, hop_length=hop, n_frames=t,
                                  batch_block=1, precision="default")
    err1 = float((one - want[:1]).abs().max())
    assert err1 <= 1e-4 * float(want[:1].abs().max())
    with pytest.raises(ValueError, match="rows"):  # as the SIMT tiers: B = 0 is refused
        cqt_cuda.cqt_frame_gemm(padded[:0], kernels, hop_length=hop, n_frames=t,
                                batch_block=1, precision="default")


SPLIT_TIER_CFGS = {
    "train": CQTConfig(),  # hop 1024
    "serving_cnn": CQTConfig.serving_cnn(),  # hop 512
    "hop1000": RECIPE_CFGS["hop1000"],
}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
@pytest.mark.parametrize("name", list(SPLIT_TIER_CFGS))
def test_frame_gemm_split_tiers_run_on_tensor_cores(card, name, precision):
    """highest and bf16x3 at hops 1024, 512 and 1000: one tensor-core launch
    of the tier a call; per window max|err| <= 1e-4 max|ref| against
    frame_gemm_plain (TF32 off); two runs identical; at highest, the
    per-window error against a float64 contraction of the same inputs at
    most 4x that of the fp32 plain version (the tier is as accurate as
    fp32)."""
    fe = CQTFrontend(SPLIT_TIER_CFGS[name])
    cfg = fe.cfg
    kernels = fe.kernels_on(card)
    x = _windows(cfg, 8, seed=14, device=card)
    kw = kernels.shape[0]
    padded = torch.nn.functional.pad(x, (kw // 2, kw // 2))
    hop, t = cfg.hop_length, cfg.n_frames
    kw_args = dict(hop_length=hop, n_frames=t, batch_block=4, precision=precision)
    before = (cqt_cuda.frame_gemm_launches, dict(cqt_cuda.frame_gemm_mma_launches))
    got = cqt_cuda.cqt_frame_gemm(padded, kernels, **kw_args)
    torch.cuda.synchronize()
    assert cqt_cuda.frame_gemm_launches == before[0] + 1
    assert {k: v - before[1][k] for k, v in cqt_cuda.frame_gemm_mma_launches.items()} == {
        "highest": int(precision == "highest"), "bf16x3": int(precision == "bf16x3"),
        "default": 0}
    want = frame_gemm_plain(padded, kernels, hop_length=hop, n_frames=t, precision=precision)
    err = (got - want).abs().amax(dim=(1, 2))
    assert bool((err <= 1e-4 * want.abs().amax(dim=(1, 2))).all()), err
    assert torch.equal(cqt_cuda.cqt_frame_gemm(padded, kernels, **kw_args), got)
    if precision == "highest":
        ref = frame_gemm_plain(padded.double(), kernels.double(), hop_length=hop, n_frames=t,
                               precision="highest")
        scale = ref.abs().amax(dim=(1, 2))
        f64_err = float(((got.double() - ref).abs().amax(dim=(1, 2)) / scale).max())
        plain_err = float(((want.double() - ref).abs().amax(dim=(1, 2)) / scale).max())
        assert f64_err <= 4 * plain_err, (f64_err, plain_err)


@pytest.mark.cuda
def test_frame_gemm_wrapper_rejects_what_the_kernel_does_not_take(card):
    padded = torch.zeros((4, 3000), device=card)
    kernels = torch.zeros((1000, 20), device=card)
    kw = dict(hop_length=333, n_frames=7, batch_block=4)
    with pytest.raises(ValueError, match="float32"):
        cqt_cuda.cqt_frame_gemm(padded.double(), kernels, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        cqt_cuda.cqt_frame_gemm(padded[:, ::2], kernels, **kw)
    with pytest.raises(ValueError, match="kernels"):
        cqt_cuda.cqt_frame_gemm(padded, kernels.cpu(), **kw)
    with pytest.raises(ValueError, match="not divisible by block 3"):
        cqt_cuda.cqt_frame_gemm(padded, kernels, hop_length=333, n_frames=7, batch_block=3)


def _gemm_operands(card, m, k, n, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    hq = torch.randn((m, k), generator=gen, device=card).to(torch.bfloat16)
    sq = (0.05 * torch.randn((k, n), generator=gen, device=card)).to(torch.bfloat16)
    return hq, sq


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, n", [(600, 70, 200), (256, 33, 7168), (1, 128, 8),
                                     (28600, 70, 7168)])
def test_gemm_stats_kernel_matches_plain(card, m, k, n):
    """y within one bf16 ulp of the plain version; sums within 1e-5 of
    max|sum| of the float64 column sums of the kernel's own y; two runs
    identical; one launch a call.  The shapes take ragged row and column
    tiles, an odd K (the 2-byte staging path), the largest K, and an M that
    is not a multiple of the CTAs' rows (runs of 56 row tiles, the last
    tile 56 rows)."""
    hq, sq = _gemm_operands(card, m, k, n)
    before = dict(stem_cuda.launches)
    y, sums = stem_tail.gemm_stats(hq, sq, m_tile=m)
    torch.cuda.synchronize()
    assert {key: stem_cuda.launches[key] - before[key] for key in before} == {
        "stem_stats": 0, "stem_fwd": 0, "stem_bwd": 0, "gemm_stats": 1}
    want_y, _ = stem_tail.gemm_stats_plain(hq, sq)
    _assert_within_one_bf16_ulp(y, want_y)
    y64 = y.double()
    ref = torch.stack([y64.sum(0), (y64 * y64).sum(0)])
    assert bool(((sums.double() - ref).abs().amax(1) <= 1e-5 * ref.abs().amax(1)).all())
    y2, sums2 = stem_cuda.gemm_stats(hq, sq)
    assert torch.equal(y2, y) and torch.equal(sums2, sums)


@pytest.mark.cuda
def test_gemm_stats_holds_two_ctas_an_sm_without_spills(card):
    """The GEMM kernel at the tool's shape ([28672, 70] x [70, 7168]): no
    local memory, the planned two CTAs an SM, 224 CTAs."""
    info = stem_cuda.gemm_stats_kernel_info()
    assert info["local_bytes"] == 0 and info["registers"] <= 128
    assert info["ctas_per_sm"] >= 2 and info["threads"] == stem_cuda.GEMM_THREADS
    assert info["grid"] == 224 and info["shared_bytes"] >= info["smem_bytes"]


@pytest.mark.cuda
def test_gemm_stats_wrapper_rejects_what_the_kernel_does_not_take(card):
    hq, sq = _gemm_operands(card, 256, 70, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        stem_cuda.gemm_stats(hq.float(), sq)
    with pytest.raises(ValueError, match="N % 8"):
        stem_cuda.gemm_stats(hq, sq[:, :60].contiguous())
    big_hq, big_sq = _gemm_operands(card, 256, 130, 64)
    with pytest.raises(ValueError, match="K <= 128"):
        stem_cuda.gemm_stats(big_hq, big_sq)
    shifted = hq.reshape(-1)[1:1 + 255 * 70].view(255, 70)
    with pytest.raises(ValueError, match="aligned"):
        stem_cuda.gemm_stats(shifted, sq)
    with pytest.raises(ValueError, match="m_tile"):  # the JAX signature's row tile
        stem_tail.gemm_stats(hq[:200], sq)
    with pytest.raises(ValueError, match="lie on a CUDA device"):
        stem_cuda.gemm_stats(hq.cpu(), sq.cpu())


def _conv_case(card, b, h, w, c, f, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((b, h, w, c), generator=gen, device=card).to(torch.bfloat16)
    w9 = (0.05 * torch.randn((9, c, f), generator=gen, device=card)).to(torch.bfloat16)
    s = (0.5 + torch.rand(c, generator=gen, device=card)).to(torch.bfloat16)
    o = (0.1 * torch.randn(c, generator=gen, device=card)).to(torch.bfloat16)
    return x, w9, s, o


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 8, 16, 32), (3, 7, 7, 64, 64), (2, 5, 9, 40, 136),
                                   (1, 14, 14, 256, 256), (1, 1, 37, 8, 8),
                                   (2, 9, 13, 1024, 16), (2, 30, 57, 16, 8), (1, 56, 56, 8, 72)])
def test_conv3x3_kernel_matches_plain(card, shape):
    """The conv against conv3x3_plain (TF32 off): within one bf16 ulp;
    two runs identical; one launch a call.  The shapes take ragged output
    blocks (W not a multiple of the block's width), the halo of small
    maps, B=1, H=1, C=8 and C=1024, C off the 16-channel chunk, and F=8 and
    F off the 64-column tile."""
    x, w9, s, o = _conv_case(card, *shape)
    before = conv3x3_cuda.launches["conv3x3"]
    got = conv3x3.conv3x3_affine_relu(x, w9, s, o)
    torch.cuda.synchronize()
    assert conv3x3_cuda.launches["conv3x3"] == before + 1
    _assert_within_one_bf16_ulp(got, conv3x3.conv3x3_plain(x, w9, s, o))
    assert torch.equal(conv3x3_cuda.conv3x3(x, w9, s, o), got)


@pytest.mark.cuda
def test_conv3x3_wrapper_rejects_what_the_kernel_does_not_take(card):
    x, w9, s, o = _conv_case(card, 2, 6, 6, 16, 16)
    with pytest.raises(ValueError, match="bfloat16"):
        conv3x3_cuda.conv3x3(x.float(), w9, s, o)
    with pytest.raises(ValueError, match="multiples of 8"):
        conv3x3_cuda.conv3x3(x[..., :12].contiguous(), w9[:, :12].contiguous(), s[:12], o[:12])
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_cuda.conv3x3(x.transpose(1, 2), w9, s, o)
    shifted = x.reshape(-1)[4:4 + 6 * 6 * 16].view(1, 6, 6, 16)  # 8 bytes off
    with pytest.raises(ValueError, match="aligned"):
        conv3x3_cuda.conv3x3(shifted, w9, s, o)
    with pytest.raises(ValueError, match="must lie on"):
        conv3x3_cuda.conv3x3(x, w9.cpu(), s, o)


@pytest.mark.cuda
def test_checkpoint_written_on_the_card_reloads_there(card, tmp_path, capsys):
    """train.run on the card (native-best, the native fused stem and the
    fused BatchNorm, one synthetic track, one epoch) writes a checkpoint
    and, with --profile-dir, a trace that holds the native stem's kernels;
    restored into a fresh state on the card the checkpoint holds the
    file's weights, moments and step; --eval-only reports that step; a
    Transcriber served from the file on the card gives the restored
    model's logits."""
    import json

    from guitar_tablature_classification_tpu_torch.models import build_model
    from guitar_tablature_classification_tpu_torch.train import Checkpointer, create_train_state
    from guitar_tablature_classification_tpu_torch.train import run as train_run

    ck = str(tmp_path / "ck")
    base = ["--synthetic", "--synthetic-tracks", "1", "--recipe", "native-best",
            "--stem-fusion", "fused", "--bn-fusion", "on", "--checkpoint-dir", ck,
            "--device", "cuda"]
    before = dict(stem_native_cuda.launches)
    prof = tmp_path / "prof"
    assert train_run.main([*base, "--epochs", "1", "--profile-dir", str(prof)]) == 0
    assert stem_native_cuda.launches["native_bwd"] > before["native_bwd"]
    assert "native_bwd" in (prof / "trace.json").read_text()
    assert (prof / "ops.txt").stat().st_size > 0
    cfg = train_run.make_config(train_run.build_parser().parse_args(base))
    ckpt = Checkpointer(ck)
    state = create_train_state(build_model(cfg.model), cfg.optim, device="cuda")
    state, meta = ckpt.restore(state, expect_model=dataclasses.asdict(cfg.model))
    tree = torch.load(ckpt.path, map_location="cpu", weights_only=True)
    assert state.params.is_cuda and state.step == meta["step"] == tree["step"] > 0
    sd = state.model.state_dict()
    for key, value in tree["model_state_dict"].items():
        assert torch.equal(sd[key].cpu(), value), key
    adam = state.adam_state()
    assert adam["count"] == tree["optimizer_state_dict"]["count"] == state.step
    for name, value in tree["optimizer_state_dict"]["mu"].items():
        assert torch.equal(adam["mu"][name].cpu(), value), name
    capsys.readouterr()
    assert train_run.main([*base, "--eval-only"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["checkpoint_step"] == \
        state.step
    served = Transcriber(tree["model_state_dict"], model_cfg=cfg.model, cqt_cfg=cfg.cqt,
                         device="cuda")
    windows = _windows(cfg.cqt, 16, 3, card)
    state.model.eval()
    with torch.no_grad():
        want = state.model(served.preprocess(served.frontend(windows)))
    assert torch.equal(served.predict_logits(windows), want)


@pytest.mark.cuda
def test_loader_batches_reach_the_card_through_pinned_copies(card):
    """batch_to_device: NumPy batches land on the card with their dtypes
    and values; the augmentation draws the same on a CUDA generator for
    the same seed."""
    from guitar_tablature_classification_tpu_torch.ops.augment import augment_batch
    from guitar_tablature_classification_tpu_torch.train import batch_to_device

    rng = np.random.default_rng(0)
    feats = rng.uniform(-120, 0, (8, 96, 9)).astype(np.float32)
    labels = rng.integers(0, 19, (8, 6)).astype(np.int32)
    out = batch_to_device({"features": feats, "labels": labels}, card)
    torch.cuda.synchronize()
    assert out["features"].is_cuda and out["labels"].dtype == torch.int32
    assert np.array_equal(out["features"].cpu().numpy(), feats)
    a = augment_batch(torch.Generator(device="cuda").manual_seed(3), out["features"], 0.5)
    b = augment_batch(torch.Generator(device="cuda").manual_seed(3), out["features"], 0.5)
    assert a.is_cuda and torch.equal(a, b)


@pytest.mark.cuda
def test_device_prefetch_stages_batches_on_a_copy_stream(card):
    """device_prefetch on the card: every batch arrives bit for bit, in
    order, with its dtype, including a short last batch that reuses a larger
    pinned buffer; the pinned buffers are reused (at most size + 1 sets);
    the consumer's stream sees each copy complete even while it runs long
    kernels of its own between batches."""
    from guitar_tablature_classification_tpu_torch.data import pipeline

    rng = np.random.default_rng(0)
    host = [{"audio": rng.standard_normal((512, 8820)).astype(np.float32),
             "labels": rng.integers(0, 19, (512, 6)).astype(np.int32)} for _ in range(6)]
    host.append({k: v[:100] for k, v in host[0].items()})
    pinned = []
    real = pipeline._staged

    def spy(buffers, key, src):
        out = real(buffers, key, src)
        pinned.append(buffers[key].data_ptr())
        return out

    pipeline._staged = spy
    try:
        busy = torch.randn(4096, 4096, device=card)
        got = []
        for batch in pipeline.as_device_batches(iter(host), prefetch=2, device=card):
            busy = busy @ busy / 64.0  # the consumer's stream stays busy
            got.append({k: v.clone() for k, v in batch.items()})
    finally:
        pipeline._staged = real
    torch.cuda.synchronize()
    assert len(got) == len(host)
    for g, h in zip(got, host):
        for key in h:
            assert g[key].is_cuda and g[key].dtype == torch.from_numpy(h[key]).dtype
            assert torch.equal(g[key].cpu(), torch.from_numpy(h[key])), key
    assert len(set(pinned)) <= 2 * 3  # two keys, at most size + 1 sets


# ----------------------------------------------------- MLA: 192/128, causal


def _mla(b, n, h, device, seed=0):
    """q, k [B, N, H, 192] and v [B, N, H, 128] bf16 as the latent attention
    lays them out (q and k contiguous, v a strided view of the key-value
    projection), and an output gradient."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(device, torch.bfloat16)

    kv = draw(b, n, h, 256)
    return draw(b, n, h, 192), draw(b, n, h, 192), kv[..., 128:], draw(b, n, h, 128)


MLA_SCALE = 192 ** -0.5 * (0.1 * 0.707 * np.log(40) + 1) ** 2  # DeepSeek-V2-Lite's


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 1, 2), (1, 65, 3), (2, 129, 2), (1, 200, 4),
                                   (32, 785, 16)])
def test_mla_kernels_match_plain(card, causal, shape):
    """attn_fwd_mla and attn_bwd_mla against the plain version (causal
    mask, explicit scale): the bf16 tolerances and relative limits of the
    64-wide kernels, each launch counted, and two backward runs giving
    identical gradients.  (32, 785, 16) is DeepSeek-V2-Lite's training
    shape at B=32."""
    b, n, h = shape
    q, k, v, g = _mla(b, n, h, card)
    before = dict(attention_cuda.launches)
    out, lse = attention_cuda.fwd_mla(q, k, v, MLA_SCALE, causal)
    grads = attention_cuda.bwd_mla(q, k, v, out, lse, g, MLA_SCALE, causal)
    again = attention_cuda.bwd_mla(q, k, v, out, lse, g, MLA_SCALE, causal)
    torch.cuda.synchronize()
    assert {k_: attention_cuda.launches[k_] - before[k_] for k_ in before} == {
        "attn_fwd": 0, "attn_bwd": 0, "attn_fwd_mla": 1, "attn_bwd_mla": 2}
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = attention.attention_reference(*leaves, scale=MLA_SCALE, causal=causal)
    want_grads = torch.autograd.grad(want, leaves, g)
    atol, rtol = ATTN_TOL[torch.bfloat16]["out"]
    torch.testing.assert_close(out.float(), want.detach().float(), atol=atol, rtol=rtol)
    _assert_rel_close(out, want.detach())
    atol, rtol = ATTN_TOL[torch.bfloat16]["grad"]
    for got, ref, rerun in zip(grads, want_grads, again):
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)
        _assert_rel_close(got, ref)
        assert torch.equal(got, rerun)


@pytest.mark.cuda
def test_mla_kernels_catch_a_dropped_mask(card):
    """The causal output differs from the unmasked one by far more than
    the limits above allow: a kernel that dropped the mask would fail."""
    q, k, v, _ = _mla(2, 129, 2, card, seed=3)
    causal, _ = attention_cuda.fwd_mla(q, k, v, MLA_SCALE, True)
    full, _ = attention_cuda.fwd_mla(q, k, v, MLA_SCALE, False)
    assert float((causal.float() - full.float()).norm()) > 10 * ATTN_REL_TOL["l2"] * float(
        full.float().norm())


# digests of the 64-wide kernels' bf16 out, lse, dq, dk and dv at vit_s8's
# training shape [64, 785, 6, 64] (seed 0): recorded on an H100 from the
# kernels as they were before the MLA widths joined csrc/attention.cu, and
# the same from the 64-wide instance of the template that serves both
VIT_ATTN_DIGESTS = ["23c125545ff51665", "24456593c2d041a9", "698062aac7444242",
                    "11b4d4f624313cc6", "129a0035dd728acf"]


@pytest.mark.cuda
def test_vit_attention_bits_unchanged(card):
    qkv, (q, k, v), g = _qkv(64, 785, 6, torch.bfloat16, card)
    out, lse = attention_cuda.fwd(q, k, v)
    grads = attention_cuda.bwd(q, k, v, out, lse, g)
    got = [hashlib.sha256(t.cpu().view(torch.int16).numpy().tobytes()).hexdigest()[:16]
           for t in (out, lse, *grads)]
    assert got == VIT_ATTN_DIGESTS, got


def _tiny_mla_config():
    """DeepSeek-V2's block at the MLA kernels' widths (192/128) and small
    everything else."""
    return dict(
        hidden_size=256, num_hidden_layers=3, num_attention_heads=2, q_lora_rank=None,
        kv_lora_rank=64, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        intermediate_size=384, moe_intermediate_size=64, n_routed_experts=8, n_shared_experts=2,
        num_experts_per_tok=3, first_k_dense_replace=1, moe_layer_freq=1, norm_topk_prob=False,
        routed_scaling_factor=1.0, scoring_func="softmax", topk_method="greedy", seq_aux=True,
        aux_loss_alpha=0.001, rms_norm_eps=1e-6, rope_theta=10000, hidden_act="silu",
        attention_bias=False,
        rope_scaling=dict(beta_fast=32, beta_slow=1, factor=40, mscale=0.707,
                          mscale_all_dim=0.707, original_max_position_embeddings=4096,
                          type="yarn"))


@pytest.mark.cuda
def test_routed_forward_replays_from_a_bucket_graph(card):
    """The Transcriber captures deepseek_v2's routed forward (router,
    permutation, grouped GEMMs, MLA kernels) into a bucket graph: a capture
    fails on any host sync, so it enqueues none; the replay's logits equal
    the eager forward's bit for bit, and the rows-per-expert counter
    moves under the replay."""
    from guitar_tablature_classification_tpu_torch.config import ModelConfig
    from guitar_tablature_classification_tpu_torch.ops import moe

    cfg = ModelConfig(arch="deepseek_v2", deepseek=_tiny_mla_config())
    t = Transcriber(model_cfg=cfg, batch_size=8, bucket_sizes=(1, 8), device=card)
    x = torch.rand(8, 224, 224, 3, device=card)
    with torch.no_grad():
        first = t.model(x)      # eager, captures
        replay = t.model(x)     # replays
        eager = t.model.forward.eager(x)
    torch.cuda.synchronize()
    assert torch.equal(replay, eager) and torch.equal(first, eager)
    layer = next(m for m in t.model.modules() if m in moe.LAYERS)
    assert int(layer.rows.sum()) == 8 * 785 * 3


# ------------------------------------------------------------ the Adam update

ADAM_LR = 1e-2
# element offsets of grads, params, mu, nu and the backbone mask in their
# own buffers: all 16-byte aligned (vectors from element 0), all 4 bytes past
# (a head of 3 singles, then vectors), and alignments that differ (singles)
ADAM_LAYOUTS = {"aligned": (0, 0, 0, 0, 0), "offset": (1, 1, 1, 1, 1),
                "mixed": (1, 2, 0, 3, 1)}
ADAM_DECAYS = {"adam": ("adam", 1e-2), "adamw": ("adamw", 1e-2), "no_decay": ("adamw", 0.0)}


def _adam_case(device, n, decay, clip, mask, offsets, seed=0):
    """An optimizer and its buffers as views at ``offsets`` into buffers of
    their own; moments seeded (nu >= 0), the global norm ~5 sqrt(n) with
    ``clip``, else ~1e-4."""
    name, wd = ADAM_DECAYS[decay]
    cfg = OptimConfig(name=name, weight_decay=wd, backbone_lr_scale=0.1 if mask else 1.0)
    tx = engine.make_optimizer(cfg, ["vit.w", "heads.b"], [n // 2, n - n // 2])
    g = torch.Generator(device=device).manual_seed(seed)
    views = []
    for off, kind in zip(offsets[:4], ("grads", "params", "mu", "nu")):
        view = torch.empty(n + 4, device=device)[off:off + n]
        view.copy_({"grads": (5.0 if clip else 1e-4 / n**0.5) * torch.randn(n, generator=g,
                                                                             device=device),
                    "params": torch.randn(n, generator=g, device=device),
                    "mu": 1e-2 * torch.randn(n, generator=g, device=device),
                    "nu": 1e-4 * torch.rand(n, generator=g, device=device)}[kind])
        views.append(view)
    grads, params, mu, nu = views
    state = engine.AdamState(torch.zeros((), dtype=torch.int32, device=device), mu, nu)
    if tx.backbone is not None:
        tx.backbone = torch.zeros(n + 4, dtype=torch.bool, device=device)[
            offsets[4]:offsets[4] + n].copy_(tx.backbone)
    return tx, grads, params, state


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(ADAM_LAYOUTS))
@pytest.mark.parametrize("ok", [None, True, False])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("decay", list(ADAM_DECAYS))
def test_adam_kernel_gives_the_plain_chains_bits(card, decay, clip, mask, ok, layout):
    """Two steps of ``Optimizer.apply`` (one kernel launch each, counted by
    ``launches`` and ``train.update_kernel``) against two of
    ``apply_plain`` from the same state: params, mu, nu and the count bit
    for bit, at a ragged n (4,099) in each layout; ``ok`` False leaves
    every buffer as it was."""
    n = 4099
    tx, grads, params, state = _adam_case(card, n, decay, clip, mask, ADAM_LAYOUTS[layout])
    walk = adam_cuda.plan(n, [t.data_ptr() for t in (grads, params, state.mu, state.nu)])
    head = {"aligned": 0, "offset": 3}.get(layout)
    assert walk == ((1, 0, n) if head is None else (4, head, (n - head) // 4))
    p2 = params.clone()
    state2 = engine.AdamState(state.count.clone(), state.mu.clone(), state.nu.clone())
    start = [t.clone() for t in (params, state.mu, state.nu, state.count)]
    flag = None if ok is None else torch.tensor(ok, device=card)
    for _ in range(2):
        before = adam_cuda.launches["adam_update"]
        with profiling.recording() as rec:
            norm = tx.apply(grads, state, params, ADAM_LR, ok=flag)
        assert adam_cuda.launches["adam_update"] == before + 1
        assert rec.drain()[1] == {"train.update_kernel": 1}
        tx.apply_plain(grads, state2, p2, ADAM_LR, ok=flag)
    torch.cuda.synchronize()
    assert (float(norm) > 1.0) == clip
    got, want = (params, state.mu, state.nu, state.count), (p2, state2.mu, state2.nu, state2.count)
    for label, a, b in zip(("params", "mu", "nu", "count"), got, want):
        assert torch.equal(a, b), (label, int((a != b).sum()))
    if ok is False:
        assert all(torch.equal(a, b) for a, b in zip(got, start))
    else:
        assert int(state.count) == 2 and not torch.equal(params, start[0])


@pytest.mark.cuda
def test_adam_kernel_indexes_past_2_31_elements(card):
    """One kernel step over n = 2^31 + 5 elements (64-bit indices, byte
    offsets past 2^33) against the plain chain on the elements at the
    start, around 2^31, at the end and at random places, with the same
    global norm."""
    n = (1 << 31) + 5
    tx = engine.make_optimizer(OptimConfig(name="adamw"), ["w"], [n])
    g = torch.Generator(device=card).manual_seed(3)
    grads = torch.empty(n, device=card).normal_(generator=g)
    params = torch.empty(n, device=card).normal_(generator=g)
    state = engine.AdamState(torch.zeros((), dtype=torch.int32, device=card),
                             torch.empty(n, device=card).normal_(0.0, 1e-2, generator=g),
                             torch.empty(n, device=card).uniform_(0.0, 1e-4, generator=g))
    k = 4096
    at = torch.cat([torch.arange(k), torch.arange((1 << 31) - k, (1 << 31) + 4),
                    torch.arange(n - k, n),
                    torch.randint(0, n, (4 * k,), generator=torch.Generator().manual_seed(4))])
    at = at.to(card)
    part = [t[at] for t in (grads, params, state.mu, state.nu)]
    g_norm = torch.linalg.vector_norm(grads)
    state_part = engine.AdamState(state.count.clone(), part[2], part[3])
    tx.apply(grads, state, params, ADAM_LR, g_norm=g_norm)
    tx.apply_plain(part[0], state_part, part[1], ADAM_LR, g_norm=g_norm)
    torch.cuda.synchronize()
    for label, full, want in (("params", params, part[1]), ("mu", state.mu, state_part.mu),
                              ("nu", state.nu, state_part.nu)):
        assert torch.equal(full[at], want), (label, int((full[at] != want).sum()))
    assert int(state.count) == 1
    del grads, params, state, part, state_part
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_train_step_launches_the_update_kernel_once_a_step(card):
    """Three train steps on the card: ``adam_update`` +3 and
    ``train.update_kernel`` 3, the update's one kernel a step."""
    from guitar_tablature_classification_tpu_torch.models import build_model

    model_cfg = ModelConfig(arch="small_cnn", dtype="float32")
    state = engine.create_train_state(build_model(model_cfg), OptimConfig(), device="cuda")
    step = engine.make_train_step(state.model, engine.make_preprocess(model_cfg))
    rng = np.random.default_rng(0)
    batch = {"features": torch.from_numpy(rng.uniform(-120, 0, (8, 96, 9)).astype(np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 19, (8, 6)))}
    batch = {key: value.to(card) for key, value in batch.items()}
    gen = torch.Generator(device=card).manual_seed(0)
    before = adam_cuda.launches["adam_update"]
    with profiling.recording() as rec:
        for _ in range(3):
            step(state, batch, gen, 1e-3)
    torch.cuda.synchronize()
    assert adam_cuda.launches["adam_update"] == before + 3
    assert rec.drain()[1].get("train.update_kernel") == 3
