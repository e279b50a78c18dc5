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
from guitar_tablature_classification_tpu_torch.ops import cqt_cuda
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
