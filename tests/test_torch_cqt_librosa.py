"""The port's copy of the librosa-algorithm CQT oracle (``ops/cqt_librosa.py``)
bit-equal to the JAX package's, and the port's plain CQT held to it within
the JAX package's own limits (tests/test_cqt.py:53-110)."""

import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu_torch.config import CQTConfig
from guitar_tablature_classification_tpu_torch.ops import cqt_librosa
from guitar_tablature_classification_tpu_torch.ops.cqt import CQTFrontend
from guitar_tablature_classification_tpu_torch.ops.cqt_kernels import bin_frequencies


def _signals(cfg):
    rng = np.random.default_rng(0)
    n = cfg.window_samples
    freqs = bin_frequencies(cfg)
    t = np.arange(n) / cfg.sample_rate
    tones = sum(np.sin(2 * np.pi * freqs[k] * t + 0.3 * k) for k in range(4, cfg.n_bins, 12))
    f1 = min(4000.0, cfg.sample_rate / 2 * 0.8)
    chirp = np.sin(2 * np.pi * (80 * t + (f1 - 80) / (2 * t[-1]) * t**2))
    return {"tones": tones, "chirp": chirp, "noise": rng.standard_normal(n)}


@pytest.mark.parametrize("recipe", ["train", "serving"])
def test_oracle_copy_is_bit_equal_to_jax(recipe):
    from guitar_tablature_classification_tpu.config import CQTConfig as JaxCQTConfig
    from guitar_tablature_classification_tpu.ops import cqt_librosa as jax_librosa

    cfg = CQTConfig() if recipe == "train" else CQTConfig.serving_cnn()
    jcfg = JaxCQTConfig() if recipe == "train" else JaxCQTConfig.serving_cnn()
    freqs = bin_frequencies(cfg)
    assert np.array_equal(cqt_librosa.relative_bandwidth(freqs),
                          jax_librosa.relative_bandwidth(freqs))
    for name, sig in _signals(cfg).items():
        got = cqt_librosa.cqt_multirate_db(sig, cfg)
        want = jax_librosa.cqt_multirate_db(sig, jcfg)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    raw = cqt_librosa.cqt_multirate(_signals(cfg)["chirp"], cfg)
    assert np.array_equal(raw, jax_librosa.cqt_multirate(_signals(cfg)["chirp"], jcfg))


@pytest.mark.parametrize("recipe", ["train", "serving"])
def test_plain_cqt_against_the_librosa_algorithm(recipe):
    """The port's plain CQT (the CPU path of ``CQTFrontend``) against the
    multirate oracle: on cells open on both sides, mean |d| < 1 dB and max
    < 8 dB; under 2 % gate flips, each within 6 dB of the gate (the JAX
    package's limits for its direct-form CQT)."""
    cfg = CQTConfig() if recipe == "train" else CQTConfig.serving_cnn()
    frontend = CQTFrontend(cfg)
    for name, sig in _signals(cfg).items():
        ours = frontend(torch.from_numpy(sig[None].astype(np.float32)))[0].numpy()
        lib = cqt_librosa.cqt_multirate_db(sig, cfg)
        assert ours.shape == lib.shape
        both_open = (ours > -119) & (lib > -119)
        d = np.abs(ours - lib)[both_open]
        assert d.mean() < 1.0 and d.max() < 8.0, (name, d.mean(), d.max())
        flips = (ours <= -119) != (lib <= -119)
        assert flips.mean() < 0.02, (name, flips.mean())
        if flips.any():
            open_side = np.where(ours <= -119, lib, ours)[flips]
            assert np.abs(open_side - cfg.gate_threshold_db).max() < 6.0, name
