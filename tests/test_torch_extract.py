"""The port's batch CQT extraction (``ops/extract.py``, ``tab-extract-cqt``)
held to the JAX package's on the same WAV files, on the CPU: the same file
names under both naming schemes and the ``max_segments`` budget, and
features within the tolerance tests/test_torch_cqt.py holds the frontend
to (0.02 dB off the gate's 0.5 dB boundary)."""

import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from guitar_tablature_classification_tpu.ops.extract import process_all_audio as jax_process
from guitar_tablature_classification_tpu_torch.config import CQTConfig
from guitar_tablature_classification_tpu_torch.ops import extract
from guitar_tablature_classification_tpu_torch.ops.cqt import CQTFrontend


@pytest.fixture(scope="module")
def audio_dir(tmp_path_factory):
    """Two tones-plus-noise tracks of 0.9 s and 0.5 s, int16 at 44.1 kHz."""
    d = tmp_path_factory.mktemp("audio")
    rng = np.random.default_rng(0)
    for name, seconds in (("b_track", 0.9), ("a_track", 0.5)):
        t = np.arange(int(44100 * seconds)) / 44100
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(80, 900) * t) + 0.01 * rng.standard_normal(t.size)
        wavfile.write(str(d / f"{name}.wav"), 44100, (x * 32767).astype(np.int16))
    (d / "notes.txt").write_text("not audio")
    return d


def _assert_features_close(got, want):
    boundary = np.abs(want - CQTConfig().gate_threshold_db) < 0.5
    np.testing.assert_allclose(got[~boundary], want[~boundary], atol=0.02)


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(fixture_naming=True),
    dict(fixture_naming=True, max_segments=5, batch_size=2),
], ids=["plain_naming", "fixture_naming", "budget"])
def test_process_all_audio_matches_jax(audio_dir, tmp_path, kwargs):
    got = extract.process_all_audio(str(audio_dir), 0.2, 0.1, str(tmp_path / "port"),
                                    device="cpu", **kwargs)
    want = jax_process(str(audio_dir), 0.2, 0.1, str(tmp_path / "jax"), **kwargs)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == (4 if "max_segments" in kwargs else 8 + 4)
    for g, w in zip(got, want):
        a, b = np.load(g), np.load(w)
        assert a.shape == b.shape == (96, 9) and a.dtype == np.float32
        _assert_features_close(a, b)


def test_extract_windows_chunks_without_padding():
    """Chunks of 3 over 7 windows (a short last chunk) give what one call
    over all of them gives, bit for bit."""
    cfg = CQTConfig()
    rng = np.random.default_rng(1)
    windows = (0.1 * rng.standard_normal((7, cfg.window_samples))).astype(np.float32)
    frontend = CQTFrontend(cfg)
    got = extract.extract_windows(frontend, windows, batch_size=3, device="cpu")
    want = frontend(torch.from_numpy(windows)).numpy()
    assert got.shape == (7, 96, 9) and np.array_equal(got, want)


def test_cli_writes_fixture_named_files(audio_dir, tmp_path, capsys):
    out = tmp_path / "feats"
    assert extract.main([str(audio_dir), str(out), "--hop-size", "0.2", "--fixture-naming",
                         "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == f"wrote 6 feature files to {out}"
    assert sorted(os.listdir(out))[:2] == ["a_track_segment_0_0.00.npy",
                                           "a_track_segment_0_0.20.npy"]
