"""The port's tab image and activation plot (``infer/tab_image.py``) held to
the JAX package's on the same frets (the decoded pixels equal), the CLI's
``--image`` and ``--visualize``, and the ``infer`` package without PIL or
matplotlib."""

import os
import subprocess
import sys

import numpy as np
import pytest
from scipy.io import wavfile

from guitar_tablature_classification_tpu_torch.infer import (
    cli,
    create_tablature_image,
    plot_string_activations,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pixels(path):
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGBA"))


def _frets(seed, t):
    rng = np.random.default_rng(seed)
    frets = rng.integers(0, 19, (t, 6))
    frets[rng.uniform(size=frets.shape) < 0.5] = 0  # open strings draw nothing
    return frets, np.arange(t) * 0.1


@pytest.mark.parametrize("t, title", [(40, "demo"), (5, None), (70, "three rows")])
def test_tab_image_matches_jax(tmp_path, t, title):
    from guitar_tablature_classification_tpu.infer import create_tablature_image as jax_image

    frets, times = _frets(t, t)
    got = create_tablature_image(frets, times, str(tmp_path / "port.png"), title=title)
    want = jax_image(frets, times, str(tmp_path / "jax.png"), title=title)
    assert got == str(tmp_path / "port.png")
    a, b = _pixels(got), _pixels(want)
    rows = -(-t // 32)
    assert a.shape == (60 + (60 if title else 20) + rows * (40 * 7 + 30), 1600, 4)
    np.testing.assert_array_equal(a, b)


def test_activation_plot_matches_jax(tmp_path):
    from guitar_tablature_classification_tpu.infer import plot_string_activations as jax_plot

    frets, times = _frets(1, 30)
    got = plot_string_activations(frets, times, str(tmp_path / "port.png"))
    want = jax_plot(frets, times, str(tmp_path / "jax.png"))
    a = _pixels(got)
    assert a.shape == (1000, 1200, 4)
    np.testing.assert_array_equal(a, _pixels(want))


def test_cli_writes_the_image_and_the_plot(tmp_path):
    wav = tmp_path / "demo.wav"
    rng = np.random.default_rng(0)
    audio = 0.3 * np.sin(2 * np.pi * 196.0 * np.arange(int(1.2 * 44100)) / 44100)
    audio += 0.01 * rng.standard_normal(audio.shape)
    wavfile.write(str(wav), 44100, (audio * 32767).astype(np.int16))
    image, plot = tmp_path / "tab.png", tmp_path / "act.png"
    assert cli.main([str(wav), "--arch", "small_cnn", "--batch-size", "8", "--device", "cpu",
                     "--image", str(image), "--visualize", str(plot)]) == 0
    assert (tmp_path / "demo_tab.txt").exists()
    assert _pixels(image).shape == (60 + 60 + 310, 1600, 4)  # 11 windows: one row
    assert _pixels(plot).shape == (1000, 1200, 4)


def test_infer_imports_and_serves_without_pil_or_matplotlib():
    """With PIL and matplotlib hidden from the import system, the ``infer``
    package imports and serves one batch; only the renderers need them."""
    script = f"""
import sys
sys.path.insert(0, {ROOT!r})
for name in ("PIL", "matplotlib"):
    sys.modules[name] = None  # any import of it raises ImportError
import numpy as np
from guitar_tablature_classification_tpu_torch.config import CQTConfig, ModelConfig
from guitar_tablature_classification_tpu_torch.infer import StreamingTranscriber, Transcriber
from guitar_tablature_classification_tpu_torch.infer import create_tablature_image
cfg = CQTConfig()
t = Transcriber(None, model_cfg=ModelConfig(arch="small_cnn"), cqt_cfg=cfg, batch_size=4,
                device="cpu")
logits = t.predict_windows(np.zeros((4, cfg.window_samples), np.float32))
assert logits.shape == (4, 6, 19) and np.isfinite(logits).all()
try:
    create_tablature_image(np.zeros((2, 6), int), np.zeros(2), "x.png")
except ImportError:
    print("SERVED WITHOUT PIL")
"""
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVED WITHOUT PIL" in proc.stdout
