"""The port's serving path (Transcriber, mode filter, framing, CLI) held to
the JAX package's on the same NumPy weights and audio."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from guitar_tablature_classification_tpu.config import CQTConfig as JaxCQTConfig
from guitar_tablature_classification_tpu.config import ModelConfig as JaxModelConfig
from guitar_tablature_classification_tpu.config import RECIPES as JAX_RECIPES
from guitar_tablature_classification_tpu.data import render_performance
from guitar_tablature_classification_tpu.infer import Transcriber as JaxTranscriber
from guitar_tablature_classification_tpu.ops import CQTFrontend as JaxCQTFrontend
from guitar_tablature_classification_tpu.ops import frame_track as jax_frame_track
from guitar_tablature_classification_tpu.ops import mode_filter as jax_mode_filter
from guitar_tablature_classification_tpu.ops import window_times as jax_window_times
from guitar_tablature_classification_tpu.train import make_preprocess as jax_make_preprocess
from guitar_tablature_classification_tpu_torch.config import RECIPES, CQTConfig, ModelConfig
from guitar_tablature_classification_tpu_torch.infer import Transcriber, cli
from guitar_tablature_classification_tpu_torch.models import state_dict_from_flax
from guitar_tablature_classification_tpu_torch.ops import (
    frame_track,
    mode_filter,
    mode_filter_np,
    num_windows,
    window_times,
)
from test_torch_models import perturbed_variables

NOTES = [(0, 3, 0.1, 0.8), (2, 5, 0.5, 0.6), (4, 7, 0.9, 0.5), (5, 0, 1.2, 0.3)]


def _audio(seconds, cfg=None):
    """Synthetic guitar track (the JAX package's renderer): the notes of
    NOTES that end within ``seconds``."""
    notes = [n for n in NOTES if n[2] + n[3] <= seconds]
    return render_performance(notes, seconds, cfg or JaxCQTConfig())


def _assert_same_frets(got_logits, want_logits, tol):
    """Argmax frets agree wherever the JAX top-2 logit margin exceeds the
    logit tolerance (closer calls may flip on rounding alone)."""
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > tol
    assert decided.mean() > 0.8
    got, want = got_logits.argmax(-1), want_logits.argmax(-1)
    assert np.array_equal(got[decided], want[decided])


def test_transcriber_matches_jax_fp32_highest():
    """fp32 model, highest-precision CQT: XLA and PyTorch differ in fp32
    summation order only (logits to 1e-4 of their scale)."""
    jmodel, variables = perturbed_variables("resnet18_native", "float32")
    audio = _audio(1.5)
    want = JaxTranscriber(
        variables, model_cfg=JaxModelConfig(arch="resnet18_native", dtype="float32"),
        cqt_cfg=JaxCQTConfig(), batch_size=8,
    ).transcribe(audio, smooth_window=0, keep_logits=True)
    port = Transcriber(
        state_dict_from_flax(variables),
        model_cfg=ModelConfig(arch="resnet18_native", dtype="float32"),
        cqt_cfg=CQTConfig(), batch_size=8, device="cpu",
    )
    got = port.transcribe(audio, smooth_window=0, keep_logits=True)
    np.testing.assert_array_equal(got.times, want.times)
    tol = 1e-4 * np.abs(want.logits).max()
    np.testing.assert_allclose(got.logits, want.logits, rtol=0, atol=tol)
    _assert_same_frets(got.logits, want.logits, tol)
    smoothed = port.transcribe(audio)
    assert smoothed.frets.shape == want.frets.shape
    assert np.array_equal(
        smoothed.frets, np.asarray(jax_mode_filter(jnp.asarray(got.frets)))
    )


def test_transcriber_matches_jax_native_best():
    """native-best (default-tier CQT, bf16 model) against the JAX pipeline
    built on the interpret-mode Pallas kernel: the only JAX path that shows
    the bf16 CQT operands on the CPU.  bf16 model tolerance as in
    test_torch_models.test_logits_match_flax_bf16."""
    jcfg = JAX_RECIPES["native-best"]()
    jmodel, variables = perturbed_variables("resnet18_native", "bfloat16")
    audio = _audio(1.0, jcfg.cqt)
    windows = np.ascontiguousarray(jax_frame_track(audio, jcfg.cqt))
    frontend = JaxCQTFrontend(jcfg.cqt, use_pallas=True, pallas_interpret=True)
    images = jax_make_preprocess(jcfg.model)(frontend(windows))
    want = np.asarray(jmodel.apply(variables, images, train=False))

    cfg = RECIPES["native-best"]()
    port = Transcriber(
        state_dict_from_flax(variables), model_cfg=cfg.model, cqt_cfg=cfg.cqt,
        batch_size=cfg.data.batch_size, device="cpu",
    )
    assert port.bucket_sizes == (1, 8, 32, 2048)
    got = port.predict_windows(windows)
    tol = 5e-2 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    _assert_same_frets(got, want, tol)


def test_bucketed_batches_do_not_change_results():
    cfg = CQTConfig()
    a = Transcriber(None, model_cfg=ModelConfig(arch="resnet18_native", dtype="float32"),
                    cqt_cfg=cfg, batch_size=16, bucket_sizes=(4, 8, 16), device="cpu")
    assert a.bucket_sizes == (4, 8, 16)
    assert [a._bucket_for(n) for n in (21, 5, 3, 1)] == [16, 4, 4, 4]
    b = Transcriber(None, model_cfg=ModelConfig(arch="resnet18_native", dtype="float32"),
                    cqt_cfg=cfg, batch_size=8, device="cpu")
    windows = np.random.default_rng(0).standard_normal((21, cfg.window_samples))
    got = a.predict_windows(windows.astype(np.float32))
    assert got.shape == (21, 6, 19)
    np.testing.assert_allclose(got, b.predict_windows(windows), atol=1e-5)
    np.testing.assert_allclose(a.predict_windows(windows[:1]), got[:1], atol=1e-5)


@pytest.mark.parametrize("case", ["random", "ties", "short", "window5"])
def test_mode_filter_matches_jax(case):
    rng = np.random.default_rng(0)
    window = 5 if case == "window5" else 3
    if case == "ties":  # every neighbourhood a 1-1-1 tie -> smallest fret
        preds = np.tile(np.array([[7], [2], [11], [4], [9]]), (3, 6)).astype(np.int32)
    elif case == "short":
        preds = rng.integers(0, 19, (3, 6)).astype(np.int32)
    else:
        preds = rng.integers(0, 4, (40, 6)).astype(np.int32)
    want = np.asarray(jax_mode_filter(jnp.asarray(preds), window=window))
    assert np.array_equal(mode_filter(torch.from_numpy(preds), window=window).numpy(), want)
    assert np.array_equal(mode_filter_np(preds, window=window), want)
    if case == "ties":
        assert want[1, 0] == 2  # (7, 2, 11) -> smallest


def test_framing_matches_jax():
    cfg = CQTConfig()
    audio = np.random.default_rng(0).standard_normal(3 * cfg.sample_rate + 123)
    audio = audio.astype(np.float32)
    want = np.asarray(jax_frame_track(audio, JaxCQTConfig()))
    assert np.array_equal(frame_track(audio, cfg), want)
    assert num_windows(len(audio), cfg.window_samples, cfg.hop_samples) == len(want)
    assert np.array_equal(window_times(len(audio), cfg),
                          jax_window_times(len(audio), JaxCQTConfig()))


def _write_wav(path, seconds=1.2):
    audio = _audio(seconds)
    wavfile.write(str(path), 44100, (np.clip(audio, -1, 1) * 32767).astype(np.int16))


def _strip_timestamp(text):
    return "\n".join(ln for ln in text.splitlines() if not ln.startswith("Generated:"))


def test_cli_matches_jax_cli(tmp_path):
    """Same .pt checkpoint, same WAV: the same tab text (the heads' output
    biases are spread so every fret decision has a wide margin)."""
    from guitar_tablature_classification_tpu.infer import cli as jax_cli
    from guitar_tablature_classification_tpu.models.torch_export import (
        save_torch_checkpoint,
    )

    _, variables = perturbed_variables("resnet18_native", "bfloat16", seed=4)
    out_bias = variables["params"]["heads"]["out"]["bias"]
    variables["params"]["heads"]["out"]["bias"] = (
        np.random.default_rng(5).normal(0, 3, out_bias.shape).astype(np.float32)
    )
    ckpt = tmp_path / "best_guitar_tab_model.pt"
    save_torch_checkpoint(str(ckpt), variables, arch="resnet18_native")
    wav = tmp_path / "demo.wav"
    _write_wav(wav)
    args = [str(wav), "--model", str(ckpt), "--arch", "resnet18_native",
            "--batch-size", "8"]
    assert jax_cli.main(args + ["--output", str(tmp_path / "jax.txt")]) == 0
    assert cli.main(args + ["--output", str(tmp_path / "port.txt"),
                            "--device", "cpu"]) == 0
    want = _strip_timestamp((tmp_path / "jax.txt").read_text())
    got = _strip_timestamp((tmp_path / "port.txt").read_text())
    assert "e|" in got and got == want


@pytest.mark.parametrize("flag", ["--image", "--visualize"])
def test_cli_unported_outputs_raise(tmp_path, flag, monkeypatch):
    """Where the flag's package does not import, the CLI exits before it
    transcribes, naming the package, and writes nothing."""
    import sys

    package = {"--image": "PIL", "--visualize": "matplotlib"}[flag]
    monkeypatch.setitem(sys.modules, package, None)  # import raises ImportError
    wav = tmp_path / "demo.wav"
    _write_wav(wav, 0.5)
    with pytest.raises(SystemExit, match=f"{flag} needs {package}"):
        cli.main([str(wav), flag, str(tmp_path / "x.png"), "--device", "cpu"])
    assert not (tmp_path / "x.png").exists() and not (tmp_path / "demo_tab.txt").exists()


def test_cli_orbax_directory_raises(tmp_path):
    wav = tmp_path / "demo.wav"
    _write_wav(wav, 0.5)
    with pytest.raises(SystemExit, match="save_torch_checkpoint"):
        cli.main([str(wav), "--model", str(tmp_path / "ckpt_dir"),
                  "--device", "cpu"])


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """No device and no card: the constructor and the CLI raise instead of
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transcriber(None, model_cfg=ModelConfig(arch="resnet18_native"))
    wav = tmp_path / "demo.wav"
    _write_wav(wav, 0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(wav), "--arch", "resnet18_native"])
    assert cli.build_parser().parse_args([str(wav)]).device == "cuda"


def test_recipe_serving_config():
    """--recipe native-best serves resnet18_native on the default-tier CQT."""
    args = cli.build_parser().parse_args(
        ["x.wav", "--recipe", "native-best", "--device", "cpu", "--batch-size", "4"]
    )
    t = cli.load_transcriber(args)
    assert t.model_cfg.arch == "resnet18_native"
    assert t.cqt_cfg.precision == "default"
    assert t.cqt_cfg == dataclasses.replace(
        RECIPES["native-best"]().cqt, window_seconds=0.2, hop_seconds=0.1
    )
