"""The port's streaming transcription (``infer/streaming.py``) and the
reference's sequential mode filter (``ops/smoothing.py``), held to the
offline path and to the JAX package on the same inputs from a seed.

Frets are compared exactly and window times to 1e-9 s (JAX
tests/test_infer.py:233-275).  Against the JAX ``StreamingTranscriber``
the weights are the JAX model's, converted; the track is one on which the
two offline paths agree.
"""

import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu_torch.config import CQTConfig, ModelConfig
from guitar_tablature_classification_tpu_torch.data.synthetic import render_performance
from guitar_tablature_classification_tpu_torch.infer import StreamingTranscriber, Transcriber
from guitar_tablature_classification_tpu_torch.ops.smoothing import (
    mode_filter,
    mode_filter_np,
    mode_filter_sequential,
)

SMALL = ModelConfig(arch="small_cnn", dtype="float32")
NOTES = [(0, 3, 0.1, 0.8), (4, 7, 0.6, 0.9), (2, 5, 1.1, 0.5)]


@pytest.fixture(scope="module")
def jax_small():
    """The JAX small_cnn's variables and its Transcriber (batch 8)."""
    import jax

    from guitar_tablature_classification_tpu.config import ModelConfig as JaxModelConfig
    from guitar_tablature_classification_tpu.infer import Transcriber as JaxTranscriber
    from guitar_tablature_classification_tpu.models import build_model as jax_build
    from guitar_tablature_classification_tpu.train import make_preprocess as jax_pre

    cfg = JaxModelConfig(arch="small_cnn", dtype="float32")
    cqt = CQTConfig()
    sample = jax_pre(cfg)(np.zeros((1, cqt.n_bins, cqt.n_frames), np.float32))
    init = jax.jit(lambda x: jax_build(cfg).init(jax.random.PRNGKey(0), x, train=False))
    variables = init(sample)  # jitted: far faster on the CPU
    return variables, JaxTranscriber(variables, model_cfg=cfg, cqt_cfg=cqt, batch_size=8)


@pytest.fixture(scope="module")
def transcriber(jax_small):
    from guitar_tablature_classification_tpu_torch.models import state_dict_from_flax

    import jax

    sd = state_dict_from_flax(jax.tree.map(np.asarray, jax_small[0]))
    return Transcriber(sd, model_cfg=SMALL, cqt_cfg=CQTConfig(), batch_size=8, device="cpu")


def _stream(transcriber_or_stream, audio, seed=0, sizes=(1000, 20000)):
    """Feed ``audio`` in seeded chunks, then flush: (frets, times)."""
    stream = transcriber_or_stream
    rng = np.random.default_rng(seed)
    frets, times, pos = [], [], 0
    while pos < len(audio):
        chunk = int(rng.integers(*sizes))
        out = stream.feed(audio[pos:pos + chunk])
        frets.append(out.frets)
        times.append(out.times)
        pos += chunk
    out = stream.flush()
    return np.concatenate(frets + [out.frets]), np.concatenate(times + [out.times])


# ------------------------------------------------------------ mode filters


@pytest.mark.parametrize("seed, window", [(0, 3), (1, 3), (2, 5), (3, 7)])
def test_mode_filter_sequential_matches_jax(seed, window):
    from guitar_tablature_classification_tpu.ops.smoothing import (
        mode_filter_sequential as jax_sequential,
    )

    preds = np.random.default_rng(seed).integers(0, 19, (40, 6))
    got = mode_filter_sequential(preds, window=window)
    np.testing.assert_array_equal(got, jax_sequential(preds, window=window))
    assert got is not preds and np.array_equal(preds, np.random.default_rng(seed).integers(
        0, 19, (40, 6)))  # the input is left as it was
    short = preds[:window]  # the reference returns raw at T <= window (:707)
    np.testing.assert_array_equal(mode_filter_sequential(short, window=window), short)


def test_mode_filter_matches_sequential_on_stable_data():
    """JAX tests/test_ops.py:136 on the port's mode filters."""
    rng = np.random.default_rng(3)
    base = np.repeat(rng.integers(0, 19, (8, 6)), 5, axis=0)
    base[7, 2] = 18  # glitch
    want = mode_filter_sequential(base, window=3)
    np.testing.assert_array_equal(mode_filter(torch.from_numpy(base), window=3).numpy(), want)
    np.testing.assert_array_equal(mode_filter_np(base, window=3), want)
    assert want[7, 2] != 18  # glitch removed


# ------------------------------------------------------------ streaming


@pytest.mark.parametrize("smooth", [3, 5, 0, 1])
def test_streaming_matches_offline(transcriber, smooth):
    """Chunked feeds (1,000-20,000 samples) give exactly the offline
    transcription, smoothed or not (JAX tests/test_infer.py:233)."""
    cfg = transcriber.cqt_cfg
    audio = render_performance(NOTES, 2.0, cfg)
    offline = transcriber.transcribe(audio, smooth_window=smooth)
    frets, times = _stream(StreamingTranscriber(transcriber, smooth_window=smooth), audio)
    np.testing.assert_array_equal(frets, offline.frets)
    np.testing.assert_allclose(times, offline.times, atol=1e-9)


def test_streaming_tiny_track_passthrough(transcriber):
    """A track no longer than the smoothing window returns raw predictions,
    held back until the flush (JAX tests/test_infer.py:263)."""
    cfg = transcriber.cqt_cfg
    for seconds in (0.5, 0.4):  # 4 windows, and 3: the passthrough regime
        audio = render_performance([(0, 2, 0.05, 0.3)], seconds, cfg)
        offline = transcriber.transcribe(audio, smooth_window=3)
        stream = StreamingTranscriber(transcriber, smooth_window=3)
        first = stream.feed(audio)
        last = stream.flush()
        np.testing.assert_array_equal(np.concatenate([first.frets, last.frets]), offline.frets)
    assert len(offline.frets) == 3 and first.frets.shape == (0, 6)  # held until the flush
    empty = StreamingTranscriber(transcriber).feed(audio[:100])  # no window yet
    assert empty.frets.shape == (0, 6) and empty.times.shape == (0,)


def test_streaming_matches_jax_streaming(transcriber, jax_small):
    """The same converted weights through the JAX StreamingTranscriber and
    the port's, on a track where the two offline paths agree: the same
    frets and times, chunk by chunk in total."""
    from guitar_tablature_classification_tpu.infer import (
        StreamingTranscriber as JaxStreamingTranscriber,
    )

    jt = jax_small[1]
    audio = render_performance(NOTES, 2.0, transcriber.cqt_cfg)
    np.testing.assert_array_equal(transcriber.transcribe(audio).frets,
                                  jt.transcribe(audio).frets)
    sizes = (4000, 20000)  # fewer feeds: each new bucket shape compiles once on the JAX side
    got = _stream(StreamingTranscriber(transcriber), audio, seed=1, sizes=sizes)
    want = _stream(JaxStreamingTranscriber(jt), audio, seed=1, sizes=sizes)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-9)


def test_port_trained_checkpoint_serves_through_jax(tmp_path):
    """A resnet18_native checkpoint trained by the port (two steps), saved
    in the reference .pt layout and served through the JAX package's
    transcriber_from_torch_checkpoint, gives the port's frets and, within
    the fp32 models' tolerance, its logits."""
    from guitar_tablature_classification_tpu.config import ModelConfig as JaxModelConfig
    from guitar_tablature_classification_tpu.infer import (
        transcriber_from_torch_checkpoint as jax_from_pt,
    )
    from guitar_tablature_classification_tpu_torch.config import OptimConfig
    from guitar_tablature_classification_tpu_torch.models import build_model
    from guitar_tablature_classification_tpu_torch.train import (
        create_train_state,
        make_preprocess,
        make_train_step,
    )

    cfg = ModelConfig(arch="resnet18_native", dtype="float32")
    model = build_model(cfg)
    state = create_train_state(model, OptimConfig(), device="cpu")
    step = make_train_step(model, make_preprocess(cfg))
    rng = np.random.default_rng(4)
    for i in range(2):
        batch = {"features": torch.from_numpy(rng.uniform(-120, 0, (8, 96, 9)).astype(np.float32)),
                 "labels": torch.from_numpy(rng.integers(0, 19, (8, 6)))}
        step(state, batch, torch.Generator().manual_seed(i), 1e-3)
    path = str(tmp_path / "best_guitar_tab_model.pt")
    torch.save(model.state_dict(), path)

    cqt = CQTConfig()
    audio = render_performance(NOTES, 1.7, cqt)  # 16 windows: two full buckets of 8
    port = Transcriber(model.state_dict(), model_cfg=cfg, cqt_cfg=cqt, batch_size=8,
                       device="cpu").transcribe(audio, keep_logits=True)
    jax_t = jax_from_pt(path, arch="resnet18_native",
                        model_cfg=JaxModelConfig(arch="resnet18_native", dtype="float32"),
                        cqt_cfg=cqt, batch_size=8)
    want = jax_t.transcribe(audio, keep_logits=True)
    assert port.frets.shape == (16, 6)
    np.testing.assert_array_equal(port.frets, want.frets)
    np.testing.assert_allclose(port.logits, want.logits, atol=1e-4, rtol=1e-3)
