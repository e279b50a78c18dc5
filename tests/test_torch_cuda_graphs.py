"""The Transcriber's model forward replayed from CUDA graphs
(``utils/cuda_graphs.py``).

Without a card: no graph is captured and the engagement counters stay 0,
the engagement rule sends a model in train mode, grad on or a batch that is
no bucket to the eager forward, the launch counters' snapshot and add-back
are exact, and the model keeps its state dict, its hooks and its copies.
On the card (``cuda``-marked, for the flagship ResNet-18 and ViT-S/8 with
seeded weights): each bucket's graph gives the eager forward's logits bit
for bit, a track of several full buckets gives the eager logits (no
aliased outputs), a pre-hook fires once a bucket with its batch, the launch
counters read what as many eager forwards give, weights loaded in place
after the capture are replayed, and streaming gives the offline frets.
This file imports no JAX, so its card tests run where JAX is missing:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_graphs.py
"""

import copy
import dataclasses
import gc

import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu_torch.config import RECIPES, ModelConfig
from guitar_tablature_classification_tpu_torch.infer import StreamingTranscriber, Transcriber
from guitar_tablature_classification_tpu_torch.models import build_model
from guitar_tablature_classification_tpu_torch.ops import cqt_cuda, stem_cuda
from guitar_tablature_classification_tpu_torch.parallel import make_mesh
from guitar_tablature_classification_tpu_torch.utils import profiling
from guitar_tablature_classification_tpu_torch.utils.cuda_graphs import (
    GraphedForward,
    _read_part,
    add_launches,
    engages,
    launch_counts,
    launches_moved,
)

SMALL = ModelConfig(arch="small_cnn", dtype="float32")
GRAPH_COUNTERS = ("serve.graph_captures", "serve.graph_replays", "serve.eager_forwards")


def _audio(seconds: float, seed: int, sample_rate: int = 22050) -> np.ndarray:
    """A seeded track of tones in noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    f = 80.0 * (1000.0 / 80.0) ** rng.random()
    return (np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


# ------------------------------------------------------------ without a card


@pytest.mark.parametrize("arch", ["small_cnn", "resnet18_native"])
def test_cpu_captures_no_graph_and_counts_nothing(arch):
    t = Transcriber(None, model_cfg=ModelConfig(arch=arch, dtype="float32"), batch_size=8,
                    device="cpu", seed=1)
    assert isinstance(t.model.forward, GraphedForward)
    audio = _audio(1.0, seed=2, sample_rate=t.cqt_cfg.sample_rate)
    with profiling.recording() as rec:
        out = t.transcribe(audio, keep_logits=True)
    counters = rec.drain()[1]
    assert all(counters.get(name, 0) == 0 for name in GRAPH_COUNTERS), counters
    assert counters["serve.rows_real"] == out.logits.shape[0]
    assert t.model.forward.graphs == {}
    # the same logits as the module's own forward
    plain = Transcriber(None, model_cfg=ModelConfig(arch=arch, dtype="float32"), batch_size=8,
                        device="cpu", seed=1)
    del plain.model.forward  # the class's forward again
    assert np.array_equal(plain.transcribe(audio, keep_logits=True).logits, out.logits)


class _OnCard:
    """What the engagement rule reads of an input, as if it lay on a card."""

    is_cuda = True

    def __init__(self, batch: int):
        self.shape = (batch, 96, 9, 1)
        self.ndim = 4


@pytest.mark.parametrize("case", ["engages", "cpu", "train", "grad", "not_a_bucket"])
def test_engagement_rule(case):
    model = build_model(SMALL).eval()
    x = _OnCard(3 if case == "not_a_bucket" else 8)
    if case == "cpu":
        x = torch.zeros(8, 96, 9, 1)
    if case == "train":
        model.train()
    with torch.set_grad_enabled(case == "grad"):
        assert engages(model, x, {1, 8, 32, 128}) == (case == "engages")


@pytest.mark.parametrize("case", ["cpu", "train", "grad", "not_a_bucket", "argument"])
def test_what_the_rule_refuses_runs_the_eager_forward(case):
    model = build_model(SMALL, generator=torch.Generator().manual_seed(3))
    for m in model.modules():  # train mode without a dropout generator
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    model.train(case == "train")
    runner = GraphedForward(model, (1, 8), "serve")
    model.forward = runner
    x = torch.randn(5 if case == "not_a_bucket" else 8, 96, 9, 1,
                    generator=torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(5)
    with torch.set_grad_enabled(case == "grad"):
        kw = {"generator": gen} if case == "argument" else {}
        got = model(x, **kw)
        want = type(model).forward(model, x, **({"generator": gen.manual_seed(5)} if kw else {}))
    assert torch.equal(got, want)
    assert runner.graphs == {}


def test_launch_counter_snapshot_and_add_back_are_exact(monkeypatch):
    monkeypatch.setattr(cqt_cuda, "launches", 7)
    monkeypatch.setattr(cqt_cuda, "mma_launches", 2)
    monkeypatch.setattr(cqt_cuda, "mma_launches_by_tier", dict(cqt_cuda.mma_launches_by_tier))
    monkeypatch.setattr(stem_cuda, "launches", dict(stem_cuda.launches))
    mod, stem = cqt_cuda.__name__, stem_cuda.__name__
    before = launch_counts()
    assert before[(mod, "launches", None)] == 7
    assert (stem, "launches", "stem_fwd") in before
    assert (mod, "mma_launches_by_tier", "default") in before
    # one "forward": a fused CQT on the tensor cores, two stem forwards
    cqt_cuda.launches += 1
    cqt_cuda.mma_launches += 1
    cqt_cuda.mma_launches_by_tier["default"] += 1
    stem_cuda.launches["stem_fwd"] += 2
    moved = launches_moved(before, launch_counts())
    assert moved == {(mod, "launches", None): 1, (mod, "mma_launches", None): 1,
                     (mod, "mma_launches_by_tier", "default"): 1,
                     (stem, "launches", "stem_fwd"): 2}
    add_launches(moved, -1)  # what a capture does
    assert launch_counts() == before
    for _ in range(5):  # five replays
        add_launches(moved)
    after = launch_counts()
    assert launches_moved(before, after) == {k: 5 * n for k, n in moved.items()}
    assert cqt_cuda.launches == 12 and stem_cuda.launches["stem_fwd"] == before[
        (stem, "launches", "stem_fwd")] + 10


@pytest.mark.parametrize("layout", ["contiguous", "broadcast_channels", "channels_last"])
def test_the_graph_input_keeps_the_call_layout(layout):
    """The graph's static input reads memory laid out as the call's input
    (a broadcast dim stays broadcast), so the replay takes the kernels the
    eager forward takes on it."""
    base = torch.randn(4, 6, 5)
    x = {"contiguous": base[..., None],
         "broadcast_channels": base[..., None].expand(4, 6, 5, 3),  # tile_channels
         "channels_last": torch.randn(4, 3, 6, 5).permute(0, 2, 3, 1)}[layout]
    src = _read_part(x)
    static = torch.empty_like(src)
    static.copy_(src)
    assert static.expand(x.shape).stride() == x.stride()
    assert torch.equal(static.expand(x.shape), x)


def test_model_keeps_its_state_dict_hooks_and_copies():
    t = Transcriber(None, model_cfg=SMALL, batch_size=8, device="cpu", seed=6)
    assert set(t.model.state_dict()) == set(build_model(SMALL).state_dict())
    batches = []
    t.model.register_forward_pre_hook(lambda _m, args: batches.append(args[0].shape[0]))
    t.predict_windows(np.zeros((19, t.cqt_cfg.window_samples), np.float32))
    assert batches == [8, 8, 1, 1, 1]
    twin = copy.deepcopy(t.model)  # a copy serves itself, not the original
    assert twin.forward is not t.model.forward
    with torch.no_grad():
        for p in twin.parameters():
            p.add_(1.0)
    x = torch.randn(8, 96, 9, 1)
    with torch.inference_mode():
        assert torch.equal(twin(x), type(twin).forward(twin, x))
        assert not torch.equal(twin(x), t.model(x))


def test_a_mesh_transcriber_stays_eager():
    t = Transcriber(None, model_cfg=SMALL, batch_size=8, device="cpu", seed=0,
                    mesh=make_mesh(device="cpu"))
    assert "forward" not in vars(t.model)


# --------------------------------------------------------------- on the card

CONFIGS = ("resnet18_flagship", "vit_s8")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    yield torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()


def _model_cfg(name: str) -> ModelConfig:
    if name == "vit_s8":
        return RECIPES["vit-reference"]().model
    return ModelConfig(arch="resnet18", stem_fusion="fused")


def _off_identity(model: torch.nn.Module, seed: int) -> None:
    """Move every BatchNorm off the identity it starts at (bf16 rounds
    rsqrt(1 + 1e-5) to 1), so the comparisons read the trunk."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                c, dev = m.num_features, m.weight.device
                m.weight.mul_((0.5 + torch.rand(c, generator=gen)).to(dev))
                m.bias.add_((0.1 * torch.randn(c, generator=gen)).to(dev))
                m.running_mean.add_((0.1 * torch.randn(c, generator=gen)).to(dev))
                m.running_var.mul_((0.5 + torch.rand(c, generator=gen)).to(dev))


def _transcriber(name: str, seed: int = 11) -> Transcriber:
    t = Transcriber(None, model_cfg=_model_cfg(name), batch_size=128, seed=seed)
    _off_identity(t.model, seed)
    return t


def _images(t: Transcriber, batch: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((batch, t.cqt_cfg.window_samples), np.float32))
    with torch.inference_mode():
        return t.preprocess(t.frontend(x.to(t.device)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
def test_each_bucket_replays_the_eager_logits(card, name):
    t = _transcriber(name)
    assert t.bucket_sizes == (1, 8, 32, 128)
    with profiling.recording() as rec, torch.inference_mode():
        for b in t.bucket_sizes:
            images = _images(t, b, seed=b)
            want = t.model.forward.eager(images)
            captured = t.model(images)  # the eager forward on a side stream, then the capture
            replayed = t.model(images)
            again = t.model(_images(t, b, seed=b + 1))
            assert torch.equal(captured, want) and torch.equal(replayed, want), b
            assert torch.equal(again, t.model.forward.eager(_images(t, b, seed=b + 1))), b
    assert len(t.model.forward.graphs) == 4
    counters = rec.drain()[1]
    assert counters["serve.graph_captures"] == 4
    assert counters["serve.graph_replays"] == 8
    assert counters["serve.eager_forwards"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
def test_a_track_of_several_full_buckets_gives_the_eager_logits(card, name):
    t = _transcriber(name)
    # 299 windows: buckets of 128, 128, 32, 8, 1, 1, 1
    audio = _audio(30.0, seed=12, sample_rate=t.cqt_cfg.sample_rate)
    t.transcribe(audio)  # captures every bucket the track takes
    with profiling.recording() as rec:
        got = t.transcribe(audio, keep_logits=True)
    counters = rec.drain()[1]
    assert counters["serve.graph_replays"] >= 3 and counters.get("serve.eager_forwards", 0) == 0
    eager = _transcriber(name)  # the same weights, graphs off
    del eager.model.forward
    want = eager.transcribe(audio, keep_logits=True)
    assert np.array_equal(got.logits, want.logits)
    assert np.array_equal(got.frets, want.frets)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
def test_a_pre_hook_fires_once_a_bucket_with_its_batch(card, name):
    t = _transcriber(name)
    audio = _audio(14.0, seed=13, sample_rate=t.cqt_cfg.sample_rate)  # 139 windows
    t.transcribe(audio)
    batches = []
    t.model.register_forward_pre_hook(lambda _m, args: batches.append(args[0].shape[0]))
    with profiling.recording() as rec:
        t.transcribe(audio)
    assert batches == [128, 8, 1, 1, 1]
    assert rec.drain()[1]["serve.graph_replays"] == len(batches)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
def test_the_launch_counters_read_what_eager_forwards_give(card, name):
    t = _transcriber(name)
    n = 5
    with torch.inference_mode():
        images = _images(t, 32, seed=14)
        before = launch_counts()
        t.model.forward.eager(images)
        one = launches_moved(before, launch_counts())
        assert one, "the forward launches no counted kernel"
        before = launch_counts()
        for _ in range(n):  # a capture, then n - 1 replays
            t.model(images)
        torch.cuda.synchronize()
    assert launches_moved(before, launch_counts()) == {k: n * v for k, v in one.items()}
    key = ("guitar_tablature_classification_tpu_torch.ops.attention_cuda", "launches", "attn_fwd")
    if name == "vit_s8":
        assert one[key] == 12
    else:
        assert one[("guitar_tablature_classification_tpu_torch.ops.stem_cuda", "launches",
                    "stem_fwd")] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
def test_weights_loaded_in_place_after_the_capture_are_replayed(card, name):
    t = _transcriber(name, seed=15)
    other = _transcriber(name, seed=16)
    with torch.inference_mode():
        images = _images(t, 8, seed=17)
        first = t.model(images)  # captured with the first weights
        t.model(images)
        t.model.load_state_dict(other.model.state_dict())
        got = t.model(images)
        want = other.model.forward.eager(images)
    assert not torch.equal(first, want)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
def test_streaming_gives_the_offline_frets(card, name):
    t = _transcriber(name, seed=18)
    audio = _audio(6.0, seed=19, sample_rate=t.cqt_cfg.sample_rate)
    offline = t.transcribe(audio)
    stream = StreamingTranscriber(t)
    rng = np.random.default_rng(20)
    frets, pos = [], 0
    with profiling.recording() as rec:
        while pos < len(audio):
            n = int(rng.integers(1000, 20000))
            frets.append(stream.feed(audio[pos:pos + n]).frets)
            pos += n
        frets.append(stream.flush().frets)
    assert np.array_equal(np.concatenate(frets), offline.frets)
    assert rec.drain()[1]["serve.graph_replays"] > 0


@pytest.mark.cuda
def test_the_native_recipe_replays_too(card):
    """native-best with its fused stem and BatchNorm (chip_smoke's serving
    path): a bucket's graph gives the eager logits."""
    cfg = RECIPES["native-best"]()
    model_cfg = dataclasses.replace(cfg.model, stem_fusion="fused", bn_fusion="on")
    t = Transcriber(None, model_cfg=model_cfg, cqt_cfg=cfg.cqt, batch_size=64, seed=21)
    _off_identity(t.model, 21)
    with torch.inference_mode():
        images = _images(t, 64, seed=22)
        want = t.model.forward.eager(images)
        t.model(images)
        assert torch.equal(t.model(images), want)
