"""The port's span and counter recorder (``utils/profiling.py``): off it
records nothing; on, spans nest with their parent and request on
``time.perf_counter``; the train step, ``device_prefetch`` and the
Transcriber record their phases; and the results are the same bits with
the recorder on and off.  This file imports no JAX: its card test runs
where JAX is missing:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""

import time

import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu_torch.config import CQTConfig, ModelConfig, OptimConfig
from guitar_tablature_classification_tpu_torch.infer import Transcriber
from guitar_tablature_classification_tpu_torch.models import build_model
from guitar_tablature_classification_tpu_torch.ops.framing import frame_track
from guitar_tablature_classification_tpu_torch.train import (
    create_train_state,
    make_preprocess,
    make_train_step,
)
from guitar_tablature_classification_tpu_torch.utils import profiling

TRAIN_PHASES = ("train.features", "train.forward", "train.backward", "train.update")


def test_off_records_nothing():
    assert profiling.span("x") is profiling.span("y")  # one shared null context
    with profiling.span("x", request=3):
        profiling.count("c", 5)
    with profiling.recording() as rec:
        pass
    assert rec.drain() == ([], {})


def test_spans_nest_with_parent_request_and_self_time():
    with profiling.recording() as rec:
        before = time.perf_counter()
        with profiling.span("outer", request=7):
            with profiling.span("a"):
                time.sleep(0.002)
                profiling.count("rows", 3)
            with profiling.span("b", request=9):
                with profiling.span("b.inner"):
                    profiling.count("rows", 2)
            time.sleep(0.002)
        after = time.perf_counter()
        with profiling.span("root"):
            pass
        spans, counters = rec.drain()
        assert rec.drain() == ([], {})  # drained
    assert counters == {"rows": 5}
    by = {s.name: s for s in spans}
    assert [s.name for s in spans] == ["a", "b.inner", "b", "outer", "root"]  # by close
    outer = by["outer"]
    assert outer.parent is None and by["root"].parent is None and by["root"].request is None
    assert by["a"].parent == outer.id and by["b"].parent == outer.id
    assert by["b.inner"].parent == by["b"].id
    assert (by["a"].request, by["b"].request, by["b.inner"].request) == (7, 9, 9)
    assert len({s.id for s in spans}) == len(spans)
    # on perf_counter: each span lies between the reads around it
    assert before <= outer.start <= by["a"].start <= by["a"].end <= by["b"].start
    assert by["b"].end <= outer.end <= after
    own = profiling.self_times(spans)
    dur = {s.name: s.end - s.start for s in spans}
    assert own[outer.id] == pytest.approx(dur["outer"] - dur["a"] - dur["b"], abs=1e-12)
    assert own[by["b"].id] == pytest.approx(dur["b"] - dur["b.inner"], abs=1e-12)
    assert own[by["a"].id] == dur["a"] and own[outer.id] >= 0.002


def test_a_recording_inside_another_takes_its_spans():
    with profiling.recording() as outer:
        with profiling.recording() as inner:
            with profiling.span("x"):
                pass
        with profiling.span("y"):
            pass
    assert [s.name for s in inner.drain()[0]] == ["x"]
    assert [s.name for s in outer.drain()[0]] == ["y"]


def _train_setup():
    cfg = ModelConfig(arch="small_cnn", dtype="float32")
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, OptimConfig(), "cpu")
    step = make_train_step(model, make_preprocess(cfg), smoothing=0.05)
    rng = np.random.default_rng(1)
    batches = [{"features": torch.from_numpy(rng.uniform(-120, 0, (4, 96, 9)).astype(np.float32)),
                "labels": torch.from_numpy(rng.integers(0, 19, (4, 6)).astype(np.int64))}
               for _ in range(3)]
    return state, step, batches


def _train(record: bool):
    state, step, batches = _train_setup()
    losses, spans = [], []
    for batch in batches:
        gen = torch.Generator().manual_seed(state.step)
        if record:
            with profiling.recording() as rec:
                losses.append(step(state, batch, gen, 1e-3)["loss"])
            spans.append(rec.drain()[0])
        else:
            losses.append(step(state, batch, gen, 1e-3)["loss"])
    return losses, state.params.clone(), spans


def test_train_step_records_its_phases_and_changes_no_bit():
    losses_off, params_off, _ = _train(record=False)
    losses_on, params_on, spans = _train(record=True)
    assert all(torch.equal(a, b) for a, b in zip(losses_off, losses_on))
    assert torch.equal(params_off, params_on)
    for k, step_spans in enumerate(spans):
        names = sorted(s.name for s in step_spans)
        assert names == sorted(("train.step",) + TRAIN_PHASES)  # once each a step
        root = next(s for s in step_spans if s.name == "train.step")
        assert root.parent is None and root.request == k
        for s in step_spans:
            if s.name != "train.step":
                assert s.parent == root.id and s.request == k
                assert root.start <= s.start <= s.end <= root.end
        phases = sorted((s for s in step_spans if s.parent == root.id), key=lambda s: s.start)
        assert tuple(s.name for s in phases) == TRAIN_PHASES


def _buckets(n: int, sizes: tuple[int, ...]) -> list[tuple[int, int]]:
    """(real rows, bucket) of each forward call: the largest bucket the
    remainder fills, else the smallest."""
    out = []
    while n > 0:
        b = next((b for b in reversed(sizes) if n >= b), sizes[0])
        out.append((min(n, b), b))
        n -= min(n, b)
    return out


def test_transcribe_records_a_bucket_per_forward_call_and_changes_no_bit():
    cqt = CQTConfig()
    t = Transcriber(None, model_cfg=ModelConfig(arch="small_cnn", dtype="float32"),
                    cqt_cfg=cqt, batch_size=16, bucket_sizes=(4, 8, 16), device="cpu")
    calls = []
    t.model.register_forward_pre_hook(lambda _m, args: calls.append(args[0].shape[0]))
    hop = cqt.window_samples // 2
    audio = np.random.default_rng(2).standard_normal(cqt.window_samples + 22 * hop)
    audio = audio.astype(np.float32)
    n = frame_track(audio, cqt, hop_samples=hop).shape[0]
    assert n == 23 and all(n % b for b in t.bucket_sizes)
    want = _buckets(n, t.bucket_sizes)
    off = t.transcribe(audio, hop_samples=hop, keep_logits=True)
    with profiling.recording() as rec:
        on = t.transcribe(audio, hop_samples=hop, keep_logits=True)
        again = t.transcribe(audio, hop_samples=hop)
    spans, counters = rec.drain()
    assert np.array_equal(off.frets, on.frets) and np.array_equal(off.logits, on.logits)
    assert np.array_equal(off.times, on.times) and np.array_equal(on.frets, again.frets)
    assert counters == {"serve.rows_real": 2 * sum(r for r, _ in want),
                        "serve.rows_forwarded": 2 * sum(b for _, b in want)}
    assert calls == [b for _, b in want] * 3
    tracks = [s for s in spans if s.name == "serve.transcribe"]
    assert [s.request for s in tracks] == [1, 2] and all(s.parent is None for s in tracks)
    for track in tracks:
        mine = [s for s in spans if s.request == track.request]
        kids = {s.name for s in mine if s.parent == track.id}
        assert kids == {"serve.frame", "serve.bucket", "serve.fetch", "serve.smooth"}
        buckets = [s for s in mine if s.name == "serve.bucket"]
        assert len(buckets) == len(want)  # one a forward call
        for name, per_bucket in (("serve.h2d", 1), ("serve.forward", 1)):
            inside = [s for s in mine if s.name == name]
            assert len(inside) == per_bucket * len(want)
            assert {s.parent for s in inside} == {b.id for b in buckets}
        pads = [s for s in mine if s.name == "serve.pad"]
        assert len(pads) == sum(r < b for r, b in want)
        assert {p.parent for p in pads} <= {b.id for b in buckets}


@pytest.mark.cuda
def test_device_prefetch_on_the_card_records_its_work_and_waits():
    """``data.prefetch`` a yield, and ``data.prefetch_wait`` where the oldest
    pinned set's copy has not finished: the loader holds the copy stream
    back with a long sleep kernel before each batch it hands over."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the prefetch's copy stream is on it")
    from guitar_tablature_classification_tpu_torch.data import pipeline

    streams = []
    make = torch.cuda.Stream

    def stream(*args, **kw):
        streams.append(make(*args, **kw))
        return streams[-1]

    rng = np.random.default_rng(0)
    host = [{"audio": rng.standard_normal((64, 8820)).astype(np.float32)} for _ in range(8)]

    def loader():
        for batch in host:
            if streams:
                with torch.cuda.stream(streams[0]):
                    torch.cuda._sleep(50_000_000)  # tens of ms on the copy stream
            yield batch

    torch.cuda.Stream = stream
    try:
        with profiling.recording() as rec:  # the host never waits for a batch itself
            got = [b["audio"] for b in pipeline.device_prefetch(loader(), size=2, device="cuda")]
    finally:
        torch.cuda.Stream = make
    torch.cuda.synchronize()
    spans, _ = rec.drain()
    assert len(got) == len(host)
    assert all(torch.equal(g.cpu(), torch.from_numpy(h["audio"])) for g, h in zip(got, host))
    work = [s for s in spans if s.name == "data.prefetch"]
    waits = [s for s in spans if s.name == "data.prefetch_wait"]
    assert len(work) == len(host) + 1  # the first fill, then one a yield
    assert waits and {w.parent for w in waits} <= {s.id for s in work}
