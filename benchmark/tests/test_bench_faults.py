"""A run with the timed path broken underneath comes out not correct,
for each fault the cells can have: a train step that returns its state
unchanged, half of the batch left out with the mean over the rest, and a
served fret altered where it is produced (one card: no exchange between
chips to leave out); and a backward that returns nothing, the stem tail's
(``faults/stem_bwd_zero.py``; B5's runs only on the card).  The runs skip the chip check of ``run.py`` and go
through the rest of the harness on the CPU, at the cells' limits, on tiny
cells at float32 (where a sound run reads far under them); and B1's
``default`` tier writing each bin one bin up (``faults/cqt_default_bin_shift.py``),
in tiny cells of the ``native-best`` configuration."""

from __future__ import annotations

import pytest

from .bench_helpers import TINY_SERVE, TINY_TRAIN, add_cell, copy_benchmark, run_cell

UNCHANGED = """
import torch
from guitar_tablature_classification_tpu_torch.train import engine
made = engine.make_train_step
def make_train_step(*a, **k):
    step = made(*a, **k)
    def broken(state, batch, gen, lr):
        kept = [t.clone() for t in (state.params, state.opt_state.count, state.opt_state.mu,
                                    state.opt_state.nu)]
        out = step(state, batch, gen, lr)
        for t, k in zip((state.params, state.opt_state.count, state.opt_state.mu,
                         state.opt_state.nu), kept):
            t.copy_(k)
        return out
    return broken
engine.make_train_step = make_train_step
"""

HALF_BATCH = """
from guitar_tablature_classification_tpu_torch.train import engine
made = engine.make_train_step
def make_train_step(*a, **k):
    step = made(*a, **k)
    def broken(state, batch, gen, lr):
        half = batch["labels"].shape[0] // 2
        return step(state, {key: v[:half] for key, v in batch.items()}, gen, lr)
    return broken
engine.make_train_step = make_train_step
"""

STEM_BWD_ZERO = """
from benchmark.faults.stem_bwd_zero import plant
plant()
"""

CQT_BIN_SHIFT = """
from benchmark.faults.cqt_default_bin_shift import plant
plant()
"""

ALTERED = """
from guitar_tablature_classification_tpu_torch.infer import transcribe
made = transcribe.Transcriber.transcribe
def broken(self, audio, **k):
    out = made(self, audio, **k)
    out.frets[len(out.frets) // 2, 3] = (out.frets[len(out.frets) // 2, 3] + 1) % 19
    return out
transcribe.Transcriber.transcribe = broken
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = copy_benchmark(str(tmp_path_factory.mktemp("bench")))
    add_cell(root, "tiny_flagship_train", "resnet18_flagship", TINY_TRAIN, "flagship_train",
             model={"dtype": "float32"}, e2e=("train_segments_per_s",))
    add_cell(root, "tiny_flagship_serve", "resnet18_flagship", TINY_SERVE, "flagship_serve",
             model={"dtype": "float32"}, e2e=("serve_windows_per_s",))
    add_cell(root, "tiny_native_train", "resnet18_native", TINY_TRAIN, "native_train",
             model={"dtype": "float32"}, e2e=("train_segments_per_s",))
    # longer tracks than the flagship's: the native model's argmax turns on
    # a few hundred windows, not on a few dozen
    add_cell(root, "tiny_native_serve", "resnet18_native",
             dict(TINY_SERVE, track_seconds=[20.0, 10.0]), "native_serve",
             model={"dtype": "float32"}, e2e=("serve_windows_per_s",))
    return root


@pytest.mark.parametrize("cell", ["tiny_flagship_train", "tiny_flagship_serve",
                                  "tiny_native_train", "tiny_native_serve"])
def test_a_sound_run_is_correct(root, cell):
    out = run_cell(root, cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell,fault,number", [
    ("tiny_flagship_train", UNCHANGED, "change_gap"),
    ("tiny_flagship_train", HALF_BATCH, "logit_direction_error"),
    ("tiny_flagship_train", STEM_BWD_ZERO, "direction_error"),
    ("tiny_flagship_serve", ALTERED, "frets_mismatch"),
    ("tiny_native_train", CQT_BIN_SHIFT, "logit_direction_error"),
    ("tiny_native_serve", CQT_BIN_SHIFT, "logit_error"),
], ids=["state_unchanged", "half_batch", "stem_bwd_zero", "fret_altered",
        "native_train_cqt_bin_shift", "native_serve_cqt_bin_shift"])
def test_a_broken_run_is_not_correct(root, cell, fault, number):
    out = run_cell(root, cell, patch=fault)
    assert not out["correct"]
    check = out["checks"][number]
    assert check["value"] > check["limit"], out["checks"]
