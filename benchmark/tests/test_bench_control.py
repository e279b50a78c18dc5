"""The control: the reference computed one precision step below the
configurations' bfloat16 (fp8 e4m3 operands in the backbone's products,
and in the CQT's where the configuration states it in bf16)
put in the port's place, at a size a test run holds.  It has to come out
not correct at the cells' limits.  On the card, at the cells' own sizes,
``python3 -m benchmark.calibrate --control-seeds ...`` reads the same
control (``PERF.md`` gives those readings)."""

from __future__ import annotations

import pytest

from .bench_helpers import TINY_SERVE, TINY_TRAIN, add_cell, copy_benchmark, run_cell

TRAIN_CONTROL = """
from benchmark.drivers import train
made = train.Driver.setup
def setup(self):
    made(self)
    self.readings = self.reference("fp8")
train.Driver.setup = setup
"""

SERVE_CONTROL = """
from benchmark import check
from benchmark.drivers import serve
made = serve.Driver.sample
def sample(self):
    picked = made(self)
    for k in picked:
        i, out = self.results[k]
        out.logits = self.reference_logits(self.tracks[i], "fp8").numpy()
        out.frets = check.mode_filter(out.logits.argmax(-1), self.traffic["smooth_window"], 19)
    return picked
serve.Driver.sample = sample
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = copy_benchmark(str(tmp_path_factory.mktemp("bench")))
    add_cell(root, "tiny_flagship_train", "resnet18_flagship", TINY_TRAIN, "flagship_train",
             e2e=("train_segments_per_s",))
    add_cell(root, "tiny_vit_serve", "vit_s8", dict(TINY_SERVE, track_seconds=[10.0, 5.0]),
             "vit_serve", model={"vit_layers": 2}, e2e=("serve_windows_per_s",))
    add_cell(root, "tiny_native_train", "resnet18_native", TINY_TRAIN, "native_train",
             e2e=("train_segments_per_s",))
    add_cell(root, "tiny_native_serve", "resnet18_native",
             dict(TINY_SERVE, track_seconds=[20.0, 10.0]), "native_serve",
             e2e=("serve_windows_per_s",))
    return root


@pytest.mark.parametrize("cell,control,number", [
    ("tiny_flagship_train", TRAIN_CONTROL, "logit_direction_error"),
    ("tiny_vit_serve", SERVE_CONTROL, "fret_gap"),
    ("tiny_native_train", TRAIN_CONTROL, "logit_direction_error"),
    ("tiny_native_serve", SERVE_CONTROL, "logit_error"),
])
def test_the_control_is_not_correct(root, cell, control, number):
    out = run_cell(root, cell, patch=control)
    assert not out["correct"]
    check = out["checks"][number]
    assert check["value"] > check["limit"], out["checks"]
