"""A later change adds a configuration, a traffic mix and a per-layer
metric as new files and new entries, and the harness runs the new cell
without an edit to any file that was there; and a configuration of an
architecture the benchmark has no model of yet comes with the
reference's model of it as a file of its own."""

from __future__ import annotations

import hashlib
import json
import os

from .bench_helpers import TINY_SERVE, TINY_TRAIN, add_cell, copy_benchmark, run_cell


def _digests(root: str) -> dict[str, str]:
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_a_cell_added_by_files_runs(tmp_path):
    root = copy_benchmark(str(tmp_path))
    before = _digests(os.path.join(root, "benchmark"))
    add_cell(root, "tiny_vit_train", "vit_s8", TINY_TRAIN, "vit_train",
             model={"vit_layers": 1, "dtype": "float32"}, e2e=("train_segments_per_s",))
    metric = os.path.join(root, "benchmark", "metrics", "steps_per_window.train.py")
    with open(metric, "w") as f:
        f.write('"""Steps in the window."""\n\n\ndef read(run):\n'
                '    return float(run.window["steps"]) if "steps" in run.window else None\n')
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["per_layer"].append({"name": "steps_per_window.train", "unit": "steps",
                              "better": "higher", "source": "program_counter",
                              "layer": "train/engine.py make_train_step",
                              "moves": "train_segments_per_s", "workloads": ["tiny_vit_train"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    after = _digests(os.path.join(root, "benchmark"))
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited

    plain = run_cell(root, "tiny_vit_train")
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"train_segments_per_s", "setup_s"}
    assert plain["attempted"] >= 1 and plain["metrics"]["train_segments_per_s"]["value"] > 0
    assert list(plain)[-1] == "checks"
    traced = run_cell(root, "tiny_vit_train", trace=True)
    assert traced["metrics"]["steps_per_window.train"]["value"] == traced["attempted"]
    assert "host_enqueue_ms.train" not in traced["metrics"]  # not listed for the new cell


SMALL_CNN = '''"""The reference model of ``arch`` ``small_cnn``: three 3x3 VALID convs
1->32->64->64 with ReLU, a 2x2 max-pool, the features flattened in
(H, W, C) order, then per string dense layers ->152->76->frets, ReLU
between (dropout in training only).  It takes the CQT in [0, 1]."""

import torch
import torch.nn.functional as F
from torch import nn

from .models import conv
from .precision import Precision


class Stacked(nn.Module):
    def __init__(self, strings, n_in, n_out):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(strings, n_in, n_out))
        self.bias = nn.Parameter(torch.zeros(strings, n_out))


class SmallCNN(nn.Module):
    def __init__(self, strings, frets, hw=(96, 9)):
        super().__init__()
        self.conv1, self.conv2, self.conv3 = (nn.Conv2d(a, b, 3) for a, b in
                                              ((1, 32), (32, 64), (64, 64)))
        h, w = ((d - 6) // 2 for d in hw)
        self.dense0 = Stacked(strings, h * w * 64, 152)
        self.dense1 = Stacked(strings, 152, 76)
        self.out = Stacked(strings, 76, frets)

    @staticmethod
    def inputs(db):
        return ((db + 120.0) / 120.0).clamp(0.0, 1.0)[:, None]

    def run(self, x, *, train, generator=None, prec=Precision()):
        for c in (self.conv1, self.conv2, self.conv3):
            x = F.relu(conv(x, c, prec))
        x = F.max_pool2d(x, 2).permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(torch.einsum("bf,sfh->bsh", x, self.dense0.weight) + self.dense0.bias)
        x = F.relu(torch.einsum("bsf,sfh->bsh", x, self.dense1.weight) + self.dense1.bias)
        return torch.einsum("bsf,sfh->bsh", x, self.out.weight) + self.out.bias


def build(model):
    return SmallCNN(model["num_strings"], model["num_frets"])
'''


def test_a_new_architecture_comes_as_files(tmp_path):
    root = copy_benchmark(str(tmp_path))
    before = _digests(os.path.join(root, "benchmark"))
    with open(os.path.join(root, "benchmark", "reference", "arch_small_cnn.py"), "w") as f:
        f.write(SMALL_CNN)
    add_cell(root, "tiny_cnn_serve", "resnet18_flagship", TINY_SERVE, "flagship_serve",
             model={"arch": "small_cnn", "dtype": "float32"}, e2e=("serve_windows_per_s",))
    after = _digests(os.path.join(root, "benchmark"))
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited

    out = run_cell(root, "tiny_cnn_serve")
    assert out["correct"], out["checks"]
    assert out["checks"]["fret_gap"]["value"] < 1e-3
    assert set(out["metrics"]) == {"serve_windows_per_s", "setup_s"}
