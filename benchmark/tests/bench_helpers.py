"""A copy of the benchmark in a temporary directory with tiny cells added
by files only, and a way to run one of its cells there on the CPU through
the harness's own code (the chip check of ``run.py`` left out)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

TINY_TRAIN = {"kind": "train", "batch": 4, "batches": 3, "hop_seconds": 0.1, "prefetch": 2,
              "check_steps": 3, "warm_steps": 1, "trace_steps": 1}
TINY_SERVE = {"kind": "serve", "track_seconds": [3.0, 1.5], "batch_size": 8, "buckets": [1, 8],
              "smooth_window": 3, "hop_seconds": 0.1, "check_tracks": 2, "trace_tracks": 1}


def copy_benchmark(dest: str) -> str:
    """``dest``/benchmark and ``dest``/BENCHMARK.json, copies of the
    repository's; returns ``dest``."""
    shutil.copytree(BENCH, os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    return dest


def add_cell(root: str, name: str, config: str, traffic: dict, limits_from: str,
             model: dict | None = None, e2e: tuple[str, ...] = ()) -> None:
    """A cell ``name`` on a new configuration ``<config>_<name>`` (the
    configuration ``config`` with ``model`` changed) and a new traffic mix
    ``<name>``, with the limits of the cell ``limits_from``: new files and
    new entries only."""
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    cfg["model"].update(model or {})
    new_config = f"{config}_{name}"
    _dump(os.path.join(bench, "configs", f"{new_config}.json"), cfg)
    _dump(os.path.join(bench, "traffic", f"{name}.json"), traffic)
    shutil.copy(os.path.join(bench, "limits", f"{limits_from}.json"),
                os.path.join(bench, "limits", f"{name}.json"))
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": name, "config": new_config, "traffic": name, "chips": 1,
                              "why": "a tiny cell for the CPU tests"})
    for m in spec["end_to_end"]:
        if m["name"] in e2e and "workloads" in m:
            m["workloads"].append(name)
    _dump(spec_path, spec)


def _dump(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


RUNNER = """
import json, sys, time
sys.path[:0] = [{root!r}, {repo!r}]
import benchmark
assert benchmark.__file__.startswith({root!r}), benchmark.__file__
from benchmark import harness
{patch}
out = harness.run({cell!r}, {seed!r}, {seconds!r}, {trace!r}, "cpu", time.perf_counter())
print(json.dumps(out))
"""


def run_cell(root: str, cell: str, seed: int = 1234567890123, seconds: float = 0.5,
             patch: str = "", trace: bool = False) -> dict:
    """One run of ``cell`` in the copy at ``root``, on the CPU, in a fresh
    process; ``patch`` is Python run before it (a fault planted under the
    timed path).  Returns the result line."""
    code = RUNNER.format(root=root, repo=REPO, cell=cell, seed=seed, seconds=seconds,
                         patch=patch, trace=trace)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=900, env=env, cwd=root)
    if proc.returncode != 0:
        raise AssertionError(f"the run failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])
