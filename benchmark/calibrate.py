"""The readings that the limits of ``correct`` are set from, for one cell,
over many seeds in one process (no benchmark run calls this):

- the port's sound runs: each number of the cell's check (the lower
  readings);
- the control: the reference computed one precision step lower (fp8 e4m3
  operands in the backbone's products) in the port's place;
- training only: the reference with half of each batch taken into the
  mean (a fault to read; a state left unchanged reads 1 by the measure and
  needs no run);
- with ``--fault <name>``: the port with ``faults/<name>.py`` planted,
  every seed of the call (a fault to read).

    python3 -m benchmark.calibrate --workload vit_train --seeds 1 2 3 --control-seeds 1 2 3
    python3 -m benchmark.calibrate --workload vit_train --seeds 4 5 6 --fault attn_bwd_zero

Serving takes a short window (``--seconds``) at the cell's own load, then
checks its sample as a run does.  One JSON line a seed and reading, and a
summary line (largest sound reading, smallest control and fault reading,
of each number).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from . import check, harness
from .spans import Spans


def _train(cell, seed, dev, control: bool, key: str) -> dict:
    drv = harness.driver(cell, seed, dev, Spans())
    drv.setup()
    port = drv.readings
    drv.free()
    t = time.perf_counter()
    ref = drv.reference()
    out = {key: check.train_numbers(port, ref), "reference_s": time.perf_counter() - t,
           "detail": check.train_detail(port, ref)}
    if control:
        for name, kw in (("control", {"kind": "fp8"}), ("half_batch", {"rows_fault": True})):
            low = drv.reference(**kw)
            out[name] = check.train_numbers(low, ref)
            out[name + "_detail"] = check.train_detail(low, ref)
    return out


def _serve(cell, seed, dev, control: bool, key: str, seconds: float) -> dict:
    drv = harness.driver(cell, seed, dev, Spans())
    drv.setup()
    drv.window(seconds)
    sample = [drv.results[k] for k in drv.sample()]
    drv.free()
    t = time.perf_counter()
    refs = [drv.reference_logits(drv.tracks[i]).numpy() for i, _ in sample]
    out = {key: check.serve_numbers([(o.frets, o.logits) for _, o in sample], refs,
                                        cell.traffic["smooth_window"]),
           "reference_s": time.perf_counter() - t, "tracks": len(drv.results),
           "sampled_windows": sum(r.shape[0] for r in refs)}
    if control:
        low = [drv.reference_logits(drv.tracks[i], "fp8").numpy() for i, _ in sample]
        out["control"] = check.control_numbers(refs, low, cell.traffic["smooth_window"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", help="plant faults/<name>.py in the port for every seed")
    p.add_argument("--set", nargs="*", default=[], metavar="GROUP.KEY=JSON",
                   help="override a configuration value for a diagnostic (model.dtype=\"float32\")")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for item in args.set:
        key, value = item.split("=", 1)
        group, name = key.split(".", 1)
        cell.config[group][name] = json.loads(value)
    dev = torch.device(args.device)
    key = "sound"
    if args.fault:
        importlib.import_module(f".faults.{args.fault}", __package__).plant()
        key = "fault"
    rows = []
    for seed in args.seeds:
        control = seed in args.control_seeds
        if cell.traffic["kind"] == "train":
            r = _train(cell, seed, dev, control, key)
        else:
            r = _serve(cell, seed, dev, control, key, args.seconds)
        r["seed"] = seed
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = {}
    for kind, pick in (("sound", max), ("control", min), ("half_batch", min), ("fault", min)):
        got = [r[kind] for r in rows if kind in r]
        if got:
            summary[kind] = {k: pick(g[k] for g in got) for k in got[0]}
    print("summary " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
