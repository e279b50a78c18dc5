"""Run one cell of the benchmark once, on the card this process sees.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number that decided ``correct``
beside its limit, which also make up the last lines of standard error.
Exits non-zero, printing no result, without a CUDA card (or fewer than
the cell asks for), where the port cannot be imported, or where JAX or the
JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
os.environ.setdefault("USE_FLAX", "0")  # keep libraries from loading JAX on their own
# one host thread for PyTorch's CPU ops: the host paces the training steps, and
# idle OpenMP workers spinning on the card machine's few cores made runs spread
os.environ["OMP_NUM_THREADS"] = "1"
# a Triton kernel's cache, if the port ever has one: inside the checkout, at a fixed path
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(os.path.dirname(HERE), ".bench_cache", "triton"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.run", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        import guitar_tablature_classification_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is not here: {e}", file=sys.stderr)
        return 4
    torch.set_num_threads(1)
    torch.backends.cudnn.benchmark = False
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = harness.loaded_forbidden()
    if found:
        print(f"benchmark: these modules were loaded: {found}", file=sys.stderr)
        return 5
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
