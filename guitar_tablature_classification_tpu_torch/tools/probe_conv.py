"""Probe: the 3x3 conv with a fused ReLU-affine on its input
(``ops/conv3x3.py``, kernel ``csrc/conv3x3.cu``) against cuDNN at ResNet18
trunk shapes: the port of the JAX repo's ``tools/probe_pallas_conv.py`` and
the entry point of its kernel.

    python -m guitar_tablature_classification_tpu_torch.tools.probe_conv \\
        [--device cuda] [--batch 256] [--iters 30]

The probe's three cases at B=256, (H, C -> F) = (56, 64 -> 64),
(28, 128 -> 128) and (14, 256 -> 256), with its inputs from NumPy's
``default_rng(0)`` in its order.  Per case it prints the yardstick, cuDNN
``F.conv2d`` (channels last, bf16, fp32 accumulation) on the same bf16
``relu(x*s + o)``, timed alone and with the affine, then one line for
the kernel with ms, TF/s and the probe's parity figure
``max|got - ref| / max|ref|`` against the cuDNN output.  The variants
("sum9", "concat") and the probe's ``bt`` and ``row_chunk`` are TPU
formulations of one function that all reach the one kernel: the probe
checks that both variants give the same bits and times the kernel once.  On the CPU (a
rehearsal) the yardstick is an fp32 convolution rounded to bf16, since
PyTorch's CPU bf16 convolution is not relied on.  :func:`probe` returns
the rows.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import conv3x3
from .timing import device_name, time_ms

STEPS = 30
# (H, C, F, bt, row_chunk), as the JAX probe lists them
CASES = ((56, 64, 64, 4, 8), (28, 128, 128, 8, 7), (14, 256, 256, 8, 7))


def _bf16(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(torch.bfloat16)


def probe(device=None, batch: int = 256, iters: int = STEPS, cases=CASES) -> list[dict]:
    """Run the cases; returns one row per (case, route) with ``ms``,
    ``tflops`` and, for the kernel, ``parity``."""
    dev = resolve_device(device)
    name = device_name(dev)
    rng = np.random.default_rng(0)
    rows = []
    for h, c, f, bt, rc in cases:
        bt = bt if batch % bt == 0 else 1
        x = _bf16(rng.standard_normal((batch, h, h, c)), dev)
        wk = _bf16(rng.standard_normal((3, 3, c, f)) * 0.02, dev)
        s = _bf16(rng.uniform(0.5, 1.5, c), dev)
        o = _bf16(rng.standard_normal(c) * 0.1, dev)
        flops = 2 * batch * h * h * f * 9 * c
        w9 = wk.reshape(9, c, f).contiguous()
        # OIHW weight, channels last: the layout cuDNN takes for NHWC input
        w_oihw = wk.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

        def cudnn(t):
            if dev.type == "cpu":
                return F.conv2d(t.float(), w_oihw.float(), padding=1).to(torch.bfloat16)
            return F.conv2d(t, w_oihw, padding=1)

        t_nchw = conv3x3.affine_relu(x, s, o).permute(0, 3, 1, 2)  # a channels-last view
        ref = cudnn(t_nchw).permute(0, 2, 3, 1).float()
        scale = float(ref.abs().max())
        base = {"case": f"{c}->{f} @{h}", "batch": batch, "flops": flops, "device": name}

        def emit(label, ms, **extra):
            row = {**base, "route": label, "ms": ms, "tflops": flops / (ms / 1e3) / 1e12, **extra}
            par = f" (par {extra['parity']:.1e})" if "parity" in extra else ""
            print(f"{label + ' conv3x3 ' + base['case'] + par:<58s} {ms:8.3f} ms  "
                  f"{row['tflops']:7.1f} TF/s", flush=True)
            rows.append(row)

        emit("cuDNN", time_ms(lambda: cudnn(t_nchw), iters, dev))
        emit("cuDNN+affine", time_ms(
            lambda: cudnn(conv3x3.affine_relu(x, s, o).permute(0, 3, 1, 2)), iters, dev))
        def run(variant=conv3x3.VARIANTS[0]):
            return conv3x3.conv3x3_affine_relu(x, w9, s, o, variant=variant,
                                               row_chunk=rc, bt=bt)

        got = run()
        for variant in conv3x3.VARIANTS[1:]:  # one function: every variant gives the same bits
            if not torch.equal(run(variant), got):
                raise AssertionError(f"variant {variant} differs from {conv3x3.VARIANTS[0]}")
        parity = float((got.float() - ref).abs().max()) / max(scale, 1e-9)
        emit("kernel " + "/".join(conv3x3.VARIANTS), time_ms(run, iters, dev), parity=parity)
        del x, t_nchw, ref, got
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the card (cuda)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=STEPS)
    args = ap.parse_args(argv)
    rows = probe(args.device, batch=args.batch, iters=args.iters)
    print(json.dumps({"device": rows[0]["device"], "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
