"""Piecewise timings of the fused 224^2 stem (where the time hides): the
port of the JAX repo's ``tools/profile_stem_pieces.py``, and the entry point
of the stem-front GEMM with statistics (``ops/stem_cuda.py::gemm_stats``,
the port of ``ops/stem_pallas.py::_gemm_stats_pallas``; no model path
calls it, in either package).

    python -m guitar_tablature_classification_tpu_torch.tools.profile_stem_pieces \\
        [--device cuda] [--batch 256] [--iters 20]

Each piece runs ``iters`` times after one warm-up and prints one line with
its mean milliseconds (CUDA events on the card):

1. the quadrant GEMM front forward, 2. its forward and backward (the
   gradient reaching conv1's weight);
3. the bare [B*112, 70] x [70, 7168] GEMM, one bf16 ``torch.matmul`` (a
   yardstick, as the JAX tool's einsum);
4. the GEMM with statistics (the B8 kernel);
5. the stem statistics, 6. the stem tail forward and 7. backward kernels
   (B2, ``ops/stem_cuda.py``);
8. ``bn_relu_pool`` forward and backward.

The JAX tool also sweeps the Pallas kernels' batch tile (``bt``) and
``m_tile``: those choose the TPU kernels' VMEM tiles, mean nothing on the
GPU, and are dropped.  Inputs follow the JAX tool's NumPy recipe
(``default_rng(0)``).  :func:`profile` returns the rows, for callers in
the same process.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import resolve_device
from ..ops import stem_fusion, stem_tail
from .timing import device_name, time_ms

STEPS = 20
H2, C = 56, 64


def profile(device=None, batch: int = 256, iters: int = STEPS) -> list[dict]:
    """Time the eight pieces; returns one row per piece
    ``{"piece", "ms", "device", "batch"}`` and prints its line."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (batch, 96, 9)).astype(np.float32)).to(dev)
    w_hwio = (rng.standard_normal((7, 7, 3, 64)) * 0.05).astype(np.float32)
    w = torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy()).to(dev)  # OIHW
    with torch.no_grad():
        yq = stem_fusion.precomposed_conv1_quadrant(x, w, dtype=torch.bfloat16).contiguous()
    zeros, ones = (torch.full((C,), v, device=dev) for v in (0.0, 1.0))
    mean, var, scale, bias = zeros, ones, ones, zeros
    se, oe, _ = stem_tail.lane_affine(mean, var, scale, bias, 1e-5)
    g = torch.from_numpy((rng.standard_normal((batch, H2, H2 * C)) * 0.1).astype(np.float32))
    g = g.to(dev).to(torch.bfloat16)
    hq = torch.from_numpy(rng.standard_normal((batch * 2 * 56, 70)).astype(np.float32))
    hq = hq.to(dev).to(torch.bfloat16)
    sq = torch.from_numpy((rng.standard_normal((70, 7168)) * 0.05).astype(np.float32))
    sq = sq.to(dev).to(torch.bfloat16)
    m_tile = 256 if hq.shape[0] % 256 == 0 else 112  # the TPU tool's default where it divides M

    def front_fwd():
        with torch.no_grad():
            return stem_fusion.precomposed_conv1_quadrant(x, w, dtype=torch.bfloat16)

    w_leaf = w.clone().requires_grad_(True)

    def front_fwd_bwd():
        y = stem_fusion.precomposed_conv1_quadrant(x, w_leaf, dtype=torch.bfloat16)
        return torch.autograd.grad((y.float() ** 2).sum() * 1e-9, w_leaf)

    def bare_gemm():
        if dev.type == "cpu":  # the CPU's bf16 kernels are not relied on
            return (hq.float() @ sq.float()).to(torch.bfloat16)
        return torch.matmul(hq, sq)

    yq_leaf = yq.clone().requires_grad_(True)
    g4 = g.reshape(batch, H2, H2, C).float()

    def op_fwd_bwd():
        out = stem_tail.bn_relu_pool(yq_leaf, mean, var, scale, bias, 1e-5)
        return torch.autograd.grad((out.float() * g4).sum(), yq_leaf)

    pieces = [
        (f"GEMM front fwd (B={batch})", front_fwd),
        ("GEMM front fwd+bwd", front_fwd_bwd),
        (f"bare GEMM [{batch * 112},70]x[70,7168] (torch.matmul)", bare_gemm),
        ("GEMM+stats kernel (gemm_stats)", lambda: stem_tail.gemm_stats(hq, sq, m_tile=m_tile)),
        ("BN stats kernel (stem_stats)", lambda: stem_tail.stats(yq)),
        ("stem fwd kernel (BN+ReLU+pool)", lambda: stem_tail.fwd(yq, se, oe)),
        ("stem bwd kernel (pool/relu/BN grads)", lambda: stem_tail.bwd(yq, g, se, oe)),
        ("bn_relu_pool custom op fwd+bwd", op_fwd_bwd),
    ]
    name = device_name(dev)
    rows = []
    for label, fn in pieces:
        ms = time_ms(fn, iters, dev)
        print(f"{label:<58s} {ms:8.3f} ms", flush=True)
        rows.append({"piece": label, "ms": ms, "device": name, "batch": batch})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the card (cuda)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=STEPS)
    args = ap.parse_args(argv)
    rows = profile(args.device, batch=args.batch, iters=args.iters)
    print(json.dumps({"device": rows[0]["device"], "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
