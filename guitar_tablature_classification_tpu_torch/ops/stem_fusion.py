"""Precomposed ResNet stem front: resize, tile, normalize and conv1 folded
into GEMMs (the JAX package's ``ops/stem_fusion.py``).

The flagship 224^2 recipe upsamples the [96, 9] CQT bicubically to 224^2,
tiles it to 3 channels, ImageNet-normalizes it and runs conv1 7x7/s2.
Every stage is linear in the CQT values, so the whole front is one linear
map [96, 9] -> [112, 112, 64] that never needs the 224^2 image:

    y[p,q,f] = sum_{i,j} (sum_c W[i,j,c,f]/sigma_c) (Rh_i X Rw_j^T)[p,q] + bias[p,q,f]

with ``Rh_i[p,u] = R_h[2p+i-3, u]`` (zero rows where conv1's padding falls
outside the image) and a static bias field carrying the -mu/sigma offset.

:func:`precomposed_conv1_quadrant` emits conv1's output in the quadrant
layout that :mod:`.stem_tail` reads.  The GEMMs run in plain PyTorch (the
JAX package leaves them to XLA too); gradients reach ``conv1.weight``
through them.  bf16 roundings and fp32 accumulation follow the JAX
function: h, s3 and the bias rows are rounded to the compute dtype, every
product accumulates in fp32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .normalize import IMAGENET_MEAN, IMAGENET_STD
from .resize import resize_matrix


@functools.lru_cache(maxsize=16)
def _front_matrices(
    src_h: int,
    src_w: int,
    out: int = 224,
    kernel: int = 7,
    stride: int = 2,
    a: float = -0.75,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """-> (RH [k, out/s, src_h], RW [k, out/s, src_w], INH [out/s, k],
    INW [out/s, k]): per-tap resize rows and inside-the-image indicators
    (zero where conv1's padding falls outside, matching its zero padding)."""
    r_h = resize_matrix(src_h, out, a)
    r_w = resize_matrix(src_w, out, a)
    oh = out // stride
    pad = kernel // 2

    def build(r, src):
        taps = np.zeros((kernel, oh, src), np.float32)
        inside = np.zeros((oh, kernel), np.float32)
        for i in range(kernel):
            for p in range(oh):
                row = stride * p + i - pad
                if 0 <= row < out:
                    taps[i, p] = r[row]
                    inside[p, i] = 1.0
        return taps, inside

    rh, inh = build(r_h, src_h)
    rw, inw = build(r_w, src_w)
    return rh, rw, inh, inw


@functools.lru_cache(maxsize=16)
def _front_constants(
    src_h: int, src_w: int, out: int, kernel: int, stride: int, device: torch.device
) -> tuple[torch.Tensor, ...]:
    """:func:`_front_matrices`, then ImageNet's std and mean, on ``device``,
    made once a shape and device: the forward copies nothing from the host
    (a CUDA graph cannot capture such a copy, and each one held the host
    until the card had drained)."""
    with torch.inference_mode(False):  # tensors a later training step may use
        mats = tuple(torch.from_numpy(m).to(device)
                     for m in _front_matrices(src_h, src_w, out, kernel, stride))
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device)
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device)
    return (*mats, std, mean)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """einsum of operands in ``dtype`` with fp32 accumulation, rounded once
    to ``dtype``.  On the CPU, bf16 operands are upcast exactly to fp32
    first (the same arithmetic; PyTorch's CPU bf16 kernels are not relied
    on)."""
    a, b = a.to(dtype), b.to(dtype)
    if a.device.type == "cpu" and dtype == torch.bfloat16:
        return torch.einsum(eq, a.float(), b.float()).to(dtype)
    return torch.einsum(eq, a, b)


def _front_terms(x, conv1_weight, out_size, stride, dtype):
    """Shared terms of both fronts: the static matrices on x's device, the
    HWIO fp32 kernel, its 1/sigma and mu/sigma contractions, and h."""
    b, src_h, src_w = x.shape
    k = conv1_weight.shape[-1]
    rh, rw, inh, inw, std, mean = _front_constants(src_h, src_w, out_size, k, stride, x.device)
    w = conv1_weight.float().permute(2, 3, 1, 0)  # OIHW -> HWIO [k, k, c, f]
    inv_std = 1.0 / std
    w1 = torch.einsum("ijcf,c->ijf", w, inv_std)  # value path
    wmu = torch.einsum("ijcf,c->ijf", w, mean * inv_std)  # -mean/std offset
    oh = out_size // stride
    # H[b,p,(i,v)] = sum_u RH[i,p,u] x[b,u,v]
    h = _einsum("ipu,buv->bpiv", rh, x, dtype).reshape(b, oh, k * src_w)
    return rh, rw, inh, inw, w1, wmu, h


def precomposed_conv1(
    x: torch.Tensor,
    conv1_weight: torch.Tensor,
    *,
    out_size: int = 224,
    stride: int = 2,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """x: [B, src_h, src_w] unit-scaled CQT; conv1_weight: [64, 3, 7, 7]
    (the port's OIHW ``conv1.weight``).  Returns what
    ``conv1(imagenet_normalize(tile(resize(x))))`` returns, channels last:
    [B, out_size//stride, out_size//stride, 64]."""
    b = x.shape[0]
    feats = conv1_weight.shape[0]
    _, rw, inh, inw, w1, wmu, h = _front_terms(x, conv1_weight, out_size, stride, dtype)
    bias = -torch.einsum("pi,qj,ijf->pqf", inh, inw, wmu)
    oh = out_size // stride
    k = w1.shape[0]
    s = _einsum("ijf,jqv->ivqf", w1, rw, dtype).reshape(k * rw.shape[-1], oh * feats)
    # one GEMM straight into conv1's output, kept in fp32 until the bias
    y = torch.einsum("bpk,km->bpm", h.float(), s.float())
    return (y.reshape(b, oh, oh, feats) + bias).to(dtype)


def quadrant_operands(
    x: torch.Tensor,
    conv1_weight: torch.Tensor,
    *,
    out_size: int = 224,
    stride: int = 2,
    dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The two operands of :func:`precomposed_conv1_quadrant`'s GEMM, in
    ``dtype``: patches hq [B, 2, OH//2, K] and weights sq [K, OH*F] (K = 70
    for the 224^2 stem: 7 taps x 9 CQT frames, plus the 7 bias rows).

    The -mu/sigma bias field enters as ``k`` extra GEMM rows (the per-row
    inside-image indicators join the patch vector, the per-(q, f) bias
    factors join the weight matrix), and the weight columns and patch rows
    are permuted into parity order, so one GEMM writes the quadrant layout
    directly (``stem_fusion.py:114-177``)."""
    b = x.shape[0]
    feats = conv1_weight.shape[0]
    _, rw, inh, inw, w1, wmu, h = _front_terms(x, conv1_weight, out_size, stride, dtype)
    oh = out_size // stride
    if oh % 2:
        raise ValueError(f"quadrant stem front needs an even output size, got {oh}")
    k = w1.shape[0]
    src_w = rw.shape[-1]
    # bias-as-GEMM rows: the patch side carries inh[p, i] (exact 0/1)
    ha = torch.cat([h, inh.to(h.dtype).expand(b, oh, k)], dim=-1)
    hq = torch.stack([ha[:, 0::2], ha[:, 1::2]], dim=1)  # [B, 2, OH/2, K]
    s3 = _einsum("ijf,jqv->ivqf", w1, rw, dtype).reshape(k * src_w, oh, feats)
    brows = (-torch.einsum("qj,ijf->iqf", inw, wmu)).to(dtype)  # [k, OH, F]
    sall = torch.cat([s3, brows], dim=0)  # [K, OH, F]
    sq = torch.cat([sall[:, 0::2], sall[:, 1::2]], dim=1).reshape(
        sall.shape[0], oh * feats
    )  # columns in (col parity, q half, f) order
    return hq, sq


def precomposed_conv1_quadrant(
    x: torch.Tensor,
    conv1_weight: torch.Tensor,
    *,
    out_size: int = 224,
    stride: int = 2,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The same map as :func:`precomposed_conv1`, emitted in quadrant layout
    ``[B, 2, OH//2, OH*F]``::

        yq[b, p%2, p//2, (q%2)*(OH//2)*F + (q//2)*F + f] == y[b, p, q, f]

    One GEMM of the :func:`quadrant_operands`."""
    hq, sq = quadrant_operands(x, conv1_weight, out_size=out_size, stride=stride, dtype=dtype)
    return _einsum("brhk,kn->brhn", hq, sq, dtype)
