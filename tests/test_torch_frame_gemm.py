"""The port's raw CQT frame GEMM (``ops/cqt.py::frame_gemm_plain`` behind
``ops/cqt_cuda.py::cqt_frame_gemm``) held to the JAX package's TPU kernel
``ops/cqt_pallas.py::cqt_frame_gemm`` in interpret mode, on the same NumPy
inputs.

Tolerance: per window, max|got - want| <= 1e-5 * max|want|.  Both sides
take the same fp32 products (exact for the bf16 operands of the lower
tiers, whose roundings agree) and differ only by the fp32 summation order
over Kw = 23,552 (training) or 6,144 (serving) filter rows; on the CPU
they differ by 5.3e-7.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from guitar_tablature_classification_tpu.ops.cqt_pallas import cqt_frame_gemm as jax_frame_gemm
from guitar_tablature_classification_tpu_torch.config import CQTConfig
from guitar_tablature_classification_tpu_torch.ops import cqt_cuda
from guitar_tablature_classification_tpu_torch.ops.cqt import (
    CQTFrontend,
    cqt_epilogue,
    fp32_matmul,
    frame_gemm_plain,
    round_bf16,
    split_bf16,
)
from guitar_tablature_classification_tpu_torch.ops.cqt_kernels import n_frames_for

REL_TOL = 1e-5
PRECISIONS = ("highest", "bf16x3", "default")


def _case(cfg, batch, seed):
    """Guitar-range tones plus noise, constant-padded as the CQT pads
    them, and the recipe's [Kw, 2F] filterbank."""
    fe = CQTFrontend(cfg)
    kernels = fe.filterbank.stacked()
    kw = kernels.shape[0]
    rng = np.random.default_rng(seed)
    t = np.arange(cfg.window_samples) / cfg.sample_rate
    f = 60.0 * (2000.0 / 60.0) ** rng.random((batch, 1))
    x = np.sin(2 * np.pi * f * t) + 0.01 * rng.standard_normal((batch, t.size))
    padded = np.pad(x.astype(np.float32), ((0, 0), (kw // 2, kw // 2)))
    return padded, kernels, n_frames_for(cfg.window_samples, cfg.hop_length)


def _assert_close(got, want):
    err = np.abs(got - want).max(axis=(1, 2))
    scale = np.abs(want).max(axis=(1, 2))
    assert np.all(err <= REL_TOL * scale), (err / scale).max()


@pytest.mark.parametrize(
    "recipe, precision, batch",
    [("train", p, 16) for p in PRECISIONS] + [("serving_cnn", "default", 2)],
)
def test_matches_pallas_interpret(recipe, precision, batch):
    cfg = CQTConfig() if recipe == "train" else CQTConfig.serving_cnn()
    padded, kernels, t = _case(cfg, batch, seed=0)
    want = np.asarray(jax_frame_gemm(
        jnp.asarray(padded), jnp.asarray(kernels), hop_length=cfg.hop_length,
        n_frames=t, batch_block=batch, interpret=True, precision=precision,
    ))
    got = cqt_cuda.cqt_frame_gemm(
        torch.from_numpy(padded), torch.from_numpy(kernels), hop_length=cfg.hop_length,
        n_frames=t, batch_block=batch, precision=precision,
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_cqt_plain_is_unchanged_by_the_refactor(precision):
    """cqt_plain now calls frame_gemm_plain then cqt_epilogue; it gives the
    bits the inline frame stack and matmul gave before."""
    cfg = dataclasses.replace(CQTConfig(), precision=precision)
    padded, kernels, t = _case(cfg, 4, seed=1)
    x = torch.from_numpy(padded[:, kernels.shape[0] // 2:][:, :cfg.window_samples].copy())
    k = torch.from_numpy(kernels)
    kw = k.shape[0]
    frames = F.pad(x, (kw // 2, kw // 2)).unfold(-1, kw, cfg.hop_length)[:, :t]
    with fp32_matmul():
        if precision == "bf16x3":
            (f_hi, f_lo), (k_hi, k_lo) = split_bf16(frames), split_bf16(k)
            coeff = f_hi @ k_hi + f_hi @ k_lo + f_lo @ k_hi
        elif precision == "default":
            coeff = round_bf16(frames) @ round_bf16(k)
        else:
            coeff = frames @ k
    before = cqt_epilogue(
        coeff, n_bins=cfg.n_bins, magnitude_power=cfg.magnitude_power, amin=cfg.amin,
        top_db=cfg.top_db, gate_threshold_db=cfg.gate_threshold_db,
        gate_floor_db=cfg.gate_floor_db,
    )
    assert torch.equal(CQTFrontend(cfg)(x), before)


def test_short_input_reads_zeros_past_its_end():
    """A P shorter than (T-1)*hop + Kw reads zeros, as the JAX function's
    own padding gives (and the JAX function agrees)."""
    cfg = CQTConfig()
    padded, kernels, t = _case(cfg, 16, seed=2)
    short = padded[:, : padded.shape[1] - 3000]
    got = cqt_cuda.cqt_frame_gemm(torch.from_numpy(short), torch.from_numpy(kernels),
                                  hop_length=cfg.hop_length, n_frames=t)
    zeros = np.pad(short, ((0, 0), (0, 3000)))
    want = frame_gemm_plain(torch.from_numpy(zeros), torch.from_numpy(kernels),
                            hop_length=cfg.hop_length, n_frames=t, precision="highest")
    assert torch.equal(got, want)
    jax_out = np.asarray(jax_frame_gemm(jnp.asarray(short), jnp.asarray(kernels),
                                        hop_length=cfg.hop_length, n_frames=t,
                                        interpret=True))
    _assert_close(got.numpy(), jax_out)


def test_wrapper_checks_as_jax_does_and_cpu_launches_nothing():
    cfg = CQTConfig()
    padded, kernels, t = _case(cfg, 12, seed=3)
    args = (torch.from_numpy(padded), torch.from_numpy(kernels))
    kw = dict(hop_length=cfg.hop_length, n_frames=t)
    with pytest.raises(ValueError, match="not divisible by block 16"):
        cqt_cuda.cqt_frame_gemm(*args, **kw)
    with pytest.raises(ValueError, match="precision"):
        cqt_cuda.cqt_frame_gemm(*args, batch_block=4, precision="high", **kw)
    before = cqt_cuda.frame_gemm_launches
    out = cqt_cuda.cqt_frame_gemm(*args, batch_block=4, k_tile=512, **kw)
    assert cqt_cuda.frame_gemm_launches == before
    assert torch.equal(out, frame_gemm_plain(*args, precision="highest", **kw))
    with pytest.raises(ValueError, match="unsupported device"):
        cqt_cuda.cqt_frame_gemm(args[0].to("meta"), args[1].to("meta"), batch_block=4, **kw)


def test_splits_follow_the_shape():
    """The kernel's split of the depth: enough CTAs at the training recipe
    (108 output tiles -> 3 ranges), none where the tiles fill the card,
    never a range under 512 rows."""
    assert cqt_cuda.frame_gemm_splits(256 * 9, 192, 23552) == 3
    assert cqt_cuda.frame_gemm_splits(64 * 130, 168, 6144) == 1
    assert cqt_cuda.frame_gemm_splits(16, 8, 600) == 1
