"""The port's raw CQT frame GEMM (``ops/cqt.py::frame_gemm_plain`` behind
``ops/cqt_cuda.py::cqt_frame_gemm``) held to the JAX package's TPU kernel
``ops/cqt_pallas.py::cqt_frame_gemm`` in interpret mode, on the same NumPy
inputs.

Tolerance: per window, max|got - want| <= 1e-5 * max|want|.  Both sides
take the same fp32 products (exact for the bf16 operands of the lower
tiers, whose roundings agree) and differ only by the fp32 summation order
over Kw = 23,552 (training) or 6,144 (serving) filter rows; on the CPU
they differ by 5.3e-7.  The tile-plan tests walk the card kernels' plans
(tiles, depth ranges, padded copies of each bf16 piece, products of
pieces) in float64 NumPy and hold them to the dense contraction at rtol
1e-9.
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
    """The SIMT kernel's split of the depth (highest and bf16x3 at a hop off
    the 8-grid): enough CTAs at the training recipe's shape (108 output
    tiles -> 3 ranges), none where the tiles fill the card, never a range
    under 512 rows."""
    assert cqt_cuda.frame_gemm_splits(256 * 9, 192, 23552) == 3
    assert cqt_cuda.frame_gemm_splits(64 * 130, 168, 6144) == 1
    assert cqt_cuda.frame_gemm_splits(16, 8, 600) == 1


def _pieces(arr, parts):
    """The kernel's bf16 pieces of fp32 values (to_parts_kernel): piece p
    = bf16(v), then v -= piece in fp32 (exact), as float64 arrays."""
    v = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    out = []
    for _ in range(parts):
        piece = v.to(torch.bfloat16).float()
        out.append(piece.double().numpy())
        v = v - piece
    return out


def _emulate_mma_kernel(padded, kernels, hop, t, count=False, precision="default"):
    """float64 NumPy walk of csrc/cqt_frame_gemm.cu's tensor-core kernels
    at a tier: the grid of 128 x 96 tiles and depth ranges, 32-deep steps,
    the tier's bf16 pieces of both operands and its products of pieces
    (FRAME_GEMM_PRODUCTS), each step's sum added into the total, partial
    sums added in split order.  At a hop that is a multiple of 8 the ring
    kernels read zero-padded bf16 copies of each piece (audio rows of P8,
    filterbank of K32 x N96) with no mask and the last range ends at K32;
    else (default only) each A value is read at padded[b, t*hop + k] when
    k lies in the range and inside P (else 0).  With ``count``, also how
    often each (row, k, column) term with k < Kw was taken."""
    b, p = padded.shape
    kw, n = kernels.shape
    rows = b * t
    copies = cqt_cuda.frame_gemm_copies(p, t, hop, kw, n, precision)
    ring = copies is not None
    assert ring or precision == "default"
    bm, bn, bk = cqt_cuda.frame_gemm_tile(precision, ring)
    splits = cqt_cuda.frame_gemm_splits(rows, n, kw, precision, ring)
    ranges = cqt_cuda.frame_gemm_ranges(kw, splits, precision, ring)
    assert len(ranges) == splits and ranges[-1][1] == kw
    parts = cqt_cuda.FRAME_GEMM_PARTS[precision]
    a_bf, k_bf = _pieces(padded, parts), _pieces(kernels, parts)
    m = np.arange(rows)
    if ring:
        p8, k32, n96 = copies
        assert p8 % 8 == 0 and p8 >= max(p, (t - 1) * hop + k32) and k32 % bk == 0
        a_bf = [np.pad(a, ((0, 0), (0, p8 - p))) for a in a_bf]
        k_bf = [np.pad(k, ((0, k32 - kw), (0, n96 - n))) for k in k_bf]
        ranges = ranges[:-1] + [(ranges[-1][0], k32)]
        assert all(r[0] % bk == 0 and (r[1] - r[0]) % bk == 0 for r in ranges)
        row_off, row_lim, depth = (m // t) * p8 + (m % t) * hop, np.full(rows, 1 << 40), k32
    else:
        row_off, row_lim, depth = (m // t) * p + (m % t) * hop, p - (m % t) * hop, kw
    partial = np.zeros((splits, rows, n))
    cover = np.zeros((rows, kw, n), np.int32) if count else None
    flats = [a.reshape(-1) for a in a_bf]
    for z, (k_begin, k_end) in enumerate(ranges):
        for m0 in range(0, rows, bm):
            ms = m[m0 : m0 + bm]
            for n0 in range(0, n, bn):
                ns = np.arange(n0, min(n0 + bn, n))
                total = np.zeros((len(ms), len(ns)))
                for k0 in range(k_begin, k_end, bk):
                    ks = np.arange(k0, k0 + bk)
                    live = (ks[None, :] < k_end) & (ks[None, :] < row_lim[ms, None])
                    idx = np.where(live, row_off[ms, None] + ks[None, :], 0)
                    kl = ks < min(k_end, depth)
                    a = [np.where(live, f[idx], 0.0) for f in flats]
                    bt = [np.where(kl[:, None], k[np.minimum(ks, depth - 1)][:, ns], 0.0)
                          for k in k_bf]
                    total += sum(a[pa] @ bt[pb] for pa, pb in cqt_cuda.FRAME_GEMM_PRODUCTS[precision])
                    if count:
                        kin = ks[ks < min(k_end, kw)]
                        cover[np.ix_(ms, kin, ns)] += 1
                partial[z][np.ix_(ms, ns)] = total
    out = partial[0]
    for z in range(1, splits):
        out = out + partial[z]
    return out.reshape(b, t, n), cover


def _dense_pieces(padded, kernels, hop, t, precision="default"):
    """The dense float64 contraction of the tier's products of pieces."""
    kw = kernels.shape[0]
    need = (t - 1) * hop + kw
    full = np.pad(padded, ((0, 0), (0, max(0, need - padded.shape[1]))))
    parts = cqt_cuda.FRAME_GEMM_PARTS[precision]
    a, k = _pieces(full, parts), _pieces(kernels, parts)
    return sum(np.stack([a[pa][:, i * hop : i * hop + kw] @ k[pb] for i in range(t)], axis=1)
               for pa, pb in cqt_cuda.FRAME_GEMM_PRODUCTS[precision])


@pytest.mark.parametrize("recipe", ["train", "serving_cnn"])
def test_mma_plan_matches_dense_bf16_contraction(recipe):
    """The default tier's tiles and depth ranges sum exactly the dense
    contraction of the bf16-rounded operands (float64)."""
    cfg = CQTConfig() if recipe == "train" else CQTConfig.serving_cnn()
    padded, kernels, t = _case(cfg, 4 if recipe == "train" else 1, seed=4)
    got, _ = _emulate_mma_kernel(padded, kernels, cfg.hop_length, t)
    want = _dense_pieces(padded, kernels, cfg.hop_length, t)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12 * np.abs(want).max())


def test_mma_ring_copies_cover_each_term_once():
    """hop 512, Kw 5000 (not a multiple of 32), N 20, P short: the ring
    kernel's padded copies and ranges take every term once."""
    rng = np.random.default_rng(10)
    kernels = rng.standard_normal((5000, 20)).astype(np.float32)
    padded = rng.standard_normal((4, 6000)).astype(np.float32)
    assert cqt_cuda.frame_gemm_copies(6000, 7, 512, 5000, 20, "default") == (8096, 5024, 96)
    got, cover = _emulate_mma_kernel(padded, kernels, 512, 7, count=True)
    assert cover.min() == 1 and cover.max() == 1
    want = _dense_pieces(padded, kernels, 512, 7)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12 * np.abs(want).max())


def test_mma_plan_covers_each_term_once_ragged():
    """hop 333, Kw 5000, N 20 and P short of (T-1)*hop + Kw: every (row, k,
    column) term is taken exactly once, and the zeros past P are read as
    the JAX function's padding gives them."""
    rng = np.random.default_rng(9)
    kernels = rng.standard_normal((5000, 20)).astype(np.float32)
    padded = rng.standard_normal((4, 6000)).astype(np.float32)
    got, cover = _emulate_mma_kernel(padded, kernels, 333, 7, count=True)
    assert cqt_cuda.frame_gemm_splits(28, 20, 5000, "default") > 1
    assert cover.min() == 1 and cover.max() == 1
    want = _dense_pieces(padded, kernels, 333, 7)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12 * np.abs(want).max())


def test_mma_splits_follow_the_shape():
    """The tensor-core tiles: 36 at the training recipe (B=256) -> 7 depth
    ranges, 252 CTAs in one wave of two an SM; the SIMT kernel keeps its
    64 x 64 tiles."""
    assert cqt_cuda.frame_gemm_tile("default") == (128, 96, 32)
    assert cqt_cuda.frame_gemm_tile("bf16x3") == (64, 64, 16)
    assert cqt_cuda.frame_gemm_splits(256 * 9, 192, 23552, "default") == 7
    assert cqt_cuda.frame_gemm_splits(64 * 130, 168, 6144, "default") == 2
    for kw, splits in ((23552, 7), (5000, 9), (600, 1)):
        ranges = cqt_cuda.frame_gemm_ranges(kw, splits, "default")
        assert ranges[0][0] == 0 and ranges[-1][1] == kw
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all((e - s) % 32 == 0 or e == kw for s, e in ranges)


SPLIT_TIERS = ("highest", "bf16x3")


def _ragged(seed=10):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, 6000)).astype(np.float32),
            rng.standard_normal((5000, 20)).astype(np.float32))


@pytest.mark.parametrize("precision", SPLIT_TIERS)
@pytest.mark.parametrize("recipe", ["train", "serving_cnn", "ragged_ring"])
def test_split_tier_plan_matches_dense_contraction(recipe, precision):
    """highest and bf16x3 on the ring kernels: the tiles, the ring's depth
    ranges and padded copies of each piece, and the tier's products of
    pieces sum exactly the dense float64 contraction of those products
    (rtol 1e-9).  ragged_ring: hop 512, Kw 5000 (off the 32-row step), N 20,
    P short, every (row, k, column) term taken once."""
    if recipe == "ragged_ring":
        (padded, kernels), hop, t = _ragged(), 512, 7
    else:
        cfg = CQTConfig() if recipe == "train" else CQTConfig.serving_cnn()
        padded, kernels, t = _case(cfg, 4 if recipe == "train" else 1, seed=5)
        hop = cfg.hop_length
    assert cqt_cuda.frame_gemm_route(precision, hop) == "ring"
    got, cover = _emulate_mma_kernel(padded, kernels, hop, t, count=recipe == "ragged_ring",
                                     precision=precision)
    if cover is not None:
        assert cover.min() == 1 and cover.max() == 1
    want = _dense_pieces(padded, kernels, hop, t, precision)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12 * np.abs(want).max())


def test_pieces_are_the_plain_split_and_hold_fp32():
    """bf16x3's two pieces are ops/cqt.py::split_bf16's hi and lo, bit for
    bit; highest's three pieces add up to the fp32 value exactly, over a
    wide range of magnitudes."""
    rng = np.random.default_rng(11)
    v = (rng.standard_normal(50000) * 10.0 ** rng.uniform(-20, 20, 50000)).astype(np.float32)
    hi, lo = split_bf16(torch.from_numpy(v))
    two = _pieces(v, 2)
    assert np.array_equal(two[0], hi.double().numpy()) and np.array_equal(two[1], lo.double().numpy())
    three = _pieces(v, 3)
    assert np.array_equal(three[0] + three[1] + three[2], v.astype(np.float64))


@pytest.mark.parametrize("recipe", ["train", "ragged_ring"])
def test_highest_products_hold_fp32_accuracy(recipe):
    """The six products of highest's pieces differ from the float64
    contraction of the fp32 operands by the three dropped products only:
    per window under 1e-6 of max|ref| (fp32's own unit roundoff is 6e-8;
    the products' long sum in fp32 is the kernel's only other error)."""
    if recipe == "ragged_ring":
        (padded, kernels), hop, t = _ragged(12), 512, 7
    else:
        cfg = CQTConfig()
        padded, kernels, t = _case(cfg, 4, seed=6)
        hop = cfg.hop_length
    kw = kernels.shape[0]
    full = np.pad(padded, ((0, 0), (0, max(0, (t - 1) * hop + kw - padded.shape[1])))).astype(np.float64)
    exact = np.stack([full[:, i * hop : i * hop + kw] @ kernels.astype(np.float64)
                      for i in range(t)], axis=1)
    six = _dense_pieces(padded, kernels, hop, t, "highest")
    rel = np.abs(six - exact).max(axis=(1, 2)) / np.abs(exact).max(axis=(1, 2))
    assert rel.max() < 1e-6, rel.max()


def test_split_tier_routes_and_splits():
    """Every tier runs on the tensor cores at the training recipe's hop
    1024, serving_cnn's 512 and hop 1000; highest and bf16x3 keep the SIMT
    kernel at a hop off the 8-grid (333).  The ring kernels hold one CTA an
    SM at the split tiers, so the training recipe's 36 tiles take 11 depth
    ranges (396 CTAs: three full waves on 132 SMs); serving_cnn's 130 tiles
    one."""
    for hop in (1024, 512, 1000):
        assert {cqt_cuda.frame_gemm_route(p, hop) for p in PRECISIONS} == {"ring"}
    assert [cqt_cuda.frame_gemm_route(p, 333) for p in PRECISIONS] == ["simt", "simt",
                                                                        "fp32_loads"]
    for p in SPLIT_TIERS:
        assert cqt_cuda.frame_gemm_tile(p, ring=True) == (128, 96, 32)
        assert cqt_cuda.frame_gemm_splits(256 * 9, 192, 23552, p, ring=True) == 11
        assert cqt_cuda.frame_gemm_splits(64 * 130, 168, 6144, p, ring=True) == 1
        ranges = cqt_cuda.frame_gemm_ranges(23552, 11, p, ring=True)
        assert ranges[0] == (0, 2144) and ranges[-1] == (21440, 23552)
    assert cqt_cuda.frame_gemm_copies(6000, 7, 512, 5000, 20, "highest") == (8096, 5024, 96)
    assert cqt_cuda.frame_gemm_copies(6000, 7, 333, 5000, 20, "highest") is None
