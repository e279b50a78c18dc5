"""The port's CQT (plain version, kernel plan, wrapper) held to the JAX
package's CQT on the same NumPy inputs.

Tolerances are the JAX package's own (tests/test_cqt.py):
- 0.02 dB on cells >= 0.5 dB from the gate, for two fp32 formulations at
  ``highest`` (test_cqt.py:214-224): summation order differs;
- 0.15 dB off the gate boundary against the float64 golden fixture
  (test_cqt.py:385-395);
- zero gate flips and 2e-3 dB where neither side is gated, for two
  formulations at the same reduced precision (test_cqt.py:260,317-319).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu.config import CQTConfig as JaxCQTConfig
from guitar_tablature_classification_tpu.ops import CQTFrontend as JaxCQTFrontend
from guitar_tablature_classification_tpu.ops import make_filterbank as jax_make_filterbank
from guitar_tablature_classification_tpu.ops import reflect_index as jax_reflect_index
from guitar_tablature_classification_tpu.ops.cqt import split_geometry as jax_split_geometry
from guitar_tablature_classification_tpu_torch.config import CQTConfig
from guitar_tablature_classification_tpu_torch.ops import cqt_cuda
from guitar_tablature_classification_tpu_torch.ops.cqt import (
    CQTFrontend,
    reflect_index,
    split_bf16,
    split_geometry,
)
from guitar_tablature_classification_tpu_torch.ops.cqt_kernels import (
    make_filterbank,
    n_frames_for,
    pad_np,
)

# name -> field overrides, applied to both packages' CQTConfig
RECIPES = {
    "train": {},
    "serving_cnn_0.5s": dict(
        sample_rate=22050, hop_length=512, n_bins=84,
        fmin=65.40639132514966, window_seconds=0.5, hop_seconds=0.25,
    ),
    "reflect": dict(pad_mode="reflect"),
    "hop1000": dict(hop_length=1000, window_seconds=0.25, hop_seconds=0.125),
}


def _cfgs(name, **extra):
    kw = {**RECIPES[name], **extra}
    return (dataclasses.replace(JaxCQTConfig(), **kw),
            dataclasses.replace(CQTConfig(), **kw))


def _windows(cfg, batch, seed):
    """Guitar-range tones plus noise, and one pure-noise window."""
    rng = np.random.default_rng(seed)
    t = np.arange(cfg.window_samples) / cfg.sample_rate
    out = []
    for i in range(batch - 1):
        f = 60.0 * (2000.0 / 60.0) ** rng.random(3)
        x = sum(a * np.sin(2 * np.pi * fi * t) for a, fi in zip(rng.random(3), f))
        out.append(x + 0.01 * rng.standard_normal(t.shape))
    out.append(0.1 * rng.standard_normal(t.shape))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("name", list(RECIPES))
def test_filterbank_bit_equal(name):
    jcfg, cfg = _cfgs(name)
    want, got = jax_make_filterbank(jcfg), make_filterbank(cfg)
    assert np.array_equal(got.stacked(), want.stacked())
    assert np.array_equal(got.lengths, want.lengths)
    assert got.kernel_width == want.kernel_width


@pytest.mark.parametrize("name", list(RECIPES) + ["serving_cnn_3s"])
def test_split_geometry_equal(name):
    if name == "serving_cnn_3s":
        jcfg, cfg = JaxCQTConfig.serving_cnn(), CQTConfig.serving_cnn()
    else:
        jcfg, cfg = _cfgs(name)
    got = split_geometry(make_filterbank(cfg), cfg, cfg.window_samples)
    want = jax_split_geometry(jax_make_filterbank(jcfg), jcfg, jcfg.window_samples)
    assert got == want
    assert np.array_equal(reflect_index(cfg.window_samples, 3000),
                          jax_reflect_index(jcfg.window_samples, 3000))


@pytest.mark.parametrize("name", ["train", "serving_cnn_0.5s", "reflect"])
def test_plain_highest_matches_jax(name):
    jcfg, cfg = _cfgs(name)
    x = _windows(cfg, 4, seed=1)
    want = np.asarray(JaxCQTFrontend(jcfg, use_pallas=False)(x))
    got = CQTFrontend(cfg)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, cfg.n_bins, cfg.n_frames)
    boundary = np.abs(want - cfg.gate_threshold_db) < 0.5
    np.testing.assert_allclose(got[~boundary], want[~boundary], atol=0.02)


def test_plain_matches_golden_fixture():
    path = os.path.join(os.path.dirname(__file__), "data", "cqt_golden.npz")
    data = np.load(path)
    got = CQTFrontend(CQTConfig())(torch.from_numpy(data["input"])).numpy()
    want = data["output"]
    boundary = np.abs(want + 60.0) < 0.5
    np.testing.assert_allclose(got[~boundary], want[~boundary], atol=0.15)


@pytest.mark.parametrize("precision", ["bf16x3", "default"])
@pytest.mark.parametrize("name", ["train", "serving_cnn_0.5s", "reflect"])
def test_plain_low_precision_matches_interpret_kernel(name, precision):
    """At bf16x3/default only the Pallas kernel (interpret mode) shows the
    bf16 operand rounding: JAX's XLA path at Precision.DEFAULT computes
    in fp32 on the CPU."""
    jcfg, cfg = _cfgs(name, precision=precision)
    x = _windows(cfg, 4, seed=2)
    want = np.asarray(
        JaxCQTFrontend(jcfg, use_pallas=True, pallas_interpret=True)(x)
    )
    got = CQTFrontend(cfg)(torch.from_numpy(x)).numpy()
    gate = cfg.gate_floor_db
    assert np.sum((got == gate) != (want == gate)) == 0
    both = (got != gate) & (want != gate)
    np.testing.assert_allclose(got[both], want[both], atol=2e-3)


def _emulate_kernel(cfg, x):
    """float64 NumPy walk of csrc/cqt.cu's tiles, row clipping and work
    items over the packed filterbank -> s = |CQT|^p, [B, F, T]."""
    fb = make_filterbank(cfg)
    n = x.shape[1]
    plan = cqt_cuda.make_plan(fb, cfg, n, torch.device("cpu"))
    geom = cqt_cuda.kernel_geometry(fb)
    packed = cqt_cuda.pack_filter(fb, geom, "highest").astype(np.float64)
    g_n, tt, t = cqt_cuda.GROUP, plan.tile_frames, plan.n_frames
    out = np.zeros((x.shape[0], cfg.n_bins, t))
    for b in range(x.shape[0]):
        for t0 in range(0, t, tt):
            k_lo, k_hi = cqt_cuda.tile_rows(
                geom, reflect=plan.reflect, pad=plan.pad, hop=plan.hop,
                num_samples=n, t0=t0, tile_frames=tt,
            )
            buf_len = (tt - 1) * plan.hop + max(k_hi - k_lo, 0)
            assert buf_len <= plan.buf_cap
            src = t0 * plan.hop + k_lo - plan.pad + np.arange(buf_len)
            if plan.reflect:
                period = 2 * (n - 1)
                m = np.mod(src, period)
                buf = x[b, np.where(m >= n, period - m, m)]
            else:
                ok = (src >= 0) & (src < n)
                buf = np.where(ok, x[b, np.clip(src, 0, n - 1)], 0.0)
            for g in range(geom.n_groups):
                acc = np.zeros((tt, 2 * g_n))
                start = geom.group_item_start[g]
                for it in range(start, start + geom.group_item_count[g]):
                    assert geom.item_group[it] == g
                    k0 = max(geom.item_k0[it], k_lo)
                    k1 = min(geom.item_k1[it], k_hi)
                    ks = np.arange(k0, k1)
                    rows = packed[geom.group_off[g] + ks - geom.group_lo[g]]
                    for j in range(tt):
                        acc[j] += buf[j * plan.hop + ks - k_lo] @ rows
                for j in range(g_n):
                    f = g * g_n + j
                    for i in range(tt):
                        if f < cfg.n_bins and t0 + i < t:
                            mag2 = acc[i, j] ** 2 + acc[i, g_n + j] ** 2
                            out[b, f, t0 + i] = mag2 ** (cfg.magnitude_power / 2)
    return out


@pytest.mark.parametrize("name", list(RECIPES))
def test_kernel_plan_covers_every_nonzero_term(name):
    """The kernel's plan (packed filterbank, row clipping per tile, work
    items) sums exactly the dense contraction's nonzero terms."""
    _, cfg = _cfgs(name)
    x = _windows(cfg, 2, seed=3).astype(np.float64)
    got = _emulate_kernel(cfg, x)
    fb = make_filterbank(cfg)
    padded = pad_np(x, fb.kernel_width // 2, cfg.pad_mode)
    t = n_frames_for(x.shape[1], cfg.hop_length)
    frames = np.stack([
        padded[:, i * cfg.hop_length : i * cfg.hop_length + fb.kernel_width]
        for i in range(t)
    ], axis=1)
    coeff = frames @ fb.stacked().astype(np.float64)
    mag2 = coeff[..., : cfg.n_bins] ** 2 + coeff[..., cfg.n_bins :] ** 2
    want = (mag2 ** (cfg.magnitude_power / 2)).transpose(0, 2, 1)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12 * want.max())


def test_pack_filter_tiers():
    cfg = CQTConfig()
    fb = make_filterbank(cfg)
    geom = cqt_cuda.kernel_geometry(fb)
    hi = cqt_cuda.pack_filter(fb, geom, "highest")
    default = cqt_cuda.pack_filter(fb, geom, "default")
    split = cqt_cuda.pack_filter(fb, geom, "bf16x3")
    g = cqt_cuda.GROUP
    assert hi.shape == (int((geom.group_hi - geom.group_lo).sum()), 2 * g)
    bf16 = torch.from_numpy(hi).to(torch.bfloat16).float().numpy()
    assert np.array_equal(default, bf16)
    assert np.array_equal(split[:, :g], bf16[:, :g])
    assert np.array_equal(split[:, 2 * g : 3 * g], bf16[:, g:])
    np.testing.assert_allclose(split[:, :g] + split[:, g : 2 * g], hi[:, :g],
                               rtol=2**-15, atol=0)
    # the packed spans hold every nonzero filter value exactly once
    assert np.count_nonzero(hi) == (
        np.count_nonzero(fb.kernels_real) + np.count_nonzero(fb.kernels_imag)
    )


@pytest.mark.parametrize("name", list(RECIPES))
def test_bound_counts_match_dense_count(name):
    """needed_macs and needed_filter_values (the terms of chip_smoke.py's
    bound) equal a dense count of nonzero filter entries that meet audio."""
    _, cfg = _cfgs(name)
    fb = make_filterbank(cfg)
    n, hop = cfg.window_samples, cfg.hop_length
    t, pad = n_frames_for(n, hop), fb.kernel_width // 2
    lo, hi = cqt_cuda.bin_rows(fb)
    k = np.arange(fb.kernel_width)[:, None]
    span = (k >= lo) & (k < hi)  # [K, F]
    if cfg.pad_mode == "reflect":
        meets = np.ones((t, fb.kernel_width), bool)
    else:
        rows = np.arange(t)[:, None] * hop + k[:, 0]
        meets = (rows >= pad) & (rows < pad + n)  # [T, K]
    macs = sum(int((span & m[:, None]).sum()) for m in meets)
    assert cqt_cuda.needed_macs(fb, cfg, n) == 2 * macs
    values = int((span & meets.any(axis=0)[:, None]).sum())
    assert cqt_cuda.needed_filter_values(fb, cfg, n) == 2 * values


def test_wrapper_sends_cpu_tensors_to_plain_version():
    fe = CQTFrontend(CQTConfig(precision="default"))
    x = torch.from_numpy(_windows(fe.cfg, 3, seed=4))
    before = cqt_cuda.launches
    got = cqt_cuda.cqt_fused(x, fe)
    assert cqt_cuda.launches == before
    assert torch.equal(got, fe.plain(x))
    assert fe(x[0]).shape == (96, 9)  # 1-D input squeezes back


# ------------------------------------------------- tensor-core plan

def _pieces(arr, parts):
    """The kernel's bf16 pieces of fp32 values (csrc/frame_mma.cuh
    take_piece): piece p = bf16(v), then v -= piece in fp32 (exact), as
    float64 arrays."""
    v = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    out = []
    for _ in range(parts):
        piece = v.to(torch.bfloat16).float()
        out.append(piece.double().numpy())
        v = v - piece
    return out


def _emulate_mma_kernel(cfg, x, products=None):
    """float64 NumPy walk of csrc/cqt.cu's cqt_mma_kernel at the tier of
    ``cfg``: one CTA per (window block, frame tile), its windows' audio
    staged as the tier's bf16 pieces (one copy a piece, each with its zero
    block) at the skewed positions, the A fragments of each piece read back
    at the ldmatrix (or 16-bit) addresses, then band by band: each unit's
    pieces of the band's chunks over the fragment-order filter blocks of
    each piece and each group whose span holds the chunk, each chunk's
    products of pieces (``products``, else the tier's
    cqt_cuda.FRAME_GEMM_PRODUCTS) summed and added into the unit's total in
    chunk order, the units' sums added in order -> s = |CQT|^p, [B, F, T]."""
    fb = make_filterbank(cfg)
    batch, n = x.shape
    plan = cqt_cuda.make_mma_plan(fb, cfg, n, torch.device("cpu"))
    geom, sh, hop, skew, t_all = plan.geom, plan.shape, plan.hop, plan.skew, plan.n_frames
    parts = sh.parts
    assert parts == cqt_cuda.FRAME_GEMM_PARTS[cfg.precision]
    products = cqt_cuda.FRAME_GEMM_PRODUCTS[cfg.precision] if products is None else products
    ldm = hop % 8 == 0
    assert ldm or parts == 1
    blocks = ((plan.filt.numpy().view(np.uint16).astype(np.uint32) << 16)
              .view(np.float32).astype(np.float64))  # [parts * blocks, 32, 4]
    assert len(blocks) == parts * plan.piece_blocks
    lane = np.arange(32)
    k_of = 2 * (lane % 4)[:, None] + np.array([0, 1, 8, 9])[None, :]
    dense_blk = np.zeros((len(blocks), 16, 8))
    dense_blk[:, k_of, np.broadcast_to((lane // 4)[:, None], (32, 4))] = blocks
    dense_blk = dense_blk.reshape(parts, plan.piece_blocks, 16, 8)
    xr = _pieces(x, parts)
    out = np.full((batch, cfg.n_bins, t_all), np.nan)
    w_n, tf, gsz = sh.windows, sh.frames, cqt_cuda.MMA_BAND_GROUPS
    pst = sh.piece_stride
    assert pst == w_n * sh.wstride + 8 and sh.warps == cqt_cuda.mma_warps(parts)
    assert len(sh.pieces) == geom.n_bands and min(sh.pieces) >= 1
    assert sh.part_off + sh.units * sh.part_bytes == sh.smem_bytes
    assert sh.smem_bytes <= cqt_cuda.MMA_SMEM_BUDGET
    assert np.array_equal(plan.gmeta.numpy(), np.concatenate([geom.meta(), sh.pieces]))
    n_ft = -(-t_all // tf)
    assert plan.n_ctas(batch) == n_ft * -(-batch // w_n)
    for cta in range(plan.n_ctas(batch)):
        t0, b0 = (cta % n_ft) * tf, (cta // n_ft) * w_n
        clip = dict(reflect=plan.reflect, pad=plan.pad, hop=hop, num_samples=n, t0=t0,
                    frames=tf)
        c_s, c_e = cqt_cuda.mma_tile_chunks(geom, **clip)
        i0, i1, i_lo, i_hi = cqt_cuda.mma_stage_span(geom, **clip)
        assert i0 % 8 == 0 and i1 % 8 == 0 and i0 <= i_lo <= i_hi <= i1
        assert sh.part_off >= 2 * parts * pst
        sbuf = np.full(parts * pst, np.nan)
        zero = w_n * sh.wstride
        for p in range(parts):
            sbuf[p * pst + zero : p * pst + zero + 8] = 0.0
        d = np.arange(i1 - i0)
        i = i0 + d
        a_idx = t0 * hop + 16 * c_s - plan.pad + i
        pos = d + (skew * (d // hop) if ldm else 0)
        assert len(d) == 0 or pos.max() < sh.wstride
        audio = (i >= i_lo) & (i < i_hi)
        for w in range(w_n):
            b = b0 + w
            if plan.reflect:
                period = 2 * (n - 1)
                m = np.mod(a_idx, period)
                src = np.where(m >= n, period - m, m)
            else:
                # outside [i_lo, i_hi) the staged value is 0: the padding
                assert np.all((a_idx >= 0) & (a_idx < n) | ~audio)
                src = np.clip(a_idx, 0, n - 1)
            for p in range(parts):
                v = xr[p][min(b, batch - 1), src]
                sbuf[p * pst + w * sh.wstride + pos] = np.where(audio & (b < batch), v, 0.0)
        rows = w_n * tf
        r = np.arange(sh.row_units * sh.unit_rows)
        roff = np.where(r < rows, (r % tf) * hop - i0, -(1 << 29))
        wbase = np.where(r < rows, (r // tf) * sh.wstride, 0)
        for band in range(geom.n_bands):
            kp = sh.pieces[band]
            c_a, c_b = cqt_cuda.mma_tile_chunks(geom, band=band, **clip)
            assert c_s <= c_a <= c_b <= c_e
            nc = c_b - c_a
            part = np.zeros((kp, sh.row_units * sh.unit_rows, gsz, 4, 2))
            for q in range(kp):
                ca, cb = c_a + (q * nc) // kp, c_a + ((q + 1) * nc) // kp
                if cb <= ca:
                    continue
                c = np.arange(ca, cb)
                kk = np.arange(16)
                if ldm:  # each 8-sample run: the skew of its first sample, or the zeros
                    run = (roff[None, :, None] + 16 * (c - c_s)[:, None, None]
                           + 8 * (kk // 8)[None, None, :])  # [chunks, rows, 16]
                    assert np.all(run % 8 == 0)  # 16-byte aligned, inside one skew block
                    inside = (run >= 0) & (run < i1 - i0)
                    at = np.where(inside, wbase[None, :, None] + run
                                  + skew * (np.maximum(run, 0) // hop), zero) + kk % 8
                else:  # each value on its own, zero outside [i0, i1)
                    dd = roff[None, :, None] + 16 * (c - c_s)[:, None, None] + kk[None, None, :]
                    inside = (dd >= 0) & (dd < i1 - i0)
                    at = np.where(inside, wbase[None, :, None] + dd, zero)
                a = [sbuf[at + p * pst] for p in range(parts)]  # [chunks, rows, 16] a piece
                for gi in range(gsz):
                    g = band * gsz + gi
                    if g >= geom.n_groups:
                        continue
                    live = (c >= geom.c_lo[g]) & (c < geom.c_hi[g])
                    if live.any():
                        blk = dense_blk[:, geom.blk_off[g] + c[live] - geom.c_lo[g]]
                        sums = sum(np.einsum("crk,ckn->crn", a[pa][live], blk[pb])
                                   for pa, pb in products)  # each chunk's products
                        unit_total = np.zeros(sums.shape[1:])
                        for chunk_sum in sums:  # into the unit's total, chunk by chunk
                            unit_total = unit_total + chunk_sum
                        part[q, :, gi] = unit_total.reshape(-1, 4, 2)
            total = part[0]
            for q in range(1, kp):
                total = total + part[q]
            s = (total[..., 0] ** 2 + total[..., 1] ** 2) ** (cfg.magnitude_power / 2)
            for row in range(rows):
                b, t = b0 + row // tf, t0 + row % tf
                if b >= batch or t >= t_all:
                    continue
                f = 4 * band * gsz + np.arange(4 * gsz)
                keep = f < cfg.n_bins
                assert np.all(np.isnan(out[b, f[keep], t]))
                out[b, f[keep], t] = s[row].reshape(-1)[keep]
    assert not np.isnan(out).any()
    return out


def _mma_cfg(name):
    if name == "serving_cnn_3s":
        return dataclasses.replace(CQTConfig.serving_cnn(), precision="default")
    if name == "hop333":
        return dataclasses.replace(CQTConfig(), hop_length=333, precision="default")
    return _cfgs(name, precision="default")[1]


@pytest.mark.parametrize("name", list(RECIPES) + ["serving_cnn_3s", "hop333"])
def test_mma_plan_matches_dense_bf16_contraction(name):
    """The default tier's tile plan (fragment-order bf16 filter, bands,
    window blocks, frame tiles, chunk pieces, skewed staging) sums exactly
    the dense contraction of the bf16-rounded operands.  Three windows:
    not a multiple of any band's windows per CTA."""
    cfg = _mma_cfg(name)
    x = _windows(cfg, 3, seed=5)
    got = _emulate_mma_kernel(cfg, x)
    fb = make_filterbank(cfg)
    xr = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    padded = pad_np(xr, fb.kernel_width // 2, cfg.pad_mode)
    t = n_frames_for(x.shape[1], cfg.hop_length)
    kern = torch.from_numpy(fb.stacked()).to(torch.bfloat16).double().numpy()
    coeff = np.stack([
        padded[:, i * cfg.hop_length : i * cfg.hop_length + fb.kernel_width] @ kern
        for i in range(t)
    ], axis=1)
    mag2 = coeff[..., : cfg.n_bins] ** 2 + coeff[..., cfg.n_bins :] ** 2
    want = (mag2 ** (cfg.magnitude_power / 2)).transpose(0, 2, 1)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12 * want.max())


def _unpack_filter_mma(packed, geom, kernel_width, n_bins):
    """Inverse of cqt_cuda.pack_filter_mma: float32 re and im [Kw, n_bins],
    and how often each (row, column) was packed."""
    lane = np.arange(32)
    k_of = 2 * (lane % 4)[:, None] + np.array([0, 1, 8, 9])[None, :]
    n_of = np.broadcast_to((lane // 4)[:, None], (32, 4))
    rows = max(int(geom.c_hi.max()) * 16, kernel_width)
    f32 = (packed.astype(np.uint32) << 16).view(np.float32)
    dense = np.zeros((rows, 8 * geom.n_groups), np.float32)
    seen = np.zeros(dense.shape, np.int64)
    for g in range(geom.n_groups):
        c = np.arange(geom.c_lo[g], geom.c_hi[g])
        k = 16 * c[:, None, None] + k_of[None]
        n_idx = np.broadcast_to(8 * g + n_of[None], k.shape)
        dense[k, n_idx] = f32[geom.blk_off[g] : geom.blk_off[g] + len(c)]
        np.add.at(seen, (k, n_idx), 1)
    re = dense[:kernel_width, 0::2][:, :n_bins]
    im = dense[:kernel_width, 1::2][:, :n_bins]
    return re, im, seen


@pytest.mark.parametrize("name", list(RECIPES) + ["serving_cnn_3s"])
def test_mma_packed_filter_is_the_rounded_filterbank_once(name):
    cfg = _mma_cfg(name)
    fb = make_filterbank(cfg)
    geom = cqt_cuda.mma_geometry(fb)
    packed = cqt_cuda.pack_filter_mma(fb, geom)
    assert packed.dtype == np.uint16 and packed.shape[1:] == (32, 4)
    assert packed.shape[0] == int((geom.c_hi - geom.c_lo).sum())
    assert packed.nbytes < 2 * 1024 * 1024
    re, im, seen = _unpack_filter_mma(packed, geom, fb.kernel_width, fb.n_bins)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()  # noqa: E731
    assert np.array_equal(re, bf(fb.kernels_real))
    assert np.array_equal(im, bf(fb.kernels_imag))
    assert seen.max() == 1
    nz = np.count_nonzero(fb.kernels_real) + np.count_nonzero(fb.kernels_imag)
    assert np.count_nonzero(packed) == nz


@pytest.mark.parametrize("name", list(RECIPES) + ["serving_cnn_3s", "hop333"])
def test_mma_plan_fits_shared_memory(name):
    cfg = _mma_cfg(name)
    fb = make_filterbank(cfg)
    plan = cqt_cuda.make_mma_plan(fb, cfg, cfg.window_samples, torch.device("cpu"))
    sh = plan.shape
    assert sh.smem_bytes <= cqt_cuda.MMA_SMEM_BUDGET
    assert plan.skew % 8 == 0 and (plan.hop % 8 == 0 or plan.skew == 0)
    assert sh.windows * sh.frames <= cqt_cuda.MMA_MAX_ROWS
    assert sh.wstride % 8 == 0 and sh.part_off % 16 == 0
    # the staged windows, then each unit's partial sums
    assert sh.part_off >= 2 * sh.windows * sh.wstride
    assert sh.smem_bytes == sh.part_off + sh.units * cqt_cuda.MMA_PART_BYTES
    assert cqt_cuda.mma_geometry(fb).nested()


def test_frontend_plans_by_tier():
    """The plan of the kernel the route picks (cqt_cuda.cqt_route): at the
    training recipe's hop 1024, default and bf16x3 take the tensor-core
    plan with the tier's pieces at any batch, highest the SIMT plan at the
    flagship's B=256 and the tensor-core plan at B=4096; at hop 333
    highest and bf16x3 take the SIMT plan, default the tensor-core one."""
    fb_default = CQTFrontend(CQTConfig(precision="default"))
    cpu = torch.device("cpu")

    def plan(fe, batch):
        return fe.kernel_plan(8820, cpu, fe.route(batch, 8820, cpu))

    for precision, parts in cqt_cuda.FRAME_GEMM_PARTS.items():
        fe = CQTFrontend(CQTConfig(precision=precision))
        assert isinstance(plan(fe, 4096), cqt_cuda.MmaPlan)
        assert plan(fe, 4096).shape.parts == parts
        want = cqt_cuda.KernelPlan if precision == "highest" else cqt_cuda.MmaPlan
        assert isinstance(plan(fe, 256), want)
        off_grid = CQTFrontend(dataclasses.replace(CQTConfig(), hop_length=333,
                                                   precision=precision))
        want = cqt_cuda.MmaPlan if precision == "default" else cqt_cuda.KernelPlan
        for batch in (1, 4096):
            assert isinstance(plan(off_grid, batch), want)
    # a CPU tensor takes the plain version: no launch is counted
    x = torch.from_numpy(_windows(fb_default.cfg, 2, seed=6))
    before = (cqt_cuda.launches, cqt_cuda.mma_launches)
    assert torch.equal(fb_default(x), fb_default.plain(x))
    assert (cqt_cuda.launches, cqt_cuda.mma_launches) == before


# ------------------------------ highest and bf16x3 on the tensor cores

SPLIT_TIERS = ("highest", "bf16x3")
SPLIT_RECIPES = ("train", "serving_cnn_0.5s", "reflect", "hop1000", "serving_cnn_3s")


def _tier_cfg(name, precision):
    return dataclasses.replace(_mma_cfg(name), precision=precision)


def _dense_products(cfg, x, exact=False):
    """s = |CQT|^p, [B, F, T], of the dense float64 contraction of the
    tier's products of bf16 pieces of the audio and of the filterbank (with
    ``exact``, of the fp32 operands themselves)."""
    fb = make_filterbank(cfg)
    if exact:
        a, k, products = [x.astype(np.float64)], [fb.stacked().astype(np.float64)], ((0, 0),)
    else:
        parts = cqt_cuda.FRAME_GEMM_PARTS[cfg.precision]
        a, k = _pieces(x, parts), _pieces(fb.stacked(), parts)
        products = cqt_cuda.FRAME_GEMM_PRODUCTS[cfg.precision]
    kw, hop = fb.kernel_width, cfg.hop_length
    padded = [pad_np(p, kw // 2, cfg.pad_mode) for p in a]
    t = n_frames_for(x.shape[1], hop)
    coeff = sum(np.stack([padded[pa][:, i * hop : i * hop + kw] @ k[pb] for i in range(t)],
                         axis=1) for pa, pb in products)
    mag2 = coeff[..., : cfg.n_bins] ** 2 + coeff[..., cfg.n_bins :] ** 2
    return (mag2 ** (cfg.magnitude_power / 2)).transpose(0, 2, 1)


@pytest.mark.parametrize("precision", SPLIT_TIERS)
@pytest.mark.parametrize("name", SPLIT_RECIPES)
def test_mma_split_tier_plan_matches_dense_contraction(name, precision):
    """highest and bf16x3 on the tensor cores: the tier's plan (8 or 12
    warps, 32-row units, a staged copy and zero block for each bf16 piece of the audio,
    each piece's fragment-order filter, the tier's products of pieces, each
    chunk's products added into the unit's total) sums exactly the dense
    float64 contraction of the same products of the same pieces (rtol
    1e-9).  Three windows: a multiple of no plan's windows per CTA."""
    cfg = _tier_cfg(name, precision)
    x = _windows(cfg, 3, seed=5)
    got = _emulate_mma_kernel(cfg, x)
    want = _dense_products(cfg, x)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12 * want.max())


@pytest.mark.parametrize("fault", ["dropped_product", "bf16x3_products_at_highest"])
def test_mma_split_tier_walk_catches_planted_faults(fault):
    """The walk above fails a plan that drops highest's smallest product
    (lo*lo, 2^-16 of hi*hi), or that runs bf16x3's three products on
    highest's three pieces."""
    cfg = _tier_cfg("train", "highest")
    x = _windows(cfg, 3, seed=5)
    want = _dense_products(cfg, x)
    six = cqt_cuda.FRAME_GEMM_PRODUCTS["highest"]
    products = six[1:] if fault == "dropped_product" else cqt_cuda.FRAME_GEMM_PRODUCTS["bf16x3"]
    assert len(products) < len(six)
    got = _emulate_mma_kernel(cfg, x, products=products)
    assert not np.allclose(got, want, rtol=1e-9, atol=1e-12 * want.max())


@pytest.mark.parametrize("name", ["train", "reflect", "serving_cnn_3s"])
def test_mma_highest_holds_fp32_accuracy(name):
    """At highest the six products of the pieces differ from the float64
    contraction of the fp32 operands by the three dropped products only
    (each under 2^-24 of hi*hi a term): per window, max|s - s64| under
    1e-6 of max s64, where s = |CQT|^4 moves by four times the
    coefficients' relative error (fp32's unit roundoff is 6e-8; the
    kernel's fp32 sums are its only other error, held on the card)."""
    cfg = _tier_cfg(name, "highest")
    x = _windows(cfg, 3, seed=7)
    six = _dense_products(cfg, x)
    exact = _dense_products(cfg, x, exact=True)
    rel = np.abs(six - exact).max(axis=(1, 2)) / exact.max(axis=(1, 2))
    assert rel.max() < 1e-6, rel.max()


@pytest.mark.parametrize("precision", SPLIT_TIERS)
def test_mma_packed_pieces_are_the_split_filterbank_once(precision):
    """The packed filter holds the tier's pieces one after another, each in
    the fragment order with every value once: piece 0 is the default
    tier's filter bit for bit, pieces 0 and 1 are split_bf16's hi and lo,
    and highest's three pieces add up to the fp32 filterbank exactly."""
    cfg = _tier_cfg("train", precision)
    fb = make_filterbank(cfg)
    geom = cqt_cuda.mma_geometry(fb)
    parts = cqt_cuda.FRAME_GEMM_PARTS[precision]
    packed = cqt_cuda.pack_filter_mma(fb, geom, parts)
    n_blk = int((geom.c_hi - geom.c_lo).sum())
    assert packed.dtype == np.uint16 and packed.shape == (parts * n_blk, 32, 4)
    assert packed.nbytes < parts * 2 * 1024 * 1024
    assert np.array_equal(packed[:n_blk], cqt_cuda.pack_filter_mma(fb, geom))
    pieces = [_unpack_filter_mma(packed[p * n_blk : (p + 1) * n_blk], geom, fb.kernel_width,
                                 fb.n_bins) for p in range(parts)]
    assert all(seen.max() == 1 for *_, seen in pieces)
    for j, kern in enumerate((fb.kernels_real, fb.kernels_imag)):
        hi, lo = split_bf16(torch.from_numpy(kern))
        assert np.array_equal(pieces[0][j], hi.numpy())
        assert np.array_equal(pieces[1][j], lo.numpy())
        if parts == 3:
            total = sum(p[j].astype(np.float64) for p in pieces)
            assert np.array_equal(total, kern.astype(np.float64))


@pytest.mark.parametrize("precision", SPLIT_TIERS)
@pytest.mark.parametrize("name", SPLIT_RECIPES)
def test_mma_split_tier_plan_fits_shared_memory(name, precision):
    """Each split tier's CTA: 8 warps at highest, 12 at bf16x3, units of
    32 rows (two m16 tiles);
    its pieces' staged copies (each with its zero block), then the units'
    partial sums, inside the budget; at most two units a warp."""
    cfg = _tier_cfg(name, precision)
    fb = make_filterbank(cfg)
    plan = cqt_cuda.make_mma_plan(fb, cfg, cfg.window_samples, torch.device("cpu"))
    sh = plan.shape
    assert sh.parts == cqt_cuda.FRAME_GEMM_PARTS[precision]
    assert sh.warps == {"highest": 8, "bf16x3": 12}[precision]
    assert sh.smem_bytes <= cqt_cuda.MMA_SMEM_BUDGET
    assert sh.unit_rows == 32 and sh.part_bytes == 32 * 8 * cqt_cuda.MMA_BAND_GROUPS * 4
    assert sh.smem_bytes == sh.part_off + sh.units * sh.part_bytes
    assert sh.part_off >= 2 * sh.parts * sh.piece_stride and sh.part_off % 16 == 0
    assert sh.windows * sh.frames <= cqt_cuda.MMA_MAX_ROWS and sh.units <= 2 * sh.warps
    assert plan.filt.shape[0] == sh.parts * plan.piece_blocks


# highest's route at shapes timed on the card with both kernels
# (chip_smoke.py's CQT route sweep, H100): (recipe, batch, route, the
# faster kernel there).  hop 1000 at B=64 and 128 is a win the route gives
# up: its grid fills half a wave, where the training recipe's loses.
HIGHEST_ROUTES = [
    ("train", 64, "simt", "simt"), ("train", 256, "simt", "simt"),
    ("train", 384, "mma", "mma"), ("train", 512, "simt", "simt"),
    ("train", 768, "mma", "mma"), ("train", 1024, "mma", "mma"),
    ("train", 4096, "mma", "mma"),
    ("serving_cnn_3s", 16, "simt", "simt"), ("serving_cnn_3s", 32, "simt", "simt"),
    ("serving_cnn_3s", 64, "mma", "mma"), ("serving_cnn_3s", 256, "mma", "mma"),
    ("reflect", 64, "simt", "simt"), ("reflect", 512, "simt", "simt"),
    ("reflect", 4096, "simt", "simt"),
    ("hop1000", 64, "simt", "mma"), ("hop1000", 128, "simt", "mma"),
    ("hop1000", 256, "mma", "mma"), ("hop1000", 512, "mma", "mma"),
]


@pytest.mark.parametrize("name,batch,route,faster", HIGHEST_ROUTES)
def test_highest_route_at_measured_shapes(name, batch, route, faster):
    """highest takes the tensor cores where their grid fills its waves
    (cqt_cuda.MMA_MIN_FILL) with at least 2 windows a CTA: at every shape
    timed on the card the route picks the faster kernel, but for the two
    hop-1000 shapes it gives up."""
    cfg = _tier_cfg(name, "highest")
    plan = cqt_cuda.make_mma_plan(make_filterbank(cfg), cfg, cfg.window_samples,
                                  torch.device("cpu"))
    assert cqt_cuda.cqt_route("highest", cfg.hop_length, batch, plan) == route
    assert CQTFrontend(cfg).route(batch, cfg.window_samples, torch.device("cpu")) == route
    assert route == faster or (name, batch) in {("hop1000", 64), ("hop1000", 128)}


def test_cqt_route_by_tier_and_hop():
    """default and bf16x3 on the tensor cores at hops 1024 (training), 512
    (serving_cnn) and 1000 at any batch; highest and bf16x3 on the SIMT
    kernel at hop 333, default on the tensor cores there too; highest
    needs the tensor-core plan to be routed; the default tier's plan is
    the one it had before the split tiers came (its bits follow it)."""
    for hop in (1024, 512, 1000):
        for batch in (1, 256, 4096):
            assert {cqt_cuda.cqt_route(p, hop, batch) for p in ("bf16x3", "default")} == {
                "mma"}
        assert cqt_cuda.mma_takes("highest", hop)
    assert [cqt_cuda.cqt_route(p, 333, 4096) for p in ("highest", "bf16x3", "default")] == [
        "simt", "simt", "mma"]
    with pytest.raises(ValueError, match="tensor-core plan"):
        cqt_cuda.cqt_route("highest", 1024, 256)
    with pytest.raises(ValueError, match="multiple of 8"):
        cfg = dataclasses.replace(CQTConfig(), hop_length=333)
        cqt_cuda.make_mma_plan(make_filterbank(cfg), cfg, cfg.window_samples,
                               torch.device("cpu"))
    cfg = _mma_cfg("train")
    sh = cqt_cuda.make_mma_plan(make_filterbank(cfg), cfg, cfg.window_samples,
                                torch.device("cpu")).shape
    assert sh == cqt_cuda.MmaShape(5, 9, (8, 4, 2, 1, 1, 1), 8904, 89056, 228320)
