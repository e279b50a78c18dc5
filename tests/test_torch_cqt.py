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


# ------------------------------------------ default tier: tensor-core plan

def _emulate_mma_kernel(cfg, x):
    """float64 NumPy walk of csrc/cqt.cu's cqt_mma_kernel at the default
    tier: one CTA per (window block, frame tile), its windows' bf16 audio
    staged at the skewed positions, the A fragments read back at the
    ldmatrix (or 16-bit) addresses, then band by band: each unit's pieces
    of the band's chunks over the fragment-order filter blocks of each
    group whose span holds the chunk, the pieces' sums added in order ->
    s = |CQT|^p, [B, F, T]."""
    fb = make_filterbank(cfg)
    batch, n = x.shape
    plan = cqt_cuda.make_mma_plan(fb, cfg, n, torch.device("cpu"))
    geom, sh, hop, skew, t_all = plan.geom, plan.shape, plan.hop, plan.skew, plan.n_frames
    ldm = hop % 8 == 0
    blocks = ((plan.filt.numpy().view(np.uint16).astype(np.uint32) << 16)
              .view(np.float32).astype(np.float64))  # [blocks, 32, 4]
    lane = np.arange(32)
    k_of = 2 * (lane % 4)[:, None] + np.array([0, 1, 8, 9])[None, :]
    dense_blk = np.zeros((len(blocks), 16, 8))
    dense_blk[:, k_of, np.broadcast_to((lane // 4)[:, None], (32, 4))] = blocks
    xr = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).double().numpy()
    out = np.full((batch, cfg.n_bins, t_all), np.nan)
    w_n, tf, gsz = sh.windows, sh.frames, cqt_cuda.MMA_BAND_GROUPS
    assert len(sh.pieces) == geom.n_bands and min(sh.pieces) >= 1
    assert sh.part_off + sh.units * cqt_cuda.MMA_PART_BYTES == sh.smem_bytes
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
        big = 2 * (sh.windows * sh.wstride + 8)
        assert sh.part_off >= big
        sbuf = np.full(w_n * sh.wstride + 8, np.nan)
        zero = w_n * sh.wstride
        sbuf[zero : zero + 8] = 0.0
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
                v = xr[min(b, batch - 1), np.where(m >= n, period - m, m)]
            else:
                # outside [i_lo, i_hi) the staged value is 0: the padding
                assert np.all((a_idx >= 0) & (a_idx < n) | ~audio)
                v = xr[min(b, batch - 1), np.clip(a_idx, 0, n - 1)]
            sbuf[w * sh.wstride + pos] = np.where(audio & (b < batch), v, 0.0)
        rows = w_n * tf
        r = np.arange(sh.row_units * cqt_cuda.MMA_UNIT_ROWS)
        roff = np.where(r < rows, (r % tf) * hop - i0, -(1 << 29))
        wbase = np.where(r < rows, (r // tf) * sh.wstride, 0)
        for band in range(geom.n_bands):
            kp = sh.pieces[band]
            c_a, c_b = cqt_cuda.mma_tile_chunks(geom, band=band, **clip)
            assert c_s <= c_a <= c_b <= c_e
            nc = c_b - c_a
            part = np.zeros((kp, sh.row_units * cqt_cuda.MMA_UNIT_ROWS, gsz, 4, 2))
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
                a = sbuf[at]  # [chunks, rows, 16]
                for gi in range(gsz):
                    g = band * gsz + gi
                    if g >= geom.n_groups:
                        continue
                    live = (c >= geom.c_lo[g]) & (c < geom.c_hi[g])
                    if live.any():
                        blk = dense_blk[geom.blk_off[g] + c[live] - geom.c_lo[g]]
                        part[q, :, gi] = np.einsum("crk,ckn->rn", a[live], blk).reshape(-1, 4, 2)
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
    fb_default = CQTFrontend(CQTConfig(precision="default"))
    fb_highest = CQTFrontend(CQTConfig())
    cpu = torch.device("cpu")
    assert isinstance(fb_default.kernel_plan(8820, cpu), cqt_cuda.MmaPlan)
    assert isinstance(fb_highest.kernel_plan(8820, cpu), cqt_cuda.KernelPlan)
    # a CPU tensor takes the plain version: no launch is counted
    x = torch.from_numpy(_windows(fb_default.cfg, 2, seed=6))
    before = (cqt_cuda.launches, cqt_cuda.mma_launches)
    assert torch.equal(fb_default(x), fb_default.plain(x))
    assert (cqt_cuda.launches, cqt_cuda.mma_launches) == before
