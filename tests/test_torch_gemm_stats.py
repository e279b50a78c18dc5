"""The port's stem-front GEMM with statistics (``ops/stem_tail.py::
gemm_stats_plain`` behind ``gemm_stats``) held to the JAX package's TPU
kernel ``ops/stem_pallas.py::_gemm_stats_pallas`` in interpret mode, and
to the port's own quadrant front, on the same NumPy inputs.

Tolerances, with their reasons:
- y: within one bf16 ulp (of the larger magnitude) plus 1e-5 of max|y|.
  Both sides round once from fp32 sums of the same exact products whose
  order differs, so a sum next to a rounding boundary may land one ulp
  away; the floor covers outputs near zero, where the fp32 order's error
  (about 70 eps of the products) exceeds a tiny value's ulp.
- sums: each side's sums within 1e-5 of max|sum| of the float64 column
  sums of its own y (fp32 summation order over 512 rows); across the two
  sides, the column sums of |y_port - y_jax| plus that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guitar_tablature_classification_tpu.ops import stem_fusion as jax_front
from guitar_tablature_classification_tpu.ops.stem_pallas import _gemm_stats_pallas
from guitar_tablature_classification_tpu_torch.ops import stem_cuda, stem_fusion, stem_tail
from guitar_tablature_classification_tpu_torch.tools import profile_stem_pieces

SUM_TOL = 1e-5


def bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The bf16 spacing at |a| (2^-7 on [1, 2))."""
    _, e = np.frexp(np.abs(a).astype(np.float32))
    return np.ldexp(np.float32(1.0), e - 8)


def assert_within_one_ulp(got: np.ndarray, want: np.ndarray) -> None:
    floor = 1e-5 * np.abs(want).max()
    limit = bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + floor
    assert np.all(np.abs(got - want) <= limit), np.abs(got - want).max()


def _sums_of(y: np.ndarray) -> np.ndarray:
    y64 = y.astype(np.float64)
    return np.stack([y64.sum(0), (y64 * y64).sum(0)])


def _operands(seed, m=512, k=70, n=896):
    rng = np.random.default_rng(seed)
    hq = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    sq = jnp.asarray(rng.standard_normal((k, n)) * 0.05, jnp.bfloat16)
    as_torch = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()  # noqa: E731
    return hq, sq, as_torch(hq), as_torch(sq)


def test_matches_pallas_interpret():
    hq, sq, thq, tsq = _operands(0)
    y_j, sums_j = _gemm_stats_pallas(hq, sq, interpret=True, m_tile=256)
    y_j, sums_j = np.asarray(y_j.astype(jnp.float32)), np.asarray(sums_j)
    y, sums = stem_tail.gemm_stats(thq, tsq, m_tile=256)
    assert y.dtype == torch.bfloat16 and sums.dtype == torch.float32
    assert tuple(y.shape) == (512, 896) and tuple(sums.shape) == (2, 896)
    y, sums = y.float().numpy(), sums.numpy()
    assert_within_one_ulp(y, y_j)
    for got, own in ((sums, y), (sums_j, y_j)):
        ref = _sums_of(own)
        assert np.all(np.abs(got - ref).max(1) <= SUM_TOL * np.abs(ref).max(1))
    diff = np.abs(y.astype(np.float64) - y_j)
    y_abs = np.maximum(np.abs(y), np.abs(y_j)).astype(np.float64)
    moved = np.stack([diff.sum(0), (diff * 2 * y_abs).sum(0)])
    assert np.all(np.abs(sums - sums_j) <= moved + SUM_TOL * np.abs(sums_j).max(1, keepdims=True))


@pytest.mark.parametrize("batch", [1, 3])
def test_real_front_operands_give_the_front(batch):
    """The quadrant front's own operands through gemm_stats_plain give
    precomposed_conv1_quadrant's bits, and the operands are the JAX
    front's (the JAX front's y within the front's bf16 tolerance)."""
    rng = np.random.default_rng(batch)
    x = rng.uniform(0, 1, (batch, 96, 9)).astype(np.float32)
    w = (rng.standard_normal((7, 7, 3, 64)) * 0.05).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    hq, sq = stem_fusion.quadrant_operands(tx, tw)
    assert tuple(hq.shape) == (batch, 2, 56, 70) and tuple(sq.shape) == (70, 7168)
    y, sums = stem_tail.gemm_stats(hq.reshape(-1, 70), sq, m_tile=112)
    yq = stem_fusion.precomposed_conv1_quadrant(tx, tw)
    assert torch.equal(y.reshape(yq.shape), yq)
    assert torch.equal(sums, stem_tail.gemm_stats_plain(hq.reshape(-1, 70), sq)[1])
    want = np.asarray(jax_front.precomposed_conv1_quadrant(
        jnp.asarray(x), jnp.asarray(w), dtype=jnp.bfloat16).astype(jnp.float32))
    assert_within_one_ulp(y.float().numpy().reshape(want.shape), want)
    # the per-lane sums fold to the stem tail's per-channel statistics
    per_channel = sums.double().reshape(2, -1, 64).sum(1)
    stats = stem_tail.stats_plain(yq).double()
    assert torch.allclose(per_channel, stats, rtol=SUM_TOL, atol=SUM_TOL * float(stats.abs().max()))


def test_m_tile_must_divide_m_and_cpu_launches_nothing():
    """The TPU grid M // m_tile leaves the last rows unwritten; the port
    raises instead, on every device."""
    _, _, thq, tsq = _operands(1, m=320)
    with pytest.raises(ValueError, match="not a multiple of m_tile=256"):
        stem_tail.gemm_stats(thq, tsq)
    with pytest.raises(ValueError, match="expected hq"):
        stem_tail.gemm_stats(thq, tsq[:-1])
    before = dict(stem_cuda.launches)
    y, sums = stem_tail.gemm_stats(thq, tsq, m_tile=64)
    assert stem_cuda.launches == before
    want = stem_tail.gemm_stats_plain(thq, tsq)
    assert torch.equal(y, want[0]) and torch.equal(sums, want[1])
    with pytest.raises(ValueError, match="unsupported device"):
        stem_tail.gemm_stats(thq.to("meta"), tsq.to("meta"), m_tile=64)


def test_profile_stem_pieces_runs_on_the_cpu():
    """The tool that is the kernel's entry point times its eight pieces; on
    the CPU (a rehearsal) every piece takes its plain version."""
    before = dict(stem_cuda.launches)
    rows = profile_stem_pieces.profile(device="cpu", batch=1, iters=1)
    assert [r["piece"].split(" (")[0] for r in rows][3] == "GEMM+stats kernel"
    assert len(rows) == 8 and all(r["ms"] > 0 and r["device"] == "cpu" for r in rows)
    assert stem_cuda.launches == before


# ------------------------------------------ the GEMM kernel's persistent tiling


def _perm(k):
    """The kernel's fragment rows: fragment row g of a 16-row step is tile
    row perm[g] (+ the step's base), row g + 8 the row after it; at even K
    with K/2 odd, perm[g] = 4g / (K/2) mod 32, else 4g."""
    s = k // 2
    if k % 2 == 0 and s % 2:
        inv = pow(s, -1, 32)
        return [(4 * g * inv) % 32 for g in range(8)]
    return [4 * g for g in range(8)]


def _walk_gemm_stats(hq, sq, fault=None):
    """``csrc/stem_gemm.cu`` gemm_stats_kernel walked CTA by CTA over its
    plan (``stem_cuda.gemm_plan``) on the CPU: CTA (column tile, split)
    takes its row tiles in order; each tile's y (the plain version's, zero
    past M and N) is written where it lies inside y; each thread's sums
    (lane g of a column: its fragment rows, tile rows R and R + 1 of each
    16-row step of its warp's 64-row half, R = the step's base + perm[g])
    are added in fp32 in the kernel's order, then a
    fixed shuffle tree adds the eight lanes, and the two halves add into the
    CTA's partial row; the fold adds a column's rows in CTA order.
    ``fault`` plants a bug: "skip" drops the last tile of each run, "double"
    walks its first tile twice.  Returns (y, sums, how often each cell of y
    was written)."""
    m, k = hq.shape
    n = sq.shape[1]
    tile = stem_cuda.GEMM_TILE
    plan = stem_cuda.gemm_plan(m, n, k)
    assert plan.grid == plan.col_tiles * plan.splits <= max(stem_cuda.GEMM_CTAS, plan.col_tiles)
    assert (plan.splits - 1) * plan.run < plan.row_tiles <= plan.splits * plan.run
    assert plan.k_steps * 16 >= k and plan.smem_bytes <= 227 * 1024
    y_plain = stem_tail.gemm_stats_plain(hq, sq)[0].float()
    y = torch.zeros((m, n))
    written = torch.zeros((m, n), dtype=torch.int64)
    partial = torch.zeros((plan.grid, 2, tile))
    for cta in range(plan.grid):
        ct, split = divmod(cta, plan.splits)
        n0 = ct * tile
        rts = list(range(split * plan.run, min(plan.row_tiles, (split + 1) * plan.run)))
        if fault == "skip":
            rts = rts[:-1]
        elif fault == "double":
            rts = rts[:1] + rts
        s = torch.zeros((2, 2, 8, tile))  # [stat, row half, lane g, column], fp32
        for rt in rts:
            m0 = rt * tile
            yt = torch.zeros((tile, tile))
            yt[:min(tile, m - m0), :min(tile, n - n0)] = y_plain[m0:m0 + tile, n0:n0 + tile]
            y[m0:m0 + tile, n0:n0 + tile] = yt[:min(tile, m - m0), :min(tile, n - n0)]
            written[m0:m0 + tile, n0:n0 + tile] += 1
            perm = torch.tensor(_perm(k))
            for sub in range(4):
                for h in range(2):
                    rows = (torch.arange(2)[:, None] * 64 + 32 * (sub // 2) + 2 * (sub % 2)
                            + perm[None, :] + h)  # [row half, g]
                    v = yt[rows]
                    s[0] += v
                    s[1] += v * v
        for x in (1, 2, 4):  # xor 4, 8, 16 of the lane: g ^ 1, g ^ 2, g ^ 4
            s = s + s[:, :, torch.arange(8) ^ x]
        partial[cta] = s[:, 0, 0] + s[:, 1, 0]
    sums = torch.zeros((2, n))
    for col in range(n):
        ct, c = divmod(col, tile)
        for p in range(plan.splits):
            sums[:, col] += partial[ct * plan.splits + p, :, c]
    return y, sums, written


GEMM_WALKS = {  # name: (M, K, N, GEMM_CTAS)
    "ragged_m_n": (600, 70, 200, 264),  # 88 rows and 72 columns in the last tiles
    "runs": (1100, 70, 256, 8),  # 9 row tiles, four CTAs a column: runs of 3
    "uneven_runs": (1280, 70, 136, 4),  # 10 row tiles in runs of 3, 3, 3, 1
    "odd_k": (300, 33, 136, 6),
    "k_128": (130, 128, 8, 264),
}


@pytest.mark.parametrize("name", list(GEMM_WALKS))
def test_gemm_stats_walk_matches_plain(name, monkeypatch):
    """The persistent tiling writes each y cell once with the plain
    version's value, and its sums, in the kernel's fp32 order, are within
    1e-5 of max|sum| of the float64 column sums of y."""
    m, k, n, ctas = GEMM_WALKS[name]
    monkeypatch.setattr(stem_cuda, "GEMM_CTAS", ctas)
    _, _, hq, sq = _operands(len(name), m=m, k=k, n=n)
    y, sums, written = _walk_gemm_stats(hq, sq)
    assert torch.all(written == 1)
    want_y, want_sums = stem_tail.gemm_stats_plain(hq, sq)
    assert torch.equal(y, want_y.float())
    ref = torch.from_numpy(_sums_of(want_y.float().numpy()))
    assert bool(((sums.double() - ref).abs().amax(1) <= SUM_TOL * ref.abs().amax(1)).all())
    atol = SUM_TOL * float(want_sums.abs().max())
    assert torch.allclose(sums, want_sums, rtol=SUM_TOL, atol=atol)


@pytest.mark.parametrize("fault", ["skip", "double"])
def test_gemm_stats_walk_catches_planted_faults(fault, monkeypatch):
    """A skipped or doubled row tile shows in the write counts and in the
    sums."""
    monkeypatch.setattr(stem_cuda, "GEMM_CTAS", 8)
    _, _, hq, sq = _operands(5, m=1100, k=70, n=256)
    y, sums, written = _walk_gemm_stats(hq, sq, fault=fault)
    assert not torch.all(written == 1)
    want_sums = stem_tail.gemm_stats_plain(hq, sq)[1]
    atol = SUM_TOL * float(want_sums.abs().max())
    assert not torch.allclose(sums, want_sums, rtol=SUM_TOL, atol=atol)


def test_gemm_stats_thread_walks_and_staging():
    """The walks inside a CTA: the 16-byte copies of an hq row tile (thread
    t of half h = t / 128 copies chunks h*128K + 16 (t % 128), + 2048, ...
    of the rows it multiplies) cover its 256*K bytes once; the fragment
    rows of a warp's four 16-row steps (tile rows base + perm[g] and the
    row after it) cover its 64 rows once, and at K = 70 a fragment load's
    32 words lie in distinct banks; the y
    staging puts fragment row g (+ 8h) of a step where the A operand took
    it (block row perm[g] + h + 2 (step % 2)), at its place in the tensor
    store's 64-byte swizzle."""
    threads, tile = stem_cuda.GEMM_THREADS, stem_cuda.GEMM_TILE
    for k in (70, 33, 128, 16, 1):
        slot, half = 2 * tile * k, 128 * k
        chunks = torch.zeros(slot // 16, dtype=torch.int64)
        for tid in range(threads):
            h = tid // 128
            for c in range(h * half + (tid % 128) * 16, (h + 1) * half, 128 * 16):
                chunks[c // 16] += 1
        assert torch.all(chunks == 1)
        perm = _perm(k)
        rows = torch.zeros(64, dtype=torch.int64)
        for sub in range(4):
            base = 32 * (sub // 2) + 2 * (sub % 2)
            for g in range(8):
                rows[base + perm[g]] += 1
                rows[base + perm[g] + 1] += 1
        assert torch.all(rows == 1)
    perm = _perm(70)
    for sub in range(4):
        base = 32 * (sub // 2) + 2 * (sub % 2)
        for h in range(2):  # a0/a2 (row R), a1/a3 (row R + 1)
            words = [((base + perm[g] + h) * 70 + 2 * t) // 2 for g in range(8) for t in range(4)]
            assert len({w % 32 for w in words}) == 32
    placed = {}
    for p in range(2):
        for x in range(2):
            for lane in range(32):
                rr, h = lane & 7, (lane >> 3) & 1
                j = 2 * x + (lane >> 4)
                brow = perm[rr] + h + 2 * p
                assert brow == 2 * p + perm[rr] + h  # the A operand's row of fragment row rr + 8h
                placed[brow, j] = brow * 64 + 16 * (j ^ ((brow >> 1) & 3))
    swizzled = {(r, c): 64 * r + 16 * (c ^ ((r >> 1) & 3)) for r in range(32) for c in range(4)}
    assert placed == swizzled


def test_gemm_plan_at_the_tools_shape():
    """[28672, 70] x [70, 7168]: 56 column tiles x 4 runs of 56 row tiles
    (224 CTAs, two an SM), five k-steps, 104,448 shared bytes."""
    plan = stem_cuda.gemm_plan(28672, 7168, 70)
    assert (plan.col_tiles, plan.row_tiles, plan.splits, plan.run, plan.grid) == (
        56, 224, 4, 56, 224)
    assert plan.k_steps == 5 and plan.smem_bytes == 104448
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
    with pytest.raises(ValueError, match="K <= 128"):
        stem_cuda.gemm_plan(256, 64, 130)
