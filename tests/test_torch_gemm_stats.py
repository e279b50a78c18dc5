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
