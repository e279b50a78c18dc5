"""Deterministic random streams (the JAX package's ``utils/prng.py``).

The JAX package threads explicit ``jax.random`` keys: one root key per run,
split by purpose, folded by step.  Here the same role falls to explicit
``torch.Generator`` objects seeded from integers that :func:`fold_in`
derives from (seed, purpose, counter), so no draw depends on PyTorch's
global generator.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A seed derived from (``seed``, ``data``), as ``jax.random.fold_in``
    derives a key: a different ``data`` gives an unrelated stream.  The
    result fits ``torch.Generator.manual_seed`` (63 bits)."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ (data & _MASK64)) >> 1


def step_generator(
    seed: int, step: int, generator: torch.Generator | None = None
) -> torch.Generator:
    """The generator of train step ``step`` of a run seeded with ``seed``
    (dropout and augmentation draw from it): seeded from ``fold_in(seed,
    step)``, so a resumed run draws at a step what an uninterrupted one
    would have.  ``generator`` (on the step's device) is re-seeded in
    place; without it, a new CPU generator."""
    if generator is None:
        generator = torch.Generator()
    return generator.manual_seed(fold_in(seed, step))


def set_seed(seed: int = 42) -> torch.Generator:
    """Reference-compatible helper: seeds NumPy's legacy global (for any
    host-side shuffling) and PyTorch's global generators, and returns a
    CPU generator seeded with ``seed``."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


@dataclass
class KeySequence:
    """Named, reproducible streams: ``keys('dropout')`` returns a fresh
    CPU generator each call, seeded from (seed, name, counter).  The name
    enters through CRC-32, which, unlike ``hash``, does not change between
    processes."""

    seed: int = 42
    _counters: dict = field(default_factory=dict)

    def __call__(self, name: str) -> torch.Generator:
        count = self._counters.get(name, 0)
        self._counters[name] = count + 1
        seed = fold_in(fold_in(self.seed, zlib.crc32(name.encode())), count)
        return torch.Generator().manual_seed(seed)
