"""Seeds for each purpose of a run, derived from ``--seed`` (any whole
number, 64 bits and more included) by splitmix64, so that weights, audio,
labels and dropout draw from unrelated streams."""

from __future__ import annotations

import zlib

_MASK = (1 << 64) - 1


def _mix(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def derive(seed: int, purpose: str, index: int = 0) -> int:
    """A 63-bit seed for (seed, purpose, index)."""
    x = _mix(int(seed) & _MASK) ^ zlib.crc32(purpose.encode())
    return _mix(_mix(x) ^ (index & _MASK)) >> 1
