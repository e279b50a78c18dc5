"""Seeding, structured metrics logging and profiling."""

from .logging import MetricsLogger
from .prng import KeySequence, fold_in, set_seed, step_generator
from .profiling import trace

__all__ = [
    "KeySequence", "MetricsLogger", "fold_in", "set_seed", "step_generator", "trace",
]
