"""Training engine (this slice: preprocessing only)."""

from .engine import make_preprocess

__all__ = ["make_preprocess"]
