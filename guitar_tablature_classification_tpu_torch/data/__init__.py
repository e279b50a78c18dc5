"""Audio file loading."""

from .audio import load_audio, load_wav, resample

__all__ = ["load_audio", "load_wav", "resample"]
