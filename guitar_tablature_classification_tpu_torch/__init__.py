"""guitar_tablature_classification_tpu_torch — the PyTorch / CUDA port of
``guitar_tablature_classification_tpu`` for an NVIDIA H100.

The JAX package stays the reference; this package never imports it (nor
JAX).  Its modules mirror the JAX package's names so each counterpart is
easy to find:

  ops/     CQT frontend (plain version + hand-written Hopper kernel in
           csrc/cqt.cu), framing, normalization, resize, smoothing
  models/  ResNet18, string-branch heads, GuitarTabNet, weight conversion
  train/   make_preprocess
  data/    audio file loading
  infer/   batched transcription, tab text, the tab-transcribe CLI

Entry points run on the card (``cuda``) unless the caller passes
``device="cpu"``.
"""

from .config import (
    CQTConfig,
    DataConfig,
    MeshConfig,
    ModelConfig,
    NUM_FRETS,
    NUM_STRINGS,
    OPEN_STRING_MIDI,
    OptimConfig,
    RECIPES,
    TrainConfig,
)
from .version import __version__

__all__ = [
    "CQTConfig",
    "DataConfig",
    "MeshConfig",
    "ModelConfig",
    "NUM_FRETS",
    "NUM_STRINGS",
    "OPEN_STRING_MIDI",
    "OptimConfig",
    "RECIPES",
    "TrainConfig",
    "__version__",
]
