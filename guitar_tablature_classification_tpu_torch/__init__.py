"""guitar_tablature_classification_tpu_torch — the PyTorch / CUDA port of
``guitar_tablature_classification_tpu`` for an NVIDIA H100.

The JAX package stays the reference; this package never imports it (nor
JAX).  Its modules mirror the JAX package's names so each counterpart is
easy to find:

  ops/     CQT frontend (plain version + hand-written Hopper kernels in
           csrc/), attention, the stem tails, fused BatchNorm, framing,
           normalization, resize, smoothing, augmentation
  models/  ResNet18, ViT, string-branch heads, GuitarTabNet, ViTTab,
           weight conversion
  train/   preprocess, train and eval steps, the epoch loop, schedules,
           checkpoints, metrics, the tab-train CLI (train/run.py)
  data/    audio file loading, synthetic data, packing, loaders
  labels/  JAMS reading and tablature labels
  utils/   generators, metrics logging, profiling
  infer/   batched and streaming transcription, tab text and image, the
           tab-transcribe CLI
  parallel/ data and string-head parallelism over torch.distributed ranks
  bench.py the root bench.py's rows on the card

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
