"""Training engine: preprocessing, optimizer, train state, train and eval
steps, the epoch loop, schedules, checkpoints and metrics."""

from .checkpoint import (
    Checkpointer,
    CheckpointMismatchError,
    OrbaxCheckpointError,
    find_checkpoint,
)
from .engine import (
    AdamState,
    Optimizer,
    TrainState,
    batch_to_device,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_preprocess,
    make_train_step,
    test_model,
    train_model,
    validate_model,
)
from .metrics import confusion_matrices, per_fret_accuracy, row_normalize
from .schedules import CosineAnnealingWarmRestarts, ReduceLROnPlateau, make_scheduler

__all__ = [
    "AdamState", "Checkpointer", "CheckpointMismatchError", "CosineAnnealingWarmRestarts",
    "Optimizer", "OrbaxCheckpointError", "ReduceLROnPlateau", "TrainState",
    "batch_to_device", "confusion_matrices", "create_train_state", "find_checkpoint",
    "make_eval_step", "make_optimizer", "make_preprocess", "make_scheduler",
    "make_train_step", "per_fret_accuracy", "row_normalize", "test_model",
    "train_model", "validate_model",
]
