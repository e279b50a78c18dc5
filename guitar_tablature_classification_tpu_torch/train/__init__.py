"""Training engine: preprocessing, optimizer, train state, train and eval
steps."""

from .engine import (
    AdamState,
    Optimizer,
    TrainState,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_preprocess,
    make_train_step,
)

__all__ = [
    "AdamState", "Optimizer", "TrainState", "create_train_state",
    "make_eval_step", "make_optimizer", "make_preprocess", "make_train_step",
]
