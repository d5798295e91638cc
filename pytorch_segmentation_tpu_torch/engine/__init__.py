"""Training, evaluation and checkpoints."""

from .checkpoint import load_model_bundle, save_checkpoint
from .evaluate import test
from .steps import (TrainState, create_train_state, make_eval_step,
                    make_predict_step, make_train_step)
from .trainer import Trainer

__all__ = [
    "Trainer", "test", "TrainState", "create_train_state", "make_train_step",
    "make_eval_step", "make_predict_step", "save_checkpoint",
    "load_model_bundle",
]
