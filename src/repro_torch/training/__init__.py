"""Training: optimizers, the train step and the fault-tolerant trainer."""

from .optimizer import OptConfig, apply_opt, init_opt_state
from .train_step import (TrainConfig, abstract_train_state, init_train_state,
                         make_train_step)
from .trainer import StragglerWatchdog, Trainer, TrainerConfig

__all__ = ["OptConfig", "apply_opt", "init_opt_state", "TrainConfig",
           "abstract_train_state", "init_train_state", "make_train_step", "Trainer",
           "TrainerConfig", "StragglerWatchdog"]
