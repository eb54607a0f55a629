"""Training of the PyTorch port: loss, optimizer and schedules, train and eval steps."""

from paradis_torch.train.loss import WeightedLoss
from paradis_torch.train.optim import (
    ParadisOptimizer,
    build_optimizer,
    build_schedule,
    get_learning_rate,
    set_learning_rate,
)
from paradis_torch.train.step import TrainState, create_train_state, make_eval_step, make_train_step

__all__ = [
    "ParadisOptimizer",
    "TrainState",
    "WeightedLoss",
    "build_optimizer",
    "build_schedule",
    "create_train_state",
    "get_learning_rate",
    "make_eval_step",
    "make_train_step",
    "set_learning_rate",
]
