"""The port's training path (``repro.training``): the train step and the
preemptible ``Trainer``."""
from .train_step import TrainSettings, make_eval_step, make_train_step
from .trainer import Trainer, TrainerConfig

__all__ = [
    "TrainSettings",
    "Trainer",
    "TrainerConfig",
    "make_eval_step",
    "make_train_step",
]
