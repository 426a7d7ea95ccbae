"""Training: the sequence loss, the optimizer recipe and the train step in
its standard and taped gradient modes."""

from .loss import uniform_sequence_loss
from .optim import make_optimizer, one_cycle_linear
from .trainer import (Trainer, TrainerConfig, make_train_step,
                      taped_value_and_grad)

__all__ = ["uniform_sequence_loss", "make_optimizer", "one_cycle_linear",
           "Trainer", "TrainerConfig", "make_train_step",
           "taped_value_and_grad"]
