"""Training: the sequence loss, the optimizer recipe, the train step in
its standard and taped gradient modes, and the training loop."""

from .loss import uniform_sequence_loss
from .optim import make_optimizer, one_cycle_linear
from .trainer import (Trainer, TrainerConfig, add_noise, draw_noise,
                      make_train_step, step_generator, taped_value_and_grad)

__all__ = ["uniform_sequence_loss", "make_optimizer", "one_cycle_linear",
           "Trainer", "TrainerConfig", "add_noise", "draw_noise",
           "make_train_step", "step_generator", "taped_value_and_grad"]
