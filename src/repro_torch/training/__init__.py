"""The port's train step."""
from repro_torch.training.step import (
    TrainState, loss_and_grads, make_train_step, param_groups,
    train_state_init,
)

__all__ = ["TrainState", "train_state_init", "make_train_step",
           "param_groups", "loss_and_grads"]
