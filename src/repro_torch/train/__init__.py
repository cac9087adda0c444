"""The LM train step (counterpart of the reference package's ``train``)."""

from .trainer import TrainState, init_train_state, make_serve_step, \
    make_train_step

__all__ = ["TrainState", "make_train_step", "make_serve_step",
           "init_train_state"]
