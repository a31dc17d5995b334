"""The train step and the train loop (port of ``repro.train``)."""
from .step import (TrainState, init_train_state, lm_loss,  # noqa: F401
                   make_train_step)
from .loop import TrainLoopConfig, train_loop  # noqa: F401
