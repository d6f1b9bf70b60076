"""Training layer of the port: optimizers, the train and eval steps, and
parameter checkpoints."""

from movenet_tpu_torch.train.checkpoint import (
    latest_step,
    restore_params,
    save_params,
)
from movenet_tpu_torch.train.loop import (
    Batch,
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from movenet_tpu_torch.train.optim import make_optimizer

__all__ = ["latest_step", "restore_params", "save_params", "Batch",
           "TrainState", "create_train_state", "make_eval_step",
           "make_train_step", "make_optimizer"]
