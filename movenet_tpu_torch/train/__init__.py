"""Training layer of the port: optimizers, the train and eval steps, and
checkpoints (the trainer and its CLI are ``train.trainer`` and
``train.cli``)."""

from movenet_tpu_torch.train.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    restore_params,
    save_checkpoint,
    save_params,
)
from movenet_tpu_torch.train.loop import (
    Batch,
    TrainState,
    create_train_state,
    make_eval_step,
    make_scan_train_step,
    make_train_step,
)
from movenet_tpu_torch.train.optim import (
    Schedules,
    cyclic_schedule,
    make_optimizer,
    make_schedule,
    multistep_schedule,
    onecycle_schedule,
    step_schedule,
)

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint",
           "restore_params", "save_checkpoint", "save_params", "Batch",
           "TrainState", "create_train_state", "make_eval_step",
           "make_scan_train_step", "make_train_step", "make_optimizer",
           "make_schedule", "onecycle_schedule", "cyclic_schedule",
           "step_schedule", "multistep_schedule", "Schedules"]
