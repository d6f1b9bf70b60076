"""Training layer of the port; so far only parameter checkpoints."""

from movenet_tpu_torch.train.checkpoint import (
    latest_step,
    restore_params,
    save_params,
)

__all__ = ["latest_step", "restore_params", "save_params"]
