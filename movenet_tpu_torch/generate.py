"""Loading a trained model for generation.

So far only ``load_checkpoint_model``; the generate CLI, which needs the
data layer and the sample export, comes with a later part of the port.
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch

from movenet_tpu_torch.config import TrainingConfig
from movenet_tpu_torch.models.convert import load_jax_params
from movenet_tpu_torch.models.wavenet import WaveNet, make_wavenet
from movenet_tpu_torch.train.checkpoint import restore_params

logger = logging.getLogger(__name__)


def load_checkpoint_model(checkpoint_dir: Path, device="cpu"):
    """(model, config, step) from a run directory: ``config.json`` gives
    the architecture, the latest ``checkpoints/<step>/params.npz`` the
    weights.  The model is on ``device``, in eval mode."""
    checkpoint_dir = Path(checkpoint_dir)
    config = TrainingConfig.load(checkpoint_dir / "config.json")
    params, step = restore_params(checkpoint_dir)
    model: WaveNet = load_jax_params(make_wavenet(config.model_config),
                                     params)
    model = model.to(torch.device(device)).eval()
    logger.info("restored step-%d params from %s", step, checkpoint_dir)
    return model, config, step
