"""Optimizers with the JAX package's torch semantics, on torch's own.

The counterpart of ``movenet_tpu.train.optim.make_optimizer`` for a
constant learning rate (``scheduler=None``): Adam (L2 term into the
gradient), AdamW (decoupled decay), SGD and RMSprop (eps outside the
sqrt), with the configuration's weight decay passed explicitly (torch's
AdamW would otherwise decay by 0.01).  Global-norm clipping is not part
of the optimizer: ``clip_by_global_norm`` below applies optax's rule and
the train step calls it.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch


def make_optimizer(config, params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: Optional[int] = None
                   ) -> torch.optim.Optimizer:
    """A torch optimizer for ``config.optimizer`` at the constant
    ``config.learning_rate``.  LR schedules are not ported yet
    (ROADMAP.md A.3)."""
    if config.scheduler is not None:
        raise NotImplementedError(
            f"scheduler {config.scheduler!r}: LR schedules (and the "
            "momentum cycling they bring) are not ported yet "
            "(ROADMAP.md A.3); use scheduler=None")
    name = config.optimizer
    lr = config.learning_rate
    wd = config.weight_decay
    params = list(params)
    if name == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=wd)
    if name == "AdamW":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=wd)
    if name == "SGD":
        return torch.optim.SGD(params, lr=lr,
                               momentum=config.momentum or 0.0,
                               weight_decay=wd, nesterov=False)
    if name == "RMSprop":
        return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8,
                                   weight_decay=wd,
                                   momentum=config.momentum or 0.0)
    raise ValueError(
        f"optimizer {name} not recognized. Must be one of "
        "['Adam', 'AdamW', 'SGD', 'RMSprop']")


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient (float32)."""
    return torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                          for g in grads))


def clip_by_global_norm(grads, max_norm: float, norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm in place: g -> g / norm * max_norm where
    norm >= max_norm (no epsilon, unlike torch's clip_grad_norm_)."""
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))


__all__ = ["make_optimizer", "global_norm", "clip_by_global_norm"]
