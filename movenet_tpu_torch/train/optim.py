"""Optimizers and LR schedules with the JAX package's torch semantics.

The counterpart of ``movenet_tpu.train.optim``: Adam (L2 term into the
gradient), AdamW (decoupled decay), SGD and RMSprop (eps outside the
sqrt), with the configuration's weight decay passed explicitly (torch's
AdamW would otherwise decay by 0.01), under the schedules OneCycleLR
(three-phase, cosine), CyclicLR, StepLR and MultiStepLR and the
momentum/beta1 cycling that OneCycleLR (always) and CyclicLR (with
``scheduler_cycle_momentum``) bring.

Each schedule is a stateless function of the optimizer's update count,
computed in float32 as the JAX package's jnp schedules are.
``Schedules.apply`` sets every param group's ``lr`` (and ``betas[0]`` or
``momentum``) from the count before the update, so a run resumed from a
checkpoint's step has the same LR and beta1 with no scheduler state to
save.  torch's Adam takes the bias correction with the current beta1
(``_adam_scheduled_b1`` in the JAX package).  One rule differs from
torch's own optimizers: under a schedule without momentum cycling, the
JAX package's RMSprop is optax's, which scales by the learning rate
before the momentum trace; ``RMSpropLRInTrace`` is that update.

Global-norm clipping is not part of the optimizer: ``clip_by_global_norm``
below applies optax's rule and the train step calls it.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

_F = np.float32


def _phase_curve(ends, starts, first, last):
    """The cosine interpolation over phases of ``onecycle_schedule``."""
    ends = np.asarray(ends, np.float32)
    starts = np.asarray(starts, np.float32)
    first = np.asarray(first, np.float32)
    last = np.asarray(last, np.float32)

    def schedule(step):
        s = _F(step)
        # the first phase whose end >= s (torch walks phases in order)
        phase = min(int(np.sum(s > ends)), len(ends) - 1)
        lo, hi = starts[phase], ends[phase]
        pct = (s - lo) / (hi - lo) if hi > lo else _F(1.0)
        pct = _F(min(max(pct, _F(0.0)), _F(1.0)))
        a, b = first[phase], last[phase]
        return b + (a - b) / _F(2.0) * (_F(1.0) + np.cos(_F(np.pi) * pct))

    return schedule


def _phase_ends(total_steps: int, pct_start: float, three_phase: bool):
    if three_phase:
        ends = [float(pct_start * total_steps) - 1.0,
                float(2 * pct_start * total_steps) - 2.0,
                float(total_steps) - 1.0]
    else:
        ends = [float(pct_start * total_steps) - 1.0,
                float(total_steps) - 1.0]
    return ends, [0.0] + ends[:-1]


def onecycle_schedule(max_lr: float, total_steps: int,
                      pct_start: float = 0.45, div_factor: float = 25.0,
                      final_div_factor: float = 1e4,
                      three_phase: bool = True):
    """torch's OneCycleLR with cosine annealing; three_phase: warm up
    initial -> max over pct_start, anneal max -> initial over the next
    pct_start, then initial -> min.  Phase ends follow torch:
    [pct*T - 1, 2*pct*T - 2, T - 1]."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    ends, starts = _phase_ends(total_steps, pct_start, three_phase)
    if three_phase:
        first, last = ([initial_lr, max_lr, initial_lr],
                       [max_lr, initial_lr, min_lr])
    else:
        first, last = [initial_lr, max_lr], [max_lr, min_lr]
    return _phase_curve(ends, starts, first, last)


def onecycle_momentum_schedule(total_steps: int, pct_start: float = 0.45,
                               base_momentum: float = 0.85,
                               max_momentum: float = 0.95,
                               three_phase: bool = True):
    """torch's OneCycleLR momentum cycling: max -> base while the LR warms
    up, base -> max while it anneals, then flat at max."""
    ends, starts = _phase_ends(total_steps, pct_start, three_phase)
    if three_phase:
        first, last = ([max_momentum, base_momentum, max_momentum],
                       [base_momentum, max_momentum, max_momentum])
    else:
        first, last = [max_momentum, base_momentum], [base_momentum,
                                                      max_momentum]
    return _phase_curve(ends, starts, first, last)


def _cyclic(low: float, high: float, step_size_up: int,
            step_size_down: Optional[int], mode: str, gamma: float,
            rising: bool):
    down = step_size_up if step_size_down is None else step_size_down
    total = _F(step_size_up + down)
    ratio = _F(step_size_up / float(step_size_up + down))
    if mode not in ("triangular", "triangular2", "exp_range"):
        raise ValueError(f"unknown cyclic mode: {mode}")

    def schedule(step):
        s = _F(step)
        cycle = np.floor(_F(1.0) + s / total)
        x = _F(1.0) + s / total - cycle
        scale = x / ratio if x <= ratio else (x - _F(1.0)) / (ratio - _F(1.0))
        height = _F(high - low) * scale
        if mode == "triangular2":
            height = height / _F(2.0) ** (cycle - _F(1.0))
        elif mode == "exp_range":
            height = height * _F(gamma) ** s
        return _F(low) + height if rising else _F(high) - height

    return schedule


def cyclic_schedule(base_lr: float, max_lr: float, step_size_up: int = 2000,
                    step_size_down: Optional[int] = None,
                    mode: str = "triangular", gamma: float = 1.0):
    """torch's CyclicLR, closed form."""
    return _cyclic(base_lr, max_lr, step_size_up, step_size_down, mode,
                   gamma, rising=True)


def cyclic_momentum_schedule(base_momentum: float = 0.8,
                             max_momentum: float = 0.9,
                             step_size_up: int = 2000,
                             step_size_down: Optional[int] = None,
                             mode: str = "triangular", gamma: float = 1.0):
    """torch's CyclicLR momentum cycling: inverse to the LR, between
    max_momentum and base_momentum."""
    return _cyclic(base_momentum, max_momentum, step_size_up,
                   step_size_down, mode, gamma, rising=False)


def step_schedule(initial_lr: float, step_size: int, gamma: float = 0.1):
    """torch's StepLR: lr0 * gamma^floor(s / step_size)."""
    def schedule(step):
        return _F(initial_lr) * _F(gamma) ** np.floor(_F(step)
                                                     / _F(step_size))

    return schedule


def multistep_schedule(initial_lr: float, milestones: Sequence[int],
                       gamma: float = 0.1):
    """torch's MultiStepLR: lr0 * gamma^(number of milestones <= s)."""
    ms = np.asarray(sorted(milestones), np.float32)

    def schedule(step):
        k = _F(np.sum(_F(step) >= ms))
        return _F(initial_lr) * _F(gamma) ** k

    return schedule


def _updates_per_epoch(config, steps_per_epoch: Optional[int]) -> int:
    return math.ceil((steps_per_epoch or 1) / config.accumulation_steps)


def make_schedule(config, steps_per_epoch: Optional[int] = None
                  ) -> Callable[[int], np.float32]:
    """The LR schedule named by a TrainingConfig as a function of the
    update count (constant without a scheduler).  OneCycleLR's total
    steps are n_epochs * ceil(steps_per_epoch / accumulation_steps), as
    in the JAX package."""
    name = config.scheduler
    if name is None:
        lr = _F(config.learning_rate)
        return lambda step: lr
    if name == "OneCycleLR":
        if steps_per_epoch is None:
            raise ValueError("OneCycleLR needs steps_per_epoch")
        return onecycle_schedule(
            max_lr=config.max_learning_rate,
            total_steps=config.n_epochs * _updates_per_epoch(
                config, steps_per_epoch),
            pct_start=config.lr_pct_start, three_phase=True)
    if name == "CyclicLR":
        return cyclic_schedule(
            base_lr=config.base_learning_rate,
            max_lr=config.max_learning_rate,
            step_size_up=config.scheduler_step_size_up,
            step_size_down=config.scheduler_step_size_down,
            mode=config.scheduler_cyclic_mode,
            gamma=config.scheduler_cyclic_gamma)
    if name == "StepLR":
        return step_schedule(config.learning_rate,
                             config.scheduler_step_size,
                             config.scheduler_step_gamma)
    if name == "MultiStepLR":
        if not config.scheduler_milestones:
            raise ValueError("MultiStepLR needs scheduler_milestones")
        return multistep_schedule(config.learning_rate,
                                  config.scheduler_milestones,
                                  config.scheduler_step_gamma)
    raise ValueError(
        f"scheduler {name} not recognized. Must be one of "
        "[None, 'OneCycleLR', 'CyclicLR', 'StepLR', 'MultiStepLR']")


def momentum_schedule_for(config, steps_per_epoch: Optional[int] = None):
    """The momentum/beta1 schedule torch would apply, or None: OneCycleLR
    cycles momentum by default, CyclicLR only with
    ``scheduler_cycle_momentum``."""
    if config.scheduler == "OneCycleLR":
        return onecycle_momentum_schedule(
            total_steps=config.n_epochs * _updates_per_epoch(
                config, steps_per_epoch),
            pct_start=config.lr_pct_start, three_phase=True)
    if config.scheduler == "CyclicLR" and config.scheduler_cycle_momentum:
        return cyclic_momentum_schedule(
            step_size_up=config.scheduler_step_size_up,
            step_size_down=config.scheduler_step_size_down,
            mode=config.scheduler_cyclic_mode,
            gamma=config.scheduler_cyclic_gamma)
    return None


class Schedules:
    """A config's LR schedule and momentum/beta1 schedule.  Called with
    the update count it gives the LR (the ``learning_rate`` metric);
    ``apply`` writes both into an optimizer's param groups before that
    update.  Without a scheduler ``apply`` leaves the optimizer as it was
    built."""

    def __init__(self, config, steps_per_epoch: Optional[int] = None):
        self.lr = make_schedule(config, steps_per_epoch)
        self.momentum = momentum_schedule_for(config, steps_per_epoch)
        self.constant = config.scheduler is None

    def __call__(self, step: int) -> np.float32:
        return self.lr(step)

    def apply(self, optimizer: torch.optim.Optimizer, step: int) -> None:
        if self.constant:
            return
        lr = float(self.lr(step))
        m = None if self.momentum is None else float(self.momentum(step))
        for group in optimizer.param_groups:
            group["lr"] = lr
            if m is None:
                continue
            if "betas" in group:
                group["betas"] = (m, group["betas"][1])
            else:
                group["momentum"] = m


class RMSpropLRInTrace(torch.optim.Optimizer):
    """optax's rmsprop with momentum (``eps_in_sqrt=False``): sq = alpha
    sq + (1 - alpha) g^2, buf = momentum buf - lr g / (sqrt(sq) + eps),
    p += buf; the L2 term (weight_decay p) joins g first.  Under a
    changing LR this is not torch's RMSprop, which keeps the LR out of
    the trace; the JAX package trains with it."""

    def __init__(self, params, lr: float, alpha: float = 0.99,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 momentum: float = 0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps,
                                      weight_decay=weight_decay,
                                      momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            alpha, eps, lr = group["alpha"], group["eps"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["square_avg"] = torch.zeros_like(p)
                    state["momentum_buffer"] = torch.zeros_like(p)
                sq, buf = state["square_avg"], state["momentum_buffer"]
                sq.mul_(alpha).addcmul_(g, g, value=1 - alpha)
                u = (g / (sq.sqrt() + eps)) * -lr
                buf.mul_(group["momentum"]).add_(u)
                p.add_(buf)
        return loss


def make_optimizer(config, params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: Optional[int] = None
                   ) -> torch.optim.Optimizer:
    """A torch optimizer for ``config.optimizer`` at the config's first
    LR; a schedule (``Schedules``) moves its LR and beta1/momentum per
    update."""
    name = config.optimizer
    lr = float(make_schedule(config, steps_per_epoch)(0)) \
        if config.scheduler is not None else config.learning_rate
    wd = config.weight_decay
    cycled = momentum_schedule_for(config, steps_per_epoch) is not None
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
        if config.scheduler is not None and not cycled and config.momentum:
            return RMSpropLRInTrace(params, lr=lr, alpha=0.99, eps=1e-8,
                                    weight_decay=wd,
                                    momentum=config.momentum)
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


__all__ = ["make_optimizer", "make_schedule", "momentum_schedule_for",
           "Schedules", "RMSpropLRInTrace", "onecycle_schedule",
           "onecycle_momentum_schedule", "cyclic_schedule",
           "cyclic_momentum_schedule", "step_schedule",
           "multistep_schedule", "global_norm", "clip_by_global_norm"]
