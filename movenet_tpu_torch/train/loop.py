"""Train and eval steps.

The counterpart of ``movenet_tpu.train.loop``.  The loss is the
reference's cross-entropy on the model's softmax output (the parity
quirk, ``parity_softmax_output``) or on the logits, over the targets
``codes[:, RF:]``, with first-argmax accuracy.  With
``config.fused_blocks`` the loss runs through the fused trunk and
head/CE ops (``models/fused.fused_train_loss``): CUDA kernels for a
model on the card, their plain versions on the CPU.  Without it the
unfused ``WaveNet.train_logits`` runs in the compute dtype and the loss
in float32.

A step takes the mean of the microbatch gradients
(``accumulation_steps``), measures their global norm before clipping,
clips by optax's rule, sets the LR (and beta1/momentum) of the update
count from the schedule and applies one optimizer update.
``make_scan_train_step`` runs N such steps per call.

With a process ``group`` (data parallelism, ``movenet_tpu_torch.parallel``)
each rank's batch is its rows of the global batch; after the backward
(and the accumulation mean) one all-reduce of a flat float32 buffer sums
every gradient, the loss and the accuracy over the ranks, and the sums
are divided by the data-axis size: the mean of the shard means, as the
JAX package's ``pmean`` and shard_map transpose give it.  The global
norm, the clip and the update then see the averaged gradient on every
rank.  Without a group nothing is all-reduced.

On a mesh whose ``seq`` axis is above 1 each rank also holds a part of
the time axis: a ``TimeWindow`` of the clip, its own target positions
plus the halo they reach back to.  The fused route is off there, as in
the JAX package's ``_build_loss``.  A rank's loss, accuracy and
gradients are the means over its own positions, weighted by its share
of the clip's positions before the sum, so the divided sum is the mean
over every position of the global batch however the positions fall
across the ranks.  The windows need no exchange between the ranks: the
halo is recomputed, and the gradients of the ranks' windows add up to
the whole clip's.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional

import torch

from movenet_tpu_torch.models.wavenet import WaveNet
from movenet_tpu_torch.train.optim import (
    Schedules,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
)


@dataclass(frozen=True)
class TimeWindow:
    """A rank's part of the clips' time axis on a ``seq`` mesh.

    The batch's codes hold the clips' samples ``[start, start + W)``; the
    window's logits from row ``first`` on are the rank's own (row i
    predicts the window's sample i + 1), the rows before them its halo.
    ``share`` is the rank's own positions over the clip's T - RF.  The
    video stays whole: the context is encoded from the whole clip and cut
    to the window (``WaveNet.window_logits``)."""

    start: int
    first: int
    share: float


_TENSORS = ("codes", "video", "labels", "codes_pack")


@dataclass
class Batch:
    """int mu-law codes (B, T), optional video (B, F, H, W, C), class
    labels (B,) and the fused path's (T, 3B) int32 codes pack
    (``models.fused.codes_pack_np``).  With accumulation every field has
    a leading (accumulation_steps,) axis.  ``window``: the part of the
    time axis the codes hold on a ``seq`` mesh (None: whole clips)."""

    codes: torch.Tensor
    video: Optional[torch.Tensor] = None
    labels: Optional[torch.Tensor] = None
    codes_pack: Optional[torch.Tensor] = None
    window: Optional[TimeWindow] = None

    def to(self, device) -> "Batch":
        return replace(self, **{
            k: None if getattr(self, k) is None
            else torch.as_tensor(getattr(self, k)).to(device,
                                                      non_blocking=True)
            for k in _TENSORS})

    def micro(self, i: int) -> "Batch":
        return replace(self, **{
            k: None if getattr(self, k) is None else getattr(self, k)[i]
            for k in _TENSORS})


@dataclass
class TrainState:
    """The module (its parameters), the optimizer, the update count and
    the LR schedule (a ``Schedules``, or any step -> LR callable; None:
    the optimizer's own LR, no ``learning_rate`` metric)."""

    module: WaveNet
    optimizer: torch.optim.Optimizer
    step: int = 0
    lr_schedule: Optional[Callable] = None


def training_device(device="cuda") -> torch.device:
    """``device`` as a torch device; a CUDA device without a card
    raises (the CPU only when the caller asks for it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available (pass device='cpu' to train on the CPU)")
    return device


def create_train_state(model: WaveNet, config, optimizer=None,
                       lr_schedule=None, device="cuda",
                       steps_per_epoch: Optional[int] = None) -> TrainState:
    """Moves the model to ``device`` (the card unless the caller asks for
    the CPU; no card raises) and builds ``make_optimizer(config)``.  With
    a scheduler in the config and no ``lr_schedule`` given, the config's
    ``Schedules`` (OneCycleLR needs ``steps_per_epoch``)."""
    model = model.to(training_device(device))
    if optimizer is None:
        optimizer = make_optimizer(config, model.parameters(),
                                   steps_per_epoch)
    if lr_schedule is None and config.scheduler is not None:
        lr_schedule = Schedules(config, steps_per_epoch)
    return TrainState(module=model, optimizer=optimizer, step=0,
                      lr_schedule=lr_schedule)


def _use_fused(config) -> bool:
    return bool(getattr(config, "fused_blocks", False))


def _loss_and_metrics(model: WaveNet, parity: bool, fused: bool = False):
    rf = model.receptive_fields

    def fn(batch: Batch):
        labels = batch.labels if model.global_classes else None
        window = batch.window
        if fused:
            from movenet_tpu_torch.models.fused import fused_train_loss

            return fused_train_loss(model, batch.codes, batch.video, labels,
                                    parity=parity,
                                    codes_pack=batch.codes_pack)
        # whole clips: the window of every sample, owning from RF - 1 on
        start, first = (None, rf - 1) if window is None else (
            window.start, window.first)
        logits = model.window_logits(batch.codes, start, first, batch.video,
                                     labels)
        targets = batch.codes[:, first + 1:].long()
        logits = logits.to(torch.float32)          # (B, positions, C)
        tgt = targets[..., None]
        if parity:
            # CE on the softmax probabilities: lse(p) - p[y]
            probs = torch.softmax(logits, dim=-1)
            nll = torch.logsumexp(probs, dim=-1, keepdim=True) \
                - torch.gather(probs, -1, tgt)
        else:
            nll = torch.logsumexp(logits, dim=-1, keepdim=True) \
                - torch.gather(logits, -1, tgt)
        loss = nll.mean()
        acc = (logits.argmax(-1) == targets).to(torch.float32).mean()
        return loss, acc

    return fn


def _seq(mesh) -> int:
    return 1 if mesh is None else mesh.seq


def _build_loss(model: WaveNet, config, mesh=None):
    """The loss of a step on ``mesh`` (None: one rank, or a data axis
    only): the fused route is off when the mesh shards time, as in the
    JAX package (the windows run the unfused ``window_logits``)."""
    return _loss_and_metrics(model,
                             config.model_config.parity_softmax_output,
                             fused=_use_fused(config) and _seq(mesh) == 1)


def _window_share(batch: Batch, mesh) -> float:
    """The rank's share of the clip's positions: a step on a ``seq`` mesh
    takes one rank's window, any other step whole clips."""
    if (batch.window is None) != (_seq(mesh) == 1):
        raise ValueError(
            f"a step on a mesh with seq={_seq(mesh)} takes "
            + ("whole clips" if _seq(mesh) == 1 else
               "one rank's time window (parallel.shard_batch with seq and "
               "model)"))
    return 1.0 if batch.window is None else batch.window.share


def _mean_over_ranks(tensors, group, share: float = 1.0, data=None):
    """Each tensor's mean over the ranks of ``group``, in float32, as views
    of one flat buffer: one all-reduce of the tensors times ``share`` (the
    rank's part of the time axis), then a division by ``data`` (default:
    the group's size; gloo takes no AVG on CUDA tensors)."""
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    if share != 1.0:
        flat.mul_(share)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(dist.get_world_size(group) if data is None else data)
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return out


def make_train_step(model: WaveNet, config, group=None, mesh=None):
    """``train_step(state, batch) -> (state, metrics)``.

    accumulation_steps == 1: batch fields are (B, ...); > 1: (A, B, ...),
    and the update uses the mean of the A microbatch gradients.  Metrics
    are 0-dim tensors on the model's device: ``loss``, ``accuracy``,
    ``grad_norm`` (before clipping) and, with a schedule,
    ``learning_rate``.  With a process ``group`` the batch is this rank's
    shard and the gradients, loss and accuracy are the means over the
    global batch's positions (module docstring); ``mesh``
    (``parallel.mesh.Mesh``, default: a data axis over the group) says
    how the group's ranks split it."""
    accum = config.accumulation_steps
    clip = config.gradient_clipping
    loss_fn = _build_loss(model, config, mesh)
    data = None if mesh is None else mesh.data

    def train_step(state: TrainState, batch: Batch):
        module = state.module
        device = module.front_cur.device
        batch = batch.to(device)
        share = _window_share(batch, mesh)
        params = [p for p in module.parameters() if p.requires_grad]
        state.optimizer.zero_grad(set_to_none=True)
        if accum <= 1:
            loss, acc = loss_fn(batch)
            loss.backward()
        else:
            loss = acc = 0.0
            for i in range(accum):
                l_i, a_i = loss_fn(batch.micro(i))
                l_i.backward()
                loss, acc = loss + l_i.detach(), acc + a_i.detach()
            loss, acc = loss / accum, acc / accum
        grads = [p.grad for p in params if p.grad is not None]
        with torch.no_grad():
            if accum > 1:
                for g in grads:
                    g.div_(accum)
            if group is not None:
                *means, loss, acc = _mean_over_ranks(
                    [*grads, loss.detach(), acc.detach()], group, share,
                    data)
                for g, m in zip(grads, means):
                    g.copy_(m)
            grad_norm = global_norm(grads)
            if clip and clip > 0:
                clip_by_global_norm(grads, clip, grad_norm)
        metrics = {"loss": loss.detach(), "accuracy": acc.detach(),
                   "grad_norm": grad_norm}
        sched = state.lr_schedule
        if sched is not None:
            if hasattr(sched, "apply"):
                sched.apply(state.optimizer, state.step)
            metrics["learning_rate"] = torch.as_tensor(sched(state.step))
        state.optimizer.step()
        return replace(state, step=state.step + 1), metrics

    return train_step


def make_scan_train_step(model: WaveNet, config, n_steps: int,
                         group=None, mesh=None):
    """``multi_step(state, batches) -> (state, metrics)``: ``n_steps``
    optimizer steps in one call, on batches stacked on a leading
    (n_steps, ...) axis; every metric comes back stacked (n_steps,), the
    same values as n_steps calls of the train step (the JAX package's
    ``make_scan_train_step``, a ``lax.scan`` there)."""
    step = make_train_step(model, config, group, mesh)

    def multi_step(state: TrainState, batches: Batch):
        per_step = []
        for i in range(n_steps):
            state, m = step(state, batches.micro(i))
            per_step.append(m)
        return state, {k: torch.stack([torch.as_tensor(m[k]).to(
            per_step[0]["loss"].device) for m in per_step])
            for k in per_step[0]}

    return multi_step


def make_eval_step(model: WaveNet, config, group=None, mesh=None):
    """``eval_step(state, batch) -> {"loss", "accuracy"}``, no gradients
    (the fused head then saves no softmax); with a process ``group``, the
    means over the global batch's positions, as in ``make_train_step``."""
    loss_fn = _build_loss(model, config, mesh)
    data = None if mesh is None else mesh.data

    def eval_step(state: TrainState, batch: Batch):
        batch = batch.to(state.module.front_cur.device)
        share = _window_share(batch, mesh)
        with torch.no_grad():
            loss, acc = loss_fn(batch)
            if group is not None:
                loss, acc = _mean_over_ranks([loss, acc], group, share,
                                             data)
        return {"loss": loss, "accuracy": acc}

    return eval_step


__all__ = ["Batch", "TimeWindow", "TrainState", "create_train_state",
           "make_train_step", "make_scan_train_step", "make_eval_step"]
