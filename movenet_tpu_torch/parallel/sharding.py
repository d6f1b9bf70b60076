"""Batch sharding and the data-parallel steps.

The counterpart of ``movenet_tpu.parallel.sharding`` for one process per
card.  Layout, as in the JAX package:

  * parameters and optimizer state: replicated on every rank (channel
    sizes are at most 256, so tensor parallelism buys nothing; the
    reference replicates too, via DDP);
  * batch codes (B, T) / (A, B, T), video (B, F, H, W, C) and labels
    (B,): the batch axis on ``data``; rank r holds rows
    ``[r*b, (r+1)*b)`` with ``b = B / data``.

JAX gets the gradient all-reduce from pjit (or from shard_map's
transpose on the fused path); here the train step all-reduces one flat
float32 buffer of every gradient, the loss and the accuracy
(``train.loop.make_train_step(..., group=...)``).
"""

from __future__ import annotations

from dataclasses import replace as _replace
from typing import Optional

import torch

from movenet_tpu_torch.parallel.mesh import DATA_AXIS
from movenet_tpu_torch.train.loop import (
    Batch,
    make_eval_step,
    make_scan_train_step,
    make_train_step,
)


def _world(group):
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "data-parallel steps need an initialised process group "
            "(parallel.initialize_distributed)")
    return dist.group.WORLD if group is None else group


def replicate(module: torch.nn.Module, group=None, src: int = 0) -> None:
    """Broadcast rank ``src``'s parameters and buffers to every rank of
    ``group`` (one flat buffer a dtype).  Ranks built from the same seed
    already hold equal weights; this guards a restore or an init that
    drew differently."""
    import torch.distributed as dist

    group = _world(group)
    by_dtype = {}
    for t in list(module.parameters()) + list(module.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in ts])
            dist.broadcast(flat, src=src, group=group)
            offset = 0
            for t in ts:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view_as(t))
                offset += n


def batch_sharding(leading) -> Batch:
    """Each field's axes as a PartitionSpec tuple (a Batch of tuples).

    ``leading`` counts replicated leading axes ahead of the batch dim:
    0 for a plain (B, ...) batch, 1 for gradient accumulation (A, B, ...)
    OR a scanned multi-step batch (N, B, ...), 2 for both (N, A, B, ...).
    A bool is accepted (True == 1).  Time stays whole: the port does not
    shard the seq axis (ROADMAP.md A.11).
    """
    lead = (None,) * int(leading)
    return Batch(codes=(*lead, DATA_AXIS, None),
                 video=(*lead, DATA_AXIS, None, None, None, None),
                 labels=(*lead, DATA_AXIS),
                 codes_pack=None)


def shard_batch(batch: Batch, rank: Optional[int] = None,
                data: Optional[int] = None) -> Batch:
    """Rank ``rank``'s rows of a host ``batch`` whose batch axis spans
    ``data`` ranks (defaults: this rank and the world size).  The codes
    pack holds the batch in its lanes and cannot be split: it is
    dropped, and the fused loss builds each shard's own on the device
    (as JAX rebuilds it per shard)."""
    from movenet_tpu_torch.parallel.mesh import process_count, process_index

    rank = process_index() if rank is None else rank
    data = process_count() if data is None else data
    spec = batch_sharding(batch.codes.dim() - 2)

    def take(x, axes):
        if x is None:
            return None
        axis = axes.index(DATA_AXIS)
        size = x.shape[axis]
        if size % data:
            raise ValueError(
                f"batch axis of {size} rows not divisible by data-axis "
                f"size {data}")
        b = size // data
        return x.narrow(axis, rank * b, b)

    return _replace(batch, codes=take(batch.codes, spec.codes),
                    video=take(batch.video, spec.video),
                    labels=take(batch.labels, spec.labels), codes_pack=None)


def make_parallel_train_step(model, config, group=None):
    """``train_step(state, shard) -> (state, metrics)`` of one data rank:
    ``shard`` is this rank's rows (``shard_batch``); the loss, accuracy
    and gradients are the means over the ranks of ``group`` (default:
    every rank), so every rank takes the update and logs the metrics of
    the whole batch."""
    return make_train_step(model, config, group=_world(group))


def make_parallel_scan_train_step(model, config, n_steps: int, group=None):
    """``n_steps`` data-parallel optimizer steps per call on batches
    stacked on a leading (n_steps, ...) axis; metrics stacked
    (n_steps,)."""
    return make_scan_train_step(model, config, n_steps, group=_world(group))


def make_parallel_eval_step(model, config, group=None):
    """``eval_step(state, shard) -> {"loss", "accuracy"}``: the means
    over the ranks of ``group``."""
    return make_eval_step(model, config, group=_world(group))


__all__ = ["batch_sharding", "make_parallel_eval_step",
           "make_parallel_scan_train_step", "make_parallel_train_step",
           "replicate", "shard_batch"]
