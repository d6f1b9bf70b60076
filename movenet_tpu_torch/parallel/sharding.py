"""Batch sharding and the parallel steps.

The counterpart of ``movenet_tpu.parallel.sharding`` for one process per
card.  Layout, as in the JAX package:

  * parameters and optimizer state: replicated on every rank (channel
    sizes are at most 256, so tensor parallelism buys nothing; the
    reference replicates too, via DDP);
  * batch codes (B, T) / (A, B, T), video (B, F, H, W, C) and labels
    (B,): the batch axis on ``data``; the rank at data index i holds
    rows ``[i*b, (i+1)*b)`` with ``b = B / data``;
  * with ``seq`` > 1 the codes' time axis on ``seq``: the clip's T - RF
    target positions are split evenly over the seq ranks, and the rank
    at seq index j holds its own positions' samples plus the halo they
    reach back to (1 + the sum of the dilations: the front's shift of
    one and each layer's), a ``train.loop.TimeWindow``.  The video stays
    whole on every seq rank (JAX keeps it replicated over ``seq``); each
    rank encodes the whole clip and cuts the context to its window.

JAX gets the gradient all-reduce from pjit (or from shard_map's
transpose on the fused path) and GSPMD inserts the causal shifts' halo
exchanges; here the train step all-reduces one flat float32 buffer of
every gradient, the loss and the accuracy (``train.loop.make_train_step(
..., group=..., mesh=...)``), and the windows need no other exchange:
each rank recomputes its halo (22 rows at experiment 01's stack, 3,070
at the flagship's), instead of two dependent exchanges a layer.
"""

from __future__ import annotations

from dataclasses import replace as _replace
from typing import Optional, Tuple

import torch

from movenet_tpu_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS, Mesh
from movenet_tpu_torch.train.loop import (
    Batch,
    TimeWindow,
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


def batch_sharding(leading, shard_time: Optional[bool] = None,
                   mesh: Optional[Mesh] = None) -> Batch:
    """Each field's axes as a PartitionSpec tuple (a Batch of tuples).

    ``leading`` counts replicated leading axes ahead of the batch dim:
    0 for a plain (B, ...) batch, 1 for gradient accumulation (A, B, ...)
    OR a scanned multi-step batch (N, B, ...), 2 for both (N, A, B, ...).
    A bool is accepted (True == 1).  ``shard_time`` None: the codes' time
    axis is on ``seq`` when ``mesh`` has a seq axis above 1 (no mesh:
    one rank of seq).
    """
    if shard_time is None:
        shard_time = mesh is not None and mesh.seq > 1
    lead = (None,) * int(leading)
    return Batch(codes=(*lead, DATA_AXIS, SEQ_AXIS if shard_time else None),
                 video=(*lead, DATA_AXIS, None, None, None, None),
                 labels=(*lead, DATA_AXIS),
                 codes_pack=None)


def time_window(t: int, model, seq: int, index: int
                ) -> Tuple[TimeWindow, int]:
    """(window, stop) of seq index ``index`` of ``seq`` on clips of ``t``
    samples: the rank holds samples ``[window.start, stop)``.  The T - RF
    target positions split evenly (the first ranks get one fewer when
    they do not divide); a rank's halo is the samples its first own
    logit reaches back to, 1 + the sum of ``model``'s dilations (RF - S +
    1), cut at the clip's start (only rank 0's first logits see the zero
    fill there, as in the unsharded run)."""
    rf = model.receptive_fields
    reach = 1 + sum(model.dilations)
    n = t - rf
    if n < seq:
        raise ValueError(
            f"{max(n, 0)} target positions (T={t} less RF={rf}) do not "
            f"split over seq={seq}")
    lo, hi = n * index // seq, n * (index + 1) // seq
    start = max(0, rf - 1 + lo - reach)
    return TimeWindow(start=start, first=rf - 1 + lo - start,
                      share=(hi - lo) / n), rf + hi


def window_batch(batch: Batch, model, seq: int, index: int) -> Batch:
    """``batch`` (whole clips, any leading axes) cut to seq index
    ``index``'s window of its time axis; the video stays whole and the
    codes pack is dropped (the window runs the unfused route)."""
    window, stop = time_window(batch.codes.shape[-1], model, seq, index)
    return _replace(batch, codes=batch.codes[..., window.start:stop],
                    codes_pack=None, window=window)


def shard_batch(batch: Batch, rank: Optional[int] = None,
                data: Optional[int] = None, seq: int = 1,
                model=None) -> Batch:
    """Rank ``rank``'s part of a host ``batch`` on a (``data``, ``seq``)
    mesh (defaults: this rank, and a data axis over every rank the seq
    axis leaves): the rows of its data index and, with ``seq`` > 1, the
    window of its seq index (``window_batch``; the halo depends on
    ``model``, a WaveNet).  The codes pack holds the batch in its lanes
    and cannot be split: it is dropped, and the fused loss builds each
    shard's own on the device (as JAX rebuilds it per shard)."""
    from movenet_tpu_torch.parallel.mesh import process_count, process_index

    rank = process_index() if rank is None else rank
    data = process_count() // seq if data is None else data
    index, seq_index = Mesh(data, seq).coords(rank)
    if seq > 1 and model is None:
        raise ValueError("sharding the time axis needs the model (its "
                         "receptive field sets the halo)")
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
        return x.narrow(axis, index * b, b)

    shard = _replace(batch, codes=take(batch.codes, spec.codes),
                     video=take(batch.video, spec.video),
                     labels=take(batch.labels, spec.labels),
                     codes_pack=None)
    return window_batch(shard, model, seq, seq_index) if seq > 1 else shard


def make_parallel_train_step(model, config, group=None,
                             mesh: Optional[Mesh] = None):
    """``train_step(state, shard) -> (state, metrics)`` of one rank of
    ``mesh`` (default: a data axis over the ranks of ``group``, itself
    every rank by default): ``shard`` is this rank's part of the batch
    (``shard_batch``); the loss, accuracy and gradients are the means
    over every position of the global batch, so every rank takes the
    update and logs the metrics of the whole batch.  On a mesh with seq
    > 1 the fused route is off, as in the JAX package."""
    return make_train_step(model, config, group=_world(group), mesh=mesh)


def make_parallel_scan_train_step(model, config, n_steps: int, group=None,
                                  mesh: Optional[Mesh] = None):
    """``n_steps`` parallel optimizer steps per call on batches stacked
    on a leading (n_steps, ...) axis; metrics stacked (n_steps,)."""
    return make_scan_train_step(model, config, n_steps, group=_world(group),
                                mesh=mesh)


def make_parallel_eval_step(model, config, group=None,
                            mesh: Optional[Mesh] = None):
    """``eval_step(state, shard) -> {"loss", "accuracy"}``: the means
    over every position of the global batch."""
    return make_eval_step(model, config, group=_world(group), mesh=mesh)


__all__ = ["batch_sharding", "make_parallel_eval_step",
           "make_parallel_scan_train_step", "make_parallel_train_step",
           "replicate", "shard_batch", "time_window", "window_batch"]
