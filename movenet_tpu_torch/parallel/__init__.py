"""Parallelism: the (data, seq) mesh's axis sizes, distributed init,
sharding rules and the parallel steps.

The JAX package runs one SPMD program over a named device mesh; the
port runs one process per card (``torch.multiprocessing.spawn`` from
``train.cli``, the reference's ``dist_train_model``), each rank training
on its rows of the batch (and, on a ``seq`` axis, its window of the time
axis) with the gradients averaged over NCCL.
"""

from movenet_tpu_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    initialize_distributed,
    local_batch_size,
    sync_global_devices,
)
from movenet_tpu_torch.parallel.sharding import (
    batch_sharding,
    make_parallel_eval_step,
    make_parallel_scan_train_step,
    make_parallel_train_step,
    replicate,
    shard_batch,
    time_window,
    window_batch,
)

__all__ = [
    "create_mesh",
    "initialize_distributed",
    "local_batch_size",
    "sync_global_devices",
    "batch_sharding",
    "make_parallel_train_step",
    "make_parallel_scan_train_step",
    "make_parallel_eval_step",
    "replicate",
    "shard_batch",
    "Mesh",
    "time_window",
    "window_batch",
]
