"""The (data, seq) layout and the distributed runtime.

The counterpart of ``movenet_tpu.parallel.mesh`` for one process per
card.  A ``Mesh`` names the sizes of the JAX mesh's two axes:

  * ``data``: the batch is split over the ranks (one process, one card
    each); every rank holds the whole model and the gradients are
    averaged over the ranks before the update;
  * ``seq``: the time axis is split over the ranks of each data index,
    on the unfused route only, as in the JAX package
    (``parallel.sharding``).

Rank r sits at (data index ``r // seq``, seq index ``r % seq``), the
order of JAX's ``create_device_mesh((data, seq))``.

``initialize_distributed`` joins a rank to the run's process group:
NCCL for CUDA tensors, gloo for the CPU (or, when the caller names it,
for CUDA tensors too).
"""

from __future__ import annotations

import datetime
import logging
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
SEQ_AXIS = "seq"

# every collective waits this long for the slowest rank: rank 0 writes
# checkpoints and generates samples while the others wait at the epoch's
# barrier
TIMEOUT = datetime.timedelta(hours=1)


@dataclass(frozen=True)
class Mesh:
    """Axis sizes of a (data, seq) mesh; ``shape`` as JAX's ``Mesh.shape``."""

    data: int
    seq: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, SEQ_AXIS: self.seq}

    @property
    def size(self) -> int:
        """The ranks of the mesh."""
        return self.data * self.seq

    def coords(self, rank: int) -> Tuple[int, int]:
        """(data index, seq index) of ``rank``."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a {self.data}x{self.seq} "
                             "mesh")
        return divmod(rank, self.seq)


def process_index() -> int:
    """This rank (0 without an initialised process group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_count() -> int:
    """The number of ranks (1 without an initialised process group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def initialize_distributed(config, local_rank: int = 0, local_ranks: int = 1,
                           device="cuda", backend: Optional[str] = None,
                           address: Optional[str] = None) -> bool:
    """Join this rank to the run's process group; returns whether it did.

    ``address`` (host:port, default ``config.coordinator_address``) is
    rank 0's rendezvous.  The world is ``num_processes`` processes (hosts)
    of ``local_ranks`` ranks each; this rank's global rank is
    ``process_id * local_ranks + local_rank``.  Without an address there is
    nothing to join: one host, one rank, no process group (the JAX
    function is a no-op on a single host too).

    The backend is NCCL for ``device`` on CUDA and gloo on the CPU;
    ``backend`` overrides it.  On CUDA the rank's card is
    ``cuda:{local_rank}``, made current before anything is allocated.
    """
    import torch.distributed as dist

    address = address or config.coordinator_address
    if not address:
        return False
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    world = (config.num_processes or 1) * local_ranks
    rank = (config.process_id or 0) * local_ranks + local_rank
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    logger.info("distributed runtime: rank %d of %d over %s (%s), process "
                "%d of %d", rank, world, backend, address,
                config.process_id or 0, config.num_processes or 1)
    return True


def create_mesh(mesh_config=None, n_devices: Optional[int] = None,
                batch_size: Optional[int] = None) -> Mesh:
    """The (data, seq) sizes over ``n_devices`` (default: the visible
    cards), as the JAX package resolves them.

    mesh_config.data == -1 means "all devices not used by seq"; when a
    ``batch_size`` is also given, the data axis auto-fits to the largest
    divisor of the batch that the devices allow (idling the remainder
    with a warning) instead of failing on non-divisible batches.
    An explicitly requested shape is honored strictly.
    """
    n = torch.cuda.device_count() if n_devices is None else int(n_devices)
    if mesh_config is None:
        data, seq = n, 1
    else:
        data, seq = mesh_config.axis_sizes(n)
    auto_data = mesh_config is None or mesh_config.data <= 0
    if auto_data and batch_size is not None:
        avail = n // seq
        # largest divisor of the batch that fits the available devices
        # (gcd would idle devices needlessly: batch 6 on 4 devices must
        # give data=3, not gcd(6,4)=2)
        data = max(d for d in range(1, avail + 1) if batch_size % d == 0)
        if data * seq < n:
            logger.warning(
                "mesh auto-fit: using %d of %d devices (data=%d, seq=%d) "
                "so the data axis divides batch_size=%d",
                data * seq, n, data, seq, batch_size)
        n = data * seq
    if data * seq != n:
        raise ValueError(
            f"mesh {data}x{seq} does not cover {n} devices")
    return Mesh(data, seq)


def local_batch_size(global_batch_size: int, mesh: Mesh) -> int:
    """Per-process share of the global batch (the DistributedSampler
    equivalent, reference dataset.py:79-87): every process contributes
    ``global / process_count`` rows, which requires the data axis to span
    processes evenly.  The trainer follows the JAX trainer instead, whose
    processes (hosts) each load ``batch_size`` rows (ROADMAP.md C)."""
    data = mesh.shape[DATA_AXIS]
    procs = process_count()
    if global_batch_size % data:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by data-axis "
            f"size {data}")
    if data % procs:
        raise ValueError(
            f"data-axis size {data} must be a multiple of the process "
            f"count {procs} for per-process batch sharding")
    if global_batch_size % procs:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by process "
            f"count {procs}")
    return global_batch_size // procs


def sync_global_devices(name: str = "barrier", group=None) -> None:
    """Barrier across the ranks of ``group`` (the reference's
    dist.barrier(), trainer.py:385-387); nothing without a process
    group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        logger.debug("barrier %s", name)
        dist.barrier(group=group)


__all__ = ["DATA_AXIS", "SEQ_AXIS", "Mesh", "create_mesh",
           "initialize_distributed", "local_batch_size", "process_count",
           "process_index", "sync_global_devices", "TIMEOUT"]
