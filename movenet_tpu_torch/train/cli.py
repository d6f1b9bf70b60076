"""Training CLI.

    python -m movenet_tpu_torch.train.cli --dataset /path/to/kinetics ...

The JAX package's flag surface (``movenet_tpu.train.cli``), flag for
flag.  It trains on the CUDA card and raises without one; only a caller of
``main`` or ``train_model`` can ask for the CPU.

Several cards: ``--mesh_data -1`` (the default) fits the data axis to
the largest divisor of ``--batch_size`` that this host's cards allow
beside ``--mesh_seq`` (the time axis's ranks, default 1), ``--mesh_data
N`` asks for N exactly.  With a mesh of one rank and no coordinator the
run trains in this process.  Otherwise the CLI spawns one worker process
per rank of this host (the reference's ``dist_train_model`` with
``mp.spawn``), which join one process group over NCCL at
``--coordinator_address`` (a free localhost port when none is given).
Across hosts, start the CLI once on each host with the same
``--coordinator_address`` and ``--num_processes`` and its own
``--process_id``; host i's ranks are ``i * k .. i * k + k - 1`` of
``k = data * seq / num_processes`` a host.  A worker that fails ends
the launcher with an error.
"""

from __future__ import annotations

import logging
import socket

from movenet_tpu_torch.config import arg_parser, config_from_args

LOG_FORMAT = "%(asctime)s: %(levelname)s: %(name)s: %(message)s"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(local_rank: int, dataset: str, config, device: str,
               address: str, local_ranks: int) -> None:
    """One rank of the mesh (a spawned worker)."""
    import torch.distributed as dist

    from movenet_tpu_torch.parallel.mesh import initialize_distributed
    from movenet_tpu_torch.train.trainer import train_model

    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT)
    initialize_distributed(config, local_rank, local_ranks, device,
                           address=address)
    try:
        train_model(dataset, config, device=device)
    finally:
        dist.destroy_process_group()


def main(argv=None, device="cuda"):
    """Train per the flags; returns the final TrainState of an in-process
    run, None when spawned workers trained."""
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT)
    parser = arg_parser()
    args = parser.parse_args(argv)
    if not args.dataset:
        parser.error("--dataset is required")
    config = config_from_args(args)

    from movenet_tpu_torch.train.loop import training_device
    from movenet_tpu_torch.train.trainer import (
        data_parallel_plan,
        train_model,
    )

    device = training_device(device)
    mesh, ranks = data_parallel_plan(config, device)
    if mesh.size == 1 and not config.coordinator_address:
        return train_model(args.dataset, config, device=device)

    import torch.multiprocessing as mp

    address = config.coordinator_address or f"127.0.0.1:{_free_port()}"
    mp.spawn(_rank_main, nprocs=ranks, join=True,
             args=(args.dataset, config, device.type, address, ranks))
    return None


if __name__ == "__main__":
    main()
