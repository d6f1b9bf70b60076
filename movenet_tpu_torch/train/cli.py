"""Training CLI.

    python -m movenet_tpu_torch.train.cli --dataset /path/to/kinetics ...

The JAX package's flag surface (``movenet_tpu.train.cli``), flag for
flag.  It trains on the CUDA card and raises without one; only a caller of
``main`` or ``train_model`` can ask for the CPU.
"""

from __future__ import annotations

import logging

from movenet_tpu_torch.config import arg_parser, config_from_args


def main(argv=None, device="cuda"):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s: %(levelname)s: %(name)s: %(message)s")
    parser = arg_parser()
    args = parser.parse_args(argv)
    if not args.dataset:
        parser.error("--dataset is required")
    config = config_from_args(args)

    from movenet_tpu_torch.train.trainer import train_model

    return train_model(args.dataset, config, device=device)


if __name__ == "__main__":
    main()
