"""Parameter checkpoints of the port, in the JAX package's run layout:

    <run>/checkpoints/<step>/params.npz   (flax parameter names)
    <run>/config.json                     (run config snapshot)

Each array is stored under its flax path joined by "/" (``head1/kernel``,
``blocks_w_cur`` ...), so the file holds exactly the tree that
``models/convert.py`` maps to and from a ``state_dict``.  Optimizer state
is not stored: the port does not train yet.  A JAX run's orbax checkpoint
is brought over by loading it with the JAX package and writing it here
with ``params_to_jax``'s tree.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Optional, Tuple

import numpy as np

from movenet_tpu_torch.models.convert import flatten_tree, unflatten_tree

PARAMS_FILE = "params.npz"


def latest_step(run_dir: Path) -> Optional[int]:
    root = Path(run_dir) / "checkpoints"
    steps = [int(p.name) for p in root.glob("*")
             if p.name.isdigit() and (p / PARAMS_FILE).is_file()]
    return max(steps) if steps else None


def save_params(run_dir: Path, step: int, params: Mapping,
                config=None) -> Path:
    """Write a flax-layout params tree at ``step`` (and ``config.json``
    when a config is given); returns the checkpoint directory."""
    ckpt = Path(run_dir) / "checkpoints" / str(int(step))
    ckpt.mkdir(parents=True, exist_ok=True)
    tmp = ckpt / (PARAMS_FILE + ".tmp.npz")
    np.savez(tmp, **flatten_tree(params, sep="/"))
    tmp.replace(ckpt / PARAMS_FILE)
    if config is not None:
        config.save(Path(run_dir) / "config.json")
    return ckpt


def restore_params(run_dir: Path, step: Optional[int] = None
                   ) -> Tuple[dict, int]:
    """(flax-layout params tree, step) of the given or latest step."""
    if step is None:
        step = latest_step(run_dir)
    if step is None:
        raise FileNotFoundError(
            f"no checkpoint found under {Path(run_dir) / 'checkpoints'}")
    path = Path(run_dir) / "checkpoints" / str(int(step)) / PARAMS_FILE
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return unflatten_tree(flat, sep="/"), int(step)
