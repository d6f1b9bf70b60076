"""Checkpoints of the port: params, optimizer state and step, with resume.

The counterpart of ``movenet_tpu.train.checkpoint``, in the JAX package's
run layout:

    <run>/checkpoints/<index>/params.npz      (flax parameter names)
    <run>/checkpoints/<index>/optimizer.pt    (torch optimizer state_dict)
    <run>/checkpoints/<index>/state.json      ({"step": update count})
    <run>/config.json                         (run config snapshot)

``params.npz`` stores each array under its flax path joined by "/"
(``head1/kernel``, ``blocks_w_cur`` ...), the tree that
``models/convert.py`` maps to and from a ``state_dict``, so ``generate``
and ``serve`` read a checkpoint of either kind.  The trainer indexes
checkpoints by epoch, as the JAX trainer does.  A checkpoint directory is
written whole under a temporary name and then renamed, so a run stopped
mid-save leaves the previous checkpoints intact.

A JAX run's orbax checkpoint is brought over by restoring it with the JAX
package and writing its params here (``save_params``): orbax imports JAX,
which this package never does.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from pathlib import Path
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from movenet_tpu_torch.models.convert import (
    flatten_tree,
    load_jax_params,
    params_to_jax,
    unflatten_tree,
)

logger = logging.getLogger(__name__)

PARAMS_FILE = "params.npz"
OPTIM_FILE = "optimizer.pt"
STATE_FILE = "state.json"


def latest_step(run_dir: Path) -> Optional[int]:
    """The largest checkpoint index under ``run_dir``, or None."""
    root = Path(run_dir) / "checkpoints"
    steps = [int(p.name) for p in root.glob("*")
             if p.name.isdigit() and (p / PARAMS_FILE).is_file()]
    return max(steps) if steps else None


def _write_dir(run_dir: Path, index: int, write) -> Path:
    """Write a checkpoint directory through ``write(tmp_dir)`` and move it
    into place (replacing an older one of the same index)."""
    root = Path(run_dir) / "checkpoints"
    root.mkdir(parents=True, exist_ok=True)
    final = root / str(int(index))
    tmp = root / f".{int(index)}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    write(tmp)
    if final.exists():
        old = root / f".{int(index)}.old-{os.getpid()}"
        final.rename(old)
        tmp.rename(final)
        shutil.rmtree(old, ignore_errors=True)
    else:
        tmp.rename(final)
    return final


def save_params(run_dir: Path, step: int, params: Mapping,
                config=None) -> Path:
    """Write a flax-layout params tree at index ``step`` (and
    ``config.json`` when a config is given); returns the checkpoint
    directory."""
    def write(d):
        np.savez(d / PARAMS_FILE, **flatten_tree(params, sep="/"))
        (d / STATE_FILE).write_text(json.dumps({"step": int(step)}))

    ckpt = _write_dir(run_dir, step, write)
    if config is not None:
        config.save(Path(run_dir) / "config.json")
    return ckpt


def restore_params(run_dir: Path, step: Optional[int] = None
                   ) -> Tuple[dict, int]:
    """(flax-layout params tree, index) of the given or latest index."""
    if step is None:
        step = latest_step(run_dir)
    if step is None:
        raise FileNotFoundError(
            f"no checkpoint found under {Path(run_dir) / 'checkpoints'}")
    path = Path(run_dir) / "checkpoints" / str(int(step)) / PARAMS_FILE
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return unflatten_tree(flat, sep="/"), int(step)


def migrate_legacy_block_params(params: dict) -> dict:
    """Convert a pre-stacking parameter tree (per-block ``block_{i}``
    submodules with w_cur / context_proj / residual_proj / skip_proj /
    global_proj leaves) to the stacked ``blocks_*`` (L, ...) layout.
    Returns ``params`` unchanged when it is already stacked."""
    if "block_0" not in params:
        return params
    out = {k: v for k, v in params.items()
           if not (k.startswith("block_") and k[6:].isdigit())}
    blocks = []
    while f"block_{len(blocks)}" in params:
        blocks.append(params[f"block_{len(blocks)}"])

    def stack(get):
        return np.stack([np.asarray(get(b)) for b in blocks])

    out["blocks_w_cur"] = stack(lambda b: b["w_cur"])
    out["blocks_w_past"] = stack(lambda b: b["w_past"])
    if "context_proj" in blocks[0]:
        out["blocks_ctx_kernel"] = stack(
            lambda b: b["context_proj"]["kernel"])
        out["blocks_ctx_bias"] = stack(
            lambda b: b["context_proj"]["bias"])
    out["blocks_res_kernel"] = stack(
        lambda b: b["residual_proj"]["kernel"])
    out["blocks_res_bias"] = stack(lambda b: b["residual_proj"]["bias"])
    out["blocks_skip_kernel"] = stack(lambda b: b["skip_proj"]["kernel"])
    out["blocks_skip_bias"] = stack(lambda b: b["skip_proj"]["bias"])
    if "global_proj" in blocks[0]:
        out["blocks_global_kernel"] = stack(
            lambda b: b["global_proj"]["kernel"])
    return out


class CheckpointManager:
    """Checkpoints of one run directory (the JAX package's manager API:
    ``save``, ``restore``, ``latest_step``; saves are synchronous, so
    there is nothing to wait for or close)."""

    def __init__(self, directory: Path):
        self.run_dir = Path(directory).absolute()
        self.directory = self.run_dir / "checkpoints"
        self.directory.mkdir(parents=True, exist_ok=True)

    def save(self, index: int, state) -> Path:
        """Params, optimizer state and step of a ``TrainState``."""
        params = params_to_jax(state.module.state_dict())

        def write(d):
            np.savez(d / PARAMS_FILE, **flatten_tree(params, sep="/"))
            torch.save(state.optimizer.state_dict(), d / OPTIM_FILE)
            (d / STATE_FILE).write_text(json.dumps({"step": int(state.step)}))

        return _write_dir(self.run_dir, index, write)

    def restore(self, state, index: Optional[int] = None):
        """Load a checkpoint into ``state`` (its module and optimizer, in
        place); returns the state with the saved step.

        A legacy per-block tree is migrated, and saved leaves the model
        lacks (context convs of an audio-only run) are dropped; in both
        cases the optimizer state followed the old leaves and is reset,
        with a warning.  Params and step always round-trip."""
        from dataclasses import replace

        tree, index = restore_params(self.run_dir, index)
        meta = self.directory / str(index) / STATE_FILE
        step = json.loads(meta.read_text())["step"] if meta.is_file() else 0
        template = set(flatten_tree(params_to_jax(state.module.state_dict()),
                                    sep="/"))
        reset = None
        if "block_0" in tree:
            tree = migrate_legacy_block_params(tree)
            reset = ("uses the legacy per-block parameter layout: migrating "
                     "params to the stacked layout")
        flat = flatten_tree(tree, sep="/")
        saved = set(flat)
        if template < saved:
            extra = sorted(saved - template)
            flat = {k: flat[k] for k in template}
            reset = reset or ("has parameter leaves the current model "
                              f"lacks ({', '.join(extra)}): dropping them")
        elif saved != template:
            raise ValueError(
                f"checkpoint {index} under {self.directory} does not match "
                f"the model: missing {sorted(template - saved)}, extra "
                f"{sorted(saved - template)}")
        load_jax_params(state.module, unflatten_tree(flat, sep="/"))
        optim = self.directory / str(index) / OPTIM_FILE
        if reset is not None or not optim.is_file():
            logger.warning("checkpoint at step %s %s and RESETTING optimizer "
                           "state", index, reset or "has no optimizer state")
            state.optimizer.state.clear()
        else:
            dev = next(state.module.parameters()).device
            state.optimizer.load_state_dict(
                torch.load(optim, map_location=dev, weights_only=True))
        return replace(state, step=int(step))

    def latest_step(self) -> Optional[int]:
        return latest_step(self.run_dir)


def save_checkpoint(directory: Path, step: int, state,
                    config=None) -> Path:
    """One-shot save (also snapshots ``config.json``)."""
    path = CheckpointManager(directory).save(step, state)
    if config is not None:
        config.save(Path(directory) / "config.json")
    return path


def restore_checkpoint(directory: Path, state, step: Optional[int] = None):
    return CheckpointManager(directory).restore(state, step)
