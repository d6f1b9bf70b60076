"""Metric writers: JSONL (always), TensorBoard and Weights & Biases (when
their packages are installed).

The counterpart of ``movenet_tpu.utils.observability``: the same writer
protocol, the same ``metrics.jsonl`` records ({"tag", "step", "time",
**metrics}) and tags.  Only rank 0 writes: the rank comes from
``torch.distributed`` when it is initialised, else 0.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict, List, Optional

from movenet_tpu_torch.parallel.mesh import process_index

logger = logging.getLogger(__name__)




class Writer:
    def scalars(self, tag: str, values: Dict[str, float],
                step: int) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullWriter(Writer):
    def scalars(self, tag, values, step):
        pass


class JsonlWriter(Writer):
    """One JSON object per line: {"tag", "step", "time", **metrics}."""

    def __init__(self, path: Path):
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = path.open("a")

    def scalars(self, tag, values, step):
        rec = {"tag": tag, "step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()


class TensorBoardWriter(Writer):
    """Backed by torch.utils.tensorboard (needs the tensorboard package)."""

    def __init__(self, logdir: Path):
        from torch.utils.tensorboard import SummaryWriter

        self._w = SummaryWriter(log_dir=str(logdir))

    def scalars(self, tag, values, step):
        for k, v in values.items():
            self._w.add_scalar(f"{tag}/{k}", float(v), int(step))

    def close(self):
        self._w.close()


class WandbWriter(Writer):
    def __init__(self, project: str, config: Optional[dict] = None):
        import wandb

        self._run = wandb.init(project=project, config=config or {})
        self._wandb = wandb

    def scalars(self, tag, values, step):
        self._wandb.log(
            {f"{tag}/{k}": float(v) for k, v in values.items()},
            step=int(step))

    def close(self):
        self._run.finish()


class MultiWriter(Writer):
    def __init__(self, writers: List[Writer]):
        self.writers = writers

    def scalars(self, tag, values, step):
        for w in self.writers:
            w.scalars(tag, values, step)

    def close(self):
        for w in self.writers:
            w.close()


def make_writer(config) -> Writer:
    """The writer stack of a TrainingConfig; ranks other than 0 get a
    NullWriter."""
    if process_index() != 0:
        return NullWriter()
    writers: List[Writer] = [
        JsonlWriter(Path(config.tensorboard_dir) / "metrics.jsonl")
    ]
    if config.logger == "tensorboard":
        try:
            writers.append(TensorBoardWriter(Path(config.tensorboard_dir)))
        except ImportError:
            logger.warning("tensorboard unavailable; JSONL only")
    elif config.logger == "wandb":
        try:
            writers.append(WandbWriter(config.wandb_project,
                                       config.to_dict()))
        except ImportError:
            logger.warning("wandb unavailable; JSONL only")
    return MultiWriter(writers) if len(writers) > 1 else writers[0]


class StepTimer:
    """steps/sec counter that skips the first (warm-up) tick."""

    def __init__(self):
        self._t0 = None
        self._steps = 0

    def tick(self, n_steps: int = 1):
        if self._t0 is None:
            self._t0 = time.perf_counter()
            self._steps = 0
            return {}
        self._steps += n_steps
        dt = time.perf_counter() - self._t0
        if dt <= 0:
            return {}
        return {"steps_per_sec": self._steps / dt}


__all__ = ["Writer", "NullWriter", "JsonlWriter", "TensorBoardWriter",
           "WandbWriter", "MultiWriter", "make_writer", "StepTimer",
           "process_index"]
