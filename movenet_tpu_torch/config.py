"""Configuration for movenet_tpu_torch.

The same dataclasses, fields and defaults as ``movenet_tpu.config``, with
the same JSON round trip, so the port reads a JAX run's ``config.json``
unchanged.  Fields that only steer the JAX trainer (mesh shape, Pallas
strategy, interpret mode) are kept so that a config written by either
package loads in the other; the port's serving path ignores them.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, List, Optional


@dataclass
class ModelConfig:
    """WaveNet architecture hyperparameters."""

    layer_size: int = 2
    stack_size: int = 2
    input_channels: int = 256
    residual_channels: int = 16
    skip_channels: int = 16
    context_in_channels: int = 1

    # canonical sequence geometry; the audio:video ratio must be a power
    # of the upsample stride (10) for the learned-upsampler schedule
    max_audio_frames: int = 160_000
    max_video_frames: int = 160

    # global (dance-category) conditioning classes; 0 disables
    global_classes: int = 0

    # video (local) conditioning capability: False builds no context convs
    use_context: bool = True

    # the reference's forward returns softmax probabilities and trains
    # cross-entropy on them; True keeps that loss surface
    parity_softmax_output: bool = True

    # "bfloat16" or "float32"; parameters are always stored in float32
    compute_dtype: str = "bfloat16"

    remat: bool = False
    fused_strategy: Optional[str] = None

    @property
    def dilations(self) -> List[int]:
        """``2^0..2^(L-1)`` repeated ``stack_size`` times."""
        return [
            2 ** l
            for _ in range(self.stack_size)
            for l in range(self.layer_size)
        ]

    @property
    def receptive_fields(self) -> int:
        return sum(self.dilations) + self.stack_size


@dataclass
class MeshConfig:
    """Device layout of a JAX training run (data, seq axes)."""

    data: int = -1
    seq: int = 1

    def axis_sizes(self, n_devices: int) -> tuple:
        data = self.data if self.data > 0 else max(1, n_devices // self.seq)
        return (data, self.seq)


@dataclass
class TrainingConfig:
    """Training-run configuration, field for field as in movenet_tpu."""

    model_config: ModelConfig = field(default_factory=ModelConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # --- core training loop ---------------------------------------------
    batch_size: int = 3
    val_batch_size: int = 3
    checkpoint_every: int = 25
    optimizer: str = "AdamW"
    learning_rate: float = 0.0001
    momentum: float = 0.9
    accumulation_steps: int = 1
    num_workers: int = 0
    val_num_workers: int = 0
    pin_memory: bool = False
    weight_decay: float = 0.0
    n_epochs: int = 100
    n_steps_per_epoch: Optional[int] = None
    use_video: bool = True
    fused_blocks: bool = False
    fused_interpret: bool = False
    gradient_clipping: Optional[float] = 0.0
    flat_optimizer: bool = True
    scan_steps: int = 1
    batch_subsample_frac: Optional[float] = None
    val_batch_subsample_frac: Optional[float] = None
    seed: int = 0

    # --- sample generation ------------------------------------------------
    generate_n_samples: Optional[int] = None
    generate_temperature: float = 1.0

    # --- LR schedule ------------------------------------------------------
    scheduler: Optional[str] = "OneCycleLR"
    lr_pct_start: float = 0.45
    base_learning_rate: float = 0.0003
    scheduler_step_size_up: int = 1000
    scheduler_step_size_down: Optional[int] = None
    scheduler_cyclic_mode: str = "triangular"
    scheduler_cyclic_gamma: float = 1.0
    scheduler_cycle_momentum: bool = False
    max_learning_rate: float = 0.003
    scheduler_step_size: int = 10
    scheduler_step_gamma: float = 0.1
    scheduler_milestones: Optional[List[int]] = None

    # --- distributed ------------------------------------------------------
    dist_backend: Optional[str] = None
    dist_port: str = "8888"
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    # --- model IO ---------------------------------------------------------
    pretrained_model_path: Optional[Path] = None
    pretrained_run_exp_name: Optional[str] = None
    model_output_path: Path = Path("models")
    auto_resume: bool = False

    # --- logging ----------------------------------------------------------
    tensorboard_dir: Path = Path("tensorboard_logs")
    log_every_n_steps: int = 50
    log_samples_every: Optional[int] = None
    logger: Optional[str] = None
    wandb_project: str = "dance2music-tpu"
    log_video: bool = False

    # ---------------------------------------------------------------- JSON
    def to_dict(self) -> dict:
        def enc(v: Any):
            if isinstance(v, Path):
                return str(v)
            if dataclasses.is_dataclass(v) and not isinstance(v, type):
                return {k: enc(x) for k, x in dataclasses.asdict(v).items()}
            if isinstance(v, dict):
                return {k: enc(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [enc(x) for x in v]
            return v

        return {
            f.name: enc(getattr(self, f.name))
            for f in dataclasses.fields(self)
        }

    def to_json(self, **kwargs) -> str:
        return json.dumps(self.to_dict(), **kwargs)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainingConfig":
        d = dict(d)
        model = d.pop("model_config", {}) or {}
        mesh = d.pop("mesh", {}) or {}
        known = {f.name for f in dataclasses.fields(cls)}
        clean = {k: v for k, v in d.items() if k in known}
        for key in ("pretrained_model_path", "model_output_path",
                    "tensorboard_dir"):
            if clean.get(key) is not None:
                clean[key] = Path(clean[key])
        model_known = {f.name for f in dataclasses.fields(ModelConfig)}
        mesh_known = {f.name for f in dataclasses.fields(MeshConfig)}
        return cls(
            model_config=ModelConfig(
                **{k: v for k, v in model.items() if k in model_known}),
            mesh=MeshConfig(
                **{k: v for k, v in mesh.items() if k in mesh_known}),
            **clean,
        )

    @classmethod
    def from_json(cls, s: str) -> "TrainingConfig":
        return cls.from_dict(json.loads(s))

    def save(self, path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json(indent=2))

    @classmethod
    def load(cls, path: Path) -> "TrainingConfig":
        return cls.from_json(Path(path).read_text())
