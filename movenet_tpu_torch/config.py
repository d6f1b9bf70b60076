"""Configuration for movenet_tpu_torch.

The same dataclasses, fields and defaults as ``movenet_tpu.config``, with
the same JSON round trip, so the port reads a JAX run's ``config.json``
unchanged, and the same trainer CLI (``arg_parser``, ``config_from_args``)
with the same flags and defaults.  Fields that only steer the JAX trainer
(interpret mode, the flat optimizer) are kept so that a config written by
either package loads in the other; the port ignores them.
"""

from __future__ import annotations

import argparse
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


def _bool_flag(x: str) -> bool:
    return bool(int(x))


def arg_parser() -> argparse.ArgumentParser:
    """The JAX trainer's CLI surface, flag for flag and default for
    default (the CLI defaults differ from the dataclass defaults)."""
    p = argparse.ArgumentParser(description="movenet_tpu_torch trainer")
    p.add_argument("--dataset", type=str)
    p.add_argument("--batch_size", type=int, default=3)
    p.add_argument("--val_batch_size", type=int, default=3)
    p.add_argument("--optimizer", type=str, default="AdamW")
    p.add_argument("--learning_rate", type=float, default=0.001)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--scheduler", type=str, default=None)
    p.add_argument("--lr_pct_start", type=float, default=0.45)
    p.add_argument("--base_learning_rate", type=float, default=0.0003)
    p.add_argument("--scheduler_step_size_up", type=int, default=1000)
    p.add_argument("--scheduler_step_size_down", type=int, default=None)
    p.add_argument("--scheduler_cyclic_mode", type=str, default="triangular")
    p.add_argument("--scheduler_cyclic_gamma", type=float, default=1.0)
    p.add_argument("--scheduler_cycle_momentum", type=_bool_flag,
                   default=False)
    p.add_argument("--max_learning_rate", type=float, default=0.003)
    p.add_argument("--scheduler_step_size", type=int, default=10)
    p.add_argument("--scheduler_step_gamma", type=float, default=0.1)
    p.add_argument(
        "--scheduler_milestones",
        type=lambda x: [int(i) for i in json.loads(x)],
        default=None,
    )
    p.add_argument("--accumulation_steps", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=1)
    p.add_argument("--val_num_workers", type=int, default=1)
    p.add_argument("--pin_memory", type=_bool_flag, default=False)
    p.add_argument("--generate_n_samples", type=int, default=None)
    p.add_argument("--generate_temperature", type=float, default=1.0)
    p.add_argument("--n_epochs", type=int, default=10)
    p.add_argument("--n_steps_per_epoch", type=int, default=None)
    p.add_argument("--use_video", type=_bool_flag, default=True)
    p.add_argument("--batch_subsample_frac", type=float, default=None)
    p.add_argument("--val_batch_subsample_frac", type=float, default=None)
    p.add_argument("--gradient_clipping", type=float, default=0.0)
    p.add_argument("--checkpoint_every", type=int, default=1)
    p.add_argument("--input_channels", type=int, default=16)
    p.add_argument("--residual_channels", type=int, default=16)
    p.add_argument("--skip_channels", type=int, default=8)
    p.add_argument("--layer_size", type=int, default=3)
    p.add_argument("--stack_size", type=int, default=3)
    p.add_argument("--global_classes", type=int, default=0)
    p.add_argument("--fused_blocks", type=_bool_flag, default=False)
    p.add_argument("--flat_optimizer", type=_bool_flag, default=True)
    p.add_argument("--scan_steps", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    # distributed: the processes and the (data, seq) mesh, resolved by
    # train.trainer.data_parallel_plan (--dist_backend, --dist_port:
    # parsed and stored)
    p.add_argument("--dist_backend", type=str, default=None)
    p.add_argument("--dist_port", type=str, default="8888")
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--mesh_data", type=int, default=-1)
    p.add_argument("--mesh_seq", type=int, default=1)
    # model knobs
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--parity_softmax_output", type=_bool_flag, default=True)
    p.add_argument("--remat", type=_bool_flag, default=False)
    p.add_argument("--fused_strategy", type=str, default=None,
                   choices=["auto", "save", "replay", "recompute"])
    # model IO
    p.add_argument(
        "--pretrained_model_path",
        type=lambda x: None if not x else Path(x),
        default=None,
    )
    p.add_argument(
        "--pretrained_run_exp_name",
        type=lambda x: None if not x else x,
        default=None,
    )
    p.add_argument("--model_output_path", type=Path, default=None)
    p.add_argument("--auto_resume", type=_bool_flag, default=False)
    p.add_argument("--training_logs_path", type=Path,
                   default=Path("training_logs"))
    # logging
    p.add_argument("--logger", default=None, type=str,
                   choices=["wandb", "tensorboard", "jsonl"])
    p.add_argument("--log_every_n_steps", type=int, default=50)
    p.add_argument("--log_samples_every", type=int, default=None)
    p.add_argument("--log_video", type=_bool_flag, default=False)
    p.add_argument("--wandb_api_key", type=str, default="")
    p.add_argument("--wandb_project", type=str, default="dance2music-tpu")
    return p


def config_from_args(args: argparse.Namespace) -> TrainingConfig:
    """Map parsed CLI args onto a TrainingConfig, as the JAX package
    does."""
    from datetime import datetime

    out_path = args.model_output_path
    if out_path is None:
        out_path = Path("models") / datetime.now().strftime("%Y%m%d%H%M%S")

    return TrainingConfig(
        model_config=ModelConfig(
            layer_size=args.layer_size,
            stack_size=args.stack_size,
            input_channels=args.input_channels,
            residual_channels=args.residual_channels,
            skip_channels=args.skip_channels,
            compute_dtype=args.compute_dtype,
            parity_softmax_output=args.parity_softmax_output,
            remat=args.remat,
            fused_strategy=args.fused_strategy,
            global_classes=args.global_classes,
        ),
        mesh=MeshConfig(data=args.mesh_data, seq=args.mesh_seq),
        batch_size=args.batch_size,
        val_batch_size=args.val_batch_size,
        checkpoint_every=args.checkpoint_every,
        optimizer=args.optimizer,
        learning_rate=args.learning_rate,
        momentum=args.momentum,
        weight_decay=args.weight_decay,
        accumulation_steps=args.accumulation_steps,
        num_workers=args.num_workers,
        val_num_workers=args.val_num_workers,
        pin_memory=args.pin_memory,
        n_epochs=args.n_epochs,
        n_steps_per_epoch=args.n_steps_per_epoch,
        use_video=args.use_video,
        fused_blocks=args.fused_blocks,
        flat_optimizer=args.flat_optimizer,
        scan_steps=args.scan_steps,
        gradient_clipping=args.gradient_clipping,
        batch_subsample_frac=args.batch_subsample_frac,
        val_batch_subsample_frac=args.val_batch_subsample_frac,
        seed=args.seed,
        generate_n_samples=args.generate_n_samples,
        generate_temperature=args.generate_temperature,
        scheduler=args.scheduler,
        lr_pct_start=args.lr_pct_start,
        base_learning_rate=args.base_learning_rate,
        scheduler_step_size_up=args.scheduler_step_size_up,
        scheduler_step_size_down=args.scheduler_step_size_down,
        scheduler_cyclic_mode=args.scheduler_cyclic_mode,
        scheduler_cyclic_gamma=args.scheduler_cyclic_gamma,
        scheduler_cycle_momentum=args.scheduler_cycle_momentum,
        max_learning_rate=args.max_learning_rate,
        scheduler_step_size=args.scheduler_step_size,
        scheduler_step_gamma=args.scheduler_step_gamma,
        scheduler_milestones=args.scheduler_milestones,
        dist_backend=args.dist_backend,
        dist_port=args.dist_port,
        coordinator_address=args.coordinator_address,
        num_processes=args.num_processes,
        process_id=args.process_id,
        pretrained_model_path=(
            args.pretrained_model_path
            if args.pretrained_model_path else None
        ),
        pretrained_run_exp_name=args.pretrained_run_exp_name,
        model_output_path=out_path,
        auto_resume=args.auto_resume,
        tensorboard_dir=args.training_logs_path,
        log_every_n_steps=args.log_every_n_steps,
        log_samples_every=args.log_samples_every,
        logger=args.logger,
        wandb_project=args.wandb_project,
        log_video=args.log_video,
    )
