"""Worker process of tests/test_torch_parallel.py (not a test file).

    python torch_dp_worker.py steps <port> <rank> <world> <dir>
        one of <world> ranks over gloo on the CPU: for each case in
        <dir>/cases.json whose mesh (``[data, seq]``, default ``[world,
        1]``) has <world> ranks, the case's weights (a flax tree,
        <case>_params.npz) and global batch (<case>.npz), this rank's
        part of it (``shard_batch``), the eval step and then the case's
        steps (default 3) of the parallel train step; writes
        <dir>/<case>_rank<rank>.npz (the eval metrics, per-step metrics,
        the params after each step, the shard's codes, the params' digest
        before and after ``replicate``, and that of a model drawn from
        seed 7).  A case with fused blocks on a seq mesh fails if the
        fused loss is called.
    python torch_dp_worker.py cli <argv.json>
        the trainer CLI (``train.cli.main(argv, device="cpu")``) with the
        clip geometry shrunk to 1 s clips of 2 frames
    python torch_dp_worker.py train <port> <rank> <argv.json>
        one rank of the trainer (``train_model``, the same geometry) on
        the flags' --mesh_data x --mesh_seq mesh over gloo: on the CPU a
        process has one device, so the mesh is given to the trainer
        instead of resolved over the devices, and every rank is a process
        of its own
"""

import json
import os
import sys

# a bare script's sys.path[0] is tests/: add the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)
N_STEPS = 3


def _batch(data, keys=("codes", "video", "labels")):
    from movenet_tpu_torch.train.loop import Batch

    return Batch(**{k: torch.from_numpy(data[k]) for k in keys
                    if k in data.files})


def run_steps(port: int, rank: int, world: int, out: str) -> None:
    from movenet_tpu_torch.config import ModelConfig, TrainingConfig
    from movenet_tpu_torch.models import fused
    from movenet_tpu_torch.models.convert import (
        load_jax_params,
        unflatten_tree,
    )
    from movenet_tpu_torch.models.wavenet import make_wavenet
    from movenet_tpu_torch.parallel import (
        Mesh,
        initialize_distributed,
        make_parallel_eval_step,
        make_parallel_train_step,
        replicate,
        shard_batch,
        sync_global_devices,
    )
    from movenet_tpu_torch.train import create_train_state
    from movenet_tpu_torch.train.trainer import params_digest

    def no_fused(*args, **kwargs):
        raise AssertionError("the fused loss ran on a seq mesh")

    cases = json.load(open(os.path.join(out, "cases.json")))
    joined = initialize_distributed(TrainingConfig(), local_rank=rank,
                                    local_ranks=world, device="cpu",
                                    address=f"127.0.0.1:{port}")
    assert joined and torch.distributed.get_world_size() == world
    real_fused = fused.fused_train_loss
    for name, case in cases.items():
        mesh = Mesh(*case.get("mesh", (world, 1)))
        if mesh.size != world:
            continue
        cfg = TrainingConfig(model_config=ModelConfig(**case["model"]),
                             **case["config"])
        tree = np.load(os.path.join(out, f"{name}_params.npz"))
        model = load_jax_params(make_wavenet(cfg.model_config),
                                unflatten_tree(dict(tree), sep="/"))
        state = create_train_state(model, cfg, device="cpu")
        before = params_digest(model)
        replicate(model)
        res = {"digest_before": before, "digest_after": params_digest(model),
               "digest_seeded": params_digest(make_wavenet(
                   cfg.model_config,
                   generator=torch.Generator().manual_seed(7)))}
        data = np.load(os.path.join(out, f"{name}.npz"))
        shard = shard_batch(_batch(data), rank, mesh.data, mesh.seq, model)
        res["shard_codes"] = shard.codes.numpy()
        fused.fused_train_loss = no_fused if mesh.seq > 1 else real_fused
        evals = make_parallel_eval_step(model, cfg, mesh=mesh)(
            state, shard.micro(0) if cfg.accumulation_steps > 1 else shard)
        for k, v in evals.items():
            res[f"eval_{k}"] = float(v)
        step = make_parallel_train_step(model, cfg, mesh=mesh)
        for i in range(case.get("steps", N_STEPS)):
            state, m = step(state, shard)
            for k, v in m.items():
                res.setdefault(k, []).append(float(v))
            for n, p in model.named_parameters():
                res[f"param{i}/{n}"] = p.detach().numpy().copy()
        np.savez(os.path.join(out, f"{name}_rank{rank}.npz"),
                 **{k: np.asarray(v) for k, v in res.items()})
    fused.fused_train_loss = real_fused
    sync_global_devices("done")
    torch.distributed.destroy_process_group()


def _shrunk(args):
    from movenet_tpu_torch.config import config_from_args

    cfg = config_from_args(args)
    cfg.model_config.max_audio_frames = 2000
    cfg.model_config.max_video_frames = 2
    return cfg


def run_cli(argv_file: str) -> None:
    from movenet_tpu_torch.train import cli

    cli.config_from_args = _shrunk
    cli.main(json.load(open(argv_file)), device="cpu")


def run_train(port: int, rank: int, argv_file: str) -> None:
    import logging

    from movenet_tpu_torch.config import TrainingConfig, arg_parser
    from movenet_tpu_torch.parallel import Mesh, initialize_distributed
    from movenet_tpu_torch.train import trainer

    logging.basicConfig(level=logging.INFO)
    args = arg_parser().parse_args(json.load(open(argv_file)))
    cfg = _shrunk(args)
    mesh = Mesh(cfg.mesh.data, cfg.mesh.seq)
    trainer.data_parallel_plan = lambda config, device: (mesh, mesh.size)
    initialize_distributed(TrainingConfig(), local_rank=rank,
                           local_ranks=mesh.size, device="cpu",
                           address=f"127.0.0.1:{port}")
    try:
        trainer.train_model(args.dataset, cfg, device="cpu")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "steps":
        run_steps(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5])
    elif sys.argv[1] == "train":
        run_train(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        run_cli(sys.argv[2])
