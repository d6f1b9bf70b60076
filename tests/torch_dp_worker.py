"""Worker process of tests/test_torch_parallel.py (not a test file).

    python torch_dp_worker.py steps <port> <rank> <dir>
        one of two ranks over gloo on the CPU: for each case in
        <dir>/cases.json, the case's weights (a flax tree, <case>_params.npz)
        and global batch
        (<case>.npz), this rank's rows, 3 data-parallel train steps;
        writes <dir>/<case>_rank<rank>.npz (per-step metrics, the params
        after each step, the params' digest before and after
        ``replicate``, and that of a model drawn from seed 7)
    python torch_dp_worker.py cli <argv.json>
        the trainer CLI (``train.cli.main(argv, device="cpu")``) with the
        clip geometry shrunk to 1 s clips of 2 frames
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


def run_steps(port: int, rank: int, out: str) -> None:
    from movenet_tpu_torch.config import ModelConfig, TrainingConfig
    from movenet_tpu_torch.models.convert import (
        load_jax_params,
        unflatten_tree,
    )
    from movenet_tpu_torch.models.wavenet import make_wavenet
    from movenet_tpu_torch.parallel import (
        initialize_distributed,
        make_parallel_train_step,
        replicate,
        shard_batch,
        sync_global_devices,
    )
    from movenet_tpu_torch.train import create_train_state
    from movenet_tpu_torch.train.trainer import params_digest

    cases = json.load(open(os.path.join(out, "cases.json")))
    joined = initialize_distributed(TrainingConfig(), local_rank=rank,
                                    local_ranks=2, device="cpu",
                                    address=f"127.0.0.1:{port}")
    assert joined and torch.distributed.get_world_size() == 2
    for name, case in cases.items():
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
        shard = shard_batch(_batch(data), rank, 2)
        step = make_parallel_train_step(model, cfg)
        for i in range(N_STEPS):
            state, m = step(state, shard)
            for k, v in m.items():
                res.setdefault(k, []).append(float(v))
            for n, p in model.named_parameters():
                res[f"param{i}/{n}"] = p.detach().numpy().copy()
        np.savez(os.path.join(out, f"{name}_rank{rank}.npz"),
                 **{k: np.asarray(v) for k, v in res.items()})
    sync_global_devices("done")
    torch.distributed.destroy_process_group()


def run_cli(argv_file: str) -> None:
    import movenet_tpu_torch.config as C
    from movenet_tpu_torch.train import cli

    orig = C.config_from_args

    def shrunk(args):
        cfg = orig(args)
        cfg.model_config.max_audio_frames = 2000
        cfg.model_config.max_video_frames = 2
        return cfg

    cli.config_from_args = shrunk
    cli.main(json.load(open(argv_file)), device="cpu")


if __name__ == "__main__":
    if sys.argv[1] == "steps":
        run_steps(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        run_cli(sys.argv[2])
