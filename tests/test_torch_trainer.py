"""The port's trainer and its CLI on the CPU (``main(argv, device="cpu")``),
the twin of tests/test_trainer.py: an end-to-end run with video (metrics,
checkpoints, sample WAVs, generation from the run), auto-resume,
preemption, and the gate of this layer: a run stopped by preemption and
resumed with --auto_resume 1 ends with the params and optimizer state of
an uninterrupted run, bit for bit.  Plus the CLI's configuration against
the JAX package's for the same flags."""

import json
import wave

import numpy as np
import pytest
import torch

from movenet_tpu_torch.models.convert import flatten_tree, params_to_jax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    from movenet_tpu_torch.data import make_synthetic_dataset

    root = tmp_path_factory.mktemp("torch_trainer_ds")
    make_synthetic_dataset(
        root, categories=["breakdancing"], clips_per_category=4,
        audio_fps=2000, video_fps=2, duration_s=1.0, frame_hw=(48, 48),
        seed=3)
    return root


def _args(dataset_root, out, logs, extra=()):
    return [
        "--dataset", str(dataset_root),
        "--n_epochs", "2",
        "--batch_size", "2",
        "--val_batch_size", "2",
        "--learning_rate", "0.0003",
        "--input_channels", "64",
        "--residual_channels", "16",
        "--skip_channels", "16",
        "--layer_size", "3",
        "--stack_size", "2",
        "--checkpoint_every", "1",
        "--num_workers", "1",
        "--val_num_workers", "1",
        "--compute_dtype", "float32",
        "--model_output_path", str(out),
        "--training_logs_path", str(logs),
        "--log_samples_every", "2",
        "--generate_n_samples", "120",
        "--generate_temperature", "0.0",
        *extra,
    ]


def _shrink(monkeypatch, use_video=True):
    """1 s clips of 2 frames: 2 video frames * 10^3 = 2000 audio frames
    (the geometry is not a CLI flag)."""
    import movenet_tpu_torch.config as C

    orig = C.config_from_args

    def patched(args):
        cfg = orig(args)
        cfg.model_config.max_audio_frames = 2000
        cfg.model_config.max_video_frames = 2
        cfg.use_video = cfg.use_video and use_video
        return cfg

    monkeypatch.setattr(C, "config_from_args", patched)
    monkeypatch.setattr("movenet_tpu_torch.train.cli.config_from_args",
                        patched)


def _no_samples(args):
    i = args.index("--log_samples_every")
    return args[:i] + args[i + 2:]


def _state_arrays(state):
    params = flatten_tree(params_to_jax(state.module.state_dict()), sep="/")
    opt = state.optimizer.state_dict()
    return params, opt


def test_cli_end_to_end_video(dataset_root, tmp_path, monkeypatch):
    from movenet_tpu_torch.train.cli import main

    _shrink(monkeypatch)
    out, logs = tmp_path / "models", tmp_path / "logs"
    state = main(_args(dataset_root, out, logs), device="cpu")
    assert state.step == 4  # 2 epochs x (4 clips / batch 2)

    cfg_json = json.loads((out / "config.json").read_text())
    assert cfg_json["model_config"]["layer_size"] == 3
    lines = [json.loads(l) for l in
             (logs / "metrics.jsonl").read_text().splitlines()]
    assert {"train", "val", "epoch"} <= {l["tag"] for l in lines}
    train_lines = [l for l in lines if l["tag"] == "train"]
    assert [l["step"] for l in train_lines] == [2, 4]
    assert all(np.isfinite(l["loss"]) for l in train_lines)

    from movenet_tpu_torch.train import latest_step

    assert latest_step(out) == 1
    ckpt = out / "checkpoints" / "1"
    assert json.loads((ckpt / "state.json").read_text()) == {"step": 4}
    assert (ckpt / "optimizer.pt").is_file()

    # sample export at epoch 2 ((epoch + 1) % 2 == 0)
    wavs = list((out / "samples").rglob("*.wav"))
    assert {"original", "predicted", "generated"} <= \
        {p.name.split("_")[0] for p in wavs}
    with wave.open(str(wavs[0])) as fh:
        assert fh.getnchannels() == 2 and fh.getsampwidth() == 2
        assert fh.getnframes() > 0

    # generation from the run without a dataset, by the API and the CLI
    from movenet_tpu_torch.generate import generate_from_checkpoint
    from movenet_tpu_torch.generate import main as gen_main

    written = generate_from_checkpoint(
        out, n_samples=150, temperature=0.0, batch_size=1,
        out_dir=tmp_path / "gen", device="cpu")
    assert len(written["generated"]) == 1
    gen_main(["--checkpoint", str(out), "--n_samples", "150",
              "--temperature", "0.0", "--batch_size", "1",
              "--device", "cpu", "--out", str(tmp_path / "gen2")])
    cli_wavs = list((tmp_path / "gen2").rglob("generated_*.wav"))
    assert cli_wavs and cli_wavs[0].read_bytes() == \
        written["generated"][0].read_bytes()


def test_auto_resume(dataset_root, tmp_path, monkeypatch):
    from movenet_tpu_torch.train.cli import main

    _shrink(monkeypatch, use_video=False)
    out, logs = tmp_path / "m", tmp_path / "l"
    base = _no_samples(_args(dataset_root, out, logs,
                             extra=["--use_video", "0"]))
    s1 = main(base, device="cpu").step
    # every epoch is done: the resumed run trains no further
    state2 = main(base + ["--auto_resume", "1"], device="cpu")
    assert state2.step == s1 == 4
    # one more epoch continues from the checkpoint
    i = base.index("--n_epochs")
    more = base[:i] + ["--n_epochs", "3"] + base[i + 2:]
    assert main(more + ["--auto_resume", "1"], device="cpu").step == 6


class _PreemptAfter:
    """A PreemptionGuard whose flag rises at its ``n``-th read."""

    def __init__(self, n):
        import movenet_tpu_torch.train.trainer as T

        self.n = n
        self.base = T.PreemptionGuard

    def __call__(self, install=True):
        n = self.n

        class Guard(self.base):
            def __init__(self, install=True):
                super().__init__(install=False)
                self.reads = 0

            @property
            def requested(self):
                self.reads += 1
                return self.reads >= n

            @requested.setter
            def requested(self, v):
                pass

        return Guard()


def test_preemption_checkpoints_and_exits(dataset_root, tmp_path,
                                          monkeypatch):
    import movenet_tpu_torch.train.trainer as T
    from movenet_tpu_torch.train import latest_step
    from movenet_tpu_torch.train.cli import main

    monkeypatch.setattr(T, "PreemptionGuard", _PreemptAfter(2))
    _shrink(monkeypatch, use_video=False)
    out, logs = tmp_path / "m", tmp_path / "l"
    args = _no_samples(_args(dataset_root, out, logs,
                             extra=["--use_video", "0", "--n_epochs", "50"]))
    state = main(args, device="cpu")
    # preempted at the second step boundary, after one step
    assert state.step == 1 and latest_step(out) == 0


def test_preempted_resume_matches_uninterrupted(dataset_root, tmp_path,
                                                monkeypatch):
    """Preempted at the end of epoch 0 (the guard's third read), resumed
    with --auto_resume 1: the params and the optimizer state equal those
    of an uninterrupted 2-epoch run from the same seed."""
    import movenet_tpu_torch.train.trainer as T
    from movenet_tpu_torch.train import latest_step
    from movenet_tpu_torch.train.cli import main

    _shrink(monkeypatch, use_video=False)

    def args(name, extra=()):
        return _no_samples(_args(dataset_root, tmp_path / name,
                                 tmp_path / f"{name}_logs",
                                 extra=["--use_video", "0", *extra]))

    whole = main(args("whole"), device="cpu")
    real_guard = T.PreemptionGuard
    monkeypatch.setattr(T, "PreemptionGuard", _PreemptAfter(3))
    cut = main(args("cut"), device="cpu")
    assert cut.step == 2 and latest_step(tmp_path / "cut") == 0
    monkeypatch.setattr(T, "PreemptionGuard", real_guard)
    resumed = main(args("cut", ["--auto_resume", "1"]), device="cpu")
    assert resumed.step == whole.step == 4
    (pw, ow), (pr, orr) = _state_arrays(whole), _state_arrays(resumed)
    assert set(pw) == set(pr)
    for k in pw:
        np.testing.assert_array_equal(pr[k], pw[k], err_msg=k)
    assert orr["param_groups"] == ow["param_groups"]
    assert set(orr["state"]) == set(ow["state"])
    for i, s in ow["state"].items():
        for k, v in s.items():
            assert torch.equal(orr["state"][i][k], v), (i, k)


EXP02 = ["--use_video", "1", "--n_epochs", "10", "--batch_size", "2",
         "--learning_rate", "0.0003", "--input_channels", "64",
         "--residual_channels", "64", "--layer_size", "3", "--stack_size",
         "3", "--checkpoint_every", "1", "--fused_blocks", "1",
         "--auto_resume", "1"]


@pytest.mark.parametrize("which", ["exp02", "trainer_test"])
def test_config_from_args_matches_jax(which, tmp_path):
    from movenet_tpu.config import arg_parser as j_parser
    from movenet_tpu.config import config_from_args as j_config

    from movenet_tpu_torch.config import arg_parser, config_from_args

    if which == "exp02":
        argv = ["--dataset", "d", *EXP02, "--model_output_path",
                str(tmp_path / "m")]
    else:   # tests/test_trainer.py's flags, its schedule included
        argv = _args("d", tmp_path / "m", tmp_path / "l",
                     extra=["--scheduler", "OneCycleLR", "--remat", "1",
                            "--fused_strategy", "recompute"])
    got = config_from_args(arg_parser().parse_args(argv)).to_dict()
    want = j_config(j_parser().parse_args(argv)).to_dict()
    assert got == want


def test_unported_trainer_options_raise(tmp_path, monkeypatch):
    """--mesh_data 2 on a host with one card raises JAX's create_mesh
    error, from the trainer and from the CLI before it spawns
    anything."""
    from movenet_tpu_torch.config import arg_parser, config_from_args
    from movenet_tpu_torch.train.cli import main
    from movenet_tpu_torch.train.trainer import train_model

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    base = ["--dataset", "d", "--model_output_path", str(tmp_path)]
    for extra, err, match in (
            (["--mesh_data", "2"], ValueError,
             "mesh 2x1 does not cover 1 devices"),):
        cfg = config_from_args(arg_parser().parse_args([*base, *extra]))
        with pytest.raises(err, match=match):
            train_model("d", cfg, device="cpu")
        with pytest.raises(err, match=match):
            main([*base, *extra], device="cpu")


def test_chunk_batches():
    from movenet_tpu_torch.train.loop import Batch
    from movenet_tpu_torch.train.trainer import _chunk_batches

    bs = [Batch(codes=torch.full((2, 8), i)) for i in range(5)]
    out = list(_chunk_batches(iter(bs), 2, max_steps=5))
    assert [tuple(b.codes.shape) for b in out] == [(2, 2, 8), (2, 2, 8),
                                                   (2, 8)]
    assert int(out[1].codes[1, 0, 0]) == 3 and out[0].video is None


def test_cli_needs_cuda_by_default(dataset_root, tmp_path, monkeypatch):
    from movenet_tpu_torch.train.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _shrink(monkeypatch, use_video=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(_no_samples(_args(dataset_root, tmp_path / "m",
                               tmp_path / "l")))


def _script_flags(path):
    """The trainer flags an experiment script passes, "$@" dropped."""
    import shlex
    from pathlib import Path

    text = Path(path).read_text()
    body = text[text.index(".train.cli"):].split("\n", 1)[1]
    flags = shlex.split(body.replace("\\\n", " "))
    return [f for f in flags if f != "$@"]


@pytest.mark.parametrize("count,warns", [(0, False), (1, False),
                                          (4, True)])
def test_mesh_data_all_logs_the_device_count(count, warns, monkeypatch,
                                             caplog):
    """--mesh_data -1 at batch 6: the trainer logs how many cards the host
    has (count 0: a CPU run, one device) and the fitted data axis; on 4
    cards that is 3 ranks, with JAX's warning for the idle card."""
    import logging

    from movenet_tpu_torch.config import arg_parser, config_from_args
    from movenet_tpu_torch.train import trainer

    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    cfg = config_from_args(arg_parser().parse_args(
        ["--dataset", "d", "--mesh_data", "-1", "--batch_size", "6",
         "--val_batch_size", "6"]))
    with caplog.at_level(logging.INFO):
        mesh, ranks = trainer.data_parallel_plan(
            cfg, "cuda" if count else "cpu")
    if count:
        assert f"{count} CUDA device(s) visible" in caplog.text
    else:
        assert "the CPU, one device a process" in caplog.text
    data = 3 if warns else 1
    assert (mesh.data, mesh.seq, ranks) == (data, 1, data)
    assert f"mesh: data={data} seq=1" in caplog.text
    warned = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert bool(warned) == warns
    if warns:
        assert warned[0].getMessage() == (
            "mesh auto-fit: using 3 of 4 devices (data=3, seq=1) so the "
            "data axis divides batch_size=6")


def test_trainer_leaves_no_loader_thread_running(tmp_path, monkeypatch):
    """A run cut by its step cap while clips are still being decoded:
    when main() returns, every thread the loaders started has ended (none
    goes on reading clips whose directory the caller may remove, or sits
    in torch when the interpreter exits)."""
    import threading
    import time

    from movenet_tpu_torch.data import make_synthetic_dataset
    from movenet_tpu_torch.data.pipeline import DataLoader
    from movenet_tpu_torch.train.cli import main

    _shrink(monkeypatch, use_video=False)
    root = tmp_path / "ds"
    make_synthetic_dataset(
        root, categories=["breakdancing"], clips_per_category=40,
        audio_fps=2000, video_fps=2, duration_s=1.0, frame_hw=(48, 48),
        seed=5)
    load = DataLoader._load_example

    def slow_load(self, meta):
        time.sleep(0.05)
        return load(self, meta)

    monkeypatch.setattr(DataLoader, "_load_example", slow_load)
    args = _no_samples(_args(root, tmp_path / "out", tmp_path / "logs",
                             extra=["--use_video", "0", "--n_epochs", "1",
                                    "--n_steps_per_epoch", "1",
                                    "--num_workers", "2"]))
    before = set(threading.enumerate())
    assert main(args, device="cpu").step == 1
    left = [t.name for t in set(threading.enumerate()) - before
            if t.is_alive()]
    assert not left, left


@pytest.mark.parametrize("name", ["03_kinetics_scale_up",
                                  "04_kinetics_receptive_field"])
def test_experiment_scripts_match_jax(name, tmp_path, monkeypatch):
    """experiments/torch/<name>.sh passes the JAX script's flags, to the
    port's CLI, and both parse into the same TrainingConfig; the port
    plans it on one device as one rank.  On a host of 4 cards experiment
    03 (batch 3) trains on three ranks; experiment 04 (batch 2) would
    take two, whose rows its default validation batch of 3 does not
    split: it raises at start-up, where JAX fails in its sharded step."""
    from pathlib import Path

    from movenet_tpu.config import arg_parser as j_parser
    from movenet_tpu.config import config_from_args as j_config

    from movenet_tpu_torch.config import arg_parser, config_from_args
    from movenet_tpu_torch.train.trainer import data_parallel_plan

    root = Path(__file__).resolve().parents[1] / "experiments"
    flags = _script_flags(root / "torch" / f"{name}.sh")
    assert flags == _script_flags(root / f"{name}.sh")
    assert "movenet_tpu_torch.train.cli" in \
        (root / "torch" / f"{name}.sh").read_text()
    argv = [f if f != "$DATASET" else "d" for f in flags] + [
        "--model_output_path", str(tmp_path / "m")]
    cfg = config_from_args(arg_parser().parse_args(argv))
    assert cfg.to_dict() == j_config(j_parser().parse_args(argv)).to_dict()
    assert data_parallel_plan(cfg, "cpu")[0].data == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    if name.startswith("03"):
        assert data_parallel_plan(cfg, "cuda")[0].data == 3
    else:
        with pytest.raises(ValueError, match="val_batch_size 3 is not "
                           "divisible by the 2 data-parallel rank"):
            data_parallel_plan(cfg, "cuda")
    mc = cfg.model_config
    assert (mc.input_channels, mc.skip_channels) == (128, 8)
    assert mc.residual_channels == (32 if name.startswith("03") else 16)


def test_cli_schedule_and_scan_steps(dataset_root, tmp_path, monkeypatch):
    """OneCycleLR with --scan_steps 2: every step logs its learning_rate
    at its own step, and the run ends where single steps end, bit for
    bit."""
    from movenet_tpu_torch.train.cli import main
    from movenet_tpu_torch.train.optim import Schedules

    _shrink(monkeypatch, use_video=False)
    runs = {}
    for scan in ("1", "2"):
        logs = tmp_path / f"l{scan}"
        extra = ["--scheduler", "OneCycleLR", "--max_learning_rate", "0.003",
                 "--scan_steps", scan, "--log_every_n_steps", "1",
                 "--batch_size", "1", "--n_epochs", "1"]
        state = main(_no_samples(_args(dataset_root, tmp_path / f"m{scan}",
                                       logs, extra)), device="cpu")
        lines = [json.loads(l) for l in
                 (logs / "metrics.jsonl").read_text().splitlines()]
        runs[scan] = (state, [l for l in lines if l["tag"] == "train"])
    (s1, l1), (s2, l2) = runs["1"], runs["2"]
    assert s1.step == s2.step == 4
    assert [l["step"] for l in l2] == [l["step"] for l in l1] == [1, 2, 3, 4]
    sched = Schedules(_cfg_of(tmp_path / "m1"), 4)
    for a, b in zip(l1, l2):
        assert a["loss"] == b["loss"]
        assert a["learning_rate"] == b["learning_rate"] == \
            pytest.approx(float(sched(a["step"] - 1)), rel=1e-7)
    for (n, a), b in zip(s1.module.named_parameters(),
                         s2.module.parameters()):
        assert torch.equal(a, b), n


def _cfg_of(run_dir):
    from movenet_tpu_torch.config import TrainingConfig

    return TrainingConfig.from_json((run_dir / "config.json").read_text())



@pytest.mark.parametrize("flags,cards,procs", [
    (["--mesh_seq", "2"], 4, 1),
    (["--mesh_seq", "2", "--batch_size", "4"], 4, 1),
    (["--mesh_data", "-1", "--mesh_seq", "2", "--batch_size", "6"], 8, 1),
    (["--mesh_data", "2", "--mesh_seq", "2", "--batch_size", "4"], 4, 1),
    (["--mesh_data", "1", "--mesh_seq", "4"], 4, 1),
    (["--mesh_data", "2", "--mesh_seq", "2", "--batch_size", "4"], 2, 2),
    (["--mesh_data", "1", "--mesh_seq", "2"], 1, 2),
])
def test_mesh_seq_resolves_as_jax(flags, cards, procs, monkeypatch, caplog):
    """--mesh_seq resolves to JAX's mesh over the cards of every process
    (``create_mesh(config.mesh, batch_size=...)`` and its
    ``local_batch_size`` rule that the data axis spans the processes), and
    the CLI spawns data x seq / processes ranks a host; fused blocks asked
    for are logged as off."""
    import logging

    import jax

    from movenet_tpu.parallel import create_mesh as j_create_mesh
    from movenet_tpu.parallel import local_batch_size as j_local_batch_size

    from movenet_tpu_torch.config import arg_parser, config_from_args
    from movenet_tpu_torch.train import cli, trainer

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    batch = flags[flags.index("--batch_size") + 1] \
        if "--batch_size" in flags else "3"
    argv = ["--dataset", "d", "--val_batch_size", batch, "--fused_blocks",
            "1", *flags]
    if procs > 1:
        argv += ["--coordinator_address", "127.0.0.1:1", "--num_processes",
                 str(procs), "--process_id", "0"]
    cfg = config_from_args(arg_parser().parse_args(argv))
    monkeypatch.setattr(jax, "process_count", lambda: procs)
    try:
        jm = j_create_mesh(cfg.mesh, devices=jax.devices()[:cards * procs],
                           batch_size=cfg.batch_size)
        j_local_batch_size(cfg.batch_size * procs, jm)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            trainer.data_parallel_plan(cfg, "cuda")
        assert str(got.value).split(" for ")[0] == str(e).split(" for ")[0]
        return
    with caplog.at_level(logging.INFO):
        mesh, ranks = trainer.data_parallel_plan(cfg, "cuda")
    assert mesh.shape == dict(jm.shape)
    assert ranks == mesh.data * mesh.seq // procs
    assert "the fused route is off" in caplog.text

    spawned = []
    monkeypatch.setattr("torch.multiprocessing.spawn",
                        lambda fn, nprocs, join, args: spawned.append(
                            (nprocs, args[-1])))
    assert cli.main(argv) is None
    assert spawned == [(ranks, ranks)]
