"""The port's data-parallel layer (``movenet_tpu_torch.parallel``) on the
CPU against the JAX package's ``movenet_tpu.parallel``.

- ``create_mesh``: the same (data, seq), warning and error as JAX's over
  1..8 devices (the 8 virtual CPU devices of tests/conftest.py), batches
  1..8 and ``mesh_data`` in {-1, 1, 2, 4}; ``local_batch_size``'s errors
  by message.
- Two ranks over gloo (``tests/torch_dp_worker.py``, one process each),
  layer 4 x stack 2, C=32, R=S=16, float32, T=1280, Adam, 3 steps on a
  global batch of 4: fused, unfused, and fused with video and
  accumulation 2.  Against one port process on the same 4 rows: loss
  rtol 1e-6, grad_norm 1e-5 (the shard means are summed in another
  order), params within 0.01 lr a step; against JAX's
  ``make_parallel_train_step`` on a 2-device data mesh at the ranks'
  weights before each step (carried over by ``models/convert``): loss
  rtol 1e-5, grad_norm 1e-4, the float32 bars of
  tests/test_torch_train.py.  Both ranks' metrics and params are exactly
  equal after every step.
- The loader's rank slices, side by side, are the one-process batches.
- The trainer CLI in two processes (``--num_processes 2``, gloo).
"""

import json
import logging
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from movenet_tpu.config import MeshConfig as JMeshConfig
from movenet_tpu.config import ModelConfig as JModelConfig
from movenet_tpu.config import TrainingConfig as JTrainingConfig
from movenet_tpu.models.wavenet import WaveNet as JWaveNet
from movenet_tpu.models.wavenet import make_wavenet as j_make
from movenet_tpu.parallel import create_mesh as j_create_mesh
from movenet_tpu.parallel import local_batch_size as j_local_batch_size
from movenet_tpu.parallel import make_parallel_train_step as j_dp_step
from movenet_tpu.parallel import shard_batch as j_shard_batch
from movenet_tpu.train import create_train_state as j_create
from movenet_tpu.train import make_optimizer as j_make_optimizer
from movenet_tpu.train.loop import Batch as JBatch

from movenet_tpu_torch.config import MeshConfig, ModelConfig, TrainingConfig
from movenet_tpu_torch.models.convert import (
    flatten_tree,
    load_jax_params,
    params_to_jax,
)
from movenet_tpu_torch.models.wavenet import make_wavenet
from movenet_tpu_torch.parallel import create_mesh, local_batch_size
from movenet_tpu_torch.parallel import mesh as t_mesh
from movenet_tpu_torch.train import Batch, create_train_state, make_train_step

torch.set_num_threads(2)
WORKER = Path(__file__).parent / "torch_dp_worker.py"
TIMEOUT = 120
N_STEPS = 3
T = 1280


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(cmds, ok=True):
    """Run worker commands at once (each in its own session, so a timeout
    kills the ranks it spawned too); returns their outputs, after
    checking that each exited 0 (``ok``) or not."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), *c], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              start_new_session=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
        pytest.fail(f"data-parallel workers timed out after {TIMEOUT} s")
    for p, out in zip(procs, outs):
        assert (p.returncode == 0) == ok, out[-4000:]
    return outs


# ------------------------------------------------------------------ mesh
def _outcome(fn, caplog, logger):
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=logger):
        try:
            got, err = fn(), None
        except ValueError as e:
            got, err = None, str(e)
    return got, err, [r.getMessage() for r in caplog.records
                      if r.name == logger]


@pytest.mark.parametrize("mesh_data", [-1, 1, 2, 4])
@pytest.mark.parametrize("batch", range(1, 9))
@pytest.mark.parametrize("n", range(1, 9))
def test_create_mesh_matches_jax(n, batch, mesh_data, caplog):
    want = _outcome(lambda: dict(j_create_mesh(
        JMeshConfig(data=mesh_data), devices=jax.devices()[:n],
        batch_size=batch).shape), caplog, "movenet_tpu.parallel.mesh")
    got = _outcome(lambda: create_mesh(
        MeshConfig(data=mesh_data), n, batch_size=batch).shape, caplog,
        "movenet_tpu_torch.parallel.mesh")
    assert got == want


@pytest.mark.parametrize("global_batch,data,procs", [
    (15, 8, 1),    # the batch does not split over the data axis
    (12, 6, 4),    # the data axis does not split over the processes
    (16, 8, 2),    # fine: 8 rows a process
])
def test_local_batch_size_matches_jax(global_batch, data, procs,
                                      monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: procs)
    monkeypatch.setattr(t_mesh, "process_count", lambda: procs)
    jm = j_create_mesh(JMeshConfig(data=data), devices=jax.devices()[:data])
    tm = create_mesh(MeshConfig(data=data), data)
    try:
        want = j_local_batch_size(global_batch, jm)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            local_batch_size(global_batch, tm)
        assert str(got.value) == str(e)
    else:
        assert local_batch_size(global_batch, tm) == want == \
            global_batch // procs


# ------------------------------------------------------- two-rank steps
CASES = {
    "fused": dict(fused=True, video=False, accum=1),
    "unfused": dict(fused=False, video=False, accum=1),
    "fused_video_accum2": dict(fused=True, video=True, accum=2),
}
MODEL = dict(layer_size=4, stack_size=2, input_channels=32,
             residual_channels=16, skip_channels=16, compute_dtype="float32",
             max_audio_frames=T, max_video_frames=128)


def _case(name):
    c = CASES[name]
    cfg = dict(optimizer="Adam", learning_rate=1e-3, scheduler=None,
               batch_size=4, weight_decay=0.0, fused_blocks=c["fused"],
               accumulation_steps=c["accum"])
    lead = (c["accum"],) if c["accum"] > 1 else ()
    rng = np.random.default_rng(len(name))
    data = {"codes": rng.integers(0, 32, size=lead + (4, T)).astype(
        np.int32)}
    if c["video"]:
        data["video"] = rng.standard_normal(
            lead + (4, 128, 64, 64, 1)).astype(np.float32)
    return cfg, data


def _jax_params(data):
    first = (0,) * (data["codes"].ndim - 2)
    jm = j_make(JModelConfig(**MODEL))
    video = data.get("video")
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(data["codes"][first]),
                     None if video is None else jnp.asarray(video[first]),
                     None, method=JWaveNet.init_all)["params"]
    return jm, params


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """The two ranks' results of every case (one pair of workers)."""
    out = tmp_path_factory.mktemp("dp_steps")
    cases = {}
    for name in CASES:
        cfg, data = _case(name)
        _, params = _jax_params(data)
        np.savez(out / f"{name}_params.npz",
                 **flatten_tree(jax.device_get(params), sep="/"))
        np.savez(out / f"{name}.npz", **data)
        cases[name] = {"model": MODEL, "config": cfg}
    (out / "cases.json").write_text(json.dumps(cases))
    port = str(_free_port())
    _run_workers([["steps", port, str(r), str(out)] for r in (0, 1)])
    return {name: [dict(np.load(out / f"{name}_rank{r}.npz"))
                   for r in (0, 1)] for name in CASES}


def _one_process(name):
    cfg, data = _case(name)
    _, params = _jax_params(data)
    tm = load_jax_params(make_wavenet(ModelConfig(**MODEL)), params)
    tcfg = TrainingConfig(model_config=ModelConfig(**MODEL), **cfg)
    state = create_train_state(tm, tcfg, device="cpu")
    step = make_train_step(tm, tcfg)
    batch = Batch(**{k: torch.from_numpy(v) for k, v in data.items()})
    metrics = []
    for _ in range(N_STEPS):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {n: p.detach().numpy() for n, p in
                     tm.named_parameters()}


def _jax_mesh_metrics(name, rank_out):
    """JAX's data-parallel step on a 2-device mesh, at the weights the
    ranks hold before each of their steps: its loss, accuracy and
    grad_norm.  (Trajectories of their own would part: through the
    4096-wide frame projection Adam turns float32 noise into steps of up
    to lr, ROADMAP.md C.)"""
    cfg, data = _case(name)
    jm, params = _jax_params(data)
    jcfg = JTrainingConfig(model_config=JModelConfig(**MODEL),
                           fused_interpret=cfg["fused_blocks"], **cfg)
    jstate = j_create(jm, jcfg, j_make_optimizer(jcfg),
                      jax.random.PRNGKey(0),
                      JBatch(codes=jnp.asarray(data["codes"])))
    mesh = j_create_mesh(JMeshConfig(data=2), devices=jax.devices()[:2])
    metrics = []
    with mesh:
        step = j_dp_step(jm, jcfg, mesh, has_video="video" in data)
        batch = j_shard_batch(mesh, JBatch(codes=data["codes"],
                                           video=data.get("video")))
        for i in range(N_STEPS):
            if i:
                prefix = f"param{i - 1}/"
                params = jax.tree.map(jnp.asarray, params_to_jax({
                    k[len(prefix):]: torch.from_numpy(v)
                    for k, v in rank_out.items() if k.startswith(prefix)}))
            _, m = step(jstate.replace(params=params,
                                       opt_state=jstate.tx.init(params)),
                        batch)
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_one_process_and_jax_mesh(name, dp_runs):
    r0, r1 = dp_runs[name]
    # the ranks: the same metrics and params after every step, bit for bit
    assert set(r0) == set(r1)
    for k in r0:
        if k.startswith("digest"):
            assert r0[k] == r1[k], k
        else:
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    # equal weights load equal: the broadcast changes nothing
    assert r0["digest_before"] == r0["digest_after"]

    lr = _case(name)[0]["learning_rate"]
    n_valid = 4 * _case(name)[0]["accumulation_steps"] * (
        T - make_wavenet(ModelConfig(**MODEL)).receptive_fields)
    one, params = _one_process(name)
    for i, m in enumerate(one):
        np.testing.assert_allclose(r0["loss"][i], m["loss"], rtol=1e-6)
        np.testing.assert_allclose(r0["grad_norm"][i], m["grad_norm"],
                                   rtol=1e-5)
        assert abs(r0["accuracy"][i] - m["accuracy"]) <= 1.0 / n_valid \
            + 1e-7
    for n, p in params.items():
        np.testing.assert_allclose(r0[f"param{N_STEPS - 1}/{n}"], p, rtol=0,
                                   atol=1e-2 * lr * N_STEPS, err_msg=n)

    for i, m in enumerate(_jax_mesh_metrics(name, r0)):
        np.testing.assert_allclose(r0["loss"][i], m["loss"], rtol=1e-5)
        np.testing.assert_allclose(r0["grad_norm"][i], m["grad_norm"],
                                   rtol=1e-4)
        assert abs(r0["accuracy"][i] - m["accuracy"]) <= 1.0 / n_valid \
            + 1e-7


def test_ranks_draw_equal_weights_from_one_seed():
    """Two builds from one seed hold equal weights, so ``replicate`` is a
    guard, not what makes the ranks agree."""
    from movenet_tpu_torch.train.trainer import params_digest

    a, b = (make_wavenet(ModelConfig(**MODEL),
                         generator=torch.Generator().manual_seed(7))
            for _ in range(2))
    assert params_digest(a) == params_digest(b)


# --------------------------------------------------------------- loader
@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    from movenet_tpu_torch.data import make_synthetic_dataset

    root = tmp_path_factory.mktemp("dp_clips")
    make_synthetic_dataset(
        root, categories=["breakdancing", "krumping"], clips_per_category=6,
        audio_fps=2000, video_fps=2, duration_s=1.0, frame_hw=(32, 32),
        seed=5)
    return root


@pytest.mark.parametrize("accum,ranks", [(1, 2), (2, 2), (1, 4)])
def test_loader_rank_slices_join_to_one_process_batches(clips, accum,
                                                        ranks):
    """Each rank decodes only its columns; side by side, in rank order,
    they are the one-process batches bit for bit (shuffled order, crops
    and labels included)."""
    from movenet_tpu_torch.data.pipeline import get_dataloader

    kw = dict(input_channels=64, batch_size=4, accumulation_steps=accum,
              batch_subsample_frac=0.5, max_audio_frames=2000,
              max_video_frames=2, num_workers=2)
    whole = list(get_dataloader(clips, **kw).epoch(1))
    b = 4 // ranks
    parts = [list(get_dataloader(clips, rows=(r * b, (r + 1) * b),
                                 **kw).epoch(1)) for r in range(ranks)]
    assert len(whole) == 12 // (4 * accum) and \
        all(len(p) == len(whole) for p in parts)
    axis = int(accum > 1)
    for i, want in enumerate(whole):
        for field in ("codes", "video", "labels"):
            got = torch.cat([getattr(p[i], field) for p in parts], axis)
            assert torch.equal(got, getattr(want, field)), (i, field)
    # the crop is taken (half of each clip), and the classes differ
    assert whole[0].codes.shape[-1] == 1000
    assert len({int(x) for w in whole for x in w.labels.reshape(-1)}) == 2


def test_loader_rows_checked(clips):
    from movenet_tpu_torch.data.pipeline import get_dataloader

    with pytest.raises(ValueError, match="rows"):
        get_dataloader(clips, input_channels=64, batch_size=2, rows=(1, 3))


# ------------------------------------------------------------ trainer CLI
def _cli_args(root, out, logs, port, pid, epochs, extra=()):
    return ["--dataset", str(root), "--n_epochs", str(epochs),
            "--batch_size", "2", "--val_batch_size", "2",
            "--learning_rate", "0.0003", "--input_channels", "64",
            "--residual_channels", "16", "--skip_channels", "16",
            "--layer_size", "3", "--stack_size", "2",
            "--checkpoint_every", "1", "--num_workers", "1",
            "--val_num_workers", "1", "--compute_dtype", "float32",
            "--use_video", "0",
            "--model_output_path", str(out), "--training_logs_path",
            str(logs), "--log_samples_every", "2",
            "--generate_n_samples", "120", "--generate_temperature", "0.0",
            "--coordinator_address", f"127.0.0.1:{port}",
            "--num_processes", "2", "--process_id", str(pid), *extra]


def _cli_pair(tmp_path, root, out, logs, epochs, extra=(), ok=True):
    port = _free_port()
    cmds = []
    for pid in (0, 1):
        f = tmp_path / f"argv_{pid}_{epochs}.json"
        f.write_text(json.dumps(_cli_args(root, out, logs, port, pid, epochs,
                                          extra)))
        cmds.append(["cli", str(f)])
    return _run_workers(cmds, ok)


def _cli_clips(root):
    from movenet_tpu_torch.data import make_synthetic_dataset

    make_synthetic_dataset(root, categories=["breakdancing"],
                           clips_per_category=8, audio_fps=2000,
                           video_fps=2, duration_s=1.0, frame_hw=(32, 32),
                           seed=3)
    return root


def test_trainer_cli_failed_rank_exits_nonzero(tmp_path):
    """A rank that raises (here the fused path refuses T=2000) ends its
    launcher with a non-zero exit, and no launcher waits on."""
    root = _cli_clips(tmp_path / "ds")
    outs = _cli_pair(tmp_path, root, tmp_path / "m", tmp_path / "l", 1,
                     extra=["--fused_blocks", "1"], ok=False)
    assert all("fused path needs T % 128 == 0" in o for o in outs)


def test_trainer_cli_two_processes(tmp_path):
    """Two processes of one rank each (a host's share of the clip index,
    2 rows a step each: a global batch of 4): rank 0 alone writes
    config.json, the metrics and the checkpoints; the ranks end with equal
    params; --auto_resume 1 continues the run."""
    root = _cli_clips(tmp_path / "ds")
    out, logs = tmp_path / "models", tmp_path / "logs"
    logs0, _ = _cli_pair(tmp_path, root, out, logs, 2)
    assert "the 2 ranks' params are equal" in logs0
    assert "rank 1 of 2 over gloo" in logs0 + _

    cfg = json.loads((out / "config.json").read_text())
    assert cfg["num_processes"] == 2 and cfg["batch_size"] == 2
    lines = [json.loads(l) for l in
             (logs / "metrics.jsonl").read_text().splitlines()]
    # 8 clips over 2 processes, 2 rows a process: 2 steps an epoch, each
    # logged once (a second writer would double every line)
    assert [l["step"] for l in lines if l["tag"] == "train"] == [2, 4]
    assert [l["epoch"] for l in lines if l["tag"] == "epoch"] == [0, 1]
    assert len([l for l in lines if l["tag"] == "val"]) == 2
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == \
        ["0", "1"]
    assert json.loads((out / "checkpoints" / "1" / "state.json")
                      .read_text()) == {"step": 4}
    assert list((out / "samples").rglob("*.wav"))

    logs0, _ = _cli_pair(tmp_path, root, out, logs, 3,
                         extra=["--auto_resume", "1"])
    assert "auto-resumed at epoch 2 (step 4)" in logs0
    assert "the 2 ranks' params are equal" in logs0
    lines = [json.loads(l) for l in
             (logs / "metrics.jsonl").read_text().splitlines()]
    assert [l["step"] for l in lines if l["tag"] == "train"] == [2, 4, 6]
    assert json.loads((out / "checkpoints" / "2" / "state.json")
                      .read_text()) == {"step": 6}
