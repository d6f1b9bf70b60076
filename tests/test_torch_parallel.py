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
- The sequence axis: gloo ranks on (data 1, seq 2) meshes (with and
  without video, stack 1, a T - RF that does not split evenly, fused
  blocks asked for) and one (data 2, seq 2) mesh in four processes,
  layer 2 x stack 2, C=32, R=S=16, float32, T=512 (640 with video), B=2,
  SGD, 2 steps, against JAX's ``make_parallel_train_step`` and
  ``make_parallel_eval_step`` on ``create_mesh(MeshConfig(data=d,
  seq=s))`` (the uneven case against JAX's unsharded step, which the
  mesh equals), each on its own two steps: loss and accuracy
  rtol 1e-5, grad_norm 1e-4, the same against the port's one process,
  and the two steps' update of every parameter within 1e-3 of its
  leaf's largest against both; every rank's metrics and params equal.  ``shard_batch``'s windows for every
  layout.
- The loader's rank slices, side by side, are the one-process batches;
  the seq ranks of one data index load equal batches.
- The trainer CLI in two processes (``--num_processes 2``, gloo), also
  on the sequence axis.
"""

import functools
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
from movenet_tpu.parallel import make_parallel_eval_step as j_dp_eval
from movenet_tpu.parallel import make_parallel_train_step as j_dp_step
from movenet_tpu.parallel import shard_batch as j_shard_batch
from movenet_tpu.train import create_train_state as j_create
from movenet_tpu.train import make_optimizer as j_make_optimizer
from movenet_tpu.train.loop import Batch as JBatch
from movenet_tpu.train.loop import make_eval_step as j_eval_step
from movenet_tpu.train.loop import make_train_step as j_train_step

from movenet_tpu_torch.config import MeshConfig, ModelConfig, TrainingConfig
from movenet_tpu_torch.models.convert import (
    flatten_tree,
    load_jax_params,
    params_to_jax,
)
from movenet_tpu_torch.models.wavenet import make_wavenet
from movenet_tpu_torch.parallel import (
    Mesh,
    create_mesh,
    local_batch_size,
    shard_batch,
)
from movenet_tpu_torch.parallel import mesh as t_mesh
from movenet_tpu_torch.train import (
    Batch,
    create_train_state,
    make_eval_step,
    make_train_step,
)

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
    _run_workers([["steps", port, str(r), "2", str(out)] for r in (0, 1)])
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
        if k == "shard_codes":
            continue
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


# ---------------------------------------------------------- sequence axis
SEQ_T = 512
SEQ_STEPS = 2
SEQ_CASES = {
    "seq2": dict(mesh=(1, 2)),
    "seq2_video_accum2": dict(mesh=(1, 2), video=True, accum=2, t=640,
                              frames=64),
    "seq2_stack1": dict(mesh=(1, 2), stack=1),
    "seq2_uneven": dict(mesh=(1, 2), t=SEQ_T + 1),
    "seq2_fused": dict(mesh=(1, 2), fused=True),
    "data2_seq2": dict(mesh=(2, 2)),
}


def _seq_case(name):
    """(model dict, config dict, global batch) of a sequence-axis case."""
    c = SEQ_CASES[name]
    t = c.get("t", SEQ_T)
    model = dict(layer_size=2, stack_size=c.get("stack", 2),
                 input_channels=32, residual_channels=16, skip_channels=16,
                 compute_dtype="float32", max_audio_frames=t,
                 max_video_frames=c.get("frames", 64))
    accum = c.get("accum", 1)
    # SGD: its update is the gradient, so the params after two steps hold
    # every element of the gradients against the reference (Adam's would
    # give rounding-noise elements steps of up to lr, as above)
    cfg = dict(optimizer="SGD", learning_rate=2.0, scheduler=None,
               batch_size=2, weight_decay=0.0,
               fused_blocks=c.get("fused", False), accumulation_steps=accum)
    lead = (accum,) if accum > 1 else ()
    rng = np.random.default_rng(100 + len(name))
    data = {"codes": rng.integers(0, 32, size=lead + (2, t)).astype(
        np.int32)}
    if c.get("video"):
        data["video"] = rng.standard_normal(
            lead + (2, model["max_video_frames"], 64, 64, 1)).astype(
                np.float32)
    return model, cfg, data


@functools.lru_cache(maxsize=None)
def _seq_init(name):
    """(JAX model, its initial params) of a sequence-axis case."""
    model, _, data = _seq_case(name)
    first = (0,) * (data["codes"].ndim - 2)
    jm = j_make(JModelConfig(**model))
    video = data.get("video")
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(data["codes"][first]),
                     None if video is None else jnp.asarray(video[first]),
                     None, method=JWaveNet.init_all)["params"]
    return jm, params


def _seq_workers(tmp_path_factory, world):
    """Every rank's results of the sequence-axis cases of ``world``
    ranks (one worker a rank)."""
    out = tmp_path_factory.mktemp(f"seq_steps{world}")
    names = [n for n, c in SEQ_CASES.items() if Mesh(*c["mesh"]).size == world]
    cases = {}
    for name in names:
        model, cfg, data = _seq_case(name)
        np.savez(out / f"{name}_params.npz",
                 **flatten_tree(jax.device_get(_seq_init(name)[1]), sep="/"))
        np.savez(out / f"{name}.npz", **data)
        cases[name] = {"model": model, "config": cfg,
                       "mesh": SEQ_CASES[name]["mesh"], "steps": SEQ_STEPS}
    (out / "cases.json").write_text(json.dumps(cases))
    port = str(_free_port())
    _run_workers([["steps", port, str(r), str(world), str(out)]
                  for r in range(world)])
    return {name: [dict(np.load(out / f"{name}_rank{r}.npz"))
                   for r in range(world)] for name in names}


@pytest.fixture(scope="module")
def seq_runs2(tmp_path_factory):
    return _seq_workers(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def seq_runs4(tmp_path_factory):
    return _seq_workers(tmp_path_factory, 4)


def _seq_jax(name):
    """JAX's eval step and SEQ_STEPS train steps on the case's mesh (the
    uneven case: unsharded): the eval metrics, each step's metrics and
    the params after the last step (as the port's named parameters)."""
    model, cfg, data = _seq_case(name)
    jm, params = _seq_init(name)
    jcfg = JTrainingConfig(model_config=JModelConfig(**model),
                           fused_interpret=cfg["fused_blocks"], **cfg)
    state = j_create(jm, jcfg, j_make_optimizer(jcfg),
                     jax.random.PRNGKey(0),
                     JBatch(codes=jnp.asarray(data["codes"])))
    state = state.replace(params=params, opt_state=state.tx.init(params))
    d, s = SEQ_CASES[name]["mesh"]
    lead = (0,) * (data["codes"].ndim - 2)
    jb = JBatch(codes=data["codes"], video=data.get("video"))
    eb = JBatch(codes=data["codes"][lead],
                video=None if "video" not in data else data["video"][lead])
    has_video = "video" in data
    mesh = j_create_mesh(JMeshConfig(data=d, seq=s),
                         devices=jax.devices()[:d * s])
    with mesh:
        if name == "seq2_uneven":
            step = jax.jit(j_train_step(jm, jcfg))
            evals = jax.jit(j_eval_step(jm, jcfg))
            batch, ebatch = (JBatch(codes=jnp.asarray(b.codes))
                             for b in (jb, eb))
        else:
            step = j_dp_step(jm, jcfg, mesh, has_video=has_video)
            evals = j_dp_eval(jm, jcfg, mesh, has_video=has_video)
            batch, ebatch = j_shard_batch(mesh, jb), j_shard_batch(mesh, eb)
        ev = {k: float(v) for k, v in evals(state, ebatch).items()}
        metrics = []
        for _ in range(SEQ_STEPS):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    tm = load_jax_params(make_wavenet(ModelConfig(**model)),
                         jax.device_get(state.params))
    return ev, metrics, {n: p.detach().numpy()
                         for n, p in tm.named_parameters()}


def _seq_one_process(name):
    """The port's one process on the whole batch: SEQ_STEPS steps'
    metrics, the params before and after them."""
    model, cfg, data = _seq_case(name)
    tm = load_jax_params(make_wavenet(ModelConfig(**model)),
                         _seq_init(name)[1])
    init = {n: p.detach().numpy().copy() for n, p in tm.named_parameters()}
    tcfg = TrainingConfig(model_config=ModelConfig(**model), **cfg)
    state = create_train_state(tm, tcfg, device="cpu")
    step = make_train_step(tm, tcfg)
    batch = Batch(**{k: torch.from_numpy(v) for k, v in data.items()})
    metrics = []
    for _ in range(SEQ_STEPS):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, init, {n: p.detach().numpy() for n, p in
                           tm.named_parameters()}


@pytest.mark.parametrize("name", list(SEQ_CASES))
def test_seq_ranks_match_jax_mesh(name, request):
    ranks = request.getfixturevalue(
        f"seq_runs{Mesh(*SEQ_CASES[name]['mesh']).size}")[name]
    r0 = ranks[0]
    # every rank: the same metrics and params after every step, bit for
    # bit (the seq ranks' windows differ, their update does not)
    for r in ranks[1:]:
        assert set(r) == set(r0)
        for k in r0:
            if k not in ("shard_codes", "digest_before", "digest_after"):
                np.testing.assert_array_equal(r[k], r0[k], err_msg=k)
    assert all(r["digest_before"] == r["digest_after"] for r in ranks)

    ev, jax_metrics, jax_params = _seq_jax(name)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(r0[f"eval_{k}"], ev[k], rtol=1e-5,
                                   err_msg=k)
    one, init, one_params = _seq_one_process(name)
    for want in (jax_metrics, one):
        for i, m in enumerate(want):
            for k, rtol in (("loss", 1e-5), ("accuracy", 1e-5),
                            ("grad_norm", 1e-4)):
                np.testing.assert_allclose(r0[k][i], m[k], rtol=rtol,
                                           err_msg=f"step {i} {k}")
    # the two steps' update of every element, to 1e-3 of its leaf's
    # largest (a halo one row short moves grad_norm by 7e-4)
    for want in (jax_params, one_params):
        for n, p in want.items():
            moved = p - init[n]
            np.testing.assert_allclose(
                r0[f"param{SEQ_STEPS - 1}/{n}"] - init[n], moved, rtol=0,
                atol=1e-3 * np.abs(moved).max(), err_msg=n)


@pytest.mark.parametrize("leading", [0, 1, 2])
@pytest.mark.parametrize("seq", [1, 2])
def test_batch_sharding_matches_jax(leading, seq):
    """Each field's axes as JAX's ``batch_sharding`` gives them on a
    (data 2, seq) mesh: time on ``seq`` when it is above 1, or when
    asked."""
    from movenet_tpu.parallel import batch_sharding as j_batch_sharding

    from movenet_tpu_torch.parallel import batch_sharding

    jm = j_create_mesh(JMeshConfig(data=2, seq=seq),
                       devices=jax.devices()[:2 * seq])
    for shard_time in (None, True, False):
        want = j_batch_sharding(jm, leading, shard_time)
        got = batch_sharding(leading, shard_time, Mesh(2, seq))
        for field in ("codes", "video", "labels"):
            assert getattr(got, field) == tuple(getattr(want, field)), field


@pytest.mark.parametrize("lead", [(), (2,), (3, 2)])
@pytest.mark.parametrize("stack,t,seq", [(2, 512, 2), (1, 513, 2),
                                         (3, 700, 4)])
def test_shard_batch_windows(lead, stack, t, seq):
    """Every layout: each rank holds its data rows and a window of the
    codes whose own positions, joined over the seq ranks, are the clip's
    T - RF targets once each; its halo is the stack's reach (RF - S + 1)
    cut at the clip's start; the video and labels are its rows, whole."""
    model = make_wavenet(ModelConfig(layer_size=3, stack_size=stack,
                                     input_channels=8, residual_channels=4,
                                     skip_channels=4, max_audio_frames=t))
    rf = model.receptive_fields
    reach = rf - stack + 1
    data = 2
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 8, size=lead + (4, t)))
    video = torch.randn(lead + (4, 3, 2, 2, 1))
    labels = torch.arange(4).expand(lead + (4,))
    batch = Batch(codes=codes, video=video, labels=labels,
                  codes_pack=torch.zeros(1))
    for d in range(data):
        rows = slice(2 * d, 2 * d + 2)
        owned, shares = [], 0.0
        for s_ in range(seq):
            shard = shard_batch(batch, d * seq + s_, data, seq, model)
            w = shard.window
            own_from = w.start + w.first
            assert w.start == max(0, own_from - reach)
            width = shard.codes.shape[-1]
            assert torch.equal(shard.codes, codes[..., rows, w.start:
                                                  w.start + width])
            assert torch.equal(shard.video, video[..., rows, :, :, :, :])
            assert torch.equal(shard.labels, labels[..., rows])
            assert shard.codes_pack is None
            # logit rows first .. width - 2: targets first+1 .. width-1
            owned += list(range(own_from + 1 - rf, w.start + width - rf))
            shares += w.share
            assert w.share == pytest.approx(
                (w.start + width - own_from - 1) / (t - rf))
        assert owned == list(range(t - rf))
        assert shares == pytest.approx(1.0)
    with pytest.raises(ValueError, match="needs the model"):
        shard_batch(batch, 0, data, seq)


def test_seq_step_needs_a_window():
    """A step on a seq mesh refuses whole clips (each rank would count
    every position), and any other step refuses a window (it would
    divide the windows' sums by the wrong count)."""
    mc = ModelConfig(**dict(MODEL, layer_size=2))
    model = make_wavenet(mc)
    cfg = TrainingConfig(model_config=mc, optimizer="Adam", scheduler=None)
    state = create_train_state(model, cfg, device="cpu")
    batch = Batch(codes=torch.zeros(2, 64, dtype=torch.int32))
    window = shard_batch(batch, 1, 1, 2, model)
    for make in (make_train_step, make_eval_step):
        with pytest.raises(ValueError, match="time window"):
            make(model, cfg, mesh=Mesh(1, 2))(state, batch)
        for mesh in (None, Mesh(2, 1)):
            with pytest.raises(ValueError, match="whole clips"):
                make(model, cfg, mesh=mesh)(state, window)


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


@pytest.mark.parametrize("accum", [1, 2])
def test_loader_seq_ranks_load_equal_batches(clips, accum):
    """On a (data 2, seq 2) mesh at batch 4 the two seq ranks of each data
    index pass the same rows: their loaders walk the same clips and draw
    the same crops, so they hold equal batches (which each then cuts to
    its window)."""
    from movenet_tpu_torch.data.pipeline import get_dataloader

    kw = dict(input_channels=64, batch_size=4, accumulation_steps=accum,
              batch_subsample_frac=0.5, max_audio_frames=2000,
              max_video_frames=2, num_workers=2)
    for rows in ((0, 2), (2, 4)):
        first, second = (list(get_dataloader(clips, rows=rows, **kw)
                              .epoch(3)) for _ in range(2))
        assert len(first) == len(second) == 12 // (4 * accum)
        for a, b in zip(first, second):
            for field in ("codes", "video", "labels"):
                assert torch.equal(getattr(a, field), getattr(b, field))


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


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_trainer_seq_ranks_match_one_process(tmp_path, mesh):
    """The trainer on a (data, seq) mesh of gloo ranks (with video, fused
    blocks asked for and taken off, cropped clips) logs the losses of the
    unfused one-process run on the same clips within 1e-5 (accuracies
    within one position), ends with its params (SGD: no Adam steps on rounding noise), and
    its ranks end with equal params: the seq ranks of one data index load
    the same rows and crops."""
    from movenet_tpu_torch.config import arg_parser, config_from_args
    from movenet_tpu_torch.train.trainer import train_model

    root = _cli_clips(tmp_path / "ds")
    batch = str(2 * mesh[0])

    def argv(name, extra):
        return ["--dataset", str(root), "--n_epochs", "1", "--batch_size",
                batch, "--val_batch_size", batch, "--optimizer", "SGD",
                "--learning_rate", "0.5",
                "--input_channels", "64", "--residual_channels", "16",
                "--skip_channels", "16", "--layer_size", "3",
                "--stack_size", "2", "--num_workers", "1",
                "--val_num_workers", "1", "--compute_dtype", "float32",
                "--use_video", "1", "--batch_subsample_frac", "0.5",
                "--log_samples_every", "0", "--logger", "jsonl",
                "--model_output_path", str(tmp_path / name / "m"),
                "--training_logs_path", str(tmp_path / name / "l"), *extra]

    f = tmp_path / "argv.json"
    f.write_text(json.dumps(argv("seq", [
        "--mesh_data", str(mesh[0]), "--mesh_seq", str(mesh[1]),
        "--fused_blocks", "1"])))
    port = str(_free_port())
    outs = _run_workers([["train", port, str(r), str(f)]
                         for r in range(mesh[0] * mesh[1])])
    n = mesh[0] * mesh[1]
    assert f"the {n} ranks' params are equal" in outs[0]

    # the workers' geometry: 1 s clips of 2 frames
    one = config_from_args(arg_parser().parse_args(argv("one", [])))
    one.model_config.max_audio_frames = 2000
    one.model_config.max_video_frames = 2
    train_model(str(root), one, device="cpu")

    def logged(name):
        lines = [json.loads(l) for l in (tmp_path / name / "l" /
                 "metrics.jsonl").read_text().splitlines()]
        return {tag: [(l["step"], l["loss"], l["accuracy"]) for l in lines
                      if l["tag"] == tag] for tag in ("train", "val")}

    got, want = logged("seq"), logged("one")
    # 1 s clips of 2000 samples cropped to half, RF 16: an argmax tie
    # broken the other way moves the accuracy by one position
    n_valid = int(batch) * (1000 - 16)
    for tag in ("train", "val"):
        assert [s for s, *_ in got[tag]] == [s for s, *_ in want[tag]]
        assert want[tag]
        for (_, gl, ga), (_, wl, wa) in zip(got[tag], want[tag]):
            np.testing.assert_allclose(gl, wl, rtol=1e-5)
            assert abs(ga - wa) <= 1.0 / n_valid + 1e-7
    a = np.load(tmp_path / "seq" / "m" / "checkpoints" / "0" / "params.npz")
    b = np.load(tmp_path / "one" / "m" / "checkpoints" / "0" / "params.npz")
    for k in b.files:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5, err_msg=k)
