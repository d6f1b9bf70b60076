"""The port's LR schedules and momentum cycling (train/optim.py) against
the JAX package's (movenet_tpu.train.optim), step by step, as
tests/test_momentum_cycling.py holds the JAX package against torch:

- the LR and beta1/momentum of every update count, for OneCycleLR,
  CyclicLR (with and without momentum cycling, each mode), StepLR and
  MultiStepLR, with accumulation > 1 (OneCycleLR's total steps count
  updates): float32 values within 2e-6 relative (both compute the curves
  in float32; numpy's and XLA's cos and pow may differ in the last bit);
- parameter trajectories of each optimizer (Adam, AdamW, SGD, RMSprop)
  under each scheduler over 40 updates of seeded gradients: within rtol
  5e-4, atol 5e-6 at every step (tests/test_momentum_cycling.py's bar
  between the JAX package and torch);
- a 50-step OneCycleLR run of the sine fixture through both packages'
  train steps from the same weights: the per-step losses within 1e-3
  relative and the learning_rate metric within 2e-6;
- ``scan_steps`` = 4 through ``make_scan_train_step``: the same state and
  metrics as four single steps, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from movenet_tpu.config import ModelConfig as JModelConfig
from movenet_tpu.config import TrainingConfig as JTrainingConfig
from movenet_tpu.models.wavenet import WaveNet as JWaveNet
from movenet_tpu.models.wavenet import make_wavenet as j_make
from movenet_tpu.train import create_train_state as j_create
from movenet_tpu.train import make_train_step as j_train_step
from movenet_tpu.train import optim as jopt
from movenet_tpu.train.loop import Batch as JBatch

from movenet_tpu_torch.config import ModelConfig, TrainingConfig
from movenet_tpu_torch.models.convert import load_jax_params
from movenet_tpu_torch.models.wavenet import make_wavenet
from movenet_tpu_torch.train import optim
from movenet_tpu_torch.train.loop import (
    Batch,
    create_train_state,
    make_scan_train_step,
    make_train_step,
)

torch.set_num_threads(2)
STEPS_PER_EPOCH = 12
ACCUM = 3

SCHEDULERS = {
    "OneCycleLR": dict(max_learning_rate=3e-3, lr_pct_start=0.3,
                       n_epochs=10),
    "CyclicLR": dict(base_learning_rate=1e-4, max_learning_rate=2e-3,
                     scheduler_step_size_up=7, scheduler_step_size_down=5),
    "CyclicLR-momentum": dict(base_learning_rate=1e-4,
                              max_learning_rate=2e-3,
                              scheduler_step_size_up=6,
                              scheduler_cycle_momentum=True,
                              scheduler_cyclic_mode="triangular2"),
    "CyclicLR-exp": dict(base_learning_rate=1e-4, max_learning_rate=2e-3,
                         scheduler_step_size_up=4,
                         scheduler_cyclic_mode="exp_range",
                         scheduler_cyclic_gamma=0.97),
    "StepLR": dict(scheduler_step_size=7, scheduler_step_gamma=0.5),
    "MultiStepLR": dict(scheduler_milestones=[5, 11, 30],
                        scheduler_step_gamma=0.3),
}


def _configs(sched, name="AdamW", wd=0.0):
    kw = dict(SCHEDULERS[sched], scheduler=sched.split("-")[0],
              optimizer=name, learning_rate=1e-3, weight_decay=wd,
              momentum=0.9, accumulation_steps=ACCUM, gradient_clipping=0.0)
    return (TrainingConfig(model_config=ModelConfig(), **kw),
            JTrainingConfig(model_config=JModelConfig(), **kw))


@pytest.mark.parametrize("sched", list(SCHEDULERS))
def test_lr_and_momentum_trajectories_match_jax(sched):
    cfg, jcfg = _configs(sched)
    lr = optim.make_schedule(cfg, STEPS_PER_EPOCH)
    jlr = jopt.make_schedule(jcfg, STEPS_PER_EPOCH)
    m = optim.momentum_schedule_for(cfg, STEPS_PER_EPOCH)
    jm = jopt.momentum_schedule_for(jcfg, STEPS_PER_EPOCH)
    assert (m is None) == (jm is None)
    assert (m is None) == (sched not in ("OneCycleLR", "CyclicLR-momentum"))
    for step in range(45):
        got, want = lr(step), float(jlr(step))
        assert isinstance(got, np.float32)
        np.testing.assert_allclose(float(got), want, rtol=2e-6,
                                   err_msg=f"lr at {step}")
        if m is not None:
            np.testing.assert_allclose(float(m(step)), float(jm(step)),
                                       rtol=2e-6,
                                       err_msg=f"momentum at {step}")


def _jax_trajectory(jcfg, w0, grads):
    tx = jopt.make_optimizer(jcfg, steps_per_epoch=STEPS_PER_EPOCH)
    params = {"w": jnp.asarray(w0)}
    state = tx.init(params)
    out = []
    for g in grads:
        updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
        out.append(np.asarray(params["w"]))
    return out


def _port_trajectory(cfg, w0, grads):
    p = torch.nn.Parameter(torch.tensor(w0.copy()))
    opt = optim.make_optimizer(cfg, [p], STEPS_PER_EPOCH)
    sched = optim.Schedules(cfg, STEPS_PER_EPOCH)
    out = []
    for step, g in enumerate(grads):
        opt.zero_grad()
        p.grad = torch.tensor(g.copy())
        sched.apply(opt, step)
        opt.step()
        out.append(p.detach().numpy().copy())
    return out


@pytest.mark.parametrize("sched", list(SCHEDULERS))
@pytest.mark.parametrize("name,wd", [("Adam", 0.05), ("AdamW", 0.05),
                                     ("SGD", 0.0), ("RMSprop", 0.01)])
def test_optimizer_trajectories_match_jax(sched, name, wd):
    cfg, jcfg = _configs(sched, name, wd)
    rng = np.random.default_rng(11)
    w0 = rng.standard_normal((6, 4)).astype(np.float32)
    grads = [rng.standard_normal((6, 4)).astype(np.float32)
             for _ in range(40)]
    want = _jax_trajectory(jcfg, w0, grads)
    got = _port_trajectory(cfg, w0, grads)
    for step, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-6,
                                   err_msg=f"{name} {sched} step {step}")


def test_schedules_are_stateless_for_resume():
    """The LR and beta1 of an update come from its count alone: applying
    the schedule at step k to a fresh optimizer gives the values an
    uninterrupted run had there."""
    cfg, _ = _configs("OneCycleLR", "Adam")
    sched = optim.Schedules(cfg, STEPS_PER_EPOCH)
    p = torch.nn.Parameter(torch.zeros(2))
    run = optim.make_optimizer(cfg, [p], STEPS_PER_EPOCH)
    seen = []
    for step in range(9):
        sched.apply(run, step)
        seen.append((run.param_groups[0]["lr"],
                     run.param_groups[0]["betas"][0]))
    fresh = optim.make_optimizer(cfg, [p], STEPS_PER_EPOCH)
    sched.apply(fresh, 8)
    assert (fresh.param_groups[0]["lr"],
            fresh.param_groups[0]["betas"][0]) == seen[-1]
    # total steps: n_epochs * ceil(steps_per_epoch / accumulation_steps)
    total = cfg.n_epochs * -(-STEPS_PER_EPOCH // ACCUM)
    peak = int(np.argmax([float(sched(s)) for s in range(total)]))
    assert peak == int(0.3 * total) - 1
    # without a scheduler the optimizer keeps its own LR
    const = optim.Schedules(TrainingConfig(scheduler=None,
                                           learning_rate=5e-4))
    opt = optim.make_optimizer(TrainingConfig(scheduler=None,
                                              learning_rate=5e-4), [p])
    const.apply(opt, 3)
    assert opt.param_groups[0]["lr"] == 5e-4
    assert float(const(3)) == float(np.float32(5e-4))


SINE_KW = dict(layer_size=3, stack_size=2, input_channels=256,
               residual_channels=16, skip_channels=16,
               compute_dtype="float32", max_audio_frames=1024)


def test_onecycle_sine_loss_curve_matches_jax(sine_codes):
    """50 OneCycleLR AdamW updates on the sine fixture (both packages'
    unfused float32 train steps, the same initial weights)."""
    n = 50
    codes = np.asarray(sine_codes)[:2, :1024].astype(np.int32)
    jm = j_make(JModelConfig(**SINE_KW))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(codes),
                     method=JWaveNet.init_all)["params"]
    tm = load_jax_params(make_wavenet(ModelConfig(**SINE_KW)), params)
    kw = dict(optimizer="AdamW", scheduler="OneCycleLR",
              max_learning_rate=1e-2, lr_pct_start=0.3, n_epochs=1,
              weight_decay=0.01, batch_size=2, gradient_clipping=0.0)
    jcfg = JTrainingConfig(model_config=JModelConfig(**SINE_KW), **kw)
    tcfg = TrainingConfig(model_config=ModelConfig(**SINE_KW), **kw)
    tx = jopt.make_optimizer(jcfg, steps_per_epoch=n)
    jstate = j_create(jm, jcfg, tx, jax.random.PRNGKey(0),
                      JBatch(codes=jnp.asarray(codes)),
                      lr_schedule=jopt.make_schedule(jcfg, n))
    jstate = jstate.replace(params=params, opt_state=tx.init(params))
    jstep = jax.jit(j_train_step(jm, jcfg))
    state = create_train_state(tm, tcfg, device="cpu", steps_per_epoch=n)
    step = make_train_step(tm, tcfg)
    jb, tb = JBatch(codes=jnp.asarray(codes)), Batch(
        codes=torch.from_numpy(codes))
    losses = []
    for i in range(n):
        jstate, jmet = jstep(jstate, jb)
        state, met = step(state, tb)
        losses.append((float(met["loss"]), float(jmet["loss"])))
        np.testing.assert_allclose(float(met["learning_rate"]),
                                   float(jmet["learning_rate"]), rtol=2e-6)
    got, want = np.array(losses).T
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert want[-1] < want[0] - 0.1       # the curve does go down


def test_scan_steps_equal_single_steps():
    kw = dict(SINE_KW, input_channels=64, max_audio_frames=256)
    cfg = TrainingConfig(model_config=ModelConfig(**kw), optimizer="Adam",
                         scheduler="OneCycleLR", max_learning_rate=5e-3,
                         n_epochs=2, batch_size=2)
    rng = np.random.default_rng(5)
    codes = torch.from_numpy(rng.integers(0, 64, (4, 2, 256)).astype(
        np.int64))
    models = [make_wavenet(ModelConfig(**kw),
                           generator=torch.Generator().manual_seed(1))
              for _ in range(2)]
    single = create_train_state(models[0], cfg, device="cpu",
                                steps_per_epoch=4)
    step = make_train_step(models[0], cfg)
    metrics = []
    for i in range(4):
        single, m = step(single, Batch(codes=codes[i]))
        metrics.append(m)
    scanned = create_train_state(models[1], cfg, device="cpu",
                                 steps_per_epoch=4)
    scanned, stacked = make_scan_train_step(models[1], cfg, 4)(
        scanned, Batch(codes=codes))
    assert scanned.step == single.step == 4
    for k in metrics[0]:
        assert stacked[k].shape == (4,)
        np.testing.assert_array_equal(
            stacked[k].numpy(), np.array([float(m[k]) for m in metrics],
                                         np.float32), err_msg=k)
    for (n, a), b in zip(models[0].named_parameters(),
                         models[1].parameters()):
        assert torch.equal(a, b), n
