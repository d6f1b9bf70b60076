"""The port's training path on the CPU against the JAX package's: the fused
loss (trunk op + head/CE op, plain versions here, Pallas interpret mode
there) with every parameter gradient by flax name, the unfused loss, and
the train and eval steps (AdamW, accumulation, clipping).

Tolerances: float32 losses rtol 1e-5; gradients within 1% of each leaf's
largest magnitude plus the mean-difference gate of
tests/test_fused_model.py; bfloat16 (the slice's dtype) loss rtol 1e-4,
gradients within 10% of the leaf scale with the mean gate at 0.5%: the
video encoder runs in bf16 in both packages, and its bf16 products,
rounded from sums taken in different orders, move the encoder's gradients
most.  Accuracy equal or off by one flipped position.  Parameters after
n AdamW steps within 0.01 * lr * n, since Adam bounds each update by lr.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from movenet_tpu.config import ModelConfig as JModelConfig
from movenet_tpu.config import TrainingConfig as JTrainingConfig
from movenet_tpu.models import fused as jfused
from movenet_tpu.models.wavenet import WaveNet as JWaveNet
from movenet_tpu.models.wavenet import make_wavenet as j_make
from movenet_tpu.train import create_train_state as j_create
from movenet_tpu.train import make_eval_step as j_eval_step
from movenet_tpu.train import make_optimizer as j_make_optimizer
from movenet_tpu.train import make_train_step as j_train_step
from movenet_tpu.train.loop import Batch as JBatch

from movenet_tpu_torch.config import ModelConfig, TrainingConfig
from movenet_tpu_torch.models import fused
from movenet_tpu_torch.models.convert import flatten_tree, load_jax_params
from movenet_tpu_torch.models.wavenet import make_wavenet
from movenet_tpu_torch.train import (
    Batch,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from movenet_tpu_torch.train.optim import clip_by_global_norm, global_norm

torch.set_num_threads(2)
C = 64


def _model_kw(dtype, glob, maf=12800, mvf=128):
    return dict(layer_size=3, stack_size=2, input_channels=C,
                residual_channels=16, skip_channels=16, compute_dtype=dtype,
                global_classes=glob, max_audio_frames=maf,
                max_video_frames=mvf)


def _setup(dtype, t, video, glob, maf=12800, mvf=128, seed=0, lead=(),
           **extra):
    kw = dict(_model_kw(dtype, glob, maf, mvf), **extra)
    jm = j_make(JModelConfig(**kw))
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, kw["input_channels"],
                         size=lead + (2, t)).astype(np.int32)
    vid = rng.standard_normal(lead + (2, mvf, 64, 64, 1)).astype(
        np.float32) if video else None
    labels = np.tile(np.array([0, 2], np.int32), lead + (1,)) \
        if glob else None
    first = (0,) * len(lead)
    params = jm.init(
        jax.random.PRNGKey(seed), jnp.asarray(codes[first]),
        None if vid is None else jnp.asarray(vid[first]),
        None if labels is None else jnp.asarray(labels[first]),
        method=JWaveNet.init_all)["params"]
    tm = load_jax_params(make_wavenet(ModelConfig(**kw)), params)
    return kw, jm, params, tm, codes, vid, labels


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x, long=False):
    if x is None:
        return None
    t = torch.from_numpy(np.asarray(x))
    return t.long() if long else t


def _close_grads(got, want, rel, bias_rel):
    assert set(got) == set(want), set(got) ^ set(want)
    for n, w in want.items():
        g = got[n]
        scale = float(np.max(np.abs(w))) + 1e-12
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale,
                                   err_msg=n)
        bias = abs(float(np.mean(g - w)))
        assert bias <= bias_rel * scale + 1e-10, \
            f"{n}: systematic difference {bias:.3e} vs scale {scale:.3e}"


def _port_grads(tm):
    return {n: (np.zeros(p.shape, np.float32) if p.grad is None
                else p.grad.numpy()) for n, p in tm.named_parameters()}


@pytest.mark.parametrize("dtype,t,video,glob,maf,parity", [
    ("float32", 12800, True, 3, 12800, True),     # projection triple
    ("bfloat16", 12800, True, 0, 12800, True),    # the slice's dtype
    ("float32", 1280, True, 3, 1280, True),       # flat ctx (tile 256)
    ("float32", 1024, False, 0, 12800, False),    # audio only, clean CE
])
def test_fused_train_loss_matches_jax(dtype, t, video, glob, maf, parity):
    kw, jm, params, tm, codes, vid, labels = _setup(dtype, t, video, glob,
                                                    maf)
    if video:
        _, ctx, _, _ = jfused._prepare_trunk(jm, params, _j(codes),
                                             _j(vid), None)
        assert isinstance(ctx, tuple) == (t == 12800)

    def jloss(p):
        return jfused.fused_train_loss(jm, p, _j(codes), _j(vid),
                                       _j(labels), parity=parity,
                                       interpret=True)

    (want_l, want_a), want_g = jax.value_and_grad(jloss, has_aux=True)(
        params)
    loss, acc = fused.fused_train_loss(tm, _t(codes), _t(vid),
                                       _t(labels, True), parity=parity)
    loss.backward()
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(loss.detach()), float(want_l),
                               rtol=1e-5 if f32 else 1e-4)
    n_valid = 2 * (t - tm.receptive_fields)
    assert abs(float(acc) - float(want_a)) <= 1.0 / n_valid + 1e-7
    _close_grads(_port_grads(tm), flatten_tree(want_g),
                 1e-2 if f32 else 1e-1, 2e-4 if f32 else 5e-3)


@pytest.mark.parametrize("dtype,t,extra", [
    ("float32", 12800, dict(fused_strategy="recompute")),  # triple
    ("bfloat16", 1280, dict(fused_strategy="recompute")),  # flat ctx
    ("float32", 1280, dict(remat=True)),
    # the flagship's C: the float32 recompute trunk with the C = 256 head
    ("float32", 1280, dict(fused_strategy="recompute", input_channels=256)),
])
def test_fused_train_loss_recompute_matches_jax(dtype, t, extra,
                                                monkeypatch):
    """The recompute strategy (asked for, or implied by remat) through
    front_embed and the non-embed trunk, against JAX's tails kernels in
    interpret mode: the loss and every parameter gradient, at the
    module's tolerances."""
    from movenet_tpu_torch.ops import stack_kernel as sk

    kw, jm, params, tm, codes, vid, labels = _setup(dtype, t, True, 0, t,
                                                    **extra)
    _, ctx, _, _ = jfused._prepare_trunk(jm, params, _j(codes), _j(vid),
                                         None)
    assert isinstance(ctx, tuple) == (t == 12800)
    calls = []
    for name in ("stack_fwd_tails_plain", "stack_fwd_plain"):
        fn = getattr(sk, name)
        monkeypatch.setattr(sk, name, lambda *a, _f=fn, _n=name: (
            calls.append(_n), _f(*a))[1])

    def jloss(p):
        return jfused.fused_train_loss(jm, p, _j(codes), _j(vid),
                                       interpret=True)

    (want_l, want_a), want_g = jax.value_and_grad(jloss, has_aux=True)(
        params)
    loss, acc = fused.fused_train_loss(tm, _t(codes), _t(vid))
    loss.backward()
    assert calls == ["stack_fwd_tails_plain"]
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(loss.detach()), float(want_l),
                               rtol=1e-5 if f32 else 1e-4)
    n_valid = 2 * (t - tm.receptive_fields)
    assert abs(float(acc) - float(want_a)) <= 1.0 / n_valid + 1e-7
    _close_grads(_port_grads(tm), flatten_tree(want_g),
                 1e-2 if f32 else 1e-1, 2e-4 if f32 else 5e-3)


def test_unfused_bf16_logits_match_jax():
    """The unfused model computes in its compute dtype, rounding where the
    JAX model rounds: bf16 train_logits with video and global labels
    against JAX's within 1e-2 of the logits' scale at any position (a
    video-encoder sum rounded one bf16 step apart moves a few) and 2e-4 of
    it on average (float32 compute sits near 1.4e-3 there); the loss
    within rtol 1e-5."""
    from movenet_tpu.train.loop import Batch as JB
    from movenet_tpu.train.loop import _loss_and_metrics as j_loss
    from movenet_tpu_torch.train.loop import _loss_and_metrics as t_loss

    kw, jm, params, tm, codes, vid, labels = _setup("bfloat16", 1280, True,
                                                    3, 1280)
    want = np.asarray(jm.apply({"params": params}, _j(codes), _j(vid),
                               _j(labels), method=JWaveNet.train_logits),
                      np.float32)
    with torch.no_grad():
        got = tm.train_logits(_t(codes), _t(vid), _t(labels, True))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    assert err.max() <= 1e-2 * scale and err.mean() <= 2e-4 * scale, \
        (err.max() / scale, err.mean() / scale)
    want_l, _ = j_loss(jm, True)(params, JB(codes=_j(codes), video=_j(vid),
                                            labels=_j(labels)))
    with torch.no_grad():
        loss, _ = t_loss(tm, True)(Batch(codes=_t(codes), video=_t(vid),
                                         labels=_t(labels, True)))
    np.testing.assert_allclose(float(loss), float(want_l), rtol=1e-5)


def test_unfused_remat_checkpoints_each_block():
    """remat=True: the same gradients as without (within 1e-6 of each
    leaf's scale: autograd adds the recomputed graph's terms in another
    order), and every block runs a second time in the backward
    (torch.utils.checkpoint)."""
    grads, calls = {}, {}
    for remat in (False, True):
        kw, _, _, tm, codes, vid, labels = _setup("float32", 1280, True, 3,
                                                  1280)
        tm.remat = remat
        real = tm._block
        n = []

        def counted(*a, _real=real, _n=n):
            _n.append(1)
            return _real(*a)

        tm._block = counted
        loss = tm.train_logits(_t(codes), _t(vid),
                               _t(labels, True)).float().square().mean()
        forward = len(n)
        loss.backward()
        calls[remat] = (forward, len(n))
        grads[remat] = _port_grads(tm)
    n_layers = len(tm.dilations)
    assert calls[False] == (n_layers, n_layers)
    assert calls[True] == (n_layers, 2 * n_layers)
    for name, g in grads[False].items():
        np.testing.assert_allclose(grads[True][name], g, rtol=0,
                                   atol=1e-6 * np.abs(g).max(), err_msg=name)


def test_fused_host_pack_and_logits(rng_np):
    kw, jm, params, tm, codes, _, _ = _setup("float32", 1024, False, 0)
    with torch.no_grad():
        l0, a0 = fused.fused_train_loss(tm, _t(codes))
        l1, a1 = fused.fused_train_loss(
            tm, _t(codes), codes_pack=torch.from_numpy(
                fused.codes_pack_np(codes)))
    assert float(l0) == float(l1) and float(a0) == float(a1)
    np.testing.assert_array_equal(fused.codes_pack_np(codes),
                                  jfused.codes_pack_np(codes))
    np.testing.assert_array_equal(
        fused._codes_pack(_t(codes), True).numpy(),
        np.asarray(jfused._codes_pack(_j(codes), True)))
    with torch.no_grad():
        got = fused.fused_train_logits(tm, _t(codes))
        want = tm.train_logits(_t(codes))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)
    # merge_head=True runs the merged trunk + head/CE op, as JAX's does
    with torch.no_grad():
        got = fused.fused_train_loss(tm, _t(codes), merge_head=True)
    want = jfused.fused_train_loss(jm, params, _j(codes), interpret=True,
                                   merge_head=True)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    assert abs(float(got[1]) - float(want[1])) <= 1.0 / (
        2 * (1024 - tm.receptive_fields)) + 1e-7
    assert fused.supports_fused(tm, 1024) and not fused.supports_fused(
        tm, 1000)


def _configs(fused_blocks, **kw):
    base = dict(optimizer="AdamW", learning_rate=3e-3, scheduler=None,
                batch_size=2, fused_blocks=fused_blocks, weight_decay=0.0)
    base.update(kw)
    jkw = dict(base, fused_interpret=fused_blocks)
    return jkw, base


def _run_both(dtype, t, video, glob, n_steps, lead=(), maf=12800,
              **cfg_kw):
    kw, jm, params, tm, codes, vid, labels = _setup(dtype, t, video, glob,
                                                    maf=maf, lead=lead)
    jkw, tkw = _configs(**cfg_kw)
    jcfg = JTrainingConfig(model_config=JModelConfig(**kw), **jkw)
    tcfg = TrainingConfig(model_config=ModelConfig(**kw), **tkw)
    jstate = j_create(jm, jcfg, j_make_optimizer(jcfg),
                      jax.random.PRNGKey(0), JBatch(codes=_j(codes)))
    jstate = jstate.replace(params=params,
                            opt_state=jstate.tx.init(params))
    jstep = jax.jit(j_train_step(jm, jcfg))
    state = create_train_state(tm, tcfg, device="cpu")
    step = make_train_step(tm, tcfg)
    jb = JBatch(codes=_j(codes), video=_j(vid), labels=_j(labels))
    tb = Batch(codes=_t(codes), video=_t(vid), labels=_t(labels, True))
    metrics = []
    for _ in range(n_steps):
        jstate, jm_ = jstep(jstate, jb)
        state, m = step(state, tb)
        metrics.append(({k: float(v) for k, v in jm_.items()},
                        {k: float(v) for k, v in m.items()}))
    return jcfg, jstate, state, metrics, (jm, tm, jb, tb)


def _check_run(jcfg, jstate, state, metrics, n_valid):
    for want, got in metrics:
        assert set(got) == set(want)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert abs(got["accuracy"] - want["accuracy"]) <= 1.0 / n_valid \
            + 1e-7
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-4)
    atol = 0.01 * jcfg.learning_rate * len(metrics)
    want = flatten_tree(jstate.params)
    for n, p in state.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=atol, err_msg=n)
    assert state.step == len(metrics)


def test_train_step_fused_matches_jax():
    """3 AdamW steps through the fused path (Pallas interpret in JAX)."""
    jcfg, jstate, state, metrics, _ = _run_both(
        "float32", 1024, False, 3, 3, fused_blocks=True)
    _check_run(jcfg, jstate, state, metrics, 2 * (1024 - 16))


@pytest.mark.parametrize("case", ["accumulate", "clip", "sgd", "adam_wd"])
def test_train_step_unfused_matches_jax(case):
    kw = {"accumulate": dict(accumulation_steps=2),
          "clip": dict(gradient_clipping=0.005),
          "sgd": dict(optimizer="SGD", momentum=0.9),
          "adam_wd": dict(optimizer="Adam", weight_decay=0.01)}[case]
    lead = (2,) if case == "accumulate" else ()
    # the accumulation case runs without video: the frame projection's
    # 4096-wide sums leave a few gradient elements at float32 noise level,
    # where Adam's normalized update turns the noise into up to lr
    video = case != "accumulate"
    jcfg, jstate, state, metrics, _ = _run_both(
        "float32", 1280, video, 0 if video else 3, 2, lead=lead, maf=1280,
        fused_blocks=False, **kw)
    if case == "clip":
        assert metrics[0][0]["grad_norm"] > 0.005   # the clip was active
    _check_run(jcfg, jstate, state, metrics, 2 * (1280 - 16))


def test_eval_step_matches_jax():
    jcfg, jstate, state, metrics, (jm, tm, jb, tb) = _run_both(
        "float32", 1024, False, 3, 1, fused_blocks=True)
    want = jax.jit(j_eval_step(jm, jcfg))(jstate, jb)
    got = make_eval_step(tm, TrainingConfig(
        model_config=ModelConfig(**_model_kw("float32", 3)),
        fused_blocks=True))(state, tb)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    assert abs(float(got["accuracy"]) - float(want["accuracy"])) <= \
        1.0 / (2 * (1024 - 16)) + 1e-7


def test_optimizer_semantics():
    p = torch.nn.Parameter(torch.ones(3))
    for name, cls in (("Adam", torch.optim.Adam),
                      ("AdamW", torch.optim.AdamW),
                      ("SGD", torch.optim.SGD),
                      ("RMSprop", torch.optim.RMSprop)):
        cfg = TrainingConfig(optimizer=name, scheduler=None,
                             weight_decay=0.0)
        opt = make_optimizer(cfg, [p])
        assert isinstance(opt, cls)
        assert opt.param_groups[0]["weight_decay"] == 0.0
    # OneCycleLR (the dataclass default) needs the epoch's length, as in
    # the JAX package, and starts at max_lr / 25
    with pytest.raises(ValueError, match="steps_per_epoch"):
        make_optimizer(TrainingConfig(), [p])
    opt = make_optimizer(TrainingConfig(), [p], steps_per_epoch=4)
    assert opt.param_groups[0]["lr"] == pytest.approx(0.003 / 25, rel=1e-6)
    with pytest.raises(ValueError, match="not recognized"):
        make_optimizer(TrainingConfig(optimizer="Lion", scheduler=None),
                       [p])
    # optax's rule: g / norm * clip, no epsilon, only at norm >= clip
    g = [torch.tensor([3.0, 4.0])]
    n = global_norm(g)
    clip_by_global_norm(g, 1.0, n)
    np.testing.assert_allclose(g[0].numpy(), [0.6, 0.8], rtol=1e-7)
    g = [torch.tensor([0.3, 0.4])]
    clip_by_global_norm(g, 1.0, global_norm(g))
    np.testing.assert_array_equal(g[0].numpy(), np.float32([0.3, 0.4]))


def test_create_train_state_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = make_wavenet(ModelConfig(**_model_kw("float32", 0)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(model, TrainingConfig(scheduler=None))


def test_init_all_touches_every_module():
    kw = _model_kw("float32", 3, 1280, 128)
    tm = make_wavenet(ModelConfig(**kw))
    out = tm.init_all(torch.zeros(2, 1024, dtype=torch.long),
                      torch.zeros(2, 128, 64, 64, 1))
    assert out.shape == (2, 1024, C)
