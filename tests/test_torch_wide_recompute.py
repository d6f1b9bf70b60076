"""The recompute and replay strategies of the port's trunk at the R = 128
widths on the CPU (their plain versions) against the JAX package (Pallas
in interpret mode, as tests/test_torch_wide_trunk.py runs it): (R, S) =
(128, 128), the flagship's depth at R = S = 128 and the model of
scripts/probe_r128_mfu.py, and (128, 8), experiment 02 at
--residual_channels 128 (the CLI's skip width 8).

- ``fused_stack`` with ``strategy="recompute"`` and ``"replay"``: skip_sum
  and every gradient, float32 and bfloat16, with the flat ctx (T = 1280)
  and with the video projection triple (T = 1600, where both packages keep
  the triple coarse: a stack tile that is a multiple of 80), on a 3-layer
  cut of the probe's dilations (1, 2, 4) at B = 2;
- the plain replay's rebuilt layer inputs against the plain save
  forward's residual stream at R = 128 (hsave its rounding), bit for bit;
- one train step of the flagship's widths cut to layer 3 x stack 1 (R = S =
  128, C = 256, input 256, video, remat, AdamW 3e-4) against JAX's
  ``make_train_step`` from the same weights
  (``models.convert.load_jax_params``): loss and grad_norm, through the
  recompute strategy;
- the strategy both packages resolve: the flagship's depth at R = S = 128,
  the probe at B = 3 and experiment 02 with --residual_channels 128
  --remat 1 all resolve recompute.

Tolerances as tests/test_torch_wide_trunk.py: float32 forward rtol 1e-5,
gradients within 1% of each leaf's largest magnitude plus a gate on the
mean difference; bfloat16 forward within 2% of the scale, gradients within
5%, the bias gate at 0.5%; the train step's loss rtol 1e-5 and grad_norm
rtol 1e-4 in float32, 1e-4 and 1e-2 in bfloat16."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from movenet_tpu.ops.pallas import stack_kernel as jsk

from movenet_tpu_torch.ops import stack_kernel as sk

torch.set_num_threads(2)
B, V = 2, 64
DIL = (1, 2, 4)                      # the probe's dilations, one stack
PROBE_DIL = (1, 2, 4) * 3
FLAGSHIP_DIL = tuple(2 ** i for i in range(10)) * 3
# the flat ctx's T and the projection triple's
T_FLAT, T_PROJ = 1280, 1600
CAST = {"x", "ctx", "xc"}           # the activations, in the compute dtype
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(r, s, ctx_kind, seed=0):
    """Seeded numpy inputs of the 3-layer trunk: x, the ctx (flat, or the
    triple xc, wup, bup), the weights and dskip."""
    rng = np.random.default_rng(seed)
    n, t = len(DIL), T_PROJ if ctx_kind == "proj" else T_FLAT
    f = np.float32
    win = (3 if ctx_kind else 2) * r
    a = dict(
        x=(rng.standard_normal((B, t, r)) * 0.5).astype(f),
        b_fg=(rng.standard_normal((n * B, 2 * r)) * 0.1).astype(f),
        w_fg=(rng.standard_normal((n, win, 2 * r)) / np.sqrt(win)).astype(f),
        w_out=(rng.standard_normal((n, r, r + s)) / np.sqrt(r)).astype(f),
        b_out=(rng.standard_normal((n, r + s)) * 0.1).astype(f),
        dskip=(rng.standard_normal((B, t, s)) * 0.1).astype(f))
    if ctx_kind == "flat":
        a["ctx"] = (rng.standard_normal((B, t, r)) * 0.5).astype(f)
    elif ctx_kind == "proj":
        a["xc"] = (rng.standard_normal((B, t // 10, r)) * 0.5).astype(f)
        a["wup"] = (rng.standard_normal((r, 10 * r)) / np.sqrt(r)).astype(f)
        a["bup"] = (rng.standard_normal((10 * r,)) * 0.1).astype(f)
    return a


def _names(a):
    return ["x"] + [k for k in ("ctx", "xc", "wup", "bup") if k in a] \
        + ["b_fg", "w_fg", "w_out", "b_out"]


def _ctx(d):
    return (d["xc"], d["wup"], d["bup"]) if "xc" in d else d.get("ctx")


def _jax_op(a, dtype, strategy):
    jdt = DTYPES[dtype][1]
    names = _names(a)
    args = [jnp.asarray(a[n], jdt if n in CAST else jnp.float32)
            for n in names]

    def op(*xs):
        d = dict(zip(names, xs))
        return jsk.fused_stack(d["x"], _ctx(d), d["b_fg"], d["w_fg"],
                               d["w_out"], d["b_out"], DIL, True, strategy)

    skip, vjp = jax.vjp(op, *args)
    grads = vjp(jnp.asarray(a["dskip"], jdt))
    return (np.asarray(skip, np.float32),
            {n: np.asarray(g, np.float32) for n, g in zip(names, grads)})


def _torch_op(a, dtype, strategy):
    """(skip, grads by name) of the port's fused_stack, and the plain
    versions it ran."""
    tdt = DTYPES[dtype][0]
    ts = {n: torch.tensor(a[n], dtype=tdt if n in CAST else torch.float32,
                          requires_grad=True) for n in _names(a)}
    skip = sk.fused_stack(ts["x"], _ctx(ts), ts["b_fg"], ts["w_fg"],
                          ts["w_out"], ts["b_out"], DIL, strategy=strategy)
    skip.backward(torch.tensor(a["dskip"], dtype=tdt))
    return (skip.detach().float().numpy(),
            {n: t.grad.float().numpy() for n, t in ts.items()})


def _close(name, got, want, rel, bias_rel):
    scale = float(np.max(np.abs(want))) + 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=name)
    bias = abs(float(np.mean(got - want)))
    assert bias <= bias_rel * scale + 1e-10, \
        f"{name}: systematic difference {bias:.3e} vs scale {scale:.3e}"


@pytest.mark.parametrize("strategy", ["recompute", "replay"])
@pytest.mark.parametrize("r,s,ctx_kind,dtype", [
    (128, 128, "flat", "float32"), (128, 128, "proj", "bfloat16"),
    (128, 8, "flat", "bfloat16"), (128, 8, "proj", "float32"),
])
def test_wide_strategy_matches_jax(r, s, ctx_kind, dtype, strategy,
                                   monkeypatch):
    """skip_sum and every gradient of the port's recompute and replay
    strategies at R = 128 against JAX's (its tails kernels, and its
    save_h=False kernels, in interpret mode), through the strategy's own
    plain forward."""
    a = _inputs(r, s, ctx_kind)
    want, want_g = _jax_op(a, dtype, strategy)
    calls = []
    for name in ("stack_fwd_tails_plain", "stack_fwd_replay_plain",
                 "stack_fwd_x_plain"):
        fn = getattr(sk, name)
        monkeypatch.setattr(sk, name, lambda *x, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*x, **k))[1])
    got, grads = _torch_op(a, dtype, strategy)
    assert calls == [{"recompute": "stack_fwd_tails_plain",
                      "replay": "stack_fwd_replay_plain"}[strategy]]
    f32 = dtype == "float32"
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=1e-5 if f32 else 0,
                               atol=(1e-5 if f32 else 2e-2) * scale)
    assert set(grads) == set(want_g)
    rel, bias_rel = (1e-2, 2e-4) if f32 else (5e-2, 5e-3)
    for name, w in want_g.items():
        _close(name, grads[name], w, rel, bias_rel)


@pytest.mark.parametrize("r,s,ctx_kind", [(128, 128, "proj"),
                                          (128, 8, "flat")])
def test_wide_replay_rebuild_is_the_save_hsave(r, s, ctx_kind):
    """At R = 128 in bf16 the plain replay forward gives the save forward's
    skip and tfsg, its checkpoints round to hsave at their layers, and
    every layer input rebuilt from x and the checkpoints is the float32
    residual stream: the checkpoints at their layers, and rounded the save
    forward's hsave, bit for bit (the kernels' rebuild follows the same
    residual chain)."""
    a = _inputs(r, s, ctx_kind, seed=1)
    bf = torch.bfloat16
    ts = {n: torch.tensor(v, dtype=bf if n in CAST else torch.float32)
          for n, v in a.items()}
    ctx = ts.get("ctx")
    if "xc" in ts:
        ctx = sk.ctx_flatten((ts["xc"], ts["wup"], ts["bup"]), bf)
    fwd = (ts["x"], ctx, ts["b_fg"], ts["w_fg"], ts["w_out"], ts["b_out"],
           DIL)
    skip, hsave, tfsg = sk.stack_fwd_x_plain(*fwd)
    got_skip, ckpt, got_tfsg = sk.stack_fwd_replay_plain(*fwd)
    assert torch.equal(got_skip, skip) and torch.equal(got_tfsg, tfsg)
    n, every = len(DIL), sk.tails_every(len(DIL))
    for i, l in enumerate(sk.ckpt_layers(n, every)):
        assert torch.equal(ckpt[i].to(bf), hsave[l])
    rebuilt = []
    for lo in range(0, n, every):
        h0 = ts["x"] if lo == 0 else ckpt[lo // every - 1]
        rebuilt += sk.replay_rebuild(h0.float(), tfsg, ts["w_out"],
                                     ts["b_out"], bf, lo,
                                     min(lo + every, n))
    assert len(rebuilt) == n
    for l in range(n):
        assert torch.equal(rebuilt[l].to(bf), hsave[l]), l
    for i, l in enumerate(sk.ckpt_layers(n, every)):
        assert torch.equal(rebuilt[l], ckpt[i]), l


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flagship_r128_train_step_matches_jax(dtype, monkeypatch):
    """One AdamW step of the flagship's widths at R = S = 128 (layer 3 x
    stack 1 of its layer 10 x stack 3; C = 256, input 256, video) with
    remat, so that both packages take the recompute strategy, from the
    same weights."""
    from movenet_tpu.config import ModelConfig as JConfig
    from movenet_tpu.config import TrainingConfig as JTraining
    from movenet_tpu.models.wavenet import WaveNet as JWaveNet
    from movenet_tpu.models.wavenet import make_wavenet as j_make
    from movenet_tpu.train import create_train_state as j_create
    from movenet_tpu.train import make_optimizer as j_make_optimizer
    from movenet_tpu.train import make_train_step as j_train_step
    from movenet_tpu.train.loop import Batch as JBatch

    from movenet_tpu_torch.config import ModelConfig, TrainingConfig
    from movenet_tpu_torch.models.convert import load_jax_params
    from movenet_tpu_torch.models.wavenet import make_wavenet
    from movenet_tpu_torch.train import (Batch, create_train_state,
                                         make_train_step)

    t, mvf, c = 1280, 128, 256
    kw = dict(layer_size=3, stack_size=1, input_channels=c,
              residual_channels=128, skip_channels=128, compute_dtype=dtype,
              max_audio_frames=t, max_video_frames=mvf, remat=True)
    ckw = dict(optimizer="AdamW", learning_rate=3e-4, scheduler=None,
               batch_size=B, fused_blocks=True)
    jm = j_make(JConfig(**kw))
    rng = np.random.default_rng(0)
    codes = rng.integers(0, c, size=(B, t)).astype(np.int32)
    vid = rng.standard_normal((B, mvf, 64, 64, 1)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(codes),
                     jnp.asarray(vid), None,
                     method=JWaveNet.init_all)["params"]
    jcfg = JTraining(model_config=JConfig(**kw), fused_interpret=True,
                     **ckw)
    jstate = j_create(jm, jcfg, j_make_optimizer(jcfg),
                      jax.random.PRNGKey(0), JBatch(codes=jnp.asarray(codes)))
    jstate = jstate.replace(params=params, opt_state=jstate.tx.init(params))
    _, want = jax.jit(j_train_step(jm, jcfg))(
        jstate, JBatch(codes=jnp.asarray(codes), video=jnp.asarray(vid)))
    tm = load_jax_params(make_wavenet(ModelConfig(**kw)), params)
    tcfg = TrainingConfig(model_config=ModelConfig(**kw), **ckw)
    state = create_train_state(tm, tcfg, device="cpu")
    calls = []
    for name in ("stack_fwd_tails_plain", "stack_fwd_plain",
                 "stack_fwd_x_plain"):
        fn = getattr(sk, name)
        monkeypatch.setattr(sk, name, lambda *x, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*x, **k))[1])
    _, got = make_train_step(tm, tcfg)(
        state, Batch(codes=torch.from_numpy(codes),
                     video=torch.from_numpy(vid)))
    assert calls == ["stack_fwd_tails_plain"]
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5 if f32 else 1e-4)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]),
                               rtol=1e-4 if f32 else 1e-2)


@pytest.mark.parametrize("case", ["flagship", "probe_b3", "exp02_remat"])
def test_wide_strategy_resolves_recompute(case):
    """Both packages resolve the recompute strategy at the full shapes (T =
    160,000, bf16): the flagship's depth at R = S = 128 (hsave 30 x 2 x
    160,000 x 128 x 2 bytes = 2.46 GB, above JAX's 1 GiB budget), the
    probe at B = 3 (9 x 3 x 160,000 x 128 x 2 = 1.11 GB) and experiment 02
    with --residual_channels 128 --remat 1 (remat asks for recompute)."""
    from movenet_tpu.config import arg_parser as j_arg_parser
    from movenet_tpu.config import config_from_args as j_config_from_args
    from movenet_tpu.models import fused as jfused

    from movenet_tpu_torch.config import arg_parser, config_from_args
    from movenet_tpu_torch.models import fused
    from movenet_tpu_torch.models.wavenet import make_wavenet
    from movenet_tpu_torch.utils.fixtures import script_flags

    t = 160_000
    if case == "flagship":
        shape, dil, strategy = (2, t, 128), FLAGSHIP_DIL, "auto"
        assert 30 * 2 * t * 128 * 2 > 1 << 30
    elif case == "probe_b3":
        shape, dil, strategy = (3, t, 128), PROBE_DIL, "auto"
        assert 9 * 3 * t * 128 * 2 > 1 << 30
    else:
        argv = ["--dataset", "-", *script_flags("02_kinetics_breakdancing"),
                "--residual_channels", "128", "--remat", "1"]
        mc = config_from_args(arg_parser().parse_args(argv)).model_config
        jmc = j_config_from_args(j_arg_parser().parse_args(
            argv)).model_config
        assert mc.remat and jmc.remat
        assert (mc.residual_channels, mc.skip_channels) == (128, 8)
        model = make_wavenet(mc)
        dil = tuple(model.dilations)
        shape, strategy = (2, t, 128), fused._strategy(model, t)
        jm = type("M", (), {"remat": jmc.remat, "fused_strategy": None})()
        stacked = (np.zeros((len(dil), 2, 256), np.float32),) + (None,) * 3
        assert jfused._stack_weights(jm, stacked, t, dil)[0] == strategy
    want = jsk.resolve_strategy(strategy, shape, len(dil), dil, 2)
    assert sk.resolve_strategy(strategy, shape, len(dil), dil, 2) == want \
        == "recompute"


class _Library:
    """A stand-in for the kernel library's width answers: each family's
    pairs as ops/cuda/stack_kernel.FAMILY_WIDTHS lists them."""

    @staticmethod
    def movenet_stack_supports(family, r, s):
        from movenet_tpu_torch.ops.cuda import stack_kernel as ks

        return int((r, s) in list(ks.FAMILY_WIDTHS.values())[family])


@pytest.mark.parametrize("family", ["recompute", "replay"])
def test_wide_families_route_by_dtype(family):
    """At R = 128 the wrappers' checks take bf16 x for the recompute and
    replay kernels, and float32 x for the recompute kernels (their float32
    forms' wide layouts fit a block); the float32 replay and save forms
    are refused with ROADMAP.md B.2 widths (2); an unbuilt pair, (128, 64),
    is refused with B.2 widths (5)."""
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks

    a = _inputs(128, 128, "flat")
    ts = {n: torch.from_numpy(v) for n, v in a.items()}
    args = (ts["x"].bfloat16(), ts["ctx"].bfloat16(), ts["b_fg"],
            ts["w_fg"], ts["w_out"], ts["b_out"], DIL)
    what = f"the {family} kernels"
    dims = (B, T_FLAT, len(DIL), 128, 128, 384)
    assert ks._x_check(_Library, *args, what, family) == dims
    f32_args = (ts["x"], ts["ctx"], *args[2:])
    if family == "recompute":
        assert ks._x_check(_Library, *f32_args, what, family) == dims
    else:
        with pytest.raises(NotImplementedError,
                           match=r"float32 .*B\.2 widths \(2\)"):
            ks._x_check(_Library, *f32_args, what, family)
    with pytest.raises(NotImplementedError, match=r"B\.2 widths \(2\)"):
        ks._x_check(_Library, *f32_args, "the non-embed save kernels",
                    "non-embed")
    n = len(DIL)
    w_out, b_out = torch.zeros(n, 128, 192), torch.zeros(n, 192)
    with pytest.raises(NotImplementedError, match=r"B\.2 widths \(5\)"):
        ks._x_check(_Library, *args[:4], w_out, b_out, DIL, what, family)


def test_ar_ring_slab_fits_the_wide_flagship():
    """The AR kernel's ring takes 64 KB slabs where two such stages fit
    (the flagship at R = S = 64, every form) and the widest of 32 and 16 KB
    that fits elsewhere: the flagship's depth at R = S = 128 with video
    (234,200 bytes at 64 KB) and its speculative form at depth 2 take 32
    KB, in 3 stages; a request's stream is packed in its form's slabs."""
    from types import SimpleNamespace

    from movenet_tpu_torch.ops.cuda import ar_sampler as ars

    c, n = 256, 30
    for fast in (False, True):
        for nch, video in ((1, False), (1, True), (2, False), (3, False)):
            assert ars.ring_slab_bytes(fast, nch, c, 64, 64, n, video) == \
                ars.SLAB_BYTES == 65536
        wide = {(1, True): 32768, (1, False): 65536, (2, False): 65536,
                (3, False): 32768}
        for (nch, video), want in wide.items():
            assert ars.ring_slab_bytes(fast, nch, c, 128, 128, n,
                                       video) == want, (nch, video)
        with pytest.raises(ValueError, match="234200 bytes"):
            ars.smem_layout(fast, 1, c, 128, 128, n, True)
        lay = ars.smem_layout(fast, 1, c, 128, 128, n, True, 32768)
        assert (lay["total"], lay["n_stages"]) == (201448, 3)
    weights = {"front_cur": torch.zeros(c, 128),
               "w_out": torch.zeros(n, 128, 256)}
    inp = SimpleNamespace(weights=weights, fast=True, dilations=FLAGSHIP_DIL,
                          ctx=torch.zeros(1))
    assert ars._default_slab(inp, 1) == 32768
    inp.ctx = None
    assert ars._default_slab(inp, 2) == 65536
