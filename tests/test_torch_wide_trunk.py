"""The port at the R = 128 widths on the CPU (its plain versions) against the
JAX package (Pallas in interpret mode): (R, S) = (128, 128), the model of
scripts/probe_r128_mfu.py, and (128, 8), experiment 02 at
--residual_channels 128 (the CLI's skip width 8).

- ``fused_stack_embed`` (the save strategy with the embedding folded in,
  the route both take at their full shapes) and the non-embed save
  ``fused_stack``, with the flat ctx and with the video projection triple:
  skip_sum and every gradient, float32 and bfloat16, on a 3-layer cut of
  the probe's dilations (1, 2, 4) x 3 at B = 2;
- ``fused_head_loss`` at (S, C) = (128, 64), the probe's head, and (128,
  256);
- one train step of the probe's model (layer 3 x stack 1 here, R = S = 128,
  C = 64, video, AdamW 3e-4) against JAX's ``make_train_step`` from the
  same weights (``models.convert.load_jax_params``): loss and grad_norm;
- the strategy the fused loss resolves at the probe's full shape (B = 2, T
  = 160,000, L = 9, bf16): save, with 2V = 128 inside the embedding
  kernel, as in JAX; and what the flagship depth at R = 128 resolves to
  (recompute).

Tolerances as tests/test_torch_narrow_trunk.py and
tests/test_torch_train.py: float32 forward rtol 1e-5, gradients within 1%
of each leaf's largest magnitude plus a gate on the mean difference;
bfloat16 forward within 2% of the scale, gradients within 5%, the bias
gate at 0.5%; the head as tests/test_torch_head_loss.py (float32 loss rtol
1e-5, gradients 1%; bfloat16 loss rtol 1e-4, gradients 2%; the match count
off by at most one flipped position); the train step's loss rtol 1e-5 and
grad_norm rtol 1e-4 in float32, 1e-4 and 1e-2 in bfloat16 (the video
encoder's bf16 products, summed in other orders, move the gradients most,
as in tests/test_torch_train.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from movenet_tpu.ops.pallas import head_loss as jhl
from movenet_tpu.ops.pallas import stack_kernel as jsk

from movenet_tpu_torch.ops import head_loss as hl
from movenet_tpu_torch.ops import stack_kernel as sk

torch.set_num_threads(2)
B, V = 2, 64
DIL = (1, 2, 4)                      # the probe's dilations, one stack
PROBE_DIL = (1, 2, 4) * 3


def _inputs(t, r, s, ctx_kind, seed=0):
    rng = np.random.default_rng(seed)
    n = len(DIL)
    codes = rng.integers(0, V, size=(B, t)).astype(np.int32)
    prev = np.concatenate([np.full((B, 1), -1, np.int32), codes[:, :-1]], 1)
    pack = np.ascontiguousarray(
        np.concatenate([codes, prev, np.roll(codes, -1, 1)], 0).T)
    f = np.float32
    win = (3 if ctx_kind else 2) * r
    a = dict(
        table2=(rng.standard_normal((2 * V, r)) * 0.5).astype(f),
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
    return pack, a


def _close(name, got, want, rel, bias_rel):
    scale = float(np.max(np.abs(want))) + 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=name)
    bias = abs(float(np.mean(got - want)))
    assert bias <= bias_rel * scale + 1e-10, \
        f"{name}: systematic difference {bias:.3e} vs scale {scale:.3e}"


def _run_both(pack, a, dtype, embed):
    """(skip, grads) of the JAX op and of the port's op, by input name."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    first = "table2" if embed else "x"
    names = [first] + [k for k in ("ctx", "xc", "wup", "bup") if k in a] \
        + ["b_fg", "w_fg", "w_out", "b_out"]
    cast = {"table2", "x", "ctx", "xc"}
    jargs = [jnp.asarray(a[n], jdt if n in cast else jnp.float32)
             for n in names]
    pack_j = jnp.asarray(pack)

    def ctx_of(d):
        return (d["xc"], d["wup"], d["bup"]) if "xc" in d else d.get("ctx")

    def jop(*xs):
        d = dict(zip(names, xs))
        rest = (ctx_of(d), d["b_fg"], d["w_fg"], d["w_out"], d["b_out"],
                DIL)
        if embed:
            return jsk.fused_stack_embed(pack_j, d[first], *rest, jdt, True)
        return jsk.fused_stack(d[first], *rest, True, "save")

    want, vjp = jax.vjp(jop, *jargs)
    want_g = vjp(jnp.asarray(a["dskip"], jdt))
    ts = {n: torch.tensor(a[n], dtype=tdt if n in cast else torch.float32,
                          requires_grad=True) for n in names}
    rest = (ctx_of(ts), ts["b_fg"], ts["w_fg"], ts["w_out"], ts["b_out"],
            DIL)
    if embed:
        got = sk.fused_stack_embed(torch.from_numpy(pack), ts[first], *rest)
    else:
        got = sk.fused_stack(ts[first], *rest, strategy="save")
    got.backward(torch.tensor(a["dskip"], dtype=tdt))
    return (np.asarray(want, np.float32), got.detach().float().numpy(),
            {n: (np.asarray(g, np.float32), ts[n].grad.float().numpy())
             for n, g in zip(names, want_g)})


@pytest.mark.parametrize("r,s,t,ctx_kind,dtype,embed", [
    (128, 128, 12800, "proj", "float32", True),
    (128, 128, 1280, "flat", "bfloat16", True),
    (128, 8, 12800, "proj", "bfloat16", True),
    (128, 8, 1280, "flat", "float32", True),
    (128, 128, 1280, None, "bfloat16", False),
    (128, 8, 12800, "proj", "float32", False),
])
def test_wide_trunk_matches_jax(r, s, t, ctx_kind, dtype, embed):
    """The projection triple runs at T = 12,800, where both packages keep it
    coarse (a stack tile that is a multiple of 80)."""
    pack, a = _inputs(t, r, s, ctx_kind)
    want, got, grads = _run_both(pack, a, dtype, embed)
    f32 = dtype == "float32"
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=1e-5 if f32 else 0,
                               atol=(1e-5 if f32 else 2e-2) * scale)
    rel, bias_rel = (1e-2, 2e-4) if f32 else (5e-2, 5e-3)
    for name, (w, g) in grads.items():
        _close(name, g, w, rel, bias_rel)


@pytest.mark.parametrize("s,c", [(128, 64), (128, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_skip_head_matches_jax(s, c, dtype):
    t, rf = 512, 15
    rng = np.random.default_rng(1)
    codes = rng.integers(0, c, size=(B, t)).astype(np.int32)
    prev = np.concatenate([np.full((B, 1), -1, np.int32), codes[:, :-1]], 1)
    pack = np.ascontiguousarray(
        np.concatenate([codes, prev, np.roll(codes, -1, 1)], 0).T)
    f = np.float32
    a = dict(skip=rng.standard_normal((B, t, s)).astype(f),
             w1=(rng.standard_normal((s, c)) / np.sqrt(s)).astype(f),
             b1=(rng.standard_normal((c,)) * 0.1).astype(f),
             w2=(rng.standard_normal((c, c)) / np.sqrt(c)).astype(f),
             b2=(rng.standard_normal((c,)) * 0.1).astype(f))
    n_valid = B * (t - rf)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    names = ("skip", "w1", "b1", "w2", "b2")

    def jloss(*xs):
        loss, match = jhl.fused_head_loss(xs[0], jnp.asarray(pack), *xs[1:],
                                          rf, True, True, 2 * B)
        return loss / n_valid, match

    jargs = [jnp.asarray(a[n], jdt if n == "skip" else jnp.float32)
             for n in names]
    (want_l, want_m), want_g = jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True)(*jargs)
    ts = {n: torch.tensor(a[n], dtype=tdt if n == "skip" else torch.float32,
                          requires_grad=True) for n in names}
    loss, match = hl.fused_head_loss(ts["skip"], torch.from_numpy(pack),
                                     ts["w1"], ts["b1"], ts["w2"], ts["b2"],
                                     rf, True, tgt_off=2 * B)
    (loss / n_valid).backward()
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(loss.detach()) / n_valid, float(want_l),
                               rtol=1e-5 if f32 else 1e-4)
    assert abs(float(match) - float(want_m)) <= 1
    for n, w in zip(names, want_g):
        _close(n, ts[n].grad.float().numpy(), np.asarray(w, np.float32),
               1e-2 if f32 else 2e-2, 2e-4 if f32 else 5e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_train_step_matches_jax(dtype):
    """One AdamW step of the probe's model (one stack of its three) through
    the fused route in both packages, from the same weights."""
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

    t, mvf = 1280, 128
    kw = dict(layer_size=3, stack_size=1, input_channels=V,
              residual_channels=128, skip_channels=128, compute_dtype=dtype,
              max_audio_frames=t, max_video_frames=mvf)
    ckw = dict(optimizer="AdamW", learning_rate=3e-4, scheduler=None,
               batch_size=B, fused_blocks=True)
    jm = j_make(JConfig(**kw))
    rng = np.random.default_rng(0)
    codes = rng.integers(0, V, size=(B, t)).astype(np.int32)
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
    _, got = make_train_step(tm, tcfg)(
        state, Batch(codes=torch.from_numpy(codes),
                     video=torch.from_numpy(vid)))
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5 if f32 else 1e-4)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]),
                               rtol=1e-4 if f32 else 1e-2)


def test_probe_strategy_matches_jax():
    """At the probe's full shape the fused loss resolves the save strategy,
    hsave 9 x 320,000 x 128 x 2 bytes = 737 MB under JAX's 1 GiB budget, and
    2V = 128 takes the embedding kernel; at the flagship depth (30 layers)
    hsave is 2.46 GB and both resolve recompute, which the card runs at R
    = 128 through the wide recompute kernels
    (tests/test_torch_wide_recompute.py holds it to JAX here)."""
    shape, n = (2, 160_000, 128), len(PROBE_DIL)
    assert n * 2 * 160_000 * 128 * 2 == 737_280_000
    for strategy in ("auto", "save"):
        want = jsk.resolve_strategy(strategy, shape, n, PROBE_DIL, 2)
        assert sk.resolve_strategy(strategy, shape, n, PROBE_DIL, 2) == \
            want == "save"
    assert 2 * V <= sk.EMBED_MAX_2V
    flagship = tuple(2 ** i for i in range(10)) * 3
    want = jsk.resolve_strategy("auto", shape, 30, flagship, 2)
    assert sk.resolve_strategy("auto", shape, 30, flagship, 2) == want == \
        "recompute"
