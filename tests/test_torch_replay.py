"""The replay strategy of the port's trunk (``fused_stack(...,
strategy="replay")``: the save forward without hsave, the layer inputs
rebuilt in the backward from x, float32 checkpoints and the taps) on the
CPU, where its plain versions run, against the JAX package's Pallas op in
interpret mode (``fused_stack(..., interpret=True, strategy="replay")``,
as tests/test_stack_kernel.py runs it): skip_sum and every gradient,
without ctx, with the flat ctx and with the projection triple, in float32
and bfloat16; the rebuilt layer inputs against the save forward's
residual stream (hsave its rounding) and the replay gradients against the
save gradients from the same x, bit for bit (in bf16 every gradient but
dW_fg, which takes the float32 h as JAX's replay does: see
tests/test_torch_replay_wfg.py); ``fused_train_loss`` with
``fused_strategy="replay"`` against JAX's; and the trainer CLI with
``--fused_strategy replay`` against ``--fused_strategy save``.

Tolerances, those of tests/test_torch_stack_kernel.py: float32 forward
rtol 1e-5, gradients within 1% of each leaf's largest magnitude plus a
gate on the mean difference (a systematic bias); bfloat16 forward within
2% of each output's scale, gradients within 5%, the bias gate at 0.5%."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from movenet_tpu.config import ModelConfig as JModelConfig
from movenet_tpu.models import fused as jfused
from movenet_tpu.models.wavenet import WaveNet as JWaveNet
from movenet_tpu.models.wavenet import make_wavenet as j_make
from movenet_tpu.ops.pallas import stack_kernel as jsk

from movenet_tpu_torch.config import ModelConfig
from movenet_tpu_torch.models import fused
from movenet_tpu_torch.models.convert import flatten_tree, load_jax_params
from movenet_tpu_torch.models.wavenet import make_wavenet
from movenet_tpu_torch.ops import stack_kernel as sk

torch.set_num_threads(2)
B, R, S, T = 2, 16, 16, 1280
# the projection triple's T: JAX's replay takes the triple where its tile
# is a multiple of 80 (1600 here; 256 at T = 1280)
T_PROJ = 1600
DIL = (1, 2, 4) * 2
L = len(DIL)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(ctx_kind, seed=0, n=L):
    """Seeded numpy inputs of an n-layer trunk: x, the ctx (flat, or the
    triple xc, wup, bup), the trunk's weights and dskip; T_PROJ rows with
    the triple, T without."""
    rng = np.random.default_rng(seed)
    t = T_PROJ if ctx_kind == "proj" else T
    f = np.float32
    win = (3 if ctx_kind else 2) * R
    a = dict(
        x=(rng.standard_normal((B, t, R)) * 0.5).astype(f),
        b_fg=(rng.standard_normal((n * B, 2 * R)) * 0.1).astype(f),
        w_fg=(rng.standard_normal((n, win, 2 * R)) / np.sqrt(win)).astype(f),
        w_out=(rng.standard_normal((n, R, R + S)) / np.sqrt(R)).astype(f),
        b_out=(rng.standard_normal((n, R + S)) * 0.1).astype(f),
        dskip=(rng.standard_normal((B, t, S)) * 0.1).astype(f))
    if ctx_kind == "flat":
        a["ctx"] = (rng.standard_normal((B, t, R)) * 0.5).astype(f)
    elif ctx_kind == "proj":
        a["xc"] = (rng.standard_normal((B, t // 10, R)) * 0.5).astype(f)
        a["wup"] = (rng.standard_normal((R, 10 * R)) / 4).astype(f)
        a["bup"] = (rng.standard_normal((10 * R,)) * 0.1).astype(f)
    return a


# the activations, in the compute dtype; the rest float32
CAST = {"x", "ctx", "xc"}


def _names(a):
    return ["x"] + [k for k in ("ctx", "xc", "wup", "bup") if k in a] \
        + ["b_fg", "w_fg", "w_out", "b_out"]


def _ctx(d):
    if "xc" in d:
        return (d["xc"], d["wup"], d["bup"])
    return d.get("ctx")


def _jax_replay(a, dtype):
    jdt = DTYPES[dtype][1]
    names = _names(a)
    args = [jnp.asarray(a[n], jdt if n in CAST else jnp.float32)
            for n in names]

    def op(*xs):
        d = dict(zip(names, xs))
        return jsk.fused_stack(d["x"], _ctx(d), d["b_fg"], d["w_fg"],
                               d["w_out"], d["b_out"], DIL, True, "replay")

    skip, vjp = jax.vjp(op, *args)
    grads = vjp(jnp.asarray(a["dskip"], jdt))
    return (np.asarray(skip, np.float32),
            {n: np.asarray(g, np.float32) for n, g in zip(names, grads)})


def _torch_op(a, dtype, strategy):
    """(skip, grads by name) of the port's fused_stack."""
    tdt = DTYPES[dtype][0]
    ts = {n: torch.tensor(a[n], dtype=tdt if n in CAST else torch.float32,
                          requires_grad=True) for n in _names(a)}
    skip = sk.fused_stack(ts["x"], _ctx(ts), ts["b_fg"], ts["w_fg"],
                          ts["w_out"], ts["b_out"], DIL, strategy=strategy)
    skip.backward(torch.tensor(a["dskip"], dtype=tdt))
    return skip.detach(), {n: t.grad for n, t in ts.items()}


def _close_grad(name, got, want, rel, bias_rel):
    scale = float(np.max(np.abs(want))) + 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=name)
    bias = abs(float(np.mean(got - want)))
    assert bias <= bias_rel * scale + 1e-10, \
        f"{name}: systematic difference {bias:.3e} vs scale {scale:.3e}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ctx_kind", [None, "flat", "proj"])
def test_fused_stack_replay_matches_jax(ctx_kind, dtype):
    """skip_sum and every gradient of the port's replay strategy against
    JAX's replay (its save_h=False kernels in interpret mode)."""
    a = _inputs(ctx_kind)
    want_skip, want_g = _jax_replay(a, dtype)
    skip, grads = _torch_op(a, dtype, "replay")
    f32 = dtype == "float32"
    scale = float(np.max(np.abs(want_skip)))
    if f32:
        np.testing.assert_allclose(skip.numpy(), want_skip, rtol=1e-5,
                                   atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(skip.float().numpy(), want_skip, rtol=0,
                                   atol=2e-2 * scale)
    assert set(grads) == set(want_g)
    for n, w in want_g.items():
        got = grads[n].float().numpy()
        if f32:
            _close_grad(n, got, w, 1e-2, 2e-4)
        else:
            _close_grad(n, got, w, 5e-2, 5e-3)


def _torch_inputs(a, dtype, dil=DIL):
    tdt = DTYPES[dtype][0]
    ts = {n: torch.tensor(v, dtype=tdt if n in CAST else torch.float32)
          for n, v in a.items()}
    ctx, proj = ts.get("ctx"), None
    if "xc" in ts:
        trip = (ts["xc"], ts["wup"], ts["bup"])
        ctx, proj = sk.ctx_flatten(trip, tdt), sk._ctx_proj_args(trip)
    fwd = (ts["x"], ctx, ts["b_fg"], ts["w_fg"], ts["w_out"], ts["b_out"],
           dil)
    return fwd, ts["dskip"].to(tdt), proj


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ctx_kind", [None, "flat", "proj"])
def test_replay_plain_rebuild_is_the_save_hsave(ctx_kind, dtype):
    """The plain replay forward gives the save forward's skip and tfsg,
    its checkpoints round to hsave at their layers, and every layer input
    rebuilt from x and the checkpoints is the float32 residual stream: the
    checkpoints at their layers, and rounded the save forward's hsave,
    bit for bit."""
    fwd, _, _ = _torch_inputs(_inputs(ctx_kind, seed=1), dtype)
    skip, hsave, tfsg = sk.stack_fwd_x_plain(*fwd)
    got_skip, ckpt, got_tfsg = sk.stack_fwd_replay_plain(*fwd)
    assert torch.equal(got_skip, skip) and torch.equal(got_tfsg, tfsg)
    every = sk.tails_every(L)
    assert ckpt.dtype == torch.float32
    for i, l in enumerate(sk.ckpt_layers(L, every)):
        assert torch.equal(ckpt[i].to(fwd[0].dtype), hsave[l])
    rebuilt = []
    x, w_out, b_out = fwd[0], fwd[4], fwd[5]
    for lo in range(0, L, every):
        h0 = x if lo == 0 else ckpt[lo // every - 1]
        rebuilt += sk.replay_rebuild(h0.float(), tfsg, w_out, b_out, x.dtype,
                                     lo, min(lo + every, L))
    assert len(rebuilt) == L
    for l in range(L):
        assert rebuilt[l].dtype == torch.float32
        assert torch.equal(rebuilt[l].to(x.dtype), hsave[l]), l
    for i, l in enumerate(sk.ckpt_layers(L, every)):
        assert torch.equal(rebuilt[l], ckpt[i]), l


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ctx_kind", [None, "flat", "proj"])
def test_replay_gradients_are_the_save_gradients(ctx_kind, dtype):
    """The plain replay backward against the plain save-from-x backward on
    the same x, and fused_stack's replay against its save strategy through
    autograd: the same bits, but for dW_fg in bf16, which takes the float32
    h (JAX's replay) where save takes hsave's bf16(h): there it differs
    from save's, within the bf16 bar."""
    a = _inputs(ctx_kind, seed=2)
    fwd, dskip, proj = _torch_inputs(a, dtype)
    _, ckpt, tfsg = sk.stack_fwd_replay_plain(*fwd)
    _, hsave, _ = sk.stack_fwd_x_plain(*fwd)
    x, ctx, _, w_fg, w_out, b_out, _ = fwd
    got = sk.stack_bwd_replay_plain(x, ckpt, tfsg, ctx, w_fg, w_out, b_out,
                                    dskip, DIL, proj)
    want = sk.stack_bwd_x_plain(hsave, tfsg, ctx, w_fg, w_out, dskip, DIL,
                                proj)
    assert len(got) == len(want) == 7
    _same_but_wfg(got, want, 3, dtype)
    skip_r, g_r = _torch_op(a, dtype, "replay")
    skip_s, g_s = _torch_op(a, dtype, "save")
    assert torch.equal(skip_r, skip_s)
    names = list(g_s)
    _same_but_wfg([g_r[n] for n in names], [g_s[n] for n in names],
                  names.index("w_fg"), dtype)


def _same_but_wfg(got, want, i_wfg, dtype):
    """Bit-equal outputs, but for W_fg's gradient (index i_wfg) in bf16:
    off save's, within the bf16 gradient bar."""
    for i, (u, v) in enumerate(zip(got, want)):
        if dtype == "bfloat16" and i == i_wfg:
            assert not torch.equal(u, v)
            _close_grad("w_fg", u.float().numpy(), v.float().numpy(), 5e-2,
                        5e-3)
        else:
            assert (u is None and v is None) or torch.equal(u, v), i


def test_replay_checkpoints_and_groups():
    """The checkpoints sit at the inputs of layers k, 2k, ... < L, k =
    ``tails_every(L)``; a wrong count is refused; with every = 1 each layer
    is its own group and the backward is unchanged."""
    fwd, dskip, _ = _torch_inputs(_inputs("flat", seed=3), "float32")
    _, ckpt, tfsg = sk.stack_fwd_replay_plain(*fwd)
    assert ckpt.shape == (len(sk.ckpt_layers(L, sk.tails_every(L))), B, T, R)
    x, ctx, _, w_fg, w_out, b_out, _ = fwd
    tail = (tfsg, ctx, w_fg, w_out, b_out, dskip, DIL)
    with pytest.raises(ValueError, match="checkpoints"):
        sk.stack_bwd_replay_plain(x, ckpt[:0], *tail)
    _, every1, _ = sk.stack_fwd_replay_plain(*fwd, every=1)
    assert every1.shape[0] == L - 1
    for u, v in zip(sk.stack_bwd_replay_plain(x, every1, *tail, every=1),
                    sk.stack_bwd_replay_plain(x, ckpt, *tail)):
        assert (u is None and v is None) or torch.equal(u, v)


# experiment 04's trunk (layer_size 14, stack 1): groups of 4, the last of
# 2; at L = 13 the last group is one layer
DIL_EXP04 = tuple(2 ** i for i in range(14))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dil", [DIL_EXP04, DIL_EXP04[:13]],
                         ids=["L14", "L13"])
def test_replay_short_last_group_is_the_save_strategy(dil, dtype):
    """With a last group shorter than k = ``tails_every(L)``, the plain
    replay gives the save forward's skip and taps, and its backward the
    save-from-x backward's outputs, bit for bit (dW_fg in bf16 within the
    bar)."""
    n = len(dil)
    assert n % sk.tails_every(n)
    fwd, dskip, proj = _torch_inputs(_inputs("proj", seed=4, n=n), dtype,
                                     dil)
    skip, hsave, tfsg = sk.stack_fwd_x_plain(*fwd)
    got_skip, ckpt, got_tfsg = sk.stack_fwd_replay_plain(*fwd)
    assert torch.equal(got_skip, skip) and torch.equal(got_tfsg, tfsg)
    x, ctx, _, w_fg, w_out, b_out, _ = fwd
    got = sk.stack_bwd_replay_plain(x, ckpt, tfsg, ctx, w_fg, w_out, b_out,
                                    dskip, dil, proj)
    want = sk.stack_bwd_x_plain(hsave, tfsg, ctx, w_fg, w_out, dskip, dil,
                                proj)
    _same_but_wfg(got, want, 3, dtype)


# ---------------------------------------------- the model and the trainer
def _model_setup(dtype, t, seed=0):
    kw = dict(layer_size=3, stack_size=2, input_channels=64,
              residual_channels=16, skip_channels=16, compute_dtype=dtype,
              global_classes=0, fused_strategy="replay",
              max_audio_frames=16000, max_video_frames=16)
    jm = j_make(JModelConfig(**kw))
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 64, size=(2, t)).astype(np.int32)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(codes), None,
                     None, method=JWaveNet.init_all)["params"]
    tm = load_jax_params(make_wavenet(ModelConfig(**kw)), params)
    return jm, params, tm, codes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_train_loss_replay_matches_jax(dtype, monkeypatch):
    """``fused_train_loss`` with ``fused_strategy="replay"`` (layer 3 x
    stack 2, R = 16, T = 1024, as tests/test_fused_model.py sets replay
    up) against JAX's: the loss and every parameter gradient by flax name,
    at tests/test_torch_train.py's bars (float32 rtol 1e-5 and 1% of each
    leaf; bf16 1e-4 and 10%), through the replay op alone."""
    jm, params, tm, codes = _model_setup(dtype, 1024)
    calls = []
    for name in ("stack_fwd_replay_plain", "stack_fwd_x_plain",
                 "stack_fwd_plain", "stack_fwd_tails_plain"):
        fn = getattr(sk, name)
        monkeypatch.setattr(sk, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])

    def jloss(p):
        return jfused.fused_train_loss(jm, p, jnp.asarray(codes),
                                       interpret=True)

    (want_l, want_a), want_g = jax.value_and_grad(jloss, has_aux=True)(
        params)
    loss, acc = fused.fused_train_loss(tm, torch.from_numpy(codes))
    loss.backward()
    assert calls == ["stack_fwd_replay_plain"]
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(loss.detach()), float(want_l),
                               rtol=1e-5 if f32 else 1e-4)
    n_valid = 2 * (1024 - tm.receptive_fields)
    assert abs(float(acc) - float(want_a)) <= 1.0 / n_valid + 1e-7
    want_g = flatten_tree(want_g)
    got_g = {n: (np.zeros(p.shape, np.float32) if p.grad is None
                 else p.grad.float().numpy())
             for n, p in tm.named_parameters()}
    assert set(got_g) == set(want_g), set(got_g) ^ set(want_g)
    for n, w in want_g.items():
        _close_grad(n, got_g[n], np.asarray(w, np.float32),
                    1e-2 if f32 else 1e-1, 2e-4 if f32 else 5e-3)


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    from movenet_tpu_torch.data import make_synthetic_dataset

    root = tmp_path_factory.mktemp("torch_replay_ds")
    make_synthetic_dataset(
        root, categories=["breakdancing"], clips_per_category=4,
        audio_fps=2000, video_fps=2, duration_s=1.0, frame_hw=(48, 48),
        seed=3)
    return root


def _cli_losses(dataset_root, tmp_path, monkeypatch, strategy):
    """Train losses of a 2-step trainer CLI run on the CPU (float32, the
    fused route, 1 s clips resampled to 2048 codes, a multiple of the
    fused route's 128) with ``--fused_strategy strategy``, and the trunk
    ops that ran."""
    import movenet_tpu_torch.config as C
    from movenet_tpu_torch.train.cli import main

    orig = C.config_from_args

    def patched(args):
        cfg = orig(args)
        cfg.model_config.max_audio_frames = 2048
        cfg.model_config.max_video_frames = 2
        cfg.use_video = False
        return cfg

    monkeypatch.setattr(C, "config_from_args", patched)
    monkeypatch.setattr("movenet_tpu_torch.train.cli.config_from_args",
                        patched)
    routes = []
    for name in ("stack_fwd_replay_plain", "stack_fwd_x_plain",
                 "stack_fwd_plain", "stack_fwd_tails_plain"):
        fn = getattr(sk, name)
        monkeypatch.setattr(sk, name, lambda *a, _f=fn, _n=name, **k: (
            routes.append(_n), _f(*a, **k))[1])
    out, logs = tmp_path / f"m_{strategy}", tmp_path / f"l_{strategy}"
    state = main([
        "--dataset", str(dataset_root), "--n_epochs", "1",
        "--batch_size", "2", "--val_batch_size", "2",
        "--learning_rate", "0.0003", "--input_channels", "64",
        "--residual_channels", "16", "--skip_channels", "16",
        "--layer_size", "3", "--stack_size", "2", "--checkpoint_every", "1",
        "--num_workers", "1", "--val_num_workers", "1",
        "--compute_dtype", "float32",
        "--fused_blocks", "1", "--fused_strategy", strategy,
        "--log_every_n_steps", "1", "--model_output_path", str(out),
        "--training_logs_path", str(logs)], device="cpu")
    assert state.step == 2
    lines = [json.loads(l) for l in
             (logs / "metrics.jsonl").read_text().splitlines()]
    return [l["loss"] for l in lines if l["tag"] == "train"], set(routes)


def test_trainer_cli_replay_trains_as_save(dataset_root, tmp_path,
                                           monkeypatch):
    """The trainer CLI with --fused_strategy replay takes the replay op
    (and no other trunk op) and its 2 steps' losses match --fused_strategy
    save's within 1e-6 relative."""
    replay, r_routes = _cli_losses(dataset_root, tmp_path, monkeypatch,
                                   "replay")
    save, s_routes = _cli_losses(dataset_root, tmp_path, monkeypatch, "save")
    assert r_routes == {"stack_fwd_replay_plain"}
    assert s_routes == {"stack_fwd_plain"}
    assert len(replay) == len(save) == 2
    assert all(np.isfinite(replay))
    np.testing.assert_allclose(replay, save, rtol=1e-6)
