"""The port's whole-stack trunk ops on the CPU, where they run their plain
versions, against the JAX package's Pallas ops in interpret mode: the
save strategy's ``fused_stack_embed`` (the forward, skip_sum, hsave, tfsg,
and every gradient, without ctx, with the flat ctx and with the
projection triple; and at V = 512, above the kernel's 2V) and the
recompute strategy's non-embed ``fused_stack`` (skip_sum and every
gradient, without and with ctx, at sum(d) = 14 and 510), in float32 and
bfloat16; ``front_embed`` and ``ctx_proj_fold`` against their XLA
counterparts.  Plus the recompute strategy's layer checkpoints, the
geometry helpers and the paths the port refuses (the replay strategy has
its own file, tests/test_torch_replay.py).

Tolerances: float32 forward rtol 1e-5; gradients within 1% of each leaf's
largest magnitude plus a gate on the mean difference (a systematic bias),
as tests/test_fused_model.py compares the two JAX paths.  bfloat16: the
two frameworks round the same sums in different orders, so a stored bf16
value may differ by a few of its last bits: the forward within 2% of each
output's scale, gradients within 5%, the bias gate at 0.5%."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from movenet_tpu.ops.pallas import stack_kernel as jsk

from movenet_tpu_torch.ops import stack_kernel as sk

torch.set_num_threads(2)
B, R, S, V = 2, 16, 16, 64
DIL = (1, 2, 4, 1, 2, 4)
L = len(DIL)


def _inputs(t, ctx_kind, dtype, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, V, size=(B, t)).astype(np.int32)
    prev = np.concatenate([np.full((B, 1), -1, np.int32), codes[:, :-1]], 1)
    pack = np.ascontiguousarray(
        np.concatenate([codes, prev, np.roll(codes, -1, 1)], 0).T)
    f = np.float32
    win = (3 if ctx_kind else 2) * R
    arrs = dict(
        table2=(rng.standard_normal((2 * V, R)) * 0.5).astype(f),
        b_fg=(rng.standard_normal((L * B, 2 * R)) * 0.1).astype(f),
        w_fg=(rng.standard_normal((L, win, 2 * R)) / np.sqrt(win)).astype(f),
        w_out=(rng.standard_normal((L, R, R + S)) / np.sqrt(R)).astype(f),
        b_out=(rng.standard_normal((L, R + S)) * 0.1).astype(f),
        dskip=(rng.standard_normal((B, t, S)) * 0.1).astype(f))
    if ctx_kind == "flat":
        arrs["ctx"] = (rng.standard_normal((B, t, R)) * 0.5).astype(f)
    elif ctx_kind == "proj":
        arrs["xc"] = (rng.standard_normal((B, t // 10, R)) * 0.5).astype(f)
        arrs["wup"] = (rng.standard_normal((R, 10 * R)) / 4).astype(f)
        arrs["bup"] = (rng.standard_normal((10 * R,)) * 0.1).astype(f)
    return pack, arrs


def _jax_run(pack, a, dtype, want_saved):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    names = ["table2"] + [k for k in ("ctx", "xc", "wup", "bup") if k in a] \
        + ["b_fg", "w_fg", "w_out", "b_out"]
    cast = {"table2", "ctx", "xc"}
    args = [jnp.asarray(a[n], jdt if n in cast else jnp.float32)
            for n in names]
    pack_j = jnp.asarray(pack)

    def op(*xs):
        d = dict(zip(names, xs))
        ctx = d.get("ctx")
        if "xc" in d:
            ctx = (d["xc"], d["wup"], d["bup"])
        return jsk.fused_stack_embed(pack_j, d["table2"], ctx, d["b_fg"],
                                     d["w_fg"], d["w_out"], d["b_out"], DIL,
                                     jdt, True)

    skip, vjp = jax.vjp(op, *args)
    grads = vjp(jnp.asarray(a["dskip"], jdt))
    saved = None
    if want_saved:
        ctx = args[1] if "ctx" in a else None
        if "xc" in a:
            ctx = jsk.ctx_flatten(tuple(args[1:4]), jdt)
        _, hsave, tfsg, _ = jsk._fwd_pallas(
            None, ctx, args[-4], args[-3], args[-2], args[-1], DIL, True,
            embed=(pack_j, args[0], B), dtype=jdt)
        saved = (np.asarray(hsave, np.float32), np.asarray(tfsg, np.float32))
    return (np.asarray(skip, np.float32),
            {n: np.asarray(g, np.float32) for n, g in zip(names, grads)},
            saved)


def _torch_run(pack, a, dtype):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    cast = {"table2", "ctx", "xc"}
    ts = {n: torch.tensor(v, dtype=tdt if n in cast else torch.float32,
                          requires_grad=True)
          for n, v in a.items() if n != "dskip"}
    ctx = ts.get("ctx")
    if "xc" in ts:
        ctx = (ts["xc"], ts["wup"], ts["bup"])
    skip = sk.fused_stack_embed(torch.from_numpy(pack), ts["table2"], ctx,
                                ts["b_fg"], ts["w_fg"], ts["w_out"],
                                ts["b_out"], DIL)
    skip.backward(torch.tensor(a["dskip"], dtype=tdt))
    return skip.detach().float().numpy(), \
        {n: t.grad.float().numpy() for n, t in ts.items()}


def _close_grad(name, got, want, rel, bias_rel):
    scale = float(np.max(np.abs(want))) + 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=name)
    bias = abs(float(np.mean(got - want)))
    assert bias <= bias_rel * scale + 1e-10, \
        f"{name}: systematic difference {bias:.3e} vs scale {scale:.3e}"


@pytest.mark.parametrize("t,ctx_kind,dtype,saved", [
    (1024, None, "float32", True),
    (12800, "proj", "float32", False),
    (1280, "flat", "float32", False),
    (12800, "proj", "bfloat16", True),
])
def test_fused_stack_embed_matches_jax(t, ctx_kind, dtype, saved):
    pack, a = _inputs(t, ctx_kind, dtype)
    want_skip, want_g, want_saved = _jax_run(pack, a, dtype, saved)
    got_skip, got_g = _torch_run(pack, a, dtype)
    f32 = dtype == "float32"
    scale = float(np.max(np.abs(want_skip)))
    if f32:
        np.testing.assert_allclose(got_skip, want_skip, rtol=1e-5,
                                   atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got_skip, want_skip, rtol=0,
                                   atol=2e-2 * scale)
    if saved:
        tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        ts = {n: torch.tensor(v, dtype=tdt if n in ("table2", "ctx", "xc")
                              else torch.float32) for n, v in a.items()}
        ctx = ts.get("ctx")
        if "xc" in ts:
            ctx = sk.ctx_flatten((ts["xc"], ts["wup"], ts["bup"]), tdt)
        _, hsave, tfsg = sk.stack_fwd_plain(
            torch.from_numpy(pack), ts["table2"], ctx, ts["b_fg"],
            ts["w_fg"], ts["w_out"], ts["b_out"], DIL, B)
        for got, want in zip((hsave, tfsg), want_saved):
            got = got.float().numpy()
            sc = float(np.max(np.abs(want)))
            np.testing.assert_allclose(
                got, want, rtol=0, atol=(1e-5 if f32 else 2e-2) * sc)
    assert set(got_g) == set(want_g)
    for n in want_g:
        if f32:
            _close_grad(n, got_g[n], want_g[n], 1e-2, 2e-4)
        else:
            _close_grad(n, got_g[n], want_g[n], 5e-2, 5e-3)


@pytest.mark.parametrize("t", [1024, 1280, 12800, 160_000, 16_000, 1000])
@pytest.mark.parametrize("ctx", [False, True])
def test_pick_stack_tile_matches_jax(t, ctx):
    for dil in (DIL, (1, 2, 4) * 3, tuple(2 ** i for i in range(10)) * 3):
        try:
            want = jsk.pick_stack_tile(t, dil, ctx=ctx)
        except ValueError:
            with pytest.raises(ValueError):
                sk.pick_stack_tile(t, dil, ctx=ctx)
            continue
        assert sk.pick_stack_tile(t, dil, ctx=ctx) == want


@pytest.mark.parametrize("strategy", ["auto", "save", "recompute",
                                      "replay"])
@pytest.mark.parametrize("shape", [(2, 160_000, 64), (8, 160_000, 64),
                                   (2, 1024, 16)])
def test_resolve_strategy_matches_jax(strategy, shape):
    dil = (1, 2, 4) * 3
    try:
        want = jsk.resolve_strategy(strategy, shape, len(dil), dil, 2)
    except ValueError:
        with pytest.raises(ValueError):
            sk.resolve_strategy(strategy, shape, len(dil), dil, 2)
        return
    assert sk.resolve_strategy(strategy, shape, len(dil), dil, 2) == want
    assert sk.supports_recompute(shape[1], dil) == \
        jsk.supports_recompute(shape[1], dil)


def test_ctx_projection_helpers_match_jax():
    rng = np.random.default_rng(3)
    xc = rng.standard_normal((2, 12, R)).astype(np.float32)
    wup = rng.standard_normal((R, 10 * R)).astype(np.float32)
    bup = rng.standard_normal((10 * R,)).astype(np.float32)
    want = np.asarray(jsk.ctx_flatten(
        (jnp.asarray(xc), jnp.asarray(wup), jnp.asarray(bup)), jnp.float32))
    got = sk.ctx_flatten((torch.from_numpy(xc), torch.from_numpy(wup),
                          torch.from_numpy(bup)), torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    _, wt = jsk._ctx_proj_args((xc, wup, bup))
    _, wt_t = sk._ctx_proj_args(tuple(torch.from_numpy(x)
                                      for x in (xc, wup, bup)))
    np.testing.assert_array_equal(wt_t.numpy(), np.asarray(wt))
    aug = rng.standard_normal((10, R + 1, R)).astype(np.float32)
    for got, want in zip(
            sk._ctx_proj_grads(torch.from_numpy(aug),
                               tuple(torch.from_numpy(x)
                                     for x in (xc, wup, bup))),
            jsk._ctx_proj_grads(jnp.asarray(aug), (xc, wup, bup))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sk.ctx_is_proj((1, 2, 3)) and not sk.ctx_is_proj(xc)


def test_unported_strategies_raise():
    pack, a = _inputs(1024, None, "float32")
    ts = {n: torch.tensor(v) for n, v in a.items()}
    args = (torch.from_numpy(pack), ts["table2"], None, ts["b_fg"],
            ts["w_fg"], ts["w_out"], ts["b_out"], DIL)
    # the embed-folded op is the save strategy only, as in the JAX package
    for strategy in ("recompute", "replay"):
        with pytest.raises(ValueError, match="fused_stack"):
            sk.fused_stack_embed(*args, strategy=strategy)
    # the non-embed op runs the replay strategy (ported, ROADMAP.md B.3)
    x = torch.zeros(B, 1024, R)
    skip = sk.fused_stack(x, None, *args[3:], strategy="replay")
    assert skip.shape == (B, 1024, S) and skip.dtype == x.dtype


# --------------------------------------------- recompute (tails) route
def _tails_inputs(t, has_ctx, seed=1, n_layers=L):
    rng = np.random.default_rng(seed)
    f = np.float32
    win = (3 if has_ctx else 2) * R
    n = n_layers
    a = dict(
        x=(rng.standard_normal((B, t, R)) * 0.5).astype(f),
        b_fg=(rng.standard_normal((n * B, 2 * R)) * 0.1).astype(f),
        w_fg=(rng.standard_normal((n, win, 2 * R)) / np.sqrt(win)).astype(f),
        w_out=(rng.standard_normal((n, R, R + S)) / np.sqrt(R)).astype(f),
        b_out=(rng.standard_normal((n, R + S)) * 0.1).astype(f),
        dskip=(rng.standard_normal((B, t, S)) * 0.1).astype(f))
    if has_ctx:
        a["ctx"] = (rng.standard_normal((B, t, R)) * 0.5).astype(f)
    return a


# layer 8 x stack 2: sum(d) = 510 rows of halo, which the port's tiled
# recompute kernels could not hold; JAX's tile at T=1280 is 256
DIL_WIDE = tuple(2 ** i for i in range(8)) * 2


@pytest.mark.parametrize("has_ctx", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dil,t", [(DIL, 512), (DIL_WIDE, 1280)])
def test_fused_stack_recompute_matches_jax(has_ctx, dtype, dil, t):
    """fused_stack(strategy="recompute"), plain versions on the CPU,
    against JAX's tails kernels in interpret mode: the forward and every
    gradient, at the module's tolerances, at T=512 and at layer 8 x
    stack 2 (sum(d) = 510) with T=1280."""
    a = _tails_inputs(t, has_ctx, n_layers=len(dil))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    names = ["x"] + (["ctx"] if has_ctx else []) + \
        ["b_fg", "w_fg", "w_out", "b_out"]
    cast = {"x", "ctx"}
    jargs = [jnp.asarray(a[n], jdt if n in cast else jnp.float32)
             for n in names]

    def op(*xs):
        d = dict(zip(names, xs))
        return jsk.fused_stack(d["x"], d.get("ctx"), d["b_fg"], d["w_fg"],
                               d["w_out"], d["b_out"], dil, True,
                               "recompute")

    want_skip, vjp = jax.vjp(op, *jargs)
    want_g = {n: np.asarray(g, np.float32) for n, g in
              zip(names, vjp(jnp.asarray(a["dskip"], jdt)))}
    want_skip = np.asarray(want_skip, np.float32)

    ts = {n: torch.tensor(a[n], dtype=tdt if n in cast else torch.float32,
                          requires_grad=True) for n in names}
    skip = sk.fused_stack(ts["x"], ts.get("ctx"), ts["b_fg"], ts["w_fg"],
                          ts["w_out"], ts["b_out"], dil,
                          strategy="recompute")
    skip.backward(torch.tensor(a["dskip"], dtype=tdt))
    got_skip = skip.detach().float().numpy()
    scale = float(np.max(np.abs(want_skip)))
    f32 = dtype == "float32"
    np.testing.assert_allclose(got_skip, want_skip, rtol=0,
                               atol=(1e-5 if f32 else 2e-2) * scale)
    for n in names:
        got = ts[n].grad.float().numpy()
        if f32:
            _close_grad(n, got, want_g[n], 1e-2, 2e-4)
        else:
            _close_grad(n, got, want_g[n], 5e-2, 5e-3)


@pytest.mark.parametrize("n_layers,every", [(6, 0), (6, 1), (9, 0),
                                             (16, 0), (16, 5), (30, 0)])
def test_tails_checkpoints_hold_the_layer_inputs(n_layers, every):
    """The recompute forward keeps the input h_l of layers k, 2k, ... < L
    (k = every, or tails_every(L) = ceil(sqrt(L))), in the compute dtype,
    equal to the layer inputs of the whole forward."""
    t = 128
    dil = ((1, 2, 4, 8) * 8)[:n_layers]
    a = _tails_inputs(t, True, n_layers=n_layers)
    ts = {n: torch.tensor(v) for n, v in a.items()}
    x = ts["x"].to(torch.bfloat16)
    ctx = ts["ctx"].to(torch.bfloat16)
    k = every or sk.tails_every(n_layers)
    assert k == (every or int(np.ceil(np.sqrt(n_layers))))
    skip, ckpt = sk.stack_fwd_tails_plain(
        x, ctx, ts["b_fg"], ts["w_fg"], ts["w_out"], ts["b_out"], dil,
        every)
    bfg, ctxf = sk._tails_consts(x, ctx, ts["b_fg"], dil)
    hs, want_skip = sk._tails_rebuild(
        x.float(), ctxf, bfg, ts["w_fg"], ts["w_out"], ts["b_out"], dil,
        torch.bfloat16, 0, n_layers)
    layers = list(range(k, n_layers, k))
    assert ckpt.shape == (len(layers), B, t, R)
    assert skip.dtype == ckpt.dtype == torch.bfloat16
    assert torch.equal(skip, want_skip.to(torch.bfloat16))
    for i, l in enumerate(layers):
        assert torch.equal(hs[l], hs[l].to(torch.bfloat16).float())
        assert torch.equal(ckpt[i].float(), hs[l])


@pytest.mark.parametrize("has_ctx", [False, True])
def test_tails_backward_is_the_same_for_every_group_size(has_ctx):
    """The plain recompute backward from checkpoints every 1, 2, 4 or 16
    layers (one group: x alone) gives the same bits: each group's rebuilt
    inputs equal the forward's."""
    t, n = 256, 16
    dil = DIL_WIDE[:n]
    a = _tails_inputs(t, has_ctx, n_layers=n)
    ts = {k: torch.tensor(v) for k, v in a.items()}
    bf = torch.bfloat16
    x = ts["x"].to(bf)
    ctx = ts["ctx"].to(bf) if has_ctx else None
    w = (ts["b_fg"], ts["w_fg"], ts["w_out"], ts["b_out"])
    first = None
    for every in (1, 2, 4, 16):
        skip, ckpt = sk.stack_fwd_tails_plain(x, ctx, *w, dil, every)
        got = sk.stack_bwd_tails_plain(x, ckpt, ctx, *w,
                                       ts["dskip"].to(bf), dil, every)
        if first is None:
            first = (skip, got)
            continue
        assert torch.equal(skip, first[0])
        for u, v in zip(got, first[1]):
            assert (u is None and v is None) or torch.equal(u, v)
    # every=16 kept no checkpoint; every=2 needs seven
    with pytest.raises(ValueError, match="checkpoints"):
        sk.stack_bwd_tails_plain(x, ckpt, ctx, *w, ts["dskip"].to(bf), dil,
                                 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_stack_embed_wide_vocab_matches_jax(dtype):
    """fused_stack_embed at V = 512 (2V above the kernel's EMBED_MAX_2V,
    so the op embeds with front_embed and runs the non-embed fused_stack)
    against JAX's fused_stack_embed in interpret mode: the forward and
    every gradient at the module's tolerances."""
    v, t = 512, 1024
    rng = np.random.default_rng(6)
    codes = rng.integers(0, v, size=(B, t)).astype(np.int32)
    prev = np.concatenate([np.full((B, 1), -1, np.int32), codes[:, :-1]], 1)
    pack = np.ascontiguousarray(np.concatenate([codes, prev], 0).T)
    f = np.float32
    win = 3 * R
    a = dict(
        table2=(rng.standard_normal((2 * v, R)) * 0.5).astype(f),
        ctx=(rng.standard_normal((B, t, R)) * 0.5).astype(f),
        b_fg=(rng.standard_normal((L * B, 2 * R)) * 0.1).astype(f),
        w_fg=(rng.standard_normal((L, win, 2 * R)) / np.sqrt(win)).astype(f),
        w_out=(rng.standard_normal((L, R, R + S)) / np.sqrt(R)).astype(f),
        b_out=(rng.standard_normal((L, R + S)) * 0.1).astype(f))
    dskip = (rng.standard_normal((B, t, S)) * 0.1).astype(f)
    assert 2 * v > sk.EMBED_MAX_2V
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    cast = {"table2", "ctx"}
    names = list(a)
    jargs = [jnp.asarray(a[n], jdt if n in cast else jnp.float32)
             for n in names]

    def op(*xs):
        d = dict(zip(names, xs))
        return jsk.fused_stack_embed(jnp.asarray(pack), d["table2"],
                                     d["ctx"], d["b_fg"], d["w_fg"],
                                     d["w_out"], d["b_out"], DIL, jdt, True)

    want_skip, vjp = jax.vjp(op, *jargs)
    want_g = dict(zip(names, vjp(jnp.asarray(dskip, jdt))))
    ts = {n: torch.tensor(x, dtype=tdt if n in cast else torch.float32,
                          requires_grad=True) for n, x in a.items()}
    skip = sk.fused_stack_embed(torch.from_numpy(pack), ts["table2"],
                                ts["ctx"], ts["b_fg"], ts["w_fg"],
                                ts["w_out"], ts["b_out"], DIL)
    skip.backward(torch.tensor(dskip, dtype=tdt))
    want_skip = np.asarray(want_skip, np.float32)
    f32 = dtype == "float32"
    np.testing.assert_allclose(skip.detach().float().numpy(), want_skip,
                               rtol=0, atol=(1e-5 if f32 else 2e-2)
                               * float(np.max(np.abs(want_skip))))
    for n in names:
        got = ts[n].grad.float().numpy()
        want = np.asarray(want_g[n], np.float32)
        if f32:
            _close_grad(n, got, want, 1e-2, 2e-4)
        else:
            _close_grad(n, got, want, 5e-2, 5e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_front_embed_matches_jax(dtype):
    from movenet_tpu.models import fused as jfused

    rng = np.random.default_rng(4)
    v, t = 32, 200
    cur = rng.standard_normal((v, R)).astype(np.float32)
    past = rng.standard_normal((v, R)).astype(np.float32)
    codes = rng.integers(0, v, size=(B, t)).astype(np.int32)
    dh = rng.standard_normal((B, t, R)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want, vjp = jax.vjp(
        lambda c, p: jfused._front_embed(c, p, jnp.asarray(codes), jdt, v),
        jnp.asarray(cur), jnp.asarray(past))
    want_dc, want_dp = vjp(jnp.asarray(dh, jdt))
    tc = torch.tensor(cur, requires_grad=True)
    tp = torch.tensor(past, requires_grad=True)
    got = sk.front_embed(tc, tp, torch.from_numpy(codes), tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32))
    got.backward(torch.tensor(dh, dtype=tdt))
    for g, w in ((tc.grad, want_dc), (tp.grad, want_dp)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_ctx_proj_fold_matches_jax():
    rng = np.random.default_rng(5)
    tc = 12
    xc = rng.standard_normal((B, tc, R)).astype(np.float32)
    wup = rng.standard_normal((R, 10 * R)).astype(np.float32)
    bup = rng.standard_normal((10 * R,)).astype(np.float32)
    dctx = rng.standard_normal((B, 10 * tc, R)).astype(np.float32)
    want = jsk._ctx_proj_fold_xla(
        jnp.asarray(dctx), (jnp.asarray(xc), jnp.asarray(wup),
                            jnp.asarray(bup)))
    got = sk.ctx_proj_fold(torch.from_numpy(dctx),
                           tuple(torch.from_numpy(x) for x in (xc, wup, bup)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
