"""The trunk ops at experiment 03's and 04's widths, (R, S) = (32, 8) and
(16, 8), on the CPU (their plain versions) against the JAX package's
Pallas ops in interpret mode: ``fused_stack_embed`` (the save strategy
with the embedding folded in, the route both experiments take) and the
non-embed ``fused_stack`` (save from x, and recompute where the halo is
small), skip_sum and every gradient.  Experiment 04's dilations (1 ..
8192, 14 layers) run at T = 1280, so the large dilations' taps and
anti-causal carries fall outside the clip, as the early rows' do at T =
160,000.  Also the strategy the fused loss picks for both experiments'
full shapes, against the JAX package's.

Tolerances as tests/test_torch_stack_kernel.py: float32 forward rtol
1e-5, gradients within 1% of each leaf's largest magnitude plus a gate
on the mean difference; bfloat16 forward within 2% of the scale,
gradients within 5%, the bias gate at 0.5%."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from movenet_tpu.ops.pallas import stack_kernel as jsk

from movenet_tpu_torch.ops import stack_kernel as sk

torch.set_num_threads(2)
B, V = 2, 128
EXP03_DIL = (1, 2, 1, 2)                       # layer 2 x stack 2
EXP04_DIL = tuple(2 ** i for i in range(14))   # layer 14 x stack 1


def _inputs(t, r, s, dil, ctx, seed=0):
    rng = np.random.default_rng(seed)
    n = len(dil)
    codes = rng.integers(0, V, size=(B, t)).astype(np.int32)
    prev = np.concatenate([np.full((B, 1), -1, np.int32), codes[:, :-1]], 1)
    pack = np.ascontiguousarray(
        np.concatenate([codes, prev, np.roll(codes, -1, 1)], 0).T)
    f = np.float32
    win = (3 if ctx else 2) * r
    a = dict(
        table2=(rng.standard_normal((2 * V, r)) * 0.5).astype(f),
        b_fg=(rng.standard_normal((n * B, 2 * r)) * 0.1).astype(f),
        w_fg=(rng.standard_normal((n, win, 2 * r)) / np.sqrt(win)).astype(f),
        w_out=(rng.standard_normal((n, r, r + s)) / np.sqrt(r)).astype(f),
        b_out=(rng.standard_normal((n, r + s)) * 0.1).astype(f),
        x=(rng.standard_normal((B, t, r)) * 0.5).astype(f),
        dskip=(rng.standard_normal((B, t, s)) * 0.1).astype(f))
    if ctx:
        a["ctx"] = (rng.standard_normal((B, t, r)) * 0.5).astype(f)
    return pack, a


def _close(name, got, want, f32):
    scale = float(np.max(np.abs(want))) + 1e-12
    rel, bias_rel = (1e-2, 2e-4) if f32 else (5e-2, 5e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=name)
    bias = abs(float(np.mean(got - want)))
    assert bias <= bias_rel * scale + 1e-10, name


def _run_both(pack, a, dil, dtype, embed, strategy):
    """(skip, grads) of the JAX op and of the port's op."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    first = "table2" if embed else "x"
    names = [first] + (["ctx"] if "ctx" in a else []) \
        + ["b_fg", "w_fg", "w_out", "b_out"]
    cast = {"table2", "x", "ctx"}
    jargs = [jnp.asarray(a[n], jdt if n in cast else jnp.float32)
             for n in names]
    pack_j = jnp.asarray(pack)

    def jop(*xs):
        d = dict(zip(names, xs))
        rest = (d.get("ctx"), d["b_fg"], d["w_fg"], d["w_out"], d["b_out"],
                dil)
        if embed:
            return jsk.fused_stack_embed(pack_j, d[first], *rest, jdt, True)
        return jsk.fused_stack(d[first], *rest, True, strategy)

    want, vjp = jax.vjp(jop, *jargs)
    want_g = vjp(jnp.asarray(a["dskip"], jdt))
    ts = {n: torch.tensor(a[n], dtype=tdt if n in cast else torch.float32,
                          requires_grad=True) for n in names}
    rest = (ts.get("ctx"), ts["b_fg"], ts["w_fg"], ts["w_out"],
            ts["b_out"], dil)
    if embed:
        got = sk.fused_stack_embed(torch.from_numpy(pack), ts[first], *rest)
    else:
        got = sk.fused_stack(ts[first], *rest, strategy=strategy)
    got.backward(torch.tensor(a["dskip"], dtype=tdt))
    return (np.asarray(want, np.float32), got.detach().float().numpy(),
            {n: (np.asarray(g, np.float32), ts[n].grad.float().numpy())
             for n, g in zip(names, want_g)})


@pytest.mark.parametrize("r,dil,t,ctx,dtype,embed,strategy", [
    (32, EXP03_DIL, 1280, True, "bfloat16", True, "save"),
    (32, EXP03_DIL, 1280, True, "float32", False, "recompute"),
    (16, EXP04_DIL, 1280, True, "bfloat16", True, "save"),
    (16, EXP04_DIL, 1280, False, "float32", False, "save"),
])
def test_narrow_trunk_matches_jax(r, dil, t, ctx, dtype, embed, strategy):
    pack, a = _inputs(t, r, 8, dil, ctx)
    want, got, grads = _run_both(pack, a, dil, dtype, embed, strategy)
    f32 = dtype == "float32"
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=1e-5 if f32 else 0,
                               atol=(1e-5 if f32 else 2e-2) * scale)
    for name, (w, g) in grads.items():
        _close(name, g, w, f32)


@pytest.mark.parametrize("dil,r,batch,remat", [
    (EXP03_DIL, 32, 3, False), (EXP04_DIL, 16, 2, True),
])
def test_experiment_strategy_matches_jax(dil, r, batch, remat):
    """At T = 160,000 both experiments resolve to the save strategy with
    the embedding folded in: experiment 04's --remat 1 finds no
    recompute tile (d = 8192 exceeds the stack tile), as in JAX."""
    from movenet_tpu.config import ModelConfig as JConfig
    from movenet_tpu.models import fused as jfused
    from movenet_tpu.models.wavenet import make_wavenet as j_make

    from movenet_tpu_torch.config import ModelConfig
    from movenet_tpu_torch.models import fused
    from movenet_tpu_torch.models.wavenet import make_wavenet

    t = 160_000
    layer, stack = (14, 1) if dil == EXP04_DIL else (2, 2)
    kw = dict(layer_size=layer, stack_size=stack, input_channels=128,
              residual_channels=r, skip_channels=8, remat=remat,
              compute_dtype="bfloat16")
    model = make_wavenet(ModelConfig(**kw))
    jmodel = j_make(JConfig(**kw))
    assert tuple(model.dilations) == tuple(jmodel.dilations) == dil
    n = len(dil)
    stacked_w = (np.zeros((n, 1, 2 * r)), None, None, None)
    want = jfused._stack_weights(jmodel, stacked_w, t, dil)[0]
    got = fused._strategy(model, t)
    assert got == want == "auto"
    shape = (batch, t, r)
    assert sk.resolve_strategy(got, shape, n, dil, 2) == "save"
    assert jsk.resolve_strategy(want, shape, n, dil, 2) == "save"
    assert sk.supports_recompute(t, dil) == jsk.supports_recompute(t, dil)
    assert 2 * V <= sk.EMBED_MAX_2V
