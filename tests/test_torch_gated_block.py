"""The port's gated-block op on the CPU, where it runs its plain versions,
against the JAX package's Pallas kernel in interpret mode: the forward
(res, skip) and every gradient for dilations 1, 4, 128 and 256, with and
without ctx, at the bars of tests/test_gated_block_kernel.py (forward
rtol/atol 2e-5, gradients 2e-4); and the per-block route of the fused
trunk, forced in both packages by making ``pick_stack_tile`` raise,
through ``fused_train_loss`` (loss rtol 1e-5, every parameter gradient
within 1% of its leaf's scale with the mean-difference gate at 2e-4, as
tests/test_fused_model.py holds the two JAX paths)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from movenet_tpu.models import fused as jfused
from movenet_tpu.ops.pallas import gated_block as jgb
from movenet_tpu.ops.pallas import stack_kernel as jsk

from movenet_tpu_torch.models import fused
from movenet_tpu_torch.models.convert import flatten_tree
from movenet_tpu_torch.ops import gated_block as gb

torch.set_num_threads(2)
R, S = 16, 16


def _make(has_ctx, t=3 * gb.TILE, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    win = (3 if has_ctx else 2) * R
    a = dict(h=(rng.standard_normal((batch, t, R)) * 0.3).astype(f),
             b_fg=(rng.standard_normal((batch, 2 * R)) * 0.1).astype(f),
             w_fg=(rng.standard_normal((win, 2 * R)) * 0.2).astype(f),
             w_out=(rng.standard_normal((R, R + S)) * 0.2).astype(f),
             b_out=(rng.standard_normal((1, R + S)) * 0.1).astype(f))
    if has_ctx:
        a["ctx"] = (rng.standard_normal((batch, t, R)) * 0.3).astype(f)
    return a


@pytest.mark.parametrize("d", [1, 4, gb.TILE, 2 * gb.TILE])
@pytest.mark.parametrize("has_ctx", [False, True])
def test_fused_gated_block_matches_jax(d, has_ctx):
    a = _make(has_ctx)
    names = ["h"] + (["ctx"] if has_ctx else []) + \
        ["b_fg", "w_fg", "w_out", "b_out"]

    def jloss(*xs):
        k = dict(zip(names, xs))
        res, skip = jgb.fused_gated_block(k["h"], k.get("ctx"), k["b_fg"],
                                          k["w_fg"], k["w_out"], k["b_out"],
                                          d, True)
        return jnp.sum(jnp.sin(res)) + jnp.sum(skip * skip), (res, skip)

    jargs = [jnp.asarray(a[n]) for n in names]
    (_, (want_res, want_skip)), want_g = jax.value_and_grad(
        jloss, argnums=tuple(range(len(names))), has_aux=True)(*jargs)

    ts = {n: torch.tensor(a[n], requires_grad=True) for n in names}
    res, skip = gb.fused_gated_block(ts["h"], ts.get("ctx"), ts["b_fg"],
                                     ts["w_fg"], ts["w_out"], ts["b_out"], d)
    for got, want in ((res, want_res), (skip, want_skip)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
    (torch.sin(res).sum() + (skip * skip).sum()).backward()
    for n, want in zip(names, want_g):
        got = ts[n].grad
        assert got.dtype == torch.float32 and got.shape == ts[n].shape, n
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4, err_msg=f"d={d} {n}")


def test_gated_block_bf16_rounds_res_and_skip():
    """In bf16, res and skip come out in h's dtype, rounded from the
    float32 block (the product operands are not rounded), and the
    gradients in the weights' dtypes."""
    a = _make(True, t=gb.TILE)
    ts = {n: torch.tensor(v) for n, v in a.items()}
    bf = torch.bfloat16
    h, ctx = ts["h"].to(bf), ts["ctx"].to(bf)
    args = (ts["b_fg"], ts["w_fg"], ts["w_out"], ts["b_out"], 4)
    res, skip = gb.gated_block_fwd_plain(h, ctx, *args)
    res32, skip32 = gb.gated_block_fwd_plain(h.float(), ctx.float(), *args)
    assert res.dtype == skip.dtype == bf
    assert torch.equal(res, res32.to(bf)) and torch.equal(skip, skip32.to(bf))
    w = {n: ts[n].requires_grad_() for n in ("b_fg", "w_fg", "w_out",
                                            "b_out")}
    h.requires_grad_()
    res, skip = gb.fused_gated_block(h, ctx, w["b_fg"], w["w_fg"],
                                     w["w_out"], w["b_out"], 4)
    (res.float().sum() + skip.float().sum()).backward()
    assert h.grad.dtype == bf
    assert all(t.grad.dtype == torch.float32 for t in w.values())


# ------------------------------------------------- the per-block route
def _no_tile(*a, **k):
    raise ValueError("no stack tile (forced by the test)")


def test_per_block_trunk_matches_jax(monkeypatch):
    """``pick_stack_tile`` raising in both packages sends the fused loss
    through one gated block per layer, as JAX's ``_fused_trunk`` does at
    fused.py:244-258; with video (flat ctx) and class labels."""
    from test_torch_train import _close_grads, _j, _port_grads, _setup, _t

    t = 1280
    kw, jm, params, tm, codes, vid, labels = _setup("float32", t, True, 3,
                                                    maf=t)
    monkeypatch.setattr(jsk, "pick_stack_tile", _no_tile)
    monkeypatch.setattr(fused, "pick_stack_tile", _no_tile)
    calls = []
    real = fused.fused_gated_block
    monkeypatch.setattr(fused, "fused_gated_block",
                        lambda *a: (calls.append(a[-1]), real(*a))[1])

    def jloss(p):
        return jfused.fused_train_loss(jm, p, _j(codes), _j(vid),
                                       _j(labels), interpret=True)

    (want_l, want_a), want_g = jax.value_and_grad(jloss, has_aux=True)(
        params)
    loss, acc = fused.fused_train_loss(tm, _t(codes), _t(vid),
                                       _t(labels, True))
    loss.backward()
    assert calls == list(tm.dilations)
    np.testing.assert_allclose(float(loss.detach()), float(want_l),
                               rtol=1e-5)
    n_valid = 2 * (t - tm.receptive_fields)
    assert abs(float(acc) - float(want_a)) <= 1.0 / n_valid + 1e-7
    _close_grads(_port_grads(tm), flatten_tree(want_g), 1e-2, 2e-4)
