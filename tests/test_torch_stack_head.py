"""The port's merged trunk + head/CE op and the non-embed save form of the
trunk on the CPU, where they run their plain versions, against the JAX
package's Pallas kernels in interpret mode (layer 3 x stack 2, R=S=16,
C=64, B=2):

- ``fused_stack_head_loss`` (the loss, the match count, the saved skip,
  hsave and tfsg, and every gradient), with and without ctx;
- ``fused_train_loss(merge_head=True)`` with video and labels, and audio
  only with the clean CE, by flax parameter name;
- ``fused_stack(strategy="save")``, the non-embed save form (B.2(a)),
  without ctx, with the flat ctx and with the projection triple;
- the build's target name, which covers the shared headers.

Tolerances: float32 losses rtol 1e-6, match counts within one position; gradients within 1% of each leaf's scale plus the
mean-difference gate at 2e-4, as tests/test_fused_model.py holds the two
JAX paths.  bfloat16: the frameworks round the same sums in different
orders, so a stored bf16 value may sit one step apart: forward outputs
within 2% of their scale, loss rtol 1e-4, gradients within 10% of the
leaf scale with the mean gate at 0.5% (the bars of
tests/test_torch_stack_kernel.py and tests/test_torch_train.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from movenet_tpu.models import fused as jfused
from movenet_tpu.ops.pallas import stack_kernel as jsk

from movenet_tpu_torch.models import fused
from movenet_tpu_torch.models.convert import flatten_tree
from movenet_tpu_torch.ops import stack_kernel as sk
from movenet_tpu_torch.ops.cuda import build

torch.set_num_threads(2)
B, R, S, C = 2, 16, 16, 64
DIL = (1, 2, 4) * 2
L = len(DIL)
RF = 15


def _inputs(t, ctx_kind, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    win = (3 if ctx_kind else 2) * R
    codes = rng.integers(0, C, size=(B, t)).astype(np.int32)
    a = dict(
        x=(rng.standard_normal((B, t, R)) * 0.5).astype(f),
        b_fg=(rng.standard_normal((L * B, 2 * R)) * 0.1).astype(f),
        w_fg=(rng.standard_normal((L, win, 2 * R)) / np.sqrt(win)).astype(f),
        w_out=(rng.standard_normal((L, R, R + S)) / np.sqrt(R)).astype(f),
        b_out=(rng.standard_normal((L, R + S)) * 0.1).astype(f),
        w1=(rng.standard_normal((S, C)) / 4).astype(f),
        b1=(rng.standard_normal((C,)) * 0.1).astype(f),
        w2=(rng.standard_normal((C, C)) / 8).astype(f),
        b2=(rng.standard_normal((C,)) * 0.1).astype(f),
        dskip=(rng.standard_normal((B, t, S)) * 0.1).astype(f))
    if ctx_kind == "flat":
        a["ctx"] = (rng.standard_normal((B, t, R)) * 0.5).astype(f)
    elif ctx_kind == "proj":
        a["xc"] = (rng.standard_normal((B, t // 10, R)) * 0.5).astype(f)
        a["wup"] = (rng.standard_normal((R, 10 * R)) / 4).astype(f)
        a["bup"] = (rng.standard_normal((10 * R,)) * 0.1).astype(f)
    return np.ascontiguousarray(np.roll(codes, -1, 1).T), a


def _close(name, got, want, rel, bias_rel):
    scale = float(np.max(np.abs(want))) + 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=name)
    bias = abs(float(np.mean(got - want)))
    assert bias <= bias_rel * scale + 1e-10, \
        f"{name}: systematic difference {bias:.3e} vs scale {scale:.3e}"


HEAD_ARGS = ["x", "ctx", "b_fg", "w_fg", "w_out", "b_out", "w1", "b1", "w2",
             "b2"]


@pytest.mark.parametrize("ctx_kind,dtype,parity", [
    (None, "float32", True), ("flat", "float32", False),
    ("flat", "bfloat16", True)])
def test_fused_stack_head_loss_matches_jax(ctx_kind, dtype, parity):
    t = 1024
    tgt, a = _inputs(t, ctx_kind)
    names = [n for n in HEAD_ARGS if n in a]
    cast = {"x", "ctx"}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jargs = [jnp.asarray(a[n], jdt if n in cast else jnp.float32)
             for n in names]
    jt = jnp.asarray(tgt)

    def jop(*xs):
        k = dict(zip(names, xs))
        return jsk.fused_stack_head_loss(
            k["x"], k.get("ctx"), k["b_fg"], k["w_fg"], k["w_out"],
            k["b_out"], jt, k["w1"], k["b1"], k["w2"], k["b2"], DIL, RF,
            parity, True)

    want_l, want_m = jop(*jargs)
    want_g = jax.grad(lambda *xs: jop(*xs)[0],
                      argnums=tuple(range(len(names))))(*jargs)
    jd = dict(zip(names, jargs))
    _, _, want_skip, want_hsave, want_tfsg, _ = jsk._fwd_pallas_head(
        jd["x"], jd.get("ctx"), jd["b_fg"], jd["w_fg"], jd["w_out"],
        jd["b_out"], jt, jd["w1"], jd["b1"], jd["w2"], jd["b2"], DIL, RF,
        parity, True)

    ts = {n: torch.tensor(a[n], dtype=tdt if n in cast else torch.float32,
                          requires_grad=True) for n in names}
    tt = torch.from_numpy(tgt)
    loss, match = sk.fused_stack_head_loss(
        ts["x"], ts.get("ctx"), ts["b_fg"], ts["w_fg"], ts["w_out"],
        ts["b_out"], tt, ts["w1"], ts["b1"], ts["w2"], ts["b2"], DIL, RF,
        parity)
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(loss.detach()), float(want_l),
                               rtol=1e-6 if f32 else 1e-4)
    assert abs(float(match) - float(want_m)) <= 1
    with torch.no_grad():
        _, _, skip, hsave, tfsg = sk.stack_head_fwd_plain(
            ts["x"], ts.get("ctx"), ts["b_fg"], ts["w_fg"], ts["w_out"],
            ts["b_out"], tt, ts["w1"], ts["b1"], ts["w2"], ts["b2"], DIL, RF,
            parity)
    for got, want in ((skip, want_skip), (hsave, want_hsave),
                      (tfsg, want_tfsg)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=(1e-5 if f32 else 2e-2)
                                   * np.abs(want).max())
    loss.backward()
    for n, want in zip(names, want_g):
        got = ts[n].grad
        assert got.dtype == ts[n].dtype, n
        if f32:
            _close(n, got.numpy(), np.asarray(want), 1e-2, 2e-4)
        else:
            _close(n, got.float().numpy(), np.asarray(want, np.float32),
                   1e-1, 5e-3)


@pytest.mark.parametrize("dtype,t,video,parity", [
    ("float32", 12800, True, True),       # projection triple -> flat ctx
    ("bfloat16", 12800, True, True),
    ("float32", 1024, False, False),      # audio only, clean CE
])
def test_merged_train_loss_matches_jax(dtype, t, video, parity,
                                       monkeypatch):
    """fused_train_loss(merge_head=True) against JAX's, which takes
    ``_merged_loss`` at these shapes: the loss, the accuracy and every
    parameter gradient by flax name; the merged op runs, the split
    pipeline's ops do not."""
    from test_torch_train import _close_grads, _j, _port_grads, _setup, _t

    kw, jm, params, tm, codes, vid, labels = _setup(dtype, t, video, 3)
    calls = []
    for name in ("stack_head_fwd_plain", "stack_fwd_plain"):
        fn = getattr(sk, name)
        monkeypatch.setattr(sk, name, lambda *a, _f=fn, _n=name: (
            calls.append(_n), _f(*a))[1])

    def jloss(p):
        return jfused.fused_train_loss(jm, p, _j(codes), _j(vid),
                                       _j(labels), parity=parity,
                                       interpret=True, merge_head=True)

    (want_l, want_a), want_g = jax.value_and_grad(jloss, has_aux=True)(
        params)
    loss, acc = fused.fused_train_loss(tm, _t(codes), _t(vid),
                                       _t(labels, True), parity=parity,
                                       merge_head=True)
    loss.backward()
    assert calls == ["stack_head_fwd_plain"]
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(loss.detach()), float(want_l),
                               rtol=1e-6 if f32 else 1e-4)
    n_valid = 2 * (t - tm.receptive_fields)
    assert abs(float(acc) - float(want_a)) <= 1.0 / n_valid + 1e-7
    _close_grads(_port_grads(tm), flatten_tree(want_g),
                 1e-2 if f32 else 1e-1, 2e-4 if f32 else 5e-3)


def test_merged_route_falls_back_like_jax():
    """Where JAX's ``_merged_loss`` returns None (a strategy that is not
    "save"), merge_head=True takes the split pipeline in the port too."""
    from test_torch_train import _setup, _t

    _, _, _, tm, codes, _, _ = _setup("float32", 1024, False, 0)
    tm.fused_strategy = "recompute"
    assert fused._merged_inputs(tm, _t(codes), None, None) is None
    with torch.no_grad():
        got = fused.fused_train_loss(tm, _t(codes), merge_head=True)
        want = fused.fused_train_loss(tm, _t(codes))
    assert float(got[0]) == float(want[0])


@pytest.mark.parametrize("ctx_kind,dtype", [
    (None, "float32"), ("flat", "float32"), ("proj", "float32"),
    ("proj", "bfloat16")])
def test_fused_stack_save_matches_jax(ctx_kind, dtype):
    """fused_stack(strategy="save"): h in, dx out (B.2(a)).  The triple
    needs a tile that is a multiple of 80 (T=12800: 1600)."""
    t = 12800 if ctx_kind == "proj" else 1280
    _, a = _inputs(t, ctx_kind)
    names = ["x"] + [n for n in ("ctx", "xc", "wup", "bup") if n in a] + \
        ["b_fg", "w_fg", "w_out", "b_out"]
    cast = {"x", "ctx", "xc"}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def ctx_of(k):
        if "xc" in k:
            return (k["xc"], k["wup"], k["bup"])
        return k.get("ctx")

    def jop(*xs):
        k = dict(zip(names, xs))
        return jsk.fused_stack(k["x"], ctx_of(k), k["b_fg"], k["w_fg"],
                               k["w_out"], k["b_out"], DIL, True, "save")

    jargs = [jnp.asarray(a[n], jdt if n in cast else jnp.float32)
             for n in names]
    want_skip, vjp = jax.vjp(jop, *jargs)
    want_g = vjp(jnp.asarray(a["dskip"], jdt))
    ts = {n: torch.tensor(a[n], dtype=tdt if n in cast else torch.float32,
                          requires_grad=True) for n in names}
    skip = sk.fused_stack(ts["x"], ctx_of(ts), ts["b_fg"], ts["w_fg"],
                          ts["w_out"], ts["b_out"], DIL, strategy="save")
    skip.backward(torch.tensor(a["dskip"], dtype=tdt))
    f32 = dtype == "float32"
    want_skip = np.asarray(want_skip, np.float32)
    np.testing.assert_allclose(skip.detach().float().numpy(), want_skip,
                               rtol=0, atol=(1e-5 if f32 else 2e-2)
                               * np.abs(want_skip).max())
    for n, want in zip(names, want_g):
        got = ts[n].grad
        assert got.dtype == ts[n].dtype, n
        if f32:
            _close(n, got.numpy(), np.asarray(want), 1e-2, 2e-4)
        else:
            _close(n, got.float().numpy(), np.asarray(want, np.float32),
                   5e-2, 5e-3)


def test_build_target_covers_headers(tmp_path, monkeypatch):
    """A library is named by the hash of its source, the flags and every
    shared header: an edited header must not load a stale library."""
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setenv("MOVENET_TORCH_BUILD_DIR", str(tmp_path / "out"))
    first = build._target(src)
    assert first == build._target(src)
    (tmp_path / "h.cuh").write_text("// two\n")
    assert build._target(src) != first
    assert sorted(build.sources()) == ["k"]
