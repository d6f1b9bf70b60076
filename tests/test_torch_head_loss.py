"""The port's head + cross-entropy op (ops/head_loss.fused_head_loss) on
the CPU, where it runs its plain versions, against the JAX package's
Pallas op in interpret mode: loss sum, match count and every gradient,
parity and clean CE, float32 and bfloat16, with the targets riding the
packed codes array (tgt_off = 2B).

Tolerances: float32 loss rtol 1e-5, gradients within 1% of each leaf's
largest magnitude plus the mean-difference gate of
tests/test_fused_model.py; bfloat16 loss rtol 1e-4 and gradients within
2% (the frameworks round equal float32 sums that were added in different
orders to different bf16 neighbours); the match count equal or off by at
most one flipped position.

The packed route (both packages' ``PACKED_HEAD`` switched on, S = C = 64,
targets exactly B wide at tgt_off 0) is held to the same tolerances,
with the match count equal: both packages compute it from float32
operands; the loss differs only by JAX's sum over group-replicated
values times 1/64.  The head at C = 128 and C = 256 is held to the
unpacked tolerances.  A CPU model of the packed kernels' split-TF32
products (``tf32_split_matmul`` at ``PACKED_SPLIT_PASSES``) is held to
the plain packed functions at the cuda tests' tolerances."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from movenet_tpu.ops.pallas import head_loss as jhl

from movenet_tpu_torch.ops import head_loss as hl

torch.set_num_threads(2)
B, T, S, C, RF = 2, 1024, 16, 64, 15


def _inputs(seed=0, s=S, c=C, t=T):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, c, size=(B, t)).astype(np.int32)
    prev = np.concatenate([np.full((B, 1), -1, np.int32), codes[:, :-1]], 1)
    pack = np.ascontiguousarray(
        np.concatenate([codes, prev, np.roll(codes, -1, 1)], 0).T)
    f = np.float32
    return pack, dict(
        skip=rng.standard_normal((B, t, s)).astype(f),
        w1=(rng.standard_normal((s, c)) / 4).astype(f),
        b1=(rng.standard_normal((c,)) * 0.1).astype(f),
        w2=(rng.standard_normal((c, c)) / 3 * (8 / np.sqrt(c))).astype(f),
        b2=(rng.standard_normal((c,)) * 0.1).astype(f))


def _compare(pack, a, parity, dtype, tgt_off, match_equal=False):
    """fused_head_loss of both packages on the same inputs: loss, match
    and the five gradients at the module docstring's tolerances."""
    t = a["skip"].shape[1]
    n_valid = B * (t - RF)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    names = ("skip", "w1", "b1", "w2", "b2")

    def jloss(skip, w1, b1, w2, b2):
        loss, match = jhl.fused_head_loss(skip, jnp.asarray(pack), w1, b1,
                                          w2, b2, RF, parity, True, tgt_off)
        return loss / n_valid, match

    jargs = [jnp.asarray(a[n], jdt if n == "skip" else jnp.float32)
             for n in names]
    (want_l, want_m), want_g = jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True)(*jargs)
    ts = {n: torch.tensor(a[n], dtype=tdt if n == "skip" else torch.float32,
                          requires_grad=True) for n in names}
    loss, match = hl.fused_head_loss(ts["skip"], torch.from_numpy(pack),
                                     ts["w1"], ts["b1"], ts["w2"], ts["b2"],
                                     RF, parity, tgt_off=tgt_off)
    (loss / n_valid).backward()
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(loss.detach()) / n_valid, float(want_l),
                               rtol=1e-5 if f32 else 1e-4)
    if match_equal:
        assert float(match) == float(want_m)
    else:
        assert abs(float(match) - float(want_m)) <= 1
    for n, want in zip(names, want_g):
        got = ts[n].grad.float().numpy()
        want = np.asarray(want, np.float32)
        scale = float(np.max(np.abs(want))) + 1e-12
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=(1e-2 if f32 else 2e-2) * scale,
                                   err_msg=n)
        bias = abs(float(np.mean(got - want)))
        assert bias <= (2e-4 if f32 else 2e-3) * scale + 1e-10, n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("parity", [True, False])
def test_packed_head_matches_jax(parity, dtype, monkeypatch):
    """PACKED_HEAD on in both packages: JAX's _fwd_kernel_packed /
    _bwd_kernel_packed (interpret mode) against the port's packed route."""
    monkeypatch.setattr(jhl, "PACKED_HEAD", True)
    monkeypatch.setattr(hl, "PACKED_HEAD", True)
    pack3, a = _inputs(3, s=64, c=64, t=512)
    tgt = np.ascontiguousarray(pack3[:, 2 * B:])      # exactly B wide
    assert jhl._use_packed(512, 64, 64) and hl._use_packed(512, 64, 64)
    seen = []
    from movenet_tpu_torch.ops.cuda import head_loss as kern

    for name in ("head_fwd", "head_fwd_packed", "head_bwd_packed"):
        real = getattr(kern, name)
        monkeypatch.setattr(kern, name, lambda *x, _r=real, _n=name, **k: (
            seen.append(_n), _r(*x, **k))[1])
    _compare(tgt, a, parity, dtype, 0, match_equal=True)
    assert seen == ["head_fwd_packed", "head_bwd_packed"]


def _tie_margin() -> float:
    """The packed kernels' ``kTieMargin`` (csrc/head_loss.cu)."""
    import re

    from movenet_tpu_torch.ops.cuda import build

    text = (build.CSRC / "head_loss.cu").read_text()
    return 1 / float(re.search(
        r"constexpr float kTieMargin = 1\.f / (\d+)\.f;", text).group(1))


def _packed_model(skip, tgt, w1, b1, w2, b2, rf, parity, dloss):
    """The packed kernels' arithmetic (csrc/head_loss.cu) on the CPU: the
    plain packed functions with each product replaced by
    ``tf32_split_matmul`` at ``PACKED_SPLIT_PASSES``, and, as there, y
    near zero and the argmax of near-tied rows taken from the plain
    version's float32 order (``kTieMargin``).  Returns ((loss, match),
    (dskip, dw1, db1, dw2, db2))."""
    from movenet_tpu_torch.ops import stack_kernel as sk

    def mm(name, a, b):
        return sk.tf32_split_matmul(a, b, *hl.PACKED_SPLIT_PASSES[name])

    batch, t, s = skip.shape
    c = w2.shape[1]
    margin = _tie_margin()
    lsk = hl._leaky(skip.float()).reshape(-1, s)     # rows b T + t
    tg = tgt.t().reshape(-1).long()
    valid = hl._valid(t, rf, skip.device).repeat(batch)
    y_plain = torch.matmul(lsk, w1) + b1
    y = mm("y", lsk, w1) + b1
    near = y.abs() <= margin * (1 + y.abs().max(dim=-1, keepdim=True).values)
    y = torch.where(near, y_plain, y)
    ly = hl._leaky(y)
    z = mm("z", ly, w2) + b2
    onehot = torch.nn.functional.one_hot(tg, c).float()
    zmax = z.max(dim=-1, keepdim=True).values
    e = torch.exp(z - zmax)
    p = e / e.sum(dim=-1, keepdim=True)
    loss = (hl._nll_rows(z, p, onehot, parity, zmax) * valid).sum()
    top = z.topk(2, dim=-1).values
    tie = top[:, 0] - top[:, 1] <= margin * (1 + top[:, 0].abs())
    z_plain = torch.matmul(hl._leaky(y_plain), w2) + b2
    match = torch.where(
        tie, hl._match_rows(z_plain, tg,
                            z_plain.max(dim=-1, keepdim=True).values),
        hl._match_rows(z, tg, zmax))
    match = (match * valid).sum()
    scale = dloss * valid[:, None]
    if parity:
        ep = torch.exp(p)
        g = ep / ep.sum(dim=-1, keepdim=True) - onehot
        dz = (p * g - p * (p * g).sum(dim=-1, keepdim=True)) * scale
    else:
        dz = (p - onehot) * scale
    dy = mm("dy", dz, w2.t()) * hl._dleaky(y)
    dskip = mm("dskip", dy, w1.t()) * hl._dleaky(lsk)
    grads = (dskip.to(skip.dtype).reshape(skip.shape),
             mm("dw1", lsk.t(), dy), dy.sum(dim=0),
             mm("dw2", ly.t(), dz), dz.sum(dim=0))
    return (loss, match), grads


@pytest.mark.parametrize("t", [4000, 1282])
@pytest.mark.parametrize("parity", [True, False])
def test_packed_kernel_model_matches_plain(t, parity):
    """The split-TF32 model of the packed kernels against
    head_fwd_packed_plain / head_bwd_packed_plain at the tolerances the
    cuda tests hold the kernels to: loss rtol 1e-5, match within one
    position, gradients within 1e-4 of their scale, dskip (bf16) 1e-2."""
    rng = np.random.default_rng(t)
    rf, f = 24, np.float32
    codes = rng.integers(0, 64, size=(B, t)).astype(np.int32)
    tgt = torch.from_numpy(np.ascontiguousarray(np.roll(codes, -1, 1).T))
    skip = torch.from_numpy(rng.standard_normal((B, t, 64)).astype(f)).to(
        torch.bfloat16)
    w = [torch.from_numpy(x.astype(f)) for x in (
        rng.standard_normal((64, 64)) / 4, rng.standard_normal(64) * 0.1,
        rng.standard_normal((64, 64)) / 3, rng.standard_normal(64) * 0.1)]
    dloss = torch.tensor(1.0 / (B * (t - rf)))
    (loss, match), got = _packed_model(skip, tgt, *w, rf, parity, dloss)
    wl, wm = hl.head_fwd_packed_plain(skip, tgt, *w, rf, parity)
    np.testing.assert_allclose(float(loss), float(wl), rtol=1e-5)
    assert abs(float(match) - float(wm)) <= 1
    want = hl.head_bwd_packed_plain(skip, tgt, *w, rf, parity, dloss)
    for name, x, y in zip(("dskip", "dw1", "db1", "dw2", "db2"), got, want):
        x, y = x.float().numpy(), y.float().numpy()
        tol = (1e-2 if name == "dskip" else 1e-4) * np.abs(y).max()
        np.testing.assert_allclose(x, y, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("t,s,c", [(512, 64, 64), (1024, 64, 64),
                                   (1000, 64, 64), (510, 64, 64),
                                   (512, 16, 64), (512, 64, 128),
                                   (7, 64, 64)])
def test_use_packed_decides_as_jax(t, s, c, monkeypatch):
    for on in (False, True):
        monkeypatch.setattr(jhl, "PACKED_HEAD", on)
        monkeypatch.setattr(hl, "PACKED_HEAD", on)
        assert hl._use_packed(t, s, c) == jhl._use_packed(t, s, c)
    # the route also needs tgt_off 0 and targets exactly B wide
    monkeypatch.setattr(hl, "PACKED_HEAD", True)
    skip = torch.zeros(2, t, s)
    w2 = torch.zeros(c, c)
    want = jhl._use_packed(t, s, c)
    assert hl.packed_route(skip, torch.zeros(t, 2), w2, 0) == want
    assert not hl.packed_route(skip, torch.zeros(t, 6), w2, 4)
    assert not hl.packed_route(skip, torch.zeros(t, 3), w2, 0)


@pytest.mark.parametrize("s,c,t", [(8, 128, 512), (16, 256, 256),
                                   (64, 256, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_head_matches_jax(s, c, t, dtype):
    """The head at experiment 03/04's C = 128 (S = 8) and at C = 256 with
    S = 16 and with the flagship's S = 64, unpacked, targets in the codes
    pack."""
    pack, a = _inputs(4, s=s, c=c, t=t)
    _compare(pack, a, True, dtype, 2 * B)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("parity", [True, False])
def test_fused_head_loss_matches_jax(parity, dtype):
    pack, a = _inputs()
    n_valid = B * (T - RF)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    names = ("skip", "w1", "b1", "w2", "b2")

    def jloss(skip, w1, b1, w2, b2):
        loss, match = jhl.fused_head_loss(skip, jnp.asarray(pack), w1, b1,
                                          w2, b2, RF, parity, True, 2 * B)
        return loss / n_valid, match

    jargs = [jnp.asarray(a[n], jdt if n == "skip" else jnp.float32)
             for n in names]
    (want_l, want_m), want_g = jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True)(*jargs)

    ts = {n: torch.tensor(a[n], dtype=tdt if n == "skip" else torch.float32,
                          requires_grad=True) for n in names}
    loss, match = hl.fused_head_loss(ts["skip"], torch.from_numpy(pack),
                                     ts["w1"], ts["b1"], ts["w2"], ts["b2"],
                                     RF, parity, tgt_off=2 * B)
    (loss / n_valid).backward()
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(loss.detach()) / n_valid, float(want_l),
                               rtol=1e-5 if f32 else 1e-4)
    assert abs(float(match) - float(want_m)) <= 1
    for n, want in zip(names, want_g):
        got = ts[n].grad.float().numpy()
        want = np.asarray(want, np.float32)
        scale = float(np.max(np.abs(want))) + 1e-12
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=(1e-2 if f32 else 2e-2) * scale,
                                   err_msg=n)
        bias = abs(float(np.mean(got - want)))
        assert bias <= (2e-4 if f32 else 2e-3) * scale + 1e-10, n


def test_eval_call_saves_no_softmax(monkeypatch):
    """Without autograd the forward runs with save_p=False."""
    from movenet_tpu_torch.ops.cuda import head_loss as kern

    pack, a = _inputs(1)
    seen = []
    real = kern.head_fwd

    def spy(*args, save_p=True, **kw):
        seen.append(save_p)
        return real(*args, save_p=save_p, **kw)

    monkeypatch.setattr(kern, "head_fwd", spy)
    ts = {n: torch.tensor(v) for n, v in a.items()}
    with torch.no_grad():
        loss, match = hl.fused_head_loss(
            ts["skip"], torch.from_numpy(pack), ts["w1"], ts["b1"],
            ts["w2"], ts["b2"], RF, True, tgt_off=2 * B)
    assert seen == [False]
    want, want_m, p = hl.head_fwd_plain(
        ts["skip"], torch.from_numpy(pack), ts["w1"], ts["b1"], ts["w2"],
        ts["b2"], RF, True, 2 * B)
    assert float(loss) == float(want) and float(match) == float(want_m)
    assert p.shape == (B, T, C)


def test_match_is_first_argmax():
    z = torch.tensor([[1.0, 3.0, 3.0, 0.0]])
    zmax = z.max(dim=-1, keepdim=True).values
    assert hl._match_rows(z, torch.tensor([1]), zmax).item() == 1.0
    assert hl._match_rows(z, torch.tensor([2]), zmax).item() == 0.0


def test_time_head_variant_edits_apply():
    """Each diagnostic edit of ``utils/time_head.py`` still finds its text
    in ``csrc/head_loss.cu`` (an edit that no longer applies would stop
    the timer on the card)."""
    from movenet_tpu_torch.ops.cuda import build
    from movenet_tpu_torch.utils.time_head import VARIANTS

    text = (build.CSRC / "head_loss.cu").read_text()
    for name, edits in VARIANTS.items():
        for old, _ in edits:
            assert old in text, name


def test_time_head_packed_flag_and_variant_edits_apply(monkeypatch):
    """``time_head --packed`` parses its flags (here it stops only for
    want of a card), and each edit of its PACKED_VARIANTS finds its text
    exactly once in ``csrc/head_loss.cu``."""
    from movenet_tpu_torch.ops.cuda import build
    from movenet_tpu_torch.utils import time_head

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        time_head.main(["--packed", "--parent", "build/parent",
                        "--variants", "--repeats", "3"])
    text = (build.CSRC / "head_loss.cu").read_text()
    for name, edits in time_head.PACKED_VARIANTS.items():
        for old, _ in edits:
            assert text.count(old) == 1, name


@pytest.mark.parametrize("name", ["y", "z"])
def test_tie_margin_covers_the_split_error(name):
    """The packed kernels' ``kTieMargin`` (csrc/head_loss.cu) is at least
    16 times the largest gap, over (1 + the row's largest magnitude),
    between y (z) from the split-TF32 products and the plain version's
    float32 y (z) on 32,000 rows at the packed head's widths: outside the
    margin the sign of y and the argmax of z are the plain version's."""
    from movenet_tpu_torch.ops import stack_kernel as sk

    rng = np.random.default_rng(5)
    f = np.float32
    skip = torch.from_numpy(rng.standard_normal((32000, 64)).astype(f)).to(
        torch.bfloat16).float()
    w1, w2 = (torch.from_numpy((rng.standard_normal((64, 64)) / d)
                               .astype(f)) for d in (4, 3))
    b1, b2 = (torch.from_numpy((rng.standard_normal(64) * 0.1).astype(f))
              for _ in range(2))
    passes = hl.PACKED_SPLIT_PASSES
    y = sk.tf32_split_matmul(hl._leaky(skip), w1, *passes["y"]) + b1
    z = sk.tf32_split_matmul(hl._leaky(y), w2, *passes["z"]) + b2
    y_plain = torch.matmul(hl._leaky(skip), w1) + b1
    got, want = {"y": (y, y_plain), "z": (
        z, torch.matmul(hl._leaky(y_plain), w2) + b2)}[name]
    top = want.abs().max(dim=-1).values
    gap = float(((got - want).abs().max(dim=-1).values / (1 + top)).max())
    assert 16 * gap <= _tie_margin(), gap
