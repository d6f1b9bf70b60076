"""The float32 forms of the save and recompute trunk and unpacked head
kernels (csrc/stack_kernel.cu ``stack_layer_f32_kernel`` and the
backward's float32 forms, csrc/head_loss.cu ``head_fwd_f32_kernel`` /
``head_bwd_f32_kernel`` and, above C = 128, their wide forms) on the CPU,
where no card runs them: their product scheme, their shared memory and
their refusals.

* The split product with both operands float32.  Each of the kernels'
  products (``ops/stack_kernel.F32_SPLIT_PASSES``) emulated with
  ``tf32_split_matmul``, both operands split, lies within 1e-5 of its
  scale of the float64 product; one-pass TF32, and the bf16 forms'
  shortcut of leaving the activation unsplit (exact only for bf16
  values), miss that bar, which is why the float32 forms split both.
* The emulated float32 trunk (``stack_fwd_f32_split`` /
  ``stack_bwd_f32_split``: split-TF32 products layer by layer) against the
  JAX package's ``fused_stack_embed`` in float32 (the Pallas kernels in
  interpret mode) at R = S = 16, T = 1280 without ctx and 1600 with the
  projection triple: skip, hsave and tfsg within 1e-5 of each output's
  scale, every gradient within 1e-4 of its scale, the bars chip_smoke.py
  holds the kernels to on the card.
* The emulated float32 recompute trunk (``stack_fwd_tails_f32_split`` /
  ``stack_bwd_tails_f32_split``: the rebuilt layers and every product
  split-TF32) against JAX's ``fused_stack(..., strategy="recompute")`` in
  float32 (its tails kernels in interpret mode) at R = S = 16, T = 512
  with ``DIL`` and T = 1280 with ``DIL_WIDE`` (sum(d) = 510), with and
  without ctx: skip within 1e-5 of its scale, every gradient within 1e-4.
* The emulated float32 head (``head_fwd_plain`` / ``head_bwd_plain`` with
  ``split_matmul``) against JAX's ``fused_head_loss`` in float32 at (S,
  C) = (8, 64), (8, 128), (8, 256) and (64, 256), parity on and off: loss
  rtol 1e-5, the match count equal, every gradient within 1e-4 of its
  scale.
* The byte counts (``f32_smem``): every built (R, S) pair's float32 save
  and recompute launches and every float32 head at S <= 64, C <= 256 fit
  a block's 232,448 bytes; the float32 head at C = 260 or S = 132 is
  refused with the B.4 label; mixed activation dtypes are refused, naming the tensors; the
  float32 recompute, non-embed save and replay forms are taken where the
  merged forms still refuse float32.
* The float32 non-embed save and replay forms on the CPU run their plain
  versions and count no launch; the replay forward's checkpoints are the
  float32 save forward's layer inputs, its rebuild of every layer input
  from them (``replay_rebuild``) the same bits, in float32 as in bf16.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from movenet_tpu.ops.pallas import head_loss as jhl
from movenet_tpu.ops.pallas import stack_kernel as jsk

from movenet_tpu_torch.ops import head_loss as hl
from movenet_tpu_torch.ops import stack_kernel as sk
from movenet_tpu_torch.ops.cuda import head_loss as kh
from movenet_tpu_torch.ops.cuda import stack_kernel as ks

torch.set_num_threads(2)
B, R, S, V = 2, 16, 16, 64
DIL = (1, 2, 4, 1, 2, 4)
L = len(DIL)
# layer 8 x stack 2: sum(d) = 510; JAX's recompute tile at T = 1280 is 256
DIL_WIDE = tuple(2 ** i for i in range(8)) * 2
ROWS = 4096


def _f32(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _operands(seed=0, r=64, s=64):
    """(A, B) of each product of the float32 kernels at the breakdancing
    widths: float32 activations (not bf16 values), weights and
    gradients."""
    rng = np.random.default_rng(seed)
    win = 3 * r
    hp = _f32(rng.normal(0, 0.5, (ROWS, win)))
    w_fg = _f32(rng.normal(0, win ** -0.5, (win, 2 * r)))
    w_out = _f32(rng.normal(0, r ** -0.5, (r, r + s)))
    fg = torch.matmul(hp, w_fg)
    gated = torch.tanh(fg[:, :r]) * torch.sigmoid(fg[:, r:])
    dout = _f32(rng.normal(0, 1e-3, (ROWS, r + s)))
    dfg = _f32(rng.normal(0, 1e-3, (ROWS, 2 * r)))
    xc = _f32(rng.normal(0, 0.5, (ROWS // 10, r)))
    dctx = _f32(rng.normal(0, 1e-3, (ROWS // 10, 10 * r)))
    return {"fg": (hp, w_fg), "out": (gated, w_out),
            "dgated": (dout, w_out.t()), "dfg_w": (dfg, w_fg.t()),
            "dw_fg": (hp.t(), dfg), "dw_out": (gated.t(), dout),
            "dw_up": (xc.t(), dctx)}


def _rel_err(got, a, b):
    want = torch.matmul(a.double(), b.double())
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("name", sorted(sk.F32_SPLIT_PASSES))
def test_f32_split_products_hold_1e5(name):
    a, b = _operands()[name]
    assert sk.F32_SPLIT_PASSES[name] == (True, True)
    assert _rel_err(sk.split_matmul(a, b), a, b) <= 1e-5


@pytest.mark.parametrize("name", sorted(sk.F32_SPLIT_PASSES))
def test_one_pass_and_unsplit_activation_miss_1e5(name):
    """One-pass TF32 misses the bar on every product; so does leaving the
    activation operand unsplit, the bf16 forms' shortcut (A of every
    product but the two whose A is a gradient, dgated and dfg_w)."""
    a, b = _operands()[name]
    assert _rel_err(sk.tf32_split_matmul(a, b, False, False), a, b) > 1e-5
    if name not in ("dgated", "dfg_w"):
        assert _rel_err(sk.tf32_split_matmul(a, b, False, True), a, b) > 1e-5


# ------------------------------------------------ the trunk against JAX
def _trunk_inputs(t, proj, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, V, size=(B, t)).astype(np.int32)
    prev = np.concatenate([np.full((B, 1), -1, np.int32), codes[:, :-1]], 1)
    pack = np.ascontiguousarray(
        np.concatenate([codes, prev, np.roll(codes, -1, 1)], 0).T)
    f = np.float32
    win = (3 if proj else 2) * R
    a = dict(
        table2=(rng.standard_normal((2 * V, R)) * 0.5).astype(f),
        b_fg=(rng.standard_normal((L * B, 2 * R)) * 0.1).astype(f),
        w_fg=(rng.standard_normal((L, win, 2 * R)) / np.sqrt(win)).astype(f),
        w_out=(rng.standard_normal((L, R, R + S)) / np.sqrt(R)).astype(f),
        b_out=(rng.standard_normal((L, R + S)) * 0.1).astype(f),
        dskip=(rng.standard_normal((B, t, S)) * 0.1).astype(f))
    if proj:
        a["xc"] = (rng.standard_normal((B, t // 10, R)) * 0.5).astype(f)
        a["wup"] = (rng.standard_normal((R, 10 * R)) / 4).astype(f)
        a["bup"] = (rng.standard_normal((10 * R,)) * 0.1).astype(f)
    return pack, a


def _trunk_jax(pack, a):
    """JAX's fused_stack_embed in float32 (interpret mode): skip, the
    gradients by input name, and the saved hsave and tfsg."""
    names = ["table2"] + [k for k in ("xc", "wup", "bup") if k in a] \
        + ["b_fg", "w_fg", "w_out", "b_out"]
    args = [jnp.asarray(a[n]) for n in names]
    pack_j = jnp.asarray(pack)

    def op(*xs):
        d = dict(zip(names, xs))
        ctx = (d["xc"], d["wup"], d["bup"]) if "xc" in d else None
        return jsk.fused_stack_embed(pack_j, d["table2"], ctx, d["b_fg"],
                                     d["w_fg"], d["w_out"], d["b_out"], DIL,
                                     jnp.float32, True)

    skip, vjp = jax.vjp(op, *args)
    grads = vjp(jnp.asarray(a["dskip"]))
    ctx = jsk.ctx_flatten(tuple(args[1:4]), jnp.float32) if "xc" in a \
        else None
    _, hsave, tfsg, _ = jsk._fwd_pallas(
        None, ctx, args[-4], args[-3], args[-2], args[-1], DIL, True,
        embed=(pack_j, args[0], B), dtype=jnp.float32)
    return (np.asarray(skip), {n: np.asarray(g) for n, g in
                               zip(names, grads)},
            (np.asarray(hsave), np.asarray(tfsg)))


def _close(name, got, want, bar):
    got = np.asarray(got, np.float32)
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=0, atol=bar * scale,
                               err_msg=name)


@pytest.mark.parametrize("proj,t", [(False, 1280), (True, 1600)])
def test_f32_trunk_emulation_matches_jax(proj, t):
    """T = 1600 with the triple: JAX's projection backward needs a time
    tile that is a multiple of 10, which T = 1280 does not give it."""
    pack, a = _trunk_inputs(t, proj)
    want_skip, want_g, (want_h, want_tf) = _trunk_jax(pack, a)
    ts = {n: torch.from_numpy(v) for n, v in a.items()}
    tpack = torch.from_numpy(pack)
    trip = (ts["xc"], ts["wup"], ts["bup"]) if proj else None
    ctx = sk.ctx_flatten(trip, torch.float32) if proj else None
    skip, hsave, tfsg = sk.stack_fwd_f32_split(
        tpack, ts["table2"], ctx, ts["b_fg"], ts["w_fg"], ts["w_out"],
        ts["b_out"], DIL, B)
    for name, got, want in (("skip", skip, want_skip),
                            ("hsave", hsave, want_h),
                            ("tfsg", tfsg, want_tf)):
        assert got.dtype == torch.float32
        _close(name, got, want, 1e-5)
    dtab, dctx, db_fg, dw_fg, dw_out, db_out, dwup_aug = \
        sk.stack_bwd_f32_split(hsave, tfsg, ctx, ts["w_fg"], ts["w_out"],
                               ts["dskip"], tpack, V, DIL,
                               sk._ctx_proj_args(trip) if proj else None)
    got = {"table2": dtab, "b_fg": db_fg, "w_fg": dw_fg, "w_out": dw_out,
           "b_out": db_out}
    if proj:
        got["xc"] = dctx
        got["wup"], got["bup"] = sk._ctx_proj_grads(dwup_aug, trip)
    assert set(got) == set(want_g)
    for name, want in want_g.items():
        _close(name, got[name], want, 1e-4)


# ------------------------------------- the recompute trunk against JAX
def _tails_inputs(t, has_ctx, n_layers, seed=1):
    rng = np.random.default_rng(seed)
    f = np.float32
    win = (3 if has_ctx else 2) * R
    a = dict(
        x=(rng.standard_normal((B, t, R)) * 0.5).astype(f),
        b_fg=(rng.standard_normal((n_layers * B, 2 * R)) * 0.1).astype(f),
        w_fg=(rng.standard_normal((n_layers, win, 2 * R))
              / np.sqrt(win)).astype(f),
        w_out=(rng.standard_normal((n_layers, R, R + S))
               / np.sqrt(R)).astype(f),
        b_out=(rng.standard_normal((n_layers, R + S)) * 0.1).astype(f),
        dskip=(rng.standard_normal((B, t, S)) * 0.1).astype(f))
    if has_ctx:
        a["ctx"] = (rng.standard_normal((B, t, R)) * 0.5).astype(f)
    return a


@pytest.mark.parametrize("has_ctx", [False, True])
@pytest.mark.parametrize("dil,t", [(DIL, 512), (DIL_WIDE, 1280)])
def test_f32_recompute_emulation_matches_jax(has_ctx, dil, t):
    """The float32 recompute kernels' products, emulated layer by layer
    (the forward's, the rebuilt layers', fg again and the gradients'),
    against JAX's tails kernels in float32: skip within 1e-5 of its
    scale, dx, dctx and every weight gradient within 1e-4 of theirs."""
    a = _tails_inputs(t, has_ctx, len(dil))
    names = ["x"] + (["ctx"] if has_ctx else []) + \
        ["b_fg", "w_fg", "w_out", "b_out"]

    def op(*xs):
        d = dict(zip(names, xs))
        return jsk.fused_stack(d["x"], d.get("ctx"), d["b_fg"], d["w_fg"],
                               d["w_out"], d["b_out"], dil, True,
                               "recompute")

    want_skip, vjp = jax.vjp(op, *[jnp.asarray(a[n]) for n in names])
    want_g = dict(zip(names, vjp(jnp.asarray(a["dskip"]))))
    ts = {n: torch.from_numpy(v) for n, v in a.items()}
    args = (ts["x"], ts.get("ctx"), ts["b_fg"], ts["w_fg"], ts["w_out"],
            ts["b_out"], dil)
    skip, ckpt = sk.stack_fwd_tails_f32_split(*args)
    assert skip.dtype == ckpt.dtype == torch.float32
    assert ckpt.shape[0] == len(sk.ckpt_layers(len(dil),
                                               sk.tails_every(len(dil))))
    _close("skip", skip, np.asarray(want_skip), 1e-5)
    dx, dctx, db_fg, dw_fg, dw_out, db_out = sk.stack_bwd_tails_f32_split(
        ts["x"], ckpt, *args[1:-1], ts["dskip"], dil)
    got = {"x": dx, "ctx": dctx, "b_fg": db_fg, "w_fg": dw_fg,
           "w_out": dw_out, "b_out": db_out}
    for name in names:
        assert got[name].dtype == torch.float32
        _close(name, got[name], np.asarray(want_g[name]), 1e-4)


# ------------------------------------------------- the head against JAX
@pytest.mark.parametrize("s,c", [(8, 64), (8, 128), (8, 256), (64, 256)])
@pytest.mark.parametrize("parity", [True, False])
def test_f32_head_emulation_matches_jax(s, c, parity):
    t, rf = 1024, 15
    rng = np.random.default_rng(s + c)
    codes = rng.integers(0, c, size=(B, t)).astype(np.int32)
    prev = np.concatenate([np.full((B, 1), -1, np.int32), codes[:, :-1]], 1)
    pack = np.ascontiguousarray(
        np.concatenate([codes, prev, np.roll(codes, -1, 1)], 0).T)
    f = np.float32
    a = dict(skip=rng.standard_normal((B, t, s)).astype(f),
             w1=(rng.standard_normal((s, c)) / 4).astype(f),
             b1=(rng.standard_normal((c,)) * 0.1).astype(f),
             w2=(rng.standard_normal((c, c)) * (2.5 / np.sqrt(c))).astype(f),
             b2=(rng.standard_normal((c,)) * 0.1).astype(f))
    names = ("skip", "w1", "b1", "w2", "b2")
    n_valid = B * (t - rf)

    def jloss(*xs):
        loss, match = jhl.fused_head_loss(xs[0], jnp.asarray(pack), *xs[1:],
                                          rf, parity, True, 2 * B)
        return loss / n_valid, match

    (want_l, want_m), want_g = jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True)(
            *[jnp.asarray(a[n]) for n in names])
    ts = {n: torch.from_numpy(a[n]) for n in names}
    tpack = torch.from_numpy(pack)
    hargs = (ts["skip"], tpack, ts["w1"], ts["b1"], ts["w2"], ts["b2"], rf,
             parity, 2 * B)
    loss, match, p = hl.head_fwd_plain(*hargs, mm=sk.split_matmul)
    np.testing.assert_allclose(float(loss) / n_valid, float(want_l),
                               rtol=1e-5)
    assert float(match) == float(want_m)
    got = hl.head_bwd_plain(ts["skip"], tpack, p, ts["w1"], ts["b1"],
                            ts["w2"], ts["b2"], rf, parity,
                            torch.tensor(1.0 / n_valid), 2 * B,
                            mm=sk.split_matmul)
    for name, x, want in zip(names, got, want_g):
        assert x.dtype == torch.float32
        _close(name, x, np.asarray(want), 1e-4)


# ------------------------------------------------ byte counts, refusals
@pytest.mark.parametrize("r,s", ks.WIDTHS)
def test_f32_save_launches_fit_a_block(r, s):
    for win in (2 * r, 3 * r):
        smem = ks.f32_smem(r, s, win)
        assert set(smem) == {"layer_fwd", "layer_bwd", "layer_bwd_rc",
                             "wgrad_fg", "wgrad_out", "wgrad_up"}
        assert max(smem.values()) <= ks.SMEM_LIMIT, (win, smem)
        ks._f32_fits(r, s, win)


@pytest.mark.parametrize("r,s", ks.WIDTHS)
@pytest.mark.parametrize("has_ctx", [False, True])
def test_f32_recompute_launches_fit_a_block(r, s, has_ctx):
    """The float32 recompute backward's layer launch stages each tile's
    float32 [h | h(t-d) | ctx] rows (3R + 4 floats a row) over its [dh |
    dskip] and dfg rows (R + S + 4 and 2R + 4), so it takes the float32
    save backward's bytes; at (64, 64) with ctx that is 202,752 of a
    block's 232,448, where the operand rows beside the tile would need
    50,176 more.  The recompute forward and its rebuilds launch the save
    forward's layer kernel."""
    win = (3 if has_ctx else 2) * r
    smem = ks.f32_smem(r, s, win)
    assert 3 * r + 4 <= (r + s + 4) + (2 * r + 4)
    assert smem["layer_bwd_rc"] == smem["layer_bwd"] <= ks.SMEM_LIMIT
    if (r, s, has_ctx) == (64, 64, True):
        assert smem["layer_bwd_rc"] == 202_752
        assert smem["layer_bwd"] + 2 * 32 * (3 * r + 4) * 4 > ks.SMEM_LIMIT
    for k in ("layer_fwd", "wgrad_fg", "wgrad_out"):
        assert smem[k] <= ks.SMEM_LIMIT, (k, smem)


def test_f32_heads_fit_a_block_up_to_c128():
    """Every float32 head at S <= 64, C <= 256 fits a block (above C = 128
    the wide kernels' W1 and ring of W2 rows; above S = 64,
    tests/test_torch_wide_f32.py); C = 260 and S = 132 are refused with the
    B.4 label.  W2 staged whole, (256, 264) floats, would be 270,336
    bytes."""
    for s in range(4, 65, 4):
        for c in range(4, 257, 4):
            assert max(kh.f32_smem(s, c).values()) <= ks.SMEM_LIMIT, (s, c)
            kh._f32_widths(s, c)
    assert 256 * 264 * 4 > ks.SMEM_LIMIT
    assert max(kh.f32_smem(64, 256).values()) == 189_440
    for s, c in ((8, 260), (64, 260), (132, 64)):
        with pytest.raises(NotImplementedError, match=r"B\.4"):
            kh._f32_widths(s, c)


def test_mixed_activation_dtypes_are_refused():
    pack, a = _trunk_inputs(1280, False)
    ts = {n: torch.from_numpy(v) for n, v in a.items()}
    ctx = torch.zeros(B, 1280, R, dtype=torch.bfloat16)
    w_fg = torch.zeros(L, 3 * R, 2 * R)
    with pytest.raises(ValueError, match="table2 torch.float32, ctx "
                                         "torch.bfloat16"):
        ks._fwd_check(torch.from_numpy(pack), ts["table2"], ctx, ts["b_fg"],
                      w_fg, ts["w_out"], ts["b_out"], DIL, B)


def test_unbuilt_f32_forms_name_their_roadmap_item():
    for family, item in ks.F32_UNBUILT.items():
        msg = ks.f32_unbuilt("the kernels", family, torch.float32)
        assert "torch.float32" in msg and "bfloat16" in msg
        assert f"ROADMAP.md B.2/B.4 {item}" in msg


class _Built:
    """A stand-in for the kernel library: every width built."""

    @staticmethod
    def movenet_stack_supports(family, r, s):
        return 1


def test_f32_recompute_is_taken_where_merged_and_non_embed_refuse():
    """_x_check takes float32 x and ctx for the recompute, the non-embed
    save (B.2/B.4 (2), built) and the replay families, and refuses them,
    with their B.2/B.4 item (3), for the merged forms; a float16 x is
    refused for every family."""
    a = _tails_inputs(256, True, L)
    ts = {n: torch.from_numpy(v) for n, v in a.items()}
    args = (ts["x"], ts["ctx"], ts["b_fg"], ts["w_fg"], ts["w_out"],
            ts["b_out"], DIL)
    for family in ("recompute", "non-embed", "replay"):
        assert ks._x_check(_Built, *args, "the kernels", family) == \
            (B, 256, L, R, S, 3 * R)
        with pytest.raises(ValueError, match="torch.float16"):
            ks._x_check(_Built, ts["x"].half(), *args[1:], "the kernels",
                        family)
    with pytest.raises(ValueError, match=r"B\.2/B\.4 \(3\)"):
        ks._x_check(_Built, *args, "the kernels", "merged")
    with pytest.raises(ValueError, match="ctx is torch.bfloat16"):
        ks._x_check(_Built, ts["x"], ts["ctx"].bfloat16(), *args[2:],
                    "the recompute kernels", "recompute")
    assert not {"recompute", "non-embed", "replay"} & set(ks.F32_UNBUILT)


def test_f32_on_the_cpu_runs_the_plain_versions():
    """The wrappers take the plain versions for float32 CPU tensors and
    count no launch."""
    pack, a = _trunk_inputs(1280, False)
    ts = {n: torch.from_numpy(v) for n, v in a.items()}
    before = {**ks.launch_counts, **kh.launch_counts}
    args = (torch.from_numpy(pack), ts["table2"], None, ts["b_fg"],
            ts["w_fg"], ts["w_out"], ts["b_out"], DIL, B)
    got = ks.stack_fwd(*args)
    for x, y in zip(got, sk.stack_fwd_plain(*args)):
        assert torch.equal(x, y)
    tails = (got[1][0][:, :256].contiguous(), None, ts["b_fg"], ts["w_fg"],
             ts["w_out"], ts["b_out"], DIL)
    skip, ckpt = ks.stack_fwd_tails(*tails)
    for x, y in zip((skip, ckpt), sk.stack_fwd_tails_plain(*tails)):
        assert x.dtype == torch.float32 and torch.equal(x, y)
    assert {**ks.launch_counts, **kh.launch_counts} == before


@pytest.mark.parametrize("has_ctx", [False, True])
def test_f32_non_embed_and_replay_on_the_cpu(has_ctx):
    """The float32 non-embed save and replay wrappers take the plain
    versions for CPU tensors and count no launch; the replay forward's
    checkpoints are the float32 save forward's layer inputs at layers k,
    2k, ..., and ``replay_rebuild`` gives every other layer input bit for
    bit; the replay backward is the save backward's."""
    a = _tails_inputs(512, has_ctx, L)
    ts = {n: torch.from_numpy(v) for n, v in a.items()}
    args = (ts["x"], ts.get("ctx"), ts["b_fg"], ts["w_fg"], ts["w_out"],
            ts["b_out"], DIL)
    before = {**ks.launch_counts, **kh.launch_counts}
    skip, hsave, tfsg = ks.stack_fwd_x(*args)
    got = ks.stack_fwd_replay(*args)
    assert all(v.dtype == torch.float32 for v in (skip, hsave, *got))
    assert torch.equal(got[0], skip) and torch.equal(got[2], tfsg)
    every = sk.tails_every(L)
    layers = sk.ckpt_layers(L, every)
    assert got[1].shape[0] == len(layers)
    for i, l in enumerate(layers):
        assert torch.equal(got[1][i], hsave[l])
        rebuilt = sk.replay_rebuild(got[1][i], tfsg, ts["w_out"],
                                    ts["b_out"], torch.float32, l,
                                    min(l + every, L))
        assert len(rebuilt) == min(every, L - l)
        for j, h in enumerate(rebuilt):
            assert torch.equal(h, hsave[l + j]), l + j
    tail = (ts.get("ctx"), ts["w_fg"], ts["w_out"])
    save = ks.stack_bwd_x(hsave, tfsg, *tail, ts["dskip"], DIL)
    replay = ks.stack_bwd_replay(ts["x"], got[1], tfsg, *tail, ts["b_out"],
                                 ts["dskip"], DIL)
    for u, v in zip(replay, save):
        assert (u is None and v is None) or torch.equal(u, v)
    assert {**ks.launch_counts, **kh.launch_counts} == before
