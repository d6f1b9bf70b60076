"""The wide bf16 trunk backwards on ``wgmma`` (csrc/stack_kernel.cu, "the
wide layer backwards on wgmma" and "W_fg's gradient on wgmma") on the CPU,
where no card runs them: at (R, S) = (128, 128) and (128, 8) the layer
launch of the bf16 save, replay and recompute backwards runs kernel B's
block in its bf16 forms, and W_fg's gradient (MODE 0, and the bf16 replay's
MODE 7) runs on ``wgmma`` too.

* Their arithmetic, emulated (``ops/stack_kernel.wide_bwd_products``:
  dgated and dfg_w split-TF32 with both operands split, W_fg's gradient
  over rows with A split only in MODE 7, each ``WIDE_F32_CHUNK`` = 16 of k
  summed from zero and added in float32; the recompute's fg formed again
  in bf16 k steps of 16; MODE 7's rows of h(t-d) rounded as the TPU
  kernel's ring holds them), through the port's ``fused_stack`` with the
  recompute and replay strategies, against the JAX package's bf16 kernels
  (Pallas in interpret mode) on a 3-layer cut of the probe's dilations (1,
  2, 4) at B = 2: (128, 128) with the video projection triple (T = 1600)
  and (128, 8) with the flat ctx (T = 1280), at
  tests/test_torch_wide_recompute.py's bf16 bars (skip within 2% of its
  scale, every gradient within 5% of its leaf's largest magnitude, the
  mean difference within 0.5%).
* The emulation against the plain versions (torch's products) from the
  same inputs: every gradient within ``PLAIN_BARS`` of its scale.
* Their shared memory (``ops/cuda/stack_kernel.wide_bwd_smem``, the
  library's ``WgF32Bwd`` and ``WgWgrad``, which
  tests/test_torch_stack_kernel_cuda.py holds against the library on the
  card): each launch fits a block's 232,448 bytes at both widths, with ctx
  and without.
* Their weights: the float32 forms' images (``stack_wt_split_kernel``'s
  backward part, ``ops/stack_kernel.wide_f32_weight_images``), each
  weight split once into a TF32 big and small part."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from movenet_tpu.ops.pallas import stack_kernel as jsk

from movenet_tpu_torch.ops import stack_kernel as sk
from movenet_tpu_torch.ops.cuda import stack_kernel as ks

torch.set_num_threads(2)
B = 2
DIL = (1, 2, 4)
T_FLAT, T_PROJ = 1280, 1600
CAST = {"x", "ctx", "xc"}
# the emulation against the plain versions, of each gradient's scale, by
# strategy: (the bf16 gradients dx and dctx or dxc, the float32 ones).  A
# bf16 gradient is a rounding of the float32 sum, so two orders part it by
# up to a bf16 step where a sum lies near a rounding tie (readings up to
# 3.2e-3 of scale: under one step of 2^-8).  In replay only the float32
# sums' orders part the float32 gradients (readings up to 8.1e-7); the
# recompute's rebuilt layers and fg formed again are bf16 products in the
# tensor cores' order, which flips a rounding of h or of the taps now and
# then (readings up to 3.8e-4, W_up's).
PLAIN_BARS = {"recompute": (1e-2, 1e-3), "replay": (1e-2, 1e-5)}
CASES = [(128, 128, "proj"), (128, 8, "flat")]
# the plain backwards, as the module defines them
PLAIN = {name: getattr(sk, name)
         for name in ("stack_bwd_tails_plain", "stack_bwd_replay_plain")}


def _inputs(r, s, ctx_kind, seed=3):
    rng = np.random.default_rng(seed + s)
    n, t = len(DIL), T_PROJ if ctx_kind == "proj" else T_FLAT
    f = np.float32
    win = 3 * r
    a = dict(
        x=(rng.standard_normal((B, t, r)) * 0.5).astype(f),
        b_fg=(rng.standard_normal((n * B, 2 * r)) * 0.1).astype(f),
        w_fg=(rng.standard_normal((n, win, 2 * r)) / np.sqrt(win)).astype(f),
        w_out=(rng.standard_normal((n, r, r + s)) / np.sqrt(r)).astype(f),
        b_out=(rng.standard_normal((n, r + s)) * 0.1).astype(f),
        dskip=(rng.standard_normal((B, t, s)) * 0.1).astype(f))
    if ctx_kind == "flat":
        a["ctx"] = (rng.standard_normal((B, t, r)) * 0.5).astype(f)
    else:
        a["xc"] = (rng.standard_normal((B, t // 10, r)) * 0.5).astype(f)
        a["wup"] = (rng.standard_normal((r, 10 * r)) / np.sqrt(r)).astype(f)
        a["bup"] = (rng.standard_normal((10 * r,)) * 0.1).astype(f)
    return a


def _names(a):
    return ["x"] + [k for k in ("ctx", "xc", "wup", "bup") if k in a] \
        + ["b_fg", "w_fg", "w_out", "b_out"]


def _ctx(d):
    return (d["xc"], d["wup"], d["bup"]) if "xc" in d else d.get("ctx")


def _jax(a, strategy):
    names = _names(a)
    args = [jnp.asarray(a[n], jnp.bfloat16 if n in CAST else jnp.float32)
            for n in names]

    def op(*xs):
        d = dict(zip(names, xs))
        return jsk.fused_stack(d["x"], _ctx(d), d["b_fg"], d["w_fg"],
                               d["w_out"], d["b_out"], DIL, True, strategy)

    skip, vjp = jax.vjp(op, *args)
    grads = vjp(jnp.asarray(a["dskip"], jnp.bfloat16))
    return (np.asarray(skip, np.float32),
            {n: np.asarray(g, np.float32) for n, g in zip(names, grads)})


def _port(a, strategy, monkeypatch, products):
    """(skip, grads by name) of the port's ``fused_stack`` in bf16 on the
    CPU, its plain backward given ``products`` (None: torch's)."""
    name = {"recompute": "stack_bwd_tails_plain",
            "replay": "stack_bwd_replay_plain"}[strategy]
    calls = []
    fn = PLAIN[name]
    monkeypatch.setattr(sk, name, lambda *x, **k: (
        calls.append(name), fn(*x, **k, products=products))[1])
    ts = {n: torch.tensor(a[n], dtype=torch.bfloat16 if n in CAST
                          else torch.float32, requires_grad=True)
          for n in _names(a)}
    skip = sk.fused_stack(ts["x"], _ctx(ts), ts["b_fg"], ts["w_fg"],
                          ts["w_out"], ts["b_out"], DIL, strategy=strategy)
    skip.backward(torch.tensor(a["dskip"], dtype=torch.bfloat16))
    assert calls == [name]
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
@pytest.mark.parametrize("r,s,ctx_kind", CASES)
def test_wide_bf16_emulation_matches_jax(r, s, ctx_kind, strategy,
                                         monkeypatch):
    """The wide bf16 backwards' products as the new kernels sum them,
    through the port's recompute and replay strategies, against JAX's bf16
    kernels."""
    a = _inputs(r, s, ctx_kind)
    want, want_g = _jax(a, strategy)
    got, grads = _port(a, strategy, monkeypatch,
                       sk.wide_bwd_products(replay=strategy == "replay"))
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * scale)
    assert set(grads) == set(want_g)
    for name, w in want_g.items():
        _close(name, grads[name], w, 5e-2, 5e-3)


@pytest.mark.parametrize("strategy", ["recompute", "replay"])
@pytest.mark.parametrize("r,s,ctx_kind", CASES)
def test_wide_bf16_emulation_matches_plain(r, s, ctx_kind, strategy,
                                           monkeypatch):
    """The emulation against the plain versions (torch's products) from
    the same inputs: every gradient within PLAIN_BARS of its scale, the
    same skip."""
    a = _inputs(r, s, ctx_kind, seed=4)
    skip, want_g = _port(a, strategy, monkeypatch, None)
    got, grads = _port(a, strategy, monkeypatch,
                       sk.wide_bwd_products(replay=strategy == "replay"))
    np.testing.assert_array_equal(got, skip)
    for name, w in want_g.items():
        scale = float(np.max(np.abs(w))) + 1e-12
        err = float(np.max(np.abs(grads[name] - w))) / scale
        bar = PLAIN_BARS[strategy][name not in CAST]
        assert err <= bar, (name, err, bar)


@pytest.mark.parametrize("has_ctx", [False, True])
@pytest.mark.parametrize("r,s", ks.WIDE_WIDTHS)
def test_wide_bf16_launches_fit_a_block(r, s, has_ctx):
    """The layer launch of every wide bf16 backward is kernel B's block
    (seven stages of 16 k: the big and small A images of 128 rows and the B
    images of R weight rows, 229,488 bytes with the barriers); W_fg's
    gradient keeps stages of 16 rows, A^T's image of a 128-column slab (its
    big part alone in MODE 0, whose A is bf16; both in MODE 7) and dfg^T's
    big and small images of 128 columns, six in MODE 0 and four in MODE 7,
    beside the producer's six raw stages of 16 rows of A (bf16 in MODE 0,
    float32 in MODE 7) and of dfg: 223,328 bytes in MODE 0 and 231,488 in
    MODE 7 with the barriers and the bias partials.  One more image stage
    or raw stage in either mode, or the recompute's operand rows beside
    kernel B's ring (a fg pass in the layer launch), would not fit."""
    win = (3 if has_ctx else 2) * r
    smem = ks.wide_bwd_smem(r)
    assert max(smem.values()) <= ks.SMEM_LIMIT, smem
    kc, a_img, w_img = 16, 128 * 16 * 4, 128 * 16 * 4
    raw = {0: 16 * 128 * (2 + 4), 7: 16 * 128 * (4 + 4)}
    img = {0: a_img + 2 * w_img, 7: 2 * a_img + 2 * w_img}
    assert smem["layer_bwd"] == 7 * (2 * a_img + 2 * r * kc * 4) + 112 \
        == ks.f32_smem(r, s, win)["layer_bwd_rc"] == 229_488
    assert smem["wgrad_fg"] == 6 * img[0] + 6 * raw[0] + 96 + 2048 \
        == 223_328
    assert smem["wgrad_fg_replay"] == 4 * img[7] + 6 * raw[7] + 64 \
        + 2048 == 231_488
    for key, mode in (("wgrad_fg", 0), ("wgrad_fg_replay", 7)):
        assert smem[key] + min(img[mode], raw[mode]) > ks.SMEM_LIMIT, key
    assert smem["layer_bwd"] + 128 * (3 * r) * 2 > ks.SMEM_LIMIT


@pytest.mark.parametrize("has_ctx", [False, True])
@pytest.mark.parametrize("r,s", ks.WIDE_WIDTHS)
def test_wide_bf16_weight_images_are_the_f32_forms(r, s, has_ctx):
    """The wide bf16 backwards' weight images (``stack_wt_split_kernel``
    without the forward's, the wrappers' ``img``) are the float32 forms'
    backward images as they lie after the forward's in kernel A and B's
    scratch, layer by layer, and each weight is split once: big =
    tf32(w), big + small within 2^-22 of the weights' scale, both parts
    exact in TF32."""
    rng = np.random.default_rng(r + s + has_ctx)
    n, win, no = 3, (3 if has_ctx else 2) * r, r + s
    w_fg = torch.from_numpy(rng.standard_normal((n, win, 2 * r))
                            .astype(np.float32))
    w_out = torch.from_numpy(rng.standard_normal((n, r, no))
                             .astype(np.float32))
    img = sk.wide_f32_weight_images(w_fg, w_out, bwd=True, fwd=False)
    full = sk.wide_f32_weight_images(w_fg, w_out, bwd=True)
    fwd = 2 * (2 * r * win + no * r)
    k1 = -(-no // 16) * 16
    per = 2 * (r * k1 + win * 2 * r)
    assert img.numel() == n * per
    assert torch.equal(img, full[n * fwd:])
    # W_out's image of layer 1, chunk 0: its first 16 k of the R rows
    off = sk.img_offsets(r, 16).reshape(-1)
    chunk = img[per:per + 2 * r * 16].reshape(2, r * 16)[:, off]
    big, small = chunk.reshape(2, r, 16)
    w = w_out[1][:, :16]
    assert torch.equal(big, sk.tf32_rna(w))
    assert torch.equal(small, sk.tf32_rna(w - big))
    assert float((big + small - w).abs().max()) <= \
        2.0 ** -22 * float(w.abs().max())
    assert int((img.view(torch.int32) & 0x1FFF).ne(0).sum()) == 0
