"""The float32 forms at the R = 128 widths on the CPU, where no card runs
them: the wide float32 recompute trunk kernels (csrc/stack_kernel.cu,
"the wide float32 recompute kernels": kernel A, the layer kernel, and
kernel B, the layer backward, on split-TF32 wgmma) and the float32 head at
64 < S <= 128 (csrc/head_loss.cu).

* Their arithmetic, emulated (``ops/stack_kernel.kstep_split_matmul``:
  every product in the kernels' order, k in chunks, each chunk's three
  split-TF32 passes summed from zero and added in float32: kernels A and B
  at ``WIDE_F32_CHUNK`` = 16, the weight gradients and the head at 8, one
  mma.sync k step), against the JAX package in float32
  (Pallas in interpret mode): the recompute trunk on a 3-layer cut of the
  probe's dilations (1, 2, 4) at (R, S) = (128, 128) and (128, 8), with
  and without ctx, skip within 1e-5 of its scale and every gradient within
  1e-4 (tests/test_torch_f32_kernels.py's bars, which chip_smoke.py holds
  the kernels to); the head at (S, C) = (128, 64) and (128, 256), parity
  on and off, the loss rtol 1e-5, the match count equal, every gradient
  within 1e-4 of its scale.
* Their shared memory (``ops/cuda/stack_kernel.f32_smem``,
  ``ops/cuda/head_loss.f32_smem``): the wide layouts fit a block's 232,448
  bytes where the narrow float32 layouts at R = 128 would take 2-3
  blocks' worth.
* The weight split of kernels A and B (``stack_wt_split_kernel``, whose
  plain version is ``ops/stack_kernel.wide_f32_weight_images``): every big
  part exact in TF32, big + small within 2^-22 of the weights' scale, and
  each image in the order the kernels read it.
"""

import functools


import numpy as np
import pytest
import torch

import jax.numpy as jnp

from movenet_tpu.ops.pallas import head_loss as jhl
from movenet_tpu.ops.pallas import stack_kernel as jsk

from movenet_tpu_torch.ops import head_loss as hl
from movenet_tpu_torch.ops import stack_kernel as sk
from movenet_tpu_torch.ops.cuda import head_loss as kh
from movenet_tpu_torch.ops.cuda import stack_kernel as ks

import jax

torch.set_num_threads(2)
B, DIL, T = 2, (1, 2, 4), 512
# the mma.sync forms' k steps of 8 (the weight gradients, the head), and
# kernels A and B's wgmma chunks
mm = sk.kstep_split_matmul
wg_mm = functools.partial(sk.kstep_split_matmul, chunk=sk.WIDE_F32_CHUNK)


def _close(name, got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    scale = float(np.max(np.abs(want))) + 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=name)


def _trunk_inputs(r, s, has_ctx, seed=5):
    rng = np.random.default_rng(seed + r + s)
    f, n = np.float32, len(DIL)
    win = (3 if has_ctx else 2) * r
    a = dict(
        x=(rng.standard_normal((B, T, r)) * 0.5).astype(f),
        b_fg=(rng.standard_normal((n * B, 2 * r)) * 0.1).astype(f),
        w_fg=(rng.standard_normal((n, win, 2 * r)) / np.sqrt(win)).astype(f),
        w_out=(rng.standard_normal((n, r, r + s)) / np.sqrt(r)).astype(f),
        b_out=(rng.standard_normal((n, r + s)) * 0.1).astype(f),
        dskip=(rng.standard_normal((B, T, s)) * 0.1).astype(f))
    if has_ctx:
        a["ctx"] = (rng.standard_normal((B, T, r)) * 0.5).astype(f)
    return a


@pytest.mark.parametrize("has_ctx", [False, True])
@pytest.mark.parametrize("r,s", ks.WIDE_WIDTHS)
def test_wide_f32_recompute_emulation_matches_jax(r, s, has_ctx):
    """The wide float32 recompute kernels' products in their order (the
    forward's, the rebuilt layers' and the taps' in kernel A, dgated and
    dfg_w in kernel B, at their wgmma chunk; the weight gradients' in k
    steps of 8) against JAX's tails kernels in float32."""
    a = _trunk_inputs(r, s, has_ctx)
    names = ["x"] + (["ctx"] if has_ctx else []) + \
        ["b_fg", "w_fg", "w_out", "b_out"]

    def op(*xs):
        d = dict(zip(names, xs))
        return jsk.fused_stack(d["x"], d.get("ctx"), d["b_fg"], d["w_fg"],
                               d["w_out"], d["b_out"], DIL, True,
                               "recompute")

    want_skip, vjp = jax.vjp(op, *[jnp.asarray(a[n]) for n in names])
    want_g = dict(zip(names, vjp(jnp.asarray(a["dskip"]))))
    ts = {n: torch.from_numpy(v) for n, v in a.items()}
    args = (ts["x"], ts.get("ctx"), ts["b_fg"], ts["w_fg"], ts["w_out"],
            ts["b_out"], DIL)
    skip, ckpt = sk.stack_fwd_tails_plain(*args, mm=wg_mm)
    assert skip.dtype == ckpt.dtype == torch.float32
    _close("skip", skip, want_skip, 1e-5)
    got = sk.stack_bwd_tails_plain(ts["x"], ckpt, *args[1:-1], ts["dskip"],
                                   DIL,
                                   products=sk.all_products(wg_mm, wgrad=mm))
    for name, x in zip(("x", "ctx", "b_fg", "w_fg", "w_out", "b_out"), got):
        if name in want_g:
            assert x.dtype == torch.float32
            _close(name, x, want_g[name], 1e-4)


@pytest.mark.parametrize("s,c", [(128, 64), (128, 256)])
@pytest.mark.parametrize("parity", [True, False])
def test_wide_f32_head_emulation_matches_jax(s, c, parity):
    """The float32 head at S = 128 (the C <= 128 kernels at C = 64, the
    wide kernels, W2 through the ring and skip from global memory, at C =
    256), its products in the kernels' order, against JAX's
    ``fused_head_loss`` in float32."""
    t, rf = 1024, 15
    rng = np.random.default_rng(s + c + parity)
    codes = rng.integers(0, c, size=(B, t)).astype(np.int32)
    prev = np.concatenate([np.full((B, 1), -1, np.int32), codes[:, :-1]], 1)
    pack = np.ascontiguousarray(
        np.concatenate([codes, prev, np.roll(codes, -1, 1)], 0).T)
    f = np.float32
    a = dict(skip=rng.standard_normal((B, t, s)).astype(f),
             w1=(rng.standard_normal((s, c)) / np.sqrt(s)).astype(f),
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
    loss, match, p = hl.head_fwd_plain(ts["skip"], tpack, ts["w1"],
                                       ts["b1"], ts["w2"], ts["b2"], rf,
                                       parity, 2 * B, mm=mm)
    np.testing.assert_allclose(float(loss) / n_valid, float(want_l),
                               rtol=1e-5)
    assert float(match) == float(want_m)
    got = hl.head_bwd_plain(ts["skip"], tpack, p, ts["w1"], ts["b1"],
                            ts["w2"], ts["b2"], rf, parity,
                            torch.tensor(1.0 / n_valid), 2 * B, mm=mm)
    for name, x, want in zip(names, got, want_g):
        assert x.dtype == torch.float32
        _close(name, x, want, 1e-4)


@pytest.mark.parametrize("r,s", ks.WIDE_WIDTHS)
@pytest.mark.parametrize("has_ctx", [False, True])
def test_wide_f32_recompute_launches_fit_a_block(r, s, has_ctx):
    """Kernel A keeps the 128-row tile's gated rows as the out product's
    big and small TF32 images (2 x 128 x R floats) and a ring of three
    stages of 16 k (the A images of 128 operand rows, the B images of R
    weight rows): 229,424 bytes with the barriers.  Kernel B keeps a ring of
    seven stages of the same size: 229,488.  A fourth stage would not fit
    beside kernel A's gated images, and the narrow layout (W_fg^T and
    W_out^T staged whole) would take 665,600 with ctx; W_fg's gradient
    stages 32-row chunks."""
    win = (3 if has_ctx else 2) * r
    smem = ks.f32_smem(r, s, win)
    assert max(smem.values()) <= ks.SMEM_LIMIT, smem
    ks._f32_fits(r, s, win)
    a_img, kc = 2 * 128 * 16 * 4, 16
    stage = a_img + 2 * r * kc * 4
    assert smem["layer_fwd"] == 2 * 128 * r * 4 + 3 * stage + 48 == 229_424
    assert smem["layer_bwd_rc"] == 7 * stage + 112 == 229_488
    narrow = 4 * (64 * (3 * r + 4) + 2 * r * (3 * r + 4)
                  + (r + s) * (r + 4) + 64 * (r + 4))
    assert narrow > 2 * ks.SMEM_LIMIT
    assert 2 * 128 * r * 4 + 4 * stage > ks.SMEM_LIMIT


@pytest.mark.parametrize("r,s", ks.WIDE_WIDTHS)
@pytest.mark.parametrize("has_ctx", [False, True])
def test_wide_f32_weight_images_split_once(r, s, has_ctx):
    """The plain version of kernels A and B's weight split: both parts
    exact in TF32 (their 13 low bits clear), big = tf32(w), big + small
    within 2^-22 of the
    weights' scale, and each image's elements where the kernels read them:
    W_fg^T in two passes of R/2 filter columns and then their gate
    columns, W_out^T's residual rows and then its skip rows, W_out zero past
    R + S, W_fg in passes of R rows."""
    rng = np.random.default_rng(r + s + has_ctx)
    n, win, no = 2, (3 if has_ctx else 2) * r, r + s
    w_fg = torch.from_numpy(rng.standard_normal((n, win, 2 * r))
                            .astype(np.float32))
    w_out = torch.from_numpy(rng.standard_normal((n, r, no))
                             .astype(np.float32))
    img = sk.wide_f32_weight_images(w_fg, w_out, bwd=True)
    bits = img.view(torch.int32)
    k1 = -(-no // 16) * 16
    fwd, bwd = 2 * (2 * r * win + no * r), 2 * (r * k1 + win * 2 * r)
    assert img.numel() == n * (fwd + bwd)

    def unpack(flat, rows, kdim):
        """(big, small), each (rows, kdim), of one image."""
        off = sk.img_offsets(rows, 16).reshape(-1)
        ch = flat.reshape(kdim // 16, 2, rows * 16)[:, :, off]
        ch = ch.reshape(kdim // 16, 2, rows, 16).permute(1, 2, 0, 3)
        return ch.reshape(2, rows, kdim)

    half = r // 2
    cols = torch.arange(2 * r)
    order = half * (cols // r) + cols % half + (cols % r >= half).long() * r
    for l in range(n):
        f = img[l * fwd:(l + 1) * fwd]
        b = img[n * fwd + l * bwd:n * fwd + (l + 1) * bwd]
        wo = torch.zeros(r, k1)
        wo[:, :no] = w_out[l]
        wfg_t = w_fg[l].t()[order]
        want = [(f[:2 * r * win], wfg_t[:r]),
                (f[2 * r * win:4 * r * win], wfg_t[r:]),
                (f[4 * r * win:4 * r * win + 2 * r * r], w_out[l].t()[:r]),
                (f[4 * r * win + 2 * r * r:], w_out[l].t()[r:]),
                (b[:2 * r * k1], wo)] + [
                (b[2 * r * k1 + 4 * r * r * p:2 * r * k1 + 4 * r * r * (p + 1)],
                 w_fg[l][p * r:(p + 1) * r]) for p in range(win // r)]
        for flat, w in want:
            big, small = unpack(flat, *w.shape)
            assert torch.equal(big, sk.tf32_rna(w))
            assert float((big + small - w).abs().max()) <= \
                2.0 ** -22 * float(w.abs().max())
    # both parts of every image exact in TF32, as wgmma reads them
    assert int((bits & 0x1FFF).ne(0).sum()) == 0


def test_wide_f32_heads_fit_a_block():
    """Every float32 head at 64 < S <= 128, C <= 256 fits a block: the C <=
    128 kernels as they are (129,536 / 129,280 bytes at (128, 64)), the
    wide kernels with no per-warp rows of leaky(skip) (215,040 / 220,160
    at (128, 256), where those rows would add 69,632)."""
    for s in range(68, 129, 4):
        for c in range(4, 257, 4):
            assert max(kh.f32_smem(s, c).values()) <= ks.SMEM_LIMIT, (s, c)
            kh._f32_widths(s, c)
    assert kh.f32_smem(128, 64) == {"fwd": 129_536, "bwd": 129_280}
    assert kh.f32_smem(128, 256) == {"fwd": 215_040, "bwd": 220_160}
    assert 220_160 + 8 * 16 * 136 * 4 > ks.SMEM_LIMIT
