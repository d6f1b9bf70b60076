"""The trunk's layer kernel sums its products in another order than the
plain versions: bf16 ``mma.sync`` m16n8k16, each 16-wide k step summed
from zero and added to the float32 sum in k order, and the merged head's
row reductions across a quad of lanes; on the card the plain versions'
float32 products are one fmaf chain over k.  In the save forms the kernel
sums again, as the chain, the fg elements near a bf16 rounding tie and
the residual's out, so that its bf16 roundings that feed later layers are
the plain version's.  ``ops/stack_kernel`` models these orders on the CPU
(``mma_order_matmul``, ``chain_matmul``, ``stack_fwd_x_mma_order``,
``quad_order_sum``, ``head_fwd_quad_order``); here the model is held

- to its definitions (float64 sums of each k step, added in order; the
  fmaf chain);
- at the breakdancing widths (R = S = 64, W_in = 192, 9 layers) over 4096
  seeded rows, in the save and the merged form: with the re-sums, to the
  plain save forward in the chain's order (``_save_fwd`` with
  ``chain_matmul``), hsave and tfsg bit for bit and skip within 2% of its
  scale; every product in the tensor-core order, to the plain save
  forward within the card's bound, 2% of each output's scale;
- at R = S = 16, 6 layers, T = 1280, to the JAX package's save forward
  (``_fwd_pallas`` in interpret mode, as its own CPU tests run it),
  within the same 2%;
- at the three training widths (``utils/fwd_order``, 512 rows a batch
  row): the re-sum margin's observations, the largest gap between the
  orders below the margin and no escaped flip; and the save forward
  summed in float64 (``_save_fwd`` with ``acc``), its yardstick, within
  the same 2% of the float32 one;
- in the merged head, to ``head_loss.head_fwd_plain``: the loss sum rtol
  1e-5 and the match count within 2 rows, the card's bars for the merged
  forward (float32 sums of every row in other orders; first-argmax ties
  within float32 noise).

So the kernel's outputs may move from the plain version's by summation
order only, and by no more than the card's tolerances allow."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from movenet_tpu.ops.pallas import stack_kernel as jsk

from movenet_tpu_torch.ops import head_loss as hl
from movenet_tpu_torch.ops import stack_kernel as sk

torch.set_num_threads(2)
BF = torch.bfloat16


def _bf(rng, *shape, scale=1.0):
    """float32 values that are exact bf16 values."""
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to(BF).float()


@pytest.mark.parametrize("k", [16, 48, 200])
def test_mma_order_matmul_sums_k_steps_in_order(k):
    rng = np.random.default_rng(k)
    a, b = _bf(rng, 33, k), _bf(rng, k, 24)
    got = sk.mma_order_matmul(a, b).numpy()
    an, bn = a.numpy().astype(np.float64), b.numpy().astype(np.float64)
    want = np.zeros((33, 24), np.float32)
    for k0 in range(0, k, 16):
        want = want + (an[:, k0:k0 + 16] @ bn[k0:k0 + 16]).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, an @ bn, rtol=1e-5, atol=1e-5)


def _save_inputs(rng, batch, t, r, s, n, ctx):
    win = (3 if ctx else 2) * r
    return (_bf(rng, batch, t, r, scale=0.5).to(BF),
            _bf(rng, batch, t, r, scale=0.5).to(BF) if ctx else None,
            torch.from_numpy((rng.standard_normal((n * batch, 2 * r)) * 0.1)
                             .astype(np.float32)),
            torch.from_numpy((rng.standard_normal((n, win, 2 * r))
                              / np.sqrt(win)).astype(np.float32)),
            torch.from_numpy((rng.standard_normal((n, r, r + s))
                              / np.sqrt(r)).astype(np.float32)),
            torch.from_numpy((rng.standard_normal((n, r + s)) * 0.1)
                             .astype(np.float32)))


@pytest.mark.parametrize("k", [16, 192])
def test_chain_matmul_is_the_fmaf_chain(k):
    rng = np.random.default_rng(k + 1)
    a, b = _bf(rng, 33, k), _bf(rng, k, 24)
    an, bn = a.numpy(), b.numpy()
    want = np.zeros((33, 24), np.float32)
    for i in range(k):
        want = (want + an[:, i:i + 1] * bn[i]).astype(np.float32)
    np.testing.assert_array_equal(sk.chain_matmul(a, b).numpy(), want)


@pytest.mark.parametrize("raw_gate", [False, True])
def test_save_fwd_with_resums_keeps_the_chain_bits(raw_gate):
    """Breakdancing widths, 4096 rows: the model of the save layer kernel
    (re-sums of fg near ties, the residual as the chain) against the
    plain save forward in the chain's order: hsave and tfsg bit for bit,
    skip (on the tensor cores, feeding no layer) within 2%."""
    rng = np.random.default_rng(6)
    dil = (1, 2, 4) * 3
    x, ctx, *w = _save_inputs(rng, 2, 2048, 64, 64, len(dil), True)
    w[1], w[2] = w[1] * 1.7, w[2] * 1.7
    skip, hsave, tfsg = sk.stack_fwd_x_mma_order(x, ctx, *w, dil,
                                                 raw_gate=raw_gate)
    ws, wh, wt = sk._save_fwd(x.float(), ctx, *w, dil, BF, raw_gate,
                              matmul=sk.chain_matmul)
    assert torch.equal(hsave, wh)
    assert torch.equal(tfsg, wt)
    u, v = skip.float().numpy(), ws.to(BF).float().numpy()
    np.testing.assert_allclose(u, v, rtol=0, atol=2e-2 * np.abs(v).max())


@pytest.mark.parametrize("raw_gate", [False, True])
def test_save_fwd_in_mma_order_within_the_card_bound(raw_gate):
    """Breakdancing widths, 4096 rows: every product in the tensor-core
    order against the plain save forward, 2% of each output's scale; most
    of each output's bf16 values are the same bits."""
    rng = np.random.default_rng(5)
    dil = (1, 2, 4) * 3
    x, ctx, *w = _save_inputs(rng, 2, 2048, 64, 64, len(dil), True)
    got = sk.stack_fwd_x_mma_order(x, ctx, *w, dil, raw_gate=raw_gate,
                                   exact_ties=False)
    skip, hsave, tfsg = sk._save_fwd(x.float(), ctx, *w, dil, BF, raw_gate)
    for name, u, v in zip(("skip", "hsave", "tfsg"), got,
                          (skip.to(BF), hsave, tfsg)):
        u, v = u.float().numpy(), v.float().numpy()
        np.testing.assert_allclose(u, v, rtol=0,
                                   atol=2e-2 * np.abs(v).max(), err_msg=name)
        assert np.mean(u == v) > 0.9, name


@pytest.mark.parametrize("ctx", [False, True])
def test_save_fwd_in_mma_order_matches_jax(ctx):
    rng = np.random.default_rng(7)
    dil = (1, 2, 4) * 2
    args = _save_inputs(rng, 2, 1280, 16, 16, len(dil), ctx)
    got = sk.stack_fwd_x_mma_order(*args, dil)
    jx = [None if a is None else jnp.asarray(
        a.float().numpy(), jnp.bfloat16 if a.dtype == BF else jnp.float32)
        for a in args]
    want = jsk._fwd_pallas(*jx, dil, True)[:3]
    for name, u, v in zip(("skip", "hsave", "tfsg"), got, want):
        u, v = u.float().numpy(), np.asarray(v, np.float32)
        np.testing.assert_allclose(u, v, rtol=0,
                                   atol=2e-2 * np.abs(v).max(), err_msg=name)


@pytest.mark.parametrize("s,c,parity", [(64, 64, True), (64, 64, False),
                                        (8, 36, True), (16, 4, False)])
def test_head_in_quad_order_matches_plain(s, c, parity):
    rng = np.random.default_rng(c + s)
    batch, t, rf = 2, 2048, 28
    skip = _bf(rng, batch, t, s).to(BF)
    w = (_bf(rng, s, c, scale=s ** -0.5), _bf(rng, c, scale=0.1),
         _bf(rng, c, c, scale=c ** -0.5), _bf(rng, c, scale=0.1))
    tgt = torch.from_numpy(rng.integers(0, c, (t, batch)).astype(np.int32))
    loss, match = sk.head_fwd_quad_order(skip, tgt, *w, rf, parity)
    wl, wm, _ = hl.head_fwd_plain(skip, tgt, *w, rf, parity, 0,
                                  save_p=False)
    np.testing.assert_allclose(float(loss), float(wl), rtol=1e-5)
    assert abs(float(match) - float(wm)) <= 2


@pytest.mark.parametrize("shape", ["breakdancing", "exp03", "exp04"])
def test_resum_margin_holds_on_seeded_inputs(shape):
    """The margin of 8 units of |a|_2 |w|_2 is empirical: on seeded inputs
    the two orders' fg stay well inside it, and the kernel's model keeps
    every hsave and tfsg bit of the chain-order plain version."""
    from movenet_tpu_torch.utils import fwd_order

    x, ctx, *w, dil = fwd_order.inputs(shape, 3, 512)
    st = fwd_order.tie_stats(x, ctx, w[0], w[1], dil, w[2], w[3])
    assert st["gap_l2"] < sk.MMA_TIE_UNITS / 2
    assert 0 < st["flag_sg"] < st["flag_tf"] < 0.05
    kept = sk.stack_fwd_x_mma_order(x, ctx, *w, dil)
    chain = sk._save_fwd(x.float(), ctx, *w, dil, BF, False,
                         matmul=sk.chain_matmul)
    assert torch.equal(kept[1], chain[1])
    assert torch.equal(kept[2], chain[2])


def test_save_fwd_in_float64_is_the_same_forward():
    rng = np.random.default_rng(11)
    dil = (1, 2, 4)
    x, ctx, *w = _save_inputs(rng, 2, 512, 32, 8, len(dil), True)
    got = sk._save_fwd(x.double(), ctx, *w, dil, BF, False,
                       acc=torch.float64)
    want = sk._save_fwd(x.float(), ctx, *w, dil, BF, False)
    assert got[0].dtype == torch.float64
    for name, u, v in zip(("skip", "hsave", "tfsg"), got, want):
        u, v = u.float().numpy(), v.float().numpy()
        np.testing.assert_allclose(u, v, rtol=0,
                                   atol=2e-2 * np.abs(v).max(), err_msg=name)


def test_time_stack_bwd_variant_edits_apply():
    """Each diagnostic edit of the timing tool applies once to the
    kernel source it builds (the split-TF32 headers inlined), as the tool
    requires: the trunk's edits to stack_kernel.cu (the wide float32
    recompute kernels' among them), the gated block's to gated_block.cu."""
    from movenet_tpu_torch.utils import time_stack_bwd as tsb

    for source, tables in (("stack_kernel", (tsb.VARIANTS, tsb.FWD_VARIANTS,
                                             tsb.RECOMPUTE_VARIANTS)),
                           ("gated_block", (tsb.GATED_VARIANTS,))):
        src = tsb.inlined_source(source)
        assert '#include "mma_tf32.cuh"' not in src
        assert '#include "wgmma_tf32.cuh"' not in src
        for table in tables:
            for name, edits in table.items():
                text = src
                for old, new in edits:
                    assert text.count(old) == 1, (source, name, old)
                    text = text.replace(old, new)
