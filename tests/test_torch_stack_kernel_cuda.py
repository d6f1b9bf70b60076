"""The trunk kernels (csrc/stack_kernel.cu) against their plain torch
versions on a CUDA GPU.  Imports only torch and the port, so that it runs
on a machine without JAX:

    python -m pytest tests/test_torch_stack_kernel_cuda.py -q

Without a card every test skips.  Tolerances: the forward outputs are
bf16 values whose float32 sums the kernel and torch add in different
orders, so a stored value may sit one bf16 step away: within 2% of each
output's scale.  The backward takes the same saved tensors in both
versions and sums in float32: within 1e-4 of each gradient's scale.  The
recompute kernels' tolerances are stated at their test.

The save backward's products run on the tensor cores (mma.sync m16n8k8
TF32, float32 sums) with each float32 operand split into two TF32 parts,
big and small, as it is loaded: dgated = [dh | dskip] W_out^T and dfg_w =
dfg W_fg^T in the layer launch take three passes (small*big, big*small,
big*big), as does dW_out = gated^T [dh | dskip] (gated = tf*sg splits
exactly); dW_fg = [hsave | hsave(t-d) | ctx]^T dfg and the projection's
dW_up = xc^T dctx take two (their bf16 operand is exact in TF32).  One
pass of TF32 would miss 1e-4 (tests/test_torch_split_tf32.py).

The float32 forms (the float32 compute dtype: table2, ctx and dskip in
float32) take float32 inputs that are not bf16 values, so that every split
counts: the forward within 1e-5 of each output's scale, every gradient
(dctx too) within 1e-4 of its scale, two calls bit-equal.  The recompute
kernels' float32 forms (x, ctx and dskip float32) are held to the same
bars (dx too), their rebuild to the forward's own layer outputs bit for
bit, at the narrow pairs and at R = 128.  The replay kernels (bf16 and
float32) are held to their plain versions at the save forms' bars, and to
the save kernels' non-embed form bit for bit: the forward's outputs, the
rebuilt layer inputs against the save forward's residual stream (hsave
its rounding) and the backward's outputs, but for W_fg's gradient in bf16,
which takes the rebuilt float32 h as the TPU kernel does."""

import numpy as np
import pytest
import torch

from movenet_tpu_torch.ops import stack_kernel as sk
from movenet_tpu_torch.ops.cuda import stack_kernel as ks

DIL = (1, 2, 4, 1, 2, 4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, t, r, s, v, ctx_kind, batch=2, seed=0,
            dtype=torch.bfloat16):
    """Seeded inputs, the activations (table2, ctx, xc, dskip) in dtype."""
    g = torch.Generator().manual_seed(seed)
    n_layers = len(DIL)
    codes = torch.randint(0, v, (batch, t), generator=g, dtype=torch.int32)
    prev = torch.cat([torch.full((batch, 1), -1, dtype=torch.int32),
                      codes[:, :-1]], 1)
    pack = torch.cat([codes, prev, torch.roll(codes, -1, 1)], 0).t()
    win = (3 if ctx_kind else 2) * r
    bf = dtype

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    a = dict(pack=pack.contiguous(), table2=rn(2 * v, r, scale=0.5).to(bf),
             b_fg=rn(n_layers * batch, 2 * r, scale=0.1),
             w_fg=rn(n_layers, win, 2 * r, scale=win ** -0.5),
             w_out=rn(n_layers, r, r + s, scale=r ** -0.5),
             b_out=rn(n_layers, r + s, scale=0.1),
             dskip=rn(batch, t, s, scale=0.1).to(bf))
    proj = ctx = None
    if ctx_kind == "flat":
        ctx = rn(batch, t, r, scale=0.5).to(bf)
    elif ctx_kind == "proj":
        trip = (rn(batch, t // 10, r, scale=0.5).to(bf),
                rn(r, 10 * r, scale=r ** -0.5), rn(10 * r, scale=0.1))
        ctx = sk.ctx_flatten(trip, bf)
        proj = sk._ctx_proj_args(trip)
    a = {k: x.to(dev) for k, x in a.items()}
    ctx = None if ctx is None else ctx.to(dev)
    proj = None if proj is None else tuple(x.to(dev) for x in proj)
    return a, ctx, proj, batch


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,t,ctx_kind", [
    (16, 16, 1280, None), (16, 16, 1280, "flat"), (16, 16, 1280, "proj"),
    (32, 32, 2000, "proj"), (64, 64, 3200, "proj"), (64, 8, 1000, "flat"),
    (32, 8, 1280, "proj"), (16, 8, 1280, "proj"), (16, 8, 1000, None),
])
def test_stack_kernels_match_plain(cuda, r, s, t, ctx_kind):
    a, ctx, proj, batch = _inputs(cuda, t, r, s, 64, ctx_kind)
    args = (a["pack"], a["table2"], ctx, a["b_fg"], a["w_fg"], a["w_out"],
            a["b_out"], DIL, batch)
    before = dict(ks.launch_counts)
    got = ks.stack_fwd(*args)
    torch.cuda.synchronize()
    assert ks.launch_counts["stack_fwd"] == before["stack_fwd"] + 1
    want = sk.stack_fwd_plain(*args)
    for name, x, y in zip(("skip", "hsave", "tfsg"), got, want):
        x, y = x.float().cpu().numpy(), y.float().cpu().numpy()
        np.testing.assert_allclose(x, y, rtol=0,
                                   atol=2e-2 * np.abs(y).max(), err_msg=name)
    hsave, tfsg = want[1], want[2]
    bargs = (hsave, tfsg, ctx, a["w_fg"], a["w_out"], a["dskip"], a["pack"],
             64, DIL, proj)
    got = ks.stack_bwd(*bargs)
    torch.cuda.synchronize()
    assert ks.launch_counts["stack_bwd"] == before["stack_bwd"] + 1
    want = sk.stack_bwd_plain(*bargs)
    names = ("dtab", "dctx", "db_fg", "dw_fg", "dw_out", "db_out",
             "dwup_aug")
    for name, x, y in zip(names, got, want):
        if y is None:
            assert x is None, name
            continue
        x, y = x.float().cpu().numpy(), y.float().cpu().numpy()
        tol = (2e-2 if name == "dctx" else 1e-4) * np.abs(y).max()
        np.testing.assert_allclose(x, y, rtol=0, atol=tol, err_msg=name)


# the float32 forms at the six built (R, S) pairs, with each ctx form
F32_CASES = [(16, 16, 1280, None), (16, 16, 1280, "flat"),
             (32, 32, 2000, "proj"), (64, 64, 3200, "proj"),
             (64, 8, 1000, "flat"), (64, 8, 1280, "proj"),
             (32, 8, 1280, "proj"), (16, 8, 1280, "proj"),
             (16, 8, 1000, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,t,ctx_kind", F32_CASES)
def test_stack_kernels_match_plain_f32(cuda, r, s, t, ctx_kind):
    a, ctx, proj, batch = _inputs(cuda, t, r, s, 64, ctx_kind,
                                  dtype=torch.float32)
    args = (a["pack"], a["table2"], ctx, a["b_fg"], a["w_fg"], a["w_out"],
            a["b_out"], DIL, batch)
    before = dict(ks.launch_counts)
    got = ks.stack_fwd(*args)
    torch.cuda.synchronize()
    assert ks.launch_counts["stack_fwd_f32"] == before["stack_fwd_f32"] + 1
    assert ks.launch_counts["stack_fwd"] == before["stack_fwd"]
    want = sk.stack_fwd_plain(*args)
    for name, x, y in zip(("skip", "hsave", "tfsg"), got, want):
        assert x.dtype == torch.float32, name
        x, y = x.cpu().numpy(), y.cpu().numpy()
        np.testing.assert_allclose(x, y, rtol=0,
                                   atol=1e-5 * np.abs(y).max(), err_msg=name)
    hsave, tfsg = want[1], want[2]
    bargs = (hsave, tfsg, ctx, a["w_fg"], a["w_out"], a["dskip"], a["pack"],
             64, DIL, proj)
    got = ks.stack_bwd(*bargs)
    torch.cuda.synchronize()
    assert ks.launch_counts["stack_bwd_f32"] == before["stack_bwd_f32"] + 1
    assert ks.launch_counts["stack_bwd"] == before["stack_bwd"]
    want = sk.stack_bwd_plain(*bargs)
    names = ("dtab", "dctx", "db_fg", "dw_fg", "dw_out", "db_out",
             "dwup_aug")
    for name, x, y in zip(names, got, want):
        if y is None:
            assert x is None, name
            continue
        assert x.dtype == torch.float32, name
        x, y = x.cpu().numpy(), y.cpu().numpy()
        np.testing.assert_allclose(x, y, rtol=0,
                                   atol=1e-4 * np.abs(y).max(), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,ctx_kind", [(64, 64, "proj"), (64, 8, "proj"),
                                          (32, 8, "flat"), (16, 8, None)])
def test_stack_f32_kernels_repeat_bit_equal(cuda, r, s, ctx_kind):
    """Two calls of each float32 form on the same inputs give the same
    bits."""
    a, ctx, proj, batch = _inputs(cuda, 1280, r, s, 64, ctx_kind,
                                  dtype=torch.float32)
    args = (a["pack"], a["table2"], ctx, a["b_fg"], a["w_fg"], a["w_out"],
            a["b_out"], DIL, batch)
    first, second = ks.stack_fwd(*args), ks.stack_fwd(*args)
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    bargs = (first[1], first[2], ctx, a["w_fg"], a["w_out"], a["dskip"],
             a["pack"], 64, DIL, proj)
    for x, y in zip(ks.stack_bwd(*bargs), ks.stack_bwd(*bargs)):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.cuda
def test_f32_smem_mirrors_the_library(cuda):
    """ops/cuda/stack_kernel.f32_smem gives the library's own sizes of
    every float32 launch, and every one fits a block."""
    lib = ks.library()
    for r, s in ks.WIDTHS:
        for win in (2 * r, 3 * r):
            want = ks.f32_smem(r, s, win)
            got = {"layer_fwd": lib.movenet_stack_layer_smem(r, s, 3),
                   "layer_bwd": lib.movenet_stack_bwd_smem(r, s, win, -3),
                   "layer_bwd_rc": lib.movenet_stack_bwd_smem(r, s, win,
                                                              -4),
                   "wgrad_fg": lib.movenet_stack_bwd_smem(r, s, win, 4),
                   "wgrad_out": lib.movenet_stack_bwd_smem(r, s, win, 6),
                   "wgrad_up": lib.movenet_stack_bwd_smem(r, s, win, 5)}
            assert got == want, (r, s, win)
            assert max(got.values()) <= ks.SMEM_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("r,s", [(64, 64), (16, 8), (32, 8), (64, 8)])
def test_stack_bwd_is_deterministic(cuda, r, s):
    """Two backward calls on the same inputs give the same bits (the
    table gradient adds each column's rows in order): a resumed run then
    trains as an uninterrupted one."""
    a, ctx, proj, batch = _inputs(cuda, 1280, r, s, 64, "proj")
    args = (a["pack"], a["table2"], ctx, a["b_fg"], a["w_fg"], a["w_out"],
            a["b_out"], DIL, batch)
    _, hsave, tfsg = sk.stack_fwd_plain(*args)
    bargs = (hsave, tfsg, ctx, a["w_fg"], a["w_out"], a["dskip"], a["pack"],
             64, DIL, proj)
    first = ks.stack_bwd(*bargs)
    second = ks.stack_bwd(*bargs)
    for x, y in zip(first, second):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.cuda
def test_stack_head_bwd_is_deterministic(cuda):
    """The merged route's backward (the head launch, then the layer sweep
    from its float32 dskip) gives the same bits twice."""
    r, s, c, t, batch, rf = 64, 64, 64, 1280, 2, 15
    g = torch.Generator().manual_seed(1)
    n_layers, win, bf = len(DIL), 3 * r, torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(cuda)

    codes = torch.randint(0, c, (batch, t), generator=g, dtype=torch.int32)
    tgt = torch.roll(codes, -1, 1).t().contiguous().to(cuda)
    ctx = rn(batch, t, r, scale=0.5).to(bf)
    w_fg = rn(n_layers, win, 2 * r, scale=win ** -0.5)
    w_out = rn(n_layers, r, r + s, scale=r ** -0.5)
    head = (rn(s, c, scale=s ** -0.5), rn(c, scale=0.1),
            rn(c, c, scale=c ** -0.5), rn(c, scale=0.1))
    args = (rn(batch, t, r, scale=0.5).to(bf), ctx,
            rn(n_layers * batch, 2 * r, scale=0.1), w_fg, w_out,
            rn(n_layers, r + s, scale=0.1), tgt, *head, DIL, rf, True)
    _, _, skip, hsave, tfsg = sk.stack_head_fwd_plain(*args)
    dloss = torch.tensor(1.0 / (batch * (t - rf)), device=cuda)
    bargs = (hsave, tfsg, ctx, w_fg, w_out, skip, tgt, *head, dloss, DIL,
             rf, True)
    first = ks.stack_head_bwd(*bargs)
    second = ks.stack_head_bwd(*bargs)
    for x, y in zip(first, second):
        assert (x is None and y is None) or torch.equal(x, y)


# layer 8 x stack 2 (sum(d) = 510) and the flagship's layer 10 x stack 3
# (sum(d) = 3069): halos the tiled recompute kernels could not hold
DIL_WIDE = tuple(2 ** i for i in range(8)) * 2
DIL_FLAGSHIP = tuple(2 ** i for i in range(10)) * 3


def _tails_args(dev, t, r, s, has_ctx, dil, batch=2, seed=3,
                dtype=torch.bfloat16):
    """Seeded inputs of the recompute kernels, x, ctx and dskip in
    dtype."""
    g = torch.Generator().manual_seed(seed)
    n, win, bf = len(dil), (3 if has_ctx else 2) * r, dtype

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    x = rn(batch, t, r, scale=0.5).to(bf)
    ctx = rn(batch, t, r, scale=0.5).to(bf) if has_ctx else None
    args = (x, ctx, rn(n * batch, 2 * r, scale=0.1),
            rn(n, win, 2 * r, scale=win ** -0.5),
            rn(n, r, r + s, scale=r ** -0.5), rn(n, r + s, scale=0.1), dil)
    return args, rn(batch, t, s, scale=0.1).to(bf)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,t,has_ctx,dil", [
    (16, 16, 1280, False, DIL_WIDE), (32, 32, 1280, True, DIL_WIDE),
    (64, 64, 1280, True, DIL_WIDE), (64, 8, 1280, False, DIL_WIDE),
    (32, 8, 1280, False, DIL_WIDE), (16, 8, 1280, True, DIL_WIDE),
    (64, 8, 1000, True, DIL), (64, 64, 3200, False, DIL_FLAGSHIP),
    (128, 128, 1280, True, DIL_WIDE), (128, 8, 1000, False, DIL),
    (128, 128, 3200, True, DIL_FLAGSHIP), (128, 8, 1280, True, DIL_WIDE),
])
def test_tails_kernels_match_plain(cuda, r, s, t, has_ctx, dil):
    """The recompute kernels against their plain versions at the eight
    built (R, S) pairs (the wide ones, R = 128, stream their weights), at L
    = 16 (sum(d) = 510) and the flagship's dilations (sum(d) = 3069).  The
    forward as the save forward (2% of scale); the backward rebuilds h with
    its own float32 sums, so a rebuilt bf16 value may sit one step from the
    plain version's: the gradients within 1e-2 of their scale, dx and dctx
    (bf16) within 2%."""
    args, dskip = _tails_args(cuda, t, r, s, has_ctx, dil)
    before = dict(ks.launch_counts)
    got = ks.stack_fwd_tails(*args)
    torch.cuda.synchronize()
    assert ks.launch_counts["stack_fwd_tails"] == \
        before["stack_fwd_tails"] + 1
    want = sk.stack_fwd_tails_plain(*args)
    assert got[1].shape == want[1].shape == (
        len(sk.ckpt_layers(len(dil), sk.tails_every(len(dil)))),
        *args[0].shape)
    for name, u, w in zip(("skip", "ckpt"), got, want):
        u, w = u.float().cpu().numpy(), w.float().cpu().numpy()
        np.testing.assert_allclose(u, w, rtol=0, atol=2e-2 * np.abs(w).max(),
                                   err_msg=name)
    bargs = (args[0], want[1], *args[1:-1], dskip, dil)
    got = ks.stack_bwd_tails(*bargs)
    torch.cuda.synchronize()
    assert ks.launch_counts["stack_bwd_tails"] == \
        before["stack_bwd_tails"] + 1
    want = sk.stack_bwd_tails_plain(*bargs)
    for name, u, w in zip(("dx", "dctx", "db_fg", "dw_fg", "dw_out",
                           "db_out"), got, want):
        if w is None:
            assert u is None, name
            continue
        u, w = u.float().cpu().numpy(), w.float().cpu().numpy()
        tol = (2e-2 if name in ("dx", "dctx") else 1e-2) * np.abs(w).max()
        np.testing.assert_allclose(u, w, rtol=0, atol=tol, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,has_ctx,dil", [
    (64, 8, True, DIL_WIDE), (64, 64, False, DIL_FLAGSHIP),
    (16, 8, False, DIL_WIDE), (128, 128, True, DIL_FLAGSHIP),
    (128, 8, False, DIL_WIDE),
])
def test_tails_rebuild_is_bit_equal_to_the_forward(cuda, r, s, has_ctx,
                                                   dil):
    """The forward with a checkpoint at every layer keeps every layer
    input, and its default checkpoints are the same bits.  The backward
    from every layer's input (no rebuild) and the default backward (each
    group rebuilt from its checkpoint by the same layer kernel) give the
    same bits: the rebuild is the forward, bit for bit."""
    args, dskip = _tails_args(cuda, 1600, r, s, has_ctx, dil)
    n = len(dil)
    lib = ks.library()
    skip, every_layer = ks.run_fwd_tails(lib, *args, every=1)
    assert every_layer.shape[0] == n - 1
    skip_k, ckpt = ks.run_fwd_tails(lib, *args)
    assert torch.equal(skip_k, skip)
    for i, l in enumerate(sk.ckpt_layers(n, sk.tails_every(n))):
        assert torch.equal(ckpt[i], every_layer[l - 1])
    tail = (*args[1:-1], dskip, dil)
    no_rebuild = ks.run_bwd_tails(lib, args[0], every_layer, *tail, every=1)
    rebuilt = ks.run_bwd_tails(lib, args[0], ckpt, *tail)
    for u, v in zip(no_rebuild, rebuilt):
        assert (u is None and v is None) or torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,has_ctx", [(64, 8, True), (64, 64, False),
                                         (32, 8, False), (128, 128, True),
                                         (128, 8, False)])
def test_tails_kernels_are_deterministic(cuda, r, s, has_ctx):
    """Two forward and two backward calls on the same inputs give the same
    bits (fixed fragment ownership, fixed-order reductions)."""
    args, dskip = _tails_args(cuda, 1280, r, s, has_ctx, DIL_WIDE)
    first = ks.stack_fwd_tails(*args)
    second = ks.stack_fwd_tails(*args)
    for u, v in zip(first, second):
        assert torch.equal(u, v)
    bargs = (args[0], first[1], *args[1:-1], dskip, args[-1])
    first = ks.stack_bwd_tails(*bargs)
    second = ks.stack_bwd_tails(*bargs)
    for u, v in zip(first, second):
        assert (u is None and v is None) or torch.equal(u, v)


@pytest.mark.cuda
def test_tails_wrapper_rejects_wrong_inputs(cuda):
    args, dskip = _tails_args(cuda, 1280, 16, 16, True, DIL)
    x = args[0]
    with pytest.raises(ValueError, match="bfloat16"):
        ks.stack_fwd_tails(x.float(), *args[1:])
    _, ckpt = ks.stack_fwd_tails(*args)
    with pytest.raises(ValueError, match="ckpt"):
        ks.stack_bwd_tails(x, ckpt[:0], *args[1:-1], dskip, args[-1])
    with pytest.raises(NotImplementedError, match="built"):
        n = len(DIL)
        ks.stack_fwd_tails(x, args[1], args[2], args[3],
                           torch.zeros(n, 16, 20, device=cuda),
                           torch.zeros(n, 20, device=cuda), DIL)


# the float32 recompute forms at the six built (R, S) pairs with and
# without ctx, and the flagship's widths and dilations
TAILS_F32_CASES = [
    (16, 16, 1280, False, DIL_WIDE), (16, 16, 1280, True, DIL_WIDE),
    (32, 32, 1280, True, DIL_WIDE), (32, 32, 1280, False, DIL_WIDE),
    (64, 64, 1280, True, DIL_WIDE), (64, 64, 1280, False, DIL_WIDE),
    (64, 8, 1280, False, DIL_WIDE), (64, 8, 1000, True, DIL),
    (32, 8, 1280, False, DIL_WIDE), (32, 8, 1280, True, DIL_WIDE),
    (16, 8, 1280, True, DIL_WIDE), (16, 8, 1000, False, DIL),
    (64, 64, 3200, True, DIL_FLAGSHIP),
    # the wide forms (R = 128: the weights through a ring of slabs, a taps
    # launch before each layer launch of the backward)
    (128, 128, 1280, True, DIL_WIDE), (128, 128, 1000, False, DIL),
    (128, 8, 1280, True, DIL_WIDE), (128, 8, 1000, False, DIL),
    (128, 128, 3200, True, DIL_FLAGSHIP),
]


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,t,has_ctx,dil", TAILS_F32_CASES)
def test_tails_kernels_match_plain_f32(cuda, r, s, t, has_ctx, dil):
    """The float32 recompute kernels against their plain versions (TF32
    off): skip and the checkpoints within 1e-5 of their scale, then from
    the plain checkpoints dx, dctx and every weight gradient within 1e-4
    of theirs; counted apart from the bf16 forms."""
    args, dskip = _tails_args(cuda, t, r, s, has_ctx, dil,
                              dtype=torch.float32)
    before = dict(ks.launch_counts)
    got = ks.stack_fwd_tails(*args)
    torch.cuda.synchronize()
    assert ks.launch_counts["stack_fwd_tails_f32"] == \
        before["stack_fwd_tails_f32"] + 1
    assert ks.launch_counts["stack_fwd_tails"] == before["stack_fwd_tails"]
    want = sk.stack_fwd_tails_plain(*args)
    for name, u, w in zip(("skip", "ckpt"), got, want):
        assert u.dtype == torch.float32 and u.shape == w.shape, name
        if not w.numel():
            continue
        u, w = u.cpu().numpy(), w.cpu().numpy()
        np.testing.assert_allclose(u, w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
    bargs = (args[0], want[1], *args[1:-1], dskip, dil)
    got = ks.stack_bwd_tails(*bargs)
    torch.cuda.synchronize()
    assert ks.launch_counts["stack_bwd_tails_f32"] == \
        before["stack_bwd_tails_f32"] + 1
    assert ks.launch_counts["stack_bwd_tails"] == before["stack_bwd_tails"]
    want = sk.stack_bwd_tails_plain(*bargs)
    for name, u, w in zip(("dx", "dctx", "db_fg", "dw_fg", "dw_out",
                           "db_out"), got, want):
        if w is None:
            assert u is None, name
            continue
        assert u.dtype == torch.float32, name
        u, w = u.cpu().numpy(), w.cpu().numpy()
        np.testing.assert_allclose(u, w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,has_ctx,dil", [
    (64, 64, True, DIL_FLAGSHIP), (64, 8, True, DIL_WIDE),
    (16, 8, False, DIL_WIDE), (32, 32, False, DIL_WIDE),
    (128, 128, True, DIL_FLAGSHIP), (128, 8, False, DIL_WIDE),
])
def test_tails_f32_rebuild_is_bit_equal_to_the_forward(cuda, r, s, has_ctx,
                                                       dil):
    """In float32 as in bf16: the forward with a checkpoint at every layer
    keeps the layer outputs its default checkpoints hold, bit for bit, and
    the backward from every layer's input equals the default backward,
    whose groups the same layer kernel rebuilds."""
    args, dskip = _tails_args(cuda, 1600, r, s, has_ctx, dil,
                              dtype=torch.float32)
    n = len(dil)
    lib = ks.library()
    skip, every_layer = ks.run_fwd_tails(lib, *args, every=1)
    assert every_layer.shape[0] == n - 1
    skip_k, ckpt = ks.run_fwd_tails(lib, *args)
    assert torch.equal(skip_k, skip)
    for i, l in enumerate(sk.ckpt_layers(n, sk.tails_every(n))):
        assert torch.equal(ckpt[i], every_layer[l - 1])
    tail = (*args[1:-1], dskip, dil)
    no_rebuild = ks.run_bwd_tails(lib, args[0], every_layer, *tail, every=1)
    rebuilt = ks.run_bwd_tails(lib, args[0], ckpt, *tail)
    for u, v in zip(no_rebuild, rebuilt):
        assert (u is None and v is None) or torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,has_ctx", [(64, 64, True), (64, 8, False),
                                         (16, 16, True), (128, 128, True),
                                         (128, 8, False)])
def test_tails_f32_kernels_repeat_bit_equal(cuda, r, s, has_ctx):
    """Two calls of each float32 recompute form give the same bits."""
    args, dskip = _tails_args(cuda, 1280, r, s, has_ctx, DIL_WIDE,
                              dtype=torch.float32)
    first, second = ks.stack_fwd_tails(*args), ks.stack_fwd_tails(*args)
    for u, v in zip(first, second):
        assert torch.equal(u, v)
    bargs = (args[0], first[1], *args[1:-1], dskip, args[-1])
    for u, v in zip(ks.stack_bwd_tails(*bargs), ks.stack_bwd_tails(*bargs)):
        assert (u is None and v is None) or torch.equal(u, v)


def _digest(outs):
    import hashlib

    h = hashlib.sha256()
    for o in outs:
        if o is not None:
            h.update(o.contiguous().cpu().view(torch.uint8).numpy()
                     .tobytes())
    return h.hexdigest()[:32]


def _save_digests(kmod, lib, r, s, ctx_kind):
    """(forward, backward) sha256 digests of the save kernels' outputs on
    inputs made with numpy from fixed seeds: the same bits give the same
    digests on any card that runs the same kernels.  The forward's: with
    the embedding and from x.  The backward's (with the projection triple
    or the flat ctx, and the non-embed form): on saved tensors hsave and
    tfsg drawn with numpy too, so that it does not move with the forward
    kernel."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(11)
    t, batch, v, n = 1280, 2, 64, len(DIL)
    win = (3 if ctx_kind else 2) * r

    def rn(*shape, scale=1.0, gen=rng):
        return torch.from_numpy((gen.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev)

    codes = rng.integers(0, v, size=(batch, t)).astype(np.int32)
    prev = np.concatenate([np.full((batch, 1), -1, np.int32),
                           codes[:, :-1]], 1)
    pack = torch.from_numpy(np.ascontiguousarray(
        np.concatenate([codes, prev], 0).T)).to(dev)
    table2 = rn(2 * v, r, scale=0.5).to(bf)
    w = (rn(n * batch, 2 * r, scale=0.1), rn(n, win, 2 * r, scale=0.1),
         rn(n, r, r + s, scale=0.1), rn(n, r + s, scale=0.1))
    proj = ctx = None
    if ctx_kind == "proj":
        trip = (rn(batch, t // 10, r, scale=0.5).to(bf),
                rn(r, 10 * r, scale=0.1), rn(10 * r, scale=0.1))
        ctx = sk.ctx_flatten(trip, bf)
        proj = sk._ctx_proj_args(trip)
    elif ctx_kind == "flat":
        ctx = rn(batch, t, r, scale=0.5).to(bf)
    dskip = rn(batch, t, s, scale=0.1).to(bf)
    fwd = kmod.run_fwd(lib, pack, table2, ctx, *w, DIL, batch)
    x = sk.front_embed(table2[:v], table2[v:],
                       pack[:, :batch].t().contiguous(), bf)
    fwd += tuple(kmod.run_fwd_x(lib, x, ctx, *w, DIL))
    saved = np.random.default_rng(12)
    hsave = rn(n, batch, t, r, scale=0.5, gen=saved).to(bf)
    tfsg = torch.cat([torch.tanh(rn(n, batch, t, r, gen=saved)),
                      torch.sigmoid(rn(n, batch, t, r, gen=saved))],
                     -1).to(bf)
    bwd = tuple(kmod.run_bwd(lib, hsave, tfsg, ctx, w[1], w[2], dskip, pack,
                             v, DIL, proj))
    bwd += tuple(kmod.run_bwd_x(lib, hsave, tfsg, ctx, w[1], w[2], dskip,
                                DIL))
    torch.cuda.synchronize()
    return _digest(fwd), _digest(bwd)


# the save kernels' (forward, backward) digests on an NVIDIA H100 80GB
# HBM3: the forward's as the layer kernel on the tensor cores gives them,
# the backward's as both it and the source before it give them
SAVE_DIGESTS = {
    (64, 64, "proj"): ("08414367ff0e52be99e93edcf40a3b75",
                       "2cf5537bc8bf61915fb90003ff76790d"),
    (64, 8, "flat"): ("bbeaee2e88b2d75d79a9c13f615c0f7d",
                      "ee05138a8efa3d8e9324790b49dc59a6"),
    (16, 8, None): ("99965dcd7fef44d3c9f765b22fe0145a",
                    "73cde4796c525f61d4a7b3f1d255bcb2"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,ctx_kind", list(SAVE_DIGESTS))
def test_save_kernels_keep_their_bits(cuda, r, s, ctx_kind):
    """The save kernels (embed and non-embed forward, backward), which
    share code with the recompute kernels, give the bits they gave when
    their digests were recorded."""
    assert _save_digests(ks, ks.library(), r, s, ctx_kind) == \
        SAVE_DIGESTS[(r, s, ctx_kind)]


@pytest.mark.cuda
def test_stack_wrapper_rejects_wrong_inputs(cuda):
    a, ctx, _, batch = _inputs(cuda, 1280, 16, 16, 64, None)
    # mixed activation dtypes raise, naming the tensors
    bf_ctx = torch.zeros(batch, 1280, 16, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="table2 torch.float32, ctx "
                                         "torch.bfloat16"):
        ks.stack_fwd(a["pack"], a["table2"].float(), bf_ctx, a["b_fg"],
                     a["w_fg"], a["w_out"], a["b_out"], DIL, batch)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        ks.stack_fwd(a["pack"], a["table2"].double(), None, a["b_fg"],
                     a["w_fg"], a["w_out"], a["b_out"], DIL, batch)
    _, hsave, tfsg = sk.stack_fwd_plain(
        a["pack"], a["table2"].float(), None, a["b_fg"], a["w_fg"],
        a["w_out"], a["b_out"], DIL, batch)
    with pytest.raises(ValueError, match="tfsg torch.bfloat16"):
        ks.stack_bwd(hsave, tfsg.bfloat16(), None, a["w_fg"], a["w_out"],
                     a["dskip"].float(), a["pack"], 64, DIL)
    with pytest.raises(ValueError, match="dskip torch.bfloat16"):
        ks.stack_bwd(hsave, tfsg, None, a["w_fg"], a["w_out"], a["dskip"],
                     a["pack"], 64, DIL)
    # the float32 forms not built yet raise with their ROADMAP item
    x = torch.zeros(batch, 1280, 16, device=cuda)
    with pytest.raises(ValueError, match=r"B.2/B.4 \(3\)"):
        ks.stack_head_fwd(x, None, a["b_fg"], a["w_fg"], a["w_out"],
                          a["b_out"], a["pack"][:, :batch].contiguous(),
                          torch.zeros(16, 16, device=cuda),
                          torch.zeros(16, device=cuda),
                          torch.zeros(16, 16, device=cuda),
                          torch.zeros(16, device=cuda), DIL, 15, True)
    with pytest.raises(ValueError, match="b_fg"):
        ks.stack_fwd(a["pack"], a["table2"], None, a["b_fg"].double(),
                     a["w_fg"], a["w_out"], a["b_out"], DIL, batch)
    with pytest.raises(NotImplementedError, match="built"):
        w_out = torch.zeros(len(DIL), 16, 20, device=cuda)
        b_out = torch.zeros(len(DIL), 20, device=cuda)
        ks.stack_fwd(a["pack"], a["table2"], None, a["b_fg"], a["w_fg"],
                     w_out, b_out, DIL, batch)


# ------------------------------------------------------------ replay
def _replay_args(dev, t, r, s, ctx_kind, dil, dtype, batch=2, seed=5):
    """Seeded inputs of the replay kernels, the activations in dtype: the
    forward's (x, flat ctx or None, b_fg, w_fg, w_out, b_out, dil), dskip
    and the projection's (xc, wup_t) where ctx_kind is "proj"."""
    g = torch.Generator().manual_seed(seed)
    n, win = len(dil), (3 if ctx_kind else 2) * r

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    x = rn(batch, t, r, scale=0.5).to(dtype)
    ctx = proj = None
    if ctx_kind == "flat":
        ctx = rn(batch, t, r, scale=0.5).to(dtype)
    elif ctx_kind == "proj":
        trip = (rn(batch, t // 10, r, scale=0.5).to(dtype),
                rn(r, 10 * r, scale=r ** -0.5), rn(10 * r, scale=0.1))
        ctx = sk.ctx_flatten(trip, dtype)
        proj = tuple(v.to(dev) for v in sk._ctx_proj_args(trip))
    w = (rn(n * batch, 2 * r, scale=0.1), rn(n, win, 2 * r, scale=win ** -0.5),
         rn(n, r, r + s, scale=r ** -0.5), rn(n, r + s, scale=0.1))
    dskip = rn(batch, t, s, scale=0.1).to(dtype)
    args = (x.to(dev), None if ctx is None else ctx.to(dev),
            *(v.to(dev) for v in w), dil)
    return args, dskip.to(dev), proj


# experiment 04's trunk (layer_size 14, stack 1: L = 14, groups of 4, the
# last of 2) and L = 13 (groups of 4, the last of one layer)
DIL_EXP04 = tuple(2 ** i for i in range(14))
DIL_13 = DIL_EXP04[:13]
# the replay forms at the six built (R, S) pairs with each ctx form, at
# L = 6 (groups of 3), at the flagship's L = 30 (groups of 6) and with a
# short last group at L = 14 and 13
REPLAY_CASES = [
    (16, 16, 1280, None, DIL), (16, 16, 1280, "flat", DIL),
    (32, 32, 2000, "proj", DIL), (64, 64, 3200, "proj", DIL),
    (64, 8, 1000, "flat", DIL), (64, 8, 1280, "proj", DIL),
    (32, 8, 1280, "proj", DIL), (16, 8, 1280, "proj", DIL),
    (16, 8, 1000, None, DIL), (64, 64, 1600, None, DIL_FLAGSHIP),
    (64, 8, 1600, "flat", DIL_FLAGSHIP), (16, 8, 20000, "proj", DIL_EXP04),
    (16, 8, 10000, "flat", DIL_13),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("r,s,t,ctx_kind,dil", REPLAY_CASES)
def test_replay_kernels_match_plain(cuda, r, s, t, ctx_kind, dil, dtype):
    """The replay kernels against their plain versions: skip, tfsg and
    the float32 checkpoints as the save forward's outputs (bf16: 2% of
    scale, float32: 1e-5); then from the plain checkpoints and taps every
    gradient as the save backward's (1e-4 of scale; the bf16 dx and dctx
    2%); counted by dtype."""
    args, dskip, proj = _replay_args(cuda, t, r, s, ctx_kind, dil, dtype)
    f32 = dtype == torch.float32
    sfx = "_f32" if f32 else ""
    before = dict(ks.launch_counts)
    got = ks.stack_fwd_replay(*args)
    torch.cuda.synchronize()
    want = sk.stack_fwd_replay_plain(*args)
    for name, u, w in zip(("skip", "ckpt", "tfsg"), got, want):
        assert u.shape == w.shape and u.dtype == w.dtype, name
        u, w = u.float().cpu().numpy(), w.float().cpu().numpy()
        np.testing.assert_allclose(
            u, w, rtol=0, atol=(1e-5 if f32 else 2e-2) * np.abs(w).max(),
            err_msg=name)
    bargs = (args[0], want[1], want[2], args[1], args[3], args[4], args[5],
             dskip, dil, proj)
    got = ks.stack_bwd_replay(*bargs)
    torch.cuda.synchronize()
    for k in ("stack_fwd_replay", "stack_bwd_replay"):
        assert ks.launch_counts[k + sfx] == before[k + sfx] + 1, k
    want = sk.stack_bwd_replay_plain(*bargs)
    for name, u, w in zip(("dx", "dctx", "db_fg", "dw_fg", "dw_out",
                           "db_out", "dwup_aug"), got, want):
        if w is None:
            assert u is None, name
            continue
        assert u.dtype == w.dtype, name
        u, w = u.float().cpu().numpy(), w.float().cpu().numpy()
        bar = 2e-2 if name in ("dx", "dctx") and not f32 else 1e-4
        np.testing.assert_allclose(u, w, rtol=0, atol=bar * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("r,s,t,ctx_kind,dil", REPLAY_CASES)
def test_replay_is_the_save_strategy_bit_for_bit(cuda, r, s, t, ctx_kind,
                                                 dil, dtype):
    """The replay kernels against the save kernels' non-embed form on the
    same x: the forward's skip and tfsg equal, each checkpoint the save
    forward's layer input (in bf16 once rounded), every layer input as the
    backward rebuilds it (float32) the checkpoints at their layers and,
    rounded, hsave, and the backward's outputs equal the save backward's,
    but for dW_fg in bf16, which takes the float32 h (JAX's replay): that
    one within 1e-4 of its scale of the plain replay backward's; two calls
    of each give the same bits."""
    args, dskip, proj = _replay_args(cuda, t, r, s, ctx_kind, dil, dtype)
    lib, n = ks.library(), len(dil)
    skip, hsave, tfsg = ks.run_fwd_x(lib, *args)
    got = ks.run_fwd_replay(lib, *args)
    assert torch.equal(got[0], skip) and torch.equal(got[2], tfsg)
    ckpt = got[1]
    layers = sk.ckpt_layers(n, sk.tails_every(n))
    for i, l in enumerate(layers):
        assert torch.equal(ckpt[i].to(dtype), hsave[l]), l
    rebuilt = ks.run_replay_inputs(lib, args[0], ckpt, tfsg, args[4],
                                   args[5])
    assert rebuilt.dtype == torch.float32
    for l in range(n):
        assert torch.equal(rebuilt[l].to(dtype), hsave[l]), l
    for i, l in enumerate(layers):
        assert torch.equal(rebuilt[l], ckpt[i]), l
    for u, v in zip(got, ks.run_fwd_replay(lib, *args)):
        assert torch.equal(u, v)
    tail = (args[1], args[3], args[4])
    save = ks.run_bwd_x(lib, hsave, tfsg, *tail, dskip, dil, proj)
    bargs = (args[0], ckpt, tfsg, *tail, args[5], dskip, dil, proj)
    first = ks.run_bwd_replay(lib, *bargs)
    second = ks.run_bwd_replay(lib, *bargs)
    for i, (u, v, w) in enumerate(zip(first, second, save)):
        if u is None:
            assert w is None, i
            continue
        assert torch.equal(u, v), i
        if i == 3 and dtype == torch.bfloat16:
            want = sk.stack_bwd_replay_plain(*bargs)[3]
            np.testing.assert_allclose(
                u.cpu().numpy(), want.cpu().numpy(), rtol=0,
                atol=1e-4 * float(want.abs().max()), err_msg="dw_fg")
        else:
            assert torch.equal(u, w), i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("every", [1, len(DIL)])
def test_replay_group_size_keeps_the_bits(cuda, every, dtype):
    """The replay kernels with ``every`` = 1 (a checkpoint at every layer
    input: each group one layer, no rebuild) and = L (one group, no
    checkpoint, every layer rebuilt from x): the checkpoints are the save
    forward's layer inputs, the rebuilt inputs (rounded) its hsave and the
    backward's outputs the save backward's, bit for bit, but for dW_fg in
    bf16, which is the default groups' bit for bit (the float32 layer
    inputs do not depend on the grouping)."""
    args, dskip, proj = _replay_args(cuda, 1280, 32, 8, "proj", DIL, dtype)
    lib, n = ks.library(), len(DIL)
    skip, hsave, tfsg = ks.run_fwd_x(lib, *args)
    got_skip, ckpt, got_tfsg = ks.run_fwd_replay(lib, *args, every=every)
    assert torch.equal(got_skip, skip) and torch.equal(got_tfsg, tfsg)
    assert ckpt.shape[0] == len(sk.ckpt_layers(n, every))
    for i, l in enumerate(sk.ckpt_layers(n, every)):
        assert torch.equal(ckpt[i].to(dtype), hsave[l]), l
    rebuilt = ks.run_replay_inputs(lib, args[0], ckpt, tfsg, args[4],
                                   args[5], every=every)
    assert torch.equal(rebuilt.to(dtype), hsave)
    tail = (args[1], args[3], args[4])
    save = ks.run_bwd_x(lib, hsave, tfsg, *tail, dskip, DIL, proj)
    got = ks.run_bwd_replay(lib, args[0], ckpt, tfsg, *tail, args[5], dskip,
                            DIL, proj, every=every)
    _, ckpt0, _ = ks.run_fwd_replay(lib, *args)
    default = ks.run_bwd_replay(lib, args[0], ckpt0, tfsg, *tail, args[5],
                                dskip, DIL, proj)
    for i, (u, w) in enumerate(zip(got, save)):
        if i == 3 and dtype == torch.bfloat16:
            w = default[3]
        assert (u is None and w is None) or torch.equal(u, w), i


# the bf16 replay forms at the wide pairs (R = 128: the wide save forward's
# launches, the rebuild at R = 128 and the wide save backward's grids), with
# each ctx form, at L = 6 and the flagship's L = 30
WIDE_REPLAY_CASES = [
    (128, 128, 1280, "proj", DIL), (128, 128, 1000, None, DIL),
    (128, 8, 1280, "flat", DIL), (128, 8, 1280, "proj", DIL),
    (128, 128, 1600, "flat", DIL_FLAGSHIP),
]


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,t,ctx_kind,dil", WIDE_REPLAY_CASES)
def test_wide_replay_kernels_match_plain(cuda, r, s, t, ctx_kind, dil):
    """test_replay_kernels_match_plain at the wide pairs, in bf16."""
    test_replay_kernels_match_plain(cuda, r, s, t, ctx_kind, dil,
                                    torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,t,ctx_kind,dil", WIDE_REPLAY_CASES)
def test_wide_replay_is_the_save_strategy_bit_for_bit(cuda, r, s, t,
                                                      ctx_kind, dil):
    """test_replay_is_the_save_strategy_bit_for_bit at the wide pairs, in
    bf16: the rebuild at R = 128 follows the wide save forward's residual
    chain."""
    test_replay_is_the_save_strategy_bit_for_bit(cuda, r, s, t, ctx_kind,
                                                 dil, torch.bfloat16)


@pytest.mark.cuda
def test_replay_wrapper_rejects_wrong_inputs(cuda):
    args, dskip, _ = _replay_args(cuda, 1280, 16, 16, "flat", DIL,
                                  torch.bfloat16)
    x, ctx = args[0], args[1]
    with pytest.raises(ValueError, match="ctx is torch.bfloat16"):
        ks.stack_fwd_replay(x.float(), *args[1:])
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        ks.stack_fwd_replay(x.half(), None, *args[2:])
    _, ckpt, tfsg = ks.stack_fwd_replay(*args)
    tail = (ctx, args[3], args[4], args[5])
    with pytest.raises(ValueError, match="ckpt"):
        ks.stack_bwd_replay(x, ckpt[:0], tfsg, *tail, dskip, DIL)
    with pytest.raises(ValueError, match="dskip is torch.float32"):
        ks.stack_bwd_replay(x, ckpt, tfsg, *tail, dskip.float(), DIL)
    with pytest.raises(ValueError, match="tfsg is torch.float32"):
        ks.stack_bwd_replay(x, ckpt, tfsg.float(), *tail, dskip, DIL)


# ----------------------------------------------------- the wide widths
# (R, S) = (128, 128), the model of scripts/probe_r128_mfu.py, and (128, 8),
# experiment 02 at --residual_channels 128: the bf16 save forms only.  The
# forward keeps the narrow form's tie re-sums and residual chain, so its
# bars are the narrow form's (2% of each output's scale); the backward
# takes the plain version's saved tensors at the narrow form's 1e-4.
WIDE_CASES = [(128, 128, 1280, "proj"), (128, 128, 1000, None),
              (128, 8, 1280, "flat"), (128, 8, 1280, "proj")]


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,t,ctx_kind", WIDE_CASES)
def test_wide_stack_kernels_match_plain(cuda, r, s, t, ctx_kind):
    a, ctx, proj, batch = _inputs(cuda, t, r, s, 64, ctx_kind)
    args = (a["pack"], a["table2"], ctx, a["b_fg"], a["w_fg"], a["w_out"],
            a["b_out"], DIL, batch)
    before = dict(ks.launch_counts)
    got = ks.stack_fwd(*args)
    torch.cuda.synchronize()
    assert ks.launch_counts["stack_fwd"] == before["stack_fwd"] + 1
    want = sk.stack_fwd_plain(*args)
    for name, x, y in zip(("skip", "hsave", "tfsg"), got, want):
        x, y = x.float().cpu().numpy(), y.float().cpu().numpy()
        np.testing.assert_allclose(x, y, rtol=0,
                                   atol=2e-2 * np.abs(y).max(), err_msg=name)
    hsave, tfsg = want[1], want[2]
    bargs = (hsave, tfsg, ctx, a["w_fg"], a["w_out"], a["dskip"], a["pack"],
             64, DIL, proj)
    got = ks.stack_bwd(*bargs)
    torch.cuda.synchronize()
    assert ks.launch_counts["stack_bwd"] == before["stack_bwd"] + 1
    want = sk.stack_bwd_plain(*bargs)
    names = ("dtab", "dctx", "db_fg", "dw_fg", "dw_out", "db_out",
             "dwup_aug")
    for name, x, y in zip(names, got, want):
        if y is None:
            assert x is None, name
            continue
        x, y = x.float().cpu().numpy(), y.float().cpu().numpy()
        tol = (2e-2 if name == "dctx" else 1e-4) * np.abs(y).max()
        np.testing.assert_allclose(x, y, rtol=0, atol=tol, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s", [(128, 128), (128, 8)])
def test_wide_table_gradient_at_2v_512(cuda, r, s):
    """The save backward's table gradient at R = 128 with 2V = 512, the
    embed form's largest table (the flagship's C = 256 at R = 128): a (2V,
    R) float32 table passes a block's shared memory, so each block takes a
    slab of the columns.  Against the plain version, and two calls
    bit-equal."""
    t, v = 1280, 256
    a, ctx, proj, batch = _inputs(cuda, t, r, s, v, "proj")
    args = (a["pack"], a["table2"], ctx, a["b_fg"], a["w_fg"], a["w_out"],
            a["b_out"], DIL, batch)
    _, hsave, tfsg = sk.stack_fwd_plain(*args)
    bargs = (hsave, tfsg, ctx, a["w_fg"], a["w_out"], a["dskip"], a["pack"],
             v, DIL, proj)
    got = ks.stack_bwd(*bargs)
    assert all(torch.equal(x, y) for x, y in zip(got, ks.stack_bwd(*bargs)))
    want = sk.stack_bwd_plain(*bargs)
    assert got[0].shape == (2 * v, r)
    for name, x, y in zip(("dtab", "dctx", "db_fg", "dw_fg", "dw_out",
                           "db_out", "dwup_aug"), got, want):
        x, y = x.float().cpu().numpy(), y.float().cpu().numpy()
        tol = (2e-2 if name == "dctx" else 1e-4) * np.abs(y).max()
        np.testing.assert_allclose(x, y, rtol=0, atol=tol, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,ctx_kind", [(128, 128, "flat"), (128, 8, None)])
def test_wide_non_embed_kernels_match_plain(cuda, r, s, ctx_kind):
    """The non-embed save form (x in, dx out) at the wide widths, and two
    calls bit-equal."""
    a, ctx, _, batch = _inputs(cuda, 1280, r, s, 64, ctx_kind)
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(batch, 1280, r, generator=g) * 0.5).to(
        torch.bfloat16).to(cuda)
    args = (x, ctx, a["b_fg"], a["w_fg"], a["w_out"], a["b_out"], DIL)
    got = ks.stack_fwd_x(*args)
    assert all(torch.equal(u, v) for u, v in zip(got, ks.stack_fwd_x(*args)))
    want = sk.stack_fwd_x_plain(*args)
    for name, u, v in zip(("skip", "hsave", "tfsg"), got, want):
        u, v = u.float().cpu().numpy(), v.float().cpu().numpy()
        np.testing.assert_allclose(u, v, rtol=0,
                                   atol=2e-2 * np.abs(v).max(), err_msg=name)
    bargs = (want[1], want[2], ctx, a["w_fg"], a["w_out"], a["dskip"], DIL)
    got = ks.stack_bwd_x(*bargs)
    second = ks.stack_bwd_x(*bargs)
    assert all((u is None and v is None) or torch.equal(u, v)
               for u, v in zip(got, second))
    want = sk.stack_bwd_x_plain(*bargs)
    names = ("dx", "dctx", "db_fg", "dw_fg", "dw_out", "db_out")
    for name, u, v in zip(names, got, want):
        if v is None:
            assert u is None, name
            continue
        u, v = u.float().cpu().numpy(), v.float().cpu().numpy()
        tol = (2e-2 if name in ("dx", "dctx") else 1e-4) * np.abs(v).max()
        np.testing.assert_allclose(u, v, rtol=0, atol=tol, err_msg=name)


@pytest.mark.cuda
def test_family_widths_mirror_the_library(cuda):
    """ops/cuda/stack_kernel.FAMILY_WIDTHS is the library's own list of
    each family (movenet_stack_supports), the wide pairs the bf16 save,
    recompute and replay families' and the float32 recompute family's
    alone; the wide save and recompute launches' shared memory fits a block
    (the recompute forward's layer launch, form 0, and the backward's layer
    launch, kind -2, and its W_out gradient from the float32 gated, kind 3,
    are the recompute forms'; the rebuild, kind -5, and W_fg's gradient in
    its MODE 7, kind 7, the replay backward's; the float32 layer kernel,
    form 3, the layer backward's float32 recompute form, kind -4, and W_fg's
    and W_out's float32 gradients, kinds 4 and 6, the float32 recompute
    forms', equal to ``f32_smem``'s; the bf16 layer backwards, kinds -1 and
    -2, and W_fg's bf16 gradients, kinds 0 and 7, equal to
    ``wide_bwd_smem``'s; the taps launch, form 4, the recompute forward's
    block), and the float32 save form's layer backward has none there."""
    lib = ks.library()
    pairs = {(r, s) for r in (8, 16, 32, 48, 64, 96, 128, 256)
             for s in (4, 8, 16, 32, 64, 128)}
    for i, (family, widths) in enumerate(ks.FAMILY_WIDTHS.items()):
        for r, s in pairs:
            assert bool(lib.movenet_stack_supports(i, r, s)) == \
                ((r, s) in widths), (family, r, s)
    assert not lib.movenet_stack_supports(len(ks.FAMILY_WIDTHS), 16, 16)
    for family in ("save", "recompute", "replay", "recompute_f32"):
        assert set(ks.FAMILY_WIDTHS[family]) - set(ks.WIDTHS) == \
            set(ks.WIDE_WIDTHS), family
    for r, s in ks.WIDE_WIDTHS:
        for form in (0, 1, 3):
            n = lib.movenet_stack_layer_smem(r, s, form)
            assert 0 < n <= ks.SMEM_LIMIT, (r, s, form)
        for win in (2 * r, 3 * r):
            for kind in (-5, -4, -2, -1, 0, 1, 2, 3, 4, 6, 7):
                n = lib.movenet_stack_bwd_smem(r, s, win, kind)
                assert 0 < n <= ks.SMEM_LIMIT, (r, s, win, kind)
            assert lib.movenet_stack_bwd_smem(r, s, win, -3) == -1
            f32 = ks.f32_smem(r, s, win)
            assert lib.movenet_stack_layer_smem(r, s, 3) == f32["layer_fwd"]
            for kind, key in ((-4, "layer_bwd_rc"), (4, "wgrad_fg"),
                              (6, "wgrad_out")):
                assert lib.movenet_stack_bwd_smem(r, s, win, kind) == \
                    f32[key], (r, s, win, kind)
            wide = ks.wide_bwd_smem(r)
            for kind, key in ((-1, "layer_bwd"), (-2, "layer_bwd"),
                              (0, "wgrad_fg"), (7, "wgrad_fg_replay")):
                assert lib.movenet_stack_bwd_smem(r, s, win, kind) == \
                    wide[key], (r, s, win, kind)
            assert lib.movenet_stack_layer_smem(r, s, 4) == \
                lib.movenet_stack_layer_smem(r, s, 0), (r, s)


@pytest.mark.cuda
def test_other_families_raise_at_the_wide_widths(cuda):
    """Every family but the bf16 save, recompute and replay forms and the
    float32 recompute forms raises at R = 128 with its ROADMAP.md item, and
    never falls back to a plain version: the float32 save and replay forms
    (2), merged (3), gated (4); a pair no family takes, (128, 64), raises
    for the save, recompute and replay forms (5)."""
    from movenet_tpu_torch.ops.cuda import gated_block as kg

    r, s, t = 128, 128, 1280
    a, ctx, _, batch = _inputs(cuda, t, r, s, 64, "flat")
    x = torch.zeros(batch, t, r, dtype=torch.bfloat16, device=cuda)
    rest = (ctx, a["b_fg"], a["w_fg"], a["w_out"], a["b_out"], DIL)
    rest32 = (ctx.float(), *rest[1:])
    before = dict(ks.launch_counts)
    with pytest.raises(NotImplementedError, match=r"B\.2 widths \(2\)"):
        ks.stack_fwd_replay(x.float(), *rest32)
    with pytest.raises(NotImplementedError, match=r"B\.2 widths \(2\)"):
        ks.stack_bwd_replay(
            x.float(), torch.zeros(1, batch, t, r, device=cuda),
            torch.zeros(len(DIL), batch, t, 2 * r, device=cuda), ctx.float(),
            a["w_fg"], a["w_out"], a["b_out"], a["dskip"].float(), DIL)
    with pytest.raises(NotImplementedError, match=r"B\.2 widths \(2\)"):
        ks.stack_fwd(a["pack"], a["table2"].float(), ctx.float(), a["b_fg"],
                     a["w_fg"], a["w_out"], a["b_out"], DIL, batch)
    with pytest.raises(NotImplementedError, match=r"B\.2 widths \(2\)"):
        ks.stack_fwd_x(x.float(), ctx.float(), *rest[1:])
    tgt = a["pack"][:, :batch].contiguous()
    with pytest.raises(NotImplementedError, match=r"B\.2 widths \(3\)"):
        ks.stack_head_fwd(x, *rest[:5], tgt,
                          torch.zeros(s, 64, device=cuda),
                          torch.zeros(64, device=cuda),
                          torch.zeros(64, 64, device=cuda),
                          torch.zeros(64, device=cuda), DIL, 15, True)
    with pytest.raises(NotImplementedError, match=r"B\.2 widths \(4\)"):
        kg.gated_block_fwd(x, ctx, a["b_fg"][:batch], a["w_fg"][0],
                           a["w_out"][0], a["b_out"][:1], 1)
    w_out = torch.zeros(len(DIL), r, r + 64, device=cuda)
    b_out = torch.zeros(len(DIL), r + 64, device=cuda)
    with pytest.raises(NotImplementedError, match=r"B\.2 widths \(5\)"):
        ks.stack_fwd(a["pack"], a["table2"], ctx, a["b_fg"], a["w_fg"],
                     w_out, b_out, DIL, batch)
    with pytest.raises(NotImplementedError, match=r"B\.2 widths \(5\)"):
        ks.stack_fwd_tails(x, ctx, a["b_fg"], a["w_fg"], w_out, b_out, DIL)
    with pytest.raises(NotImplementedError, match=r"B\.2 widths \(5\)"):
        ks.stack_fwd_replay(x, ctx, a["b_fg"], a["w_fg"], w_out, b_out, DIL)
    assert ks.launch_counts == before
