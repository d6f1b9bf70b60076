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
pass of TF32 would miss 1e-4 (tests/test_torch_split_tf32.py)."""

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


def _inputs(dev, t, r, s, v, ctx_kind, batch=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    n_layers = len(DIL)
    codes = torch.randint(0, v, (batch, t), generator=g, dtype=torch.int32)
    prev = torch.cat([torch.full((batch, 1), -1, dtype=torch.int32),
                      codes[:, :-1]], 1)
    pack = torch.cat([codes, prev, torch.roll(codes, -1, 1)], 0).t()
    win = (3 if ctx_kind else 2) * r
    bf = torch.bfloat16

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


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,t,has_ctx", [
    (16, 16, 1280, False), (16, 16, 1280, True), (64, 8, 1280, True),
    (64, 8, 640, False), (32, 8, 1280, True), (16, 8, 640, False),
])
def test_tails_kernels_match_plain(cuda, r, s, t, has_ctx):
    """The recompute kernels against their plain versions.  The forward
    as the save forward (2% of scale); the backward rebuilds h with its
    own float32 sums, so a rebuilt bf16 value may sit one step from the
    plain version's: the gradients within 1e-2 of their scale, dx and
    dctx (bf16) within 2%."""
    a, ctx, _, batch = _inputs(cuda, t, r, s, 64, "flat" if has_ctx
                               else None)
    g = torch.Generator().manual_seed(7)
    x = (torch.randn(batch, t, r, generator=g) * 0.5).to(
        torch.bfloat16).to(cuda)
    args = (x, ctx, a["b_fg"], a["w_fg"], a["w_out"], a["b_out"], DIL)
    before = dict(ks.launch_counts)
    got = ks.stack_fwd_tails(*args)
    torch.cuda.synchronize()
    assert ks.launch_counts["stack_fwd_tails"] == \
        before["stack_fwd_tails"] + 1
    want = sk.stack_fwd_tails_plain(*args)
    for name, u, w in zip(("skip", "tails"), got, want):
        u, w = u.float().cpu().numpy(), w.float().cpu().numpy()
        np.testing.assert_allclose(u, w, rtol=0, atol=2e-2 * np.abs(w).max(),
                                   err_msg=name)
    bargs = (x, want[1], ctx, a["b_fg"], a["w_fg"], a["w_out"], a["b_out"],
             a["dskip"], DIL)
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
def test_tails_wrapper_rejects_wrong_inputs(cuda):
    a, ctx, _, batch = _inputs(cuda, 1280, 16, 16, 64, "flat")
    x = torch.zeros(batch, 1280, 16, dtype=torch.bfloat16, device=cuda)
    args = (ctx, a["b_fg"], a["w_fg"], a["w_out"], a["b_out"], DIL)
    with pytest.raises(ValueError, match="bfloat16"):
        ks.stack_fwd_tails(x.float(), *args)
    with pytest.raises(ValueError, match="multiple"):
        ks.stack_fwd_tails(x[:, :1000].contiguous(), ctx[:, :1000]
                           .contiguous(), *args[1:])
    # a halo of sum(d) rows per layer that shared memory cannot hold
    big = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
    n = len(big)
    r = 64
    with pytest.raises(NotImplementedError, match="B.5"):
        ks.stack_fwd_tails(
            torch.zeros(batch, 1280, r, dtype=torch.bfloat16, device=cuda),
            None, torch.zeros(n * batch, 2 * r, device=cuda),
            torch.zeros(n, 2 * r, 2 * r, device=cuda),
            torch.zeros(n, r, r + 8, device=cuda),
            torch.zeros(n, r + 8, device=cuda), big)


@pytest.mark.cuda
def test_stack_wrapper_rejects_wrong_inputs(cuda):
    a, ctx, _, batch = _inputs(cuda, 1280, 16, 16, 64, None)
    with pytest.raises(ValueError, match="bfloat16"):
        ks.stack_fwd(a["pack"], a["table2"].float(), None, a["b_fg"],
                     a["w_fg"], a["w_out"], a["b_out"], DIL, batch)
    with pytest.raises(ValueError, match="b_fg"):
        ks.stack_fwd(a["pack"], a["table2"], None, a["b_fg"].double(),
                     a["w_fg"], a["w_out"], a["b_out"], DIL, batch)
    with pytest.raises(NotImplementedError, match="built"):
        w_out = torch.zeros(len(DIL), 16, 20, device=cuda)
        b_out = torch.zeros(len(DIL), 20, device=cuda)
        ks.stack_fwd(a["pack"], a["table2"], None, a["b_fg"], a["w_fg"],
                     w_out, b_out, DIL, batch)
