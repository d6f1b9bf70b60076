"""The merged trunk + head/CE kernels and the non-embed save form of the
trunk kernels (csrc/stack_kernel.cu) against their plain torch versions
on a CUDA GPU.  Imports only torch and the port:

    python -m pytest tests/test_torch_stack_head_cuda.py -q

Without a card every test skips.  Tolerances: the forward's bf16 outputs
(skip, hsave, tfsg) are sums the kernel and torch add in other orders, so
a stored value may sit one bf16 step away: within 2% of each output's
scale, as the save forward's; the loss sum rtol 1e-5 and the match count
within 10 positions of 2T (first-argmax ties within float32 noise).  The
backward takes the same saved tensors in both versions and sums in
float32: the gradients within 1e-3 of their scale (the merged head's
float32 dskip feeds every layer), dx and dctx (bf16) within 2%."""

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


def _inputs(dev, t, r, s, c, has_ctx, batch=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    n_layers = len(DIL)
    win = (3 if has_ctx else 2) * r
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    codes = torch.randint(0, c, (batch, t), generator=g, dtype=torch.int32)
    a = dict(x=rn(batch, t, r, scale=0.5).to(bf),
             ctx=rn(batch, t, r, scale=0.5).to(bf) if has_ctx else None,
             b_fg=rn(n_layers * batch, 2 * r, scale=0.1),
             w_fg=rn(n_layers, win, 2 * r, scale=win ** -0.5),
             w_out=rn(n_layers, r, r + s, scale=r ** -0.5),
             b_out=rn(n_layers, r + s, scale=0.1),
             tgt=torch.roll(codes, -1, 1).t().contiguous(),
             w1=rn(s, c, scale=s ** -0.5), b1=rn(c, scale=0.1),
             w2=rn(c, c, scale=c ** -0.5), b2=rn(c, scale=0.1),
             dskip=rn(batch, t, s, scale=0.1).to(bf))
    return {k: None if v is None else v.to(dev) for k, v in a.items()}


def _close(name, got, want, rel):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,c,t,has_ctx,parity", [
    (16, 16, 64, 1280, True, True), (32, 32, 32, 2000, False, True),
    (64, 64, 64, 3200, True, True), (64, 8, 64, 1000, True, False),
])
def test_stack_head_kernels_match_plain(cuda, r, s, c, t, has_ctx, parity):
    a = _inputs(cuda, t, r, s, c, has_ctx)
    rf = 15
    args = (a["x"], a["ctx"], a["b_fg"], a["w_fg"], a["w_out"], a["b_out"],
            a["tgt"], a["w1"], a["b1"], a["w2"], a["b2"], DIL, rf, parity)
    before = dict(ks.launch_counts)
    loss, match, *got = ks.stack_head_fwd(*args)
    torch.cuda.synchronize()
    assert ks.launch_counts["stack_head_fwd"] == \
        before["stack_head_fwd"] + 1
    wl, wm, *want = sk.stack_head_fwd_plain(*args)
    assert abs(float(loss) - float(wl)) <= 1e-5 * abs(float(wl))
    assert abs(float(match) - float(wm)) <= 10
    for name, x, y in zip(("skip", "hsave", "tfsg"), got, want):
        _close(name, x, y, 2e-2)
    skip, hsave, tfsg = want
    dloss = torch.tensor(1.0 / (2 * (t - rf)), device=cuda)
    bargs = (hsave, tfsg, a["ctx"], a["w_fg"], a["w_out"], skip, a["tgt"],
             a["w1"], a["b1"], a["w2"], a["b2"], dloss, DIL, rf, parity)
    got = ks.stack_head_bwd(*bargs)
    torch.cuda.synchronize()
    assert ks.launch_counts["stack_head_bwd"] == \
        before["stack_head_bwd"] + 1
    want = sk.stack_head_bwd_plain(*bargs)
    names = ("dx", "dctx", "db_fg", "dw_fg", "dw_out", "db_out", "dw1",
             "db1", "dw2", "db2")
    for name, x, y in zip(names, got, want):
        if y is None:
            assert x is None, name
            continue
        _close(name, x, y, 2e-2 if name in ("dx", "dctx") else 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,t,ctx_kind", [
    (16, 16, 1280, None), (16, 16, 1280, "flat"), (64, 64, 3200, "proj"),
    (64, 8, 1000, "flat"),
])
def test_stack_x_kernels_match_plain(cuda, r, s, t, ctx_kind):
    """The non-embed save form (B.2(a)): x in, dx out, with the
    projection backward folded in for the triple."""
    a = _inputs(cuda, t, r, s, 64, ctx_kind is not None)
    proj = None
    if ctx_kind == "proj":
        g = torch.Generator().manual_seed(3)
        trip = ((torch.randn(2, t // 10, r, generator=g) * 0.5).to(
            torch.bfloat16).to(cuda),
            (torch.randn(r, 10 * r, generator=g) * r ** -0.5).to(cuda),
            (torch.randn(10 * r, generator=g) * 0.1).to(cuda))
        a["ctx"] = sk.ctx_flatten(trip, torch.bfloat16)
        proj = sk._ctx_proj_args(trip)
    args = (a["x"], a["ctx"], a["b_fg"], a["w_fg"], a["w_out"], a["b_out"],
            DIL)
    before = dict(ks.launch_counts)
    got = ks.stack_fwd_x(*args)
    torch.cuda.synchronize()
    assert ks.launch_counts["stack_fwd"] == before["stack_fwd"] + 1
    want = sk.stack_fwd_x_plain(*args)
    for name, x, y in zip(("skip", "hsave", "tfsg"), got, want):
        _close(name, x, y, 2e-2)
    bargs = (want[1], want[2], a["ctx"], a["w_fg"], a["w_out"], a["dskip"],
             DIL, proj)
    got = ks.stack_bwd_x(*bargs)
    torch.cuda.synchronize()
    assert ks.launch_counts["stack_bwd"] == before["stack_bwd"] + 1
    want = sk.stack_bwd_x_plain(*bargs)
    names = ("dx", "dctx", "db_fg", "dw_fg", "dw_out", "db_out", "dwup_aug")
    for name, x, y in zip(names, got, want):
        if y is None:
            assert x is None, name
            continue
        _close(name, x, y, 2e-2 if name in ("dx", "dctx") else 1e-4)


@pytest.mark.cuda
def test_merged_train_loss_runs_the_kernels(cuda):
    """fused_train_loss(merge_head=True) on the card: the merged kernels
    launch, the split pipeline's do not; the loss is finite."""
    from movenet_tpu_torch.config import ModelConfig
    from movenet_tpu_torch.models import fused
    from movenet_tpu_torch.models.wavenet import make_wavenet
    from movenet_tpu_torch.ops.cuda import head_loss as kh

    mc = ModelConfig(layer_size=3, stack_size=2, input_channels=64,
                     residual_channels=16, skip_channels=16,
                     compute_dtype="bfloat16", max_audio_frames=1280)
    model = make_wavenet(mc, generator=torch.Generator().manual_seed(0))
    model = model.to(cuda)
    codes = torch.randint(0, 64, (2, 1280), device=cuda)
    ks.reset_launch_counts()
    kh.reset_launch_counts()
    loss, acc = fused.fused_train_loss(model, codes, merge_head=True)
    loss.backward()
    torch.cuda.synchronize()
    assert ks.launch_counts["stack_head_fwd"] == 1
    assert ks.launch_counts["stack_head_bwd"] == 1
    assert ks.launch_counts["stack_fwd"] == 0
    assert kh.launch_counts["head_fwd"] == 0
    assert np.isfinite(float(loss.detach())) and 0 <= float(acc) <= 1
    assert model.head1.kernel.grad is not None
    assert model.blocks_w_cur.grad is not None


@pytest.mark.cuda
def test_merged_wrappers_reject_wrong_inputs(cuda):
    a = _inputs(cuda, 1280, 16, 16, 64, False)
    args = [a["x"], None, a["b_fg"], a["w_fg"], a["w_out"], a["b_out"],
            a["tgt"], a["w1"], a["b1"], a["w2"], a["b2"], DIL, 15, True]
    with pytest.raises(ValueError, match="B.2"):
        ks.stack_head_fwd(a["x"].float(), *args[1:])
    # the non-embed save form takes float32 (B.2/B.4 (2), built), not
    # float16
    skip, hsave, _ = ks.stack_fwd_x(a["x"].float(), *args[1:6], DIL)
    assert skip.dtype == hsave.dtype == torch.float32
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        ks.stack_fwd_x(a["x"].half(), *args[1:6], DIL)
    w_out = torch.zeros(len(DIL), 16, 20, device=cuda)
    b_out = torch.zeros(len(DIL), 20, device=cuda)
    with pytest.raises(NotImplementedError, match="B.2"):
        ks.stack_fwd_x(a["x"], None, a["b_fg"], a["w_fg"], w_out, b_out, DIL)
    big = torch.zeros(16, 128, device=cuda)
    with pytest.raises(NotImplementedError, match="B.4"):
        ks.stack_head_fwd(*args[:7], big, torch.zeros(128, device=cuda),
                          torch.zeros(128, 128, device=cuda),
                          torch.zeros(128, device=cuda), *args[11:])
