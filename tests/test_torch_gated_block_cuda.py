"""The gated-block kernels (csrc/gated_block.cu) against their plain torch
versions on a CUDA GPU.  Imports only torch and the port:

    python -m pytest tests/test_torch_gated_block_cuda.py -q

Without a card every test skips.  Tolerances: res and skip are float32
sums (in other orders in the kernel and in torch) rounded to bf16, so a
value may sit one bf16 step away: within 1% of each output's scale; the
backward's float32 weight gradients within 1e-4 of their scale, dh and
dctx (bf16) within 1%."""

import numpy as np
import pytest
import torch

from movenet_tpu_torch.ops import gated_block as gb
from movenet_tpu_torch.ops.cuda import gated_block as kg


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, t, r, s, has_ctx, batch=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    win = (3 if has_ctx else 2) * r
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    a = dict(h=rn(batch, t, r, scale=0.5).to(bf),
             ctx=rn(batch, t, r, scale=0.5).to(bf) if has_ctx else None,
             b_fg=rn(batch, 2 * r, scale=0.1),
             w_fg=rn(win, 2 * r, scale=win ** -0.5),
             w_out=rn(r, r + s, scale=r ** -0.5),
             b_out=rn(1, r + s, scale=0.1),
             dres=rn(batch, t, r, scale=0.1).to(bf),
             dskip=rn(batch, t, s, scale=0.1).to(bf))
    return {k: None if v is None else v.to(dev) for k, v in a.items()}


def _close(name, got, want, rel):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=name)


WIDTHS = [(16, 16), (32, 32), (64, 64), (64, 8), (32, 8), (16, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,t,d,has_ctx", [
    (16, 16, 1280, 1, True), (16, 16, 1000, 4, False),
    (32, 32, 1280, 128, True), (64, 64, 3200, 512, True),
    (64, 8, 1280, 256, False), (64, 64, 640, 1024, True),
    (32, 8, 1280, 2, True), (16, 8, 1280, 512, False),
])
def test_gated_kernels_match_plain(cuda, r, s, t, d, has_ctx):
    _match_plain(cuda, r, s, t, d, has_ctx, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,t,d,has_ctx,batch", [
    (64, 64, 1000, 600, True, 2), (32, 8, 999, 500, False, 2),
    (16, 16, 1000, 700, True, 3), (64, 8, 1283, 4, True, 3),
    (32, 32, 3001, 1, False, 3), (16, 8, 777, 388, True, 3),
])
def test_gated_kernels_match_plain_ragged(cuda, r, s, t, d, has_ctx, batch):
    """T not a multiple of the 64-row tile, d at least T/2 (the tap and the
    carry cross most of a batch row), and B = 3 (b_fg and db_fg per batch
    row over more than two rows)."""
    _match_plain(cuda, r, s, t, d, has_ctx, batch)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s", WIDTHS)
def test_gated_kernels_repeat_their_bits(cuda, r, s):
    """Two calls of each kernel give the same bits (fixed-order sums, no
    atomics), at a T where each persistent block walks several tiles."""
    a = _inputs(cuda, 20000, r, s, True, batch=2, seed=1)
    args = (a["h"], a["ctx"], a["b_fg"], a["w_fg"], a["w_out"])
    calls = [kg.gated_block_fwd(*args, a["b_out"], 3) for _ in range(2)]
    calls += [kg.gated_block_bwd(*args, a["dres"], a["dskip"], 3)
              for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in (calls[:2], calls[2:]):
        for x, y in zip(first, second):
            assert torch.equal(x, y)


def _match_plain(cuda, r, s, t, d, has_ctx, batch):
    a = _inputs(cuda, t, r, s, has_ctx, batch=batch)
    args = (a["h"], a["ctx"], a["b_fg"], a["w_fg"], a["w_out"])
    before = dict(kg.launch_counts)
    got = kg.gated_block_fwd(*args, a["b_out"], d)
    torch.cuda.synchronize()
    assert kg.launch_counts["gated_block_fwd"] == \
        before["gated_block_fwd"] + 1
    want = gb.gated_block_fwd_plain(*args, a["b_out"], d)
    for name, x, y in zip(("res", "skip"), got, want):
        _close(name, x, y, 1e-2)
    got = kg.gated_block_bwd(*args, a["dres"], a["dskip"], d)
    torch.cuda.synchronize()
    assert kg.launch_counts["gated_block_bwd"] == \
        before["gated_block_bwd"] + 1
    want = gb.gated_block_bwd_plain(*args, a["dres"], a["dskip"], d)
    for name, x, y in zip(("dh", "dctx", "db_fg", "dw_fg", "dw_out",
                           "db_out"), got, want):
        if y is None:
            assert x is None, name
            continue
        _close(name, x, y, 1e-2 if name in ("dh", "dctx") else 1e-4)


@pytest.mark.cuda
def test_gated_block_op_runs_the_kernels(cuda):
    """fused_gated_block on CUDA tensors: one forward and one backward
    launch, gradients in the inputs' dtypes."""
    a = _inputs(cuda, 1280, 16, 16, True)
    for k in ("h", "ctx", "b_fg", "w_fg", "w_out", "b_out"):
        a[k].requires_grad_()
    kg.reset_launch_counts()
    res, skip = gb.fused_gated_block(a["h"], a["ctx"], a["b_fg"], a["w_fg"],
                                     a["w_out"], a["b_out"], 4)
    (res.float().sum() + skip.float().square().sum()).backward()
    torch.cuda.synchronize()
    assert kg.launch_counts == {"gated_block_fwd": 1, "gated_block_bwd": 1}
    assert a["h"].grad.dtype == a["ctx"].grad.dtype == torch.bfloat16
    assert a["w_fg"].grad.dtype == torch.float32


@pytest.mark.cuda
def test_gated_wrappers_reject_wrong_inputs(cuda):
    a = _inputs(cuda, 1280, 16, 16, False)
    with pytest.raises(ValueError, match="B.2"):
        kg.gated_block_fwd(a["h"].float(), None, a["b_fg"], a["w_fg"],
                           a["w_out"], a["b_out"], 1)
    with pytest.raises(NotImplementedError, match="B.2"):
        kg.gated_block_fwd(a["h"], None, a["b_fg"], a["w_fg"],
                           torch.zeros(16, 40, device=cuda),
                           torch.zeros(1, 40, device=cuda), 1)
