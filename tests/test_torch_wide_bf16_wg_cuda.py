"""The wide bf16 trunk backwards on ``wgmma`` (csrc/stack_kernel.cu, "the
wide layer backwards on wgmma" and "W_fg's gradient on wgmma") on a CUDA
GPU, beside tests/test_torch_wgmma_cuda.py's building block.  Imports only
torch and the port:

    python -m pytest tests/test_torch_wide_bf16_wg_cuda.py -q -s

Without a card every test skips.  At (R, S) = (128, 128) with the flat ctx
and (128, 8) without, B = 2, T = 1280, dilations (1, 2, 4, 1): the save,
replay and recompute backwards (their layer launches in kernel B's bf16
forms, W_fg's gradient in MODE 0 or 7) from the kernel forwards' saved
tensors, against their plain versions (TF32 off) and against the
emulation of their own arithmetic (``ops/stack_kernel.wide_bwd_products``)
on the same inputs: each float32 gradient within ``F32_BARS`` of its scale,
each bf16 one (dx, dctx) within a bf16 step (1e-2); two calls give the same
bits.  Then the SASS of the built library: the new kernels issue HGMMA, and
the wide mma.sync layer launch and the old R = 128 MODE 0 and 7 kernels are
gone."""

import re

import pytest
import torch

from movenet_tpu_torch.ops import stack_kernel as sk
from movenet_tpu_torch.ops.cuda import stack_kernel as ks

DIL = (1, 2, 4, 1)
NAMES = ("dx", "dctx", "db_fg", "dw_fg", "dw_out", "db_out")
# float32 gradients against (the plain version, the emulation), by strategy:
# the recompute's rebuilt layers and fg formed again are bf16 products in
# the tensor cores' order, which flip a rounding of h or of the taps now
# and then (tests/test_torch_wide_bf16_wg.py's PLAIN_BARS)
F32_BARS = {"save": (1e-4, 1e-5), "replay": (1e-4, 1e-5),
            "recompute": (1e-3, 1e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _args(dev, r, s, has_ctx, t=1280, batch=2, seed=7):
    g = torch.Generator(device="cuda").manual_seed(seed + s)
    n, win, bf = len(DIL), (3 if has_ctx else 2) * r, torch.bfloat16

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    x = rn(batch, t, r, scale=0.5).to(bf)
    ctx = rn(batch, t, r, scale=0.5).to(bf) if has_ctx else None
    args = (x, ctx, rn(n * batch, 2 * r, scale=0.1),
            rn(n, win, 2 * r, scale=win ** -0.5),
            rn(n, r, r + s, scale=r ** -0.5), rn(n, r + s, scale=0.1), DIL)
    return args, rn(batch, t, s, scale=0.1).to(bf)


def _run(strategy, args, dskip):
    """(kernel outputs, a second call's, plain function of the same inputs
    given products) of one backward."""
    x, ctx, b_fg, w_fg, w_out, b_out, dil = args
    if strategy == "save":
        _, hsave, tfsg = ks.stack_fwd_x(*args)
        bargs = (hsave, tfsg, ctx, w_fg, w_out, dskip, dil)
        kern, plain = ks.stack_bwd_x, sk.stack_bwd_x_plain
    elif strategy == "replay":
        _, ckpt, tfsg = ks.stack_fwd_replay(*args)
        bargs = (x, ckpt, tfsg, ctx, w_fg, w_out, b_out, dskip, dil)
        kern, plain = ks.stack_bwd_replay, sk.stack_bwd_replay_plain
    else:
        _, ckpt = ks.stack_fwd_tails(*args)
        bargs = (x, ckpt, ctx, b_fg, w_fg, w_out, b_out, dskip, dil)
        kern, plain = ks.stack_bwd_tails, sk.stack_bwd_tails_plain
    got, again = kern(*bargs), kern(*bargs)
    cpu = tuple(v.cpu() if torch.is_tensor(v) else v for v in bargs)
    return got, again, lambda products: plain(*cpu, products=products)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["save", "replay", "recompute"])
@pytest.mark.parametrize("r,s,has_ctx", [(128, 128, True), (128, 8, False)])
def test_wide_bf16_backwards_match_plain_and_emulation(cuda, r, s, has_ctx,
                                                        strategy):
    args, dskip = _args(cuda, r, s, has_ctx)
    got, again, plain = _run(strategy, args, dskip)
    want = plain(None)
    emu = plain(sk.wide_bwd_products(replay=strategy == "replay"))
    bars = F32_BARS[strategy]
    for name, u, v, w, e in zip(NAMES, got, again, want, emu):
        if w is None:
            assert u is None, name
            continue
        assert torch.equal(u, v), name
        u = u.float().cpu()
        for label, ref, bar in (("plain", w, bars[0]),
                                ("emulation", e, bars[1])):
            ref = ref.float()
            scale = float(ref.abs().max()) + 1e-12
            err = float((u - ref).abs().max()) / scale
            bar = 1e-2 if name in ("dx", "dctx") else bar
            print(f"{strategy} ({r}, {s}) {name}: {err:.3g} of scale "
                  f"against the {label} (bar {bar:g})")
            assert err <= bar, (name, label, err)


@pytest.mark.cuda
def test_wide_bf16_kernels_issue_hgmma(cuda):
    from movenet_tpu_torch.ops.cuda import build
    from movenet_tpu_torch.utils.time_stack_bwd import sass_counts

    counts = sass_counts(build.build(["stack_kernel"])["stack_kernel"])
    layer = {k: v for k, v in counts.items()
             if re.search(r"stack_bwd_wg_kernelILi128ELi\d+ELb[01]ELi[01]E", k)}
    wgrad = {k: v for k, v in counts.items()
             if re.search(r"stack_wgrad_wg_kernelILi[07]ELi128E", k)}
    print(layer, wgrad)
    assert len(layer) == 8 and len(wgrad) == 8, (sorted(layer), sorted(wgrad))
    assert all(v[0] > 0 for v in {**layer, **wgrad}.values())
    old = [k for k in counts
           if re.search(r"stack_bwd_layer_kernelILi128E|"
                        r"stack_wgrad_kernelILi[07]ELi128E", k)]
    assert not old, old
