"""The split-TF32 ``wgmma`` building block of the wide float32 recompute
kernels (csrc/wgmma_tf32.cuh, probed alone by csrc/wgmma_tf32.cu) and the
kernels built on it (csrc/stack_kernel.cu, "the wide float32 recompute
kernels") on a CUDA GPU.  Imports only torch and the port:

    python -m pytest tests/test_torch_wgmma_cuda.py -q -s

Without a card every test skips.  One 64-row product at the depths the
kernels take (k = 128: out; 256: dgated at S = 128 and dfg_w; 384: fg with
ctx), its operands split once as they land in shared memory, is held
against float64 for each accumulation chunk (the k the tensor core sums
from zero before the chunk is added in float32); ``-s`` prints the error of
each.  The chunk the kernels take (``ops/stack_kernel.WIDE_F32_CHUNK``)
must hold 2e-6 of the output's scale: a tenth of the forward's bar of 1e-5,
over one product (the kernels' bars hold over 30 layers).  Then the
kernels against their plain versions (TF32 off) at a small R = 128 shape
within the float32 bars (forward 1e-5 of each output's scale, gradients
1e-4), and the SASS of the built library: the wide float32 kernels issue
HGMMA."""

import ctypes
import re

import numpy as np
import pytest
import torch

from movenet_tpu_torch.ops import stack_kernel as sk
from movenet_tpu_torch.ops.cuda import stack_kernel as ks

CHUNKS = (8, 16, 32, 64, 128, 384)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _probe_lib():
    from movenet_tpu_torch.ops.cuda import build

    lib = build.load("wgmma_tf32")
    lib.movenet_wgmma_probe.argtypes = [ctypes.c_void_p] * 3 + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.movenet_wgmma_probe.restype = ctypes.c_int
    return lib


def _probe(lib, a, b, chunk, swap=0):
    n, k = b.shape
    out = torch.empty(64, n, dtype=torch.float32, device=a.device)
    err = lib.movenet_wgmma_probe(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), k, n, chunk, swap,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"CUDA error {err} at launch"
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 8])
@pytest.mark.parametrize("k", [128, 256, 384])
def test_wgmma_split_product_against_float64(cuda, k, n):
    g = torch.Generator(device="cuda").manual_seed(k + n)
    a = torch.randn(64, k, generator=g, device=cuda) * 0.5
    b = torch.randn(n, k, generator=g, device=cuda) * k ** -0.5
    want = (a.double() @ b.double().t())
    scale = float(want.abs().max())
    lib = _probe_lib()
    errs = {}
    for chunk in CHUNKS:
        if chunk > k:
            continue
        got = _probe(lib, a, b, chunk)
        errs[chunk] = float((got.double() - want).abs().max()) / scale
        emu = sk.kstep_split_matmul(a.cpu(), b.cpu().t(), chunk)
        emu_err = float((got.cpu() - emu).abs().max()) / scale
        print(f"wgmma split-TF32 m64n{n} k={k} chunk {chunk}: max err "
              f"{errs[chunk]:.3g} of scale against float64, {emu_err:.3g} "
              "against kstep_split_matmul")
    one_pass = (sk.tf32_rna(a).double() @ sk.tf32_rna(b).double().t())
    print(f"  one-pass TF32 for comparison: "
          f"{float((one_pass - want).abs().max()) / scale:.3g}")
    if errs[sk.WIDE_F32_CHUNK] > 2e-6:
        swapped = _probe(lib, a, b, sk.WIDE_F32_CHUNK, swap=1)
        print(f"  with the descriptor's byte offsets swapped: "
              f"{float((swapped.double() - want).abs().max()) / scale:.3g}")
    assert errs[sk.WIDE_F32_CHUNK] <= 2e-6, errs


def _tails_inputs(dev, r, s, ctx_kind, t=1280, batch=2, seed=3):
    g = torch.Generator(device="cuda").manual_seed(seed + s)
    dil = (1, 2, 4, 1)
    n, win = len(dil), 3 * r if ctx_kind else 2 * r

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    x = rn(batch, t, r, scale=0.5)
    ctx = None
    if ctx_kind == "flat":
        ctx = rn(batch, t, r, scale=0.5)
    elif ctx_kind == "proj":
        ctx = sk.ctx_flatten((rn(batch, t // 10, r, scale=0.5),
                              rn(r, 10 * r, scale=r ** -0.5),
                              rn(10 * r, scale=0.1)), torch.float32)
    args = (x, ctx, rn(n * batch, 2 * r, scale=0.1),
            rn(n, win, 2 * r, scale=win ** -0.5),
            rn(n, r, r + s, scale=r ** -0.5), rn(n, r + s, scale=0.1), dil)
    return args, rn(batch, t, s, scale=0.1)


def _close(name, got, want, rel):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("ctx_kind", [None, "flat", "proj"])
@pytest.mark.parametrize("r,s", ks.WIDE_WIDTHS)
def test_wide_f32_kernels_match_plain(cuda, r, s, ctx_kind):
    """Kernel A (the wide float32 layer kernel: the forward, the rebuilds
    and the taps launches) and kernel B (the wide float32 layer backward)
    through the recompute wrappers against the plain versions, TF32 off:
    forward 1e-5 of each output's scale, gradients 1e-4; two backward
    calls give the same bits."""
    args, dskip = _tails_inputs(cuda, r, s, ctx_kind)
    before = dict(ks.launch_counts)
    got = ks.stack_fwd_tails(*args)
    want = sk.stack_fwd_tails_plain(*args)
    assert ks.launch_counts["stack_fwd_tails_f32"] == \
        before["stack_fwd_tails_f32"] + 1
    for name, u, w in zip(("skip", "ckpt"), got, want):
        _close(name, u, w, 1e-5)
    bargs = (args[0], want[1], *args[1:-1], dskip, args[-1])
    got = ks.stack_bwd_tails(*bargs)
    again = ks.stack_bwd_tails(*bargs)
    want = sk.stack_bwd_tails_plain(*bargs)
    for name, u, v, w in zip(("dx", "dctx", "db_fg", "dw_fg", "dw_out",
                              "db_out"), got, again, want):
        if w is None:
            assert u is None
            continue
        assert torch.equal(u, v), name
        _close(name, u, w, 1e-4)


@pytest.mark.cuda
def test_wide_f32_kernels_issue_hgmma(cuda):
    from movenet_tpu_torch.ops.cuda import build
    from movenet_tpu_torch.utils.time_stack_bwd import sass_counts

    counts = sass_counts(build.build(["stack_kernel"])["stack_kernel"])
    # kernel A, and kernel B: stack_bwd_wg_kernel's float32 form (3)
    wide = {k: v for k, v in counts.items()
            if "wg_f32" in k
            or re.search(r"stack_bwd_wg_kernelILi\d+ELi\d+ELb[01]ELi3E", k)}
    print({k: v for k, v in wide.items()})
    assert len(wide) == 6, sorted(counts)
    assert all(v[0] > 0 for v in wide.values()), wide
