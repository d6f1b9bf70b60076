"""The head/CE kernels (csrc/head_loss.cu) against their plain torch
versions on a CUDA GPU.  Imports only torch and the port:

    python -m pytest tests/test_torch_head_loss_cuda.py -q

Without a card every test skips.  Tolerances: loss sum rtol 1e-5 (float32
sums in another order), match count within one position; p within 2e-4
(the head rounds leaky(y) to bf16 as a product operand, and a sum that
lands on the other side of a rounding boundary moves z by one bf16 step
of that operand); the float32 gradients within 1e-4 of their scale;
dskip is stored in bf16 and may sit one bf16 step away: within 1% of its
scale.  The packed kernels (float32 operands, no p) take the same
tolerances against their plain versions.  At C = 128 and 256 the float32
gradients are held within 1e-3 of their scale: with 128-256 columns per
row more bf16 operands of dy land one rounding step from the plain
version's (measured on the H100: two of 4096 elements of dW1 at 1.8e-4
of the scale, at S=16, C=256).  (12, 132) is a width that is not a
multiple of 16: the kernels pad it with zeros in shared memory.  Two
calls give the same bits (fixed-order sums, no atomics), packed kernels
too; the merged trunk + head kernels keep the bits of the source before
the packed kernels moved to the tensor cores (digests).  The packed
kernels (split-TF32 tensor cores since then) hold the plain versions'
tolerances above.

The float32 forms (a float32 skip, S <= 128, C <= 256: above C = 128 the
wide kernels, W2 through a ring of row slabs, above S = 64 with the rows
of skip from global memory) take float32 inputs that are not bf16 values: loss rtol 1e-5, the match count equal, p within 1e-5,
every gradient (dskip too) within 1e-4 of its scale, two calls
bit-equal."""

import hashlib

import numpy as np
import pytest
import torch

from movenet_tpu_torch.ops import head_loss as hl
from movenet_tpu_torch.ops.cuda import head_loss as kh
from movenet_tpu_torch.ops.cuda import stack_kernel as ks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, batch, t, s, c, seed=0, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    codes = torch.randint(0, c, (batch, t), generator=g, dtype=torch.int32)
    prev = torch.cat([torch.full((batch, 1), -1, dtype=torch.int32),
                      codes[:, :-1]], 1)
    pack = torch.cat([codes, prev, torch.roll(codes, -1, 1)], 0).t()
    return dict(
        skip=torch.randn(batch, t, s, generator=g).to(dtype),
        pack=pack.contiguous(),
        w1=torch.randn(s, c, generator=g) / 4,
        b1=torch.randn(c, generator=g) * 0.1,
        w2=torch.randn(c, c, generator=g) / 3,
        b2=torch.randn(c, generator=g) * 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("s,c,t", [(16, 64, 4000), (64, 64, 10000),
                                   (8, 64, 999)])
@pytest.mark.parametrize("parity", [True, False])
def test_head_kernels_match_plain(cuda, s, c, t, parity):
    batch, rf = 2, 24
    a = _inputs(cuda, batch, t, s, c)
    a = {k: v.to(cuda) for k, v in a.items()}
    args = (a["skip"], a["pack"], a["w1"], a["b1"], a["w2"], a["b2"], rf,
            parity, 2 * batch)
    n0 = dict(kh.launch_counts)
    loss, match, p = kh.head_fwd(*args)
    torch.cuda.synchronize()
    assert kh.launch_counts["head_fwd"] == n0["head_fwd"] + 1
    wl, wm, wp = hl.head_fwd_plain(*args)
    np.testing.assert_allclose(float(loss), float(wl), rtol=1e-5)
    assert abs(float(match) - float(wm)) <= 1
    np.testing.assert_allclose(p.cpu().numpy(), wp.cpu().numpy(), rtol=0,
                               atol=2e-4)
    l2, m2, p2 = kh.head_fwd(*args, save_p=False)
    assert p2 is None and float(l2) == float(loss)
    dloss = torch.tensor(1.0 / (batch * (t - rf)), device=cuda)
    got = kh.head_bwd(a["skip"], a["pack"], wp, a["w1"], a["b1"], a["w2"],
                      a["b2"], rf, parity, dloss, 2 * batch)
    torch.cuda.synchronize()
    assert kh.launch_counts["head_bwd"] == n0["head_bwd"] + 1
    want = hl.head_bwd_plain(a["skip"], a["pack"], wp, a["w1"], a["b1"],
                             a["w2"], a["b2"], rf, parity, dloss, 2 * batch)
    for name, x, y in zip(("dskip", "dw1", "db1", "dw2", "db2"), got, want):
        x, y = x.float().cpu().numpy(), y.float().cpu().numpy()
        tol = (1e-2 if name == "dskip" else 1e-4) * np.abs(y).max()
        np.testing.assert_allclose(x, y, rtol=0, atol=tol, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("s,c,t", [(8, 128, 4000), (16, 256, 2000),
                                   (64, 256, 1000), (12, 132, 2000)])
@pytest.mark.parametrize("parity", [True, False])
def test_wide_head_kernels_match_plain(cuda, s, c, t, parity):
    """C = 128 (experiments 03/04), 256 (the flagship width) and 132 with
    S = 12 (zero-padded to 144 and 16 in shared memory)."""
    batch, rf = 2, 24
    a = _inputs(cuda, batch, t, s, c)
    a = {k: v.to(cuda) for k, v in a.items()}
    args = (a["skip"], a["pack"], a["w1"], a["b1"], a["w2"], a["b2"], rf,
            parity, 2 * batch)
    loss, match, p = kh.head_fwd(*args)
    wl, wm, wp = hl.head_fwd_plain(*args)
    np.testing.assert_allclose(float(loss), float(wl), rtol=1e-5)
    assert abs(float(match) - float(wm)) <= 1
    np.testing.assert_allclose(p.cpu().numpy(), wp.cpu().numpy(), rtol=0,
                               atol=2e-4)
    dloss = torch.tensor(1.0 / (batch * (t - rf)), device=cuda)
    bargs = (a["skip"], a["pack"], wp, a["w1"], a["b1"], a["w2"], a["b2"],
             rf, parity, dloss, 2 * batch)
    got, want = kh.head_bwd(*bargs), hl.head_bwd_plain(*bargs)
    for name, x, y in zip(("dskip", "dw1", "db1", "dw2", "db2"), got, want):
        x, y = x.float().cpu().numpy(), y.float().cpu().numpy()
        tol = (1e-2 if name == "dskip" else 1e-3) * np.abs(y).max()
        np.testing.assert_allclose(x, y, rtol=0, atol=tol, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("s,c,t", [(16, 64, 4000), (64, 64, 10000),
                                   (8, 64, 999), (8, 128, 4000),
                                   (64, 128, 2000), (12, 36, 2000),
                                   (4, 4, 1000), (12, 132, 2000),
                                   (16, 192, 2000), (8, 256, 999),
                                   (64, 256, 4000), (128, 64, 2000),
                                   (128, 128, 1000), (128, 256, 1000),
                                   (100, 132, 1000)])
@pytest.mark.parametrize("parity", [True, False])
def test_head_kernels_match_plain_f32(cuda, s, c, t, parity):
    batch, rf = 2, 24
    a = _inputs(cuda, batch, t, s, c, dtype=torch.float32)
    a = {k: v.to(cuda) for k, v in a.items()}
    args = (a["skip"], a["pack"], a["w1"], a["b1"], a["w2"], a["b2"], rf,
            parity, 2 * batch)
    n0 = dict(kh.launch_counts)
    # above C = 128 the wide kernels, counted apart
    form = "_f32_wide" if c > kh.F32_RING_C else "_f32"
    loss, match, p = kh.head_fwd(*args)
    torch.cuda.synchronize()
    assert kh.launch_counts["head_fwd" + form] == n0["head_fwd" + form] + 1
    assert kh.launch_counts["head_fwd"] == n0["head_fwd"]
    wl, wm, wp = hl.head_fwd_plain(*args)
    np.testing.assert_allclose(float(loss), float(wl), rtol=1e-5)
    assert float(match) == float(wm)
    np.testing.assert_allclose(p.cpu().numpy(), wp.cpu().numpy(), rtol=0,
                               atol=1e-5)
    l2, m2, p2 = kh.head_fwd(*args, save_p=False)
    assert p2 is None and float(l2) == float(loss)
    dloss = torch.tensor(1.0 / (batch * (t - rf)), device=cuda)
    bargs = (a["skip"], a["pack"], wp, a["w1"], a["b1"], a["w2"], a["b2"],
             rf, parity, dloss, 2 * batch)
    got = kh.head_bwd(*bargs)
    torch.cuda.synchronize()
    assert kh.launch_counts["head_bwd" + form] == n0["head_bwd" + form] + 1
    assert kh.launch_counts["head_bwd"] == n0["head_bwd"]
    want = hl.head_bwd_plain(*bargs)
    for name, x, y in zip(("dskip", "dw1", "db1", "dw2", "db2"), got, want):
        assert x.dtype == torch.float32, name
        x, y = x.cpu().numpy(), y.cpu().numpy()
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-4 * np.abs(y).max(),
                                   err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("s,c", [(16, 64), (8, 128), (64, 256), (12, 132),
                                 (128, 64), (128, 256)])
def test_head_f32_kernels_repeat_bit_equal(cuda, s, c):
    """Two calls of each float32 kernel give the same bits."""
    batch, t, rf = 2, 3000, 24
    a = {k: v.to(cuda) for k, v in
         _inputs(cuda, batch, t, s, c, dtype=torch.float32).items()}
    args = (a["skip"], a["pack"], a["w1"], a["b1"], a["w2"], a["b2"], rf,
            True, 2 * batch)
    l1, m1, p1 = kh.head_fwd(*args)
    l2, m2, p2 = kh.head_fwd(*args)
    assert float(l1) == float(l2) and float(m1) == float(m2)
    assert torch.equal(p1, p2)
    bargs = (a["skip"], a["pack"], p1, a["w1"], a["b1"], a["w2"], a["b2"],
             rf, True, torch.tensor(1e-4, device=cuda), 2 * batch)
    for x, y in zip(kh.head_bwd(*bargs), kh.head_bwd(*bargs)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_head_f32_smem_mirrors_the_library(cuda):
    """ops/cuda/head_loss.f32_smem gives the library's own sizes, and the
    float32 kernels take exactly S <= 128, C <= 256 (multiples of 4)."""
    lib = kh.library()
    for s in range(4, 133, 4):
        for c in range(4, 261, 4):
            want = kh.f32_smem(s, c)
            assert lib.movenet_head_f32_smem(s, c, 0) == want["fwd"], (s, c)
            assert lib.movenet_head_f32_smem(s, c, 1) == want["bwd"], (s, c)
            assert bool(lib.movenet_head_f32_supports(s, c)) == \
                (s <= 128 and c <= 256), (s, c)


@pytest.mark.cuda
@pytest.mark.parametrize("s,c", [(16, 64), (8, 128), (64, 256)])
def test_head_kernels_repeat_bit_equal(cuda, s, c):
    """Two calls of each kernel on the same inputs give the same bits."""
    batch, t, rf = 2, 3000, 24
    a = {k: v.to(cuda) for k, v in _inputs(cuda, batch, t, s, c).items()}
    args = (a["skip"], a["pack"], a["w1"], a["b1"], a["w2"], a["b2"], rf,
            True, 2 * batch)
    l1, m1, p1 = kh.head_fwd(*args)
    l2, m2, p2 = kh.head_fwd(*args)
    assert float(l1) == float(l2) and float(m1) == float(m2)
    assert torch.equal(p1, p2)
    bargs = (a["skip"], a["pack"], p1, a["w1"], a["b1"], a["w2"], a["b2"],
             rf, True, torch.tensor(1e-4, device=cuda), 2 * batch)
    for x, y in zip(kh.head_bwd(*bargs), kh.head_bwd(*bargs)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_head_supports_as_before(cuda):
    """The widths the kernels take: the ones they took before the
    tensor-core redesign (4 <= S <= 64, 4 <= C <= 256, multiples of 4),
    and since the wide forms S up to 128 (``kh.MAX_S``) at every such C."""
    lib = kh.library()
    for s in range(4, kh.MAX_S + 5):
        for c in range(4, 261):
            old = s % 4 == 0 and c % 4 == 0 and s <= kh.MAX_S and c <= 256
            assert bool(lib.movenet_head_supports(s, c)) == old, (s, c)


def _digest_inputs():
    """The inputs of the bit-keeping checks, made with numpy from fixed
    seeds: the packed head's (skip, targets, weights; drawn first, as when
    the digests also covered the packed kernels, so that the merged
    kernels' inputs are those of before) and the merged trunk + head
    kernels' (x, ctx, trunk and head weights, targets; and hsave, tfsg
    and skip saved for the backward, drawn with numpy too, so that the
    backward does not move with the forward kernel)."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(13)
    batch, t = 2, 2000

    def rn(*shape, scale=1.0, gen=rng):
        return torch.from_numpy((gen.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev)

    def tgt(c):
        return torch.from_numpy(rng.integers(0, c, size=(t, batch))
                                .astype(np.int32)).to(dev)

    packed = dict(skip=rn(batch, t, 64).to(bf), tgt=tgt(64),
                  w=(rn(64, 64, scale=0.25), rn(64, scale=0.1),
                     rn(64, 64, scale=0.3), rn(64, scale=0.1)))
    n, r, s, c = len(DIGEST_DILATIONS), 64, 64, 64
    m = dict(x=rn(batch, t, r, scale=0.5).to(bf),
             ctx=rn(batch, t, r, scale=0.5).to(bf))
    m["tw"] = (rn(n * batch, 2 * r, scale=0.1),
               rn(n, 3 * r, 2 * r, scale=0.07),
               rn(n, r, r + s, scale=0.12), rn(n, r + s, scale=0.1))
    m["hw"] = (rn(s, c, scale=0.12), rn(c, scale=0.1),
               rn(c, c, scale=0.12), rn(c, scale=0.1))
    m["tgt"] = tgt(c)
    saved = np.random.default_rng(14)
    m["hsave"] = rn(n, batch, t, r, scale=0.5, gen=saved).to(bf)
    m["tfsg"] = torch.cat([torch.tanh(rn(n, batch, t, r, gen=saved)),
                           torch.sigmoid(rn(n, batch, t, r, gen=saved))],
                          -1).to(bf)
    m["skip"] = rn(batch, t, s, gen=saved).to(bf)
    return packed, m


DIGEST_DILATIONS, DIGEST_RF = (1, 2, 4, 1, 2, 4), 24


def _digest(outs):
    h = hashlib.sha256()
    for o in outs:
        if o is not None:
            h.update(o.reshape(-1).contiguous().cpu().view(torch.uint8)
                     .numpy().tobytes())
    return h.hexdigest()[:32]


def _merged_digests(smod, slib):
    """(forward, backward) sha256 digests of the merged trunk + head
    kernels' outputs (stack_kernel.cu) on ``_digest_inputs``."""
    _, m = _digest_inputs()
    dloss = torch.tensor(1e-3, device="cuda")
    fwd = smod.run_head_fwd(slib, m["x"], m["ctx"], *m["tw"], m["tgt"],
                            *m["hw"], DIGEST_DILATIONS, DIGEST_RF, True)
    bwd = smod.run_head_bwd(slib, m["hsave"], m["tfsg"], m["ctx"],
                            m["tw"][1], m["tw"][2], m["skip"], m["tgt"],
                            *m["hw"], dloss, DIGEST_DILATIONS, DIGEST_RF,
                            True)
    torch.cuda.synchronize()
    return _digest(fwd), _digest(bwd)


def _packed_outputs(kmod, klib, skip, tgt, w, rf, parity, dloss):
    """The packed kernels' outputs: (loss, match, dskip, dw1, db1, dw2,
    db2)."""
    out = list(kmod.run_fwd(klib, skip, tgt, *w, rf, parity, 0, False,
                            packed=True)[:2])
    out += kmod.run_bwd(klib, skip, tgt, None, *w, rf, parity, dloss)
    torch.cuda.synchronize()
    return out


# the merged trunk + head kernels' (forward, backward) digests as the
# source before the packed kernels moved to the tensor cores gives them
# (the forward's as before; the backward's without the packed kernels'
# outputs), on an NVIDIA H100 80GB HBM3
HEAD_DIGESTS = ("f7474cd24d1364699385c4ff91fe1dd9",
                "6b34e895045a46bf253207dfc14e9651")


@pytest.mark.cuda
def test_packed_and_merged_heads_keep_their_bits(cuda):
    """The merged kernels give the digests of the source before the
    packed redesign; the packed kernels give the same bits call after
    call (both CE forms) on the digests' packed inputs."""
    assert _merged_digests(ks, ks.library()) == HEAD_DIGESTS
    p, _ = _digest_inputs()
    dloss = torch.tensor(1e-3, device=cuda)
    for parity in (True, False):
        args = (kh, kh.library(), p["skip"], p["tgt"], p["w"], DIGEST_RF,
                parity, dloss)
        first, second = _packed_outputs(*args), _packed_outputs(*args)
        assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
def test_head_wrapper_rejects_wrong_inputs(cuda):
    a = _inputs(cuda, 2, 500, 16, 64)
    a = {k: v.to(cuda) for k, v in a.items()}
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        kh.head_fwd(a["skip"].double(), a["pack"], a["w1"], a["b1"],
                    a["w2"], a["b2"], 24, True, 4)
    # no head is built above C = 256, in float32 either
    with pytest.raises(NotImplementedError, match="B.4"):
        w2 = torch.zeros(260, 260, device=cuda)
        w1 = torch.zeros(16, 260, device=cuda)
        b = torch.zeros(260, device=cuda)
        kh.head_fwd(a["skip"].float(), a["pack"], w1, b, w2, b, 24, True, 4)
    with pytest.raises(ValueError, match=r"B.2/B.4 \(5\)"):
        kh.head_fwd_packed(a["skip"].float(), a["pack"][:, :2].contiguous(),
                           a["w1"], a["b1"], a["w2"], a["b2"], 24, True)
    with pytest.raises(NotImplementedError, match="B.4"):
        w2 = torch.zeros(512, 512, device=cuda)
        w1 = torch.zeros(16, 512, device=cuda)
        b = torch.zeros(512, device=cuda)
        kh.head_fwd(a["skip"], a["pack"], w1, b, w2, b, 24, True, 4)
    with pytest.raises(ValueError, match="packed"):
        kh.head_fwd_packed(a["skip"], a["pack"][:, 4:6].contiguous(),
                           a["w1"], a["b1"], a["w2"], a["b2"], 24, True)


def _packed_args(cuda, t, seed=0):
    """Targets exactly B wide from column 0, as the packed route takes."""
    batch = 2
    a = _inputs(cuda, batch, t, 64, 64, seed)
    a = {k: v.to(cuda) for k, v in a.items()}
    a["tgt"] = a["pack"][:, 2 * batch:].contiguous()
    return a, batch


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4000, 1282])
@pytest.mark.parametrize("parity", [True, False])
def test_packed_head_kernels_match_plain(cuda, t, parity):
    a, batch = _packed_args(cuda, t)
    rf = 24
    args = (a["skip"], a["tgt"], a["w1"], a["b1"], a["w2"], a["b2"], rf,
            parity)
    n0 = dict(kh.launch_counts)
    loss, match = kh.head_fwd_packed(*args)
    torch.cuda.synchronize()
    assert kh.launch_counts["head_fwd_packed"] == n0["head_fwd_packed"] + 1
    wl, wm = hl.head_fwd_packed_plain(*args)
    np.testing.assert_allclose(float(loss), float(wl), rtol=1e-5)
    assert abs(float(match) - float(wm)) <= 1
    dloss = torch.tensor(1.0 / (batch * (t - rf)), device=cuda)
    got = kh.head_bwd_packed(*args, dloss)
    torch.cuda.synchronize()
    assert kh.launch_counts["head_bwd_packed"] == n0["head_bwd_packed"] + 1
    want = hl.head_bwd_packed_plain(*args, dloss)
    for name, x, y in zip(("dskip", "dw1", "db1", "dw2", "db2"), got, want):
        x, y = x.float().cpu().numpy(), y.float().cpu().numpy()
        tol = (1e-2 if name == "dskip" else 1e-4) * np.abs(y).max()
        np.testing.assert_allclose(x, y, rtol=0, atol=tol, err_msg=name)
    # against the unpacked kernels, which round the product operands to
    # bf16: the loss within 1e-2 relative
    ul, _, _ = kh.head_fwd(a["skip"], a["tgt"], a["w1"], a["b1"], a["w2"],
                           a["b2"], rf, parity, 0)
    np.testing.assert_allclose(float(ul), float(loss), rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4000, 1282])
@pytest.mark.parametrize("parity", [True, False])
def test_packed_head_kernels_repeat_bit_equal(cuda, t, parity):
    """Two calls of each packed kernel on the same inputs give the same
    bits (fixed-order sums, no atomics)."""
    a, batch = _packed_args(cuda, t)
    w = (a["w1"], a["b1"], a["w2"], a["b2"])
    dloss = torch.tensor(1.0 / (batch * (t - 24)), device=cuda)
    args = (kh, kh.library(), a["skip"], a["tgt"], w, 24, parity, dloss)
    first, second = _packed_outputs(*args), _packed_outputs(*args)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("parity", [True, False])
def test_packed_kernels_follow_plain_at_the_jumps(cuda, parity):
    """Where the function jumps, the packed kernels take the plain
    version's float32 order: with column 9 of W2 one float32 step from
    column 5 (their logits within rounding of a tie wherever they lead)
    the match count equals the plain version's; with b1 set so that y is
    zero in the plain version at one row of every column (dleaky jumps
    there) the gradients keep the tolerances above."""
    t, rf = 4000, 24
    a, batch = _packed_args(cuda, t, seed=4)
    w2, b2 = a["w2"].clone(), a["b2"].clone()
    w2[:, 9] = torch.nextafter(w2[:, 5], torch.full_like(w2[:, 5], 1e9))
    b2[9] = b2[5]
    args = (a["skip"], a["tgt"], a["w1"], a["b1"], w2, b2, rf, parity)
    _, match = kh.head_fwd_packed(*args)
    _, want_match = hl.head_fwd_packed_plain(*args)
    assert float(match) == float(want_match)
    y_chain = torch.matmul(hl._leaky(a["skip"].float().reshape(-1, 64)),
                           a["w1"])
    col = torch.arange(64, device=cuda)
    b1 = -y_chain[col * 97, col]
    args = (a["skip"], a["tgt"], a["w1"], b1, w2, b2, rf, parity)
    dloss = torch.tensor(1.0 / (batch * (t - rf)), device=cuda)
    got = kh.head_bwd_packed(*args, dloss)
    want = hl.head_bwd_packed_plain(*args, dloss)
    for name, x, y in zip(("dskip", "dw1", "db1", "dw2", "db2"), got, want):
        x, y = x.float().cpu().numpy(), y.float().cpu().numpy()
        tol = (1e-2 if name == "dskip" else 1e-4) * np.abs(y).max()
        np.testing.assert_allclose(x, y, rtol=0, atol=tol, err_msg=name)


@pytest.mark.cuda
def test_packed_route_through_the_op(cuda, monkeypatch):
    """With PACKED_HEAD on, fused_head_loss at tgt_off 0 takes the packed
    kernels (no softmax saved) and its gradients match the plain packed
    backward."""
    monkeypatch.setattr(hl, "PACKED_HEAD", True)
    a, batch = _packed_args(cuda, 2000, seed=3)
    w = [a[k].clone().requires_grad_(True) for k in ("w1", "b1", "w2", "b2")]
    skip = a["skip"].clone().requires_grad_(True)
    n0 = dict(kh.launch_counts)
    loss, _ = hl.fused_head_loss(skip, a["tgt"], *w, 24, True, 0)
    loss.backward()
    torch.cuda.synchronize()
    assert kh.launch_counts["head_fwd_packed"] == n0["head_fwd_packed"] + 1
    assert kh.launch_counts["head_bwd_packed"] == n0["head_bwd_packed"] + 1
    assert kh.launch_counts["head_fwd"] == n0["head_fwd"]
    want = hl.head_bwd_packed_plain(a["skip"], a["tgt"], a["w1"], a["b1"],
                                    a["w2"], a["b2"], 24, True, 1.0)
    for x, y in zip([skip.grad] + [v.grad for v in w], want):
        x, y = x.float().cpu().numpy(), y.float().cpu().numpy()
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-2 * np.abs(y).max())


@pytest.mark.cuda
@pytest.mark.parametrize("s,c,t", [(128, 64, 2000), (128, 256, 1000),
                                   (128, 128, 1000), (100, 132, 1000)])
@pytest.mark.parametrize("parity", [True, False])
def test_wide_skip_head_kernels_match_plain(cuda, s, c, t, parity):
    """S above 64: (128, 64) the head of the R = 128 probe
    (scripts/probe_r128_mfu.py), (128, 256) and (128, 128) its widest C,
    (100, 132) widths padded to 112 and 144.  The backward stages no W1^T
    there (y from W1 by ldmatrix.trans), and above C = 128 the forward
    reads leaky(skip) from global memory.  Bars as the wide head test's:
    with 128 skip columns a row more bf16 operands of dy may land one
    rounding step from the plain version's."""
    batch, rf = 2, 24
    a = _inputs(cuda, batch, t, s, c)
    a = {k: v.to(cuda) for k, v in a.items()}
    args = (a["skip"], a["pack"], a["w1"], a["b1"], a["w2"], a["b2"], rf,
            parity, 2 * batch)
    n0 = dict(kh.launch_counts)
    loss, match, p = kh.head_fwd(*args)
    wl, wm, wp = hl.head_fwd_plain(*args)
    np.testing.assert_allclose(float(loss), float(wl), rtol=1e-5)
    assert abs(float(match) - float(wm)) <= 1
    np.testing.assert_allclose(p.cpu().numpy(), wp.cpu().numpy(), rtol=0,
                               atol=2e-4)
    dloss = torch.tensor(1.0 / (batch * (t - rf)), device=cuda)
    bargs = (a["skip"], a["pack"], wp, a["w1"], a["b1"], a["w2"], a["b2"],
             rf, parity, dloss, 2 * batch)
    got = kh.head_bwd(*bargs)
    torch.cuda.synchronize()
    assert kh.launch_counts["head_fwd"] == n0["head_fwd"] + 1
    assert kh.launch_counts["head_bwd"] == n0["head_bwd"] + 1
    second = kh.head_bwd(*bargs)
    assert all(torch.equal(x, y) for x, y in zip(got, second))
    want = hl.head_bwd_plain(*bargs)
    for name, x, y in zip(("dskip", "dw1", "db1", "dw2", "db2"), got, want):
        x, y = x.float().cpu().numpy(), y.float().cpu().numpy()
        tol = (1e-2 if name == "dskip" else 1e-3) * np.abs(y).max()
        np.testing.assert_allclose(x, y, rtol=0, atol=tol, err_msg=name)


@pytest.mark.cuda
def test_f32_head_raises_above_s64(cuda):
    """The float32 head takes S <= 128 (ROADMAP.md B.4 widths (6) is built)
    and raises above it with its ROADMAP.md item, launching nothing."""
    a = _inputs(cuda, 2, 500, 132, 64, dtype=torch.float32)
    a = {k: v.to(cuda) for k, v in a.items()}
    before = dict(kh.launch_counts)
    with pytest.raises(NotImplementedError, match=r"B\.4"):
        kh.head_fwd(a["skip"], a["pack"], a["w1"], a["b1"], a["w2"],
                    a["b2"], 24, True, 4)
    assert kh.launch_counts == before
