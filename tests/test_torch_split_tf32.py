"""The save backward's split-TF32 products (csrc/stack_kernel.cu), the
gated-block kernels' (csrc/gated_block.cu) and the packed head kernels'
(csrc/head_loss.cu, S = C = 64) on the CPU, through the plain
emulation of the kernels' operand handling in ``ops/stack_kernel`` (TF32
rounding as ``cvt.rna.tf32.f32`` rounds, the big/small split, each
product's passes).  Inputs from a numpy seed at the breakdancing widths
(R = S = 64: K = R+S = 2R = 128, W_in = 3R = 192) over 4096 rows.  Every
product must lie within 1e-4 of its scale of the float64 product, the
bar the CUDA tests hold the kernels' gradients to; one-pass TF32 must
not, which is why the split exists."""

import numpy as np
import pytest
import torch

from movenet_tpu_torch.ops import gated_block as gb
from movenet_tpu_torch.ops import head_loss as hl
from movenet_tpu_torch.ops import stack_kernel as sk

R, S, WIN, ROWS = 64, 64, 192, 4096


def _bf16(x):
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).to(
        torch.float32)


def _f32(x):
    return torch.from_numpy(x.astype(np.float32))


def _operands(seed=0):
    """(A, B) of each product of the backward, float32 tensors holding
    what the kernels load: activations widened from bf16, gradients and
    weights in float32."""
    rng = np.random.default_rng(seed)
    hp = _bf16(rng.normal(0, 0.5, (ROWS, WIN)))           # [h | h(t-d) | ctx]
    tf = _bf16(np.tanh(rng.normal(0, 1, (ROWS, R))))
    sg = _bf16(1 / (1 + np.exp(-rng.normal(0, 1, (ROWS, R)))))
    gated = tf * sg
    dout = _f32(rng.normal(0, 1e-3, (ROWS, R + S)))        # [dh | dskip]
    dfg = _f32(rng.normal(0, 1e-3, (ROWS, 2 * R)))
    w_out = _f32(rng.normal(0, R ** -0.5, (R, R + S)))
    w_fg = _f32(rng.normal(0, WIN ** -0.5, (WIN, 2 * R)))
    xc = _bf16(rng.normal(0, 0.5, (ROWS // 10, R)))
    dctx = _f32(rng.normal(0, 1e-3, (ROWS // 10, 10 * R)))
    return {"dgated": (dout, w_out.t()), "dfg_w": (dfg, w_fg.t()),
            "dw_fg": (hp.t(), dfg), "dw_out": (gated.t(), dout),
            "dw_up": (xc.t(), dctx)}


def _gated_operands(seed=0):
    """(A, B) of each product of the gated-block kernels, as they load
    them: [h | h(t-d) | ctx] and dout = [dres | dskip] widened from bf16,
    W_fg and W_out in float32, gated = tanh(f) sigmoid(g) unrounded from
    a float32 fg, and dfg from dgated in float32."""
    rng = np.random.default_rng(seed)
    hp = _bf16(rng.normal(0, 0.5, (ROWS, WIN)))
    w_fg = _f32(rng.normal(0, WIN ** -0.5, (WIN, 2 * R)))
    w_out = _f32(rng.normal(0, R ** -0.5, (R, R + S)))
    fg = torch.matmul(hp, w_fg) + _f32(rng.normal(0, 0.1, (1, 2 * R)))
    tf, sg = torch.tanh(fg[:, :R]), torch.sigmoid(fg[:, R:])
    gated = tf * sg
    dout = _bf16(rng.normal(0, 1e-3, (ROWS, R + S)))
    dgated = torch.matmul(dout, w_out.t())
    dfg = torch.cat([dgated * sg * (1 - tf * tf),
                     dgated * tf * sg * (1 - sg)], dim=1)
    return {"fg": (hp, w_fg), "out": (gated, w_out),
            "dgated": (dout, w_out.t()), "dfg_w": (dfg, w_fg.t()),
            "dw_fg": (hp.t(), dfg), "dw_out": (gated.t(), dout)}


def _rel_err(got, a, b):
    want = torch.matmul(a.double(), b.double())
    return float((got.double() - want).abs().max() / want.abs().max())


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10          # a TF32 step above 1
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -20, 1.0 + 2.0 ** -10,
                      1.0 + 3 * 2.0 ** -11, 0.0], dtype=torch.float32)
    got = sk.tf32_rna(x).tolist()
    assert got == [one, -one, 1.0, one, 1.0 + 2.0 ** -9, 0.0]


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_values_and_their_products_split_exactly(seed):
    """An operand of at most 16 significant bits (bf16, or tf * sg) is
    big + small exactly, each part in TF32; a bf16 value is its own
    big part (no second pass)."""
    rng = np.random.default_rng(seed)
    x = _bf16(rng.normal(0, 1, 20000))
    y = _bf16(rng.normal(0, 1, 20000))
    big, small = sk.tf32_split(x)
    assert torch.equal(big, x) and not small.any()
    prod = x * y
    assert torch.equal(prod.double(), x.double() * y.double())
    big, small = sk.tf32_split(prod)
    assert torch.equal(big + small, prod)
    assert torch.equal(big.double() + small.double(), prod.double())
    assert torch.equal(sk.tf32_rna(small), small)
    assert torch.equal(sk.tf32_rna(big), big)


def test_float32_split_leaves_about_2_to_the_minus_22():
    x = _f32(np.random.default_rng(3).normal(0, 1, 20000))
    big, small = sk.tf32_split(x)
    rest = (x.double() - big.double() - small.double()).abs()
    assert float((rest / x.double().abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("name", sorted(sk.BWD_SPLIT_PASSES))
def test_split_products_hold_float32_tolerance(name):
    a, b = _operands()[name]
    split_a, split_b = sk.BWD_SPLIT_PASSES[name]
    got = sk.tf32_split_matmul(a, b, split_a, split_b)
    assert _rel_err(got, a, b) <= 1e-4


@pytest.mark.parametrize("name", sorted(sk.BWD_SPLIT_PASSES))
def test_one_pass_tf32_misses_the_tolerance(name):
    a, b = _operands()[name]
    got = sk.tf32_split_matmul(a, b, False, False)
    assert _rel_err(got, a, b) > 1e-4


def test_exact_operands_need_no_split():
    """A bf16 operand split or not gives the same product bits: the
    two-pass products lose nothing to the missing pass."""
    ops = _operands()
    for name in ("dw_fg", "dw_up"):
        a, b = ops[name]
        assert torch.equal(sk.tf32_split_matmul(a, b, False, True),
                           sk.tf32_split_matmul(a, b, True, True))


def test_gated_operands_are_as_the_kernels_load_them():
    """bf16 operands need no split (one TF32 part); gated and dfg are
    float32 values that do."""
    ops = _gated_operands()
    for name, (a, b) in ops.items():
        for x, split in zip((a, b), gb.SPLIT_PASSES[name]):
            exact = torch.equal(sk.tf32_rna(x), x)
            assert exact != split, name


@pytest.mark.parametrize("name", sorted(gb.SPLIT_PASSES))
def test_gated_split_products_hold_float32_tolerance(name):
    a, b = _gated_operands()[name]
    got = sk.tf32_split_matmul(a, b, *gb.SPLIT_PASSES[name])
    assert _rel_err(got, a, b) <= 1e-4


@pytest.mark.parametrize("name", sorted(gb.SPLIT_PASSES))
def test_gated_one_pass_tf32_misses_the_tolerance(name):
    a, b = _gated_operands()[name]
    got = sk.tf32_split_matmul(a, b, False, False)
    assert _rel_err(got, a, b) > 1e-4


def _packed_operands(seed=0):
    """(A, B) of each product of the packed head kernels (S = C = 64), as
    they load them: leaky of the bf16 skip, W1 and W2 in float32, leaky(y)
    from a float32 y, dz from the parity softmax of z and dy = dz W2^T *
    dleaky(y), both float32."""
    rng = np.random.default_rng(seed)
    c = 64
    skip = _bf16(rng.normal(0, 1, (ROWS, c)))
    w1 = _f32(rng.normal(0, 0.25, (c, c)))
    w2 = _f32(rng.normal(0, 1 / 3, (c, c)))
    lskip = torch.where(skip > 0, skip, 0.01 * skip)
    y = torch.matmul(lskip, w1) + _f32(rng.normal(0, 0.1, (1, c)))
    ly = torch.where(y > 0, y, 0.01 * y)
    z = torch.matmul(ly, w2) + _f32(rng.normal(0, 0.1, (1, c)))
    p = torch.softmax(z, -1)
    g = torch.softmax(p, -1) - torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, c, ROWS)), c).float()
    dz = (p * g - p * (p * g).sum(-1, keepdim=True)) / ROWS
    dy = torch.matmul(dz, w2.t()) * torch.where(y > 0, 1.0, 0.01)
    return {"y": (lskip, w1), "z": (ly, w2), "dy": (dz, w2.t()),
            "dskip": (dy, w1.t()), "dw2": (ly.t(), dz),
            "dw1": (lskip.t(), dy)}


def test_packed_operands_are_as_the_kernels_load_them():
    """Every operand of the packed kernels is a float32 value that TF32
    does not hold (leaky(skip) too: 0.01 x of a negative bf16 x), so
    every product splits both."""
    ops = _packed_operands()
    assert sorted(ops) == sorted(hl.PACKED_SPLIT_PASSES)
    for name, (a, b) in ops.items():
        for x, split in zip((a, b), hl.PACKED_SPLIT_PASSES[name]):
            exact = torch.equal(sk.tf32_rna(x), x)
            assert exact != split, name


@pytest.mark.parametrize("name", sorted(hl.PACKED_SPLIT_PASSES))
def test_packed_split_products_hold_float32_tolerance(name):
    a, b = _packed_operands()[name]
    got = sk.tf32_split_matmul(a, b, *hl.PACKED_SPLIT_PASSES[name])
    assert _rel_err(got, a, b) <= 1e-4


@pytest.mark.parametrize("name", sorted(hl.PACKED_SPLIT_PASSES))
def test_packed_one_pass_tf32_misses_the_tolerance(name):
    a, b = _packed_operands()[name]
    got = sk.tf32_split_matmul(a, b, False, False)
    assert _rel_err(got, a, b) > 1e-4
