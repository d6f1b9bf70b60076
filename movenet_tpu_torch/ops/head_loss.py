"""Output head + cross-entropy of the training path: plain versions and
the autograd op.

The counterpart of ``movenet_tpu.ops.pallas.head_loss``: the unpacked
kernels ``_fwd_kernel`` at head_loss.py:281 and ``_bwd_kernel`` at :336,
and, behind the same module switch ``PACKED_HEAD`` (off by default, as
there), the packed ones ``_fwd_kernel_packed`` (:169) and
``_bwd_kernel_packed`` (:218).
From the skip sum the head computes y = leaky(skip) W1 + b1 and
z = leaky(y) W2 + b2, then per position the NLL (parity: log sum exp(p)
- p[y] on p = softmax(z), with no max subtraction since p lies in [0, 1];
clean: lse(z) - z[y]) and whether the target is the first argmax, both
summed over the valid rows [RF-1, T-1).  The softmax p is saved in
float32 for the backward, which forms dz from it alone.

Numerics are the TPU kernels': the products take operands in the skip's
dtype (the compute dtype) and sum in float32, biases are added in
float32, the softmax and every probability step are float32, and dskip
is stored in the compute dtype.  The packed route (S = C = 64, T even,
targets exactly B wide from column 0) computes the same head and CE with
float32 product operands, saves no softmax, and its backward rebuilds y,
z and the softmax from the skip sum.  The kernels live in
``csrc/head_loss.cu`` behind ``ops/cuda/head_loss.py``; CPU tensors take
``head_fwd_plain`` / ``head_bwd_plain`` (``head_fwd_packed_plain`` /
``head_bwd_packed_plain`` on the packed route).
"""

from __future__ import annotations

import torch

f32 = torch.float32

# The JAX package's switch (head_loss.py:412), off there: with it on, the
# calls that JAX sends to its packed kernels take the packed route here.
PACKED_HEAD = False

# (split A, split B) of each product of the packed kernels
# (csrc/head_loss.cu kPass*, split-TF32 mma.sync as
# ops/stack_kernel.tf32_split_matmul models it).  Every operand is float32
# and none is exact in TF32: W1 and W2, leaky(skip) (0.01 x where the
# bf16 skip is negative), leaky(y), dz and dy; so three passes each.
PACKED_SPLIT_PASSES = {
    "y": (True, True),        # leaky(skip) W1
    "z": (True, True),        # leaky(y) W2
    "dy": (True, True),       # dz W2^T
    "dskip": (True, True),    # dy W1^T
    "dw2": (True, True),      # leaky(y)^T dz
    "dw1": (True, True),      # leaky(skip)^T dy
}


def _pick_tile(t: int, d: int, cap: int = 4000) -> int:
    """The JAX package's tile rule (gated_block.py:42-53): the largest
    tile that divides T, is a multiple of 8, fits the dilation ring and
    is at most ``cap`` rows."""
    for tile in (16000, 8000, 4000, 2000, 1600, 1000, 800, 512, 500,
                 400, 256, 200, 128, 64, 32, 16, 8):
        if tile > cap or t % tile or tile % 8:
            continue
        if d < tile or d % tile == 0:
            return tile
    raise ValueError(f"no valid tile for T={t}, dilation={d}")


def _use_packed(t_total: int, s: int, c: int) -> bool:
    """JAX's ``_use_packed`` (head_loss.py:415): the switch, S = C = 64,
    T even, and a packed tile exists."""
    if not PACKED_HEAD:
        return False
    if not (s == 64 and c == 64 and t_total % 2 == 0):
        return False
    try:
        _pick_tile(t_total // 2, 1, cap=2000)
    except ValueError:
        return False
    return True


def packed_route(skip, pack, w2, tgt_off: int) -> bool:
    """Whether a call takes the packed kernels, as JAX's ``_fwd_pallas`` /
    ``_bwd_pallas`` decide (:522-523, :570-571)."""
    batch, t, s = skip.shape
    return tgt_off == 0 and pack.shape[1] == batch and \
        _use_packed(t, s, w2.shape[1])


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, 0.01 * x)


def _dleaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, 1.0, 0.01)


def row_products(mm=None):
    """(prod, wgrad) of the plain versions: prod(a, b) = a @ b and
    wgrad(a, b) = the sum over the leading dims of a^T b, by torch, or
    both by ``mm(a, b)`` (a (..., K), b (K, N)) when given: the float32
    kernels' products through ``ops/stack_kernel.split_matmul``."""
    if mm is None:
        return torch.matmul, lambda a, b: torch.einsum("btk,btj->kj", a, b)
    return mm, lambda a, b: mm(a.reshape(-1, a.shape[-1]).t(),
                               b.reshape(-1, b.shape[-1]))


def _core(skip, tgt, w1, b1, w2, b2, op_dt, mm=None):
    """(y, z, onehot, zmax) over rows of skip (..., S) in float32; ``mm``
    forms the products (``row_products``)."""
    def rnd(x):
        return x.to(op_dt).to(f32)

    mm, _ = row_products(mm)
    y = mm(rnd(_leaky(skip)), rnd(w1)) + b1.to(f32)
    z = mm(rnd(_leaky(y)), rnd(w2)) + b2.to(f32)
    onehot = torch.nn.functional.one_hot(tgt.long(), z.shape[-1]).to(f32)
    zmax = z.max(dim=-1, keepdim=True).values
    return y, z, onehot, zmax


def _nll_rows(z, p, onehot, parity: bool, zmax):
    if parity:
        lse = torch.log(torch.exp(p).sum(dim=-1, keepdim=True))
        picked = (p * onehot).sum(dim=-1, keepdim=True)
    else:
        lse = torch.log(torch.exp(z - zmax).sum(dim=-1, keepdim=True)) \
            + zmax
        picked = (z * onehot).sum(dim=-1, keepdim=True)
    return (lse - picked)[..., 0]


def _match_rows(z, tgt, zmax):
    """1 where the target is the FIRST maximal column (jnp.argmax)."""
    col = torch.arange(z.shape[-1], device=z.device)
    is_max = z == zmax
    first = torch.where(is_max, col, z.shape[-1]).min(dim=-1).values
    return (first == tgt.long()).to(f32)


def _targets(pack, batch: int, tgt_off: int) -> torch.Tensor:
    """(B, T) targets from pack columns [tgt_off, tgt_off + B)."""
    return pack[:, tgt_off:tgt_off + batch].t()


def _valid(t: int, rf: int, device) -> torch.Tensor:
    row = torch.arange(t, device=device)
    return ((row >= rf - 1) & (row < t - 1)).to(f32)


def head_fwd_plain(skip, pack, w1, b1, w2, b2, rf: int, parity: bool,
                   tgt_off: int = 0, save_p: bool = True, mm=None):
    """(loss_sum, match_count, p (B, T, C) float32 or None); ``mm`` forms
    the products (``ops/stack_kernel.split_matmul``: as the float32
    kernels do)."""
    batch, t, _ = skip.shape
    tgt = _targets(pack, batch, tgt_off)
    _, z, onehot, zmax = _core(skip.to(f32), tgt, w1, b1, w2, b2,
                               skip.dtype, mm)
    e = torch.exp(z - zmax)
    p = e / e.sum(dim=-1, keepdim=True)
    valid = _valid(t, rf, skip.device)
    nll = _nll_rows(z, p, onehot, parity, zmax)
    match = _match_rows(z, tgt, zmax)
    loss = (nll * valid).sum()
    count = (match * valid).sum()
    return loss, count, (p if save_p else None)


def head_bwd_plain(skip, pack, p, w1, b1, w2, b2, rf: int, parity: bool,
                   dloss, tgt_off: int = 0, mm=None):
    """(dskip in skip's dtype, dw1 (S, C), db1 (C,), dw2 (C, C), db2 (C,))
    float32 weight grads; ``mm`` forms the products
    (``ops/stack_kernel.split_matmul``: as the float32 kernels do)."""
    batch, t, _ = skip.shape
    dt = skip.dtype

    def rnd(x):
        return x.to(dt).to(f32)

    prod, wgrad = row_products(mm)
    sk = skip.to(f32)
    tgt = _targets(pack, batch, tgt_off)
    onehot = torch.nn.functional.one_hot(tgt.long(), p.shape[-1]).to(f32)
    y = prod(rnd(_leaky(sk)), rnd(w1)) + b1.to(f32)
    scale = (torch.as_tensor(dloss, dtype=f32, device=skip.device)
             * _valid(t, rf, skip.device))[:, None]
    if parity:
        ep = torch.exp(p)
        q = ep / ep.sum(dim=-1, keepdim=True)
        g = q - onehot
        dz = p * g - p * (p * g).sum(dim=-1, keepdim=True)
    else:
        dz = p - onehot
    dz = dz * scale
    ly = _leaky(y)
    dw2 = wgrad(rnd(ly), rnd(dz))
    db2 = dz.sum(dim=(0, 1))
    dy = prod(rnd(dz), rnd(w2).t()) * _dleaky(y)
    dw1 = wgrad(rnd(_leaky(sk)), rnd(dy))
    db1 = dy.sum(dim=(0, 1))
    dskip = (prod(rnd(dy), rnd(w1).t()) * _dleaky(sk)).to(dt)
    return dskip, dw1, db1, dw2, db2


def head_fwd_packed_plain(skip, pack, w1, b1, w2, b2, rf: int,
                          parity: bool):
    """(loss_sum, match_count) of the packed route: the head with float32
    operands (JAX's ``_dot``), no softmax saved; targets are ``pack``'s
    B columns."""
    batch, t, _ = skip.shape
    tgt = _targets(pack, batch, 0)
    _, z, onehot, zmax = _core(skip.to(f32), tgt, w1, b1, w2, b2, f32)
    e = torch.exp(z - zmax)
    p = e / e.sum(dim=-1, keepdim=True)
    valid = _valid(t, rf, skip.device)
    nll = _nll_rows(z, p, onehot, parity, zmax)
    match = _match_rows(z, tgt, zmax)
    return (nll * valid).sum(), (match * valid).sum()


def head_bwd_packed_plain(skip, pack, w1, b1, w2, b2, rf: int,
                          parity: bool, dloss):
    """(dskip in skip's dtype, dw1, db1, dw2, db2) of the packed route:
    y, z, e, seg and p rebuilt from skip with float32 operands, then dz as
    JAX's ``_bwd_kernel_packed`` forms it (head_loss.py:248-255)."""
    batch, t, _ = skip.shape
    sk = skip.to(f32)
    tgt = _targets(pack, batch, 0)
    y, z, onehot, m = _core(sk, tgt, w1, b1, w2, b2, f32)
    e = torch.exp(z - m)
    seg = e.sum(dim=-1, keepdim=True)
    scale = (torch.as_tensor(dloss, dtype=f32, device=skip.device)
             * _valid(t, rf, skip.device))[:, None]
    if parity:
        p = e / seg
        ep = torch.exp(p)
        q = ep / ep.sum(dim=-1, keepdim=True)
        g = q - onehot
        dz = (p * g - p * (p * g).sum(dim=-1, keepdim=True)) * scale
    else:
        dz = (e / seg - onehot) * scale
    ly = _leaky(y)
    dw2 = torch.einsum("btk,btj->kj", ly, dz)
    db2 = dz.sum(dim=(0, 1))
    dy = torch.matmul(dz, w2.to(f32).t()) * _dleaky(y)
    dw1 = torch.einsum("btk,btj->kj", _leaky(sk), dy)
    db1 = dy.sum(dim=(0, 1))
    dskip = (torch.matmul(dy, w1.to(f32).t()) * _dleaky(sk)).to(skip.dtype)
    return dskip, dw1, db1, dw2, db2


class _FusedHeadLoss(torch.autograd.Function):
    """The head/CE op; on the packed route no softmax is saved and the
    backward rebuilds it."""

    @staticmethod
    def forward(fctx, skip, pack, w1, b1, w2, b2, rf, parity, tgt_off):
        from movenet_tpu_torch.ops.cuda import head_loss as kern

        fctx.packed = packed_route(skip, pack, w2, tgt_off)
        if fctx.packed:
            loss, match = kern.head_fwd_packed(skip, pack, w1, b1, w2, b2,
                                               rf, parity)
            p = None
        else:
            loss, match, p = kern.head_fwd(skip, pack, w1, b1, w2, b2, rf,
                                           parity, tgt_off, save_p=True)
        fctx.rf, fctx.parity, fctx.tgt_off = rf, parity, tgt_off
        fctx.save_for_backward(skip, pack, p, w1, b1, w2, b2)
        fctx.mark_non_differentiable(match)
        return loss, match

    @staticmethod
    def backward(fctx, dloss, _dmatch):
        from movenet_tpu_torch.ops.cuda import head_loss as kern

        skip, pack, p, w1, b1, w2, b2 = fctx.saved_tensors
        if fctx.packed:
            dskip, dw1, db1, dw2, db2 = kern.head_bwd_packed(
                skip, pack, w1, b1, w2, b2, fctx.rf, fctx.parity, dloss)
        else:
            dskip, dw1, db1, dw2, db2 = kern.head_bwd(
                skip, pack, p, w1, b1, w2, b2, fctx.rf, fctx.parity, dloss,
                fctx.tgt_off)
        return (dskip, None, dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(b2.dtype), None, None, None)


def fused_head_loss(skip_sum, targets_pack, w1, b1, w2, b2, rf: int,
                    parity: bool, tgt_off: int = 0):
    """(loss_sum, match_count) over the valid rows [RF-1, T-1).

    ``targets_pack`` (T, >= tgt_off + B): row t of column tgt_off + b
    holds codes[b, t+1] (the last row is masked).  Without autograd (the
    eval call) the softmax is not saved.  With ``PACKED_HEAD`` on, the
    calls JAX routes to its packed kernels take the packed route."""
    needs_grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (skip_sum, w1, b1, w2, b2))
    if not needs_grad:
        from movenet_tpu_torch.ops.cuda import head_loss as kern

        if packed_route(skip_sum, targets_pack, w2, tgt_off):
            return kern.head_fwd_packed(skip_sum, targets_pack, w1, b1, w2,
                                        b2, rf, parity)
        loss, match, _ = kern.head_fwd(skip_sum, targets_pack, w1, b1, w2,
                                       b2, rf, parity, tgt_off,
                                       save_p=False)
        return loss, match
    return _FusedHeadLoss.apply(skip_sum, targets_pack, w1, b1, w2, b2,
                                rf, parity, tgt_off)


__all__ = ["PACKED_HEAD", "PACKED_SPLIT_PASSES", "head_fwd_plain",
           "head_bwd_plain", "head_fwd_packed_plain",
           "head_bwd_packed_plain", "fused_head_loss"]
