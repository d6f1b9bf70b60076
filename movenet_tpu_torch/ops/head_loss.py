"""Output head + cross-entropy of the training path: plain versions and
the autograd op.

The counterpart of ``movenet_tpu.ops.pallas.head_loss`` (the unpacked
kernels ``_fwd_kernel`` at head_loss.py:281 and ``_bwd_kernel`` at :336).
From the skip sum the head computes y = leaky(skip) W1 + b1 and
z = leaky(y) W2 + b2, then per position the NLL (parity: log sum exp(p)
- p[y] on p = softmax(z), with no max subtraction since p lies in [0, 1];
clean: lse(z) - z[y]) and whether the target is the first argmax, both
summed over the valid rows [RF-1, T-1).  The softmax p is saved in
float32 for the backward, which forms dz from it alone.

Numerics are the TPU kernels': the products take operands in the skip's
dtype (the compute dtype) and sum in float32, biases are added in
float32, the softmax and every probability step are float32, and dskip
is stored in the compute dtype.  The kernels live in
``csrc/head_loss.cu`` behind ``ops/cuda/head_loss.py``; CPU tensors take
``head_fwd_plain`` / ``head_bwd_plain``.
"""

from __future__ import annotations

import torch

f32 = torch.float32


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, 0.01 * x)


def _dleaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, 1.0, 0.01)


def _core(skip, tgt, w1, b1, w2, b2, op_dt):
    """(y, z, onehot, zmax) over rows of skip (..., S) in float32."""
    def rnd(x):
        return x.to(op_dt).to(f32)

    y = torch.matmul(rnd(_leaky(skip)), rnd(w1)) + b1.to(f32)
    z = torch.matmul(rnd(_leaky(y)), rnd(w2)) + b2.to(f32)
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
                   tgt_off: int = 0, save_p: bool = True):
    """(loss_sum, match_count, p (B, T, C) float32 or None)."""
    batch, t, _ = skip.shape
    tgt = _targets(pack, batch, tgt_off)
    _, z, onehot, zmax = _core(skip.to(f32), tgt, w1, b1, w2, b2,
                               skip.dtype)
    e = torch.exp(z - zmax)
    p = e / e.sum(dim=-1, keepdim=True)
    valid = _valid(t, rf, skip.device)
    nll = _nll_rows(z, p, onehot, parity, zmax)
    match = _match_rows(z, tgt, zmax)
    loss = (nll * valid).sum()
    count = (match * valid).sum()
    return loss, count, (p if save_p else None)


def head_bwd_plain(skip, pack, p, w1, b1, w2, b2, rf: int, parity: bool,
                   dloss, tgt_off: int = 0):
    """(dskip in skip's dtype, dw1 (S, C), db1 (C,), dw2 (C, C), db2 (C,))
    float32 weight grads."""
    batch, t, _ = skip.shape
    dt = skip.dtype

    def rnd(x):
        return x.to(dt).to(f32)

    sk = skip.to(f32)
    tgt = _targets(pack, batch, tgt_off)
    onehot = torch.nn.functional.one_hot(tgt.long(), p.shape[-1]).to(f32)
    y = torch.matmul(rnd(_leaky(sk)), rnd(w1)) + b1.to(f32)
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
    dw2 = torch.einsum("btk,btj->kj", rnd(ly), rnd(dz))
    db2 = dz.sum(dim=(0, 1))
    dy = torch.matmul(rnd(dz), rnd(w2).t()) * _dleaky(y)
    dw1 = torch.einsum("btk,btj->kj", rnd(_leaky(sk)), rnd(dy))
    db1 = dy.sum(dim=(0, 1))
    dskip = (torch.matmul(rnd(dy), rnd(w1).t()) * _dleaky(sk)).to(dt)
    return dskip, dw1, db1, dw2, db2


class _FusedHeadLoss(torch.autograd.Function):
    @staticmethod
    def forward(fctx, skip, pack, w1, b1, w2, b2, rf, parity, tgt_off):
        from movenet_tpu_torch.ops.cuda import head_loss as kern

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
    eval call) the softmax is not saved."""
    needs_grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (skip_sum, w1, b1, w2, b2))
    if not needs_grad:
        from movenet_tpu_torch.ops.cuda import head_loss as kern

        loss, match, _ = kern.head_fwd(skip_sum, targets_pack, w1, b1, w2,
                                       b2, rf, parity, tgt_off,
                                       save_p=False)
        return loss, match
    return _FusedHeadLoss.apply(skip_sum, targets_pack, w1, b1, w2, b2,
                                rf, parity, tgt_off)


__all__ = ["head_fwd_plain", "head_bwd_plain", "fused_head_loss"]
