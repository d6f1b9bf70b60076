"""One gated residual block of the training path: plain versions and the
autograd op.

The counterpart of ``movenet_tpu.ops.pallas.gated_block`` (``_fwd_kernel``
at gated_block.py:91 and ``_bwd_kernel`` at :168): one block, (h, ctx) ->
(res, skip), with its VJP.  It is the per-block route of the fused trunk
(``models/fused._per_block_trunk``), taken when no common stack tile
exists.

Numerics are the TPU kernels', which differ from the whole-stack trunk's:
every product takes float32 operands (``_dot``, no rounding to the
compute dtype) and sums in float32; ``gated`` is tanh * sigmoid of the
unrounded taps; res = out[:, :R] + h and skip = out[:, R:] are rounded to
h's dtype.  The backward recomputes fg from h, then dout = [dres | dskip],
dgated, dfg, the input gradients (dh[t] += dfg_past[t + d], the tap of
rows t < d being zero) in h's dtype and the weight and bias gradients in
float32, db_fg per batch row.

The kernels live in ``csrc/gated_block.cu`` behind
``ops/cuda/gated_block.py``; CPU tensors take ``gated_block_fwd_plain`` /
``gated_block_bwd_plain``.
"""

from __future__ import annotations

import torch

from movenet_tpu_torch.ops.stack_kernel import _shift, _unshift

# the JAX package's minimum kernel granularity (gated_block.py:41): the
# fused path asks T % TILE == 0; the port's kernels take any T
TILE = 128

# (split A, split B) of each product of the kernels (csrc/gated_block.cu),
# split-TF32 mma.sync as ops/stack_kernel.tf32_split_matmul models it: a
# float32 operand (W_fg, W_out, the unrounded gated, dfg) is split, a
# bf16 one ([h | h(t-d) | ctx], dout = [dres | dskip]) is exact
SPLIT_PASSES = {
    "fg": (False, True),       # [h | h(t-d) | ctx] W_fg
    "out": (True, True),       # gated W_out
    "dgated": (False, True),   # dout W_out^T
    "dfg_w": (True, True),     # dfg W_fg^T
    "dw_fg": (False, True),    # [h | h(t-d) | ctx]^T dfg
    "dw_out": (True, False),   # gated^T dout
}


def _hp(h, ctx, d):
    f32 = torch.float32
    parts = [h.to(f32), _shift(h.to(f32), d)]
    if ctx is not None:
        parts.append(ctx.to(f32))
    return torch.cat(parts, dim=-1)


def gated_block_fwd_plain(h, ctx, b_fg, w_fg, w_out, b_out, d: int):
    """(res (B,T,R), skip (B,T,S)) in h's dtype.  b_fg (B, 2R), w_fg
    (2R|3R, 2R), w_out (R, R+S), b_out (1, R+S), all float32."""
    r = h.shape[-1]
    f32 = torch.float32
    fg = torch.matmul(_hp(h, ctx, d), w_fg.to(f32)) + b_fg.to(f32)[:, None]
    gated = torch.tanh(fg[..., :r]) * torch.sigmoid(fg[..., r:])
    out = torch.matmul(gated, w_out.to(f32)) + b_out.to(f32)
    return (out[..., :r] + h.to(f32)).to(h.dtype), out[..., r:].to(h.dtype)


def gated_block_bwd_plain(h, ctx, b_fg, w_fg, w_out, dres, dskip, d: int):
    """The VJP of ``gated_block_fwd_plain``: (dh, dctx or None in h's
    dtype; db_fg (B, 2R), dw_fg (W_in, 2R), dw_out (R, R+S), db_out
    (1, R+S) float32)."""
    r = h.shape[-1]
    f32 = torch.float32
    hp = _hp(h, ctx, d)
    fg = torch.matmul(hp, w_fg.to(f32)) + b_fg.to(f32)[:, None]
    tf, sg = torch.tanh(fg[..., :r]), torch.sigmoid(fg[..., r:])
    dout = torch.cat([dres.to(f32), dskip.to(f32)], dim=-1)
    dgated = torch.matmul(dout, w_out.to(f32).t())
    dfg = torch.cat([dgated * sg * (1.0 - tf * tf),
                     dgated * tf * sg * (1.0 - sg)], dim=-1)
    dw_fg = torch.einsum("btk,btj->kj", hp, dfg)
    dw_out = torch.einsum("btk,btj->kj", tf * sg, dout)
    db_out = dout.sum(dim=(0, 1))[None]
    db_fg = dfg.sum(dim=1)
    dfg_w = torch.matmul(dfg, w_fg.to(f32).t())
    dh = dres.to(f32) + dfg_w[..., :r] + _unshift(dfg_w[..., r:2 * r], d)
    dctx = dfg_w[..., 2 * r:].to(h.dtype) if ctx is not None else None
    return dh.to(h.dtype), dctx, db_fg, dw_fg, dw_out, db_out


class _FusedGatedBlock(torch.autograd.Function):
    @staticmethod
    def forward(fctx, h, ctx, b_fg, w_fg, w_out, b_out, dilation):
        from movenet_tpu_torch.ops.cuda import gated_block as kern

        res, skip = kern.gated_block_fwd(h, ctx, b_fg, w_fg, w_out, b_out,
                                         dilation)
        fctx.dilation = dilation
        fctx.save_for_backward(h, ctx, b_fg, w_fg, w_out)
        return res, skip

    @staticmethod
    def backward(fctx, dres, dskip):
        from movenet_tpu_torch.ops.cuda import gated_block as kern

        h, ctx, b_fg, w_fg, w_out = fctx.saved_tensors
        dh, dctx, db_fg, dw_fg, dw_out, db_out = kern.gated_block_bwd(
            h, ctx, b_fg, w_fg, w_out, dres.to(h.dtype).contiguous(),
            dskip.to(h.dtype).contiguous(), fctx.dilation)
        return (dh, dctx, db_fg.to(b_fg.dtype), dw_fg.to(w_fg.dtype),
                dw_out.to(w_out.dtype), db_out, None)


def fused_gated_block(h, ctx, b_fg, w_fg, w_out, b_out, dilation: int):
    """One gated residual block (the JAX package's ``fused_gated_block``).

    Args:
      h: (B, T, R) residual-stream input, in the compute dtype.
      ctx: (B, T, R) context features in h's dtype, or None.
      b_fg: (B, 2R) per-example fg bias; w_fg (2R or 3R, 2R) packed
        [cur; past (; ctx)] tap weights; w_out (R, R+S) packed
        [residual | skip] projection; b_out (1, R+S); all float32.
      dilation: the causal lag.
    Returns:
      (res (B, T, R), skip (B, T, S)) in h's dtype.
    """
    return _FusedGatedBlock.apply(h, ctx, b_fg, w_fg, w_out, b_out,
                                  int(dilation))


__all__ = ["TILE", "SPLIT_PASSES", "gated_block_fwd_plain",
           "gated_block_bwd_plain", "fused_gated_block"]
