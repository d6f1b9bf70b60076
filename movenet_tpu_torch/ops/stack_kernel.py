"""Whole-stack WaveNet trunk of the training path: geometry, plain
versions and the autograd ops.

The counterpart of ``movenet_tpu.ops.pallas.stack_kernel`` for its three
VJP strategies:

  save       ``fused_stack_embed``, the front embedding folded in, or
             ``fused_stack``, which takes the embedded h (``front_embed``)
             and returns dx.  The forward runs every gated block over the
             whole sequence and keeps each layer's input ``hsave`` (L, B,
             T, R) and its packed gating taps ``tfsg`` = [tanh f | sigmoid
             g] (L, B, T, 2R) for the backward, both in the compute dtype;
  recompute  ``fused_stack`` with that strategy.  The forward keeps only
             layer checkpoints ``ckpt`` (n_ckpt, B, T, R): the input h_l
             of every k-th layer, l = k, 2k, ... < L, k =
             ``tails_every(L)`` (about sqrt(L); h_0 is x, kept anyway).
             The backward walks the groups of k layers from the top,
             rebuilds each group's layer inputs from its checkpoint and
             sweeps the group's layers top down;
  replay     ``fused_stack`` with that strategy: the save strategy without
             hsave.  The forward keeps x, tfsg and the float32 residual
             stream h at the inputs of layers k, 2k, ... (float32
             checkpoints); the backward rebuilds each group's float32 layer
             inputs from its checkpoint with the save forward's own
             residual update (``replay_rebuild``: the save forward's
             residual stream bit for bit, hsave its rounding) and runs the
             save backward on them.  As in the TPU kernel W_fg's gradient
             takes the float32 h and h(t-d), the rows t with t mod tile < d
             of h(t-d) rounded to the compute dtype (the TPU kernel's ring
             snapshot; tile = ``pick_stack_tile(T, dilations, ctx)``), so
             in bf16 dW_fg differs from the save strategy's and every other
             gradient is the save strategy's bit for bit; in float32 all
             are.

The kernels live in ``csrc/stack_kernel.cu`` behind
``ops/cuda/stack_kernel.py``; tensors on the CPU take the plain versions
here (``stack_fwd_plain`` / ``stack_bwd_plain``, ``stack_fwd_x_plain`` /
``stack_bwd_x_plain``, ``stack_fwd_tails_plain`` /
``stack_bwd_tails_plain``, ``stack_fwd_replay_plain`` /
``stack_bwd_replay_plain``, ``stack_head_fwd_plain`` /
``stack_head_bwd_plain``), which compute the same functions with torch
ops over whole sequences.

Numerics of the save strategy are the TPU kernels' (stack_kernel.py:280
and :1486):

  forward   the residual stream h stays float32; every product has its
            operands rounded to the compute dtype and sums in float32;
            the embedded h is rounded; the taps are stored rounded and
            ``gated`` is formed from the rounded taps; biases are added
            in float32 after each product; the skip sum accumulates in
            float32 and is stored rounded;
  backward  every product has float32 operands (the stored activations
            widen exactly); the bias gradients are the column sums of
            the same operands; the stride-10 video projection's backward
            splits dctx into (T/10, 10, R) phases; dxc and a flat dctx
            are stored in the compute dtype.

The recompute strategy's differ (stack_kernel.py:929 and :1031):

  forward   h is rounded to the compute dtype after every layer (so the
            backward rebuilds it bit for bit); ``gated`` is formed from
            the unrounded float32 taps and rounded as a product operand;
  backward  the rebuilt fg product has compute-dtype operands; the
            gradient products have float32 operands; dfg comes from the
            unrounded taps; dx and a flat dctx are stored in the compute
            dtype.  A projection triple is folded outside the op
            (``ctx_proj_fold``).

So a recompute step is not bit-equal to a save step.

``fused_stack_head_loss`` merges the save trunk with the output head and
the CE loss (stack_kernel.py:464 and :624): its forward forms ``gated``
from the unrounded taps (as the recompute forward does) and runs the head
on the skip sum rounded to the compute dtype; its backward rebuilds the
head from the saved skip, forms dskip in float32 with float32 operands
and feeds it to the save layer sweep unrounded.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Sequence

import torch
import torch.nn.functional as F

from movenet_tpu_torch.ops import head_loss as hl

UPSAMPLE_STRIDE = 10
# hsave above this many bytes makes the auto strategy pick "recompute"
_SAVE_ALL_BUDGET_BYTES = 1 << 30
# the front embedding is folded into the kernel up to this 2V
EMBED_MAX_2V = 512


# ------------------------------------------------------------ geometry
def pick_stack_tile(t: int, dilations, ctx: bool = False) -> int:
    """The JAX package's common time tile (MOVENET_STACK_TILE first).

    The port's kernels do not tile by it; it decides, as in the JAX
    package, which VJP strategy applies and whether the video projection
    may travel as the coarse triple (``models/fused._ctx_proj_tile_ok``),
    so that both packages take the same path on the same shapes."""
    prefer = (1600, 2000, 4000, 1000, 800, 512, 500, 400, 256, 200,
              128, 64, 32, 16, 8)
    want = int(os.environ.get("MOVENET_STACK_TILE", "0"))
    if want:
        prefer = (want,) + prefer
    passes = (True, False) if ctx else (False,)
    for need80 in passes:
        for tile in prefer:
            if t % tile or tile % 8:
                continue
            if need80 and tile % 80:
                continue
            if all(d < tile or d % tile == 0 for d in dilations):
                return tile
    raise ValueError(f"no stack tile for T={t}, dilations={dilations}")


def supports_recompute(t: int, dilations) -> bool:
    """The JAX package's tails-recompute VJP needs every dilation inside
    one of its tiles; the port's layer-major kernels take any dilation
    but apply the same condition, so both packages pick one strategy."""
    try:
        tile = pick_stack_tile(t, dilations)
    except ValueError:
        return False
    return all(d < tile for d in dilations)


def resolve_strategy(strategy: str, x_shape, n_layers: int,
                     dilations, itemsize: int = 2) -> str:
    """"save", "recompute" or "replay", as the JAX package picks it:
    "auto" saves unless hsave exceeds 1 GiB and recompute applies."""
    if strategy not in ("auto", "save", "recompute", "replay"):
        raise ValueError(f"unknown fused_stack strategy: {strategy!r}")
    b, t, r = x_shape
    can_recompute = supports_recompute(t, dilations)
    if strategy in ("recompute", "replay"):
        if not can_recompute:
            raise ValueError(
                f"{strategy} strategy needs every dilation inside one "
                f"tile (T={t}, dilations={tuple(dilations)})")
        return strategy
    if strategy == "save":
        return "save"
    hsave_bytes = n_layers * b * t * r * itemsize
    if can_recompute and hsave_bytes > _SAVE_ALL_BUDGET_BYTES:
        return "recompute"
    return "save"


# -------------------------------------------------------- embedding
def _embed_onehot(pack: torch.Tensor, batch: int, vocab: int
                  ) -> torch.Tensor:
    """(B, T, 2V) float32 packed causal-embedding one-hot: the current
    code's one-hot in columns [0, V), the previous code's in [V, 2V).
    Codes outside [0, V) (the -1 that marks t=0) give zero rows."""
    codes = pack[:, :batch].t().long()
    prev = pack[:, batch:2 * batch].t().long()

    def onehot(c):
        ok = (c >= 0) & (c < vocab)
        return F.one_hot(torch.where(ok, c, 0), vocab).to(torch.float32) \
            * ok[..., None].to(torch.float32)

    return torch.cat([onehot(codes), onehot(prev)], dim=-1)


def _embed(pack: torch.Tensor, table2: torch.Tensor, batch: int
           ) -> torch.Tensor:
    """h[b, t] = cur[codes[b, t]] + past[codes[b, t-1]] in float32."""
    vocab = table2.shape[0] // 2
    tab = table2.to(torch.float32)
    codes = pack[:, :batch].t().long()
    prev = pack[:, batch:2 * batch].t().long()
    ok_c = ((codes >= 0) & (codes < vocab))[..., None]
    ok_p = ((prev >= 0) & (prev < vocab))[..., None]
    cur = torch.where(ok_c, tab[codes.clamp(0, vocab - 1)], 0.0)
    past = torch.where(ok_p, tab[vocab + prev.clamp(0, vocab - 1)], 0.0)
    return cur + past


# ------------------------------------------------------- ctx projection
def ctx_is_proj(ctx) -> bool:
    """True when ctx is the (xc, wup, bup) coarse-projection triple."""
    return isinstance(ctx, (tuple, list)) and len(ctx) == 3


def ctx_flatten(ctx, dtype) -> torch.Tensor:
    """(xc, wup, bup) -> flat (B, T, R) conditioning in ``dtype``, the
    VideoEncoder's final dense stage and reshape."""
    xc, wup, bup = ctx
    b, tc, r = xc.shape
    z = torch.matmul(xc.to(dtype), wup.to(dtype)) + bup.to(dtype)
    return z.reshape(b, tc * UPSAMPLE_STRIDE, r)


def _ctx_proj_args(ctx):
    """(xc, wup_t) from the triple; wup_t (10, R, R) holds each phase's
    transposed projection W_p^T."""
    xc, wup, _ = ctx
    r = xc.shape[-1]
    wup_t = wup.reshape(r, UPSAMPLE_STRIDE, r).permute(1, 2, 0)
    return xc, wup_t.contiguous()


def _ctx_proj_grads(dwup_aug, ctx):
    """(10, R+1, R) ones-augmented grad -> (dwup, dbup) in the shapes
    (and dtypes) of the triple's Dense parameters."""
    xc, wup, bup = ctx
    r = xc.shape[-1]
    dwup = dwup_aug[:, :r, :].permute(1, 0, 2).reshape(
        r, UPSAMPLE_STRIDE * r)
    dbup = dwup_aug[:, r, :].reshape(UPSAMPLE_STRIDE * r)
    return dwup.to(wup.dtype), dbup.to(bup.dtype)


def ctx_proj_fold(dctx_flat: torch.Tensor, ctx):
    """Flat (B, T, R) dctx -> (dxc (B, T/10, R), ones-augmented weight
    gradient (10, R+1, R)), float32: the projection triple's backward in
    torch ops (the JAX package's ``_ctx_proj_fold_xla``)."""
    xc, wup, _ = ctx
    b, tc, r = xc.shape
    f32 = torch.float32
    dz = dctx_flat.to(f32).reshape(b, tc, UPSAMPLE_STRIDE, r)
    dw = torch.einsum("bqe,bqpr->per", xc.to(f32), dz)
    db = dz.sum(dim=(0, 1))
    dwup_aug = torch.cat([dw, db[:, None, :]], dim=1)
    wup3 = wup.to(f32).reshape(r, UPSAMPLE_STRIDE, r)
    dxc = torch.einsum("bqpr,epr->bqe", dz, wup3)
    return dxc, dwup_aug


# ------------------------------------------------------ front embedding
class _FrontEmbed(torch.autograd.Function):
    """h[t] = cur[codes[t]] + past[codes[t-1]] (zero past at t = 0) in the
    compute dtype; the gradients are one-hot products with float32 sums,
    as the JAX package's ``models/fused._front_embed``."""

    @staticmethod
    def forward(fctx, cur_table, past_table, codes, dt):
        codes = codes.long()
        cur = cur_table.to(dt)[codes]
        prev = past_table.to(dt)[codes]
        fctx.save_for_backward(codes)
        fctx.dt = dt
        fctx.vocab = cur_table.shape[0]
        return cur + F.pad(prev, (0, 0, 1, 0))[:, :-1]

    @staticmethod
    def backward(fctx, dh):
        (codes,) = fctx.saved_tensors
        f32 = torch.float32
        r = dh.shape[-1]
        dhr = dh.to(fctx.dt).to(f32)
        onehot = F.one_hot(codes, fctx.vocab).to(f32)
        dcur = onehot.reshape(-1, fctx.vocab).t() @ dhr.reshape(-1, r)
        # past[codes[t]] feeds h[t+1]
        dpast = onehot[:, :-1].reshape(-1, fctx.vocab).t() \
            @ dhr[:, 1:].reshape(-1, r)
        return dcur, dpast, None, None


def front_embed(cur_table: torch.Tensor, past_table: torch.Tensor,
                codes: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """(B, T) codes -> (B, T, R) embedded h in ``dt``: the front causal
    convolution as a table lookup, with the JAX package's one-hot
    backward (deterministic float32 sums)."""
    return _FrontEmbed.apply(cur_table, past_table, codes, dt)


# ------------------------------------------------------ plain versions
def _shift(x: torch.Tensor, d: int) -> torch.Tensor:
    """x[:, t-d] along time (dim 1), zero for t < d."""
    if d >= x.shape[1]:
        return torch.zeros_like(x)
    return F.pad(x, (0, 0, d, 0))[:, :x.shape[1]]


def _unshift(x: torch.Tensor, d: int) -> torch.Tensor:
    """x[:, t+d] along time (dim 1), zero for t + d >= T."""
    if d >= x.shape[1]:
        return torch.zeros_like(x)
    return F.pad(x[:, d:], (0, 0, 0, d))


def _save_fwd(h, ctx, b_fg, w_fg, w_out, b_out, dilations, dt,
              raw_gate: bool, matmul=torch.matmul, acc=torch.float32,
              keep=None):
    """The save forward from the float32 input h: (skip_sum float32,
    hsave, tfsg in ``dt``).  ``gated`` is formed from the rounded taps
    (``_fwd_kernel``), or from the unrounded ones with ``raw_gate``
    (``_fwd_kernel_head``, stack_kernel.py:513).  ``matmul`` forms both
    products (``mma_order_matmul``: in the layer kernel's order); ``acc``
    is the dtype of every sum (float64: a reference for the orders).
    ``keep`` (layer indices): the replay forward, which keeps no hsave but
    the unrounded h (in ``acc``) at the input of those layers in its
    place, (len(keep), B, T, R)."""
    def rnd(x):
        return x.to(dt).to(acc)

    batch, _, r = h.shape
    n_layers = len(dilations)
    h = h.to(acc)
    bfg = b_fg.to(acc).reshape(n_layers, batch, 1, 2 * r)
    ctxf = ctx.to(acc) if ctx is not None else None
    skip = None
    hsave, tfsg = [], []
    for l, d in enumerate(dilations):
        hr = rnd(h)
        if keep is None:
            hsave.append(hr.to(dt))
        elif l in keep:
            hsave.append(h)
        parts = [hr, rnd(_shift(h, d))] + ([ctxf] if ctxf is not None
                                            else [])
        fg = matmul(torch.cat(parts, dim=-1), rnd(w_fg[l])) + bfg[l]
        raw = torch.cat([torch.tanh(fg[..., :r]),
                         torch.sigmoid(fg[..., r:])], dim=-1)
        v = rnd(raw)
        tfsg.append(v.to(dt))
        g = raw if raw_gate else v
        gated = g[..., :r] * g[..., r:]
        out = matmul(rnd(gated), rnd(w_out[l])) + b_out[l].to(acc)
        skip = out[..., r:] if skip is None else skip + out[..., r:]
        h = out[..., :r] + h
    kept = torch.stack(hsave) if hsave else h.new_zeros((0,) + h.shape)
    return skip, kept, torch.stack(tfsg)


def stack_fwd_plain(pack, table2, ctx, b_fg, w_fg, w_out, b_out,
                    dilations: Sequence[int], batch: int):
    """(skip_sum (B,T,S), hsave (L,B,T,R), tfsg (L,B,T,2R)), all in
    table2's dtype (the compute dtype); ctx is None or flat (B,T,R)."""
    dt = table2.dtype
    h = _embed(pack, table2, batch).to(dt).to(torch.float32)
    skip, hsave, tfsg = _save_fwd(h, ctx, b_fg, w_fg, w_out, b_out,
                                  dilations, dt, raw_gate=False)
    return skip.to(dt), hsave, tfsg


def stack_fwd_x_plain(x, ctx, b_fg, w_fg, w_out, b_out,
                      dilations: Sequence[int]):
    """The non-embed save forward (B.2(a)): ``stack_fwd_plain`` from the
    embedded input x (B, T, R) in the compute dtype instead of the
    codes; the same returns, in x's dtype."""
    skip, hsave, tfsg = _save_fwd(x.to(torch.float32), ctx, b_fg, w_fg,
                                  w_out, b_out, dilations, x.dtype,
                                  raw_gate=False)
    return skip.to(x.dtype), hsave, tfsg


# The backward's products by name: the layer's dgated = [dh | dskip]
# W_out^T and dfg_w = dfg W_fg^T, W_fg's and W_out's gradients, and the
# recompute backward's fg (its rebuilt layers and fg formed again).
BWD_PRODUCTS = ("dgated", "dfg_w", "dw_fg", "dw_out", "fg")


def all_products(mm=None, wgrad=None) -> dict:
    """The plain backwards' ``products`` that form every product by
    ``mm(a, b)`` (a (..., K), b (K, N); None: torch's), and the weight
    gradients by ``wgrad`` where it is given."""
    return {k: wgrad if wgrad is not None and k.startswith("dw") else mm
            for k in BWD_PRODUCTS}


def _products(products):
    """{name: (prod, wgrad)} (``hl.row_products``) of each product of
    ``products`` (matmuls by name; a name not given, or None: torch's)."""
    return {k: hl.row_products((products or {}).get(k))
            for k in BWD_PRODUCTS}


def _save_bwd(hsave, tfsg, ctx, w_fg, w_out, dskip, dilations,
              tap_round=None, products=None):
    """The layer sweep of the save backward: (dh of the stack's input,
    dctx or None, db_fg (L, B, 2R), dw_fg, dw_out, db_out), float32.
    dskip may be in the compute dtype or float32 (the merged head's).
    ``products`` forms the four products in place of torch's (``_products``:
    ``all_products(split_matmul)`` as the float32 kernels form them,
    ``wide_bwd_products`` as the wide bf16 kernels do).  ``tap_round`` =
    (dt, tile): the replay backward, whose float32 layer inputs feed W_fg's
    gradient with the rows t of h(t-d), t mod tile < d, rounded to dt."""
    n_layers, batch, t, two_r = tfsg.shape
    r = two_r // 2
    f32 = torch.float32
    pr = _products(products)

    ctxf = ctx.to(f32) if ctx is not None else None
    dsk = dskip.to(f32)
    dh = torch.zeros(batch, t, r, dtype=f32, device=tfsg.device)
    dctx = torch.zeros_like(dh) if ctx is not None else None
    db_fg = torch.zeros(n_layers, batch, two_r, dtype=f32,
                        device=tfsg.device)
    dw_fg, dw_out, db_out = [None] * n_layers, [None] * n_layers, \
        [None] * n_layers
    for l in reversed(range(n_layers)):
        d = dilations[l]
        h = hsave[l].to(f32)
        sh = _shift(h, d)
        if tap_round is not None:
            dt, tile = tap_round
            ring = (torch.arange(t, device=h.device) % tile < d)[None, :,
                                                                 None]
            sh = torch.where(ring, sh.to(dt).to(f32), sh)
        parts = [h, sh] + ([ctxf] if ctxf is not None else [])
        hp = torch.cat(parts, dim=-1)
        v = tfsg[l].to(f32)
        tf, sg = v[..., :r], v[..., r:]
        dout = torch.cat([dh, dsk], dim=-1)
        dgated = pr["dgated"][0](dout, w_out[l].to(f32).t())
        dfg = torch.cat([dgated * (sg * (1.0 - tf * tf)),
                         dgated * (tf * (sg - sg * sg))], dim=-1)
        gated = tf * sg
        dw_fg[l] = pr["dw_fg"][1](hp, dfg)
        db_fg[l] = dfg.sum(dim=1)
        dw_out[l] = pr["dw_out"][1](gated, dout)
        db_out[l] = dout.sum(dim=(0, 1))
        dfg_w = pr["dfg_w"][0](dfg, w_fg[l].to(f32).t())
        dh = dh + dfg_w[..., :r] + _unshift(dfg_w[..., r:2 * r], d)
        if dctx is not None:
            dctx = dctx + dfg_w[..., 2 * r:]
    return (dh, dctx, db_fg, torch.stack(dw_fg), torch.stack(dw_out),
            torch.stack(db_out))


def _dctx_out(dctx, proj, dt):
    """(dctx out, dwup_aug): the flat dctx in ``dt``, or with ``proj`` =
    (xc, wup_t) the stride-10 projection's backward folded in: coarse
    dxc (B, T/10, R) in ``dt`` and the ones-augmented (10, R+1, R)."""
    if proj is None:
        return (dctx.to(dt) if dctx is not None else None), None
    f32 = torch.float32
    xc, wup_t = proj
    batch, t, r = dctx.shape
    tc = t // UPSAMPLE_STRIDE
    dz = dctx.reshape(batch, tc, UPSAMPLE_STRIDE, r)
    xc1 = torch.cat([xc.to(f32),
                     torch.ones(batch, tc, 1, dtype=f32, device=xc.device)],
                    dim=-1)
    dwup_aug = torch.einsum("bqe,bqpr->per", xc1, dz)
    dxc = torch.einsum("bqpj,pje->bqe", dz, wup_t.to(f32))
    return dxc.to(dt), dwup_aug


def stack_bwd_plain(hsave, tfsg, ctx, w_fg, w_out, dskip, pack,
                    vocab: int, dilations: Sequence[int], proj=None):
    """The backward of ``stack_fwd_plain`` from its saved tensors.

    ``proj`` = (xc, wup_t) folds the stride-10 projection's backward in.
    Returns (dtab (2V, R), dctx, db_fg (L*B, 2R), dw_fg (L, W_in, 2R),
    dw_out (L, R, R+S), db_out (L, R+S), dwup_aug (10, R+1, R) or None),
    float32 except dctx: flat (B, T, R) or coarse dxc (B, T/10, R) in the
    compute dtype, or None without ctx."""
    n_layers, batch, _, two_r = tfsg.shape
    dh, dctx, db_fg, dw_fg, dw_out, db_out = _save_bwd(
        hsave, tfsg, ctx, w_fg, w_out, dskip, dilations)
    onehot = _embed_onehot(pack, batch, vocab)
    dtab = torch.einsum("btv,btr->vr", onehot, dh)
    dctx_out, dwup_aug = _dctx_out(dctx, proj, tfsg.dtype)
    return (dtab, dctx_out, db_fg.reshape(n_layers * batch, two_r),
            dw_fg, dw_out, db_out, dwup_aug)


def stack_bwd_x_plain(hsave, tfsg, ctx, w_fg, w_out, dskip,
                      dilations: Sequence[int], proj=None, tap_round=None,
                      products=None):
    """The backward of ``stack_fwd_x_plain``: as ``stack_bwd_plain`` with
    dx (B, T, R) in the compute dtype in place of the table gradient
    (``tap_round``, ``products``: ``_save_bwd``'s)."""
    n_layers, batch, _, two_r = tfsg.shape
    dh, dctx, db_fg, dw_fg, dw_out, db_out = _save_bwd(
        hsave, tfsg, ctx, w_fg, w_out, dskip, dilations,
        tap_round=tap_round, products=products)
    dctx_out, dwup_aug = _dctx_out(dctx, proj, tfsg.dtype)
    return (dh.to(tfsg.dtype), dctx_out,
            db_fg.reshape(n_layers * batch, two_r), dw_fg, dw_out, db_out,
            dwup_aug)


# --------------------------------------------------- replay strategy
def stack_fwd_replay_plain(x, ctx, b_fg, w_fg, w_out, b_out,
                           dilations: Sequence[int], every: int = 0):
    """The replay forward (``_fwd_kernel`` with save_h=False): the save
    forward from x without hsave.  Returns (skip_sum (B,T,S) and tfsg
    (L,B,T,2R) in x's dtype; ckpt (n_ckpt, B, T, R) float32, ckpt[i] the
    float32 residual stream h at the input of layer (i + 1) k, k = every
    or ``tails_every(L)``)."""
    n_layers = len(dilations)
    every = every or tails_every(n_layers)
    skip, ckpt, tfsg = _save_fwd(x.to(torch.float32), ctx, b_fg, w_fg,
                                 w_out, b_out, dilations, x.dtype,
                                 raw_gate=False,
                                 keep=ckpt_layers(n_layers, every))
    return skip.to(x.dtype), ckpt, tfsg


def replay_rebuild(h, tfsg, w_out, b_out, dt, lo: int, hi: int):
    """The float32 layer inputs h_lo .. h_{hi-1} from h = the float32 h_lo:
    h_{l+1} = out[..., :R] + h_l with out = rnd(gated) rnd(W_out) + b_out
    over all R+S columns and gated from the rounded taps, as ``_save_fwd``
    forms them, so the save forward's residual stream bit for bit, hsave[lo
    .. hi) its rounding to ``dt`` (the replay backward's rebuild)."""
    def rnd(v):
        return v.to(dt).to(torch.float32)

    r = h.shape[-1]
    hs = []
    for l in range(lo, hi):
        hs.append(h)
        if l + 1 < hi:
            v = tfsg[l].to(torch.float32)
            out = torch.matmul(rnd(v[..., :r] * v[..., r:]), rnd(w_out[l])) \
                + b_out[l].to(torch.float32)
            h = out[..., :r] + h
    return hs


def stack_bwd_replay_plain(x, ckpt, tfsg, ctx, w_fg, w_out, b_out, dskip,
                           dilations: Sequence[int], proj=None,
                           every: int = 0, products=None):
    """The backward of ``stack_fwd_replay_plain``: the float32 layer inputs
    rebuilt group by group from x and the checkpoints (``replay_rebuild``),
    then the save backward's sweep on them with W_fg's gradient as the TPU
    kernel forms it (``_save_bwd``'s ``tap_round``; ``products`` its).  The
    returns (dx, dctx, db_fg, dw_fg, dw_out, db_out, dwup_aug) are the save
    backward's from the same x bit for bit, but for dw_fg in bf16."""
    n_layers = len(dilations)
    every = every or tails_every(n_layers)
    if ckpt.shape[0] != len(ckpt_layers(n_layers, every)):
        raise ValueError(f"{ckpt.shape[0]} checkpoints, expected "
                         f"{len(ckpt_layers(n_layers, every))} for L="
                         f"{n_layers}, every {every}")
    hs = []
    for lo in range(0, n_layers, every):
        h0 = x if lo == 0 else ckpt[lo // every - 1]
        hs += replay_rebuild(h0.to(torch.float32), tfsg, w_out, b_out,
                             x.dtype, lo, min(lo + every, n_layers))
    tile = pick_stack_tile(x.shape[1], dilations, ctx is not None)
    return stack_bwd_x_plain(torch.stack(hs), tfsg, ctx, w_fg, w_out, dskip,
                             dilations, proj, (x.dtype, tile), products)


# ------------------------------------------- merged trunk + head + CE
def stack_head_fwd_plain(x, ctx, b_fg, w_fg, w_out, b_out, targets_tb,
                         w1, b1, w2, b2, dilations: Sequence[int], rf: int,
                         parity: bool):
    """The merged forward (``_fwd_kernel_head``): the save trunk from x
    with ``gated`` from the unrounded taps, then the head and CE on the
    skip sum rounded to x's dtype, over the valid rows [RF-1, T-1).
    Returns (loss_sum, match_count, skip (B,T,S), hsave, tfsg)."""
    skip, hsave, tfsg = _save_fwd(x.to(torch.float32), ctx, b_fg, w_fg,
                                  w_out, b_out, dilations, x.dtype,
                                  raw_gate=True)
    skip = skip.to(x.dtype)
    # targets_tb (T, B) is a head pack with its targets at column 0
    loss, match, _ = hl.head_fwd_plain(skip, targets_tb, w1, b1, w2, b2, rf,
                                       parity, 0, save_p=False)
    return loss, match, skip, hsave, tfsg


def _head_bwd_merged(skip, targets_tb, w1, b1, w2, b2, dloss, rf: int,
                     parity: bool):
    """The head backward of ``_bwd_kernel_head`` (stack_kernel.py:667-697):
    y and z rebuilt from the saved skip with compute-dtype operands, the
    softmax, dz, then every gradient product with float32 operands.
    Returns (dskip float32, dw1, db1, dw2, db2)."""
    f32 = torch.float32
    batch, t, _ = skip.shape
    sk = skip.to(f32)
    tgt = targets_tb.t()
    y, z, onehot, zmax = hl._core(sk, tgt, w1, b1, w2, b2, skip.dtype)
    e = torch.exp(z - zmax)
    p = e / e.sum(dim=-1, keepdim=True)
    scale = (torch.as_tensor(dloss, dtype=f32, device=skip.device)
             * hl._valid(t, rf, skip.device))[:, None]
    if parity:
        ep = torch.exp(p)
        q = ep / ep.sum(dim=-1, keepdim=True)
        g = q - onehot
        dz = p * g - p * (p * g).sum(dim=-1, keepdim=True)
    else:
        dz = p - onehot
    dz = dz * scale
    ly = hl._leaky(y)
    dw2 = torch.einsum("btk,btj->kj", ly, dz)
    db2 = dz.sum(dim=(0, 1))
    dy = torch.matmul(dz, w2.to(f32).t()) * hl._dleaky(y)
    lskip = hl._leaky(sk)
    dw1 = torch.einsum("btk,btj->kj", lskip, dy)
    db1 = dy.sum(dim=(0, 1))
    dskip = torch.matmul(dy, w1.to(f32).t()) * hl._dleaky(sk)
    return dskip, dw1, db1, dw2, db2


def stack_head_bwd_plain(hsave, tfsg, ctx, w_fg, w_out, skip, targets_tb,
                         w1, b1, w2, b2, dloss, dilations: Sequence[int],
                         rf: int, parity: bool):
    """The merged backward (``_bwd_kernel_head``): the head backward from
    the saved skip, then the save layer sweep from its float32 dskip
    (unrounded, unlike the split route's).  Returns (dx, dctx or None in
    the compute dtype; db_fg (L*B, 2R), dw_fg, dw_out, db_out, dw1 (S, C),
    db1 (C,), dw2 (C, C), db2 (C,) float32)."""
    dskip, dw1, db1, dw2, db2 = _head_bwd_merged(
        skip, targets_tb, w1, b1, w2, b2, dloss, rf, parity)
    dx, dctx, db_fg, dw_fg, dw_out, db_out, _ = stack_bwd_x_plain(
        hsave, tfsg, ctx, w_fg, w_out, dskip, dilations)
    return dx, dctx, db_fg, dw_fg, dw_out, db_out, dw1, db1, dw2, db2


# --------------------------------------- split-TF32 operand handling
# The save backward's kernels (csrc/stack_kernel.cu) run its float32
# products on the tensor cores in TF32, each float32 operand split into a
# big and a small TF32 part as it is loaded.  Per product, whether each
# operand is split (an operand exact in TF32 is not): (A split, B split)
# for the product A B.  Two splits take three passes, one split two.
BWD_SPLIT_PASSES = {
    "dgated": (True, True),    # [dh | dskip] W_out^T (layer launch)
    "dfg_w": (True, True),     # dfg W_fg^T (layer launch)
    "dw_fg": (False, True),    # [hsave | hsave(t-d) | ctx]^T dfg (bf16 A)
    "dw_out": (True, True),    # gated^T [dh | dskip], gated = tf * sg
    "dw_up": (False, True),    # xc^T dctx, the projection (bf16 A)
}
# The accumulation chunk of the wide float32 recompute kernels' wgmma
# products (csrc/stack_kernel.cu, "the wide float32 recompute kernels"):
# the tensor core sums each chunk of 16 k (two k steps of 8, three passes
# each) from zero, and the chunk is added in float32.  Chosen on the card
# against float64 (tests/test_torch_wgmma_cuda.py, PERF.md).
WIDE_F32_CHUNK = 16
# The float32 save kernels' products (stack_layer_f32_kernel, and the
# backward's float32 form): every operand is float32 and none is exact in
# TF32 (hsave, ctx, gated and xc are no longer bf16 values), so every
# product splits both operands: three passes.
F32_SPLIT_PASSES = {
    "fg": (True, True),        # [h | h(t-d) | ctx] W_fg (forward)
    "out": (True, True),       # gated W_out (forward)
    "dgated": (True, True),    # [dh | dskip] W_out^T
    "dfg_w": (True, True),     # dfg W_fg^T
    "dw_fg": (True, True),     # [hsave | hsave(t-d) | ctx]^T dfg
    "dw_out": (True, True),    # gated^T [dh | dskip]
    "dw_up": (True, True),     # xc^T dctx
}


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit significand bits) to
    nearest, ties away from zero, as ``cvt.rna.tf32.f32`` rounds: half a
    TF32 unit added to the magnitude bits, then the 13 low bits cleared."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(big, small), both TF32 values: big = tf32(x), small = tf32(x -
    big).  big + small is x to about 2^-22 of |x|, and exactly x where x
    has at most 22 significant bits (a bf16 value, or a product of two)."""
    big = tf32_rna(x)
    return big, tf32_rna(x.to(torch.float32) - big)


def tf32_split_matmul(a: torch.Tensor, b: torch.Tensor, split_a: bool,
                      split_b: bool) -> torch.Tensor:
    """``a @ b`` (float32) as the kernels form it: each split operand as
    big + small, the other rounded to TF32 once; the passes small*big,
    big*small (those the splits call for) and big*big, each an exact sum
    of TF32 products rounded to float32, added in float32 in that order.
    With neither operand split this is one-pass TF32."""
    f64 = torch.float64
    ab, a_s = tf32_split(a) if split_a else (tf32_rna(a), None)
    bb, b_s = tf32_split(b) if split_b else (tf32_rna(b), None)
    passes = []
    if a_s is not None:
        passes.append((a_s, bb))
    if b_s is not None:
        passes.append((ab, b_s))
    passes.append((ab, bb))
    out = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32,
                      device=a.device)
    for u, v in passes:
        out = out + torch.matmul(u.to(f64), v.to(f64)).to(torch.float32)
    return out


def split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (a (..., K) and b (K, N), float32) as the float32 kernels
    form it: both operands split, three passes (``tf32_split_matmul``)."""
    out = tf32_split_matmul(a.reshape(-1, a.shape[-1]), b, True, True)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def kstep_split_matmul(a: torch.Tensor, b: torch.Tensor, chunk: int = 8,
                       split_a: bool = True) -> torch.Tensor:
    """``a @ b`` (a (..., K) and b (K, N), float32) in the float32 kernels'
    order: k in chunks of ``chunk`` (8: one k step of the ``mma.sync``
    kernels; ``WIDE_F32_CHUNK`` for the wide kernels' ``wgmma`` products),
    each chunk's split-TF32 passes (small * big, big * small, big * big;
    without ``split_a``, A exact in TF32 as ``BWD_SPLIT_PASSES`` marks a bf16
    operand, the last two) summed from zero, each pass's exact
    sum rounded to float32, then the chunk added in float32 (mma_split_add,
    wg_chunk_add).  ``split_matmul`` sums each pass over all of K before
    rounding; this is the order the kernels sum in, up to the tensor core's
    rounding inside a pass."""
    f64, f32 = torch.float64, torch.float32
    a2 = a.reshape(-1, a.shape[-1])
    ab, a_s = tf32_split(a2) if split_a else (tf32_rna(a2), None)
    bb, b_s = (v.to(f64) for v in tf32_split(b))
    ab = ab.to(f64)
    passes = ([(a_s.to(f64), bb)] if split_a else []) + [(ab, b_s), (ab, bb)]
    out = torch.zeros(a2.shape[0], b.shape[1], dtype=f32, device=a.device)
    for k0 in range(0, a2.shape[1], chunk):
        k = slice(k0, k0 + chunk)
        t = None
        for u, v in passes:
            p = u[:, k] @ v[k]
            t = p.to(f32) if t is None else (t.to(f64) + p).to(f32)
        out = out + t
    return out.reshape(*a.shape[:-1], b.shape[-1])


def wide_bwd_products(replay: bool = False) -> dict:
    """The wide bf16 backwards' products as their kernels sum them at R =
    128 (``_save_bwd``'s and ``stack_bwd_tails_plain``'s ``products``):
    dgated and dfg_w split-TF32 on ``wgmma`` (stack_bwd_wg_kernel), both
    operands split; W_fg's gradient (stack_wgrad_wg_kernel) over rows, its
    A split only in the replay backward (MODE 7, the rebuilt float32 h;
    MODE 0's A is bf16, exact in TF32: ``BWD_SPLIT_PASSES["dw_fg"]``); each
    ``WIDE_F32_CHUNK`` of k summed from zero and added in float32 (the
    kernels' per-(batch, chunk) partial sums of W_fg's gradient, reduced in
    order, are summed here in one run of chunks); W_out's gradient as torch
    sums it (its kernel is unchanged: mma.sync, the tensor core's sum over
    all rows); the recompute's fg formed again, and its rebuilt layers, in
    bf16 k steps of 16 as the wide forward sums them
    (``mma_order_matmul``)."""
    wg = functools.partial(kstep_split_matmul, chunk=WIDE_F32_CHUNK)
    return {"dgated": wg, "dfg_w": wg,
            "dw_fg": functools.partial(wg, split_a=replay),
            "dw_out": None, "fg": mma_order_matmul}


def img_offsets(rows: int, kc: int) -> torch.Tensor:
    """(rows, kc) float offsets of each element (r, k) of an operand image
    of the wgmma kernels (csrc/wgmma_tf32.cuh ``img_off``): 8 x 4 core
    matrices, those of a row group of 8 in k order, the row groups after
    each other."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(kc)[None, :]
    return (r // 8) * (kc * 8) + (k // 4) * 32 + (r % 8) * 4 + k % 4


def _images(mat: torch.Tensor, kc: int = 16) -> torch.Tensor:
    """``mat`` (rows, K), K a multiple of kc, as the wgmma kernels' images:
    per chunk of kc k its TF32 big part, then its small part
    (``tf32_split``), each laid out by ``img_offsets``."""
    rows, kdim = mat.shape
    off = img_offsets(rows, kc).reshape(-1)
    out = []
    for part in tf32_split(mat.float()):
        img = torch.empty(kdim // kc, rows * kc, dtype=torch.float32)
        img[:, off] = part.reshape(rows, kdim // kc, kc).transpose(0, 1) \
            .reshape(kdim // kc, rows * kc)
        out.append(img)
    return torch.stack(out, 1).reshape(-1)


def wide_f32_weight_images(w_fg: torch.Tensor, w_out: torch.Tensor,
                           bwd: bool = False,
                           fwd: bool = True) -> torch.Tensor:
    """The plain version of the wide float32 recompute kernels' weight
    split (csrc/stack_kernel.cu ``stack_wt_split_kernel``): the flat
    float32 scratch it writes from w_fg (L, W_in, 2R) and w_out (L, R, R+S).
    Every layer's images for kernel A: W_fg^T in two passes of R rows (W_in
    k), each R/2 filter columns and then their R/2 gate columns, and W_out^T
    (R k) as its R residual rows, then its S skip rows; with ``bwd`` then
    every layer's for kernel B: W_out (R rows, R+S k zero to a multiple of
    16) and W_fg (2R k) as W_in/R passes of R rows.  Without ``fwd`` kernel
    B's alone: the images the wide bf16 backwards take (their wrappers'
    ``img``, ``movenet_stack_wt_bwd_elems``)."""
    n_layers, win, two_r = w_fg.shape
    r, no = two_r // 2, w_out.shape[2]
    half = r // 2
    n = torch.arange(r)
    ch = [half * p + torch.where(n < half, n, r + n - half) for p in (0, 1)]
    parts = [torch.cat([_images(w_fg[l].t()[ch[0]]),
                        _images(w_fg[l].t()[ch[1]]),
                        _images(w_out[l].t()[:r]), _images(w_out[l].t()[r:])])
             for l in range(n_layers)] if fwd else []
    if bwd:
        k1 = -(-no // 16) * 16
        for l in range(n_layers):
            wo = torch.zeros(r, k1, dtype=torch.float32)
            wo[:, :no] = w_out[l]
            parts.append(torch.cat(
                [_images(wo)] + [_images(w_fg[l][p * r:(p + 1) * r])
                                 for p in range(win // r)]))
    return torch.cat(parts)


def stack_fwd_f32_split(pack, table2, ctx, b_fg, w_fg, w_out, b_out,
                        dilations: Sequence[int], batch: int):
    """``stack_fwd_plain`` in float32 as the float32 save forward kernels
    compute it: fg and out from split-TF32 products, layer by layer
    (skip_sum, hsave, tfsg in float32)."""
    h = _embed(pack, table2.float(), batch)
    ctx = ctx.float() if ctx is not None else None
    return _save_fwd(h, ctx, b_fg, w_fg, w_out, b_out, dilations,
                     torch.float32, raw_gate=False, matmul=split_matmul)


def stack_bwd_f32_split(hsave, tfsg, ctx, w_fg, w_out, dskip, pack,
                        vocab: int, dilations: Sequence[int], proj=None):
    """``stack_bwd_plain`` in float32 as the float32 save backward kernels
    compute it: the four products of every layer and the projection's
    weight gradient split-TF32; the table gradient, dxc and the bias
    gradients float32 sums as the kernels' (same returns)."""
    n_layers, batch, _, two_r = tfsg.shape
    dh, dctx, db_fg, dw_fg, dw_out, db_out = _save_bwd(
        hsave, tfsg, ctx, w_fg, w_out, dskip, dilations,
        products=all_products(split_matmul))
    dtab = torch.einsum("btv,btr->vr", _embed_onehot(pack, batch, vocab), dh)
    dctx_out, dwup_aug = _dctx_out(dctx, proj, torch.float32)
    if proj is not None:
        xc, _ = proj
        r = xc.shape[-1]
        dz = dctx.reshape(-1, UPSAMPLE_STRIDE * r)
        dwup = split_matmul(xc.reshape(-1, r).float().t(), dz)
        dwup_aug = torch.cat([dwup.reshape(r, UPSAMPLE_STRIDE, r)
                              .permute(1, 0, 2), dwup_aug[:, r:]], dim=1)
    return (dtab, dctx_out, db_fg.reshape(n_layers * batch, two_r), dw_fg,
            dw_out, db_out, dwup_aug)


def stack_fwd_tails_f32_split(x, ctx, b_fg, w_fg, w_out, b_out,
                              dilations: Sequence[int], every: int = 0):
    """``stack_fwd_tails_plain`` in float32 as the float32 recompute
    forward kernels compute it: fg and out from split-TF32 products, layer
    by layer (skip_sum, ckpt in float32)."""
    return stack_fwd_tails_plain(
        x.float(), ctx.float() if ctx is not None else None, b_fg, w_fg,
        w_out, b_out, dilations, every, split_matmul)


def stack_bwd_tails_f32_split(x, ckpt, ctx, b_fg, w_fg, w_out, b_out,
                              dskip, dilations: Sequence[int],
                              every: int = 0):
    """``stack_bwd_tails_plain`` in float32 as the float32 recompute
    backward kernels compute it: the rebuilt layers' products, fg again and
    the four products of every layer split-TF32 (same returns)."""
    return stack_bwd_tails_plain(
        x.float(), ckpt.float(), ctx.float() if ctx is not None else None,
        b_fg, w_fg, w_out, b_out, dskip.float(), dilations, every,
        all_products(split_matmul))


# ------------------------------------------- tensor-core summation order
# The trunk's layer kernel (csrc/stack_kernel.cu stack_layer_kernel, every
# forward form) runs its products as bf16 mma.sync m16n8k16: each 16-wide k
# step's products of bf16 values, exact in float32, are summed by the
# tensor core from zero and the step's sum is added to the float32 running
# sum in k order (mma_bf16_add).  The merged head's y and z sum the same
# way, and its row reductions run across a quad of lanes.  On the card the
# plain versions' float32 products (cuBLAS at these shapes) are one fmaf
# chain over k per element instead.  In the save forms the kernel keeps the
# plain version's bits wherever a bf16 rounding feeds a later layer: fg
# elements near a rounding tie are summed again as the chain sums them, and
# the residual's out is the chain.  The functions below model these
# orders on the CPU (a tensor-core step's sum taken exactly, then rounded
# to float32).
MMA_K_STEP = 16
# the kernel's re-sum margin (empirical, not a bound), in float32
# rounding units of |a|_2 |w|_2 (kTie)
MMA_TIE_UNITS = 8


def mma_order_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (float32 operands holding compute-dtype values) summed as
    the layer kernel sums it: each 16-wide k step's sum of products in
    float64, rounded to float32, added to the float32 sum in k order."""
    f32, f64 = torch.float32, torch.float64
    out = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=f32,
                      device=a.device)
    for k0 in range(0, a.shape[-1], MMA_K_STEP):
        step = torch.matmul(a[..., k0:k0 + MMA_K_STEP].to(f64),
                            b[k0:k0 + MMA_K_STEP].to(f64))
        out = out + step.to(f32)
    return out


def chain_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (float32 operands holding compute-dtype values) as one
    fmaf chain over k per element, from zero: the products are exact in
    float32, so each step is a float32 add."""
    out = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32,
                      device=a.device)
    for k in range(a.shape[-1]):
        out = out + a[..., k:k + 1] * b[k]
    return out


def _near_bf16_tie(v: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """The kernel's near_bf16_tie: v within tau of the bf16 rounding tie
    inside its bf16 interval, or tau above a quarter of half the interval."""
    u = v.contiguous().view(torch.int32) & -65536
    lo = u.view(torch.float32)
    mid = (u | 0x8000).view(torch.float32)
    return ((v - mid).abs() < tau) | (tau > 0.25 * (mid - lo).abs())


def _gate_kernel_order(a, w, bias, r: int, raw_gate: bool,
                       exact_ties: bool):
    """[tanh f | sigmoid g] (float32) of fg = a w + bias as the save layer
    kernel forms it: fg in ``mma_order_matmul``'s order and, with
    ``exact_ties``, the elements near a rounding tie of tf, sg (or of tf *
    sg with ``raw_gate``) summed again as ``chain_matmul``."""
    fg = mma_order_matmul(a, w) + bias
    t, s = torch.tanh(fg[..., :r]), torch.sigmoid(fg[..., r:])
    if not exact_ties:
        return torch.cat([t, s], dim=-1)
    unit = MMA_TIE_UNITS * 2.0 ** -24
    bound = a.norm(dim=-1, keepdim=True) * w.norm(dim=0)
    tt = (1 - t * t) * unit * bound[..., :r] + 4 * unit * t.abs()
    ts = s * (1 - s) * unit * bound[..., r:] + 4 * unit * s
    ff, fs = _near_bf16_tie(t, tt), _near_bf16_tie(s, ts)
    if raw_gate:
        fp = _near_bf16_tie(t * s, s.abs() * tt + t.abs() * ts
                            + 4 * unit * (t * s).abs())
        ff, fs = ff | fp, fs | fp
    exact = chain_matmul(a, w) + bias
    t = torch.where(ff, torch.tanh(exact[..., :r]), t)
    s = torch.where(fs, torch.sigmoid(exact[..., r:]), s)
    return torch.cat([t, s], dim=-1)


def stack_fwd_x_mma_order(x, ctx, b_fg, w_fg, w_out, b_out,
                          dilations: Sequence[int], raw_gate: bool = False,
                          exact_ties: bool = True):
    """``stack_fwd_x_plain`` (``raw_gate``: the merged form's layers) as
    the save layer kernel computes it: (skip_sum, hsave, tfsg) in x's
    dtype.  fg in ``mma_order_matmul``'s order with the elements near a
    tie summed again (``exact_ties``), the residual's out as
    ``chain_matmul``, the skip part's in ``mma_order_matmul``'s order.
    Without ``exact_ties`` every product is in the tensor-core order."""
    f32, dt = torch.float32, x.dtype

    def rnd(v):
        return v.to(dt).to(f32)

    h = x.to(f32)
    batch, _, r = h.shape
    n_layers = len(dilations)
    bfg = b_fg.to(f32).reshape(n_layers, batch, 1, 2 * r)
    ctxf = ctx.to(f32) if ctx is not None else None
    skip, hsave, tfsg = None, [], []
    for l, d in enumerate(dilations):
        hr = rnd(h)
        hsave.append(hr.to(dt))
        parts = [hr, rnd(_shift(h, d))] + ([ctxf] if ctxf is not None
                                            else [])
        raw = _gate_kernel_order(torch.cat(parts, dim=-1), rnd(w_fg[l]),
                                 bfg[l], r, raw_gate, exact_ties)
        v = rnd(raw)
        tfsg.append(v.to(dt))
        g = raw if raw_gate else v
        gated = rnd(g[..., :r] * g[..., r:])
        wo, bo = rnd(w_out[l]), b_out[l].to(f32)
        res = (chain_matmul if exact_ties else mma_order_matmul)(
            gated, wo[:, :r])
        out_s = mma_order_matmul(gated, wo[:, r:]) + bo[r:]
        skip = out_s if skip is None else skip + out_s
        h = (res + bo[:r]) + h
    return skip.to(dt), torch.stack(hsave), torch.stack(tfsg)


def quad_order_sum(v: torch.Tensor) -> torch.Tensor:
    """The sum over the last dim (C columns, zero-padded to a multiple of
    16) as the merged head's quad of lanes forms it: lane q adds columns
    8j + 2q and 8j + 2q + 1 in order of j, then the quad adds (q0 + q1) +
    (q2 + q3)."""
    c = v.shape[-1]
    cp = -(-c // MMA_K_STEP) * MMA_K_STEP
    w = F.pad(v, (0, cp - c)).reshape(*v.shape[:-1], cp // 8, 4, 2)
    lane = torch.zeros(*v.shape[:-1], 4, dtype=v.dtype, device=v.device)
    for j in range(cp // 8):
        for e in range(2):
            lane = lane + w[..., j, :, e]
    return (lane[..., 0] + lane[..., 1]) + (lane[..., 2] + lane[..., 3])


def head_fwd_quad_order(skip, targets_tb, w1, b1, w2, b2, rf: int,
                        parity: bool):
    """(loss_sum, match_count) of the merged head on skip (B, T, S) in the
    compute dtype, as the layer kernel's last merged layer forms them: y
    and z in ``mma_order_matmul``'s order, each row's max, first argmax,
    exp sum and (parity) sum of exp(p) over its quad of lanes
    (``quad_order_sum``); ``head_core::row_nll``'s semantics."""
    f32, dt = torch.float32, skip.dtype

    def rnd(v):
        return v.to(dt).to(f32)

    batch, t, _ = skip.shape
    y = mma_order_matmul(rnd(hl._leaky(skip.to(f32))), rnd(w1)) \
        + b1.to(f32)
    z = mma_order_matmul(rnd(hl._leaky(y)), rnd(w2)) + b2.to(f32)
    tgt = targets_tb.t().long()
    zmax = z.max(dim=-1, keepdim=True).values
    col = torch.arange(z.shape[-1], device=z.device)
    first = torch.where(z == zmax, col, z.shape[-1]).min(dim=-1).values
    e = torch.exp(z - zmax)
    es = quad_order_sum(e)
    if parity:
        p = e / es[..., None]
        nll = torch.log(quad_order_sum(torch.exp(p))) \
            - p.gather(-1, tgt[..., None])[..., 0]
    else:
        nll = torch.log(es) + zmax[..., 0] \
            - z.gather(-1, tgt[..., None])[..., 0]
    valid = hl._valid(t, rf, skip.device)
    return (nll * valid).sum(), ((first == tgt).to(f32) * valid).sum()


def tails_every(n_layers: int) -> int:
    """Layers per checkpoint group of the recompute strategy, about
    sqrt(L): the forward keeps ceil(L/k) - 1 checkpoints and the backward
    k - 1 rebuilt layer inputs at a time, (B, T, R) each."""
    return math.isqrt(max(n_layers, 1) - 1) + 1


def ckpt_layers(n_layers: int, every: int) -> range:
    """The layers whose input the recompute forward keeps: k, 2k, ..."""
    return range(every, n_layers, every)


def _tails_layer(h, ctxf, bfg, w_fg, w_out, b_out, d, dt,
                 mm=torch.matmul):
    """One layer of the recompute forward from h (float32 holding
    compute-dtype values): (the next h, rounded; the skip part), with
    the weights rounded to ``dt`` and ``gated`` from the unrounded
    taps, rounded as a product operand.  ``mm`` forms both products."""
    f32 = torch.float32

    def rnd(v):
        return v.to(dt).to(f32)

    r = h.shape[-1]
    parts = [h, _shift(h, d)] + ([ctxf] if ctxf is not None else [])
    fg = mm(torch.cat(parts, dim=-1), rnd(w_fg)) + bfg
    gated = torch.tanh(fg[..., :r]) * torch.sigmoid(fg[..., r:])
    out = mm(rnd(gated), rnd(w_out)) + b_out.to(f32)
    return rnd(out[..., :r] + h), out[..., r:]


def _tails_rebuild(h, ctxf, bfg, w_fg, w_out, b_out, dilations, dt,
                   lo: int, hi: int, mm=torch.matmul):
    """The inputs h_lo .. h_{hi-1} of layers [lo, hi) from h = h_lo, and
    the skip sum of those layers (float32)."""
    hs, skip = [], None
    for l in range(lo, hi):
        hs.append(h)
        h, sk = _tails_layer(h, ctxf, bfg[l], w_fg[l], w_out[l], b_out[l],
                             dilations[l], dt, mm)
        skip = sk if skip is None else skip + sk
    return hs, skip


def _tails_consts(x, ctx, b_fg, dilations):
    batch, _, r = x.shape
    bfg = b_fg.to(torch.float32).reshape(len(dilations), batch, 1, 2 * r)
    ctxf = ctx.to(torch.float32) if ctx is not None else None
    return bfg, ctxf


def stack_fwd_tails_plain(x, ctx, b_fg, w_fg, w_out, b_out,
                          dilations: Sequence[int], every: int = 0,
                          mm=torch.matmul):
    """(skip_sum (B,T,S), ckpt (n_ckpt, B, T, R)), both in x's dtype (the
    compute dtype): ckpt[i] is the input of layer (i + 1) k, k = every or
    ``tails_every(L)``.  ctx is None or flat (B,T,R) in that dtype.
    ``mm`` forms the products (``split_matmul``: as the float32 kernels
    form them)."""
    n_layers = len(dilations)
    every = every or tails_every(n_layers)
    bfg, ctxf = _tails_consts(x, ctx, b_fg, dilations)
    hs, skip = _tails_rebuild(x.to(torch.float32), ctxf, bfg, w_fg, w_out,
                              b_out, dilations, x.dtype, 0, n_layers, mm)
    keep = [hs[l] for l in ckpt_layers(n_layers, every)]
    ckpt = torch.stack(keep) if keep else x.new_zeros((0,) + x.shape)
    return skip.to(x.dtype), ckpt.to(x.dtype)


def stack_bwd_tails_plain(x, ckpt, ctx, b_fg, w_fg, w_out, b_out, dskip,
                          dilations: Sequence[int], every: int = 0,
                          products=None):
    """The backward of ``stack_fwd_tails_plain``: (dx (B,T,R), dctx (B,T,R)
    or None, both in x's dtype; db_fg (L*B, 2R), dw_fg (L, W_in, 2R),
    dw_out (L, R+S), db_out (L, R+S) in float32).  ``products`` forms the
    products in place of torch's (``_products``; fg is the rebuilt layers'
    and fg formed again).

    Group by group from the top, as the kernels: each group's layer
    inputs rebuilt from its checkpoint (x for the first), then its layers
    swept top down."""
    dt = x.dtype
    f32 = torch.float32
    batch, t, r = x.shape
    n_layers = len(dilations)
    every = every or tails_every(n_layers)
    if ckpt.shape[0] != len(ckpt_layers(n_layers, every)):
        raise ValueError(f"{ckpt.shape[0]} checkpoints, expected "
                         f"{len(ckpt_layers(n_layers, every))} for L="
                         f"{n_layers}, every {every}")
    pr = _products(products)
    fgp = pr["fg"][0]
    bfg, ctxf = _tails_consts(x, ctx, b_fg, dilations)
    dsk = dskip.to(f32)
    dh = torch.zeros(batch, t, r, dtype=f32, device=x.device)
    dctx = torch.zeros_like(dh) if ctx is not None else None
    db_fg, dw_fg, dw_out, db_out = ([None] * n_layers for _ in range(4))
    for lo in reversed(range(0, n_layers, every)):
        hi = min(lo + every, n_layers)
        h0 = x if lo == 0 else ckpt[lo // every - 1]
        hs, _ = _tails_rebuild(h0.to(f32), ctxf, bfg, w_fg, w_out, b_out,
                               dilations, dt, lo, hi, fgp)
        for l in reversed(range(lo, hi)):
            d = dilations[l]
            h = hs[l - lo]
            parts = [h, _shift(h, d)] + ([ctxf] if ctxf is not None else [])
            hp = torch.cat(parts, dim=-1)
            fg = fgp(hp, w_fg[l].to(dt).to(f32)) + bfg[l]
            tf, sg = torch.tanh(fg[..., :r]), torch.sigmoid(fg[..., r:])
            dout = torch.cat([dh, dsk], dim=-1)
            dgated = pr["dgated"][0](dout, w_out[l].to(f32).t())
            dfg = torch.cat([dgated * (sg * (1.0 - tf * tf)),
                             dgated * (tf * (sg - sg * sg))], dim=-1)
            dw_fg[l] = pr["dw_fg"][1](hp, dfg)
            db_fg[l] = dfg.sum(dim=1)
            dw_out[l] = pr["dw_out"][1](tf * sg, dout)
            db_out[l] = dout.sum(dim=(0, 1))
            dfg_w = pr["dfg_w"][0](dfg, w_fg[l].to(f32).t())
            dh = dh + dfg_w[..., :r]
            dh = dh + _unshift(dfg_w[..., r:2 * r], d)
            if dctx is not None:
                dctx = dctx + dfg_w[..., 2 * r:]
    return (dh.to(dt), dctx.to(dt) if dctx is not None else None,
            torch.stack(db_fg).reshape(n_layers * batch, 2 * r),
            torch.stack(dw_fg), torch.stack(dw_out), torch.stack(db_out))


# ------------------------------------------------------- autograd op
class _FusedStackEmbed(torch.autograd.Function):
    """skip_sum = trunk(embed(pack)) with every gradient from the
    backward kernel; inputs after the pack may be None (no ctx, or the
    flat ctx instead of the triple)."""

    @staticmethod
    def forward(fctx, pack, table2, ctx_flat, xc, wup, bup, b_fg, w_fg,
                w_out, b_out, dilations, batch):
        from movenet_tpu_torch.ops.cuda import stack_kernel as kern

        proj = xc is not None
        if proj:
            ctx_flat = ctx_flatten((xc, wup, bup), table2.dtype)
        skip, hsave, tfsg = kern.stack_fwd(
            pack, table2, ctx_flat, b_fg, w_fg, w_out, b_out, dilations,
            batch)
        fctx.dilations = tuple(dilations)
        fctx.proj = proj
        fctx.has_ctx = ctx_flat is not None
        fctx.vocab = table2.shape[0] // 2
        fctx.save_for_backward(hsave, tfsg, ctx_flat, w_fg, w_out, pack,
                               table2, xc, wup, bup)
        return skip

    @staticmethod
    def backward(fctx, dskip):
        from movenet_tpu_torch.ops.cuda import stack_kernel as kern

        (hsave, tfsg, ctx_flat, w_fg, w_out, pack, table2, xc, wup,
         bup) = fctx.saved_tensors
        proj = _ctx_proj_args((xc, wup, bup)) if fctx.proj else None
        dtab, dctx, db_fg, dw_fg, dw_out, db_out, dwup_aug = \
            kern.stack_bwd(hsave, tfsg, ctx_flat, w_fg, w_out,
                           dskip.contiguous(), pack, fctx.vocab,
                           fctx.dilations, proj)
        d_flat = d_xc = d_wup = d_bup = None
        if fctx.proj:
            d_xc = dctx.to(xc.dtype)
            d_wup, d_bup = _ctx_proj_grads(dwup_aug, (xc, wup, bup))
        elif fctx.has_ctx:
            d_flat = dctx.to(ctx_flat.dtype)
        return (None, dtab.to(table2.dtype), d_flat, d_xc, d_wup, d_bup,
                db_fg, dw_fg.to(w_fg.dtype), dw_out.to(w_out.dtype),
                db_out, None, None)


def fused_stack_embed(codes_pack: torch.Tensor, table2: torch.Tensor,
                      ctx, b_fg, w_fg, w_out, b_out,
                      dilations: Sequence[int],
                      strategy: str = "auto") -> torch.Tensor:
    """All gated blocks with the front embedding folded in (the JAX
    package's ``fused_stack_embed``, save strategy).

    Args:
      codes_pack: (T, kB) int, k >= 2: column b holds codes[b], column
        B + b codes[b] shifted one step right with -1 at t = 0 (extra
        columns, such as CE targets, are ignored).
      table2: (2V, R) stacked [front_cur; front_past] in the compute
        dtype, which every output takes.
      ctx: None, flat (B, T, R) in the compute dtype, or the projection
        triple (xc (B, T/10, R), wup (R, 10R), bup (10R,)).
      b_fg: (L*B, 2R) per-(layer, batch) fg bias rows; w_fg (L, 2R|3R,
        2R); w_out (L, R, R+S); b_out (L, R+S), all float32.
    Returns:
      skip_sum (B, T, S) in the compute dtype.
    """
    n_layers = w_fg.shape[0]
    batch = b_fg.shape[0] // n_layers
    t, r = codes_pack.shape[0], table2.shape[1]
    mode = resolve_strategy(strategy, (batch, t, r), n_layers, dilations,
                            table2.element_size())
    if mode != "save":
        raise ValueError(
            f"fused_stack_embed is the save strategy only; {mode!r} runs "
            "through front_embed + fused_stack (models/fused routes it)")
    if table2.shape[0] > EMBED_MAX_2V:
        # the kernel's table gradient keeps per-block tables of 2V rows;
        # a larger vocabulary embeds outside it, as models/fused does
        vocab = table2.shape[0] // 2
        h = front_embed(table2[:vocab], table2[vocab:],
                        codes_pack[:, :batch].t().contiguous(), table2.dtype)
        return fused_stack(h, ctx, b_fg, w_fg, w_out, b_out, dilations,
                           strategy="save")
    xc = wup = bup = ctx_flat = None
    if ctx_is_proj(ctx):
        xc, wup, bup = ctx
    else:
        ctx_flat = ctx
    return _FusedStackEmbed.apply(codes_pack, table2, ctx_flat, xc, wup,
                                  bup, b_fg, w_fg, w_out, b_out,
                                  tuple(dilations), batch)


class _FusedStackTails(torch.autograd.Function):
    """skip_sum = trunk(x) through the recompute strategy: the forward
    keeps x and the layer checkpoints, the backward rebuilds the layer
    inputs group by group; a projection triple is flattened here and its
    backward folded by ``ctx_proj_fold``."""

    @staticmethod
    def forward(fctx, x, ctx_flat, xc, wup, bup, b_fg, w_fg, w_out, b_out,
                dilations):
        from movenet_tpu_torch.ops.cuda import stack_kernel as kern

        proj = xc is not None
        if proj:
            ctx_flat = ctx_flatten((xc, wup, bup), x.dtype)
        skip, ckpt = kern.stack_fwd_tails(x, ctx_flat, b_fg, w_fg, w_out,
                                          b_out, dilations)
        fctx.dilations = tuple(dilations)
        fctx.proj = proj
        fctx.has_ctx = ctx_flat is not None
        fctx.save_for_backward(x, ckpt, ctx_flat, b_fg, w_fg, w_out, b_out,
                               xc, wup, bup)
        return skip

    @staticmethod
    def backward(fctx, dskip):
        from movenet_tpu_torch.ops.cuda import stack_kernel as kern

        (x, ckpt, ctx_flat, b_fg, w_fg, w_out, b_out, xc, wup,
         bup) = fctx.saved_tensors
        dx, dctx, db_fg, dw_fg, dw_out, db_out = kern.stack_bwd_tails(
            x, ckpt, ctx_flat, b_fg, w_fg, w_out, b_out,
            dskip.to(x.dtype).contiguous(), fctx.dilations)
        d_flat = d_xc = d_wup = d_bup = None
        if fctx.proj:
            dxc, dwup_aug = ctx_proj_fold(dctx, (xc, wup, bup))
            d_xc = dxc.to(xc.dtype)
            d_wup, d_bup = _ctx_proj_grads(dwup_aug, (xc, wup, bup))
        elif fctx.has_ctx:
            d_flat = dctx.to(ctx_flat.dtype)
        return (dx, d_flat, d_xc, d_wup, d_bup, db_fg,
                dw_fg.to(w_fg.dtype), dw_out.to(w_out.dtype), db_out, None)


def fused_stack(x: torch.Tensor, ctx, b_fg, w_fg, w_out, b_out,
                dilations: Sequence[int],
                strategy: str = "auto") -> torch.Tensor:
    """All gated blocks over the embedded input (the JAX package's
    non-embed ``fused_stack``).

    Args:
      x: (B, T, R) front-embedding output in the compute dtype, which
        every output takes.
      ctx: None, flat (B, T, R) in the compute dtype, or the projection
        triple (xc (B, T/10, R), wup (R, 10R), bup (10R,)).
      b_fg: (L*B, 2R); w_fg (L, 2R|3R, 2R); w_out (L, R, R+S); b_out
        (L, R+S), all float32.
      strategy: "auto", "save", "recompute" or "replay", resolved as the
        JAX package resolves it.
    Returns:
      skip_sum (B, T, S) in the compute dtype.
    """
    mode = resolve_strategy(strategy, tuple(x.shape), w_fg.shape[0],
                            dilations, x.element_size())
    xc = wup = bup = ctx_flat = None
    if ctx_is_proj(ctx):
        xc, wup, bup = ctx
    else:
        ctx_flat = ctx
    op = {"save": _FusedStackSave, "recompute": _FusedStackTails,
          "replay": _FusedStackReplay}[mode]
    return op.apply(x, ctx_flat, xc, wup, bup, b_fg, w_fg, w_out, b_out,
                    tuple(dilations))


class _FusedStackSave(torch.autograd.Function):
    """skip_sum = trunk(x) through the save strategy's non-embed form
    (B.2(a)): the forward keeps hsave and tfsg, the backward returns dx;
    a projection triple is flattened here and its backward runs in the
    backward kernels, as in ``_FusedStackEmbed``."""

    @staticmethod
    def forward(fctx, x, ctx_flat, xc, wup, bup, b_fg, w_fg, w_out, b_out,
                dilations):
        from movenet_tpu_torch.ops.cuda import stack_kernel as kern

        proj = xc is not None
        if proj:
            ctx_flat = ctx_flatten((xc, wup, bup), x.dtype)
        skip, hsave, tfsg = kern.stack_fwd_x(x, ctx_flat, b_fg, w_fg, w_out,
                                             b_out, dilations)
        fctx.dilations = tuple(dilations)
        fctx.proj = proj
        fctx.has_ctx = ctx_flat is not None
        fctx.save_for_backward(hsave, tfsg, ctx_flat, w_fg, w_out, xc, wup,
                               bup)
        return skip

    @staticmethod
    def backward(fctx, dskip):
        from movenet_tpu_torch.ops.cuda import stack_kernel as kern

        hsave, tfsg, ctx_flat, w_fg, w_out, xc, wup, bup = \
            fctx.saved_tensors
        proj = _ctx_proj_args((xc, wup, bup)) if fctx.proj else None
        dx, dctx, db_fg, dw_fg, dw_out, db_out, dwup_aug = kern.stack_bwd_x(
            hsave, tfsg, ctx_flat, w_fg, w_out,
            dskip.to(tfsg.dtype).contiguous(), fctx.dilations, proj)
        d_flat = d_xc = d_wup = d_bup = None
        if fctx.proj:
            d_xc = dctx.to(xc.dtype)
            d_wup, d_bup = _ctx_proj_grads(dwup_aug, (xc, wup, bup))
        elif fctx.has_ctx:
            d_flat = dctx.to(ctx_flat.dtype)
        return (dx, d_flat, d_xc, d_wup, d_bup, db_fg,
                dw_fg.to(w_fg.dtype), dw_out.to(w_out.dtype), db_out, None)


class _FusedStackReplay(torch.autograd.Function):
    """skip_sum = trunk(x) through the replay strategy: the forward keeps
    x, the float32 layer checkpoints and tfsg, no hsave; the backward
    rebuilds the layer inputs group by group and runs the save backward
    on them; a projection triple as in ``_FusedStackSave``."""

    @staticmethod
    def forward(fctx, x, ctx_flat, xc, wup, bup, b_fg, w_fg, w_out, b_out,
                dilations):
        from movenet_tpu_torch.ops.cuda import stack_kernel as kern

        proj = xc is not None
        if proj:
            ctx_flat = ctx_flatten((xc, wup, bup), x.dtype)
        skip, ckpt, tfsg = kern.stack_fwd_replay(x, ctx_flat, b_fg, w_fg,
                                                 w_out, b_out, dilations)
        fctx.dilations = tuple(dilations)
        fctx.proj = proj
        fctx.has_ctx = ctx_flat is not None
        fctx.save_for_backward(x, ckpt, tfsg, ctx_flat, w_fg, w_out, b_out,
                               xc, wup, bup)
        return skip

    @staticmethod
    def backward(fctx, dskip):
        from movenet_tpu_torch.ops.cuda import stack_kernel as kern

        (x, ckpt, tfsg, ctx_flat, w_fg, w_out, b_out, xc, wup,
         bup) = fctx.saved_tensors
        proj = _ctx_proj_args((xc, wup, bup)) if fctx.proj else None
        dx, dctx, db_fg, dw_fg, dw_out, db_out, dwup_aug = \
            kern.stack_bwd_replay(x, ckpt, tfsg, ctx_flat, w_fg, w_out,
                                  b_out, dskip.to(x.dtype).contiguous(),
                                  fctx.dilations, proj)
        d_flat = d_xc = d_wup = d_bup = None
        if fctx.proj:
            d_xc = dctx.to(xc.dtype)
            d_wup, d_bup = _ctx_proj_grads(dwup_aug, (xc, wup, bup))
        elif fctx.has_ctx:
            d_flat = dctx.to(ctx_flat.dtype)
        return (dx, d_flat, d_xc, d_wup, d_bup, db_fg,
                dw_fg.to(w_fg.dtype), dw_out.to(w_out.dtype), db_out, None)


class _FusedStackHeadLoss(torch.autograd.Function):
    """(loss_sum, match) through the merged kernels; the match count is
    not differentiated."""

    @staticmethod
    def forward(fctx, x, ctx, b_fg, w_fg, w_out, b_out, targets_tb, w1, b1,
                w2, b2, dilations, rf, parity):
        from movenet_tpu_torch.ops.cuda import stack_kernel as kern

        loss, match, skip, hsave, tfsg = kern.stack_head_fwd(
            x, ctx, b_fg, w_fg, w_out, b_out, targets_tb, w1, b1, w2, b2,
            dilations, rf, parity)
        fctx.dilations, fctx.rf, fctx.parity = tuple(dilations), rf, parity
        fctx.save_for_backward(hsave, tfsg, ctx, w_fg, w_out, skip,
                               targets_tb, w1, b1, w2, b2)
        fctx.mark_non_differentiable(match)
        return loss, match

    @staticmethod
    def backward(fctx, dloss, _dmatch):
        from movenet_tpu_torch.ops.cuda import stack_kernel as kern

        (hsave, tfsg, ctx, w_fg, w_out, skip, targets_tb, w1, b1, w2,
         b2) = fctx.saved_tensors
        (dx, dctx, db_fg, dw_fg, dw_out, db_out, dw1, db1, dw2,
         db2) = kern.stack_head_bwd(
            hsave, tfsg, ctx, w_fg, w_out, skip, targets_tb, w1, b1, w2, b2,
            dloss, fctx.dilations, fctx.rf, fctx.parity)
        return (dx, dctx, db_fg, dw_fg.to(w_fg.dtype), dw_out.to(w_out.dtype),
                db_out, None, dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(b2.dtype), None, None, None)


def fused_stack_head_loss(x, ctx, b_fg, w_fg, w_out, b_out, targets_tb, w1,
                          b1, w2, b2, dilations: Sequence[int], rf: int,
                          parity: bool):
    """Whole trunk + output head + CE, merged (the JAX package's
    ``fused_stack_head_loss``, save strategy): (loss_sum, match_count)
    over the valid rows [RF-1, T-1).

    Args:
      x: (B, T, R) front-embedding output in the compute dtype.
      ctx: None or flat (B, T, R) in the compute dtype.
      b_fg, w_fg, w_out, b_out: as ``fused_stack``.
      targets_tb: (T, B) int targets, codes rolled one step left (the last
        row is masked).
      w1 (S, C), b1 (C,), w2 (C, C), b2 (C,): the head.
    The backward forms dskip in float32 and feeds it to the layer sweep
    unrounded, so in bf16 its gradients differ slightly from the split
    pipeline's (``fused_stack`` + ``fused_head_loss``)."""
    return _FusedStackHeadLoss.apply(x, ctx, b_fg, w_fg, w_out, b_out,
                                     targets_tb, w1, b1, w2, b2,
                                     tuple(dilations), rf, parity)


__all__ = [
    "pick_stack_tile", "supports_recompute", "resolve_strategy",
    "ctx_is_proj", "ctx_flatten", "ctx_proj_fold", "front_embed",
    "stack_fwd_plain", "stack_bwd_plain", "stack_fwd_x_plain",
    "stack_bwd_x_plain", "stack_head_fwd_plain", "stack_head_bwd_plain",
    "stack_fwd_tails_plain", "stack_bwd_tails_plain",
    "stack_fwd_replay_plain", "stack_bwd_replay_plain", "fused_stack_embed",
    "fused_stack", "fused_stack_head_loss", "tails_every",
]

