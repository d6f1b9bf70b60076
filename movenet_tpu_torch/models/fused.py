"""Fused training forward: codes -> skip sum through the whole-stack
trunk op, then the head/CE op, so logits never exist in full.

The counterpart of ``movenet_tpu.models.fused``, every route of it: the
split pipeline (trunk op + head/CE op) with the save strategy and the
front embedding folded into the trunk, or with the recompute strategy
(``remat`` or ``fused_strategy``) through ``front_embed`` and the
non-embed trunk; one gated-block op per layer where no common stack tile
exists; and with ``merge_head=True`` the merged trunk + head/CE op.  The
ops (``ops/stack_kernel.fused_stack_embed`` / ``fused_stack`` /
``fused_stack_head_loss``, ``ops/gated_block.fused_gated_block``,
``ops/head_loss.fused_head_loss``) run their CUDA kernels on tensors on
the card and their plain versions on the CPU; gradients reach the
module's parameters through their autograd functions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from movenet_tpu_torch.models.wavenet import (
    UPSAMPLE_STRIDE,
    WaveNet,
    video_upsample_sizes,
)
from movenet_tpu_torch.ops.gated_block import fused_gated_block
from movenet_tpu_torch.ops.stack_kernel import (
    EMBED_MAX_2V,
    ctx_flatten,
    ctx_is_proj,
    front_embed,
    fused_stack,
    fused_stack_embed,
    fused_stack_head_loss,
    pick_stack_tile,
    resolve_strategy,
    supports_recompute,
)

# the JAX package's minimum fused granularity: T must be a multiple
TILE = 128


def supports_fused(model: WaveNet, time_steps: int) -> bool:
    return time_steps % TILE == 0


def _ctx_proj_tile_ok(model: WaveNet, t: int) -> bool:
    """Whether the JAX package sends the video as the coarse projection
    triple at this T (its tile must be a multiple of 80).  The port has
    no such tile rule, but takes the same path so that both packages
    compute the same function on the same shapes."""
    try:
        tile = pick_stack_tile(t, tuple(model.dilations), ctx=True)
    except ValueError:
        return False
    return tile % 80 == 0


def _prepare_trunk(model: WaveNet, codes: torch.Tensor, video, labels):
    """Encoders and stacked per-layer weights: (ctx, (b_fg (L*B, 2R),
    w_fg (L, 2R|3R, 2R), w_out (L, R, R+S), b_out (L, R+S))).

    ctx is None, flat (B, T, R) in the compute dtype, or the triple
    (xc (B, T/10, R) in the compute dtype, wup, bup) whose last
    upsampling stage runs inside the trunk op."""
    b, t = codes.shape
    if t % TILE:
        raise ValueError(
            f"fused path needs T % {TILE} == 0, got {t}; use the "
            "unfused WaveNet.train_logits")
    r = model.residual_channels
    dt = model.dtype
    ctx = None
    if video is not None:
        enc = model.video_encoder
        if enc is None:
            raise ValueError("model has no video encoder parameters")
        up = None
        if t % UPSAMPLE_STRIDE == 0 and _ctx_proj_tile_ok(model, t):
            sizes = video_upsample_sizes(model.max_video_frames,
                                         model.max_audio_frames)
            up = getattr(enc, f"upsample_{len(sizes) - 2}", None)
        if up is not None:
            xc = enc(video, coarse=True, dtype=dt)
            if xc.shape[1] * UPSAMPLE_STRIDE == t:
                ctx = (xc.to(dt), up.kernel, up.bias)
            elif xc.shape[1] == t:      # coarse fell back to full rate
                ctx = xc.to(dt)
        if ctx is None:
            ctx = enc(video, dtype=dt)
            if ctx.shape[1] != t:
                raise ValueError(
                    "expected upsampled video and audio to have equal "
                    f"time lengths, found {ctx.shape[1]}, {t}")
            ctx = ctx.to(dt)
    global_vec = None
    if labels is not None and model.global_classes:
        global_vec = model.embed_global(labels).to(torch.float32)

    n_layers = len(model.dilations)
    fg_parts = [model.blocks_w_cur, model.blocks_w_past]
    b_fg = torch.zeros(n_layers, b, 2 * r, device=codes.device)
    if ctx is not None:
        if model.blocks_ctx_kernel is None:
            raise ValueError(
                "model was built with use_context=False but a video "
                "context was provided")
        fg_parts.append(model.blocks_ctx_kernel)
        b_fg = b_fg + model.blocks_ctx_bias[:, None, :]
    if global_vec is not None:
        b_fg = b_fg + torch.einsum("br,lro->lbo", global_vec,
                                   model.blocks_global_kernel)
    w_fg = torch.cat(fg_parts, dim=1)
    w_out = torch.cat([model.blocks_res_kernel, model.blocks_skip_kernel],
                      dim=2)
    b_out = torch.cat([model.blocks_res_bias, model.blocks_skip_bias],
                      dim=1)
    return ctx, (b_fg.reshape(n_layers * b, 2 * r), w_fg, w_out, b_out)


def _codes_pack(codes: torch.Tensor, with_targets: bool) -> torch.Tensor:
    """ONE (T, kB) int32 array for every per-position consumer: columns
    [0, B) codes, [B, 2B) codes shifted right (row 0 = -1), and with
    targets [2B, 3B) codes shifted left (CE targets; the last row is
    junk and masked).  The JAX package packs int16 on the device to
    halve a TPU relayout; the port keeps int32, the values are equal."""
    c = codes.to(torch.int32)
    prev = torch.cat([torch.full_like(c[:, :1], -1), c[:, :-1]], dim=1)
    parts = [c, prev]
    if with_targets:
        parts.append(torch.roll(c, -1, dims=1))
    return torch.cat(parts, dim=0).t().contiguous()


def codes_pack_np(codes) -> np.ndarray:
    """Host-side (numpy) twin of ``_codes_pack``: (B, T) -> (T, 3B)
    int32, for data loaders."""
    b = codes.shape[0]
    c = np.asarray(codes, np.int32)
    prev = np.concatenate([np.full((b, 1), -1, np.int32), c[:, :-1]],
                          axis=1)
    tgt = np.roll(c, -1, axis=1)
    return np.ascontiguousarray(np.concatenate([c, prev, tgt], axis=0).T)


def _has_stack_tile(t: int, dilations) -> bool:
    try:
        pick_stack_tile(t, dilations)
    except ValueError:
        return False
    return True


def _strategy(model: WaveNet, t: int) -> str:
    """The trunk's VJP strategy: the model's override, else "recompute"
    under remat where it applies, else "auto"."""
    if model.fused_strategy is not None:
        return model.fused_strategy
    if model.remat and supports_recompute(t, tuple(model.dilations)):
        return "recompute"
    return "auto"


def _per_block_trunk(h, ctx, b_fg, w_fg, w_out, b_out, dilations
                     ) -> torch.Tensor:
    """skip_sum = the sum of every block's skip, one ``fused_gated_block``
    per layer (the JAX package's per-block route, fused.py:244-258); ctx is
    None or flat; b_fg (L*B, 2R) and the stacked weights as
    ``_prepare_trunk`` gives them.  The skips add in h's dtype."""
    n_layers = len(dilations)
    b_fg = b_fg.reshape(n_layers, -1, b_fg.shape[-1])
    skip_sum = None
    for i, d in enumerate(dilations):
        h, skip = fused_gated_block(h, ctx, b_fg[i], w_fg[i], w_out[i],
                                    b_out[i].reshape(1, -1), d)
        skip_sum = skip if skip_sum is None else skip_sum + skip
    return skip_sum


def _fused_trunk(model: WaveNet, codes: torch.Tensor, video, labels,
                 codes_pack=None) -> torch.Tensor:
    """codes (+video/labels) -> skip_sum (B, T, S) in the compute dtype.

    Routed as the JAX package routes it: the save strategy with 2V <= 512
    through the whole-stack op with the embedding folded in; any other
    strategy through ``front_embed`` and the non-embed ``fused_stack``;
    without a common stack tile, one gated-block op per layer."""
    b, t = codes.shape
    dt = model.dtype
    dilations = tuple(model.dilations)
    ctx, (b_fg, w_fg, w_out, b_out) = _prepare_trunk(model, codes, video,
                                                     labels)
    if not _has_stack_tile(t, dilations):
        h = front_embed(model.front_cur, model.front_past, codes, dt)
        if ctx_is_proj(ctx):
            ctx = ctx_flatten(ctx, dt)
        return _per_block_trunk(h, ctx, b_fg, w_fg, w_out, b_out, dilations)
    strategy = _strategy(model, t)
    vocab = model.front_cur.shape[0]
    mode = resolve_strategy(strategy, (b, t, model.residual_channels),
                            len(dilations), dilations,
                            torch.finfo(dt).bits // 8)
    if mode == "save" and 2 * vocab <= EMBED_MAX_2V:
        if codes_pack is None:
            codes_pack = _codes_pack(codes, with_targets=False)
        table2 = torch.cat([model.front_cur, model.front_past],
                           dim=0).to(dt)
        return fused_stack_embed(codes_pack, table2, ctx, b_fg, w_fg, w_out,
                                 b_out, dilations, strategy)
    h = front_embed(model.front_cur, model.front_past, codes, dt)
    return fused_stack(h, ctx, b_fg, w_fg, w_out, b_out, dilations,
                       strategy)


def _merged_inputs(model: WaveNet, codes: torch.Tensor, video, labels):
    """The merged op's inputs (x, flat ctx, b_fg, w_fg, w_out, b_out,
    targets_tb), or None where the JAX package's ``_merged_loss`` returns
    None: no common stack tile, or a strategy that is not "save"."""
    b, t = codes.shape
    dt = model.dtype
    dilations = tuple(model.dilations)
    if not _has_stack_tile(t, dilations):
        return None
    ctx, (b_fg, w_fg, w_out, b_out) = _prepare_trunk(model, codes, video,
                                                     labels)
    if resolve_strategy(_strategy(model, t),
                        (b, t, model.residual_channels), len(dilations),
                        dilations, torch.finfo(dt).bits // 8) != "save":
        return None
    x = front_embed(model.front_cur, model.front_past, codes, dt)
    if ctx_is_proj(ctx):      # the merged op runs on the flat ctx
        ctx = ctx_flatten(ctx, dt)
    targets_tb = torch.roll(codes.to(torch.int32), -1, dims=1).t()
    return (x, ctx, b_fg, w_fg, w_out, b_out, targets_tb.contiguous())


def _merged_loss(model: WaveNet, codes: torch.Tensor, video, labels,
                 parity: bool):
    """(loss_sum, match) through the merged trunk + head/CE op, or None
    (the split pipeline then runs, as in the JAX package)."""
    inputs = _merged_inputs(model, codes, video, labels)
    if inputs is None:
        return None
    return fused_stack_head_loss(
        *inputs, model.head1.kernel, model.head1.bias, model.head2.kernel,
        model.head2.bias, tuple(model.dilations), model.receptive_fields,
        parity)


def fused_train_loss(model: WaveNet, codes: torch.Tensor, video=None,
                     labels=None, parity: bool = True,
                     merge_head: bool = False, codes_pack=None):
    """codes -> (mean NLL, accuracy), trunk op + head/CE op.

    ``merge_head=True`` merges the head and CE into the trunk op (JAX's
    ``fused_stack_head_loss``) where the save strategy applies; elsewhere
    the split pipeline runs, as in the JAX package."""
    from movenet_tpu_torch.ops.head_loss import fused_head_loss

    b, t = codes.shape
    if merge_head and supports_fused(model, t):
        merged = _merged_loss(model, codes, video, labels, parity)
        if merged is not None:
            loss_sum, match = merged
            n_valid = b * (t - model.receptive_fields)
            return loss_sum / n_valid, match / n_valid
    if codes_pack is not None and tuple(codes_pack.shape) == (t, 3 * b):
        pack3 = codes_pack.to(codes.device, torch.int32)
    else:
        pack3 = _codes_pack(codes, with_targets=True)
    skip_sum = _fused_trunk(model, codes, video, labels, codes_pack=pack3)
    loss_sum, match = fused_head_loss(
        skip_sum, pack3, model.head1.kernel, model.head1.bias,
        model.head2.kernel, model.head2.bias, model.receptive_fields,
        parity, tgt_off=2 * b)
    n_valid = b * (t - model.receptive_fields)
    return loss_sum / n_valid, match / n_valid


def fused_train_logits(model: WaveNet, codes: torch.Tensor,
                       video: Optional[torch.Tensor] = None,
                       labels: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """(B, T) codes -> (B, T-RF, C) float32 logits through the fused
    trunk; the head runs in float32 torch ops."""
    b, t = codes.shape
    skip_sum = _fused_trunk(model, codes, video, labels)
    y = torch.nn.functional.leaky_relu(skip_sum.to(torch.float32))
    y = torch.matmul(y, model.head1.kernel) + model.head1.bias
    logits = torch.matmul(torch.nn.functional.leaky_relu(y),
                          model.head2.kernel) + model.head2.bias
    return logits[:, model.receptive_fields - 1:-1, :]


__all__ = ["supports_fused", "codes_pack_np", "fused_train_loss",
           "fused_train_logits"]
