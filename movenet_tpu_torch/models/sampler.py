"""Autoregressive generation with cached per-layer ring buffers.

The counterpart of ``movenet_tpu.models.sampler``.  Each layer keeps a
ring of its last ``dilation`` inputs, so one generated sample costs one
small product per layer.  Zero-initialised rings make the incremental
computation equal to the left-zero-padded parallel forward, which
``incremental_logits`` checks.  The loops run eagerly, one step per
Python iteration, on whatever device the model lives on; rings are
updated in place.

Sampled draws use ``ops/jax_random``: step t draws with
``categorical(fold_in(rng, t), scores)`` as the JAX sampler does, so the
same seed gives the JAX package's codes.  ``parity_sampling=True`` keeps
the reference's double softmax (scores ``softmax(logits) / T``);
``False`` samples ``softmax(logits / T)``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from movenet_tpu_torch.models.wavenet import WaveNet
from movenet_tpu_torch.ops import jax_random


def _sample(logits: torch.Tensor, key: np.ndarray, temperature: float,
            parity_sampling: bool) -> torch.Tensor:
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if parity_sampling:
        probs = torch.softmax(logits, dim=-1)
        return jax_random.categorical(key, probs / temperature)
    return jax_random.categorical(key, logits / temperature)


def _global_vec(model: WaveNet, labels) -> Optional[torch.Tensor]:
    if labels is None or not model.global_classes:
        return None
    return model.embed_global(
        torch.as_tensor(labels, device=model.front_cur.device))


def _global_shifts(model: WaveNet, global_vec: Optional[torch.Tensor]
                   ) -> Optional[List[torch.Tensor]]:
    """Per-layer (B, 2R) global-conditioning shifts, or None."""
    if global_vec is None:
        return None
    return [torch.matmul(global_vec, model.blocks_global_kernel[l])
            for l in range(len(model.dilations))]


def _video_context(model: WaveNet, video) -> Optional[torch.Tensor]:
    if video is None:
        return None
    return model.encode_video(video).to(torch.float32)


def _step_logits(model: WaveNet, buffers: List[torch.Tensor], t: int,
                 code_t: torch.Tensor, prev_code: torch.Tensor,
                 ctx_t: Optional[torch.Tensor],
                 g_fg: Optional[List[torch.Tensor]]) -> torch.Tensor:
    """Consume ``code_t`` at position t: update the rings in place and
    return the (B, C) logits predicting position t+1."""
    h = model.front_cur[code_t] + model.front_past[prev_code] * float(t > 0)
    skip_sum = None
    for l, d in enumerate(model.dilations):
        slot = t % d
        buf = buffers[l]
        past = buf[:, slot]
        fg = torch.matmul(h, model.blocks_w_cur[l]) \
            + torch.matmul(past, model.blocks_w_past[l])
        if ctx_t is not None and model.blocks_ctx_kernel is not None:
            fg = fg + torch.matmul(ctx_t, model.blocks_ctx_kernel[l]) \
                + model.blocks_ctx_bias[l]
        if g_fg is not None:
            fg = fg + g_fg[l]
        f, g = torch.chunk(fg, 2, dim=-1)
        gated = torch.tanh(f) * torch.sigmoid(g)
        skip = torch.matmul(gated, model.blocks_skip_kernel[l]) \
            + model.blocks_skip_bias[l]
        skip_sum = skip if skip_sum is None else skip_sum + skip
        buf[:, slot] = h
        h = torch.matmul(gated, model.blocks_res_kernel[l]) \
            + model.blocks_res_bias[l] + h
    y = model.head1(F.leaky_relu(skip_sum))
    return model.head2(F.leaky_relu(y))


def _zero_buffers(model: WaveNet, batch: int) -> List[torch.Tensor]:
    dev = model.front_cur.device
    return [torch.zeros(batch, d, model.residual_channels, device=dev)
            for d in model.dilations]


@torch.no_grad()
def fast_generate(model: WaveNet, prompt_codes, n_samples: int,
                  temperature: float = 1.0,
                  rng: Optional[np.ndarray] = None,
                  video: Optional[torch.Tensor] = None,
                  parity_sampling: bool = True, warm_start: bool = True,
                  labels=None) -> torch.Tensor:
    """(B, n_samples) int32 codes; the first RF come from the prompt.

    ``rng`` is a ``jax_random.PRNGKey`` (default ``PRNGKey(0)``).
    ``warm_start=True`` fills the rings with one parallel pass over the
    prompt (``WaveNet.prompt_state``) and starts the loop at t=RF, with
    the same result as the cold start.
    """
    rf = model.receptive_fields
    if n_samples <= rf:
        raise ValueError(f"n_samples ({n_samples}) must exceed RF ({rf})")
    dev = model.front_cur.device
    prompt = torch.as_tensor(prompt_codes, device=dev)[:, :rf].long()
    batch = prompt.shape[0]
    if rng is None:
        rng = jax_random.PRNGKey(0)
    ctx = _video_context(model, video)
    global_vec = _global_vec(model, labels)
    g_fg = _global_shifts(model, global_vec)
    out = torch.empty(batch, n_samples, dtype=torch.int32, device=dev)

    def ctx_at(t):
        return None if ctx is None else ctx[:, min(t, ctx.shape[1] - 1)]

    if warm_start:
        ctx_prompt = None if ctx is None else ctx[:, :rf]
        buffers, last_logits = model.prompt_state(prompt, ctx_prompt,
                                                  global_vec)
        nxt = _sample(last_logits, jax_random.fold_in(rng, rf - 1),
                      temperature, parity_sampling)
        prev, start = prompt[:, -1], rf
        out[:, :rf] = prompt
    else:
        buffers = _zero_buffers(model, batch)
        prev = nxt = torch.zeros(batch, dtype=torch.long, device=dev)
        start = 0
    for t in range(start, n_samples):
        code_t = prompt[:, t] if t < rf else nxt
        logits = _step_logits(model, buffers, t, code_t, prev, ctx_at(t),
                              g_fg)
        nxt = _sample(logits, jax_random.fold_in(rng, t), temperature,
                      parity_sampling)
        out[:, t] = code_t
        prev = code_t
    return out


@torch.no_grad()
def incremental_logits(model: WaveNet, codes,
                       video: Optional[torch.Tensor] = None,
                       labels=None) -> torch.Tensor:
    """Teacher-forced incremental forward: (B, T, C) logits that must
    equal the parallel ``backbone`` logits."""
    dev = model.front_cur.device
    codes = torch.as_tensor(codes, device=dev).long()
    batch, total = codes.shape
    ctx = _video_context(model, video)
    g_fg = _global_shifts(model, _global_vec(model, labels))
    buffers = _zero_buffers(model, batch)
    prev = torch.zeros(batch, dtype=torch.long, device=dev)
    logits = []
    for t in range(total):
        ctx_t = None if ctx is None else ctx[:, t]
        logits.append(_step_logits(model, buffers, t, codes[:, t], prev,
                                   ctx_t, g_fg))
        prev = codes[:, t]
    return torch.stack(logits, dim=1)


@torch.no_grad()
def naive_generate(model: WaveNet, prompt_codes, n_samples: int,
                   temperature: float = 0.0,
                   rng: Optional[np.ndarray] = None,
                   parity_sampling: bool = True) -> torch.Tensor:
    """The reference's O(T * RF) algorithm: a full RF-window forward per
    generated sample.  Audio only; a cross-check for ``fast_generate``."""
    rf = model.receptive_fields
    dev = model.front_cur.device
    prompt = torch.as_tensor(prompt_codes, device=dev)
    if rng is None:
        rng = jax_random.PRNGKey(0)
    codes = torch.zeros(prompt.shape[0], n_samples, dtype=torch.int32,
                        device=dev)
    codes[:, :rf] = prompt[:, :rf].to(torch.int32)
    for i in range(rf, n_samples):
        logits = model(codes[:, i - rf:i], output_unnormalized=False,
                       remove_last=False)[:, :, -1]
        codes[:, i] = _sample(logits, jax_random.fold_in(rng, i),
                              temperature, parity_sampling).to(torch.int32)
    return codes
