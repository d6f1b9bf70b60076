"""Single-launch autoregressive samplers: wrappers, plain versions, counts.

The counterpart of ``movenet_tpu.ops.pallas.ar_sampler``.
``cuda_generate`` takes the place of ``pallas_generate``: one parallel
pass over the prompt fills the dilation rings (``WaveNet.prompt_state``)
and gives the first code, then one launch of a kernel in
``csrc/ar_sampler.cu`` runs every step t in [RF, n).
``plain_generate`` computes the same function as a per-step torch loop
(``ar_sampler_plain``); ``ar_sampler``, the kernel's wrapper, takes it
only for tensors on the CPU.  For CUDA tensors it launches the kernel or
raises.

``fast=True`` is the reassociated chain of ``stack_fast_weights``: one
dependent product per layer and the packed-tanh gate, in float32.

``video=`` (B, F, 64, 64, 1) conditions every step on the encoded video,
as ``pallas_generate`` does: ``encode_video`` (in the compute dtype,
widened to float32) gives ctx (B, T_ctx, R); the prompt pass reads ``ctx[:, :RF]``; step t reads row t of
ctx zero-padded (or cut) to n rows, so past T_ctx a step sees a zero row
while the context bias stays in the fg bias.  (The cached sampler
``models/sampler.fast_generate`` repeats the last row instead, as the
JAX package's scan sampler does; the two samplers differ there.)  The
fg taps grow to (L, 3R, 2R) = [W_cur; W_past; W_ctx] and the fg bias
is ``blocks_ctx_bias``.  The video launches count apart, as
``ar_sampler_ctx_exact`` and ``ar_sampler_ctx_fast``.

``speculative=True`` (B=1, no video) is the wavefront of
``_make_spec_kernel``: each iteration runs step t and a guessed step
t+1 (and t+2 at ``spec_depth=2``) side by side, the guesses coming from
n-gram tables seeded from the prompt and learned online.  A guess
commits only when the real chain's code equals it, so the codes equal
the standard sampler's.  ``ar_sampler_spec`` is the wrapper,
``ar_sampler_spec_plain`` the plain version; both return the codes and
the hit counter (committed guesses), which
``utils/spec_sim.simulate_spec_hits`` replays from the codes alone.

Sampling at T > 0 draws the first code with
``jax.random.categorical(fold_in(PRNGKey(seed), RF-1), ...)``
(``ops/jax_random``) and every later code by Gumbel-max on counter-based
noise (``positional_gumbel``), as the JAX kernel does, so equal weights
give the JAX package's codes.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from movenet_tpu_torch.models.wavenet import WaveNet
from movenet_tpu_torch.ops import jax_random

KERNEL_SOURCE = "movenet_tpu_torch/csrc/ar_sampler.cu"
BATCH_SIZES = (1, 2, 4, 8, 16, 32)
RING_BYTES_LIMIT = 48 * 1024 * 1024
# above this many classes the (C, C) pair table is not kept: order 3
# falls back to order 2, as pallas_generate does
SPEC_PAIR_TABLE_MAX_C = 1024

# kernel launches by form, counted by the wrappers where they launch
launch_counts: Dict[str, int] = {"ar_sampler_exact": 0,
                                 "ar_sampler_fast": 0,
                                 "ar_sampler_ctx_exact": 0,
                                 "ar_sampler_ctx_fast": 0,
                                 "ar_sampler_spec_exact": 0,
                                 "ar_sampler_spec_fast": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ------------------------------------------------------ positional noise
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def positional_bits(seed: int, t: int, batch: int, c_in: int,
                    device=None) -> torch.Tensor:
    """The 24-bit integers behind ``positional_gumbel``: a lowbias32 hash
    of the counter ``(t * batch + b) * c_in + c`` xor the scaled seed,
    all modulo 2^32 (``batch`` is the whole batch)."""
    bi = torch.arange(batch, dtype=torch.int64, device=device)[:, None]
    ci = torch.arange(c_in, dtype=torch.int64, device=device)[None, :]
    x = ((t * batch + bi) * c_in + ci) & _M32
    seed_t = torch.full((), int(seed) & _M32, dtype=torch.int64,
                        device=device)
    x = x ^ _mul32(seed_t, 0x9E3779B9)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x21F0AAAD)
    x = x ^ (x >> 15)
    x = _mul32(x, 0xD35A2D97)
    x = x ^ (x >> 15)
    return x >> 8


def positional_gumbel(seed: int, t: int, batch: int, c_in: int,
                      device=None) -> torch.Tensor:
    """(batch, c_in) float32 Gumbel noise as a pure function of (seed,
    position t, stream b, class c)."""
    u = positional_bits(seed, t, batch, c_in, device).to(torch.float32) \
        * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u + 1e-20) + 1e-20)


# --------------------------------------------------------------- weights
def stack_sampler_params(model: WaveNet, with_context: bool = False
                         ) -> dict:
    """Per-layer parameters stacked into the kernel's dense arrays:
    ``w_fg`` (L, 2R, 2R) = [W_cur; W_past], ``w_out`` (L, R, R+S) =
    [W_res | W_skip], and a zero per-layer fg bias.  ``with_context``:
    ``w_fg`` (L, 3R, 2R) = [W_cur; W_past; W_ctx] and the context-conv
    bias ``blocks_ctx_bias`` (L, 2R) as the fg bias."""
    def f32(x):
        return x.detach().to(torch.float32)

    n_layers = len(model.dilations)
    r = model.residual_channels
    fg_parts = [f32(model.blocks_w_cur), f32(model.blocks_w_past)]
    if with_context:
        if model.blocks_ctx_kernel is None:
            raise ValueError(
                "model was built with use_context=False but a video "
                "context was provided")
        fg_parts.append(f32(model.blocks_ctx_kernel))
        b_fg = f32(model.blocks_ctx_bias)
    else:
        b_fg = torch.zeros(n_layers, 2 * r, device=model.front_cur.device)
    return {
        "front_cur": f32(model.front_cur),
        "front_past": f32(model.front_past),
        "w_fg": torch.cat(fg_parts, dim=1),
        "b_fg": b_fg,
        "w_out": torch.cat([f32(model.blocks_res_kernel),
                            f32(model.blocks_skip_kernel)], dim=2),
        "b_out": torch.cat([f32(model.blocks_res_bias),
                            f32(model.blocks_skip_bias)], dim=1),
        "h1_w": f32(model.head1.kernel),
        "h1_b": f32(model.head1.bias).reshape(1, -1),
        "h2_w": f32(model.head2.kernel),
        "h2_b": f32(model.head2.bias).reshape(1, -1),
    }


def stack_fast_weights(model: WaveNet, sp: dict) -> dict:
    """Weight products of the short-chain sampler.

    With h_{l+1} = gated_l W_res_l + b_res_l + h_l, the next fg is
    gated_l (W_res_l W_cur_{l+1}) + [h_l | past_{l+1}] W_fg_{l+1}
    + b_{l+1} + b_res_l W_cur_{l+1}, so one product per layer depends on
    the gate.  The front embedding folds the same way (fc0, fp0).  Every
    matrix producing an fg has its gate-half columns scaled by 0.5 and
    every matrix consuming ``gated`` has its rows halved, so the gate is
    v = tanh(fg), gated' = v0 * v1 + v0 = 2 tanh(f) sigmoid(g).

    Returns w_prod (L, R, 2R) (last layer zero), fc0/fp0 (C, 2R), w_p0c
    (R, 2R) = W_past_0, or (2R, 2R) = [W_past_0; W_ctx_0] with video
    context, the scaled w_fg_s / w_out_s, b_corr (L, 2R) (zero for layer
    0; the caller adds it to the per-(layer, batch) fg bias and applies
    colscale to the sum) and colscale (2R,).
    """
    r = model.residual_channels
    n_layers = len(model.dilations)
    w_fg, w_out, b_out = sp["w_fg"], sp["w_out"], sp["b_out"]
    dev = w_fg.device
    colscale = torch.cat([torch.ones(r, device=dev),
                          torch.full((r,), 0.5, device=dev)])
    prods = []
    b_corr = [torch.zeros(2 * r, device=dev)]
    for l in range(n_layers):
        if l + 1 < n_layers:
            w_cur_next = w_fg[l + 1][:r]
            prods.append(torch.matmul(w_out[l][:, :r], w_cur_next))
            b_corr.append(torch.matmul(b_out[l][:r], w_cur_next))
        else:
            prods.append(torch.zeros(r, 2 * r, device=dev))
    w_cur_0 = w_fg[0][:r]
    return {
        "w_prod": torch.stack(prods) * 0.5 * colscale,
        "fc0": torch.matmul(sp["front_cur"], w_cur_0) * colscale,
        "fp0": torch.matmul(sp["front_past"], w_cur_0) * colscale,
        "w_p0c": w_fg[0][r:] * colscale,
        "w_fg_s": w_fg * colscale,
        "w_out_s": w_out * 0.5,
        "b_corr": torch.stack(b_corr),
        "colscale": colscale,
    }


# ---------------------------------------------------------------- inputs
@dataclass
class SamplerInputs:
    """Everything one launch reads: weights (float32, contiguous, on the
    model's device), the filled rings, the first two codes and, with
    video, the context rows."""

    fast: bool
    rf: int
    n_samples: int
    temperature: float
    parity_sampling: bool
    seed: int
    dilations: List[int]
    offsets: List[int]
    weights: Dict[str, torch.Tensor]
    b_fg: torch.Tensor         # (L, B, 2R)
    ring: torch.Tensor         # (B, sum_d, R); the launch copies it
    init_codes: torch.Tensor   # (2, B) int32: prompt[:, -1], first code
    prompt: torch.Tensor       # (B, RF) int32
    # speculative decoding (B=1): the guesser's order after the
    # large-C downgrade (0 when not speculative), its depth, whether it
    # learns online, and the tables seeded from the prompt on the host:
    # t2 (C,) and t3 (C, C) int32, -1 where unseen (t3 is None above
    # SPEC_PAIR_TABLE_MAX_C classes)
    spec_order: int = 0
    spec_depth: int = 1
    spec_adaptive: bool = True
    t2: Optional[np.ndarray] = None
    t3: Optional[np.ndarray] = None
    # video context (B, n_samples, R) float32: row t conditions step t
    ctx: Optional[torch.Tensor] = None
    # the kernel's packed weight streams by (chain count, slab bytes), on
    # the weights' device (``pack_stream``)
    streams: Dict[Tuple[int, int], torch.Tensor] = field(
        default_factory=dict)

    @property
    def batch(self) -> int:
        return self.ring.shape[0]

    @property
    def name(self) -> str:
        form = "fast" if self.fast else "exact"
        return (f"ar_sampler_ctx_{form}" if self.ctx is not None
                else f"ar_sampler_{form}")

    @property
    def spec_name(self) -> str:
        return ("ar_sampler_spec_fast" if self.fast
                else "ar_sampler_spec_exact")


def seed_spec_tables(prompt: np.ndarray, c_in: int, pair_table: bool):
    """The guess tables seeded from one prompt (RF,) as pallas_generate
    seeds them: t2[p[:-1]] = p[1:] and t3[p[:-2], p[1:-1]] = p[2:], -1
    where unseen.  Numpy fancy assignment is last-write-wins for
    duplicate transitions, as JAX's CPU scatter and the replay in
    ``utils/spec_sim`` are; a device scatter (``index_put_``) picks an
    unspecified winner, which would change hit counts."""
    p = np.asarray(prompt, np.int64).ravel()
    t2 = np.full(c_in, -1, np.int32)
    t2[p[:-1]] = p[1:]
    t3 = None
    if pair_table:
        t3 = np.full((c_in, c_in), -1, np.int32)
        t3[p[:-2], p[1:-1]] = p[2:]
    return t2, t3


@torch.no_grad()
def prepare(model: WaveNet, prompt_codes, n_samples: int,
            temperature: float = 0.0, seed: int = 0,
            video: Optional[torch.Tensor] = None,
            parity_sampling: bool = True, labels=None, fast: bool = False,
            speculative: bool = False, return_stats: bool = False,
            spec_order: int = 3, spec_depth: int = 1,
            spec_adaptive: bool = True) -> SamplerInputs:
    """Check the request, stack the weights and run the prompt pass."""
    rf = model.receptive_fields
    if n_samples <= rf:
        raise ValueError(f"n_samples ({n_samples}) must exceed RF ({rf})")
    dev = model.front_cur.device
    prompt = torch.as_tensor(prompt_codes, device=dev)
    if prompt.ndim != 2 or prompt.shape[1] < rf:
        raise ValueError(
            f"prompt must be (B, >= RF={rf}) codes, got "
            f"{tuple(prompt.shape)}")
    batch = prompt.shape[0]
    if batch not in BATCH_SIZES:
        raise ValueError(
            "AR sampler supports batch sizes dividing 128 (up to "
            f"32), got {batch}; use fast_generate for other batch sizes")
    if speculative and (batch != 1 or video is not None):
        raise ValueError(
            "speculative sampling supports B=1 decoding without video "
            "(it is a LATENCY optimization; batch/video paths use the "
            "standard kernel)")
    if return_stats and not speculative:
        raise ValueError(
            "return_stats reports the speculative hit counter; it "
            "requires speculative=True")
    if spec_order not in (2, 3):
        raise ValueError(f"spec_order must be 2 or 3, got {spec_order}")
    if spec_depth not in (1, 2):
        raise ValueError(f"spec_depth must be 1 or 2, got {spec_depth}")
    dil = model.dilations
    sum_d = int(np.sum(dil))
    c_in, r = model.input_channels, model.residual_channels
    ring_bytes = sum_d * batch * r * 4
    if ring_bytes > RING_BYTES_LIMIT:
        raise ValueError(
            f"ring buffers need {ring_bytes/2**20:.0f} MiB VMEM at "
            f"batch={batch} (sum of dilations {sum_d}, R={r}); reduce "
            "the batch or use fast_generate")
    prompt = prompt[:, :rf].to(torch.int32)
    if prompt.min() < 0 or prompt.max() >= c_in:
        raise ValueError(f"prompt codes must lie in [0, {c_in})")

    ctx = None
    if video is not None:
        ctx = model.encode_video(torch.as_tensor(video, device=dev)).to(
            torch.float32)                              # (B, T_ctx, R)
        if ctx.shape[0] != batch:
            raise ValueError(f"video batch {ctx.shape[0]} != prompt batch "
                             f"{batch}")
    sp = stack_sampler_params(model, with_context=ctx is not None)
    n_layers = len(dil)
    b_fg = sp["b_fg"][:, None, :].expand(n_layers, batch, 2 * r)
    global_vec = None
    if labels is not None and model.global_classes:
        global_vec = model.embed_global(
            torch.as_tensor(labels, device=dev)).to(torch.float32)
        b_fg = b_fg + torch.einsum(
            "br,lro->lbo", global_vec,
            model.blocks_global_kernel.detach().to(torch.float32))
    weights = {k: sp[k] for k in ("front_cur", "front_past", "w_fg",
                                  "w_out", "b_out", "h1_w", "h1_b",
                                  "h2_w", "h2_b")}
    if fast:
        fw = stack_fast_weights(model, sp)
        b_fg = (b_fg + fw["b_corr"][:, None, :]) * fw["colscale"]
        weights["w_fg"] = fw["w_fg_s"]
        weights["w_out"] = fw["w_out_s"]
        for k in ("fc0", "fp0", "w_p0c", "w_prod"):
            weights[k] = fw[k]
    weights = {k: v.contiguous() for k, v in weights.items()}

    buffers, last_logits = model.prompt_state(
        prompt, None if ctx is None else ctx[:, :rf], global_vec)
    if temperature == 0.0:
        first = torch.argmax(last_logits, dim=-1)
    else:
        key = jax_random.fold_in(jax_random.PRNGKey(seed), rf - 1)
        scores = torch.softmax(last_logits, dim=-1) if parity_sampling \
            else last_logits
        first = jax_random.categorical(key, scores / temperature)
    spec = {}
    if speculative:
        pair_table = c_in <= SPEC_PAIR_TABLE_MAX_C
        t2, t3 = seed_spec_tables(prompt[0].cpu().numpy(), c_in,
                                  pair_table)
        spec = dict(spec_order=spec_order if pair_table else 2,
                    spec_depth=spec_depth,
                    spec_adaptive=bool(spec_adaptive), t2=t2, t3=t3)
    if ctx is not None:
        # row t conditions step t: zero rows past T_ctx, as the TPU
        # kernel's zero-padded ctx slabs
        n = int(n_samples)
        if ctx.shape[1] < n:
            ctx = F.pad(ctx, (0, 0, 0, n - ctx.shape[1]))
        ctx = ctx[:, :n].contiguous()
    inp = SamplerInputs(
        fast=fast, rf=rf, n_samples=int(n_samples),
        temperature=float(temperature), parity_sampling=parity_sampling,
        seed=int(seed), dilations=list(dil),
        offsets=[int(o) for o in np.concatenate([[0], np.cumsum(dil)[:-1]])],
        weights=weights, b_fg=b_fg.contiguous(),
        ring=torch.cat([b.to(torch.float32) for b in buffers],
                       dim=1).contiguous(),
        init_codes=torch.stack([prompt[:, -1],
                                first.to(torch.int32)]).contiguous(),
        prompt=prompt, ctx=ctx, **spec)
    # the kernel's weight stream, once per request
    pack_stream(inp, spec_depth + 1 if speculative else 1)
    return inp


# ------------------------------------------------------ the weight stream
# The kernel reads its weights from a stream that a producer warp copies,
# slab by slab, into a ring of shared-memory stages (1-D bulk copies).  A
# step (an iteration of the speculative form) reads the same bytes in the
# same order every time, so the stream is packed once per request, in the
# order the kernel's phases consume it.  In a phase of n dot products,
# consumer thread tid (of 256) runs dots tid, tid + 256, ... in turn, each
# over its rows in index order; a dot is one or two segments (operand
# vectors) of the same length, each padded to a multiple of 4 rows.  A
# thread's "virtual rows" are its dots' padded rows one after the other,
# and the phase is kv virtual rows (the longest thread's count) by ncols =
# min(n, 256) columns, cut into slabs of ks rows.  A slab is (ks / 4,
# ncols, 4) floats: four rows of a thread lie in 16 bytes, and
# neighbouring threads read neighbouring 16 bytes.  Padding rows and rows
# past a thread's count are zero (never read).
CONSUMERS = 256
SMEM_LIMIT = 232_448           # bytes of shared memory a block can have
MAX_STAGES = 32
# a slab's bytes where the widths allow.  One SM's bulk copies complete
# one after another, so larger copies move more bytes a second (about 170
# GB/s at 32 KB against 88 at 16 KB), and each slab costs the consumers a
# fixed time whatever the ring's depth: at the flagship width an exact
# speculative iteration took 96.7 us with 16 KB slabs, 74.6 with 32 KB
# (in 2, 3 or 5 stages alike) and 67.7 with 64 KB in two stages (H100
# 80GB HBM3 at 700 W, utils/time_spec --probe and --variants)
SLAB_BYTES = 65536
# the slab sizes a ring takes by default, widest first: 64 KB where two
# such stages fit beside the chain buffers, else 32 or 16 KB (at the
# flagship's depth at R = S = 128 with video the two 64 KB stages need
# 234,200 bytes in all)
SLAB_CHOICES = (SLAB_BYTES, 32768, 16384)
# the kernel's PhaseKind order (csrc/ar_layout.cuh)
KINDS = ("A", "C", "H1", "H2", "F0", "M", "ML", "M2", "P")
_FORM_KINDS = {False: ("A", "C", "H1", "H2"),
               True: ("F0", "M", "ML", "M2", "H1", "H2")}
_KWARPS = 8


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def phase_dots(kind: str, r: int, s: int, c: int, n_layers: int):
    """[(first dot, end, rows of a segment, segments)]: the dot products
    of one phase, by index.  A: exact fg over [h | tap] (the two halves of
    W_fg as separate dots); C: exact res/skip outputs; H1, H2: the head;
    F0: fast layer 0's tap product; M: fast gated @ w_prod, the next
    layer's [h | tap] @ W_fg (two segments), the res/skip outputs; ML:
    the last layer's M (outputs only); M2: the late speculative chains'
    next W_fg product over [h | another chain's h_next]; P: the video
    context's product ctx_t @ W_ctx[l] of every layer."""
    r2, rs = 2 * r, r + s
    return {"A": [(0, 2 * r2, r, 1)], "C": [(0, rs, r, 1)],
            "H1": [(0, c, s, 1)], "H2": [(0, c, c, 1)],
            "F0": [(0, r2, r, 1)],
            "M": [(0, r2, r, 1), (r2, 2 * r2, r, 2),
                  (2 * r2, 2 * r2 + rs, r, 1)],
            "ML": [(0, rs, r, 1)], "M2": [(0, r2, r, 2)],
            "P": [(0, n_layers * r2, r, 1)]}[kind]


@functools.lru_cache(maxsize=None)
def phase_shape(kind: str, r: int, s: int, c: int, n_layers: int,
                slab_bytes: int = SLAB_BYTES) -> dict:
    """n dots, slab rows ks, virtual rows kv, columns, bytes of a slab and
    slabs of one phase (the kernel checks the same in phase_shape of
    csrc/ar_layout.cuh).  ks is the largest of 128, 64, ..., 8 that
    divides the phase's padded segment (so that no slab spans two
    segments) and keeps a slab within ``slab_bytes``, else 4."""
    ranges = phase_dots(kind, r, s, c, n_layers)
    n = ranges[-1][1]
    segp = _round4(ranges[0][2])     # one segment length per phase
    ncols = min(n, CONSUMERS)
    ks = next((q for q in (128, 64, 32, 16, 8) if segp % q == 0
               and 4 * q * ncols <= slab_bytes), 4)
    rows = np.zeros(-(-n // CONSUMERS) * CONSUMERS, np.int64)
    for a, b, _, m in ranges:
        rows[a:b] = m * segp
    kv = int(rows.reshape(-1, CONSUMERS).sum(0)[:ncols].max())
    return dict(n=n, ks=ks, kv=kv, ncols=ncols, slab_bytes=4 * ks * ncols,
                n_slabs=kv // ks)


def stream_phases(fast: bool, nch: int, dilations, video: bool = False
                  ) -> List[Tuple[str, int]]:
    """The phases of one step (speculative: iteration) that read the
    stream, in the kernel's order, as (kind, layer).  With video, P
    first.  Fast layer l's late speculative chains (those whose next tap
    is another chain's fresh h: d(l+1) < nch) read W_fg[l+1] a second
    time in M2, so those rows are in the stream twice."""
    n_layers = len(dilations)
    out = [("P", -1)] if video else []
    if not fast:
        out += [(k, l) for l in range(n_layers) for k in ("A", "C")]
    else:
        out.append(("F0", 0))
        for l in range(n_layers):
            if l + 1 < n_layers:
                out.append(("M", l))
                if dilations[l + 1] < nch:
                    out.append(("M2", l))
            else:
                out.append(("ML", l))
    return out + [("H1", -1), ("H2", -1)]


def chain_floats(c: int, r: int, s: int) -> int:
    """Floats of one chain's buffers (chain_offsets in
    csrc/ar_layout.cuh): x = [h | tap], h_next, part0, part1, gated,
    skip, act, scores, each rounded up to a multiple of 4."""
    r4 = _round4(r)
    return 4 * r4 + 2 * _round4(2 * r) + _round4(s) + 2 * _round4(c)


def smem_layout(fast: bool, nch: int, c: int, r: int, s: int,
                n_layers: int, video: bool = False,
                slab_bytes: int = SLAB_BYTES,
                max_stages: int = MAX_STAGES) -> dict:
    """Shared memory of the kernel for ``nch`` chains (1: the standard
    form): the chain buffers, the video context's row and per-step bias,
    the biases and tables (``fixed`` bytes, ring_fixed_bytes in
    csrc/ar_layout.cuh), the ring's stages (each the form's largest slab,
    with its two mbarriers) and as many of them as fit, up to
    ``max_stages``; raises, with the byte counts, when two stages do not
    fit beside the rest."""
    kinds = _FORM_KINDS[fast] + (("P",) if video else ())
    stage = max(phase_shape(k, r, s, c, n_layers, slab_bytes)["slab_bytes"]
                for k in kinds)
    ctx = _round4(r) + n_layers * 2 * r if video else 0
    biases = n_layers * (2 * r + r + s) + 2 * c
    fixed = 4 * (nch * chain_floats(c, r, s) + ctx + (nch - 1) * n_layers * r
                 + biases + _KWARPS) \
        + 4 * (_KWARPS + c + 4 + 2 * n_layers + 3 * n_layers + 4)
    per_stage = stage + 16
    n_stages = min(max_stages, MAX_STAGES,
                   (SMEM_LIMIT - fixed) // per_stage)
    if n_stages < 2:
        form = ("speculative, depth %d" % (nch - 1) if nch > 1
                else "standard") + (", video" if video else "")
        raise ValueError(
            f"the AR sampler kernel ({form}) needs {fixed + 2 * per_stage} "
            f"bytes of shared memory at C={c}, R={r}, S={s}, L={n_layers} "
            f"(chain buffers, biases and tables {fixed} + two ring stages "
            f"of {per_stage}), above the {SMEM_LIMIT:,} bytes a block can "
            "have on this card")
    return dict(fixed=fixed, stage_bytes=stage, n_stages=n_stages,
                total=fixed + n_stages * per_stage)


@functools.lru_cache(maxsize=None)
def ring_slab_bytes(fast: bool, nch: int, c: int, r: int, s: int,
                    n_layers: int, video: bool = False) -> int:
    """The slab size of a form's ring by default: the widest of
    ``SLAB_CHOICES`` whose two stages fit a block beside the rest
    (``smem_layout``, which raises where not even the narrowest does).  A
    slab cuts each thread's rows of a dot, summed in the same order
    whatever the cut."""
    for slab in SLAB_CHOICES[:-1]:
        try:
            smem_layout(fast, nch, c, r, s, n_layers, video, slab)
        except ValueError:
            continue
        return slab
    smem_layout(fast, nch, c, r, s, n_layers, video, SLAB_CHOICES[-1])
    return SLAB_CHOICES[-1]


def _default_slab(inp: "SamplerInputs", nch: int) -> int:
    """``ring_slab_bytes`` of the request's form with ``nch`` chains."""
    w = inp.weights
    c_in, r = w["front_cur"].shape
    return ring_slab_bytes(inp.fast, nch, c_in, r, w["w_out"].shape[2] - r,
                           len(inp.dilations), inp.ctx is not None)


@functools.lru_cache(maxsize=16)
def _stream_index(fast: bool, nch: int, dilations: Tuple[int, ...], r: int,
                  s: int, c: int, slab_bytes: int = SLAB_BYTES,
                  video: bool = False) -> torch.Tensor:
    """int32 index (CPU) of every stream float into the flat
    concatenation of w_fg, w_out, h1_w, h2_w (fast: then w_p0c, w_prod)
    and one zero.  With video W_fg is (L, 3R, 2R) and w_p0c (2R, 2R)."""
    n_layers = len(dilations)
    r2, rs = 2 * r, r + s
    kin = 3 * r if video else r2           # rows of a layer's W_fg
    sizes = [n_layers * kin * r2, n_layers * r * rs, s * c, c * c]
    if fast:
        sizes += [(kin - r) * r2, n_layers * r * r2]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    o_fg, o_out, o_h1, o_h2 = offs[:4]
    zero = offs[len(sizes)]

    def source(kind, l, a, i):
        """(first element of dot i's column, row stride)."""
        if kind == "A":
            half, j = i // r2, i % r2
            return o_fg + l * kin * r2 + half * r * r2 + j, r2
        if kind in ("C", "ML"):
            return o_out + l * r * rs + i, rs
        if kind in ("H1", "H2"):
            return (o_h1 if kind == "H1" else o_h2) + i, c
        if kind == "F0":
            return offs[4] + i, r2
        if kind == "M2":
            return o_fg + (l + 1) * kin * r2 + i, r2
        if kind == "P":               # W_ctx[l]; fast layer 0: w_p0c[R:]
            ll, j = i // r2, i % r2
            w_ctx = o_fg + ll * kin * r2 + r2 * r2 + j
            if fast:
                w_ctx = np.where(ll == 0, offs[4] + r * r2 + j, w_ctx)
            return w_ctx, r2
        if a == 0:                     # M: gated @ w_prod[l]
            return offs[5] + l * r * r2 + i, r2
        if a == r2:                    # M: [h | tap] @ W_fg[l + 1]
            return o_fg + (l + 1) * kin * r2 + (i - r2), r2
        return o_out + l * r * rs + (i - 2 * r2), rs

    parts = []
    for kind, l in stream_phases(fast, nch, dilations, video):
        sh = phase_shape(kind, r, s, c, n_layers, slab_bytes)
        ranges = phase_dots(kind, r, s, c, n_layers)
        segp = _round4(ranges[0][2])
        rows = np.zeros(-(-sh["n"] // CONSUMERS) * CONSUMERS, np.int64)
        for a, b, _, m in ranges:
            rows[a:b] = m * segp
        grid = rows.reshape(-1, CONSUMERS)
        start = (np.cumsum(grid, 0) - grid).ravel()   # a dot's first row
        v = np.full((sh["kv"], sh["ncols"]), zero, np.int64)
        for a, b, k, m in ranges:
            dots = np.arange(a, b)
            base, stride = source(kind, l, a, dots)
            # virtual row -> the dot's own row; padding keeps the zero
            seg, o = np.divmod(np.arange(m * segp), segp)
            own = o < k
            vr, kk = np.nonzero(own)[0][:, None], (seg * k + o)[own][:, None]
            v[start[dots][None, :] + vr, (dots % CONSUMERS)[None, :]] = \
                base[None, :] + kk * stride
        ks = sh["ks"]
        parts.append(v.reshape(sh["n_slabs"], ks // 4, 4, sh["ncols"])
                     .transpose(0, 1, 3, 2).ravel())
    return torch.from_numpy(np.concatenate(parts).astype(np.int32))


def pack_stream(inp: "SamplerInputs", nch: int,
                slab_bytes: Optional[int] = None) -> torch.Tensor:
    """The kernel's weight stream for ``nch`` chains (1: the standard
    form; speculative depth + 1): one float32 tensor on the weights'
    device, every weight bit for bit, in the order and layout the kernel
    consumes it, in slabs of ``slab_bytes`` (default ``ring_slab_bytes``);
    cached on ``inp``."""
    if slab_bytes is None:
        slab_bytes = _default_slab(inp, nch)
    got = inp.streams.get((nch, slab_bytes))
    if got is not None:
        return got
    w = inp.weights
    c_in, r = w["front_cur"].shape
    s = w["w_out"].shape[2] - r
    names = ["w_fg", "w_out", "h1_w", "h2_w"] \
        + (["w_p0c", "w_prod"] if inp.fast else [])
    flat = torch.cat([w[k].reshape(-1) for k in names]
                     + [w["w_fg"].new_zeros(1)])
    idx = _stream_index(inp.fast, nch, tuple(inp.dilations), r, s, c_in,
                        slab_bytes, inp.ctx is not None)
    stream = flat.index_select(0, idx.to(flat.device))
    inp.streams[(nch, slab_bytes)] = stream
    return stream


# ---------------------------------------------------------- plain version
@torch.no_grad()
def ar_sampler_plain(inp: SamplerInputs, return_margins: bool = False):
    """The kernel's function as a per-step torch loop on the inputs'
    device: (B, n - RF) int32 codes, the code consumed at each step.

    ``return_margins=True`` also returns, for each step, the gap between
    the two best scores behind the next code (B, n - RF), which says how
    close a decision was when a kernel disagrees.  With video the step's
    context row joins every [h | tap] (fast layer 0: [tap]) operand, as
    in the TPU kernel."""
    w = inp.weights
    r = w["front_cur"].shape[1]
    ring = inp.ring.clone()
    batch = inp.batch
    prev = inp.init_codes[0].long()
    cur = inp.init_codes[1].long()
    out = torch.empty(batch, inp.n_samples - inp.rf, dtype=torch.int32,
                      device=ring.device)
    margins = torch.empty(out.shape, device=ring.device) \
        if return_margins else None
    n_layers = len(inp.dilations)

    def slot(l, t):
        return inp.offsets[l] + t % inp.dilations[l]

    for t in range(inp.rf, inp.n_samples):
        skip = torch.zeros(batch, w["w_out"].shape[2] - r,
                           device=ring.device)
        h = w["front_cur"][cur] + w["front_past"][prev]
        ctx_t = [] if inp.ctx is None else [inp.ctx[:, t]]
        if not inp.fast:
            for l in range(n_layers):
                s_l = slot(l, t)
                fg = torch.matmul(torch.cat([h, ring[:, s_l]] + ctx_t, dim=1),
                                  w["w_fg"][l]) + inp.b_fg[l]
                gated = torch.tanh(fg[:, :r]) * torch.sigmoid(fg[:, r:])
                o = torch.matmul(gated, w["w_out"][l]) + w["b_out"][l]
                skip = skip + o[:, r:]
                ring[:, s_l] = h
                h = o[:, :r] + h
        else:
            fg = w["fc0"][cur] + (
                w["fp0"][prev]
                + torch.matmul(torch.cat([ring[:, slot(0, t)]] + ctx_t,
                                         dim=1), w["w_p0c"])
                + inp.b_fg[0])
            for l in range(n_layers):
                s_l = slot(l, t)
                v = torch.tanh(fg)
                gated = v[:, :r] * v[:, r:] + v[:, :r]
                o = torch.matmul(gated, w["w_out"][l]) + w["b_out"][l]
                if l + 1 < n_layers:
                    fgp = torch.matmul(gated, w["w_prod"][l])
                    pre = torch.matmul(
                        torch.cat([h, ring[:, slot(l + 1, t)]] + ctx_t,
                                  dim=1),
                        w["w_fg"][l + 1]) + inp.b_fg[l + 1]
                    fg = fgp + pre
                ring[:, s_l] = h
                skip = skip + o[:, r:]
                h = o[:, :r] + h
        y = torch.matmul(F.leaky_relu(skip), w["h1_w"]) + w["h1_b"]
        logits = torch.matmul(F.leaky_relu(y), w["h2_w"]) + w["h2_b"]
        if inp.temperature == 0.0:
            scores = logits
        else:
            scores = torch.softmax(logits, dim=-1) if inp.parity_sampling \
                else logits
            scores = scores / inp.temperature + positional_gumbel(
                inp.seed, t, batch, logits.shape[1], device=ring.device)
        out[:, t - inp.rf] = cur.to(torch.int32)
        if margins is not None:
            top2 = torch.topk(scores, 2, dim=-1).values
            margins[:, t - inp.rf] = top2[:, 0] - top2[:, 1]
        prev, cur = cur, torch.argmax(scores, dim=-1)
    return (out, margins) if return_margins else out


def _spec_options(inp: SamplerInputs, order, depth, adaptive):
    if inp.t2 is None:
        raise ValueError("inputs were not prepared with speculative=True")
    if inp.batch != 1:
        raise ValueError("the speculative sampler runs B=1")
    order = inp.spec_order if order is None else int(order)
    depth = inp.spec_depth if depth is None else int(depth)
    adaptive = inp.spec_adaptive if adaptive is None else bool(adaptive)
    if order not in (2, 3) or depth not in (1, 2):
        raise ValueError(f"spec order {order} / depth {depth} not in "
                         "{2, 3} / {1, 2}")
    if order == 3 and inp.t3 is None:
        raise ValueError("order 3 needs the (C, C) pair table, which is "
                         f"not kept above {SPEC_PAIR_TABLE_MAX_C} classes")
    return order, depth, adaptive


@torch.no_grad()
def ar_sampler_spec_plain(inp: SamplerInputs, order: Optional[int] = None,
                          depth: Optional[int] = None,
                          adaptive: Optional[bool] = None):
    """The speculative kernel's function as a per-iteration torch loop on
    the inputs' device: ((1, n - RF) int32 codes, 0-d int32 hits).

    Each iteration runs the real chain at step t and speculative chains
    at t+1 under the guess g1 (and at t+2 under g2 at depth 2), each with
    its own (1, .) products of ``ar_sampler_plain``'s shapes.  The
    chains' ring taps: for s1, the real chain's layer input where the
    dilation is 1 and the untouched ring slot of t+1 otherwise; for s2,
    s1's input at d == 1, the real chain's at d == 2 and the ring slot of
    t+2 otherwise.  The spec ring writes wait until the real code equals
    the guess and then commit in time order (real, s1, s2).  Order,
    depth and adaptivity default to the ones ``prepare`` was given."""
    order, depth, adaptive = _spec_options(inp, order, depth, adaptive)
    w = inp.weights
    r = w["front_cur"].shape[1]
    c_in = w["front_cur"].shape[0]
    dev = inp.ring.device
    ring = inp.ring[0].clone()                     # (sum_d, R)
    n, rf = inp.n_samples, inp.rf
    out = np.empty(n - rf, np.int32)
    t2 = inp.t2.astype(np.int64)
    t3 = inp.t3.astype(np.int64) if order == 3 else None
    n_layers = len(inp.dilations)
    dil, off = inp.dilations, inp.offsets

    def ok(c):
        return 0 <= c < c_in

    def row(table, c):
        # a code outside [0, C) (no guess) embeds as zeros, as the TPU
        # kernel's one-hot product does
        return table[c][None, :] if ok(c) else \
            torch.zeros(1, table.shape[1], device=dev)

    def slot(l, tt):
        return off[l] + tt % dil[l]

    def t3_at(p, c):
        # the kernel's one-hot reads give 0 for an invalid index
        return int(t3[p, c]) if ok(p) and ok(c) else 0

    def guess1(prev, cur):
        g = int(t2[cur]) if ok(cur) else 0
        if order == 3:
            g3 = t3_at(prev, cur)
            g = g3 if g3 >= 0 else g
        return g

    def guess2(cur, g1):
        if not ok(g1):
            return 0
        g = int(t2[g1])
        if order == 3:
            g3 = t3_at(cur, g1)
            g = g3 if g3 >= 0 else g
        return g

    def head(skip, tt):
        y = torch.matmul(F.leaky_relu(skip), w["h1_w"]) + w["h1_b"]
        logits = torch.matmul(F.leaky_relu(y), w["h2_w"]) + w["h2_b"]
        if inp.temperature == 0.0:
            scores = logits
        else:
            scores = torch.softmax(logits, dim=-1) if inp.parity_sampling \
                else logits
            scores = scores / inp.temperature + positional_gumbel(
                inp.seed, tt, 1, c_in, device=dev)
        return int(torch.argmax(scores, dim=-1))

    def gated_out(l, fg):
        if inp.fast:
            v = torch.tanh(fg)
            gated = v[:, :r] * v[:, r:] + v[:, :r]
        else:
            gated = torch.tanh(fg[:, :r]) * torch.sigmoid(fg[:, r:])
        return gated, torch.matmul(gated, w["w_out"][l]) + w["b_out"][l]

    def fg_of(l, h, tap):
        return torch.matmul(torch.cat([h, tap], dim=1), w["w_fg"][l]) \
            + inp.b_fg[l]

    def taps(l, tt, hs):
        """Layer-l ring taps of the chains at t, t+1, t+2 and the slots
        their writes go to; ``hs`` are the chains' layer-l inputs."""
        d = dil[l]
        tp = [ring[slot(l, tt)][None, :]]
        sl = [slot(l, tt)]
        if len(hs) > 1:
            tp.append(hs[0] if d == 1 else ring[slot(l, tt + 1)][None, :])
            sl.append(slot(l, tt) if d == 1 else slot(l, tt + 1))
        if len(hs) > 2:
            tp.append(hs[1] if d == 1 else hs[0] if d == 2
                      else ring[slot(l, tt + 2)][None, :])
            sl.append(slot(l, tt) if d <= 2 else slot(l, tt + 2))
        return tp, sl

    prev = int(inp.init_codes[0, 0])
    cur = int(inp.init_codes[1, 0])
    t = rf
    hits = 0
    while t < n:
        g1 = guess1(prev, cur)
        codes = [(cur, prev), (g1, cur)]
        if depth == 2:
            g2 = guess2(cur, g1)
            codes.append((g2, g1))
        k_ch = len(codes)
        hs = [row(w["front_cur"], c) + row(w["front_past"], p)
              for c, p in codes]
        skips = [torch.zeros(1, w["w_out"].shape[2] - r, device=dev)
                 for _ in range(k_ch)]
        writes = [[] for _ in range(k_ch)]          # (slot, h) per chain
        if not inp.fast:
            for l in range(n_layers):
                tp, sl = taps(l, t, hs)
                outs = [gated_out(l, fg_of(l, hs[k], tp[k]))[1]
                        for k in range(k_ch)]
                for k in range(k_ch):
                    writes[k].append((sl[k], hs[k]))
                    skips[k] = skips[k] + outs[k][:, r:]
                    hs[k] = outs[k][:, :r] + hs[k]
                ring[sl[0]] = writes[0][-1][1][0]
        else:
            # layer 0's tap at t+1 (t+2) is the front embedding of the
            # chain one step earlier: the first dilation is 1
            tap0 = [ring[slot(0, t)][None, :]] + hs[:k_ch - 1]
            fgs = [row(w["fc0"], c) + (
                row(w["fp0"], p) + torch.matmul(tap0[k], w["w_p0c"])
                + inp.b_fg[0]) for k, (c, p) in enumerate(codes)]
            for l in range(n_layers):
                _, sl = taps(l, t, hs)
                go = [gated_out(l, fg) for fg in fgs]
                if l + 1 < n_layers:
                    h_next = [o[:, :r] + h for (_, o), h in zip(go, hs)]
                    tp, _ = taps(l + 1, t, h_next)
                    fgs = [torch.matmul(go[k][0], w["w_prod"][l])
                           + fg_of(l + 1, hs[k], tp[k])
                           for k in range(k_ch)]
                for k in range(k_ch):
                    writes[k].append((sl[k], hs[k]))
                    skips[k] = skips[k] + go[k][1][:, r:]
                    hs[k] = go[k][1][:, :r] + hs[k]
                ring[sl[0]] = writes[0][-1][1][0]
        nxt = [head(skips[k], t + k) for k in range(k_ch)]
        hit = nxt[0] == g1 and t + 1 < n
        hit2 = depth == 2 and hit and nxt[1] == g2 and t + 2 < n
        for k, on in ((1, hit), (2, hit2)):
            if on:
                for s_k, h_k in writes[k]:
                    ring[s_k] = h_k[0]
        if adaptive:
            if ok(cur):
                t2[cur] = nxt[0]
            if hit and ok(g1):
                t2[g1] = nxt[1]
            if hit2 and ok(g2):
                t2[g2] = nxt[2]
            if order == 3:
                # the kernel keys the row on prev's one-hot: row 0 when
                # prev is outside [0, C)
                if ok(cur):
                    t3[prev if ok(prev) else 0, cur] = nxt[0]
                if hit and ok(cur) and ok(g1):
                    t3[cur, g1] = nxt[1]
                if hit2 and ok(g1) and ok(g2):
                    t3[g1, g2] = nxt[2]
        out[t - rf] = cur
        if hit:
            out[t + 1 - rf] = g1
        if hit2:
            out[t + 2 - rf] = g2
        hits += int(hit) + int(hit2)
        if hit2:
            t, prev, cur = t + 3, g2, nxt[2]
        elif hit:
            t, prev, cur = t + 2, g1, nxt[1]
        else:
            t, prev, cur = t + 1, cur, nxt[0]
    return (torch.from_numpy(out)[None].to(dev),
            torch.tensor(hits, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------- kernel
_ARGTYPES = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 19
             + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_void_p])
_PROBE_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 2)


def _kernel_lib() -> ctypes.CDLL:
    from movenet_tpu_torch.ops.cuda import build

    lib = build.load("ar_sampler")
    if lib.movenet_ar_sampler_launch.argtypes is None:
        bind_library(lib)
    return lib


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/ar_sampler.cu`` on ``lib`` (a
    build of it for the card, or for the CPU: an emulation)."""
    lib.movenet_ar_sampler_launch.argtypes = _ARGTYPES
    lib.movenet_ar_sampler_launch.restype = ctypes.c_int
    lib.movenet_ar_ring_fixed_bytes.argtypes = [ctypes.c_int] * 6
    lib.movenet_ar_ring_fixed_bytes.restype = ctypes.c_longlong
    lib.movenet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.movenet_cuda_error_string.restype = ctypes.c_char_p
    lib.movenet_ar_stream_probe.argtypes = _PROBE_ARGTYPES
    lib.movenet_ar_stream_probe.restype = ctypes.c_int
    return lib


def _check(name: str, x: torch.Tensor, shape: tuple, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} is {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_inputs(inp: SamplerInputs, dev) -> tuple:
    """Check every tensor a launch reads; returns (C, R, S, L, sum_d)."""
    w = inp.weights
    c_in, r = w["front_cur"].shape
    n_layers = len(inp.dilations)
    s = w["w_out"].shape[2] - r
    batch, sum_d = inp.batch, int(sum(inp.dilations))
    f32, i32 = torch.float32, torch.int32
    kin = 3 * r if inp.ctx is not None else 2 * r   # rows of each fg tap
    shapes = {"front_cur": (c_in, r), "front_past": (c_in, r),
              "w_fg": (n_layers, kin, 2 * r),
              "w_out": (n_layers, r, r + s), "b_out": (n_layers, r + s),
              "h1_w": (s, c_in), "h1_b": (1, c_in),
              "h2_w": (c_in, c_in), "h2_b": (1, c_in)}
    if inp.fast:
        shapes.update(fc0=(c_in, 2 * r), fp0=(c_in, 2 * r),
                      w_p0c=(kin - r, 2 * r), w_prod=(n_layers, r, 2 * r))
    for k, shape in shapes.items():
        _check(k, w[k], shape, f32, dev)
    _check("b_fg", inp.b_fg, (n_layers, batch, 2 * r), f32, dev)
    _check("ring", inp.ring, (batch, sum_d, r), f32, dev)
    _check("init_codes", inp.init_codes, (2, batch), i32, dev)
    if inp.ctx is not None:
        _check("ctx", inp.ctx, (batch, inp.n_samples, r), f32, dev)
    return c_in, r, s, n_layers, sum_d


def _seed32(seed: int) -> int:
    seed = seed & _M32  # the kernel reads the int32 as uint32
    return seed - (1 << 32) if seed >= 1 << 31 else seed


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{lib.movenet_cuda_error_string(err).decode()} "
            f"(cudaError {err})")


def _device_of(inp: SamplerInputs, what: str):
    dev = inp.ring.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {dev}")
    return dev


def run_ring(lib, inp: SamplerInputs, depth: int = 0, order: int = 3,
             adaptive: bool = False, stream=None,
             slab_bytes: Optional[int] = None,
             max_stages: int = MAX_STAGES):
    """One launch of ``ar_sampler_kernel`` through ``lib`` (a library with
    the C interface of ``csrc/ar_sampler.cu``) on ``stream``, on the
    inputs' device: ((B, n - RF) int32 codes, 0-d int32 hits).  Depth 0
    is the standard form (hits stay 0); depth 1 or 2 the speculative one
    with ``order`` and ``adaptive``.  The launch copies the rings and, for
    the speculative form, the guess tables (the kernel updates both in
    place).  It takes CPU tensors with ``stream=None`` for a library built
    for the CPU (an emulation of the kernel).  Raises where the ring and
    the chain buffers do not fit the shared memory of a block.  The ring's
    slabs are ``ring_slab_bytes`` of the form by default; ``slab_bytes``
    and ``max_stages`` reshape the ring (for measurements)."""
    dev = inp.ring.device
    c_in, r, s, n_layers, sum_d = _check_inputs(inp, dev)
    nch = depth + 1
    if slab_bytes is None:
        slab_bytes = _default_slab(inp, nch)
    lay = smem_layout(inp.fast, nch, c_in, r, s, n_layers,
                      inp.ctx is not None, slab_bytes, max_stages)
    wstream = pack_stream(inp, nch, slab_bytes)
    ks = (ctypes.c_int * len(KINDS))(*(
        phase_shape(k, r, s, c_in, n_layers, slab_bytes)["ks"]
        for k in KINDS))
    i32 = torch.int32
    out = torch.empty(inp.batch, inp.n_samples - inp.rf, dtype=i32,
                      device=dev)
    hits = torch.zeros((), dtype=i32, device=dev)
    ring = inp.ring.clone()
    dil = torch.tensor(inp.dilations, dtype=i32, device=dev)
    off = torch.tensor(inp.offsets, dtype=i32, device=dev)
    t2 = t3 = None
    if depth:
        t2 = torch.tensor(inp.t2, device=dev)
        t3 = torch.tensor(inp.t3, device=dev) if order == 3 else None
    w = inp.weights

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = lib.movenet_ar_sampler_launch(
        int(inp.fast), depth, order, int(adaptive), ptr(w["front_cur"]),
        ptr(w["front_past"]), ptr(inp.b_fg), ptr(w["b_out"]),
        ptr(w["h1_b"]), ptr(w["h2_b"]), ptr(w.get("fc0")),
        ptr(w.get("fp0")), ptr(dil), ptr(off), ptr(ring),
        ptr(inp.init_codes), ptr(t2), ptr(t3), ptr(out), ptr(hits),
        ptr(inp.ctx), ptr(wstream), ks, lay["stage_bytes"], lay["n_stages"],
        inp.batch, c_in, r, s, n_layers, sum_d, inp.rf, inp.n_samples,
        _seed32(inp.seed), int(inp.parity_sampling), inp.temperature,
        stream)
    _raise_on(lib, err, "ar_sampler")
    return out, hits


def ar_sampler(inp: SamplerInputs) -> torch.Tensor:
    """The kernel's wrapper: (B, n - RF) int32 codes.  Tensors on the CPU
    take ``ar_sampler_plain``; CUDA tensors take one launch of
    ``csrc/ar_sampler.cu``'s ``ar_sampler_kernel`` in its standard form
    (one block a stream, the ``HAS_CTX`` form when the inputs carry video
    context) on the current stream: a producer warp bulk-copies the
    request's packed weight stream (``pack_stream``, cached on ``inp``)
    through a ring of shared-memory stages to 8 consumer warps.  Raises
    where that ring does not fit a block's shared memory."""
    dev = _device_of(inp, "ar_sampler")
    if dev.type == "cpu":
        return ar_sampler_plain(inp)
    with torch.cuda.device(dev):  # launch on the tensors' own card
        out, _ = run_ring(_kernel_lib(), inp,
                          stream=torch.cuda.current_stream(dev).cuda_stream)
    launch_counts[inp.name] += 1
    return out


def ar_sampler_spec(inp: SamplerInputs, order: Optional[int] = None,
                    depth: Optional[int] = None,
                    adaptive: Optional[bool] = None):
    """The speculative kernel's wrapper: ((1, n - RF) int32 codes, 0-d
    int32 hits).  Tensors on the CPU take ``ar_sampler_spec_plain``; CUDA
    tensors take one launch of ``csrc/ar_sampler.cu``'s
    ``ar_sampler_kernel`` in its speculative form on the current stream,
    with per-launch device copies of the guess tables, which it updates
    in place."""
    dev = _device_of(inp, "ar_sampler_spec")
    if dev.type == "cpu":
        return ar_sampler_spec_plain(inp, order, depth, adaptive)
    with torch.cuda.device(dev):  # launch on the tensors' own card
        got = run_spec(_kernel_lib(), inp, order, depth, adaptive,
                       torch.cuda.current_stream(dev).cuda_stream)
    launch_counts[inp.spec_name] += 1
    return got


def run_spec(lib, inp: SamplerInputs, order: Optional[int] = None,
             depth: Optional[int] = None, adaptive: Optional[bool] = None,
             stream=None, slab_bytes: Optional[int] = None,
             max_stages: int = MAX_STAGES):
    """``run_ring`` in the speculative form, with order, depth and
    adaptivity defaulting to the ones ``prepare`` was given: ((1, n - RF)
    int32 codes, 0-d int32 hits)."""
    order, depth, adaptive = _spec_options(inp, order, depth, adaptive)
    return run_ring(lib, inp, depth, order, adaptive, stream, slab_bytes,
                    max_stages)


PROBE_MODES = {"bulk copy": 0, "bulk copy + smem reads": 2,
               "grouped __ldg": 1}


def stream_probe(n_bytes: int, mode: str, passes: int = 8,
                 slab_bytes: int = 16384, n_stages: int = 12) -> float:
    """GB/s at which one block, alone on the current card, moves a stream
    of ``n_bytes`` (in slabs of ``slab_bytes``, L2-resident after a warm
    pass) into its SM, timed by CUDA events over ``passes`` passes:
    ``mode`` "bulk copy" (one producer lane, a ring of ``n_stages``
    shared-memory stages), "bulk copy + smem reads" (the consumers also
    read every float) or "grouped __ldg" (256 threads, 16 loads each in
    flight).  Measurement only; no entry point calls it."""
    dev = torch.device("cuda", torch.cuda.current_device())
    n_slabs = -(-int(n_bytes) // slab_bytes)
    src = torch.randn(n_slabs * slab_bytes // 4, device=dev)
    out = torch.empty(CONSUMERS + 32, device=dev)
    lib = _kernel_lib()
    st = torch.cuda.current_stream(dev).cuda_stream

    def run(k):
        _raise_on(lib, lib.movenet_ar_stream_probe(
            src.data_ptr(), slab_bytes, n_slabs, k, PROBE_MODES[mode],
            n_stages, out.data_ptr(), st), "stream probe")

    run(1)
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    run(passes)
    stop.record()
    torch.cuda.synchronize(dev)
    return passes * n_slabs * slab_bytes / (start.elapsed_time(stop) * 1e6)


# ----------------------------------------------------------- entry points
def _codes(inp: SamplerInputs, gen: torch.Tensor) -> torch.Tensor:
    return torch.cat([inp.prompt, gen], dim=1)[:, :inp.n_samples]


def cuda_generate(model: WaveNet, prompt_codes, n_samples: int,
                  temperature: float = 0.0, seed: int = 0,
                  video: Optional[torch.Tensor] = None,
                  parity_sampling: bool = True, labels=None,
                  fast: bool = False, speculative: bool = False,
                  spec_adaptive: bool = True, spec_order: int = 3,
                  spec_depth: int = 1, return_stats: bool = False):
    """Generate (B, n_samples) int32 mu-law codes, the prompt's first RF
    included, with one kernel launch on the model's CUDA device (the
    plain version for a model on the CPU).  B in {1, 2, 4, 8, 16, 32}.
    ``video`` (B, F, 64, 64, 1) conditions the steps (see the module
    docstring); ``labels`` (B,) the global classes.

    ``speculative=True`` (B=1, no video) runs the speculative kernel;
    with ``return_stats`` the result is (codes, hits), hits a 0-d int32
    tensor counting the samples that came from committed guesses."""
    inp = prepare(model, prompt_codes, n_samples, temperature, seed, video,
                  parity_sampling, labels, fast, speculative, return_stats,
                  spec_order, spec_depth, spec_adaptive)
    if not speculative:
        return _codes(inp, ar_sampler(inp))
    gen, hits = ar_sampler_spec(inp)
    codes = _codes(inp, gen)
    return (codes, hits) if return_stats else codes


def plain_generate(model: WaveNet, prompt_codes, n_samples: int,
                   temperature: float = 0.0, seed: int = 0,
                   video: Optional[torch.Tensor] = None,
                   parity_sampling: bool = True, labels=None,
                   fast: bool = False) -> torch.Tensor:
    """``cuda_generate``'s function as a per-step torch loop, on any
    device."""
    inp = prepare(model, prompt_codes, n_samples, temperature, seed, video,
                  parity_sampling, labels, fast)
    return _codes(inp, ar_sampler_plain(inp))
