"""Video-conditioned WaveNet as a torch ``nn.Module``, forward only.

The counterpart of ``movenet_tpu.models.wavenet``: the same stacked
parameter names and shapes, in the JAX (in, out) layout, so that one set
of weights drives both packages (``models/convert.py``).  Every size-2
dilated causal convolution is two matrix products and a time shift
(``ops/conv.py``); activations are (batch, time, channels).  The input
layer, the gated blocks, the head and the video encoder compute in the
configuration's ``compute_dtype``, each product rounded where the JAX
package's ``preferred_element_type`` rounds it; parameters stay float32.
``remat=True`` recomputes each block in the backward
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does there.  The
cached samplers' per-step products stay float32, as the JAX package's do.

Parity quirk kept: ``forward`` returns softmax probabilities by default
(``output_unnormalized=True``), as the reference does.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from movenet_tpu_torch.ops.conv import (
    causal_pad_shift,
    compute_output_size,
    receptive_field,
    upsample_kernel_size,
    wavenet_dilations,
)
from movenet_tpu_torch.ops.stack_kernel import front_embed

MAX_AUDIO_FRAMES = 160_000
MAX_VIDEO_FRAMES = 160
VIDEO_FRAME_HW = (64, 64)
UPSAMPLE_STRIDE = 10


def video_upsample_sizes(in_frames: int = MAX_VIDEO_FRAMES,
                         out_frames: int = MAX_AUDIO_FRAMES
                         ) -> Sequence[int]:
    """Geometric upsampling schedule, e.g. 160 -> 1600 -> 16000 -> 160000."""
    num = math.ceil(np.log10(out_frames / in_frames) + 1)
    return [int(s) for s in np.geomspace(in_frames, out_frames, num=num)]


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
    # flax lecun_normal: truncated normal at +-2 std, variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class Dense(nn.Module):
    """``flax.linen.Dense``: ``x @ kernel + bias`` with kernel (in, out)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def reset_parameters(self, generator=None) -> None:
        _lecun_normal_(self.kernel.data, self.kernel.shape[0], generator)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.kernel) + self.bias


class Embed(nn.Module):
    """``flax.linen.Embed``: a (num_embeddings, features) table."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def reset_parameters(self, generator=None) -> None:
        nn.init.normal_(self.embedding.data,
                        std=math.sqrt(1.0 / self.embedding.shape[1]),
                        generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids.long()]


class VideoEncoder(nn.Module):
    """Video (B, F, H, W, C) -> conditioning features (B, T_audio, R).

    A per-frame affine map ``frame_proj`` (H*W*C -> R), then one stage
    per step of the upsampling schedule: a stride-10 kernel-10 stage is
    an (R -> 10R) affine map and a reshape (``upsample_i``); any other
    kernel size is a transposed convolution with parameters
    ``upsample_i_kernel`` (k, R, R) and ``upsample_i_bias``.
    """

    def __init__(self, residual_channels: int,
                 in_frames: int = MAX_VIDEO_FRAMES,
                 out_frames: int = MAX_AUDIO_FRAMES,
                 context_in_channels: int = 1,
                 frame_hw: Tuple[int, int] = VIDEO_FRAME_HW):
        super().__init__()
        r = residual_channels
        self.residual_channels = r
        self.frame_proj = Dense(
            frame_hw[0] * frame_hw[1] * context_in_channels, r)
        self.stages: List[Tuple[int, int, int]] = []
        sizes = video_upsample_sizes(in_frames, out_frames)
        for i, (s_in, s_out) in enumerate(zip(sizes[:-1], sizes[1:])):
            k = upsample_kernel_size(s_in, s_out, stride=UPSAMPLE_STRIDE)
            self.stages.append((i, k, s_out))
            if k == UPSAMPLE_STRIDE:
                setattr(self, f"upsample_{i}", Dense(r, k * r))
            else:
                setattr(self, f"upsample_{i}_kernel",
                        nn.Parameter(torch.empty(k, r, r)))
                setattr(self, f"upsample_{i}_bias",
                        nn.Parameter(torch.zeros(r)))

    def reset_parameters(self, generator=None) -> None:
        self.frame_proj.reset_parameters(generator)
        for i, k, _ in self.stages:
            if k == UPSAMPLE_STRIDE:
                getattr(self, f"upsample_{i}").reset_parameters(generator)
            else:
                # flax lecun_normal on (k, R, R): fan_in = k * R
                w = getattr(self, f"upsample_{i}_kernel")
                _lecun_normal_(w.data, k * self.residual_channels,
                               generator)
                getattr(self, f"upsample_{i}_bias").data.zero_()

    def forward(self, video: torch.Tensor, coarse: bool = False,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """``coarse=True`` stops before a final dense stride-10 stage and
        returns the (B, T/10, R) features.  ``dtype``: every stage's
        operands, result and bias in that type (flax ``Dense(dtype=...)``).
        """
        b, f = video.shape[0], video.shape[1]
        r = self.residual_channels

        def dense(mod, x):
            return torch.matmul(x, mod.kernel.to(dtype)) + mod.bias.to(dtype)

        x = dense(self.frame_proj, video.reshape(b, f, -1).to(dtype))
        n_stages = len(self.stages)
        for i, k, s_out in self.stages:
            if coarse and i == n_stages - 1 and k == UPSAMPLE_STRIDE:
                return x
            if k == UPSAMPLE_STRIDE:
                y = dense(getattr(self, f"upsample_{i}"), x)
                x = y.reshape(b, x.shape[1] * k, r)
            else:
                x = _conv_transpose_valid(
                    x, getattr(self, f"upsample_{i}_kernel").to(dtype),
                    UPSAMPLE_STRIDE) \
                    + getattr(self, f"upsample_{i}_bias").to(dtype)
                x = x[:, :s_out]
        return x


class _Logistic(torch.autograd.Function):
    """sigmoid(g) in g's dtype as XLA computes ``lax.logistic``: 1 / (1 +
    exp(-g)), each step rounded to that dtype; its derivative is JAX's, g'
    * s * (1 - s) (finite where exp(-g) overflows)."""

    @staticmethod
    def forward(ctx, g):
        s = 1.0 / (1.0 + torch.exp(-g))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, grad):
        (s,) = ctx.saved_tensors
        return grad * (s * (1.0 - s))


def _conv_transpose_valid(x: torch.Tensor, w: torch.Tensor,
                          stride: int) -> torch.Tensor:
    """``jax.lax.conv_transpose(x, w, (stride,), "VALID")`` for x (B, T,
    I), w (k, I, O): the input dilated by ``stride``, padded k-1 on the
    left and stride-1+max(k-stride, 0) on the right, correlated with the
    unflipped kernel."""
    k = w.shape[0]
    b, t, c = x.shape
    dil = x.new_zeros(b, (t - 1) * stride + 1, c)
    dil[:, ::stride] = x
    dil = F.pad(dil, (0, 0, k - 1, stride - 1 + max(k - stride, 0)))
    out_len = dil.shape[1] - k + 1
    out = x.new_zeros(b, out_len, w.shape[2])
    for j in range(k):
        out = out + torch.matmul(dil[:, j:j + out_len], w[j])
    return out


class WaveNet(nn.Module):
    """WaveNet with local (video) and global (category) conditioning.

    ``audio`` is (B, T) integer mu-law codes or (B, C, T) float mass.
    """

    def __init__(self, layer_size: int, stack_size: int,
                 input_channels: int, residual_channels: int = 16,
                 skip_channels: int = 16, context_in_channels: int = 1,
                 max_audio_frames: int = MAX_AUDIO_FRAMES,
                 max_video_frames: int = MAX_VIDEO_FRAMES,
                 global_classes: int = 0, use_context: bool = True,
                 compute_dtype: str = "float32", remat: bool = False,
                 fused_strategy: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.fused_strategy = fused_strategy
        self.max_audio_frames = max_audio_frames
        self.max_video_frames = max_video_frames
        self.layer_size = layer_size
        self.stack_size = stack_size
        self.input_channels = c = input_channels
        self.residual_channels = r = residual_channels
        self.skip_channels = s = skip_channels
        self.global_classes = global_classes
        n = len(self.dilations)

        def p(*shape):
            return nn.Parameter(torch.empty(*shape))

        self.front_cur = p(c, r)
        self.front_past = p(c, r)
        self.blocks_w_cur = p(n, r, 2 * r)
        self.blocks_w_past = p(n, r, 2 * r)
        if use_context:
            self.blocks_ctx_kernel = p(n, r, 2 * r)
            self.blocks_ctx_bias = p(n, 2 * r)
        else:
            self.blocks_ctx_kernel = self.blocks_ctx_bias = None
        self.blocks_res_kernel = p(n, r, r)
        self.blocks_res_bias = p(n, r)
        self.blocks_skip_kernel = p(n, r, s)
        self.blocks_skip_bias = p(n, s)
        self.blocks_global_kernel = p(n, r, 2 * r) if global_classes \
            else None
        self.head1 = Dense(s, c)
        self.head2 = Dense(c, c)
        self.global_embed = Embed(global_classes, r) if global_classes \
            else None
        # a geometry whose upsampling schedule has a stage of kernel size
        # < 1 cannot encode video (the JAX model fails at its first video
        # call); such a model has no video encoder at all
        sizes = video_upsample_sizes(max_video_frames, max_audio_frames)
        encodable = all(
            upsample_kernel_size(a, b, stride=UPSAMPLE_STRIDE) >= 1
            for a, b in zip(sizes[:-1], sizes[1:]))
        self.video_encoder = VideoEncoder(
            r, in_frames=max_video_frames, out_frames=max_audio_frames,
            context_in_channels=context_in_channels) \
            if encodable else None
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None) -> None:
        """Random weights with the JAX package's initializer families."""
        r = self.residual_channels
        for w in (self.front_cur, self.front_past):
            _lecun_normal_(w.data, w.shape[0], generator)
        for w in (self.blocks_w_cur, self.blocks_w_past,
                  self.blocks_ctx_kernel, self.blocks_res_kernel,
                  self.blocks_skip_kernel, self.blocks_global_kernel):
            if w is not None:
                _lecun_normal_(w.data, r, generator)
        for bias in (self.blocks_ctx_bias, self.blocks_res_bias,
                     self.blocks_skip_bias):
            if bias is not None:
                bias.data.zero_()
        for m in (self.head1, self.head2, self.global_embed,
                  self.video_encoder):
            if m is not None:
                m.reset_parameters(generator)

    @property
    def dilations(self) -> List[int]:
        return wavenet_dilations(self.layer_size, self.stack_size)

    @property
    def receptive_fields(self) -> int:
        return receptive_field(self.layer_size, self.stack_size)

    # ------------------------------------------------------------ layers
    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype as a torch dtype."""
        return torch.bfloat16 if self.compute_dtype == "bfloat16" \
            else torch.float32

    def _front(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, T) int codes or (B, C, T) float mass -> (B, T, R)."""
        dt = self.dtype
        if audio.ndim == 2 and not torch.is_floating_point(audio):
            # a table lookup whose backward is a one-hot product:
            # deterministic sums, unlike an indexed scatter-add
            return front_embed(self.front_cur, self.front_past, audio, dt)
        if audio.ndim != 3:
            raise ValueError(
                "audio must be (B, T) int codes or (B, C, T) float mass, "
                f"got shape {tuple(audio.shape)}")
        x = audio.transpose(1, 2).to(dt)
        return torch.matmul(x, self.front_cur.to(dt)) \
            + torch.matmul(causal_pad_shift(x, 1), self.front_past.to(dt))

    def encode_video(self, video: torch.Tensor) -> torch.Tensor:
        """Video (B, F, H, W, C) -> (B, T_audio, R) features in the
        compute dtype."""
        if self.video_encoder is None:
            raise ValueError("model has no video encoder parameters")
        return self.video_encoder(video, dtype=self.dtype)

    def encode_video_coarse(self, video: torch.Tensor) -> torch.Tensor:
        if self.video_encoder is None:
            raise ValueError("model has no video encoder parameters")
        return self.video_encoder(video, coarse=True, dtype=self.dtype)

    def embed_global(self, labels: Optional[torch.Tensor]
                     ) -> Optional[torch.Tensor]:
        """(B,) int class ids -> (B, R), or None without global
        conditioning."""
        if labels is None or not self.global_classes:
            return None
        if self.global_embed is None:
            raise ValueError("model has no global_embed parameters")
        return self.global_embed(torch.as_tensor(labels))

    def apply_block(self, l: int, x: torch.Tensor,
                    context: Optional[torch.Tensor],
                    global_vec: Optional[torch.Tensor] = None):
        """One gated residual block: (residual, skip), in the compute
        dtype; with ``remat`` its activations are recomputed in the
        backward instead of kept."""
        if context is not None and self.blocks_ctx_kernel is None:
            raise ValueError(
                "model was built with use_context=False but a "
                "video context was provided")
        if self.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(
                self._block, l, x, context, global_vec, use_reentrant=False)
        return self._block(l, x, context, global_vec)

    def _block(self, l: int, x: torch.Tensor,
               context: Optional[torch.Tensor],
               global_vec: Optional[torch.Tensor]):
        dt = self.dtype

        def dense(v, kernel, bias=None):
            y = torch.matmul(v.to(dt), kernel.to(dt))
            return y if bias is None else y + bias.to(dt)

        fg = dense(x, self.blocks_w_cur[l])
        fg = fg + dense(causal_pad_shift(x, self.dilations[l]),
                        self.blocks_w_past[l])
        if context is not None:
            fg = fg + dense(context, self.blocks_ctx_kernel[l],
                            self.blocks_ctx_bias[l])
        if global_vec is not None and self.global_classes:
            fg = fg + dense(global_vec,
                            self.blocks_global_kernel[l])[:, None, :]
        f, g = torch.chunk(fg, 2, dim=-1)
        gated = torch.tanh(f) * _Logistic.apply(g)
        residual = dense(gated, self.blocks_res_kernel[l],
                         self.blocks_res_bias[l]) + x
        skip = dense(gated, self.blocks_skip_kernel[l],
                     self.blocks_skip_bias[l])
        return residual, skip

    def _head(self, skip_sum: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = torch.matmul(F.leaky_relu(skip_sum.to(dt)),
                         self.head1.kernel.to(dt)) + self.head1.bias.to(dt)
        return torch.matmul(F.leaky_relu(y), self.head2.kernel.to(dt)) \
            + self.head2.bias.to(dt)

    def backbone(self, audio: torch.Tensor,
                 context_features: Optional[torch.Tensor],
                 global_vec: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """Full-length logits (B, T, C); position t predicts sample t+1."""
        h = self._front(audio)
        skip_sum = None
        for l in range(len(self.dilations)):
            h, skip = self.apply_block(l, h, context_features, global_vec)
            skip_sum = skip if skip_sum is None else skip_sum + skip
        return self._head(skip_sum)

    def _context(self, audio, video, start=None):
        """The upsampled video context of ``audio``'s samples: with
        ``start`` None the whole clips (equal lengths, at least RF
        samples), else the window ``[start, start + W)`` of them, cut
        from the whole clips' context."""
        context = self.encode_video(video) if video is not None else None
        t_in = audio.shape[-1] if audio.ndim == 3 else audio.shape[1]
        if start is not None:
            if context is None:
                return None
            if context.shape[1] < start + t_in:
                raise ValueError(
                    f"a window of samples [{start}, {start + t_in}) past "
                    f"the upsampled video's {context.shape[1]}")
            return context[:, start:start + t_in]
        if context is not None and context.shape[1] != t_in:
            raise ValueError(
                "expected upsampled video and audio to have equal time "
                f"lengths, found {context.shape[1]}, {t_in}")
        self.compute_output_size(t_in)
        return context

    def forward(self, audio: torch.Tensor,
                video: Optional[torch.Tensor] = None,
                global_features: Optional[torch.Tensor] = None,
                output_unnormalized: bool = True,
                remove_last: bool = True) -> torch.Tensor:
        """(B, C, T - RF + 1) output, one fewer step with ``remove_last``;
        softmax probabilities unless ``output_unnormalized=False``."""
        context = self._context(audio, video)
        logits = self.backbone(audio, context,
                               self.embed_global(global_features))
        logits = logits[:, self.receptive_fields - 1:, :]
        if remove_last:
            logits = logits[:, :-1, :]
        out = logits.transpose(1, 2).to(torch.float32)
        if not output_unnormalized:
            return out
        return torch.softmax(out, dim=1)

    def train_logits(self, audio: torch.Tensor,
                     video: Optional[torch.Tensor] = None,
                     labels: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """(B, T - RF, C) logits; position i predicts ``codes[:, RF+i]``:
        ``window_logits`` of the whole clips."""
        return self.window_logits(audio, None, self.receptive_fields - 1,
                                  video, labels)

    def window_logits(self, audio: torch.Tensor, start: Optional[int],
                      first: int, video: Optional[torch.Tensor] = None,
                      labels: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """The logits of a window of the clips (a ``seq`` rank's):
        ``audio`` (B, W) int codes holds the clips' samples ``[start,
        start + W)`` (``start`` None: the whole clips) and ``video`` the
        whole clips.  Returns (B, W - 1 - first, C): row i predicts
        ``audio[:, first + 1 + i]``.  The rows before ``first`` are the
        halo, whose own logits see the window's zero fill; a row at or
        past the stack's reach (1 + the sum of the dilations) sees none.
        The context is encoded from the whole clip (the encoder's
        upsampler needs it) and then cut to the window."""
        context = self._context(audio, video, start)
        logits = self.backbone(audio, context, self.embed_global(labels))
        return logits[:, first:-1, :]

    def prompt_state(self, audio: torch.Tensor,
                     context: Optional[torch.Tensor] = None,
                     global_vec: Optional[torch.Tensor] = None):
        """One parallel pass over a prompt: (buffers, last_logits).

        ``buffers[l]`` is (B, d, R) in ring order, the slot of time t
        being ``t mod d``; ``last_logits`` (B, C) predicts position T.
        """
        t_total = audio.shape[-1] if audio.ndim == 3 else audio.shape[1]
        h = self._front(audio)
        buffers = []
        skip_sum = None
        for l, d in enumerate(self.dilations):
            tail = h[:, t_total - d:, :].to(torch.float32)
            # tail index i holds time T-d+i, whose slot is (T+i) mod d
            slots = (torch.arange(d, device=h.device) - t_total) % d
            buffers.append(tail[:, slots])
            h, skip = self.apply_block(l, h, context, global_vec)
            skip_sum = skip if skip_sum is None else skip_sum + skip
        logits = self._head(skip_sum)
        return buffers, logits[:, -1, :].to(torch.float32)

    def init_all(self, audio: torch.Tensor,
                 video: Optional[torch.Tensor] = None,
                 labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Touches every submodule whatever the lengths, as the JAX
        package's ``init_all`` does to build the whole parameter tree.
        The port's modules own their parameters from construction, so
        this only runs the video encoder, the global embedding and the
        backbone once: (B, T, C) logits."""
        ctx = None
        if video is not None:
            t = audio.shape[-1] if audio.ndim == 3 else audio.shape[1]
            ctx = self.encode_video(video)[:, :t]
        if labels is None and self.global_classes:
            labels = torch.zeros(audio.shape[0], dtype=torch.long,
                                 device=self.front_cur.device)
        return self.backbone(audio, ctx, self.embed_global(labels))

    def compute_output_size(self, time_steps: int) -> int:
        return compute_output_size(time_steps, self.layer_size,
                                   self.stack_size)


def make_wavenet(model_config, device=None,
                 generator: Optional[torch.Generator] = None) -> WaveNet:
    """Build a WaveNet from a ModelConfig (either package's)."""
    model = WaveNet(
        layer_size=model_config.layer_size,
        stack_size=model_config.stack_size,
        input_channels=model_config.input_channels,
        residual_channels=model_config.residual_channels,
        skip_channels=model_config.skip_channels,
        context_in_channels=model_config.context_in_channels,
        max_audio_frames=model_config.max_audio_frames,
        max_video_frames=model_config.max_video_frames,
        global_classes=model_config.global_classes,
        use_context=getattr(model_config, "use_context", True),
        compute_dtype=getattr(model_config, "compute_dtype", "float32"),
        remat=getattr(model_config, "remat", False),
        fused_strategy=getattr(model_config, "fused_strategy", None),
        generator=generator,
    )
    return model.to(device) if device is not None else model
