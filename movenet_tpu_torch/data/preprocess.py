"""Host-side preprocessing (numpy): the counterpart of
``movenet_tpu.data.preprocess``, line for line, so the same clip gives
the same arrays (the resample plan is ``ops/resample._resample_plan``).

The reference runs these per-example on dataloader worker processes
(dataset.py:162-310).  Here they are vectorized numpy on loader threads
(or inside the native C++ loader, ``movenet_tpu_torch/native``).

Pipeline per clip (reference order, dataset.py:177-183, 253-310):
  audio: mean over channels -> sinc-resample to exactly MAX_AUDIO_FRAMES
         -> min-max normalize to [-1, 1] -> mu-law encode -> int codes
  video: RGB -> grayscale -> bilinear resize to 64x64 ->
         uniform temporal subsample to MAX_VIDEO_FRAMES frames
"""

from __future__ import annotations

import numpy as np

from movenet_tpu_torch.ops.resample import _resample_plan

MAX_AUDIO_FRAMES = 160_000
MAX_VIDEO_FRAMES = 160
FRAME_HW = (64, 64)

# ITU-R 601 luma weights (torchvision rgb_to_grayscale)
_LUMA = np.array([0.2989, 0.587, 0.114], dtype=np.float32)


# ----------------------------------------------------------------- audio
def mu_law_encode_np(x: np.ndarray, quantization_channels: int = 256
                     ) -> np.ndarray:
    mu = float(quantization_channels - 1)
    x = x.astype(np.float32)
    y = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    return ((y + 1.0) / 2.0 * mu + 0.5).astype(np.int32)


def mu_law_decode_np(q: np.ndarray, quantization_channels: int = 256
                     ) -> np.ndarray:
    mu = float(quantization_channels - 1)
    y = q.astype(np.float32) / mu * 2.0 - 1.0
    return np.sign(y) * np.expm1(np.abs(y) * np.log1p(mu)) / mu


def normalize_audio_np(audio: np.ndarray) -> np.ndarray:
    if audio.sum() == 0:
        return audio
    lo, hi = audio.min(), audio.max()
    rng = hi - lo
    if rng == 0:
        rng = 1.0
    return (audio - lo) / rng * 2.0 - 1.0


def resample_np(x: np.ndarray, orig_freq: int, new_freq: int,
                lowpass_filter_width: int = 6, rolloff: float = 0.99
                ) -> np.ndarray:
    """Host-side twin of ops.resample (same cached plan, numpy gather)."""
    if int(orig_freq) == int(new_freq):
        return x
    idx, w, t_out = _resample_plan(
        int(orig_freq), int(new_freq), int(x.shape[-1]),
        int(lowpass_filter_width), float(rolloff))
    gathered = x[..., idx]                      # (..., T_out, D)
    return np.einsum("...td,td->...t", gathered.astype(np.float32), w)


def preprocess_audio(audio: np.ndarray,
                     input_channels: int,
                     normalize: bool = True,
                     target_frames: int = MAX_AUDIO_FRAMES) -> np.ndarray:
    """Waveform -> (target_frames,) int32 mu-law codes.

    Reproduces resample_audio + one_hot_encode_audio semantics
    (dataset.py:253-289) with codes instead of a one-hot matrix — the
    model's input layer consumes codes directly (an embedding gather is
    the one-hot matmul).
    """
    audio = np.asarray(audio, dtype=np.float32)
    from movenet_tpu_torch.native import loader as native
    if native.available():
        return native.preprocess_audio(audio, input_channels,
                                       normalize, target_frames)
    if audio.ndim == 2:
        # stereo -> mono by channel mean (dataset.py:258)
        audio = audio.mean(axis=0)
    # the reference's unusual call: orig_freq = len(x) (dataset.py:259)
    out = resample_np(audio, int(audio.shape[-1]), int(target_frames))
    out = out[:target_frames]
    if normalize:
        out = normalize_audio_np(out)
    return mu_law_encode_np(out, input_channels)


# ----------------------------------------------------------------- video
def uniform_temporal_subsample(video: np.ndarray, num_samples: int,
                               axis: int = 0) -> np.ndarray:
    """pytorchvideo semantics (dataset.py:305-307): evenly spaced
    indices ``linspace(0, T-1, num_samples).long()`` — torch's .long()
    TRUNCATES toward zero (no rounding)."""
    t = video.shape[axis]
    idx = np.linspace(0, t - 1, num_samples)
    idx = np.clip(idx, 0, t - 1).astype(np.int64)  # truncation
    return np.take(video, idx, axis=axis)


def _bilinear_resize(frame: np.ndarray, out_hw) -> np.ndarray:
    """Bilinear resize (align_corners=False) of an (H, W) image."""
    h, w = frame.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return frame.astype(np.float32)
    # sample positions at pixel centers
    ys = (np.arange(oh) + 0.5) * h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * w / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)
    wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)
    f = frame.astype(np.float32)
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    return top * (1 - wy[:, None]) + bot * wy[:, None]


def preprocess_video(video: np.ndarray,
                     num_frames: int = MAX_VIDEO_FRAMES,
                     frame_hw=FRAME_HW) -> np.ndarray:
    """(F, H, W, 3) uint8 -> (num_frames, 64, 64, 1) float32.

    Reference: resize_video (dataset.py:292-310): grayscale, resize,
    uniform temporal subsample.  Pixel scale stays 0..255 — the
    reference feeds unnormalized intensities into its Conv3d.
    """
    video = np.asarray(video)
    if video.ndim != 4 or video.shape[-1] not in (1, 3):
        raise ValueError(f"expected (F, H, W, 1|3) video, got {video.shape}")
    if video.dtype == np.uint8 and video.shape[-1] == 3:
        # the C++ hot loop fuses luma + resize; single-channel input
        # (ffmpeg server-side-scaled frames) skips straight to the
        # cheap same-size path below
        from movenet_tpu_torch.native import loader as native
        if native.available():
            return native.preprocess_video(video, num_frames, frame_hw)
    if video.shape[-1] == 3:
        gray = (video.astype(np.float32) @ _LUMA)
        # torchvision casts back to the input dtype: .to(uint8)
        # TRUNCATES toward zero
        if video.dtype == np.uint8:
            gray = np.trunc(gray)
    else:
        gray = video[..., 0].astype(np.float32)

    frames = np.stack(
        [_bilinear_resize(fr, frame_hw) for fr in gray], axis=0)
    frames = uniform_temporal_subsample(frames, num_frames, axis=0)
    if frames.shape[0] > num_frames:
        frames = frames[:num_frames]
    return frames[..., None].astype(np.float32)
