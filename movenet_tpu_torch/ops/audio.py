"""Audio preprocessing on torch tensors: normalization, quantization,
one-hot encoding.

The counterpart of ``movenet_tpu.ops.audio``: the reference's per-example
transforms (dataset.py:265-289) as tensor ops, so they can run on the
device.  The data loader keeps its NumPy twins
(``data.preprocess.normalize_audio_np``).
"""

from __future__ import annotations

import torch

from movenet_tpu_torch.ops.mulaw import mu_law_encode


def normalize_audio(audio: torch.Tensor) -> torch.Tensor:
    """Min-max normalize a waveform to [-1, 1].

    Matches dataset.py:265-275 including the all-zero guard: a signal
    summing to exactly 0 is returned unchanged (the reference's
    TODO-noted behavior), and a constant one divides by 1.
    """
    audio = torch.as_tensor(audio)
    min_val = audio.min()
    max_val = audio.max()
    rng = max_val - min_val
    safe = torch.where(rng == 0, torch.ones_like(rng), rng)
    normed = (audio - min_val) / safe * 2.0 - 1.0
    return torch.where(audio.sum() == 0, audio, normed)


def quantize_audio(audio: torch.Tensor, input_channels: int,
                   normalize: bool = True) -> torch.Tensor:
    """Normalize (optionally) then mu-law quantize to int32 codes."""
    if normalize:
        audio = normalize_audio(audio)
    return mu_law_encode(audio, input_channels)


def one_hot_encode_audio(audio: torch.Tensor, input_channels: int,
                         normalize: bool = True) -> torch.Tensor:
    """Waveform (frames,) or (1, frames) -> one-hot (input_channels,
    frames) float32 (normalize -> mu-law -> scatter, dataset.py:278-289);
    a code outside [0, input_channels) gives a zero column, as
    ``jax.nn.one_hot`` does."""
    q = quantize_audio(torch.as_tensor(audio).reshape(-1), input_channels,
                       normalize=normalize)
    channels = torch.arange(input_channels, device=q.device)
    return (q[None, :] == channels[:, None]).to(torch.float32)


__all__ = ["normalize_audio", "quantize_audio", "one_hot_encode_audio"]
