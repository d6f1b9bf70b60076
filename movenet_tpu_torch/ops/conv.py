"""Causal-convolution geometry and the time shift, as in movenet_tpu.

A size-2 dilated causal convolution is ``W_cur @ x[t] + W_past @ x[t-d]``:
two matrix products and a time shift.  Activations are (batch, time,
channels) throughout, the JAX package's layout.
"""

from __future__ import annotations

from typing import List

import torch


def wavenet_dilations(layer_size: int, stack_size: int) -> List[int]:
    """Dilation schedule ``2^0..2^(L-1)`` repeated ``S`` times."""
    return [2 ** l for _ in range(stack_size) for l in range(layer_size)]


def receptive_field(layer_size: int, stack_size: int) -> int:
    """``sum(dilations) + stack_size``; L=10, S=3 gives 3072."""
    return sum(wavenet_dilations(layer_size, stack_size)) + stack_size


def compute_output_size(time_steps: int, layer_size: int, stack_size: int
                        ) -> int:
    """Valid output length ``T - RF + 1``; raises when it is below 1."""
    rf = receptive_field(layer_size, stack_size)
    out = time_steps - rf + 1
    if out < 1:
        raise ValueError(
            "input time steps must be larger than the number of receptive "
            f"fields. Number of input timesteps = {time_steps}, "
            f"receptive fields = {rf}"
        )
    return out


def causal_pad_shift(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Shift (batch, time, channels) right by ``shift`` along time,
    zero-filling: ``y[:, t] = x[:, t - shift]``, ``y[:, :shift] = 0``."""
    if shift == 0:
        return x
    t = x.shape[1]
    y = torch.zeros_like(x)
    if shift < t:
        y[:, shift:] = x[:, :t - shift]
    return y


def upsample_kernel_size(in_size: int, out_size: int, stride: int = 1,
                         padding: int = 0, output_padding: int = 0,
                         dilation: int = 1) -> int:
    """Transposed-conv kernel size that maps in_size -> out_size."""
    x = out_size - 1 - output_padding - (in_size - 1) * stride + 2 * padding
    return int(x / dilation + 1)
