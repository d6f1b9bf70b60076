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


def dilated_causal_matmul(x: torch.Tensor, w_cur: torch.Tensor,
                          w_past: torch.Tensor, dilation: int,
                          preferred_dtype=torch.float32) -> torch.Tensor:
    """Size-2 dilated causal conv as two matrix products.

    x (batch, time, c_in); w_cur (c_in, c_out), the tap for x[t]; w_past,
    the tap for x[t - dilation].  Returns (batch, time, c_out), full
    length (left zero-pad semantics), in ``preferred_dtype``: the
    operands are widened to it first, so bf16 products are exact and
    summed in float32, as JAX's ``preferred_element_type`` gives them
    (None: the operands' own dtype).
    """
    if preferred_dtype is not None:
        x, w_cur, w_past = (t.to(preferred_dtype) for t in (x, w_cur, w_past))
    return torch.matmul(x, w_cur) + torch.matmul(
        causal_pad_shift(x, dilation), w_past)


def upsample_kernel_size(in_size: int, out_size: int, stride: int = 1,
                         padding: int = 0, output_padding: int = 0,
                         dilation: int = 1) -> int:
    """Transposed-conv kernel size that maps in_size -> out_size."""
    x = out_size - 1 - output_padding - (in_size - 1) * stride + 2 * padding
    return int(x / dilation + 1)
