"""Sinc-interpolation audio resampler (torchaudio-compatible semantics).

The counterpart of ``movenet_tpu.ops.resample``: the same windowed-sinc
lowpass interpolator as torchaudio's ``sinc_interp_hann`` method,

    gcd-reduce (orig, new);  base = min(orig, new) * rolloff
    t(m, i)   = (i/orig - m/new) * base          (input i, output m)
    weight    = sinc(pi*t) * cos(t*pi/(2*width_p))^2 * base/orig,  |t| < width_p
                0 otherwise   (width_p = lowpass_filter_width)

computed as a host-side plan of (T_out, D) gather indices and tap weights
(float64 on the host, float32 stored; ``_resample_plan`` is the JAX
package's, line for line) and, on the tensor's device, a gather plus a
row-wise dot.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _resample_plan(orig_freq: int, new_freq: int, length: int,
                   lowpass_filter_width: int, rolloff: float):
    """Gather indices and tap weights for a fixed-size resample.

    Returns (indices (T_out, D) int32, weights (T_out, D) float32, T_out).
    Out-of-range indices are clamped with zero weights (zero-pad
    semantics, matching torchaudio's explicit padding).
    """
    if orig_freq <= 0 or new_freq <= 0:
        raise ValueError("frequencies must be positive")
    g = math.gcd(int(orig_freq), int(new_freq))
    orig = int(orig_freq) // g
    new = int(new_freq) // g

    base = min(orig, new) * rolloff
    # tap half-width in input samples
    width = int(math.ceil(lowpass_filter_width * orig / base))
    d = 2 * width + 2  # static support bound per output sample

    t_out = int(math.ceil(new * length / orig))

    m = np.arange(t_out, dtype=np.int64)
    j, p = m // new, m % new
    # exact output time in input-sample units: tau = j*orig + p*orig/new
    frac = p.astype(np.float64) * orig / new          # in [0, orig)
    d0 = (p * orig) // new - width                     # int64, first tap
    r = np.arange(d, dtype=np.int64)
    idx = j[:, None] * orig + d0[:, None] + r[None, :]  # (T_out, D)

    # t in "lowpass widths": ((i - tau)/orig) * base
    i_rel = (d0[:, None] + r[None, :]).astype(np.float64) - frac[:, None]
    t = i_rel / orig * base
    inside = np.abs(t) < lowpass_filter_width
    t_c = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t_c * np.pi / lowpass_filter_width / 2.0) ** 2
    tp = t_c * np.pi
    sinc = np.where(tp == 0, 1.0, np.sin(tp) / np.where(tp == 0, 1.0, tp))
    scale = base / orig
    w = np.where(inside, sinc * window * scale, 0.0)

    valid = (idx >= 0) & (idx < length)
    w = np.where(valid, w, 0.0)
    idx = np.clip(idx, 0, length - 1)

    return (idx.astype(np.int32), w.astype(np.float32), t_out)


def resample(x: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6, rolloff: float = 0.99
             ) -> torch.Tensor:
    """Resample the last axis of ``x`` from orig_freq to new_freq; output
    length ``ceil(new/orig * T)``, float32 (float64 for float64 input)."""
    x = torch.as_tensor(x)
    idx, w, _ = _resample_plan(
        int(orig_freq), int(new_freq), int(x.shape[-1]),
        int(lowpass_filter_width), float(rolloff))
    if int(orig_freq) == int(new_freq):
        return x
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    w_t = torch.from_numpy(w).to(device=x.device, dtype=dtype)
    gathered = x[..., torch.from_numpy(idx).to(x.device).long()]
    return torch.einsum("...td,td->...t", gathered.to(dtype), w_t)


def resample_to_length(x: torch.Tensor, target_length: int,
                       **kwargs) -> torch.Tensor:
    """Resample a waveform so its last axis has exactly ``target_length``:
    the reference's ``resample(x, orig_freq=len(x), new_freq=160000)``,
    with its defensive truncation."""
    out = resample(x, int(x.shape[-1]), int(target_length), **kwargs)
    return out[..., :target_length]
