"""Mu-law companding codec, the same closed forms as movenet_tpu.ops.mulaw.

For ``mu = quantization_channels - 1``:

    encode:  y = sign(x) * log1p(mu*|x|) / log1p(mu)
             q = int((y + 1) / 2 * mu + 0.5)        (truncating cast)
    decode:  y = q / mu * 2 - 1
             x = sign(y) * expm1(|y| * log1p(mu)) / mu

The encoder does not clamp: out-of-range inputs give out-of-range codes,
as upstream does.  All arithmetic is float32, operation for operation as
in the JAX package.
"""

from __future__ import annotations

import torch


def mu_law_encode(x: torch.Tensor, quantization_channels: int = 256
                  ) -> torch.Tensor:
    """Quantize a [-1, 1] float signal to int32 mu-law codes."""
    mu = float(quantization_channels - 1)
    x = torch.as_tensor(x).to(torch.float32)
    log1p_mu = torch.log1p(torch.tensor(mu, dtype=torch.float32))
    y = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / log1p_mu
    # the int cast truncates toward zero, like upstream's .to(int64)
    return ((y + 1.0) / 2.0 * mu + 0.5).to(torch.int32)


def mu_law_decode(q: torch.Tensor, quantization_channels: int = 256
                  ) -> torch.Tensor:
    """Expand integer mu-law codes back to float32 in [-1, 1]."""
    mu = float(quantization_channels - 1)
    y = torch.as_tensor(q).to(torch.float32) / mu * 2.0 - 1.0
    log1p_mu = torch.log1p(torch.tensor(mu, dtype=torch.float32))
    return torch.sign(y) * torch.expm1(torch.abs(y) * log1p_mu) / mu
