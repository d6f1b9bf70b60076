"""Core numeric ops of the port: mu-law codec and causal-conv geometry."""

from movenet_tpu_torch.ops.mulaw import mu_law_decode, mu_law_encode
from movenet_tpu_torch.ops.conv import (
    causal_pad_shift,
    compute_output_size,
    receptive_field,
    upsample_kernel_size,
    wavenet_dilations,
)

__all__ = [
    "mu_law_encode",
    "mu_law_decode",
    "causal_pad_shift",
    "compute_output_size",
    "receptive_field",
    "upsample_kernel_size",
    "wavenet_dilations",
]
