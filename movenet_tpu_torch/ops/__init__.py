"""Core numeric ops of the port: mu-law codec, audio preprocessing,
resampling, causal-conv geometry and its matmul form, and
the training path's fused ops (trunk, merged trunk + head/CE, gated
block, head/CE), whose CUDA kernels live in ``ops/cuda``."""

from movenet_tpu_torch.ops.mulaw import mu_law_decode, mu_law_encode
from movenet_tpu_torch.ops.audio import (
    normalize_audio,
    one_hot_encode_audio,
    quantize_audio,
)
from movenet_tpu_torch.ops.resample import resample, resample_to_length
from movenet_tpu_torch.ops.conv import (
    causal_pad_shift,
    compute_output_size,
    dilated_causal_matmul,
    receptive_field,
    upsample_kernel_size,
    wavenet_dilations,
)
from movenet_tpu_torch.ops.gated_block import fused_gated_block
from movenet_tpu_torch.ops.head_loss import fused_head_loss
from movenet_tpu_torch.ops.stack_kernel import (
    fused_stack,
    fused_stack_embed,
    fused_stack_head_loss,
)

__all__ = [
    "mu_law_encode",
    "mu_law_decode",
    "normalize_audio",
    "one_hot_encode_audio",
    "quantize_audio",
    "resample",
    "resample_to_length",
    "causal_pad_shift",
    "compute_output_size",
    "dilated_causal_matmul",
    "receptive_field",
    "upsample_kernel_size",
    "wavenet_dilations",
    "fused_stack",
    "fused_stack_embed",
    "fused_stack_head_loss",
    "fused_gated_block",
    "fused_head_loss",
]
