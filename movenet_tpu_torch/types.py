"""Tensor type aliases (reference: movenet/types.py:1-5).

The counterpart of ``movenet_tpu.types``: the aliases document shapes
for tooling and readers (torch tensors carry no named axes).
"""

from __future__ import annotations

import torch

# (batch, time) int32 mu-law codes — the canonical audio representation
AudioCodes = torch.Tensor
# (batch, channels, time) float — one-hot/probability mass audio
# (the reference's AudioTensor layout)
AudioTensor = torch.Tensor
# (batch, frames, height, width, channels) float video
VideoTensor = torch.Tensor
# (batch, time, residual_channels) float local-conditioning features
ContextFeatures = torch.Tensor

__all__ = ["AudioCodes", "AudioTensor", "VideoTensor",
           "ContextFeatures"]
