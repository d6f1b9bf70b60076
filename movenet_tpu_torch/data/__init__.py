"""Data layer: Kinetics-style dataset index, pluggable clip decoders,
host-side preprocessing, and a prefetching loader of CPU-tensor
batches; the counterpart of ``movenet_tpu.data``."""

from movenet_tpu_torch.data.dataset import (
    ClipIndex,
    Example,
    RawClip,
    kinetics_index,
)
from movenet_tpu_torch.data.preprocess import (
    preprocess_audio,
    preprocess_video,
    uniform_temporal_subsample,
)
from movenet_tpu_torch.data.pipeline import DataLoader, get_dataloader
from movenet_tpu_torch.data.synthetic import make_synthetic_dataset

__all__ = [
    "ClipIndex",
    "Example",
    "RawClip",
    "kinetics_index",
    "preprocess_audio",
    "preprocess_video",
    "uniform_temporal_subsample",
    "DataLoader",
    "get_dataloader",
    "make_synthetic_dataset",
]
