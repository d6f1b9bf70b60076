"""Utilities of the port: metric writers, sample export, the speculative
hit replay and training fixtures."""

from movenet_tpu_torch.utils.observability import (
    JsonlWriter,
    MultiWriter,
    make_writer,
)
from movenet_tpu_torch.utils.samples import export_samples, write_wav

__all__ = [
    "JsonlWriter",
    "MultiWriter",
    "make_writer",
    "export_samples",
    "write_wav",
]
