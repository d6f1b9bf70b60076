"""The WaveNet, its parameter converter and the samplers."""

from movenet_tpu_torch.models.wavenet import WaveNet, make_wavenet

__all__ = ["WaveNet", "make_wavenet"]
