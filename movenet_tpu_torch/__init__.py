"""movenet_tpu_torch — the PyTorch and CUDA port of movenet_tpu.

A second package beside the JAX one, mirroring its module names.  It
imports torch and never jax.  Plain tensor code is PyTorch; the TPU's
Pallas kernels become hand-written CUDA kernels for Hopper (sm_90a) under
``csrc/``, each with a plain PyTorch version beside it that the wrapper
uses for tensors on the CPU.  So far it serves generation: config,
mu-law, the resampler, the WaveNet forward, the cached samplers, the
single-launch AR sampler kernels (standard, video-conditioned and
speculative), parameter checkpoints, the TCP server and the generate CLI
with dataset prompts; it has the data layer (``data/``, with the native
C++ preprocessing in ``native/``); and it trains with the fused trunk
and head/CE kernels and their backwards (``train/loop``).
"""

__version__ = "0.1.0"

from movenet_tpu_torch.config import ModelConfig, TrainingConfig

__all__ = ["ModelConfig", "TrainingConfig", "__version__"]
