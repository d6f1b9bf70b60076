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
and head/CE kernels and their backwards (``train/loop``), on one card or
data-parallel over several (``parallel/``, one process per card).
"""

__version__ = "0.1.0"

from movenet_tpu_torch.config import ModelConfig, TrainingConfig

MAX_AUDIO_FRAMES = 160_000  # 10 s @ 16 kHz (reference: wavenet.py:27)
MAX_VIDEO_FRAMES = 160      # 16 fps video frames  (reference: wavenet.py:28)
VIDEO_FRAME_SIZE = (64, 64)  # H, W after resize   (reference: wavenet.py:29)
UPSAMPLE_STRIDE = 10        # per transposed-conv upsample stage (wavenet.py:31)

__all__ = [
    "ModelConfig",
    "TrainingConfig",
    "MAX_AUDIO_FRAMES",
    "MAX_VIDEO_FRAMES",
    "VIDEO_FRAME_SIZE",
    "UPSAMPLE_STRIDE",
    "make_wavenet",
    "mu_law_encode",
    "mu_law_decode",
    "fast_generate",
    "__version__",
]

# the entry points a user reaches for first, resolved on first access so
# that ``import movenet_tpu_torch`` stays light
_LAZY = {
    "make_wavenet": ("movenet_tpu_torch.models.wavenet", "make_wavenet"),
    "mu_law_encode": ("movenet_tpu_torch.ops.mulaw", "mu_law_encode"),
    "mu_law_decode": ("movenet_tpu_torch.ops.mulaw", "mu_law_decode"),
    "fast_generate": ("movenet_tpu_torch.models.sampler", "fast_generate"),
}


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module 'movenet_tpu_torch' has no attribute {name!r}") from None
    import importlib

    val = getattr(importlib.import_module(mod_name), attr)
    globals()[name] = val  # cache for subsequent lookups
    return val
