"""Hand-written CUDA kernels of the port, their wrappers and plain
versions.  Kernels build at first use (``build.py``), never at import."""

from movenet_tpu_torch.ops.cuda.ar_sampler import (
    cuda_generate,
    launch_counts,
    plain_generate,
    reset_launch_counts,
)

__all__ = ["cuda_generate", "plain_generate", "launch_counts",
           "reset_launch_counts"]
