"""Build the native IO library:  python -m movenet_tpu_torch.native.build

One ``g++`` call compiles ``io_loader.cpp`` and ``pipeline.cpp`` into
``build/movenet_tpu_torch/native/movenet_io-<hash>.so`` (the hash covers
the sources and the flags, so an edited source rebuilds; the directory
follows ``ops/cuda/build.build_dir``).  The flags are the JAX package's
without ``-march=native``: the build directory may travel with the
checkout to another host.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path

from movenet_tpu_torch.ops.cuda.build import build_dir

HERE = Path(__file__).resolve().parent
SRCS = (HERE / "io_loader.cpp", HERE / "pipeline.cpp")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffast-math", "-pthread")


def target() -> Path:
    """Where the library of the current sources and flags lives."""
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in SRCS)
                            + " ".join(FLAGS).encode()).hexdigest()
    return build_dir() / "native" / f"movenet_io-{digest[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the library unless it is built; returns its path and
    raises with the compiler's output on a failure."""
    out = target()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, *[str(s) for s in SRCS], "-o", str(tmp)]
    if verbose:
        print(" ".join(cmd))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed (g++ exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    tmp.replace(out)  # atomic: concurrent builders each write their own tmp
    return out


if __name__ == "__main__":
    print(f"built {build(verbose=True)}")
    sys.exit(0)
