"""Build the port's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own by ``nvcc`` into ``build/movenet_tpu_torch/<name>-<hash>.so`` (the
hash covers the source, the shared headers ``csrc/*.cuh`` and the flags,
so an edited source or header rebuilds), at first use.  Several sources build in parallel, one ``nvcc`` each.  The
library is then opened with ``ctypes``.  Nothing here runs at import.

    python -m movenet_tpu_torch.ops.cuda.build    # build every source
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output (register and shared-memory use per kernel) by source name
build_logs: Dict[str, str] = {}


def build_dir() -> Path:
    """``build/movenet_tpu_torch`` beside the package, or the directory
    named by ``MOVENET_TORCH_BUILD_DIR``."""
    env = os.environ.get("MOVENET_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[1] / "build" / "movenet_tpu_torch"


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the "
            "port's CUDA kernels are built on the machine with the GPU")
    return found


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _target(src: Path) -> Path:
    """The library path of ``src``, named by a hash of the source, every
    shared header beside it (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet,
    one nvcc process per source, all started together.  Returns the
    library path of each; raises with nvcc's output on a failure."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    unknown = [n for n in names if n not in srcs]
    if unknown:
        raise KeyError(f"no CUDA source named {unknown} in {CSRC}")
    out = {n: _target(srcs[n]) for n in names}
    todo = [n for n in names if not out[n].is_file()]
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[n] = log
        if proc.returncode != 0:
            failed.append(f"{srcs[n].name} (nvcc exit {proc.returncode}):"
                          f"\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            tmp.replace(out[n])
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib


if __name__ == "__main__":
    for name, path in build().items():
        print(f"{name}: {path}")
        if name in build_logs:
            print(build_logs[name])
