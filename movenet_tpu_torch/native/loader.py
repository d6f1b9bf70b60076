"""ctypes binding for the native C++ preprocess/IO library.

The counterpart of ``movenet_tpu.native.loader``.  Functions release the
GIL for their entire duration (ctypes foreign calls), so the thread pool
of ``data/pipeline.py`` gets true multi-core preprocessing when the
library is built (``python -m movenet_tpu_torch.native.build``).  Every
call site takes the numpy implementations when it is not built.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from movenet_tpu_torch.native import build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _bind(lib: ctypes.CDLL) -> Optional[ctypes.CDLL]:
    if lib.mn_api_version() != 1:
        return None
    lib.mn_preprocess_video.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_void_p,
    ]
    lib.mn_preprocess_video.restype = ctypes.c_int
    lib.mn_preprocess_audio.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.mn_preprocess_audio.restype = ctypes.c_int
    lib.mn_pipe_create.argtypes = [
        ctypes.c_int, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.mn_pipe_create.restype = ctypes.c_void_p
    lib.mn_pipe_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mn_pipe_submit.restype = ctypes.c_long
    lib.mn_pipe_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p]
    lib.mn_pipe_next.restype = ctypes.c_int
    lib.mn_pipe_destroy.argtypes = [ctypes.c_void_p]
    lib.mn_pipe_destroy.restype = None
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, or None while it is not built."""
    global _lib
    with _lock:
        if _lib is None:
            path = build.target()
            if not path.is_file():
                return None
            _lib = _bind(ctypes.CDLL(str(path)))
        return _lib


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library is not built (python -m "
                           "movenet_tpu_torch.native.build)")
    return lib


def available() -> bool:
    return _load() is not None


class NativePipeline:
    """C++ decode->preprocess pipeline over worker threads.

    Each submitted media file is decoded (ffmpeg subprocesses spawned
    from C++), preprocessed with the io_loader routines, and handed
    back in SUBMISSION ORDER by :meth:`next`, one blocking ctypes call
    per clip.  Outputs are bit-identical to the Python decode_clip +
    preprocess path.
    """

    def __init__(self, num_workers: int, num_frames: int,
                 frame_hw, audio_target: int, quant: int,
                 normalize: bool, use_video: bool):
        lib = _require()
        self._lib = lib
        self.num_frames = num_frames
        self.oh, self.ow = frame_hw
        self.audio_target = audio_target
        self.use_video = use_video
        self._h = lib.mn_pipe_create(
            int(num_workers), num_frames, self.oh, self.ow,
            audio_target, int(quant), int(bool(normalize)),
            int(bool(use_video)))
        self._pending = 0

    def submit(self, path) -> None:
        self._lib.mn_pipe_submit(self._h, str(path).encode())
        self._pending += 1

    def next(self):
        """(codes, video) for the next submitted clip, or None when the
        clip failed to decode (no audio / bad container)."""
        if self._pending <= 0:
            raise RuntimeError("NativePipeline.next() with no "
                               "submitted jobs")
        self._pending -= 1
        codes = np.empty(self.audio_target, np.int32)
        video = None
        vptr = None
        if self.use_video:
            video = np.empty(
                (self.num_frames, self.oh, self.ow), np.float32)
            vptr = video.ctypes.data
        rc = self._lib.mn_pipe_next(self._h, codes.ctypes.data, vptr)
        if rc != 0:
            return None
        return codes, (None if video is None else video[..., None])

    def close(self) -> None:
        if self._h is not None:
            self._lib.mn_pipe_destroy(self._h)
            self._h = None


def preprocess_video(video: np.ndarray, num_frames: int,
                     frame_hw=(64, 64)) -> np.ndarray:
    """(F, H, W, 1|3) uint8 -> (num_frames, oh, ow, 1) float32."""
    lib = _require()
    video = np.ascontiguousarray(video, dtype=np.uint8)
    f, h, w, c = video.shape
    oh, ow = frame_hw
    out = np.empty((num_frames, oh, ow), np.float32)
    rc = lib.mn_preprocess_video(
        video.ctypes.data, f, h, w, c, num_frames, oh, ow,
        out.ctypes.data)
    if rc != 0:
        raise ValueError(f"native video preprocess failed (rc={rc}) for "
                         f"shape {video.shape}")
    return out[..., None]


def preprocess_audio(audio: np.ndarray, input_channels: int,
                     normalize: bool, target_frames: int) -> np.ndarray:
    """(S,) or (ch, S) float32 -> (target_frames,) int32 mu-law codes."""
    lib = _require()
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    ch, s = audio.shape
    out = np.empty(target_frames, np.int32)
    rc = lib.mn_preprocess_audio(
        audio.ctypes.data, ch, s, target_frames, int(input_channels),
        int(bool(normalize)), out.ctypes.data)
    if rc != 0:
        raise ValueError(f"native audio preprocess failed (rc={rc})")
    return out
