"""Media-file decoding backends.

The counterpart of ``movenet_tpu.data.video``, unchanged in behaviour.

The reference decodes mp4s with torchvision.io/PyAV (FFmpeg underneath,
dataset.py:168).  Codecs are an environment property, so decode is
dispatched across backends in priority order:

  1. the native C++ loader (movenet_tpu_torch/native, ctypes-bound) when
     the shared library has been built — threaded decode + preprocess off
     the Python GIL;
  2. the ``ffmpeg``/``ffprobe`` CLI when present on PATH — frames piped
     as rawvideo rgb24, audio as f32le PCM;
  3. otherwise a clear error naming the missing capability (the packed
     ``.npz`` clip format in data/dataset.py always works and is what
     tests/benchmarks use).
"""

from __future__ import annotations

import json
import logging
import shutil
import subprocess
from pathlib import Path

import numpy as np

from movenet_tpu_torch.data.dataset import RawClip

logger = logging.getLogger(__name__)


def _have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None and \
        shutil.which("ffprobe") is not None


def _probe(fp: Path) -> dict:
    out = subprocess.run(
        ["ffprobe", "-v", "error", "-print_format", "json",
         "-show_streams", str(fp)],
        capture_output=True, check=True)
    return json.loads(out.stdout)


def _read_frames(cmd, frame_bytes: int, shape) -> "np.ndarray | None":
    """Stream fixed-size raw frames from an ffmpeg pipe.

    Bounded memory: only one frame is buffered in the pipe read at a
    time (plus the OS pipe buffer); the old implementation buffered the
    ENTIRE clip decoded to full-res rgb24 (~1 GB for 10 s of 1080p).
    """
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    frames = []
    try:
        while True:
            buf = proc.stdout.read(frame_bytes)
            if len(buf) < frame_bytes:
                break
            frames.append(
                np.frombuffer(buf, dtype=np.uint8).reshape(shape))
    finally:
        proc.stdout.close()
        stderr = proc.stderr.read()
        proc.stderr.close()
        rc = proc.wait()
    if rc != 0:
        raise RuntimeError(
            f"ffmpeg video decode failed (rc={rc}): "
            f"{stderr.decode(errors='replace')[:300]}")
    return np.stack(frames) if frames else None


def _decode_ffmpeg_cli(fp: Path, scale_hw=(64, 64)) -> RawClip:
    """Decode via the ffmpeg CLI.

    With ``scale_hw`` set (default: the model's 64x64 input), grayscale
    conversion and bilinear scaling run INSIDE ffmpeg's filter graph, so
    the pipe carries h*w bytes per frame (4 KB) instead of a full-res
    rgb24 frame (~6 MB at 1080p), and frames are streamed rather than
    buffered whole-clip.  preprocess_video treats the (F, h, w, 1)
    result's resize as a no-op.  ``scale_hw=None`` returns original-
    resolution rgb24 (host-side preprocessing then bit-matches the
    reference's resize; the scaled path matches to filter-graph
    precision).
    """
    info = _probe(fp)
    vstream = next((s for s in info["streams"]
                    if s["codec_type"] == "video"), None)
    astream = next((s for s in info["streams"]
                    if s["codec_type"] == "audio"), None)

    video = None
    video_fps = 0.0
    if vstream is not None:
        num, den = vstream.get("avg_frame_rate", "0/1").split("/")
        video_fps = float(num) / float(den) if float(den) else 0.0
        if scale_hw is not None:
            h, w = scale_hw
            cmd = ["ffmpeg", "-v", "error", "-i", str(fp),
                   "-vf", f"scale={w}:{h}:flags=bilinear,format=gray",
                   "-f", "rawvideo", "-pix_fmt", "gray", "-"]
            video = _read_frames(cmd, w * h, (h, w, 1))
        else:
            w, h = int(vstream["width"]), int(vstream["height"])
            cmd = ["ffmpeg", "-v", "error", "-i", str(fp),
                   "-f", "rawvideo", "-pix_fmt", "rgb24", "-"]
            video = _read_frames(cmd, w * h * 3, (h, w, 3))

    audio = None
    audio_fps = 0.0
    if astream is not None:
        audio_fps = float(astream.get("sample_rate", 0))
        ch = int(astream.get("channels", 1))
        raw = subprocess.run(
            ["ffmpeg", "-v", "error", "-i", str(fp), "-f", "f32le",
             "-acodec", "pcm_f32le", "-"],
            capture_output=True, check=True).stdout
        pcm = np.frombuffer(raw, dtype=np.float32)
        if ch > 1:
            pcm = pcm[: (len(pcm) // ch) * ch].reshape(-1, ch).T
        audio = pcm

    return RawClip(
        video=video,
        audio=audio,
        info={
            "video_fps": video_fps,
            "audio_fps": audio_fps,
            "video_orig_dim": 0 if video is None else int(video.shape[0]),
            "audio_orig_dim": 0 if audio is None else int(audio.shape[-1]),
        },
    )


def decode_media_file(fp: Path, scale_hw=(64, 64)) -> RawClip:
    # container decode goes through ffmpeg when present; the native C++
    # library accelerates the per-clip PREPROCESS hot loop
    # (movenet_tpu_torch/native/io_loader.cpp), not the codec itself
    if _have_ffmpeg():
        return _decode_ffmpeg_cli(fp, scale_hw=scale_hw)
    raise RuntimeError(
        f"cannot decode {fp}: no ffmpeg/ffprobe on PATH. Repack clips as "
        ".npz (see movenet_tpu_torch.data.synthetic) or install ffmpeg.")
