"""Generated-sample export: mu-law decode, resample back to the clip's
original rate, write WAV files.

The counterpart of ``movenet_tpu.utils.samples`` (``write_wav``,
``encode_mp3``, ``export_samples``, ``log_samples_table``): decode with
``ops/mulaw``, resample with ``ops/resample``, write 16-bit PCM with the
stdlib ``wave`` module, encode mp3 with the ffmpeg CLI where there is one,
and log a W&B table of the files when the writer stack has a wandb run.
"""

from __future__ import annotations

import logging
import wave
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from movenet_tpu_torch.ops.mulaw import mu_law_decode
from movenet_tpu_torch.ops.resample import resample

logger = logging.getLogger(__name__)


def write_wav(path: Path, audio: np.ndarray, sample_rate: int,
              stereo: bool = True) -> Path:
    """Write a [-1, 1] float waveform as 16-bit PCM WAV."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    audio = np.asarray(audio, np.float32).reshape(-1)
    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    if stereo:
        pcm = np.repeat(pcm[:, None], 2, axis=1).reshape(-1)
    with wave.open(str(path), "wb") as fh:
        fh.setnchannels(2 if stereo else 1)
        fh.setsampwidth(2)
        fh.setframerate(int(sample_rate))
        fh.writeframes(pcm.tobytes())
    return path


_warned_no_mp3 = False


def encode_mp3(wav_path: Path, mp3_path: Optional[Path] = None,
               bitrate: str = "192k") -> Optional[Path]:
    """Encode a WAV to MP3 with the ffmpeg CLI.  Returns the mp3 path, or
    None (with a one-time warning) when no ffmpeg is on PATH."""
    global _warned_no_mp3
    import shutil
    import subprocess

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        if not _warned_no_mp3:
            _warned_no_mp3 = True
            logger.warning("ffmpeg not on PATH: skipping mp3 export "
                           "(wav artifacts are still written)")
        return None
    wav_path = Path(wav_path)
    mp3_path = mp3_path or wav_path.with_suffix(".mp3")
    proc = subprocess.run(
        [ffmpeg, "-y", "-loglevel", "error", "-i", str(wav_path),
         "-b:a", bitrate, str(mp3_path)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        logger.warning("mp3 encode failed for %s: %s", wav_path,
                       proc.stderr.strip()[:200])
        return None
    return mp3_path


def export_samples(
    out_dir: Path,
    epoch: int,
    split: str,
    codes: Dict[str, np.ndarray],
    input_channels: int,
    model_rate: int = 16_000,
    target_rate: Optional[int] = None,
    source_paths: Optional[list] = None,
    mp3: bool = True,
) -> Dict[str, list]:
    """Decode and write one batch of sample kinds.

    Args:
      codes: mapping kind -> (B, T) int mu-law codes (numpy or torch);
        conventional kinds are "original", "predicted", "generated".
      model_rate: the model-space rate (MAX_AUDIO_FRAMES / 10 s = 16 kHz).
      target_rate: original clip rate to resample back to (None: keep
        model rate).
    Returns: kind -> list of written paths.
    """
    out = Path(out_dir) / f"epoch_{epoch:04d}" / split
    written: Dict[str, list] = {}
    for kind, batch in codes.items():
        batch = torch.as_tensor(batch).cpu()
        paths = []
        for i, row in enumerate(batch):
            audio = mu_law_decode(row, input_channels)
            rate = model_rate
            if target_rate and target_rate != model_rate:
                audio = resample(audio, model_rate, target_rate)
                rate = target_rate
            wav = write_wav(out / f"{kind}_{i:02d}.wav", audio.numpy(), rate)
            paths.append(wav)
            if mp3:
                m = encode_mp3(wav)
                if m is not None:
                    written.setdefault(f"{kind}_mp3", []).append(m)
        written[kind] = paths
    if source_paths:
        # copy the source clips next to the audio artifacts
        import shutil

        copied = []
        for i, src in enumerate(source_paths):
            src = Path(src)
            if src.exists():
                dst = out / f"source_{i:02d}{src.suffix}"
                dst.parent.mkdir(parents=True, exist_ok=True)
                shutil.copyfile(src, dst)
                copied.append(dst)
        written["source"] = copied
    logger.info("exported %s samples to %s",
                {k: len(v) for k, v in written.items()}, out)
    return written


_VIDEO_SUFFIXES = {".mp4", ".gif", ".webm", ".mov", ".avi"}


def log_samples_table(writer, split: str, epoch: int,
                      written: Dict[str, list],
                      filepaths: Optional[list] = None,
                      videos: Optional[list] = None) -> None:
    """Log a W&B table of sample files (original, predicted, generated
    audio; with ``videos``, the source clips whose suffix W&B plays) when
    the writer stack has a live wandb run; a no-op otherwise."""
    from movenet_tpu_torch.utils.observability import MultiWriter, WandbWriter

    writers = writer.writers if isinstance(writer, MultiWriter) else \
        [writer]
    for w in writers:
        if not isinstance(w, WandbWriter):
            continue
        wandb = w._wandb
        kinds = [k for k in ("original", "predicted", "generated")
                 if written.get(k)]
        columns = ["split", "epoch", "idx", "fp"]
        if videos:
            columns.append("video")
        columns += [f"{k}_audio" for k in kinds]
        n = max(len(written[k]) for k in kinds)
        data = []
        for i in range(n):
            row = [split, epoch, i,
                   str(filepaths[i]) if filepaths and i < len(filepaths)
                   else ""]
            if videos:
                v = videos[i] if i < len(videos) else None
                ok = v is not None and \
                    Path(v).suffix.lower() in _VIDEO_SUFFIXES and \
                    Path(v).exists()
                row.append(wandb.Video(str(v)) if ok else None)
            for k in kinds:
                row.append(wandb.Audio(str(written[k][i])))
            data.append(row)
        w._run.log({"sample_output": wandb.Table(columns=columns,
                                                 data=data)})
