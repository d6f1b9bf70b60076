"""Kinetics-style dataset index and decode dispatch.

The counterpart of ``movenet_tpu.data.dataset``, numpy only.

Directory convention (reference: dataset.py:101-159):

    <root>/{train,valid}/<category>/<clip>.{mp4,npz}

The category directory name is the example's class context; files with
``_raw`` in the stem or a leading dot are skipped; class balance is
computed over the index.

Decoding is pluggable because video codecs are an environment property:

  * ``.npz`` packed clips (this repo's portable format: uint8 video
    (F, H, W, 3), float32 audio (S,) or (2, S), plus fps metadata) are
    decoded with numpy alone — used by tests, benchmarks, and the
    synthetic datasets;
  * ``.mp4`` is decoded through the native C++ loader or the ffmpeg CLI
    when present (movenet_tpu_torch.data.video), mirroring the reference's
    torchvision.io/PyAV path (dataset.py:168).
"""

from __future__ import annotations

import logging
import random
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class ClipMeta:
    context: str          # category directory name (class label)
    filepath: str


@dataclass
class RawClip:
    """A decoded clip before preprocessing."""

    video: Optional[np.ndarray]   # (F, H, W, 3) uint8, or None
    audio: Optional[np.ndarray]   # (S,) or (channels, S) float32
    info: Dict                    # video_fps, audio_fps, orig dims


@dataclass
class Example:
    """A preprocessed training example (reference Example,
    dataset.py:50-56)."""

    context: str
    filepath: str
    codes: Optional[np.ndarray]   # (T,) int32 mu-law codes
    video: Optional[np.ndarray]   # (F, 64, 64, 1) float32 (0..255 scale)
    info: Dict
    label: int = 0                # class id (index into contexts)


@dataclass
class ClipIndex:
    """Index over one split of a dataset tree."""

    root: Path
    split: str
    entries: List[ClipMeta] = field(default_factory=list)

    @property
    def contexts(self) -> List[str]:
        return sorted({e.context for e in self.entries})

    @property
    def context_to_id(self) -> Dict[str, int]:
        """Stable category -> class-id mapping (the dataset's class
        labels double as the global conditioning ids)."""
        return {c: i for i, c in enumerate(self.contexts)}

    @property
    def class_balance(self) -> Dict[str, float]:
        if not self.entries:
            return {}
        counts = Counter(e.context for e in self.entries)
        total = len(self.entries)
        return {k: v / total for k, v in counts.items()}

    def __len__(self) -> int:
        return len(self.entries)

    def shard(self, process_index: int, process_count: int) -> "ClipIndex":
        """Static per-process shard (the SPMD replacement for
        DistributedSampler, reference dataset.py:79-87): process p takes
        entries p, p+N, p+2N, ..."""
        return ClipIndex(
            root=self.root, split=self.split,
            entries=self.entries[process_index::process_count],
        )

    def shuffled(self, seed: int) -> "ClipIndex":
        entries = list(self.entries)
        random.Random(seed).shuffle(entries)
        return ClipIndex(root=self.root, split=self.split, entries=entries)


SUPPORTED_SUFFIXES = (".mp4", ".npz", ".mkv", ".webm", ".avi", ".mov")


def kinetics_index(root, train: bool = True) -> ClipIndex:
    """Scan ``<root>/{train,valid}/<category>/*`` into an index
    (reference: dataset.py:117-140, same skip rules)."""
    root = Path(root)
    split = "train" if train else "valid"
    split_dir = root / split
    entries: List[ClipMeta] = []
    contexts = sorted(x.name for x in split_dir.glob("*") if x.is_dir())
    for context in contexts:
        for fp in sorted((split_dir / context).glob("*")):
            if fp.suffix.lower() not in SUPPORTED_SUFFIXES:
                continue
            if "_raw" in fp.stem or fp.stem.startswith("."):
                logger.debug("skipping file %s", fp)
                continue
            entries.append(ClipMeta(context, str(fp)))
    idx = ClipIndex(root=root, split=split, entries=entries)
    logger.info(
        "dataset %s: %d clips, contexts=%s, class balance=%s",
        split, len(idx), idx.contexts, idx.class_balance)
    return idx


def decode_clip(filepath: str) -> RawClip:
    """Decode one clip file into raw frames + waveform."""
    fp = Path(filepath)
    if fp.suffix.lower() == ".npz":
        return _decode_npz(fp)
    from movenet_tpu_torch.data.video import decode_media_file
    return decode_media_file(fp)


def _decode_npz(fp: Path) -> RawClip:
    with np.load(fp) as z:
        video = z["video"] if "video" in z else None
        audio = z["audio"].astype(np.float32) if "audio" in z else None
        info = {
            "video_fps": float(z["video_fps"]) if "video_fps" in z else 0.0,
            "audio_fps": float(z["audio_fps"]) if "audio_fps" in z else 0.0,
        }
    info["video_orig_dim"] = 0 if video is None else int(video.shape[0])
    info["audio_orig_dim"] = 0 if audio is None else int(audio.shape[-1])
    return RawClip(video=video, audio=audio, info=info)
