"""Synthetic Kinetics-style datasets.

The counterpart of ``movenet_tpu.data.synthetic``: the same arrays from
the same seed.

Real Kinetics clips need a video codec; this module fabricates
dance-like clips in the portable ``.npz`` format so the entire pipeline
(index -> decode -> preprocess -> train -> generate -> export) runs
anywhere, including CI and this image.  It is also the honest test
regime the reference itself used (its only test is a synthetic sine
wave, tests/test_model.py:20-38).

Each category gets a distinct audio signature (chord of sines keyed by
the category index) and video whose moving blob is driven by the audio
envelope — a genuine audio<->video correlation for the conditioning
path to learn.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np


def synth_clip(rng: np.random.Generator, category_id: int,
               audio_fps: int = 16_000, video_fps: int = 16,
               duration_s: float = 10.0, frame_hw=(96, 96)):
    """One synthetic clip: (video (F,H,W,3) uint8, audio (S,) float32)."""
    s = int(audio_fps * duration_s)
    t = np.arange(s, dtype=np.float32) / audio_fps
    base = 110.0 * (2.0 ** (category_id % 6))
    phase = float(rng.uniform(0, 2 * np.pi))
    audio = (
        0.6 * np.sin(2 * np.pi * base * t + phase)
        + 0.3 * np.sin(2 * np.pi * base * 1.5 * t)
        + 0.1 * np.sin(2 * np.pi * base * 2.0 * t)
    )
    # beat envelope drives the "dancer"
    beat_hz = 1.0 + 0.25 * (category_id % 4)
    env = 0.5 * (1 + np.sin(2 * np.pi * beat_hz * t))
    audio = (audio * env).astype(np.float32)

    f = int(video_fps * duration_s)
    h, w = frame_hw
    frames = np.zeros((f, h, w, 3), np.uint8)
    env_f = env[np.linspace(0, s - 1, f).astype(int)]
    cx = (w / 2 + (w / 3) * np.sin(2 * np.pi * beat_hz *
                                   np.arange(f) / video_fps)).astype(int)
    cy = (h / 2 - (h / 4) * env_f).astype(int)
    r = max(2, h // 12)
    color = np.array([80 + 25 * (category_id % 7), 200, 120], np.uint8)
    for i in range(f):
        y0, y1 = max(0, cy[i] - r), min(h, cy[i] + r)
        x0, x1 = max(0, cx[i] - r), min(w, cx[i] + r)
        frames[i, y0:y1, x0:x1] = color
    return frames, audio


def make_synthetic_dataset(
    root,
    categories: Optional[List[str]] = None,
    clips_per_category: int = 4,
    splits=("train", "valid"),
    audio_fps: int = 16_000,
    video_fps: int = 16,
    duration_s: float = 10.0,
    frame_hw=(96, 96),
    seed: int = 0,
    with_video: bool = True,
) -> Path:
    """Write a dataset tree ``<root>/{split}/<category>/clip_XX.npz``."""
    root = Path(root)
    categories = categories or ["breakdancing", "salsa_dancing",
                                "krumping"]
    rng = np.random.default_rng(seed)
    for split in splits:
        n = clips_per_category if split == "train" else \
            max(1, clips_per_category // 2)
        for ci, cat in enumerate(categories):
            d = root / split / cat
            d.mkdir(parents=True, exist_ok=True)
            for k in range(n):
                video, audio = synth_clip(
                    rng, ci, audio_fps=audio_fps, video_fps=video_fps,
                    duration_s=duration_s, frame_hw=frame_hw)
                payload = {
                    "audio": audio,
                    "audio_fps": np.float32(audio_fps),
                    "video_fps": np.float32(video_fps),
                }
                if with_video:
                    payload["video"] = video
                np.savez_compressed(d / f"clip_{k:03d}.npz", **payload)
    return root
