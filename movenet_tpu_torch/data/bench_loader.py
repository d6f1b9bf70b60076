"""Dataloader throughput benchmark CLI (the counterpart of
``movenet_tpu.data.bench_loader``).

    python -m movenet_tpu_torch.data.bench_loader <dataset_dir> \
        [--num-workers N]

The reference's equivalent is ``python movenet/dataset.py <path>``
(dataset.py:313-364), its grid.ai dataloader smoke job: iterate every
batch, time the epoch, write the wall time to ``time.txt``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def main(argv=None):
    from movenet_tpu_torch.data.pipeline import get_dataloader

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("filepath", type=str)
    ap.add_argument("--num-workers", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--input-channels", type=int, default=16)
    ap.add_argument("--use-video", type=lambda x: bool(int(x)), default=False)
    ap.add_argument("--max-audio-frames", type=int, default=160_000)
    ap.add_argument("--max-video-frames", type=int, default=160)
    ap.add_argument("--out", type=Path, default=Path("time.txt"))
    args = ap.parse_args(argv)

    loader = get_dataloader(
        args.filepath,
        input_channels=args.input_channels,
        batch_size=args.batch_size,
        train=True,
        use_video=args.use_video,
        num_workers=args.num_workers,
        shuffle=True,
        max_audio_frames=args.max_audio_frames,
        max_video_frames=args.max_video_frames,
    )
    n_batches = len(loader)
    print(f"iterating through {n_batches} batches "
          f"({args.num_workers} workers)")
    start = time.time()
    n_examples = 0
    for i, batch in enumerate(loader.epoch(0), 1):
        n_examples += batch.codes.shape[0]
        print(f"[batch {i}/{n_batches}]")
    elapsed = time.time() - start
    stats = {
        "batches": n_batches,
        "examples": n_examples,
        "seconds": round(elapsed, 3),
        "examples_per_sec": round(n_examples / max(elapsed, 1e-9), 2),
    }
    print(json.dumps(stats))
    args.out.write_text(f"time taken: {elapsed}\n")
    return stats


if __name__ == "__main__":
    main()
