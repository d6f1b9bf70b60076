"""Prefetching data loader.

The counterpart of ``movenet_tpu.data.pipeline``: the same batches, as
the port's ``train.loop.Batch`` of CPU tensors (the caller moves them to
its device).  It replaces the reference's torch DataLoader +
DistributedSampler (dataset.py:59-98) with a thread-pool decode
pipeline and static per-process index sharding (each process loads only
its own shard).

Fixed batch shapes: a failed decode is substituted with the next
readable clip instead of shrinking the batch (the reference drops the
example and produces ragged batch sizes, dataset.py:215-227).

Temporal cropping (``subsample_frac``, reference dataset.py:232-242):
``synchronized=True`` (default) crops audio and video over the SAME
window so the conditioning still matches the waveform;
``synchronized=False`` reproduces the reference's two independent
random starts.

Data parallelism (``rows=(start, stop)``): a rank decodes only its
columns ``[start, stop)`` of each batch (of each microbatch under
accumulation), taking the clips those columns would hold in the
one-process order; the crop draws are made once a batch as there, so
without failed decodes the ranks' batches, put side by side, are the
one-process batches bit for bit.  A failed decode is substituted by the
next clip of the rank's own share.  The seq ranks of one data index
pass the same ``rows``: they walk the same clips and make the same
draws, so they hold the same batches (each then cuts its window of the
time axis).
"""

from __future__ import annotations

import logging
import math
import queue
import random
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

import torch

from movenet_tpu_torch.data.dataset import (
    ClipIndex,
    Example,
    decode_clip,
    kinetics_index,
)
from movenet_tpu_torch.data.preprocess import (
    MAX_AUDIO_FRAMES,
    MAX_VIDEO_FRAMES,
    preprocess_audio,
    preprocess_video,
)
from movenet_tpu_torch.train.loop import Batch

logger = logging.getLogger(__name__)


class DataLoader:
    """Iterable over fixed-shape Batches of mu-law codes (+ video).

    ``native_pipeline``: "auto" runs the C++ decode->preprocess pipeline
    when it is usable (library built, ffmpeg present, media files, not
    .npz), "on" requires it, "off" never uses it."""

    def __init__(
        self,
        index: ClipIndex,
        input_channels: int,
        batch_size: int,
        use_video: bool = True,
        normalize_audio: bool = True,
        subsample_frac: Optional[float] = None,
        synchronized_crop: bool = True,
        accumulation_steps: int = 1,
        num_workers: int = 4,
        shuffle: bool = True,
        seed: int = 0,
        max_audio_frames: int = MAX_AUDIO_FRAMES,
        max_video_frames: int = MAX_VIDEO_FRAMES,
        prefetch_batches: int = 2,
        context_to_id=None,
        native_pipeline: str = "auto",
        host_pack: bool = False,
        rows: Optional[Tuple[int, int]] = None,
    ):
        if len(index) == 0:
            raise ValueError(f"empty dataset index under {index.root}")
        self.index = index
        self.input_channels = input_channels
        self.batch_size = batch_size
        self.use_video = use_video
        self.normalize_audio = normalize_audio
        self.subsample_frac = subsample_frac
        self.synchronized_crop = synchronized_crop
        self.accumulation_steps = max(1, accumulation_steps)
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.seed = seed
        self.max_audio_frames = max_audio_frames
        self.max_video_frames = max_video_frames
        self.prefetch_batches = prefetch_batches
        self.host_pack = host_pack
        if rows is not None and not 0 <= rows[0] < rows[1] <= batch_size:
            raise ValueError(f"rows {rows} outside a batch of {batch_size}")
        self.rows = rows
        # class-id mapping should come from the FULL (unsharded) index so
        # ids are consistent across processes; get_dataloader passes it
        self.context_to_id = (context_to_id if context_to_id is not None
                              else index.context_to_id)
        self._warned_contexts: set = set()
        if native_pipeline not in ("auto", "on", "off"):
            raise ValueError(
                f"native_pipeline must be auto|on|off, "
                f"got {native_pipeline!r}")
        self.native_pipeline = native_pipeline

    def _native_pipe_usable(self) -> bool:
        """The C++ decode->preprocess pipeline handles media containers
        (ffmpeg), not packed .npz clips; use it only when built AND
        every entry is a media file."""
        if self.native_pipeline == "off":
            return False
        from movenet_tpu_torch.data.video import _have_ffmpeg
        from movenet_tpu_torch.native.loader import available

        ok = available() and _have_ffmpeg() and all(
            Path(m.filepath).suffix.lower() != ".npz"
            for m in self.index.entries)
        if self.native_pipeline == "on" and not ok:
            raise RuntimeError(
                "native_pipeline='on' but the native pipeline is not "
                "usable (library not built, no ffmpeg, or .npz inputs)")
        return ok

    # ------------------------------------------------------------- sizes
    @property
    def examples_per_step(self) -> int:
        return self.batch_size * self.accumulation_steps

    def __len__(self) -> int:
        """Optimizer updates per epoch."""
        return len(self.index) // self.examples_per_step

    def steps_per_epoch(self) -> int:
        return max(1, len(self))

    @property
    def _width(self) -> int:
        """Columns of each batch this loader yields."""
        return self.batch_size if self.rows is None \
            else self.rows[1] - self.rows[0]

    def _own_entries(self, entries) -> list:
        """The clips of this loader's columns, in the one-process order."""
        if self.rows is None:
            return list(entries)
        start, stop = self.rows
        per = self.examples_per_step
        return [m for k, m in enumerate(entries)
                if start <= k % per % self.batch_size < stop]

    # ------------------------------------------------------------ decode
    def _load_example(self, meta) -> Optional[Example]:
        try:
            clip = decode_clip(meta.filepath)
        except Exception as e:  # decode failures are data, not crashes
            logger.warning("decode failed for %s: %s", meta.filepath, e)
            return None
        if clip.audio is None or clip.info.get("audio_orig_dim", 0) == 0:
            return None
        if self.use_video and (clip.video is None
                               or clip.video.shape[0] == 0):
            return None
        codes = preprocess_audio(
            clip.audio, self.input_channels,
            normalize=self.normalize_audio,
            target_frames=self.max_audio_frames)
        video = None
        if self.use_video:
            video = preprocess_video(
                clip.video, num_frames=self.max_video_frames)
        label = self.context_to_id.get(meta.context)
        if label is None:
            if meta.context not in self._warned_contexts:
                self._warned_contexts.add(meta.context)
                logger.warning(
                    "context %r missing from the class-id mapping "
                    "(train/val category sets differ?); conditioning on "
                    "class 0", meta.context)
            label = 0
        return Example(meta.context, meta.filepath, codes, video,
                       clip.info, label=label)

    # -------------------------------------------------------------- crop
    def _crop(self, codes: np.ndarray, video: Optional[np.ndarray],
              rng: random.Random):
        frac = self.subsample_frac
        if frac is None:
            return codes, video
        t = codes.shape[-1]
        if video is not None and self.synchronized_crop:
            f = video.shape[1]
            ratio = t // f
            nf = math.ceil(f * frac)
            na = nf * ratio
            v0 = rng.randint(0, f - nf)
            return (codes[..., v0 * ratio: v0 * ratio + na],
                    video[:, v0: v0 + nf])
        # reference behavior: independent random windows
        na = math.ceil(t * frac)
        a0 = rng.randint(0, t - na)
        codes = codes[..., a0: a0 + na]
        if video is not None:
            f = video.shape[1]
            nf = math.ceil(f * frac)
            v0 = rng.randint(0, f - nf)
            video = video[:, v0: v0 + nf]
        return codes, video

    # ------------------------------------------------------------ epochs
    def epoch(self, epoch_index: int = 0) -> Iterator[Batch]:
        """Yield batches for one epoch.

        With accumulation_steps > 1 batches carry a leading (A,) axis
        ready for the scanning train step.
        """
        idx = self.index
        if self.shuffle:
            idx = idx.shuffled(self.seed + epoch_index)
        rng = random.Random(self.seed * 1_000_003 + epoch_index)
        per_step = self._width * self.accumulation_steps

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded-wait put so an early-stopping consumer never
            # leaves this thread blocked forever
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def native_producer():
            """decode->preprocess->assemble via the C++ worker pool
            (native/pipeline.cpp): one blocking ctypes call per clip,
            bounded in-flight work, outputs bit-identical to the
            Python path."""
            from movenet_tpu_torch.native.loader import NativePipeline

            pipe = NativePipeline(
                self.num_workers, self.max_video_frames, (64, 64),
                self.max_audio_frames, self.input_channels,
                self.normalize_audio, self.use_video)
            try:
                entries = self._own_entries(idx.entries)
                in_flight = 0
                pos = 0
                group: List[Example] = []
                while pos < len(entries) or in_flight > 0:
                    while in_flight < self.num_workers * 2 and \
                            pos < len(entries):
                        pipe.submit(entries[pos].filepath)
                        pos += 1
                        in_flight += 1
                    if stop.is_set():
                        return
                    meta_i = pos - in_flight
                    out = pipe.next()
                    in_flight -= 1
                    if out is None:
                        continue  # substitute: next clip fills the slot
                    codes, video = out
                    meta = entries[meta_i]
                    label = self.context_to_id.get(meta.context)
                    if label is None:
                        if meta.context not in self._warned_contexts:
                            self._warned_contexts.add(meta.context)
                            logger.warning(
                                "context %r missing from the class-id "
                                "mapping; conditioning on class 0",
                                meta.context)
                        label = 0
                    group.append(Example(meta.context, meta.filepath,
                                         codes, video, {}, label=label))
                    if len(group) == per_step:
                        if not put(self._assemble(group, rng)):
                            return
                        group = []
            except Exception as e:  # surface errors on the consumer side
                put(e)
            finally:
                pipe.close()
                put(None)

        def producer():
            try:
                # bounded in-flight decode: the output queue only
                # throttles assembled batches, so an unbounded pool.map
                # would let workers decode the whole epoch ahead of the
                # consumer (multi-GB of preprocessed clips in RAM)
                from collections import deque

                with ThreadPoolExecutor(self.num_workers) as pool:
                    entries = iter(self._own_entries(idx.entries))
                    in_flight: deque = deque()

                    def refill():
                        while len(in_flight) < self.num_workers * 2:
                            meta = next(entries, None)
                            if meta is None:
                                return
                            in_flight.append(
                                pool.submit(self._load_example, meta))

                    refill()
                    group: List[Example] = []
                    try:
                        while in_flight and not stop.is_set():
                            ex = in_flight.popleft().result()
                            refill()
                            if ex is None:
                                continue  # substitute: next clip fills
                            group.append(ex)
                            if len(group) == per_step:
                                if not put(self._assemble(group, rng)):
                                    return
                                group = []
                    finally:
                        # a stopped consumer waits only for the decodes
                        # already running, not for the queued ones
                        for f in in_flight:
                            f.cancel()
            except Exception as e:  # surface errors on the consumer side
                put(e)
            finally:
                put(None)

        target = native_producer if self._native_pipe_usable() \
            else producer
        thread = threading.Thread(target=target, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # the producer sees the stop within one decode: no decode
            # outlives the epoch (its files may be gone after it), and no
            # thread is left inside torch when the interpreter exits
            if not sys.is_finalizing():
                thread.join()

    def _assemble(self, group: List[Example], rng: random.Random) -> Batch:
        codes = np.stack([ex.codes for ex in group]).astype(np.int32)
        labels = np.asarray([ex.label for ex in group], np.int32)
        video = None
        if self.use_video:
            video = np.stack([ex.video for ex in group])
        codes, video = self._crop(codes, video, rng)
        a, b = self.accumulation_steps, self._width
        if a > 1:
            codes = codes.reshape(a, b, *codes.shape[1:])
            labels = labels.reshape(a, b)
            if video is not None:
                video = video.reshape(a, b, *video.shape[1:])
        pack = None
        if self.host_pack:
            # (T, 3B) int32 fused-kernel codes pack, computed on the
            # worker thread so the device skips the relayout
            from movenet_tpu_torch.models.fused import codes_pack_np

            if a > 1:
                pack = np.stack([codes_pack_np(codes[i])
                                 for i in range(a)])
            else:
                pack = codes_pack_np(codes)

        def cpu(x):
            return None if x is None else torch.from_numpy(
                np.ascontiguousarray(x))

        return Batch(codes=cpu(codes), video=cpu(video), labels=cpu(labels),
                     codes_pack=cpu(pack))

    def meta_batches(self) -> Iterator[List[Example]]:
        """Raw Example groups (for sample-export callbacks that need
        filepaths/contexts alongside tensors)."""
        group: List[Example] = []
        for meta in self.index.entries:
            ex = self._load_example(meta)
            if ex is None:
                continue
            group.append(ex)
            if len(group) == self.batch_size:
                yield group
                group = []


def get_dataloader(
    filepath,
    input_channels: int,
    batch_size: int = 64,
    train: bool = True,
    process_index: int = 0,
    process_count: int = 1,
    use_video: bool = True,
    normalize_audio: bool = True,
    batch_subsample_frac: Optional[float] = None,
    **kwargs,
) -> DataLoader:
    """Reference-shaped factory (dataset.py:59-98): scans the dataset
    tree, shards the index per process, returns a DataLoader (``rows``
    in ``kwargs``: a rank's columns of each batch)."""
    index = kinetics_index(filepath, train=train)
    context_to_id = index.context_to_id  # before sharding: global ids
    if process_count > 1:
        index = index.shard(process_index, process_count)
    return DataLoader(
        index=index,
        context_to_id=context_to_id,
        input_channels=input_channels,
        batch_size=batch_size,
        use_video=use_video,
        normalize_audio=normalize_audio,
        subsample_frac=batch_subsample_frac,
        **kwargs,
    )
