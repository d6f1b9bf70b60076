"""The epoch loop: config -> data -> train/eval steps -> checkpoints ->
metrics -> sample export.

The counterpart of ``movenet_tpu.train.trainer`` on one device.  Per
epoch: the train loop (optional step cap), validation, periodic
generation and sample export, and a periodic checkpoint (and a final
one).  ``--auto_resume`` continues from the run's latest checkpoint; a
SIGTERM or SIGINT checkpoints and stops at the next step boundary.

The LR schedule (and the momentum cycling it brings) follows the update
count, and every train step logs its ``learning_rate``.  ``scan_steps`` >
1 runs that many optimizer steps per call (``make_scan_train_step``) and
logs each step's metrics at its own step.

Parallelism, as the JAX trainer's: ``data_parallel_plan`` resolves the
(data, seq) mesh over the cards of every process (``--mesh_data -1``
fits the data axis to the largest divisor of ``batch_size`` that the
cards ``--mesh_seq`` leaves allow), and ``train.cli`` starts one process
per rank.  A process (host, ``--process_id`` of ``--num_processes``)
loads ``batch_size`` rows of its share of the clip index a step, as the
JAX trainer's processes do, and its data indices split them
(``DataLoader(rows=...)``): the seq ranks of one data index load the
same rows and each cuts its window of the time axis
(``parallel.sharding.window_batch``; the fused route is off there, as
in the JAX trainer).  Every rank takes the update of the whole batch.
Rank 0 alone writes ``config.json``, the metrics, checkpoints and
samples; the ranks meet at a barrier after each checkpoint and at each
epoch's end, and agree at each step whether to stop (a preemption or an
exhausted loader on any rank stops all).
"""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from movenet_tpu_torch.config import TrainingConfig
from movenet_tpu_torch.data.pipeline import DataLoader, get_dataloader
from movenet_tpu_torch.models.sampler import fast_generate
from movenet_tpu_torch.models.wavenet import WaveNet, make_wavenet
from movenet_tpu_torch.ops import jax_random
from movenet_tpu_torch.parallel.mesh import (
    TIMEOUT,
    Mesh,
    create_mesh,
    process_count,
    process_index,
    sync_global_devices,
)
from movenet_tpu_torch.parallel.sharding import replicate, window_batch
from movenet_tpu_torch.train.checkpoint import CheckpointManager, latest_step
from movenet_tpu_torch.train.loop import (
    Batch,
    create_train_state,
    make_eval_step,
    make_scan_train_step,
    make_train_step,
    training_device,
)
from movenet_tpu_torch.train.optim import Schedules
from movenet_tpu_torch.utils.observability import make_writer
from movenet_tpu_torch.utils.samples import export_samples

logger = logging.getLogger(__name__)


class PreemptionGuard:
    """SIGTERM/SIGINT set a flag; the epoch loop checkpoints and exits at
    the next step boundary, and ``--auto_resume`` continues the run."""

    def __init__(self, install: bool = True):
        import signal

        self.requested = False
        self._prev = {}
        if not install:
            return
        import threading
        if threading.current_thread() is not threading.main_thread():
            return  # signals only installable from the main thread
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):  # pragma: no cover
                pass

    def _handler(self, signum, frame):
        logger.warning("received signal %s: will checkpoint and exit "
                       "at the next step boundary", signum)
        self.requested = True

    def restore(self):
        import signal

        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):  # pragma: no cover
                pass


def _device_prefetch(batches, device, depth: int = 2):
    """Move host batches to ``device`` on a thread, ``depth`` batches ahead
    of the train step."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        # never block forever: the consumer may stop early (step caps,
        # preemption) and the producer must not leak a blocked thread
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not _put(b.to(device)):
                    return
        except Exception as e:  # surface on the consumer side
            _put(e)
        finally:
            _put(None)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        # the worker ends after at most one more batch; then the source
        # is closed here, so the loader's threads end with the epoch and
        # none is left copying to the device when the interpreter exits
        if not sys.is_finalizing():
            thread.join()
            close = getattr(batches, "close", None)
            if close is not None:
                close()


def _stack_batches(bs) -> Batch:
    def stack(name):
        vals = [getattr(b, name) for b in bs]
        return None if vals[0] is None else torch.stack(vals)

    return Batch(codes=stack("codes"), video=stack("video"),
                 labels=stack("labels"), codes_pack=stack("codes_pack"),
                 window=bs[0].window)


def _chunk_batches(batches, n: int, max_steps: Optional[int] = None):
    """Group host batches into stacked (n, ...) chunks for a multi-step
    call; the tail that does not fill a chunk (epoch end, step cap) is
    yielded as plain per-step batches."""
    buf = []
    produced = 0
    for b in batches:
        if max_steps is not None and produced >= max_steps:
            break
        buf.append(b)
        produced += 1
        if len(buf) == n:
            yield _stack_batches(buf)
            buf = []
    for b in buf:
        yield b


def _mean_metrics(metrics_list) -> Dict[str, float]:
    if not metrics_list:
        return {}
    keys = metrics_list[0].keys()
    return {k: float(np.mean([float(m[k]) for m in metrics_list]))
            for k in keys}


def _resolve_run_dir(exp_name: str, out_dir: Path) -> Path:
    """``--pretrained_run_exp_name`` -> a local run directory holding
    checkpoints: the name as a path, or a sibling run under out_dir's
    parent.  Fails loudly."""
    candidates = [Path(exp_name), out_dir.parent / exp_name]
    tried = []
    for cand in candidates:
        tried.append(str(cand))
        if cand.is_dir() and latest_step(cand) is not None:
            return cand
    raise FileNotFoundError(
        f"pretrained_run_exp_name={exp_name!r}: no run directory with "
        f"checkpoints found (tried: {', '.join(tried)})")


def _host(config: TrainingConfig) -> Tuple[int, int]:
    """(this process's index, the process count): the coordinator flags,
    or one process without a coordinator."""
    if config.coordinator_address:
        return config.process_id or 0, config.num_processes or 1
    return 0, 1


def data_parallel_plan(config: TrainingConfig, device) -> Tuple[Mesh, int]:
    """(mesh, ranks per process) of a run on ``device``'s kind of card.

    The devices are the visible cards (the CPU counts as one) of each of
    ``--num_processes`` processes when a coordinator is named, else of
    this one; the mesh over them is resolved as the JAX trainer's
    ``create_mesh(config.mesh, batch_size=config.batch_size)``.  Each
    process runs ``data * seq / num_processes`` ranks, and its ``data /
    num_processes`` data indices must split its ``batch_size`` and
    ``val_batch_size`` rows evenly."""
    mesh_config = config.mesh
    procs = _host(config)[1]
    device = torch.device(device)
    if device.type == "cuda":
        local = torch.cuda.device_count()
        logger.info("--mesh_data %d: %d CUDA device(s) visible to each of "
                    "%d process(es)", mesh_config.data, local, procs)
    else:
        local = 1
        logger.info("--mesh_data %d: the CPU, one device a process, %d "
                    "process(es)", mesh_config.data, procs)
    mesh = create_mesh(mesh_config, local * procs,
                       batch_size=config.batch_size)
    if mesh.data % procs:
        raise ValueError(
            f"data-axis size {mesh.data} must be a multiple of the process "
            f"count {procs}")
    indices = mesh.data // procs
    for name in ("batch_size", "val_batch_size"):
        if getattr(config, name) % indices:
            raise ValueError(
                f"{name} {getattr(config, name)} is not divisible by the "
                f"{indices} data-parallel rank(s) of a process (the JAX "
                "trainer fails there in its sharded step)")
    ranks = mesh.size // procs
    logger.info("mesh: data=%d seq=%d over %d device(s), %d rank(s) a "
                "process", mesh.data, mesh.seq, local * procs, ranks)
    if mesh.seq > 1 and config.fused_blocks:
        logger.info("--mesh_seq %d: the fused route is off (as in the JAX "
                    "trainer); the ranks train the unfused route on their "
                    "windows of the time axis", mesh.seq)
    return mesh, ranks


def _mapped(items, fn):
    """``fn`` of each of ``items``; closes ``items`` when it is closed
    (a loader's epoch then stops its threads)."""
    try:
        for item in items:
            yield fn(item)
    finally:
        close = getattr(items, "close", None)
        if close is not None:
            close()


def _with_end(items):
    """``items``, then None."""
    yield from items
    yield None


def _agree(control, preempted: bool, kind: int):
    """(stop, preempted) as every rank sees it.  ``kind`` is what this
    rank holds for the next call: 0 nothing (its loader is exhausted or
    the epoch's steps are done), 1 a batch, 2 a chunk of scan steps.  The
    ranks stop when any was preempted, any holds nothing or they hold
    different kinds: each call all-reduces the same buffers, so one rank
    taking a step alone would wait forever.  ``control`` None: this
    process alone."""
    if control is None:
        return preempted or kind == 0, preempted
    flags = torch.tensor([int(preempted), -kind, kind])
    dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=control)
    lo, hi = -int(flags[1]), int(flags[2])
    preempted = bool(flags[0])
    return preempted or lo == 0 or lo != hi, preempted


def train_model(
    dataset_fp: str,
    config: TrainingConfig,
    train_loader: Optional[DataLoader] = None,
    val_loader: Optional[DataLoader] = None,
    device="cuda",
):
    """Train a WaveNet per the config on ``device`` (the card unless the
    caller asks for the CPU; no card raises); returns the final
    TrainState.  ``train_loader``/``val_loader`` may be injected; by
    default they come from the dataset tree at ``dataset_fp``."""
    device = training_device(device)
    if device.type == "cuda" and device.index is None:
        # explicit, for the prefetch thread: a new thread's current card
        # is cuda:0, whatever this rank's is
        device = torch.device("cuda", torch.cuda.current_device())
    mesh, ranks = data_parallel_plan(config, device)
    group = control = None
    if dist.is_available() and dist.is_initialized():
        if process_count() != mesh.size:
            raise RuntimeError(
                f"the process group has {process_count()} ranks and the "
                f"mesh {mesh.data}x{mesh.seq}")
        group = dist.group.WORLD
        # host-side flags and barriers over gloo: they wait on no stream
        control = group if dist.get_backend() == "gloo" else \
            dist.new_group(backend="gloo", timeout=TIMEOUT)
    elif mesh.size > 1:
        raise RuntimeError(
            f"mesh data={mesh.data} seq={mesh.seq} trains one process per "
            "rank: start the run with movenet_tpu_torch.train.cli, or join "
            "each rank to a process group first "
            "(parallel.initialize_distributed)")
    rank = process_index()
    # this process's data indices split its rows; its seq ranks of one
    # data index load the same rows
    index, seq_index = mesh.coords(rank)
    host, hosts = _host(config)
    indices = mesh.data // hosts
    mc = config.model_config
    loader_kwargs = dict(
        input_channels=mc.input_channels,
        batch_size=config.batch_size,
        use_video=config.use_video,
        accumulation_steps=config.accumulation_steps,
        max_audio_frames=mc.max_audio_frames,
        max_video_frames=mc.max_video_frames,
        process_index=host,
        process_count=hosts,
    )

    def rows(batch_size):
        b, i = batch_size // indices, index % indices
        return None if indices == 1 else (i * b, (i + 1) * b)

    if train_loader is None:
        train_loader = get_dataloader(
            dataset_fp, train=True, num_workers=config.num_workers,
            batch_subsample_frac=config.batch_subsample_frac,
            rows=rows(config.batch_size), **loader_kwargs)
    if val_loader is None:
        vkw = dict(loader_kwargs)
        vkw.update(batch_size=config.val_batch_size,
                   accumulation_steps=1)
        val_loader = get_dataloader(
            dataset_fp, train=False, num_workers=config.val_num_workers,
            batch_subsample_frac=config.val_batch_subsample_frac,
            shuffle=False, rows=rows(config.val_batch_size), **vkw)

    steps_per_epoch = train_loader.steps_per_epoch()
    if config.n_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, config.n_steps_per_epoch)
    if control is not None:
        # the processes' shares of the index may differ in length
        n = torch.tensor([steps_per_epoch])
        dist.all_reduce(n, op=dist.ReduceOp.MIN, group=control)
        steps_per_epoch = int(n)

    # a run without video never feeds context: drop the per-block context
    # convs so they carry no dead optimizer state or decay
    mc.use_context = mc.use_context and config.use_video
    if mc.global_classes == -1:
        # auto: one class per dataset category
        mc.global_classes = max(1, len(train_loader.context_to_id))
        logger.info("global conditioning over %d classes",
                    mc.global_classes)
    model = make_wavenet(
        mc, generator=torch.Generator().manual_seed(config.seed))
    logger.info("model receptive field: %d", model.receptive_fields)
    state = create_train_state(
        model, config, device=device, steps_per_epoch=steps_per_epoch,
        lr_schedule=Schedules(config, steps_per_epoch))

    out_dir = Path(config.model_output_path)
    ckpt = CheckpointManager(out_dir)
    start_epoch = 0
    pretrained_path = config.pretrained_model_path
    if pretrained_path is None and config.pretrained_run_exp_name:
        pretrained_path = _resolve_run_dir(
            config.pretrained_run_exp_name, out_dir)
        logger.info("resolved pretrained run %r -> %s",
                    config.pretrained_run_exp_name, pretrained_path)
    if pretrained_path:
        state = CheckpointManager(Path(pretrained_path)).restore(state)
        logger.info("restored pretrained state (step %d) from %s",
                    state.step, pretrained_path)
    elif config.auto_resume and ckpt.latest_step() is not None:
        start_epoch = int(ckpt.latest_step()) + 1
        state = ckpt.restore(state)
        logger.info("auto-resumed at epoch %d (step %d)", start_epoch,
                    state.step)
    if group is not None:
        replicate(state.module, group)

    if rank == 0:
        config.save(out_dir / "config.json")
    writer = make_writer(config)

    train_step = make_train_step(model, config, group, mesh=mesh)
    scan_n = max(1, int(config.scan_steps))
    scan_step = make_scan_train_step(model, config, scan_n, group,
                                     mesh=mesh) if scan_n > 1 else None
    # a chunk carries one leading axis over the plain (accumulation-aware)
    # batch rank
    base_ndim = 2 + (config.accumulation_steps > 1)
    eval_step = make_eval_step(model, config, group, mesh=mesh)

    def batches(loader, epoch):
        """The loader's batches of ``epoch``, each cut to this rank's
        window of the time axis on a seq mesh."""
        source = loader.epoch(epoch)
        if mesh.seq == 1:
            return source
        return _mapped(source, lambda b: window_batch(b, model, mesh.seq,
                                                      seq_index))

    guard = PreemptionGuard()
    log_every = max(1, config.log_every_n_steps)

    for epoch in range(start_epoch, config.n_epochs):
        t_epoch = time.perf_counter()
        # the metric sums stay on the device between log points: float()
        # synchronises with the card
        metric_sums = None
        n_steps = 0
        t_window = time.perf_counter()
        window_start = 0
        last_log = 0
        source = batches(train_loader, epoch)
        if scan_step is not None:
            source = _chunk_batches(source, scan_n, steps_per_epoch)
        for batch in _with_end(_device_prefetch(source, device)):
            chunk = batch is not None and scan_step is not None \
                and batch.codes.dim() == base_ndim + 1
            kind = 0 if batch is None or n_steps >= steps_per_epoch \
                else 1 + chunk
            stop, preempted = _agree(control, kind != 0 and guard.requested,
                                     kind)
            if preempted:
                guard.requested = True
            if stop:
                break
            if chunk:
                # a full chunk: scan_n steps in one call, metrics (scan_n,)
                state, metrics = scan_step(state, batch)
                n_steps += scan_n
                call_sums = {k: v.sum(0) for k, v in metrics.items()}
            else:
                state, metrics = train_step(state, batch)
                n_steps += 1
                call_sums = metrics
            # per-step sums: the epoch mean divides by n_steps
            metric_sums = call_sums if metric_sums is None else {
                k: metric_sums[k] + v for k, v in call_sums.items()}
            if n_steps - last_log >= log_every or \
                    n_steps >= steps_per_epoch:
                last_log = n_steps
                # every step of a chunk is logged at its own step
                host = {k: torch.as_tensor(v).reshape(-1).tolist()
                        for k, v in metrics.items()}
                n_in_call = len(next(iter(host.values())))
                now = time.perf_counter()
                sps = ((n_steps - window_start) / max(now - t_window, 1e-9))
                t_window, window_start = now, n_steps
                for i in range(n_in_call):
                    vals = {k: float(v[i]) for k, v in host.items()}
                    if i == n_in_call - 1:
                        vals["steps_per_sec"] = sps
                    writer.scalars("train", vals,
                                   state.step - n_in_call + 1 + i)
        train_mean = {} if metric_sums is None else {
            k: float(v) / n_steps for k, v in metric_sums.items()}

        if _agree(control, guard.requested, 1)[1]:
            logger.warning("preempted: checkpointing at epoch %d", epoch)
            if rank == 0:
                ckpt.save(epoch, state)
            sync_global_devices(f"preempted_{epoch}", control)
            break

        val_metrics = []
        for batch in _with_end(batches(val_loader, epoch)):
            if _agree(control, False, int(batch is not None))[0]:
                break
            m = eval_step(state, batch)
            val_metrics.append({k: float(v) for k, v in m.items()})
        if val_metrics:
            writer.scalars("val", _mean_metrics(val_metrics), state.step)

        epoch_summary = {
            "epoch": epoch,
            "epoch_seconds": time.perf_counter() - t_epoch,
            **{f"train_{k}": v for k, v in train_mean.items()},
            **{f"val_{k}": v
               for k, v in _mean_metrics(val_metrics).items()},
        }
        writer.scalars("epoch", epoch_summary, epoch)
        logger.info("epoch %d: %s", epoch, {
            k: round(v, 5) for k, v in epoch_summary.items()})

        if config.log_samples_every and \
                (epoch + 1) % config.log_samples_every == 0:
            _log_samples(model, config, val_loader, out_dir, epoch, writer)

        is_last = epoch == config.n_epochs - 1
        if rank == 0 and (is_last
                          or (epoch + 1) % config.checkpoint_every == 0):
            ckpt.save(epoch, state)
        # torch saves are not collective (orbax's are): the other ranks
        # wait here for rank 0's checkpoint and samples
        sync_global_devices(f"epoch_{epoch}", control)

    guard.restore()
    writer.close()
    if control is not None:
        _check_replicas(state.module, control)
    return state


def params_digest(module: torch.nn.Module) -> str:
    """sha256 of every parameter and buffer's bytes, in state-dict order."""
    import hashlib

    h = hashlib.sha256()
    for name, t in module.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def _check_replicas(module: torch.nn.Module, control) -> None:
    """Every rank must end with the same weights: they took the same
    averaged updates.  Raises on rank 0 when they differ."""
    digests = [None] * dist.get_world_size(control)
    dist.all_gather_object(digests, params_digest(module), group=control)
    if process_index() == 0:
        if len(set(digests)) != 1:
            raise RuntimeError(
                f"the ranks' params differ after training: {digests}")
        logger.info("the %d ranks' params are equal (sha256 %s)",
                    len(digests), digests[0])


def _log_samples(model: WaveNet, config, val_loader, out_dir, epoch,
                 writer=None) -> None:
    """Teacher-forced predictions and free-running generation (the cached
    sampler) on one validation batch, exported as WAVs."""
    if process_index() != 0:
        return
    # meta_batches carries each row's file path (the tensor loader
    # substitutes failed decodes, which would shift a positional mapping)
    group = next(val_loader.meta_batches(), None)
    if group is None:
        return
    dev = model.front_cur.device
    codes = torch.from_numpy(np.stack([ex.codes for ex in group])).to(dev)
    video = None
    if val_loader.use_video and group[0].video is not None:
        video = torch.from_numpy(np.stack([ex.video for ex in group])).to(dev)
    labels = None
    if model.global_classes:
        labels = torch.tensor([ex.label for ex in group], device=dev)
    sources = [ex.filepath for ex in group]
    rf = model.receptive_fields

    with torch.no_grad():
        logits = model.train_logits(codes, video, labels)
    predicted = logits.argmax(-1).cpu().numpy()

    n = config.generate_n_samples or codes.shape[-1]
    generated = None
    if n > rf:
        t0 = time.perf_counter()
        generated = fast_generate(
            model, codes[:, :rf], int(n),
            temperature=config.generate_temperature,
            rng=jax_random.PRNGKey(epoch), video=video,
            labels=labels).cpu().numpy()
        logger.info("sample generation took %.2f seconds",
                    time.perf_counter() - t0)

    kinds = {"original": codes.cpu().numpy(), "predicted": predicted}
    if generated is not None:
        kinds["generated"] = generated
    model_rate = int(16_000 * config.model_config.max_audio_frames
                     / 160_000)
    written = export_samples(Path(out_dir) / "samples", epoch, "val", kinds,
                             config.model_config.input_channels,
                             model_rate=max(model_rate, 1),
                             source_paths=sources)
    if writer is not None:
        from movenet_tpu_torch.utils.samples import log_samples_table

        log_samples_table(writer, "val", epoch, written, filepaths=sources,
                          videos=sources if config.log_video else None)


__all__ = ["PreemptionGuard", "data_parallel_plan", "params_digest",
           "train_model"]
