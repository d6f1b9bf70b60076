"""Device time of one train step, by kernel, and the device's idle share.

    python -m movenet_tpu_torch.utils.profile_step [--steps 2] [--rows 20]
        [--widths breakdancing|flagship|exp00|exp01]

Runs ``make_train_step`` on the CUDA device: on the breakdancing config
(utils/fixtures; with ``--widths flagship`` at the flagship widths, layer
10 x stack 3, C=256, R=S=64, where the default strategy is the recompute
one), or with ``--widths exp00`` / ``exp01`` on experiment 00's / 01's
flags (``experiments/torch``: the unfused route, B=3, S=8, 01 with video)
on a random batch at the real clip format.  Two warm-up steps, then
``--steps`` steps timed on the host clock to a synchronised card, then
``--steps`` steps under ``torch.profiler``.  Prints the device time of
each kernel (total and per call, divided by the step count), the host
ms of a step, the idle share (1 - device time / host ms; the kernels of
one stream do not overlap) and the peak device memory of a step, with
the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import time

EXPERIMENTS = {"exp00": "00_audio_only_debug", "exp01": "01_audio_video_debug"}


def main(argv=None) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from movenet_tpu_torch.train import create_train_state, make_train_step
    from movenet_tpu_torch.utils.fixtures import (
        FLAGSHIP_TRAIN,
        breakdancing,
        experiment,
        random_batch,
    )

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--rows", type=int, default=20,
                    help="kernels to list, largest first")
    ap.add_argument("--widths", choices=("breakdancing", "flagship",
                                         *EXPERIMENTS),
                    default="breakdancing")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    if args.widths in EXPERIMENTS:
        cfg, model = experiment(EXPERIMENTS[args.widths])
        batch = random_batch(cfg.model_config, cfg.batch_size,
                             cfg.use_video)
    else:
        cfg, model, batch = breakdancing(
            widths=FLAGSHIP_TRAIN if args.widths == "flagship" else None)
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: -e.device_time_total)
    total = sum(e.device_time_total for e in rows) / args.steps / 1e3
    print(f"{args.widths}: device time per step {total:.3f} ms over "
          f"{args.steps} steps; host {host_ms:.3f} ms a step (unprofiled), "
          f"idle share {1 - total / host_ms:.3f}; peak memory "
          f"{peak_gb:.3f} GB; {card.strip()}")
    for e in rows[:args.rows]:
        per_step = e.device_time_total / args.steps / 1e3
        print(f"{per_step:9.3f} ms/step {e.count // args.steps:4d} calls "
              f"{e.device_time_total / e.count / 1e3:8.3f} ms/call  "
              f"{e.key[:100]}")


if __name__ == "__main__":
    main()
