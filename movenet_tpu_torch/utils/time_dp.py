"""The parallel trainer on every card of this host against one card.

    python -m movenet_tpu_torch.utils.time_dp [--rows 2] [--steps 6]
        [--seq 1] [--script 02_kinetics_breakdancing]

Writes synthetic clips at the real format (16 kHz, 16 fps, 10 s, 96x96),
then runs the trainer CLI with the flags of
``experiments/torch/<script>.sh`` (a fused script's, such as 02, with
the recompute strategy under ``--seq 1``) at a global batch of
``--rows`` rows a data index for one epoch of ``--steps`` steps, twice:
over every visible card (``--mesh_data -1 --mesh_seq <seq>``: a data
axis of cards / seq indices, the time axis over seq cards each; the CLI
spawns one rank a card, which join one NCCL group) and on card 0 alone
(``CUDA_VISIBLE_DEVICES=0``: one process, no group).  Under ``--seq`` >
1 the fused route is off, so the cards run the unfused route whatever
the script says.  Fails unless the multi-card run's ranks end with equal
params and each step's training loss is within 1e-3 relative of the
one-card run's.  Prints each run's update time (the trainer's
``steps_per_sec`` at every step, synchronised by its logging; median
after the first step) and wall time, with every card's name and power
limit; the last line is a JSON summary.  Needs two or more CUDA
devices.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SCRIPTS = ("00_audio_only_debug", "01_audio_video_debug",
           "02_kinetics_breakdancing")
TIMEOUT_S = 900


def _run(cmd, env) -> str:
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SystemExit(f"time_dp: {cmd[:2]} ran past {TIMEOUT_S} s")
    if proc.returncode:
        raise SystemExit(f"time_dp: the trainer exited {proc.returncode}:\n"
                         f"{out[-4000:]}")
    return out


def main(argv=None) -> None:
    import torch

    from movenet_tpu_torch.config import arg_parser, config_from_args
    from movenet_tpu_torch.data import make_synthetic_dataset
    from movenet_tpu_torch.ops.cuda import build
    from movenet_tpu_torch.utils.fixtures import script_flags

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rows", type=int, default=2,
                    help="rows a data index")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seq", type=int, default=1,
                    help="cards a data index (the time axis)")
    ap.add_argument("--script", choices=SCRIPTS, default=SCRIPTS[-1])
    args = ap.parse_args(argv)
    cards = torch.cuda.device_count()
    if cards < 2:
        raise SystemExit("time_dp needs two or more CUDA devices")
    if cards % args.seq:
        raise SystemExit(f"--seq {args.seq} does not divide {cards} cards")
    data = cards // args.seq
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().replace("\n", "; ")
    batch = data * args.rows
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        ds = Path(tmp) / "clips"
        flags = script_flags(args.script)
        fused = config_from_args(arg_parser().parse_args(
            ["--dataset", str(ds), *flags])).fused_blocks and args.seq == 1
        if fused:
            # the fused route: the recompute strategy, and its kernels
            # built once, before the ranks start
            flags += ["--fused_strategy", "recompute"]
            t0 = time.perf_counter()
            build.build()
            print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
        make_synthetic_dataset(ds, splits=("train", "valid"),
                               categories=["breakdancing"],
                               clips_per_category=batch * args.steps)
        for label, visible in (("cards", None), ("one card", "0")):
            env = dict(os.environ)
            if visible is not None:
                env["CUDA_VISIBLE_DEVICES"] = visible
            out = Path(tmp) / label.replace(" ", "_")
            t0 = time.perf_counter()
            mesh = [] if visible else ["--mesh_seq", str(args.seq)]
            log = _run([sys.executable, "-m", "movenet_tpu_torch.train.cli",
                        "--dataset", str(ds), *flags, *mesh, "--batch_size",
                        str(batch), "--val_batch_size", str(batch),
                        "--n_epochs", "1", "--n_steps_per_epoch",
                        str(args.steps),
                        "--log_every_n_steps", "1", "--logger", "jsonl",
                        "--model_output_path", str(out / "run"),
                        "--training_logs_path", str(out / "logs")], env)
            lines = [json.loads(l) for l in
                     (out / "logs" / "metrics.jsonl").read_text().splitlines()]
            train = [l for l in lines if l["tag"] == "train"]
            ms = [1e3 / l["steps_per_sec"] for l in train]
            runs[label] = dict(
                loss=[l["loss"] for l in train], ms=ms,
                median_ms=statistics.median(ms[1:]),
                val_loss=[l["loss"] for l in lines if l["tag"] == "val"],
                wall_s=time.perf_counter() - t0, log=log)
    multi, one = runs["cards"], runs["one card"]
    want = [f"rank 0 of {cards} over nccl",
            f"mesh: data={data} seq={args.seq} over {cards} device(s)",
            f"the {cards} ranks' params are equal"]
    found = [next((l.split(": ", 3)[-1] for l in multi["log"].splitlines()
                   if w in l), None) for w in want]
    for line in found:
        print(f"time_dp: {line}", flush=True)
    for label, r in runs.items():
        layout = f"data {data} x seq {args.seq}, {args.rows} rows a data " \
            "index" if label == "cards" else f"{batch} rows"
        print(f"time_dp {label} ({args.script}): batch {batch} ({layout}), "
              f"{len(r['ms'])} updates: ms "
              f"{[round(v, 2) for v in r['ms']]} (median after the first "
              f"{r['median_ms']:.2f}); losses "
              f"{[round(v, 6) for v in r['loss']]}; val loss "
              f"{[round(v, 6) for v in r['val_loss']]}; wall "
              f"{r['wall_s']:.1f} s with the data; {card}", flush=True)
    bad = [w for w, l in zip(want, found) if l is None]
    if len(multi["loss"]) != args.steps or len(one["loss"]) != args.steps:
        bad.append(f"steps logged: {len(multi['loss'])}, {len(one['loss'])}")
    bad += [f"step {i}: loss {a} against one card's {b}"
            for i, (a, b) in enumerate(zip(multi["loss"], one["loss"]))
            if abs(a - b) > 1e-3 * abs(b)]
    print(json.dumps({"cards": cards, "script": args.script, "data": data,
                      "seq": args.seq, "batch": batch,
                      "rows_a_data_index": args.rows,
                      "card": card, "ms": multi["median_ms"],
                      "one_card_ms": one["median_ms"],
                      "loss": multi["loss"], "one_card_loss": one["loss"],
                      "ok": not bad}))
    if bad:
        raise SystemExit(f"time_dp: {bad}")


if __name__ == "__main__":
    sys.exit(main())
