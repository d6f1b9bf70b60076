"""The data-parallel trainer on every card of this host against one card.

    python -m movenet_tpu_torch.utils.time_dp [--rows 2] [--steps 6]

Writes synthetic clips at the real format (16 kHz, 16 fps, 10 s, 96x96),
then runs the trainer CLI with the flags of
``experiments/torch/02_kinetics_breakdancing.sh`` and the recompute
strategy at a global batch of ``--rows`` rows a card for one epoch of
``--steps`` steps, twice: over every visible card
(``--mesh_data -1``: the CLI spawns one rank a card, which join one NCCL
group) and on card 0 alone (``CUDA_VISIBLE_DEVICES=0``: one process, no
group).  Fails unless the multi-card run's ranks end with equal params
and each step's training loss is within 1e-3 relative of the one-card
run's.  Prints each run's update time (the trainer's ``steps_per_sec``
at every step, synchronised by its logging; median after the first
step) and wall time, with every card's name and power limit; the last
line is a JSON summary.  Needs two or more CUDA devices.
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
SCRIPT = ROOT / "experiments" / "torch" / "02_kinetics_breakdancing.sh"
TIMEOUT_S = 900


def _script_flags() -> list:
    """The trainer flags of experiment 02's script, without the dataset
    and "$@"."""
    import shlex

    text = SCRIPT.read_text()
    body = text[text.index(".train.cli"):].split("\n", 1)[1]
    flags = [f for f in shlex.split(body.replace("\\\n", " ")) if f != "$@"]
    i = flags.index("--dataset")
    return flags[:i] + flags[i + 2:]


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

    from movenet_tpu_torch.data import make_synthetic_dataset
    from movenet_tpu_torch.ops.cuda import build

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rows", type=int, default=2, help="rows a card")
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args(argv)
    cards = torch.cuda.device_count()
    if cards < 2:
        raise SystemExit("time_dp needs two or more CUDA devices")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().replace("\n", "; ")
    batch = cards * args.rows
    t0 = time.perf_counter()
    build.build()   # once, before the ranks start
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        ds = Path(tmp) / "clips"
        make_synthetic_dataset(ds, splits=("train", "valid"),
                               categories=["breakdancing"],
                               clips_per_category=batch * args.steps)
        for label, visible in (("cards", None), ("one card", "0")):
            env = dict(os.environ)
            if visible is not None:
                env["CUDA_VISIBLE_DEVICES"] = visible
            out = Path(tmp) / label.replace(" ", "_")
            t0 = time.perf_counter()
            log = _run([sys.executable, "-m", "movenet_tpu_torch.train.cli",
                        "--dataset", str(ds), *_script_flags(), "--batch_size",
                        str(batch), "--val_batch_size", str(batch),
                        "--n_epochs", "1", "--n_steps_per_epoch",
                        str(args.steps), "--fused_strategy", "recompute",
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
            f"mesh: data={cards} seq=1 over {cards} device(s)",
            f"the {cards} ranks' params are equal"]
    found = [next((l.split(": ", 3)[-1] for l in multi["log"].splitlines()
                   if w in l), None) for w in want]
    for line in found:
        print(f"time_dp: {line}", flush=True)
    for label, r in runs.items():
        rows = args.rows if label == "cards" else batch
        print(f"time_dp {label}: batch {batch} ({rows} rows a card), "
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
    print(json.dumps({"cards": cards, "batch": batch, "rows_a_card": args.rows,
                      "card": card, "ms": multi["median_ms"],
                      "one_card_ms": one["median_ms"],
                      "loss": multi["loss"], "one_card_loss": one["loss"],
                      "ok": not bad}))
    if bad:
        raise SystemExit(f"time_dp: {bad}")


if __name__ == "__main__":
    sys.exit(main())
