#!/usr/bin/env python3
"""Smoke test of movenet_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases (any failure exits non-zero and prints no result):
  1. device: a CUDA card is present; its name and power limit;
  2. build: every csrc/*.cu kernel is compiled with nvcc;
  3. kernel vs plain: the AR sampler kernel and its plain torch version
     give equal codes at the flagship sampler width (layer 10 x stack 3,
     C=256, R=S=64, RF=3072; seeded random weights, head2 x 10) for
     n = RF + 2048: greedy B=1 and B=8, exact and fast, and T=1.0 with
     parity sampling at B=8, fast, seed 3;
  4. serve (the main path): GenerationServer on a flagship checkpoint in
     a temp dir, once with the fast sampler (the default) and once with
     the exact one, answering ping, greedy, sampled and wav requests over
     TCP; every generate request is one kernel launch, and the codes
     equal a direct cuda_generate call;
  5. times: samples/s of the kernel and of the plain version;
  6. the kernels line, then the card line, then the result line.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FLAGSHIP = dict(layer_size=10, stack_size=3, input_channels=256,
                residual_channels=64, skip_channels=64)
N_COMPARE = 2048          # generated samples per kernel-vs-plain case
N_SERVE = 16_000          # generated samples of the B=1 serve request
REPLACES = "movenet_tpu/ops/pallas/ar_sampler.py:206"


class PhaseFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def flagship_model(torch, seed: int = 0):
    from movenet_tpu_torch.config import ModelConfig
    from movenet_tpu_torch.models.wavenet import make_wavenet

    mc = ModelConfig(**FLAGSHIP, compute_dtype="float32")
    gen = torch.Generator().manual_seed(seed)
    model = make_wavenet(mc, generator=gen)
    with torch.no_grad():
        # a sharper head gives greedy decisions a margin above float32
        # summation-order noise, as tests/test_pallas_sampler.py does
        model.head2.kernel.mul_(10.0)
    return mc, model.to("cuda").eval()


def time_cuda(torch, fn, repeats: int) -> float:
    """Mean milliseconds of fn() over repeats, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def phase_compare(torch, np, model, rf):
    """Kernel vs plain on the same inputs; returns per-case records."""
    from movenet_tpu_torch.ops.cuda import ar_sampler as ars

    cases = [("greedy B=1 exact", 1, 0.0, False, 0),
             ("greedy B=1 fast", 1, 0.0, True, 0),
             ("greedy B=8 exact", 8, 0.0, False, 0),
             ("greedy B=8 fast", 8, 0.0, True, 0),
             ("T=1.0 parity B=8 fast", 8, 1.0, True, 3)]
    rng = np.random.default_rng(0)
    records = []
    for label, batch, temp, fast, seed in cases:
        prompt = rng.integers(0, model.input_channels, size=(batch, rf))
        inp = ars.prepare(model, prompt, rf + N_COMPARE, temperature=temp,
                          seed=seed, parity_sampling=True, fast=fast)
        got = ars.ar_sampler(inp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, margins = ars.ar_sampler_plain(inp, return_margins=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        kernel_ms = time_cuda(torch, lambda: ars.ar_sampler(inp), 3)
        diff = (got != want).nonzero()
        err = int((got.long() - want.long()).abs().max())
        generated = batch * N_COMPARE
        rec = dict(label=label, name=inp.name, batch=batch, fast=fast,
                   equal=diff.shape[0] == 0, max_abs_err=err,
                   ms=kernel_ms, plain_ms=plain_ms,
                   sps=generated / kernel_ms * 1e3,
                   plain_sps=generated / plain_ms * 1e3)
        records.append(rec)
        msg = (f"compare {label}: equal={rec['equal']} kernel "
               f"{kernel_ms:.2f} ms, plain {plain_ms:.1f} ms")
        if diff.shape[0]:
            b, i = (int(v) for v in diff[0])
            margin = float(margins[b, i - 1]) if i > 0 else float("nan")
            msg += (f"; first difference at stream {b}, position "
                    f"{rf + i} (kernel {int(got[b, i])}, plain "
                    f"{int(want[b, i])}), plain top-2 margin there "
                    f"{margin:.3g}")
        print(msg, flush=True)
    return records


def phase_serve(torch, np, mc, model, rf):
    """The main path: two servers (fast default, exact), real requests."""
    from movenet_tpu_torch.config import TrainingConfig
    from movenet_tpu_torch.models.convert import params_to_jax
    from movenet_tpu_torch.ops.cuda import ar_sampler as ars
    from movenet_tpu_torch.serve import (GenerationServer,
                                         GenerationService, request)
    from movenet_tpu_torch.train.checkpoint import save_params

    rng = np.random.default_rng(1)
    prompt8 = rng.integers(0, mc.input_channels, size=(8, rf)).tolist()
    with tempfile.TemporaryDirectory() as run_dir:
        cfg = TrainingConfig(model_config=mc, use_video=False,
                             scheduler=None, batch_size=1)
        save_params(run_dir, 0, params_to_jax(model.state_dict()), cfg)
        services = {}
        replies = {}
        ars.reset_launch_counts()
        for fast in (True, False):
            svc = GenerationService(Path(run_dir), fast=fast,
                                    device="cuda")
            services[fast] = svc
            svc.warmup()
            server = GenerationServer(("127.0.0.1", 0), svc)
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            port = server.server_address[1]
            try:
                reqs = {"ping": {"op": "ping", "id": "ping"},
                        "greedy": {"id": "greedy", "temperature": 0.0,
                                   "n_samples": rf + N_SERVE},
                        "sampled": {"id": "sampled", "temperature": 1.0,
                                    "seed": 3, "prompt": prompt8,
                                    "n_samples": rf + N_COMPARE}}
                if fast:
                    reqs["wav"] = {"id": "wav", "temperature": 0.0,
                                   "format": "wav",
                                   "n_samples": rf + N_COMPARE}
                for key, payload in reqs.items():
                    resp = request("127.0.0.1", port, payload)
                    check("error" not in resp,
                          f"serve {key} (fast={fast}): {resp.get('error')}")
                    replies[(fast, key)] = resp
            finally:
                server.shutdown()
                server.server_close()
                thread.join(timeout=30)
        torch.cuda.synchronize()
        launches = dict(ars.launch_counts)

    # every generate request, warmup included, was one launch
    check(launches == {"ar_sampler_fast": 4, "ar_sampler_exact": 3},
          f"launch counts of the main path: {launches}")
    for fast in (True, False):
        svc = services[fast]
        ping = replies[(fast, "ping")]
        check(ping.get("ok") and ping["model"]["sampler"] == "cuda",
              f"ping: {ping}")
        silence = np.full((1, rf), svc.silent_code)
        direct = {
            "greedy": ars.cuda_generate(svc.model, silence, rf + N_SERVE,
                                        fast=fast),
            "sampled": ars.cuda_generate(svc.model, prompt8,
                                         rf + N_COMPARE, temperature=1.0,
                                         seed=3, fast=fast),
        }
        for key, want in direct.items():
            resp = replies[(fast, key)]
            got = np.asarray(resp["codes"])
            want = want.cpu().numpy()
            check(got.shape == want.shape, f"{key}: shape {got.shape}")
            check((got >= 0).all() and (got < mc.input_channels).all(),
                  f"{key}: codes out of range")
            check((got == want).all(),
                  f"serve {key} (fast={fast}) differs from cuda_generate")
            print(f"serve fast={int(fast)} {key}: B={got.shape[0]} "
                  f"n={got.shape[1]} {resp['ms']} ms, "
                  f"{resp['samples_per_sec']} samples/s", flush=True)
        if fast:
            wav = replies[(True, "wav")]
            check(len(wav["wav_b64"]) == 1, "wav: one stream expected")
            import base64
            raw = base64.b64decode(wav["wav_b64"][0])
            check(raw[:4] == b"RIFF" and len(raw) == 44 + 2 * (rf + N_COMPARE),
                  "wav: not a 16-bit mono WAV of the requested length")
            print(f"serve fast=1 wav: {wav['ms']} ms, "
                  f"{wav['samples_per_sec']} samples/s", flush=True)
    return launches


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import movenet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: movenet_tpu_torch not importable ({e}); run "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    from movenet_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = "device"
    try:
        card = card_line()
        kind = torch.cuda.get_device_name(0)
        print(f"device: {kind}; torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}; {card}", flush=True)

        phase = "build"
        t0 = time.perf_counter()
        libs = build.build()
        print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for name, log in build.build_logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  nvcc {name}: {line.strip()}")

        phase = "kernel vs plain"
        mc, model = flagship_model(torch)
        rf = model.receptive_fields
        check(rf == 3072, f"flagship RF is {rf}")
        records = phase_compare(torch, np, model, rf)
        bad = [r["label"] for r in records if not r["equal"]]
        check(not bad, f"kernel and plain disagree: {bad}")

        phase = "serve"
        launches = phase_serve(torch, np, mc, model, rf)

        phase = "times"
        for r in records:
            print(f"time {r['label']}: kernel {r['sps']:.0f} samples/s "
                  f"({r['ms']:.2f} ms for {r['batch']}x{N_COMPARE}), plain "
                  f"{r['plain_sps']:.0f} samples/s ({r['plain_ms']:.1f} ms)"
                  f"; {card}", flush=True)

        phase = "kernels line"
        from movenet_tpu_torch.ops.cuda import ar_sampler as ars
        kernels = []
        for name in ("ar_sampler_exact", "ar_sampler_fast"):
            mine = [r for r in records if r["name"] == name]
            timed = [r for r in mine if r["batch"] == 1][0]
            kernels.append({
                "name": name, "route": "cuda",
                "source": ars.KERNEL_SOURCE,
                "replaces": REPLACES, "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": timed["ms"], "plain_ms": timed["plain_ms"],
                "matches_plain": all(r["equal"] for r in mine),
                "shape": f"B=1, n=RF+{N_COMPARE}"})
        check(all(k["launches"] > 0 for k in kernels),
              "a kernel of the path was not launched")
        print(json.dumps({"kernels": kernels}))
        print(card)
    except PhaseFailed as e:
        print(f"chip_smoke: phase {phase} failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
