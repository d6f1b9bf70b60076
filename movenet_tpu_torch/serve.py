"""Persistent generation server: checkpoint -> TCP JSON-line API.

The port of ``movenet_tpu.serve``, with the same protocol.  It loads the
checkpoint once, keeps the model on the device, and answers generation
requests over a socket.  On a CUDA device every request with B in
{1, 2, 4, 8, 16, 32} streams runs one launch of an AR sampler kernel
(``ops/cuda/ar_sampler.cu``); other batch sizes, and a server on the
CPU, use the cached sampler ``models/sampler.fast_generate``.

Protocol (one JSON object per line, newline-terminated, UTF-8):

  request:  {"id": any, "n_samples": int, "temperature": float,
             "prompt": [[codes...] per stream] | null,
             "seed": int, "format": "codes" | "wav"}
  response: {"id": any, "ms": float, "samples_per_sec": float,
             "codes": [[...]]}            (format == "codes")
            + "spec_commit_ratio" when the speculative kernel served
              the request (greedy B=1: fraction of the generated
              samples that rode a committed guess, bounded [0, 1))
            {"id": ..., "wav_b64": [...]} (format == "wav": 16 kHz
                                           mono PCM16 WAV per stream)
  errors:   {"id": any, "error": "..."}
  health:   {"op": "ping"} -> {"ok": true, "model": {...}}

Requests are served in order behind one lock (one device, one queue;
concurrency belongs in the batch dimension).  A missing prompt seeds
with RF frames of mu-law silence; a short prompt is left-padded with
silence and a long one keeps its most recent RF codes.

Speculative routing (``--speculative 1``, the default) is staged as in
the JAX server: B=1 greedy requests ride the speculative kernel only
after an in-process run of it has given codes bit-equal to the standard
kernel's on this device (``validate_speculative``, after warmup in
``serve``); until then, and after any failure, the standard kernel
serves them, and a failure of the pair-table (order 3) form downgrades
to order 2 before speculation is turned off.

Server:  python -m movenet_tpu_torch.serve --checkpoint <run_dir> --port 7631
Client:  python -m movenet_tpu_torch.serve --connect localhost:7631 \
             --n_samples 20000 --temperature 1.0 --out clip.wav
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import logging
import socket
import socketserver
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


class GenerationService:
    """Checkpoint + model on one device behind a lock."""

    last_spec_commit_ratio: Optional[float] = None

    def __init__(self, checkpoint_dir: Path, parity_sampling: bool = True,
                 fast: bool = True, prefer_kernel: Optional[bool] = None,
                 speculative: bool = True, spec_order: int = 3,
                 device="cuda"):
        from movenet_tpu_torch.generate import load_checkpoint_model
        from movenet_tpu_torch.ops import mu_law_encode

        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"device {device!r} requested but no CUDA device is "
                    "available")
            # the exact sampler is float32 end to end, as the JAX
            # package's Precision.HIGHEST path is
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model, self.config, self.step = load_checkpoint_model(
            Path(checkpoint_dir), device=self.device)
        self.mc = self.config.model_config
        self.rf = self.model.receptive_fields
        self.parity_sampling = parity_sampling
        self.fast = fast
        self.speculative = speculative
        # 3 = learned pair table (default); validation falls back to 2
        self.spec_order = spec_order
        # None = not yet validated (the standard kernel serves
        # everything); True = validated, speculation routes B=1 greedy;
        # False = validation failed, speculation off for the server's
        # lifetime.  serve() validates during warmup; without warmup the
        # first eligible request is served by the standard kernel and
        # validation runs in a background thread behind the same lock.
        self.spec_validated: Optional[bool] = None
        self._spec_validation_started = False
        if prefer_kernel is None:
            prefer_kernel = self.device.type == "cuda"
        self.prefer_kernel = prefer_kernel
        self.silent_code = int(mu_law_encode(
            torch.zeros(1), self.mc.input_channels)[0])
        self._lock = threading.Lock()

    # ------------------------------------------------------------ info
    def info(self) -> dict:
        mc = self.mc
        return {
            "step": self.step,
            "receptive_fields": self.rf,
            "input_channels": mc.input_channels,
            "layer_size": mc.layer_size,
            "stack_size": mc.stack_size,
            "max_audio_frames": mc.max_audio_frames,
            "sampler": "cuda" if self.prefer_kernel else "scan",
            "speculative": {None: "pending-validation", True: "active",
                            False: "off"}[self.spec_validated]
            if self.speculative and self.prefer_kernel else "off",
            "device": str(self.device),
        }

    # ------------------------------------------- speculative staging
    def validate_speculative(self, n: Optional[int] = None) -> bool:
        """Run the speculative kernel in-process and bit-check it against
        the standard kernel; only a validated kernel is routed traffic.
        Staged: an order-3 failure retries on order 2 before giving up.
        Returns whether speculative routing is now active; the decision
        is logged."""
        from movenet_tpu_torch.ops.cuda.ar_sampler import cuda_generate

        if not (self.speculative and self.prefer_kernel):
            return False
        if self.spec_validated is not None:
            return bool(self.spec_validated)
        n = int(n or (self.rf + 128))
        prompt = torch.full((1, self.rf), self.silent_code,
                            dtype=torch.int32, device=self.device)
        with self._lock:
            if self.spec_validated is not None:
                return bool(self.spec_validated)
            t0 = time.perf_counter()
            ref = cuda_generate(
                self.model, prompt, n, temperature=0.0,
                parity_sampling=self.parity_sampling, fast=self.fast,
                speculative=False)
            orders = (self.spec_order,) if self.spec_order != 3 \
                else (3, 2)
            for order in orders:
                try:
                    got, _ = cuda_generate(
                        self.model, prompt, n, temperature=0.0,
                        parity_sampling=self.parity_sampling,
                        fast=self.fast, speculative=True,
                        spec_order=order, return_stats=True)
                except Exception:
                    logger.exception(
                        "speculative validation: order-%d kernel "
                        "failed to build/run", order)
                    continue
                if torch.equal(got, ref):
                    self.spec_order = order
                    self.spec_validated = True
                    logger.info(
                        "speculative routing ACTIVE (order %d "
                        "validated bit-equal in %.1fs)", order,
                        time.perf_counter() - t0)
                    return True
                logger.error(
                    "speculative validation: order-%d output is NOT "
                    "bit-equal to the standard kernel; speculation "
                    "disabled", order)
                break
            self.spec_validated = False
            self.speculative = False
            logger.info("speculative routing OFF (validation failed "
                        "in %.1fs)", time.perf_counter() - t0)
            return False

    def _start_background_validation(self):
        if self._spec_validation_started:
            return
        self._spec_validation_started = True
        logger.info("request served on the standard kernel; "
                    "speculative validation started in the background "
                    "(requests stay on the standard kernel until it "
                    "passes)")
        threading.Thread(target=self.validate_speculative,
                         daemon=True).start()

    # -------------------------------------------------------- generate
    def generate(self, n_samples: int, temperature: float = 1.0,
                 prompt: Optional[np.ndarray] = None, seed: int = 0
                 ) -> np.ndarray:
        """(B, n_samples) int32 mu-law codes (prompt included).

        ``self.last_spec_commit_ratio`` mirrors the most recent request's
        commit ratio; concurrent handlers use ``generate_with_stats``,
        whose return value another request cannot overwrite."""
        return self.generate_with_stats(n_samples, temperature, prompt,
                                        seed)[0]

    def generate_with_stats(self, n_samples: int,
                            temperature: float = 1.0,
                            prompt: Optional[np.ndarray] = None,
                            seed: int = 0):
        """(codes, spec_commit_ratio or None) for one request: the commit
        ratio (committed guesses / generated samples) when the
        speculative kernel served it, None otherwise."""
        from movenet_tpu_torch.models.sampler import fast_generate
        from movenet_tpu_torch.ops import jax_random
        from movenet_tpu_torch.ops.cuda.ar_sampler import (
            BATCH_SIZES, cuda_generate)

        if prompt is None:
            prompt = np.full((1, self.rf), self.silent_code, np.int32)
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim == 1:
            prompt = prompt[None, :]
        if prompt.shape[1] < self.rf:  # left-pad with silence
            pad = np.full((prompt.shape[0], self.rf - prompt.shape[1]),
                          self.silent_code, np.int32)
            prompt = np.concatenate([pad, prompt], axis=1)
        elif prompt.shape[1] > self.rf:
            # keep the most recent rf codes: the samplers condition on
            # prompt[:, :rf]
            prompt = prompt[:, -self.rf:]
        c_in = self.mc.input_channels
        if prompt.min() < 0 or prompt.max() >= c_in:
            raise ValueError(f"prompt codes must lie in [0, {c_in})")
        n_samples = int(n_samples)
        if n_samples <= self.rf:
            raise ValueError(
                f"n_samples ({n_samples}) must exceed the receptive "
                f"field ({self.rf})")
        b = prompt.shape[0]
        prompt_t = torch.from_numpy(prompt).to(self.device)
        spec_candidate = False
        commit_ratio = None
        with self._lock:
            if self.prefer_kernel and b in BATCH_SIZES:
                # B=1 greedy requests ride the speculative kernel once it
                # is validated; sampled requests stay on the standard
                # kernel (speculation is exact at any temperature, but
                # sampled hit rates are low)
                spec_candidate = bool(self.speculative and b == 1
                                      and float(temperature) == 0.0)
                spec = bool(spec_candidate and self.spec_validated)
                codes = None
                while spec:
                    try:
                        codes, hits = cuda_generate(
                            self.model, prompt_t, n_samples,
                            temperature=float(temperature),
                            seed=int(seed),
                            parity_sampling=self.parity_sampling,
                            fast=self.fast, speculative=True,
                            spec_order=self.spec_order,
                            return_stats=True)
                        h = float(hits)
                        g = n_samples - self.rf
                        commit_ratio = round(h / max(1, g), 4)
                        break
                    except Exception:
                        # staged downgrade: validation ran at one size,
                        # so a failure at this size still goes order 3
                        # -> order 2 -> the standard kernel, and stops
                        # speculative routing for the server's lifetime
                        if self.spec_order == 3:
                            logger.exception(
                                "order-3 speculative kernel failed; "
                                "retrying with spec_order=2")
                            self.spec_order = 2
                            continue
                        logger.exception(
                            "speculative sampler failed; falling back "
                            "to the standard kernel (disabled for "
                            "this server lifetime)")
                        self.speculative = False
                        self.spec_validated = False
                        spec = False
                if codes is None:
                    codes = cuda_generate(
                        self.model, prompt_t, n_samples,
                        temperature=float(temperature), seed=int(seed),
                        parity_sampling=self.parity_sampling,
                        fast=self.fast, speculative=False)
            else:
                codes = fast_generate(
                    self.model, prompt_t, n_samples,
                    temperature=float(temperature),
                    rng=jax_random.PRNGKey(int(seed)),
                    parity_sampling=self.parity_sampling)
            self.last_spec_commit_ratio = commit_ratio
            codes = codes.cpu().numpy()
        if spec_candidate and self.spec_validated is None:
            # served on the standard kernel; bring speculation up out of
            # band so that a later request can ride it
            self._start_background_validation()
        return codes, commit_ratio

    def warmup(self, n: Optional[int] = None) -> float:
        """One greedy request at a canonical size; returns seconds."""
        t0 = time.perf_counter()
        self.generate(n or (self.rf + 128), temperature=0.0)
        return time.perf_counter() - t0

    # ------------------------------------------------------------- wav
    def to_wav(self, codes: np.ndarray) -> list:
        """Per-stream 16 kHz PCM16 WAV bytes (base64) from codes."""
        import wave

        from movenet_tpu_torch.ops import mu_law_decode

        audio = mu_law_decode(torch.from_numpy(np.asarray(codes)),
                              self.mc.input_channels).numpy()
        out = []
        for row in audio:
            pcm = np.clip(row * 32767.0, -32768, 32767).astype("<i2")
            buf = io.BytesIO()
            with wave.open(buf, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16_000)
                w.writeframes(pcm.tobytes())
            out.append(base64.b64encode(buf.getvalue()).decode("ascii"))
        return out


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        svc: GenerationService = self.server.service  # type: ignore
        for raw in self.rfile:
            raw = raw.strip()
            if not raw:
                continue
            try:
                req = json.loads(raw)
            except json.JSONDecodeError as e:
                self._send({"error": f"bad json: {e}"})
                continue
            rid = req.get("id")
            try:
                if req.get("op") == "ping":
                    self._send({"id": rid, "ok": True,
                                "model": svc.info()})
                    continue
                t0 = time.perf_counter()
                codes, commit_ratio = svc.generate_with_stats(
                    req.get("n_samples", svc.rf + 16_000),
                    temperature=req.get("temperature", 1.0),
                    prompt=req.get("prompt"),
                    seed=req.get("seed", 0))
                dt = time.perf_counter() - t0
                generated = codes.shape[1] - svc.rf
                resp = {"id": rid, "ms": round(dt * 1e3, 3),
                        "samples_per_sec": round(
                            generated * codes.shape[0] / dt, 1)}
                if commit_ratio is not None:
                    resp["spec_commit_ratio"] = commit_ratio
                if req.get("format", "codes") == "wav":
                    resp["wav_b64"] = svc.to_wav(codes)
                else:
                    resp["codes"] = codes.tolist()
                self._send(resp)
            except Exception as e:  # report, keep serving
                logger.exception("request failed")
                self._send({"id": rid, "error": str(e)})

    def _send(self, obj: dict):
        self.wfile.write((json.dumps(obj) + "\n").encode())
        self.wfile.flush()


class GenerationServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, service: GenerationService):
        super().__init__(addr, _Handler)
        self.service = service


def serve(checkpoint_dir: Path, host: str = "127.0.0.1",
          port: int = 7631, warmup: bool = True,
          parity_sampling: bool = True, fast: bool = True,
          prefer_kernel: Optional[bool] = None,
          speculative: bool = True, spec_order: int = 3,
          device="cuda") -> GenerationServer:
    svc = GenerationService(checkpoint_dir,
                            parity_sampling=parity_sampling, fast=fast,
                            prefer_kernel=prefer_kernel,
                            speculative=speculative, spec_order=spec_order,
                            device=device)
    if warmup:
        dt = svc.warmup()
        logger.info("sampler warm (build+first run: %.1fs)", dt)
        # validate the speculative kernel before accepting traffic, so
        # that the first request stays on a proven path
        svc.validate_speculative()
    server = GenerationServer((host, port), svc)
    logger.info("serving %s on %s:%d", svc.info(), host,
                server.server_address[1])
    return server


def request(host: str, port: int, payload: dict, timeout: float = 600.0
            ) -> dict:
    """One-shot client: send a request line, read the response line."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        f = s.makefile("rwb")
        f.write((json.dumps(payload) + "\n").encode())
        f.flush()
        line = f.readline()
    if not line:
        raise ConnectionError("server closed the connection")
    return json.loads(line)


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s: %(levelname)s: %(message)s")
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", type=Path, default=None)
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7631)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the model (cuda, cuda:1, cpu)")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--parity_sampling", type=lambda x: bool(int(x)),
                    default=True)
    ap.add_argument("--fast_sampler", type=lambda x: bool(int(x)),
                    default=True)
    ap.add_argument("--speculative", type=lambda x: bool(int(x)),
                    default=True,
                    help="route B=1 greedy requests through the "
                    "speculative wavefront kernel once an in-process run "
                    "+ bit-check passes on this device (until then, and "
                    "on any failure, the standard kernel serves)")
    ap.add_argument("--spec_order", type=int, default=3, choices=(2, 3),
                    help="speculative guesser order (3: learned pair "
                    "table, default; 2: learned successor column)")
    # client mode
    ap.add_argument("--connect", type=str, default=None,
                    help="host:port — run as client instead of server")
    ap.add_argument("--n_samples", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="client: write the first stream's WAV here")
    args = ap.parse_args(argv)

    if args.connect:
        host, _, port = args.connect.partition(":")
        payload = {"id": 0, "temperature": args.temperature,
                   "seed": args.seed,
                   "format": "wav" if args.out else "codes"}
        if args.n_samples:
            payload["n_samples"] = args.n_samples
        resp = request(host, int(port or 7631), payload)
        if "error" in resp:
            raise SystemExit(f"server error: {resp['error']}")
        if args.out:
            args.out.write_bytes(
                base64.b64decode(resp["wav_b64"][0]))
            print(f"{args.out} ({resp['ms']} ms, "
                  f"{resp['samples_per_sec']} samples/s)")
        else:
            print(json.dumps({k: v for k, v in resp.items()
                              if k != "codes"}))
        return

    if args.checkpoint is None:
        raise SystemExit("--checkpoint is required in server mode")
    server = serve(args.checkpoint, args.host, args.port,
                   warmup=not args.no_warmup,
                   parity_sampling=args.parity_sampling,
                   fast=args.fast_sampler,
                   speculative=args.speculative,
                   spec_order=args.spec_order, device=args.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
