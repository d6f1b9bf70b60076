#!/usr/bin/env python3
"""Smoke test of movenet_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases (any failure exits non-zero and prints no result):
  1. device: a CUDA card is present; its name and power limit;
  2. build: every csrc/*.cu kernel is compiled with nvcc; ptxas'
     registers and spills of every kernel, and for the save backward's
     tensor-core kernels (stack_bwd_layer_kernel, stack_wgrad_kernel)
     their dynamic shared memory too; the dynamic shared memory of the
     eight ar_sampler_kernel instantiations (the standard form, exact and
     fast, with and without video; the speculative one at depths 1 and 2)
     at the flagship width (their ring of stages beside the chain
     buffers, the kernel's and the wrapper's sizes equal);
  3. kernel vs plain: the AR sampler kernel and its plain torch version
     give equal codes at the flagship sampler width (layer 10 x stack 3,
     C=256, R=S=64, RF=3072; seeded random weights, head2 x 10) for
     n = RF + 2048: greedy B=1 and B=8, exact and fast, and T=1.0 with
     parity sampling at B=8, fast, seed 3; each case's us per step and
     its stream bound: the step's packed weight stream times the steps
     over the rate at which one block moves that stream into its SM,
     measured here (ops/cuda/ar_sampler.stream_probe: bulk copies into
     the kernel's two 64 KB stages and grouped __ldg, the faster), once
     for the standard and speculative cases alike;
  4. spec kernel vs plain: the speculative kernel and its plain version
     give equal (codes, hits) at the same width and n, B=1: greedy exact
     order 3 depth 1, greedy fast o3 d1 (the serve default form), greedy
     fast o2 d2, and T=1.0 parity fast o3 d1 seed 3; the codes equal the
     standard kernel's and the hits equal the utils/spec_sim replay; and
     the same on a hit-rich model (utils/fixtures.train_overfit, trained
     on the card at the fixture's width), where hits must be > 0; each
     case's time per iteration (generated samples less hits) beside the
     standard kernel's step of the same form, and its stream bound: the
     iteration's packed weight stream times the iterations over the
     single-block rate of phase 3;
  5. serve (the main path): ``serve()`` on a flagship checkpoint in a
     temp dir, once with the default options (fast sampler, speculative
     1) and once with the exact sampler; after warmup speculation must be
     "active"; ping, greedy B=1 (one second of audio, on the speculative
     kernel, with spec_commit_ratio), sampled B=8 (standard kernel) and
     wav requests over TCP; exact launch counts per kernel; the codes
     equal a direct standard-kernel cuda_generate call;
  6. generate CLI: ``movenet_tpu_torch.generate.main`` on the same
     checkpoint, greedy, --speculative 1 --spec_depth 2, writes WAVs of
     the requested length with one speculative launch;
  7. video kernel vs plain: a synthetic valid split at the real clip
     format (16 kHz, 16 fps, 10 s, 96x96; 9 clips) made by the port's
     ``make_synthetic_dataset``, through the port's ``DataLoader`` with
     the native preprocessing library built here: (B, 160, 64, 64, 1)
     video and B x 160,000 codes; the video form of the AR kernel and its
     plain version give equal codes at the flagship width (its video
     encoder maps 160 frames to 160,000 samples) for n = RF + 2048:
     greedy B=1 and B=8, exact and fast, and T=1.0 parity B=8 fast seed
     3, prompted and conditioned by the clips; us per step and stream
     bound as in phase 3;
  8. generate CLI with --dataset (the main path of this form): a
     ``use_video`` checkpoint of the same weights; greedy B=8 writes 8
     WAVs of n frames with one ``ar_sampler_ctx_fast`` launch and the
     codes of a direct ``cuda_generate`` on the same batch; B=1 with
     --speculative 1 launches ``ar_sampler_ctx_fast`` once and no
     speculative kernel; B=2 with --fast_sampler 0 launches
     ``ar_sampler_ctx_exact`` once;
  9. train kernels vs plain: at the breakdancing training shapes (layer
     3 x stack 3, C=R=S=64, bf16, B=2, T=160000, video as the stride-10
     projection triple; seeded random weights and data) the trunk
     forward (skip, hsave, tfsg), the trunk backward for a seeded dskip
     (every gradient), the head forward (loss, match, p) and backward
     (dskip, head gradients) each against its plain version, with the
     tolerances stated there, and each kernel's time by CUDA events; the
     trunk backward's device time by grid (torch.profiler): the layer
     launches, the weight-gradient launches, their reductions, the rest;
  9f. float32 (``--compute_dtype float32``): (a) the float32 forms of the
     save trunk (embed form, video triple) and the unpacked head against
     their plain versions (TF32 off) at the breakdancing cell (R=S=C=64),
     experiment 02's CLI widths (S=8), and experiments 03's and 04's
     shapes, T=160000, seeded float32 inputs: forward outputs within 1e-5
     of their scale, gradients within 1e-4, the head's loss within 1e-5
     relative, its match count within 1e-5 of the valid rows, p within
     1e-5; each form's time beside the bf16 form's on the same shapes,
     the breakdancing step in float32 (1 + 5 ``make_train_step`` steps,
     each launching each float32 form once: step ms, peak memory),
     and the float32 backwards' device time by grid at experiment 02's
     shapes (the head's at 03's too);
     (b, after phase 15) the trainer CLI with experiment 02's flags and
     --compute_dtype float32 for 1 epoch of 4 steps on phase 14's clips:
     the save strategy in its embed form, exactly the four float32 forms
     (forwards once a train step and validation batch, backwards once a
     step), finite losses, checkpoint 0 at step 4, update ms and peak
     memory; (c) from checkpoint 0 and the run's first batch, one loss +
     backward through the fused route against the unfused
     ``window_logits`` route in float32 (torch ops, TF32 off): loss within
     1e-5 relative, grad_norm within 1e-4, every leaf within 1e-2 of its
     scale;
  10. train (the main training path): ``make_train_step`` (AdamW, lr 3e-4)
     for 1 warm-up + 5 steps through the kernels, each step launching
     each of the four training kernels once, then the same steps through
     the plain versions from the same weights; the losses are finite and
     agree within 1e-3; step ms (median), steps/s, peak memory;
  11. recompute kernels vs plain: at experiment 02's CLI widths (layer 3
     x stack 3, C=R=64, S=8, bf16, B=2, T=160000, seeded random weights,
     codes and video (2, 160, 64, 64, 1) through the encoder, flat ctx)
     and at the flagship width (layer 10 x stack 3, R=S=64, B=2,
     T=160000, no ctx, seeded random x and weights) the recompute
     forward (skip, layer checkpoints) and backward (dx, dctx, every
     gradient) against their plain versions, with their times; one
     ``fused_train_loss`` loss + backward through the recompute strategy
     against the save strategy (loss and every gradient within the
     tolerance stated there), and each one's peak device memory;
  9g. the flagship trainer in float32: (a, after phase 11) the float32
     recompute forms against their plain versions (TF32 off) at the
     flagship's trunk (L=30, R=S=64, B=2, T=160000, flat ctx) and
     experiment 02's CLI widths (S=8), and the wide float32 head (W2
     through a ring) at (S, C, B) = (64, 256, 2) and (16, 256, 2), seeded
     float32 inputs, within phase 9f's bars; each form's time beside the
     bf16 form's on the same shapes; (b, after phase 16) the trainer CLI
     with the flagship flags and --compute_dtype float32 for 1 epoch of 4
     steps on phase 16's clips: the default strategy resolves to
     recompute, only the float32 recompute forms and the wide float32 head
     run (forwards once a train step and validation batch, backwards once
     a step), finite losses, update ms and peak memory; (c) from
     checkpoint 0 and the run's first batch the fused route against the
     unfused one in float32 within phase 9f's route bars (on one row where
     the unfused route does not fit the card at B=2), each route's peak
     memory;
  12. merged head: at the breakdancing shapes the merged trunk + head
     kernels (stack_kernel.py:464 / :624) against their plain versions on
     the merged loss's own inputs (flat ctx); ``fused_train_loss`` with
     ``merge_head=True`` (the main path of this form: each merged kernel
     launched once, no split-route kernel) against the split route from
     the same weights, loss and every gradient at the tolerances stated
     there; 1 + 5 AdamW steps on each route (per-step losses within
     1e-3); times and peak memory of both routes; the merged
     backward's device time by grid, as phase 9's;
  13. gated block: the gated-block kernels (gated_block.py:91 / :168)
     against their plain versions at R=S=64, B=2, T=160000, bf16, flat
     ctx, d=1 and d=512; the per-block trunk (``_per_block_trunk``, one
     gated block per layer of the breakdancing stack, forward and
     backward: the main path of this form) against the whole-stack save
     trunk's non-embed form on the same inputs; their times;
  14. the trainer CLI (the main path of this form): synthetic train and
     valid splits at the real clip format (8 + 4 clips), then
     ``movenet_tpu_torch.train.cli.main`` with experiment 02's flags and
     --fused_strategy recompute for 1 epoch of 4 steps: the trunk runs
     only the recompute kernels (one forward per train step and validation
     batch, one backward per step), the losses in metrics.jsonl are
     finite, checkpoint 0 holds params, optimizer state and step 4;
  15. resume: the same command with --n_epochs 2 --auto_resume 1 starts
     at epoch 1 and ends at step 8; an uninterrupted 2-epoch run from
     the same seed ends with the same params and optimizer state;
  15b. data parallel: (a) ``python -m movenet_tpu_torch.train.cli`` as a
     subprocess with phase 14's flags and --coordinator_address
     127.0.0.1:<free port> --num_processes 1 --process_id 0: the
     launcher spawns one rank, which trains over NCCL at world size 1
     (its log: the backend, the world size, the mesh, the ranks' params
     equal); its checkpoint after step 4 (params, optimizer state, step)
     equals phase 14's bit for bit; (b) two ranks spawned on this card
     over gloo (NCCL takes no two ranks on one device) through
     ``initialize_distributed`` and ``make_parallel_train_step``, at the
     breakdancing shapes (the fixture's model, a seeded global batch of
     4 rows, T=160000, 2 rows a rank), 1 + 3 steps, against one process
     on all 4 rows: each step's loss and grad_norm within 1e-3 relative
     of the one process's step from the ranks' weights before it, and
     the one process's own 1 + 3 losses within 1e-3 (its grad_norm is
     printed beside), the ranks' metrics and params' digests equal after
     every step, each training kernel launched once a step in each rank
     (their launches count on the kernels line); each rank's step ms and
     the one process's;
  16. flagship trainer CLI: synthetic clips at the real format (8 + 4),
     then the trainer CLI with the flagship widths (layer 10 x stack 3,
     C=256, R=S=64, batch 2, --fused_blocks 1, the default strategy)
     for 1 epoch of 4 steps: the strategy resolves to recompute (only
     the recompute kernels run the trunk), the losses are finite; then
     one loss + backward of the trained model through the save, replay
     and recompute strategies, in bf16 and in float32: each one's peak
     device memory and ms; replay's peak at least REPLAY_SAVING_GB below
     save's; and in each dtype the trained model's trunk on that batch
     (its codes' embedding and its video's projection triple) through
     ``fused_stack`` with save and with replay: the same skip and
     gradients, bit for bit, but for W_fg's in bf16, which replay forms
     from the float32 h as the TPU kernel does: held within phase 23's bar
     of the plain replay's;
  23. the replay strategy: (a, after phase 9g (a)) its kernels in bf16
     and float32 at the flagship's trunk (L=30, R=S=64, B=2, T=160000)
     and experiment 02's (L=9, S=8), with a flat ctx and with the video
     projection triple (the trainer's form): against their plain
     versions within phase 9's bars (bf16) and phase 9f's (float32,
     TF32 off), and against the save kernels' non-embed form from the
     same x bit for bit (the forward's skip and taps, each checkpoint,
     every rebuilt float32 layer input against the checkpoints and,
     rounded, hsave, every gradient but W_fg's in bf16, which takes the
     float32 h and is held to the plain version); each form's time beside
     the save form's and the plain version's, the backward by grid at the
     flagship; ``fused_stack`` through save and replay with autograd at
     the flagship in both ctx forms, the same skip and gradients (W_fg's in
     bf16 within phase 23's bar of the plain replay's)
     (the float32 non-embed save forms' launches); (c, after phase 16) the
     trainer CLI with the flagship flags and --fused_strategy replay for
     4 steps, in bf16 and with --compute_dtype float32: only the replay
     trunk kernels and the head's run, finite losses, update ms and peak
     memory;
  17. packed head: with PACKED_HEAD on, at the breakdancing head shapes
     (B=2, T=160000, S=C=64, bf16 skip, seeded), parity on and off, the
     packed kernels (head_loss.py:169 / :218; split-TF32 tensor cores)
     against their plain versions (loss, equal match, every gradient)
     and loosely against the unpacked kernels; their times beside the
     unpacked pair's on the same inputs, their registers, spills and
     shared memory a block; ``fused_head_loss`` at tgt_off 0 forward +
     backward (the main path of this form) launches each packed kernel
     once and no unpacked one;
  18. wide head: the head kernels at (S, C) = (8, 128) with B=3 and B=2
     (experiments 03 and 04), (16, 256) and the flagship's (64, 256) with
     B=2, T=160000, bf16, against their plain versions;
  19. narrow trunk: the save kernels (embed form, video triple) at
     experiment 03's shapes (B=3, L=4, dilations (1,2,1,2), R=32, S=8,
     V=128) and experiment 04's (B=2, L=14, dilations 1..8192, R=16, S=8,
     V=128), T=160000, forward and backward against their plain versions,
     the backward's device time by grid;
  20. experiments 03 and 04 (the main path of these widths) and 00 and
     01 (the JAX trainer's default unfused route): the trainer CLI with
     the flags of experiments/torch/0[0-4]_*.sh on synthetic clips at the
     real format (30 train + 3 valid), cut only in epochs (2, or 1 for
     00 and 01), steps per epoch (1, 2, 3) and clips; per-update losses
     finite, the LR and beta1 of every update equal to the port's
     schedule at that run's total steps, step ms, peak device memory,
     launch counts (03/04: head kernels at C=128, trunk kernels at the
     new widths, no recompute kernel; 00/01: no training kernel at all);
     00's and 01's updates run again on the CPU from the run's initial
     weights on the batches the card saw: each update's loss and the
     first update's grad_norm within 1e-3 relative (the later grad_norms
     printed beside); experiment 04 cut at the end of epoch 0 and resumed
     equals the uninterrupted run bit for bit (params, optimizer state,
     LR and beta1);
  20b. sequence parallel: two ranks spawned on this card over gloo on a
     (data 1, seq 2) mesh through ``make_parallel_train_step``, each on
     its window of the time axis, with experiment 01's flags at full
     width (B=3, T=160000, video) on the first 1 + 3 batches of its
     loader over phase 20's clips: the ranks' batches equal, their
     metrics and params' digests equal after every step, no training
     kernel launched, and each step's loss and grad_norm within 1e-3
     relative of one process's step on the same rows from the ranks'
     weights before it; each rank's step ms and the one process's;
  21. times: samples/s of the AR kernels and the plain versions (video
     and audio-only side by side), the speculative kernel's time per
     generated sample beside the standard kernel's, the train step and
     kernel times, the merged route's against the split route's, the
     gated block's and the per-block trunk's, the new forms' and the
     experiments' update times and peak memory, the flagship trainer
     step, the sequence-parallel step;
  24. the R = 128 widths (the wide save trunk kernels and the head at S =
     128): (a, after phase 13) the four training kernels at the shapes of
     scripts/probe_r128_mfu.py (utils/fixtures.PROBE_R128: layer 3 x
     stack 3, R=S=128, C=64, bf16, B=2, T=160000, video) and at
     experiment 02's CLI widths at --residual_channels 128 (R=128, S=8)
     against their plain versions at phase 9's bars (the backward with the
     projection triple, and at the probe with the flat ctx too), their
     times and the backward by grid; (b) phase 10's 1 + 5 steps of the
     probe's model through the kernels and plain from one set of weights
     (losses within 1e-3, each kernel launched once a step); (d) greedy
     B=1 generation from the trained probe model through the AR kernel's
     video form, exact and fast, codes equal to the plain version's; (c,
     after phase 23 (c)) the trainer CLI with experiment 02's flags and
     --residual_channels 128 for 3 updates on phase 14's clips: R=128,
     S=8, the save strategy (only the wide save kernels and the head run),
     finite losses, update ms and peak memory;
  25. the recompute and replay strategies at R = 128: (a, after phase 24
     (d)) their four kernels (the wide recompute forward and backward, the
     replay forward and backward at R = 128) at the flagship's depth at R
     = S = 128 (L=30, B=2, T=160000) and at experiment 02's shapes at
     --residual_channels 128 ((128, 8), L=9), each with a flat ctx and
     with the video projection triple, against their plain versions at
     phases 11's and 23's bars, the replay kernels also bit for bit
     against the wide save kernels as in phase 23 (every rebuilt layer
     input against hsave, every gradient but W_fg's in bf16); their times
     by CUDA events and the backwards by grid at the flagship's depth; (b, after phase 24 (c)) the trainer CLI at the
     flagship's depth at R = S = 128 (the flagship flags with
     --residual_channels 128 --skip_channels 128) for 4 steps on phase
     16's clips with no strategy flag (the default resolves recompute:
     only the recompute trunk kernels and the head's run) and with
     --fused_strategy replay (only the replay trunk kernels), finite
     losses, update ms and peak memory, then one loss + backward of the
     trained model through save, replay and recompute for each one's peak
     memory; (c) experiment 02's CLI with --residual_channels 128 --remat
     1 for 3 updates on phase 14's clips: recompute at (128, 8); (d)
     phase 24 (d)'s greedy B=1 generation with video from (b)'s trained
     model, exact and fast, codes equal to the plain version's (the ring
     in 32 KB slabs: two 64 KB stages do not fit there);
  26. float32 training at R = 128: (a, after phase 25 (a)) the float32
     recompute forms at R = 128 (the wide float32 forward's slab walk; the
     backward's taps launches and wide layer launches) at the flagship's
     depth at R = S = 128 and experiment 02's shapes at
     --residual_channels 128, each with a flat ctx and the video
     projection triple's flat form, and the float32 head at (S, C, B) =
     (128, 256, 2) and (128, 64, 2), against their plain versions (TF32
     off) within phase 9g's bars; the backward by grid at the flagship's
     depth; at experiment 02's shapes the rebuilt layer inputs bit for bit
     against the forward's; each form's time beside its bf16 form's and
     the plain version's; (b, after phase 9g (b, c)) the trainer CLI at
     the flagship's depth at R = S = 128 with --compute_dtype float32 for
     4 steps on phase 16's clips (the default strategy resolves
     recompute): exact launches of the float32 recompute and wide head
     forms, finite losses, update ms and peak memory, then the fused
     float32 route against the unfused one from checkpoint 0
     (``f32_routes``, phase 9g (c)'s bars); (c) experiment 02's CLI with
     --compute_dtype float32 --residual_channels 128, then also with
     --skip_channels 128, 3 updates each on phase 14's clips: exact
     launches;
  22. the kernels line (38 entries, every form of the fourteen TPU kernel
     functions, the eight float32 forms, the replay strategy's four,
     phase 25's four at R = 128 and phase 26's four in float32 at R = S =
     128, each with its bound from this run's shapes; the new widths'
     readings under "widths", phase 24's with their launches; the
     speculative rows also with their stream bound), then the whole run's
     seconds, the card line, then the result line.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import base64
import json
import os
import re
import signal
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
N_TRAIN = 5               # timed train steps after one warm-up step
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 and TF32
# tensor-core and float32 (no tensor core) operations/s
HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12
TF32_OPS_S = 495e12
F32_OPS_S = 67e12
TRAIN_KERNELS = {
    "stack_fwd": ("movenet_tpu_torch/csrc/stack_kernel.cu",
                  "movenet_tpu/ops/pallas/stack_kernel.py:280"),
    "stack_bwd": ("movenet_tpu_torch/csrc/stack_kernel.cu",
                  "movenet_tpu/ops/pallas/stack_kernel.py:1486"),
    "head_fwd": ("movenet_tpu_torch/csrc/head_loss.cu",
                 "movenet_tpu/ops/pallas/head_loss.py:281"),
    "head_bwd": ("movenet_tpu_torch/csrc/head_loss.cu",
                 "movenet_tpu/ops/pallas/head_loss.py:336"),
}
TAILS_KERNELS = {
    "stack_fwd_tails": ("movenet_tpu_torch/csrc/stack_kernel.cu",
                        "movenet_tpu/ops/pallas/stack_kernel.py:929"),
    "stack_bwd_tails": ("movenet_tpu_torch/csrc/stack_kernel.cu",
                        "movenet_tpu/ops/pallas/stack_kernel.py:1031"),
}
MERGED_KERNELS = {
    "stack_head_fwd": ("movenet_tpu_torch/csrc/stack_kernel.cu",
                       "movenet_tpu/ops/pallas/stack_kernel.py:464"),
    "stack_head_bwd": ("movenet_tpu_torch/csrc/stack_kernel.cu",
                       "movenet_tpu/ops/pallas/stack_kernel.py:624"),
}
GATED_KERNELS = {
    "gated_block_fwd": ("movenet_tpu_torch/csrc/gated_block.cu",
                        "movenet_tpu/ops/pallas/gated_block.py:91"),
    "gated_block_bwd": ("movenet_tpu_torch/csrc/gated_block.cu",
                        "movenet_tpu/ops/pallas/gated_block.py:168"),
}
# float32 on the card (phase 9f): the save trunk's embed forms and the
# unpacked head in float32, counted apart from the bf16 forms
F32_KERNELS = {f"{k}_f32": v for k, v in TRAIN_KERNELS.items()}
# phase 9f's shapes, T = 160000, video as the stride-10 projection triple:
# (B, dilations, R, S, V = C): the breakdancing cell (bench.py:173-200),
# experiment 02's CLI widths (S = 8) and experiments 03's and 04's
F32_SHAPES = {"exp02": (2, (1, 2, 4) * 3, 64, 8, 64),
              "breakdancing": (2, (1, 2, 4) * 3, 64, 64, 64),
              "exp03": (3, (1, 2, 1, 2), 32, 8, 128),
              "exp04": (2, tuple(2 ** i for i in range(14)), 16, 8, 128)}
# its bars, of each output's largest magnitude (the loss relative, the
# match count of the valid rows): split-TF32 products are float32-accurate
# (tests/test_torch_f32_kernels.py); the plain side runs with TF32 off
F32_BARS = {"fwd": 1e-5, "bwd": 1e-4, "loss": 1e-5, "match": 1e-5,
            "p": 1e-5, "head_bwd": 1e-4}
# phase 9f (c): the fused route against the unfused one in float32 from
# the same weights and batch (tests/test_fused_model.py's leaf bar)
F32_ROUTE_BARS = {"loss": 1e-5, "grad_norm": 1e-4, "leaf": 1e-2}
# the float32 backwards' grids (torch.profiler): phase 9f's trunk
# backward at exp02, its head backward at exp02 and exp03
F32_BWD_GRIDS = (("layer", "stack_bwd_layer_kernel"),
                 ("wgrad W_fg", "stack_wgrad_kernel<4"),
                 ("wgrad W_out", "stack_wgrad_kernel<6"),
                 ("wgrad W_up", "stack_wgrad_kernel<5"),
                 ("table", "stack_embed_grad_kernel"),
                 ("dxc", "stack_proj_dx_kernel"),
                 ("head rows", "head_bwd_f32_kernel"),
                 ("head weight gradients", "head_wgrad_f32_kernel"),
                 ("reductions", "reduce_kernel"))
# phase 9g: the flagship trainer in float32: the recompute kernels' float32
# forms and the wide float32 head (C = 256), counted apart
F32_TAILS_KERNELS = {f"{k}_f32": v for k, v in TAILS_KERNELS.items()}
F32_WIDE_KERNELS = {"head_fwd_f32_wide": TRAIN_KERNELS["head_fwd"],
                    "head_bwd_f32_wide": TRAIN_KERNELS["head_bwd"]}
# its shapes, T = 160000, flat float32 ctx: (B, dilations, R, S), the
# flagship's (layer 10 x stack 3) and experiment 02's CLI widths; the
# head's (S, C, B), the flagship's and experiment 03's S at C = 256
F32_TAILS_SHAPES = {"flagship": (2, tuple(2 ** i for i in range(10)) * 3,
                                 64, 64),
                    "exp02": (2, (1, 2, 4) * 3, 64, 8)}
F32_WIDE_HEADS = ((64, 256, 2), (16, 256, 2))
# the grids of phase 9g's backwards at the flagship's shapes
F32_TAILS_GRIDS = (("rebuild", "stack_layer_f32_kernel"),
                   ("layer", "stack_bwd_layer_kernel"),
                   ("wgrad W_fg", "stack_wgrad_kernel<4"),
                   ("wgrad W_out", "stack_wgrad_kernel<6"),
                   ("dx", "stack_dx_kernel"),
                   ("head rows", "head_bwd_f32_wide_kernel"),
                   ("head weight gradients", "head_wgrad_f32_kernel"),
                   ("reductions", "reduce_kernel"))
# dilations of the gated-block phase: the breakdancing stack's first and
# the flagship stack's largest
GATED_DILATIONS = (1, 512)
# experiment 02 (experiments/02_kinetics_breakdancing.sh) through the CLI:
# its flags, with the CLI's default skip width 8
EXP02_FLAGS = ["--use_video", "1", "--n_epochs", "10", "--batch_size", "2",
               "--learning_rate", "0.0003", "--input_channels", "64",
               "--residual_channels", "64", "--layer_size", "3",
               "--stack_size", "3", "--checkpoint_every", "1",
               "--fused_blocks", "1", "--auto_resume", "1"]
REPLACES = {"ar_sampler_exact": "movenet_tpu/ops/pallas/ar_sampler.py:206",
            "ar_sampler_fast": "movenet_tpu/ops/pallas/ar_sampler.py:206",
            "ar_sampler_ctx_exact":
                "movenet_tpu/ops/pallas/ar_sampler.py:206",
            "ar_sampler_ctx_fast":
                "movenet_tpu/ops/pallas/ar_sampler.py:206",
            "ar_sampler_spec_exact":
                "movenet_tpu/ops/pallas/ar_sampler.py:422",
            "ar_sampler_spec_fast":
                "movenet_tpu/ops/pallas/ar_sampler.py:422"}


class PhaseFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def trainer_cli(argv):
    """``movenet_tpu_torch.train.cli.main(argv)``; fails unless every
    thread its loaders started has ended when it returns (a loader thread
    left copying to the card aborts the interpreter at exit)."""
    from movenet_tpu_torch.train import cli

    before = set(threading.enumerate())
    state = cli.main(argv)
    left = [t.name for t in set(threading.enumerate()) - before
            if t.is_alive()]
    check(not left, f"threads still running after the trainer CLI "
          f"returned: {left}")
    return state


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


def phase_compare(torch, np, model, rf, rate, clips=None):
    """Kernel vs plain on the same inputs; returns per-case records.
    Prompts are seeded random codes, or with ``clips`` (a loader batch
    of 8) the clips' first RF codes, and their video conditions the
    steps.  ``rate`` (GB/s) is the single-block stream rate behind each
    case's stream bound."""
    from movenet_tpu_torch.ops.cuda import ar_sampler as ars

    cases = [("greedy B=1 exact", 1, 0.0, False, 0),
             ("greedy B=1 fast", 1, 0.0, True, 0),
             ("greedy B=8 exact", 8, 0.0, False, 0),
             ("greedy B=8 fast", 8, 0.0, True, 0),
             ("T=1.0 parity B=8 fast", 8, 1.0, True, 3)]
    rng = np.random.default_rng(0)
    records = []
    for label, batch, temp, fast, seed in cases:
        video = None
        if clips is None:
            prompt = rng.integers(0, model.input_channels,
                                  size=(batch, rf))
        else:
            prompt = clips.codes[:batch, :rf]
            video = clips.video[:batch].to("cuda")
            label = f"video {label}"
        inp = ars.prepare(model, prompt, rf + N_COMPARE, temperature=temp,
                          seed=seed, parity_sampling=True, fast=fast,
                          video=video)
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
        nbytes = 4 * ars.pack_stream(inp, 1).numel()
        rec = dict(label=label, name=inp.name, batch=batch, fast=fast,
                   equal=diff.shape[0] == 0, max_abs_err=err,
                   ms=kernel_ms, plain_ms=plain_ms,
                   sps=generated / kernel_ms * 1e3,
                   plain_sps=generated / plain_ms * 1e3,
                   us_per_step=kernel_ms * 1e3 / N_COMPARE,
                   stream_bytes=nbytes,
                   stream_bound_ms=stream_bound_ms(nbytes, N_COMPARE, rate))
        records.append(rec)
        msg = (f"compare {label}: equal={rec['equal']} kernel "
               f"{kernel_ms:.2f} ms ({rec['us_per_step']:.2f} us/step), "
               f"stream bound {rec['stream_bound_ms']:.3f} ms "
               f"({rec['stream_bound_ms'] * 1e3 / N_COMPARE:.2f} us/step: "
               f"{nbytes} bytes x {N_COMPARE} steps / {rate:.1f} GB/s), "
               f"plain {plain_ms:.1f} ms")
        if diff.shape[0]:
            b, i = (int(v) for v in diff[0])
            margin = float(margins[b, i - 1]) if i > 0 else float("nan")
            msg += (f"; first difference at stream {b}, position "
                    f"{rf + i} (kernel {int(got[b, i])}, plain "
                    f"{int(want[b, i])}), plain top-2 margin there "
                    f"{margin:.3g}")
        print(msg, flush=True)
    return records


def spec_case(torch, np, ars, spec_sim, label, inp, order, depth, rate):
    """One speculative kernel-vs-plain case; returns its record.  ``rate``
    (GB/s) is the single-block stream rate behind the stream bound."""
    got, hits = ars.ar_sampler_spec(inp, order, depth)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, want_hits = ars.ar_sampler_spec_plain(inp, order, depth)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    standard = ars.ar_sampler(inp)
    kernel_ms = time_cuda(torch, lambda: ars.ar_sampler_spec(
        inp, order, depth), 3)
    standard_ms = time_cuda(torch, lambda: ars.ar_sampler(inp), 3)
    codes = torch.cat([inp.prompt, got], dim=1)[0].cpu().numpy()
    replay, iters = spec_sim.simulate_spec_hits(
        codes, inp.weights["front_cur"].shape[0], inp.rf, order, depth)
    generated = inp.n_samples - inp.rf
    # each iteration emits one code and one per committed guess
    iters_k = generated - int(hits)
    check(iters_k == iters, f"{label}: {iters_k} iterations against the "
          f"replay's {iters}")
    nbytes = 4 * ars.pack_stream(inp, depth + 1).numel()
    rec = dict(label=label, name=inp.spec_name, batch=1, fast=inp.fast,
               equal=bool(torch.equal(got, want)) and int(hits) == int(
                   want_hits),
               hits=int(hits), plain_hits=int(want_hits), replay=replay,
               equal_standard=bool(torch.equal(got, standard)),
               max_abs_err=int((got.long() - want.long()).abs().max()),
               ms=kernel_ms, plain_ms=plain_ms, standard_ms=standard_ms,
               us_per_sample=kernel_ms * 1e3 / generated,
               standard_us_per_sample=standard_ms * 1e3 / generated,
               steps_per_iter=generated / iters, iters=iters,
               us_per_iter=kernel_ms * 1e3 / iters, stream_bytes=nbytes,
               stream_bound_ms=stream_bound_ms(nbytes, iters, rate))
    print(f"spec {label}: equal={rec['equal']} hits kernel {rec['hits']} "
          f"plain {rec['plain_hits']} replay {replay} "
          f"(x{rec['steps_per_iter']:.3f} steps/iteration), codes == "
          f"standard kernel {rec['equal_standard']}; kernel "
          f"{kernel_ms:.2f} ms ({rec['us_per_sample']:.2f} us/sample), "
          f"standard kernel {standard_ms:.2f} ms "
          f"({rec['standard_us_per_sample']:.2f} us/sample), plain "
          f"{plain_ms:.1f} ms", flush=True)
    print(f"spec {label}: {rec['us_per_iter']:.2f} us per iteration over "
          f"{iters} iterations, {rec['us_per_iter'] / rec['standard_us_per_sample']:.2f}"
          f"x the standard step ({rec['standard_us_per_sample']:.2f} us); "
          f"stream bound {rec['stream_bound_ms']:.3f} ms ({nbytes} bytes x "
          f"{iters} iterations / {rate:.1f} GB/s)", flush=True)
    return rec


def stream_rate(model) -> float:
    """GB/s at which one block moves the flagship's fast stream (depth 1)
    into its SM, the faster of bulk copies into a ring of the kernel's
    stages and grouped __ldg: the rate behind every stream bound."""
    from movenet_tpu_torch.ops.cuda import ar_sampler as ars

    lay = ars.smem_layout(True, 2, model.input_channels,
                          model.residual_channels, model.skip_channels,
                          len(model.dilations))
    nbytes = 4 * ars._stream_index(
        True, 2, tuple(model.dilations), model.residual_channels,
        model.skip_channels, model.input_channels).numel()
    rates = {mode: ars.stream_probe(nbytes, mode, n_stages=lay["n_stages"],
                                    slab_bytes=lay["stage_bytes"])
             for mode in ("bulk copy", "grouped __ldg")}
    print("stream rate of one block: " + ", ".join(
        f"{m} {v:.1f} GB/s" for m, v in rates.items())
        + f" ({nbytes} bytes, {lay['n_stages']} stages of "
        f"{lay['stage_bytes']} bytes)", flush=True)
    return max(rates.values())


def stream_bound_ms(nbytes: int, steps: int, rate: float) -> float:
    """The least time one SM could take to bring a stream of ``nbytes``
    in ``steps`` times at ``rate`` GB/s: the stream bound of an AR launch
    (each of B blocks streams the weights on its own SM, so B does not
    enter while L2 keeps up)."""
    return nbytes * steps / (rate * 1e6)


def phase_spec_compare(torch, np, model, rf, rate):
    """Speculative kernel vs plain, at flagship width and on the card-
    trained fixture; returns per-case records.  ``rate`` as in
    ``phase_compare``."""
    from movenet_tpu_torch.ops.cuda import ar_sampler as ars
    from movenet_tpu_torch.utils import fixtures, spec_sim

    cases = [("greedy exact o3 d1", 0.0, False, 3, 1, 0),
             ("greedy fast o3 d1", 0.0, True, 3, 1, 0),
             ("greedy fast o2 d2", 0.0, True, 2, 2, 0),
             ("T=1.0 parity fast o3 d1", 1.0, True, 3, 1, 3)]
    rng = np.random.default_rng(2)
    records = []
    for label, temp, fast, order, depth, seed in cases:
        prompt = rng.integers(0, model.input_channels, size=(1, rf))
        inp = ars.prepare(model, prompt, rf + N_COMPARE, temperature=temp,
                          seed=seed, parity_sampling=True, fast=fast,
                          speculative=True, spec_order=order,
                          spec_depth=depth)
        records.append(spec_case(torch, np, ars, spec_sim, label, inp,
                                 order, depth, rate))
    # hit-rich: the sine fixture trained on the card
    t0 = time.perf_counter()
    trained, codes = fixtures.train_overfit(
        fixtures.sine_wave(), device="cuda",
        generator=torch.Generator().manual_seed(0))
    print(f"fixture trained on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    frf = trained.receptive_fields
    for depth in (1, 2):
        inp = ars.prepare(trained, codes[None, :frf], frf + N_COMPARE,
                          fast=True, speculative=True, spec_depth=depth)
        rec = spec_case(torch, np, ars, spec_sim,
                        f"trained fixture greedy fast o3 d{depth}", inp, 3,
                        depth, rate)
        check(rec["hits"] > 0, f"{rec['label']}: no guess committed")
        records.append(rec)
    return records


def write_checkpoint(np, mc, model, run_dir, use_video=False):
    from movenet_tpu_torch.config import TrainingConfig
    from movenet_tpu_torch.models.convert import params_to_jax
    from movenet_tpu_torch.train.checkpoint import save_params

    cfg = TrainingConfig(model_config=mc, use_video=use_video,
                         scheduler=None, batch_size=1)
    save_params(run_dir, 0, params_to_jax(model.state_dict()), cfg)


def phase_serve(torch, np, mc, rf, run_dir):
    """The main path: two servers (the default: fast + speculative, and
    exact + speculative), real requests."""
    from movenet_tpu_torch.ops.cuda import ar_sampler as ars
    from movenet_tpu_torch.serve import request, serve
    from movenet_tpu_torch.utils.spec_sim import simulate_spec_hits

    rng = np.random.default_rng(1)
    prompt8 = rng.integers(0, mc.input_channels, size=(8, rf)).tolist()
    services = {}
    replies = {}
    ars.reset_launch_counts()
    for fast in (True, False):
        # serve(): warmup, then the in-process speculative validation
        server = serve(Path(run_dir), port=0, fast=fast, device="cuda")
        svc = server.service
        services[fast] = svc
        state = svc.info()["speculative"]
        check(state == "active",
              f"speculation is {state!r} after warmup (fast={fast})")
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

    # every generate request, warmup and validation included, was one
    # launch: per server the warmup and the validation reference on the
    # standard kernel, the validation run and the B=1 greedy requests on
    # the speculative one, the B=8 sampled request on the standard one
    want_launches = {"ar_sampler_fast": 3, "ar_sampler_spec_fast": 3,
                     "ar_sampler_exact": 3, "ar_sampler_spec_exact": 2,
                     "ar_sampler_ctx_exact": 0, "ar_sampler_ctx_fast": 0}
    check(launches == want_launches,
          f"launch counts of the serve path: {launches}, expected "
          f"{want_launches}")
    for fast in (True, False):
        svc = services[fast]
        ping = replies[(fast, "ping")]
        check(ping.get("ok") and ping["model"]["sampler"] == "cuda"
              and ping["model"]["speculative"] == "active", f"ping: {ping}")
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
            extra = ""
            if key == "greedy":
                check("spec_commit_ratio" in resp,
                      f"greedy (fast={fast}) not served speculatively")
                hits, _ = simulate_spec_hits(got[0], mc.input_channels, rf)
                check(resp["spec_commit_ratio"]
                      == round(hits / N_SERVE, 4),
                      f"spec_commit_ratio {resp['spec_commit_ratio']} vs "
                      f"replay {hits}/{N_SERVE}")
                extra = f", spec_commit_ratio {resp['spec_commit_ratio']}"
            else:
                check("spec_commit_ratio" not in resp,
                      f"{key} (fast={fast}) rode the speculative kernel")
            print(f"serve fast={int(fast)} speculative=1 {key}: "
                  f"B={got.shape[0]} n={got.shape[1]} {resp['ms']} ms, "
                  f"{resp['samples_per_sec']} samples/s{extra}", flush=True)
        if fast:
            wav = replies[(True, "wav")]
            check(len(wav["wav_b64"]) == 1, "wav: one stream expected")
            raw = base64.b64decode(wav["wav_b64"][0])
            check(raw[:4] == b"RIFF" and len(raw) == 44 + 2 * (rf + N_COMPARE),
                  "wav: not a 16-bit mono WAV of the requested length")
            print(f"serve fast=1 wav: {wav['ms']} ms, "
                  f"{wav['samples_per_sec']} samples/s", flush=True)
    return launches


def phase_cli(torch, np, rf, run_dir):
    """The generate CLI, greedy, speculative at depth 2; one launch."""
    import wave

    from movenet_tpu_torch import generate
    from movenet_tpu_torch.ops.cuda import ar_sampler as ars

    n = rf + N_COMPARE
    with tempfile.TemporaryDirectory() as out:
        ars.reset_launch_counts()
        t0 = time.perf_counter()
        written = generate.main([
            "--checkpoint", str(run_dir), "--temperature", "0",
            "--speculative", "1", "--spec_depth", "2", "--n_samples",
            str(n), "--out", out])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(ars.launch_counts)
        wavs = written.get("generated", [])
        check(len(wavs) == 1, f"generate CLI wrote {written}")
        with wave.open(str(wavs[0])) as w:
            frames = w.getnframes()
        check(frames == n, f"generate CLI wav has {frames} frames, not {n}")
    want = {k: 0 for k in launches}
    want["ar_sampler_spec_fast"] = 1
    check(launches == want, f"launch counts of the CLI: {launches}")
    print(f"generate CLI: {n} samples (speculative depth 2) in "
          f"{dt * 1e3:.1f} ms with the checkpoint load, {frames} frames "
          "written", flush=True)
    return launches


def video_clips(torch, np, root, mc):
    """A synthetic valid split at the real clip format through the
    port's DataLoader, with the native preprocessing library built and
    used: the first batch of 8 (CPU tensors)."""
    from movenet_tpu_torch.data import get_dataloader, make_synthetic_dataset
    from movenet_tpu_torch.native import build as native_build
    from movenet_tpu_torch.native import loader

    t0 = time.perf_counter()
    native_build.build()
    check(loader.available(), "the native library did not load")
    make_synthetic_dataset(root, splits=("valid",), clips_per_category=6)
    made = time.perf_counter()
    data = get_dataloader(root, input_channels=mc.input_channels,
                          batch_size=8, train=False, use_video=True,
                          shuffle=False, num_workers=4,
                          max_audio_frames=mc.max_audio_frames,
                          max_video_frames=mc.max_video_frames)
    check(len(data.index) == 9, f"{len(data.index)} valid clips, not 9")
    epoch = data.epoch(0)
    try:
        clips = next(epoch)
    finally:
        epoch.close()
    check(tuple(clips.codes.shape) == (8, mc.max_audio_frames)
          and tuple(clips.video.shape) == (8, mc.max_video_frames, 64, 64, 1),
          f"loader batch codes {tuple(clips.codes.shape)}, video "
          f"{tuple(clips.video.shape)}")
    check(bool(torch.isfinite(clips.video).all())
          and 0 <= int(clips.codes.min()) <= int(clips.codes.max())
          < mc.input_channels, "loader batch out of range")
    print(f"data: 9 clips (16 kHz, 16 fps, 10 s, 96x96) written in "
          f"{made - t0:.1f} s with the native build, first batch of 8 "
          f"loaded in {time.perf_counter() - made:.1f} s: codes "
          f"{tuple(clips.codes.shape)}, video {tuple(clips.video.shape)}",
          flush=True)
    return clips


def phase_dataset_cli(torch, np, mc, model, rf, run_dir, ds):
    """The generate CLI with --dataset on a use_video checkpoint: greedy
    B=8 (fast), B=1 with --speculative 1, B=2 with --fast_sampler 0;
    each one launch of the video kernel; B=8's codes equal a direct
    cuda_generate on the same batch."""
    import wave

    from movenet_tpu_torch import generate
    from movenet_tpu_torch.ops.cuda import ar_sampler as ars
    from movenet_tpu_torch.utils import samples

    n = rf + N_COMPARE
    runs = [("B=8", ["--batch_size", "8"], "ar_sampler_ctx_fast"),
            ("B=1 --speculative 1", ["--batch_size", "1", "--speculative",
                                     "1"], "ar_sampler_ctx_fast"),
            ("B=2 --fast_sampler 0", ["--batch_size", "2", "--fast_sampler",
                                      "0"], "ar_sampler_ctx_exact")]
    total = {k: 0 for k in ars.launch_counts}
    seen = []
    real_export = samples.export_samples

    def spy(out_dir, epoch, split, codes, *a, **kw):
        seen.append(np.asarray(codes["generated"]).copy())
        return real_export(out_dir, epoch, split, codes, *a, **kw)

    samples.export_samples = spy
    try:
        for label, extra, kernel in runs:
            with tempfile.TemporaryDirectory() as out:
                ars.reset_launch_counts()
                t0 = time.perf_counter()
                written = generate.main([
                    "--checkpoint", str(run_dir), "--dataset", str(ds),
                    "--temperature", "0", "--n_samples", str(n), "--out",
                    out, *extra])
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                launches = dict(ars.launch_counts)
                batch = int(extra[1])
                wavs = written.get("generated", [])
                check(len(wavs) == batch,
                      f"generate --dataset {label} wrote {len(wavs)} WAVs")
                for path in wavs:
                    with wave.open(str(path)) as w:
                        check(w.getnframes() == n,
                              f"{path}: {w.getnframes()} frames, not {n}")
            want = {k: 0 for k in launches}
            want[kernel] = 1
            check(launches == want,
                  f"launch counts of generate --dataset {label}: {launches}")
            for k, v in launches.items():
                total[k] += v
            print(f"generate --dataset {label}: {batch} WAVs of {n} frames "
                  f"in {dt * 1e3:.1f} ms with the checkpoint and data "
                  f"load; launches {kernel} x1", flush=True)
    finally:
        samples.export_samples = real_export
    # the B=8 run's codes against a direct call on the same batch
    clips = generate.first_batch(ds, mc, 8, True)
    direct = ars.cuda_generate(model, clips.codes[:, :rf].to("cuda"), n,
                               temperature=0.0, video=clips.video.to("cuda"),
                               fast=True).cpu().numpy()
    check(seen[0].shape == direct.shape and (seen[0] == direct).all(),
          "generate --dataset B=8 codes differ from cuda_generate")
    check((seen[0] >= 0).all() and (seen[0] < mc.input_channels).all(),
          "generate --dataset codes out of range")
    print("generate --dataset B=8: codes equal a direct cuda_generate on "
          "the same clips", flush=True)
    return total


def train_bounds(b, t, l, r, s, c, v, win, proj, act=2, peak=BF16_OPS_S):
    """(bound_ms, bound_by) of each training kernel from its shapes:
    bytes (each input read once, each output written once) over 3.35 TB/s
    against operations over the peak of the units that can run them (bf16
    operands 989 TF/s; the trunk backward's float32 operands on the
    tensor cores, 495 TF/s TF32, counted once: the split passes are the
    design's cost, not the work), the larger.  ``act``: bytes of an
    activation (2, or 4 for the float32 forms, whose every product takes
    float32 operands: ``peak`` TF32 for the forwards too)."""
    m = b * t
    w_bytes = 4 * l * (win * 2 * r + r * (r + s) + b * 2 * r + r + s)
    pack = 4 * t * 3 * b
    ctx = act * m * r
    fwd_bytes = pack + act * 2 * v * r + ctx + w_bytes + act * m * s \
        + act * l * m * r + act * l * m * 2 * r
    fwd_ops = 2 * m * l * (win * 2 * r + r * (r + s))
    bwd_bytes = act * l * m * r + act * l * m * 2 * r + act * m * s + pack \
        + (act * (m // 10) * r * 2 if proj else ctx * 2) + 2 * w_bytes \
        + 4 * 2 * v * r
    bwd_ops = 2 * m * l * ((r + s) * r + 2 * r * win + (win + 1) * 2 * r
                           + (r + 1) * (r + s)) + 2 * m * r
    if proj:
        bwd_ops += 2 * (m // 10) * (r + 1) * 10 * r + 2 * m * r * r
    hw = 4 * (s * c + c * c + 2 * c)
    head_fwd_bytes = act * m * s + pack + hw + 4 * m * c
    head_fwd_ops = 2 * m * (s * c + c * c)
    head_bwd_bytes = act * m * s + pack + 4 * m * c + hw + act * m * s + hw
    head_bwd_ops = 2 * m * (3 * s * c + 2 * c * c)

    def bound(nbytes, ops, peak):
        tb, to = nbytes / HBM_BYTES_S * 1e3, ops / peak * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    return {"stack_fwd": bound(fwd_bytes, fwd_ops, peak),
            "stack_bwd": bound(bwd_bytes, bwd_ops, TF32_OPS_S),
            "head_fwd": bound(head_fwd_bytes, head_fwd_ops, peak),
            "head_bwd": bound(head_bwd_bytes, head_bwd_ops, peak)}


def tails_bounds(b, t, l, r, s, win, every, act=2):
    """(bound_ms, bound_by) of the recompute kernels: the forward reads x
    and ctx and writes skip and the layer checkpoints; the backward reads
    x, the checkpoints, ctx and dskip and writes dx, dctx and the
    gradients.  Operations: the forward's products on bf16 operands at
    989 TF/s; the backward's bf16 products (the rebuilt layers, L -
    ceil(L/every), and fg of every layer) at 989 TF/s plus its gradient
    products on float32 operands on the tensor cores at the TF32 peak,
    counted once, as for the save backward.  ``act``: bytes of an
    activation (4 for the float32 forms, whose every product takes
    float32 operands: all at the TF32 peak, counted once)."""
    m = b * t
    w_bytes = 4 * l * (win * 2 * r + r * (r + s) + b * 2 * r + r + s)
    ctx = act * m * r if win == 3 * r else 0
    ckpt = act * m * r * len(range(every, l, every))
    grads = 4 * l * (win * 2 * r + r * (r + s) + r + s + b * 2 * r)
    fwd_bytes = act * m * r + ctx + w_bytes + act * m * s + ckpt
    bwd_bytes = act * m * r + ckpt + ctx + act * m * s + w_bytes \
        + act * m * r + ctx + grads
    layer_ops = 2 * m * (win * 2 * r + r * (r + s))
    fwd_ops = l * layer_ops
    rebuilt = l - len(range(0, l, every))
    bf16_ops = rebuilt * layer_ops + l * 2 * m * win * 2 * r
    grad_ops = 2 * m * l * ((r + s) * r + 2 * r * win + win * 2 * r
                            + r * (r + s))

    def bound(nbytes, ops_ms):
        tb = nbytes / HBM_BYTES_S * 1e3
        return (tb, "bytes") if tb >= ops_ms else (ops_ms, "operations")

    low = TF32_OPS_S if act == 4 else BF16_OPS_S
    return {"stack_fwd_tails": bound(fwd_bytes, fwd_ops / low * 1e3),
            "stack_bwd_tails": bound(bwd_bytes, (bf16_ops / low
                                                 + grad_ops / TF32_OPS_S)
                                     * 1e3)}


def merged_bounds(b, t, l, r, s, c, win):
    """(bound_ms, bound_by) of the merged kernels: the save trunk's bytes
    from x (hsave, tfsg, skip written; x, ctx, weights, targets read) and
    the head's; operations: the trunk's and the head's products on bf16
    operands (989 TF/s) forward; backward the head's rebuild on bf16, its
    gradient products on float32 (67 TF/s: its kernel keeps fmaf) and the
    layer sweep's on the tensor cores (495 TF/s TF32, as train_bounds)."""
    m = b * t
    w_bytes = 4 * l * (win * 2 * r + r * (r + s) + b * 2 * r + r + s)
    hw = 4 * (s * c + c * c + 2 * c)
    ctx = 2 * m * r if win == 3 * r else 0
    saved = 2 * l * m * r + 2 * l * m * 2 * r + 2 * m * s
    fwd_bytes = 2 * m * r + ctx + w_bytes + hw + 4 * m + saved
    bwd_bytes = saved + ctx + 4 * m + w_bytes + hw + 2 * m * r + ctx \
        + w_bytes + hw
    head_ops = 2 * m * (s * c + c * c)
    fwd_ops = 2 * m * l * (win * 2 * r + r * (r + s)) + head_ops
    head_f32 = 2 * m * (2 * c * c + 2 * s * c)
    sweep = 2 * m * l * (
        (r + s) * r + 2 * r * win + (win + 1) * 2 * r + (r + 1) * (r + s))

    def bound(nbytes, ops_ms):
        tb = nbytes / HBM_BYTES_S * 1e3
        return (tb, "bytes") if tb >= ops_ms else (ops_ms, "operations")

    return {"stack_head_fwd": bound(fwd_bytes, fwd_ops / BF16_OPS_S * 1e3),
            "stack_head_bwd": bound(bwd_bytes, (head_ops / BF16_OPS_S
                                                + head_f32 / F32_OPS_S
                                                + sweep / TF32_OPS_S) * 1e3)}


def gated_bounds(b, t, r, s, win):
    """(bound_ms, bound_by) of one gated block: h, ctx and the weights
    read, res and skip written (backward: dres, dskip read too, dh, dctx
    and the gradients written); every product on float32 operands on the
    tensor cores, at the TF32 peak counted once (the split passes are the
    design's cost, not the work), as train_bounds counts the save
    backward's."""
    m = b * t
    w_bytes = 4 * (win * 2 * r + r * (r + s) + b * 2 * r + r + s)
    ctx = 2 * m * r if win == 3 * r else 0
    fwd_bytes = 2 * m * r + ctx + w_bytes + 2 * m * r + 2 * m * s
    bwd_bytes = 2 * m * r + ctx + w_bytes + 2 * m * r + 2 * m * s \
        + 2 * m * r + ctx + w_bytes
    fwd_ops = 2 * m * (win * 2 * r + r * (r + s))
    bwd_ops = 2 * m * (2 * win * 2 * r + 2 * r * (r + s) + 2 * r * win)

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_S * 1e3, ops / TF32_OPS_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    return {"gated_block_fwd": bound(fwd_bytes, fwd_ops),
            "gated_block_bwd": bound(bwd_bytes, bwd_ops)}


def ar_bound(model, batch, steps, video=False):
    """(bound_ms, bound_by) of one AR sampler launch on the whole card:
    the weights read once (with video W_ctx too, and the context rows of
    every step) against the float32 operations of every step.  Each
    record's ``stream_bound_ms`` (``stream_bound_ms``) is the one-SM
    bound of the standard and speculative forms alike, beside it in the
    kernels line."""
    r, s, c = (model.residual_channels, model.skip_channels,
               model.input_channels)
    n_layers = len(model.dilations)
    nbytes = 4 * (2 * c * r + n_layers * (2 * r * 2 * r + r * (r + s))
                  + s * c + c * c)
    ops = 2 * batch * steps * (n_layers * (4 * r * r + r * (r + s))
                               + s * c + c * c)
    if video:
        nbytes += 4 * n_layers * r * 2 * r + 4 * batch * steps * r
        ops += 2 * batch * steps * n_layers * r * 2 * r
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / F32_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def kernel_name(mangled: str) -> str:
    """name<template ints> of a mangled kernel name, far enough to read
    (the mangled name where it does not parse)."""
    if not mangled.startswith("_Z"):
        return mangled
    i = 3 if mangled.startswith("_ZN") else 2
    name = ""
    while True:   # the nested names (namespaces, then the kernel's)
        m = re.match(r"\d+", mangled[i:])
        if not m:
            break
        n = int(m.group())
        i += m.end()
        name, i = mangled[i:i + n], i + n
    if not name:
        return mangled
    rest = mangled[i:]
    args = re.match(r"I((?:L[ib]n?\d+E)+)E", rest)
    if args:
        name += "<" + ",".join(re.findall(r"L[ib](n?\d+)E",
                                          args.group(1))) + ">"
    return name.replace("<n", "<-").replace(",n", ",-")


def ptxas_report(log: str):
    """[(kernel, what ptxas says of it)]: its registers and spills from an
    nvcc -Xptxas -v log."""
    info = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            cur = m.group(1)
            info.setdefault(cur, [])
        elif cur and ("registers" in line or "spill" in line):
            info[cur].append(line.split("info    :")[-1].strip())
    return [(kernel_name(k), "; ".join(v)) for k, v in info.items() if v]


def bwd_smem_note(lib, kernel: str) -> str:
    """The dynamic shared memory of a trunk kernel instance (the layer
    forward stack_layer_kernel<R,S,FORM> and its float32 form
    stack_layer_f32_kernel<R,S>; stack_bwd_layer_kernel<R,S,FORM> at win =
    3R, FORM 0 save, 1 recompute, 2 float32, 3 float32 recompute; the
    replay backward's
    stack_rebuild_kernel<R>; stack_wgrad_kernel<MODE,R,S,KA>), from the
    library's own sizes; "" for another kernel."""
    m = re.match(r"stack_layer_kernel<(\d+),(\d+),(\d)>$", kernel)
    if m:
        r, s_, form = (int(x) for x in m.groups())
        return (f"; dynamic shared memory "
                f"{lib.movenet_stack_layer_smem(r, s_, form)} bytes")
    m = re.match(r"stack_layer(?:_wg)?_f32_kernel<(\d+),(\d+)>$", kernel)
    if m:
        r, s_ = (int(x) for x in m.groups())
        return (f"; dynamic shared memory "
                f"{lib.movenet_stack_layer_smem(r, s_, 3)} bytes")
    m = re.match(r"stack_bwd_layer_kernel<(\d+),(\d+),([0-3])>$", kernel)
    if m:
        r, s_, form = (int(x) for x in m.groups())
        return (f"; dynamic shared memory "
                f"{lib.movenet_stack_bwd_smem(r, s_, 3 * r, -1 - form)}"
                f" bytes (win = 3R)")
    m = re.match(r"stack_bwd_wg_kernel<(\d+),(\d+),\d,([0-3])>$", kernel)
    if m:
        r, s_, form = (int(x) for x in m.groups())
        return (f"; dynamic shared memory "
                f"{lib.movenet_stack_bwd_smem(r, s_, 3 * r, -1 - form)}"
                " bytes")
    m = re.match(r"stack_wgrad_wg_kernel<([07]),(\d+),(\d+),(\d+)>$", kernel)
    if m:
        mode, r, s_, ka = (int(x) for x in m.groups())
        return (f"; dynamic shared memory "
                f"{lib.movenet_stack_bwd_smem(r, s_, ka, mode)} bytes")
    m = re.match(r"stack_rebuild_kernel<(\d+)>$", kernel)
    if m:
        r = int(m.group(1))
        return (f"; dynamic shared memory "
                f"{lib.movenet_stack_bwd_smem(r, r, 3 * r, -5)} bytes")
    m = re.match(r"stack_wgrad_kernel<(\d),(\d+),(\d+),(\d+)>$", kernel)
    if m:
        mode, r, s_, ka = (int(x) for x in m.groups())
        win = ka if mode in (0, 4, 7) else 3 * r
        return (f"; dynamic shared memory "
                f"{lib.movenet_stack_bwd_smem(r, s_, win, mode)} bytes")
    return ""


def ring_smem_report() -> None:
    """The dynamic shared memory of the eight AR kernel instantiations at
    the flagship width: the wrapper's layout, its fixed part checked
    against the kernel library's own size."""
    from movenet_tpu_torch.ops.cuda import ar_sampler as ars

    lib = ars._kernel_lib()
    n_layers = FLAGSHIP["layer_size"] * FLAGSHIP["stack_size"]
    c, r, s = (FLAGSHIP[k] for k in ("input_channels", "residual_channels",
                                     "skip_channels"))
    forms = [(depth, video) for depth in (0, 1, 2)
             for video in ((False, True) if depth == 0 else (False,))]
    for fast in (False, True):
        for depth, video in forms:
            lay = ars.smem_layout(fast, depth + 1, c, r, s, n_layers, video)
            fixed = lib.movenet_ar_ring_fixed_bytes(depth, int(video), c, r,
                                                    s, n_layers)
            check(fixed == lay["fixed"],
                  f"AR kernel shared memory: kernel {fixed}, wrapper "
                  f"{lay['fixed']} bytes")
            print(f"  ar_sampler_kernel<{int(fast)},{depth + 1},{int(video)}>:"
                  f" dynamic shared memory {lay['total']} bytes at the "
                  f"flagship width ({lay['n_stages']} stages of "
                  f"{lay['stage_bytes']} bytes + {fixed} for the chains, "
                  f"biases and tables)")


def wgmma_sass_report(path) -> None:
    """The wgmma kernels' HGMMA (wgmma) and HMMA (mma.sync) instructions in
    the built library's SASS: the wide float32 recompute kernels (kernel A,
    2 instances; kernel B, stack_bwd_wg_kernel's float32 form, 4), the wide
    bf16 layer backwards (its forms 0 and 1, 8) and W_fg's gradient on
    wgmma (modes 0 and 7, 8): each issues wgmma, and no wide mma.sync layer
    backward nor R = 128 mma.sync W_fg gradient (modes 0, 7) is built."""
    from movenet_tpu_torch.utils.time_stack_bwd import sass_counts

    counts = {kernel_name(k): v for k, v in sass_counts(path).items()}
    wide = {k: v for k, v in counts.items()
            if re.match(r"stack_(layer_wg_f32|bwd_wg|wgrad_wg)_kernel<", k)}
    for kernel, (hg, hm, loc) in sorted(wide.items()):
        print(f"  sass {kernel}: {hg} HGMMA, {hm} HMMA, {loc} local-memory "
              "instructions", flush=True)
    check(len(wide) == 22 and all(v[0] > 0 for v in wide.values()),
          f"the wgmma kernels' SASS: {wide}")
    old = [k for k in counts
           if re.match(r"stack_bwd_layer_kernel<128,|"
                       r"stack_wgrad_kernel<[07],128,", k)]
    check(not old, f"the old wide mma.sync kernels are built: {old}")


def grid_line(label: str, by: dict) -> str:
    total = sum(by.values())
    if total <= 0:
        return f"{label} by grid: not measured (no device time in the trace)"
    parts = ", ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
                      for k, v in by.items() if v > 0)
    return (f"{label} by grid (torch.profiler, one call): {parts}; device "
            f"total {total:.3f} ms")


def _err(got, want):
    return float((got.float() - want.float()).abs().max())


def _scale(want):
    return float(want.float().abs().max())


def phase_train_kernels(torch, np, cfg, model, batch, tag="breakdancing"):
    """Each training kernel against its plain version on the card, at
    the breakdancing shapes (or ``tag``'s: the probe's, phase 24), and its
    time; returns records by kernel."""
    from movenet_tpu_torch.models import fused
    from movenet_tpu_torch.ops import head_loss as hl
    from movenet_tpu_torch.ops import stack_kernel as sk
    from movenet_tpu_torch.ops.cuda import head_loss as kh
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks
    from movenet_tpu_torch.utils.time_stack_bwd import FWD_GRIDS, by_grid

    b, t = batch.codes.shape
    dil = tuple(model.dilations)
    with torch.no_grad():
        ctx, (b_fg, w_fg, w_out, b_out) = fused._prepare_trunk(
            model, batch.codes, batch.video, None)
        check(sk.ctx_is_proj(ctx), "breakdancing ctx is not the projection "
              "triple")
        proj = sk._ctx_proj_args(ctx)
        ctx_flat = sk.ctx_flatten(ctx, torch.bfloat16)
        pack = fused._codes_pack(batch.codes, True)
        table2 = torch.cat([model.front_cur, model.front_past],
                           0).to(torch.bfloat16)
        fargs = (pack, table2, ctx_flat, b_fg, w_fg, w_out, b_out, dil, b)
        rec = {}
        # stack forward; tolerance: bf16 outputs whose float32 sums differ
        # in order may sit one bf16 step apart: 2% of each output's scale
        # (the bit-equal share is printed)
        got = ks.stack_fwd(*fargs)
        want = sk.stack_fwd_plain(*fargs)
        errs, equal = {}, {}
        for name, x, y in zip(("skip", "hsave", "tfsg"), got, want):
            errs[name] = _err(x, y)
            equal[name] = float((x == y).float().mean())
            check(errs[name] <= 2e-2 * _scale(y),
                  f"stack_fwd {name}: max err {errs[name]:.3g}, scale "
                  f"{_scale(y):.3g}")
        del got

        def fwd():
            return ks.run_fwd(ks.library(), *fargs, ks._stream(table2))

        rec["stack_fwd"] = dict(
            max_abs_err=max(errs.values()), errs=errs, equal=equal,
            ms=time_cuda(torch, fwd, 5),
            plain_ms=time_cuda(torch, lambda: sk.stack_fwd_plain(*fargs),
                                 2),
            by_grid=by_grid(torch, fwd, FWD_GRIDS))
        print(grid_line(f"train kernel stack_fwd ({tag})",
                        rec["stack_fwd"]["by_grid"]), flush=True)
        # stack backward from the plain forward's saved tensors and a
        # seeded dskip; float32 sums over 320000 rows in other orders:
        # 1e-3 of each gradient's scale, dxc (bf16) 2%
        skip, hsave, tfsg = want
        g = torch.Generator(device="cuda").manual_seed(5)
        dskip = (torch.randn(skip.shape, generator=g, device="cuda")
                 * 1e-3).to(torch.bfloat16)
        bargs = (hsave, tfsg, ctx_flat, w_fg, w_out, dskip, pack, 64, dil,
                 proj)
        got = ks.stack_bwd(*bargs)
        want = sk.stack_bwd_plain(*bargs)
        errs = {}
        for name, x, y in zip(("dtab", "dxc", "db_fg", "dw_fg", "dw_out",
                               "db_out", "dwup_aug"), got, want):
            errs[name] = _err(x, y)
            tol = (2e-2 if name == "dxc" else 1e-3) * _scale(y)
            check(errs[name] <= tol, f"stack_bwd {name}: max err "
                  f"{errs[name]:.3g}, scale {_scale(y):.3g}")
        rec["stack_bwd"] = dict(
            max_abs_err=max(errs.values()), errs=errs,
            ms=time_cuda(torch, lambda: ks.run_bwd(
                ks.library(), *bargs, stream=ks._stream(tfsg)), 5),
            plain_ms=time_cuda(torch, lambda: sk.stack_bwd_plain(*bargs),
                                 2),
            by_grid=by_grid(torch, lambda: ks.run_bwd(
                ks.library(), *bargs, stream=ks._stream(tfsg))))
        print(grid_line(f"train kernel stack_bwd ({tag})",
                        rec["stack_bwd"]["by_grid"]), flush=True)
        # head forward and backward on the kernel's skip sum; loss rtol
        # 1e-4 (float32 sums of 320000 rows), matches within 10 rows
        # (first-argmax ties of z within float32 noise), p 2e-4 (the bf16
        # operand leaky(y) may round one step apart), the gradients 1e-3
        # of their scale, dskip (bf16) 1%
        skip = got_skip = ks.stack_fwd(*fargs)[0]
        rf = model.receptive_fields
        hargs = (got_skip, pack, model.head1.kernel, model.head1.bias,
                 model.head2.kernel, model.head2.bias, rf, True, 2 * b)
        loss, match, p = kh.head_fwd(*hargs)
        wl, wm, wp = hl.head_fwd_plain(*hargs)
        check(abs(float(loss) - float(wl)) <= 1e-4 * abs(float(wl)),
              f"head_fwd loss {float(loss)} vs plain {float(wl)}")
        check(abs(float(match) - float(wm)) <= 10,
              f"head_fwd match {float(match)} vs plain {float(wm)}")
        errs = {"loss": abs(float(loss) - float(wl)),
                "match": abs(float(match) - float(wm)),
                "p": _err(p, wp)}
        check(errs["p"] <= 2e-4, f"head_fwd p: max err {errs['p']:.3g}")
        rec["head_fwd"] = dict(
            max_abs_err=errs["p"], errs=errs,
            ms=time_cuda(torch, lambda: kh.run_fwd(
                kh.library(), *hargs, stream=kh._stream(skip)), 5),
            plain_ms=time_cuda(torch, lambda: hl.head_fwd_plain(*hargs),
                                 2))
        dloss = torch.tensor(1.0 / (b * (t - rf)), device="cuda")
        hb = (got_skip, pack, wp, model.head1.kernel, model.head1.bias,
              model.head2.kernel, model.head2.bias, rf, True, dloss, 2 * b)
        got = kh.head_bwd(*hb)
        want = hl.head_bwd_plain(*hb)
        errs = {}
        for name, x, y in zip(("dskip", "dw1", "db1", "dw2", "db2"), got,
                              want):
            errs[name] = _err(x, y)
            tol = (1e-2 if name == "dskip" else 1e-3) * _scale(y)
            check(errs[name] <= tol, f"head_bwd {name}: max err "
                  f"{errs[name]:.3g}, scale {_scale(y):.3g}")
        rec["head_bwd"] = dict(
            max_abs_err=max(errs.values()), errs=errs,
            ms=time_cuda(torch, lambda: kh.run_bwd(
                kh.library(), *hb, stream=kh._stream(skip)), 5),
            plain_ms=time_cuda(torch, lambda: hl.head_bwd_plain(*hb), 2))
    for name, r in rec.items():
        errs = ", ".join(f"{k} {v:.3g}" for k, v in r["errs"].items())
        if "equal" in r:
            errs += "; bit-equal share " + ", ".join(
                f"{k} {v:.6f}" for k, v in r["equal"].items())
        print(f"train kernel {name} ({tag}) vs plain: {errs}; kernel "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms", flush=True)
    return rec


class plain_versions:
    """Within the block the trunk and head ops call their plain versions
    on CUDA tensors too (the library itself never does): the reference
    run of the train phase."""

    def __enter__(self):
        from movenet_tpu_torch.ops import head_loss as hl
        from movenet_tpu_torch.ops import stack_kernel as sk
        from movenet_tpu_torch.ops.cuda import head_loss as kh
        from movenet_tpu_torch.ops.cuda import stack_kernel as ks

        self.saved = [(ks, "stack_fwd", ks.stack_fwd),
                      (ks, "stack_bwd", ks.stack_bwd),
                      (kh, "head_fwd", kh.head_fwd),
                      (kh, "head_bwd", kh.head_bwd)]
        ks.stack_fwd = sk.stack_fwd_plain
        ks.stack_bwd = sk.stack_bwd_plain
        kh.head_fwd = hl.head_fwd_plain
        kh.head_bwd = hl.head_bwd_plain
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def phase_train(torch, np, cfg, model, batch, tag="train"):
    """The main training path: make_train_step on the card through the
    kernels (1 warm-up + N_TRAIN timed steps), then the same steps through
    the plain versions from the same weights (the kernels' model is left
    trained)."""
    import copy

    from movenet_tpu_torch.ops.cuda import head_loss as kh
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks
    from movenet_tpu_torch.train import create_train_state, make_train_step

    plain_model = copy.deepcopy(model)
    runs = {}
    launches = {k: 0 for k in TRAIN_KERNELS}
    for label, m in (("kernels", model), ("plain", plain_model)):
        state = create_train_state(m, cfg, device="cuda")
        step = make_train_step(m, cfg)
        losses, times = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(N_TRAIN + 1):
            ks.reset_launch_counts()
            kh.reset_launch_counts()
            t0 = time.perf_counter()
            if label == "plain":
                with plain_versions():
                    state, metrics = step(state, batch)
            else:
                state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            counts = {**ks.launch_counts, **kh.launch_counts}
            if label == "kernels":
                check(all(counts[k] == 1 for k in TRAIN_KERNELS),
                      f"train step {i}: kernel launches {counts}")
                for k in TRAIN_KERNELS:
                    launches[k] += counts[k]
            else:
                check(all(counts[k] == 0 for k in TRAIN_KERNELS),
                      f"plain step {i} launched kernels: {counts}")
            loss = float(metrics["loss"])
            check(np.isfinite(loss) and np.isfinite(
                float(metrics["grad_norm"])), f"{label} step {i}: "
                f"loss {loss}, grad_norm {float(metrics['grad_norm'])}")
            losses.append(loss)
            print(f"{tag} {label} step {i}: loss {loss:.6f} accuracy "
                  f"{float(metrics['accuracy']):.6f} grad_norm "
                  f"{float(metrics['grad_norm']):.6g}; {times[-1]:.2f} ms; "
                  f"launches {counts}", flush=True)
        runs[label] = dict(losses=losses,
                           step_ms=float(np.median(times[1:])),
                           peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    # tolerance: the two runs round the same bf16 forward in different
    # orders and their updates drift apart by Adam steps of lr: 1e-3
    for i, (a, w) in enumerate(zip(runs["kernels"]["losses"],
                                   runs["plain"]["losses"])):
        check(abs(a - w) <= 1e-3 * abs(w),
              f"train step {i}: kernel loss {a} vs plain {w}")
    k, p = runs["kernels"], runs["plain"]
    print(f"{tag}: step {k['step_ms']:.2f} ms (median of {N_TRAIN} after "
          f"warm-up), {1e3 / k['step_ms']:.3f} steps/s, plain step "
          f"{p['step_ms']:.2f} ms; peak memory {k['peak_gb']:.2f} GB "
          f"(plain {p['peak_gb']:.2f} GB)", flush=True)
    return runs, launches


def phase_f32_kernels(torch, np):
    """Phase 9f (a): the float32 forms of the save trunk (embed form,
    video triple) and the unpacked head against their plain versions (TF32
    off) at F32_SHAPES, seeded random float32 inputs (not bf16 values),
    within F32_BARS; each form's time by CUDA events beside the bf16
    form's on the same shapes (the inputs rounded to bf16) and the plain
    version's.  Returns records by (name, shape)."""
    from movenet_tpu_torch.ops import head_loss as hl
    from movenet_tpu_torch.ops import stack_kernel as sk
    from movenet_tpu_torch.ops.cuda import head_loss as kh
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks
    from movenet_tpu_torch.utils.time_stack_bwd import by_grid

    t, f32, bf = 160_000, torch.float32, torch.bfloat16
    rec = {}
    for label, (b, dil, r, s, v) in F32_SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(100 * len(dil) + r + s)
        n, win, c = len(dil), 3 * r, v

        def rn(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device="cuda") * scale

        codes = torch.randint(0, v, (b, t), generator=g, device="cuda",
                              dtype=torch.int32)
        prev = torch.cat([torch.full_like(codes[:, :1], -1), codes[:, :-1]],
                         1)
        pack = torch.cat([codes, prev, torch.roll(codes, -1, 1)],
                         0).t().contiguous()
        trip = (rn(b, t // 10, r, scale=0.5), rn(r, 10 * r, scale=r ** -0.5),
                rn(10 * r, scale=0.1))
        with torch.no_grad():
            ctx = sk.ctx_flatten(trip, f32)
            proj = sk._ctx_proj_args(trip)
            fargs = (pack, rn(2 * v, r, scale=0.5), ctx,
                     rn(n * b, 2 * r, scale=0.1),
                     rn(n, win, 2 * r, scale=win ** -0.5),
                     rn(n, r, r + s, scale=r ** -0.5),
                     rn(n, r + s, scale=0.1), dil, b)
            lib, st = ks.library(), ks._stream(pack)
            got, want = ks.stack_fwd(*fargs), sk.stack_fwd_plain(*fargs)
            errs = {}
            for name, x, y in zip(("skip", "hsave", "tfsg"), got, want):
                check(x.dtype == f32, f"stack_fwd_f32 {label} {name} is "
                      f"{x.dtype}")
                errs[name] = _err(x, y)
                check(errs[name] <= F32_BARS["fwd"] * _scale(y),
                      f"stack_fwd_f32 {label} {name}: max err "
                      f"{errs[name]:.3g}, scale {_scale(y):.3g}")
            skip = got[0]
            del got
            bfa = (pack, fargs[1].to(bf), ctx.to(bf), *fargs[3:])
            rec[("stack_fwd_f32", label)] = dict(
                errs=errs, max_abs_err=max(errs.values()),
                ms=time_cuda(torch, lambda: ks.run_fwd(lib, *fargs, st), 3),
                bf16_ms=time_cuda(torch, lambda: ks.run_fwd(lib, *bfa, st),
                                  3),
                plain_ms=time_cuda(torch, lambda: sk.stack_fwd_plain(*fargs),
                                   1))
            del bfa
            _, hsave, tfsg = want
            del want
            dskip = rn(b, t, s, scale=1e-3)
            bargs = (hsave, tfsg, ctx, fargs[4], fargs[5], dskip, pack, v,
                     dil, proj)
            got, want = ks.stack_bwd(*bargs), sk.stack_bwd_plain(*bargs)
            errs = {}
            for name, x, y in zip(("dtab", "dxc", "db_fg", "dw_fg",
                                   "dw_out", "db_out", "dwup_aug"), got,
                                  want):
                check(x.dtype == f32, f"stack_bwd_f32 {label} {name} is "
                      f"{x.dtype}")
                errs[name] = _err(x, y)
                check(errs[name] <= F32_BARS["bwd"] * _scale(y),
                      f"stack_bwd_f32 {label} {name}: max err "
                      f"{errs[name]:.3g}, scale {_scale(y):.3g}")
            del got, want
            bfb = (hsave.to(bf), tfsg.to(bf), ctx.to(bf), fargs[4],
                   fargs[5], dskip.to(bf), pack, v, dil,
                   (trip[0].to(bf), proj[1]))
            rec[("stack_bwd_f32", label)] = dict(
                errs=errs, max_abs_err=max(errs.values()),
                ms=time_cuda(torch, lambda: ks.run_bwd(lib, *bargs,
                                                       stream=st), 3),
                bf16_ms=time_cuda(torch, lambda: ks.run_bwd(lib, *bfb,
                                                            stream=st), 3),
                plain_ms=time_cuda(torch, lambda: sk.stack_bwd_plain(*bargs),
                                   1))
            if label == "exp02":
                print(grid_line("f32 kernel stack_bwd_f32 exp02", by_grid(
                    torch, lambda: ks.run_bwd(lib, *bargs, stream=st),
                    F32_BWD_GRIDS)), flush=True)
            del hsave, tfsg, bargs, bfb
            # the head on the kernel's skip sum
            rf = sum(dil) + 2
            n_valid = b * (t - rf)
            hargs = (skip, pack, rn(s, c, scale=0.25), rn(c, scale=0.1),
                     rn(c, c, scale=2.5 / c ** 0.5), rn(c, scale=0.1), rf,
                     True, 2 * b)
            hlib, hst = kh.library(), kh._stream(skip)
            loss, match, p = kh.head_fwd(*hargs)
            wl, wm, wp = hl.head_fwd_plain(*hargs)
            errs = {"loss": abs(float(loss) - float(wl)) / abs(float(wl)),
                    "match": abs(float(match) - float(wm)),
                    "p": _err(p, wp)}
            check(errs["loss"] <= F32_BARS["loss"],
                  f"head_fwd_f32 {label}: loss {float(loss)} vs plain "
                  f"{float(wl)}")
            check(errs["match"] <= F32_BARS["match"] * n_valid,
                  f"head_fwd_f32 {label}: match {float(match)} vs plain "
                  f"{float(wm)} of {n_valid} rows")
            check(errs["p"] <= F32_BARS["p"], f"head_fwd_f32 {label}: p max "
                  f"err {errs['p']:.3g}")
            bfh = (skip.to(bf), *hargs[1:])
            rec[("head_fwd_f32", label)] = dict(
                errs=errs, max_abs_err=errs["p"],
                ms=time_cuda(torch, lambda: kh.run_fwd(hlib, *hargs,
                                                       stream=hst), 3),
                bf16_ms=time_cuda(torch, lambda: kh.run_fwd(hlib, *bfh,
                                                            stream=hst), 3),
                plain_ms=time_cuda(torch, lambda: hl.head_fwd_plain(*hargs),
                                   1))
            dloss = torch.tensor(1.0 / n_valid, device="cuda")
            hb = (skip, pack, wp, *hargs[2:6], rf, True, dloss, 2 * b)
            bar = F32_BARS["head_bwd"]
            errs = _check_grads(f"head_bwd_f32 {label}", kh.head_bwd(*hb),
                                hl.head_bwd_plain(*hb),
                                dict(dskip=bar, dw1=bar, db1=bar, dw2=bar,
                                     db2=bar))
            bfhb = (skip.to(bf), pack, wp, *hargs[2:6], rf, True, dloss,
                    2 * b)
            rec[("head_bwd_f32", label)] = dict(
                errs=errs, max_abs_err=max(errs.values()),
                ms=time_cuda(torch, lambda: kh.run_bwd(hlib, *hb,
                                                       stream=hst), 3),
                bf16_ms=time_cuda(torch, lambda: kh.run_bwd(hlib, *bfhb,
                                                            stream=hst), 3),
                plain_ms=time_cuda(torch, lambda: hl.head_bwd_plain(*hb), 1))
            if label in ("exp02", "exp03"):
                print(grid_line(f"f32 kernel head_bwd_f32 {label}", by_grid(
                    torch, lambda: kh.run_bwd(hlib, *hb, stream=hst),
                    F32_BWD_GRIDS)), flush=True)
            del p, wp, hb, bfh, bfhb, skip, fargs
        bounds = train_bounds(b, t, n, r, s, c, v, win, True, act=4,
                              peak=TF32_OPS_S)
        for name in F32_KERNELS:
            rec[(name, label)]["bound"] = bounds[name[:-4]]
    for (name, label), r in rec.items():
        b, dil, rr, s, v = F32_SHAPES[label]
        print(f"f32 kernel {name} {label} (B={b}, T=160000, L={len(dil)}, "
              f"R={rr}, S={s}, V=C={v}, float32, video triple) vs plain: "
              + ", ".join(f"{k} {x:.3g}" for k, x in r["errs"].items())
              + f"; kernel {r['ms']:.3f} ms, bf16 form {r['bf16_ms']:.3f} "
              f"ms, plain (TF32 off) {r['plain_ms']:.3f} ms, bound "
              f"{r['bound'][0]:.3f} ms ({r['bound'][1]})", flush=True)
    return rec


def phase_f32_step(torch, np):
    """Phase 9f (a): the breakdancing step (bench.py:173-200, S = 64) in
    float32 through ``make_train_step``: 1 warm-up + N_TRAIN steps, each
    launching each float32 form once and no other training kernel; step
    ms (median after the warm-up), peak memory."""
    from movenet_tpu_torch.ops.cuda import head_loss as kh
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks
    from movenet_tpu_torch.train import create_train_state, make_train_step
    from movenet_tpu_torch.utils.fixtures import BREAKDANCING, breakdancing

    cfg, model, batch = breakdancing(
        device="cuda", widths=dict(BREAKDANCING, compute_dtype="float32"))
    state = create_train_state(model, cfg, device="cuda")
    step = make_train_step(model, cfg)
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(N_TRAIN + 1):
        ks.reset_launch_counts()
        kh.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = {**ks.launch_counts, **kh.launch_counts}
        want = {k: int(k in F32_KERNELS) for k in counts}
        check(counts == want, f"float32 train step {i}: launches {counts}")
        check(np.isfinite(float(metrics["loss"])),
              f"float32 train step {i}: loss {float(metrics['loss'])}")
    rec = dict(step_ms=float(np.median(times[1:])),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"f32 train (breakdancing, B=2, T=160000, float32): step "
          f"{rec['step_ms']:.2f} ms (median of {N_TRAIN} after warm-up), "
          f"losses {float(metrics['loss']):.6f} at the last, peak memory "
          f"{rec['peak_gb']:.2f} GB", flush=True)
    return rec


def phase_f32_cli(torch, np, root, ds):
    """Phase 9f (b, c): the trainer CLI with experiment 02's flags and
    --compute_dtype float32 for 1 epoch of 4 steps on phase 14's clips:
    the strategy resolves to save in the embed form, each float32 form
    launches once a train step (the forwards once a validation batch too)
    and no other training kernel runs; finite losses, checkpoint 0 at step
    4, the update ms and peak memory.  Then from checkpoint 0's weights
    and the run's first batch, one loss + backward through the fused
    route (the four float32 forms) against the unfused route
    (``window_logits``: torch ops, TF32 off) within F32_ROUTE_BARS.
    Returns (launches, record)."""
    from movenet_tpu_torch.config import arg_parser, config_from_args
    from movenet_tpu_torch.data import kinetics_index
    from movenet_tpu_torch.models.wavenet import make_wavenet
    from movenet_tpu_torch.ops import stack_kernel as sk
    from movenet_tpu_torch.ops.cuda import gated_block as kg
    from movenet_tpu_torch.ops.cuda import head_loss as kh
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks

    run, logs = root / "f32_run", root / "f32_logs"
    argv = ["--dataset", str(ds), *EXP02_FLAGS, "--compute_dtype", "float32",
            "--val_batch_size", "2", "--n_steps_per_epoch", "4",
            "--n_epochs", "1", "--model_output_path", str(run), "--logger",
            "jsonl", "--training_logs_path", str(logs)]
    cfg = config_from_args(arg_parser().parse_args(argv))
    mc = cfg.model_config
    probe = make_wavenet(mc)
    dil = tuple(probe.dilations)
    strategy = sk.resolve_strategy(
        "auto", (cfg.batch_size, mc.max_audio_frames, mc.residual_channels),
        len(dil), dil, 4)
    check(strategy == "save" and 2 * mc.input_channels <= sk.EMBED_MAX_2V,
          f"float32 experiment 02: strategy {strategy}, 2V "
          f"{2 * mc.input_channels}")
    n_val = len(kinetics_index(ds, train=False)) // 2
    mods = (ks, kh, kg)
    for mod in mods:
        mod.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with timed_train_steps(torch, record=1) as steps:
        state = trainer_cli(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: v for mod in mods for k, v in mod.launch_counts.items()}
    want = {k: 0 for k in launches}
    want.update(stack_fwd_f32=4 + n_val, stack_bwd_f32=4,
                head_fwd_f32=4 + n_val, head_bwd_f32=4)
    check(launches == want, f"float32 trainer CLI launches {launches}, "
          f"expected {want}")
    check(state.step == 4, f"float32 trainer CLI took {state.step} steps")
    lines = [json.loads(l) for l in (logs / "metrics.jsonl").read_text()
             .splitlines()]
    losses = [l["loss"] for l in lines if l["tag"] in ("train", "val")]
    check(losses and all(np.isfinite(losses)), f"float32 losses {losses}")
    meta = json.loads((run / "checkpoints" / "0" / "state.json").read_text())
    check(meta == {"step": 4}, f"float32 checkpoint 0: {meta}")
    median = float(np.median(steps.ms[1:]))
    print(f"f32 trainer CLI (experiment 02 flags + --compute_dtype float32;"
          f" strategy {strategy}, embed form): 4 steps + {n_val} validation "
          f"batches in {wall:.1f} s; step ms "
          f"{[round(v, 2) for v in steps.ms]} (median after the first "
          f"{median:.2f}); peak memory {peak_gb:.3f} GB; losses "
          f"{[round(v, 6) for v in losses]}; launches {launches}",
          flush=True)
    # (c) fused against unfused from checkpoint 0's weights
    errs, _ = f32_routes(
        torch, np, mc, run, steps.batches[0],
        dict(stack_fwd_f32=1, stack_bwd_f32=1, head_fwd_f32=1,
             head_bwd_f32=1),
        "f32 fused vs unfused (checkpoint 0, the run's first batch, B=2, "
        "T=160000)")
    return launches, dict(step_ms=median, ms=steps.ms, peak_gb=peak_gb,
                          wall_s=wall, errs=errs)


def exp02_setup(torch, np, seed=0):
    """(config, model, batch) at experiment 02's CLI widths: the CLI's
    config for its flags (S=8) with --fused_strategy recompute; seeded
    random weights, B=2 codes of T=160000 and video (2, 160, 64, 64, 1),
    on the card."""
    from movenet_tpu_torch.config import arg_parser, config_from_args
    from movenet_tpu_torch.models.wavenet import make_wavenet
    from movenet_tpu_torch.train import Batch

    cfg = config_from_args(arg_parser().parse_args(
        ["--dataset", "-", *EXP02_FLAGS, "--fused_strategy", "recompute"]))
    mc = cfg.model_config
    model = make_wavenet(mc, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    t = mc.max_audio_frames
    batch = Batch(
        codes=torch.from_numpy(rng.integers(0, mc.input_channels,
                                            size=(2, t))).int(),
        video=torch.from_numpy(rng.standard_normal(
            (2, mc.max_video_frames, 64, 64, 1)).astype(np.float32)))
    return cfg, model.to("cuda"), batch.to("cuda")


def tails_compare(torch, args, dskip, label, grad_tol):
    """The recompute kernels against their plain versions on ``args`` =
    (x, ctx, b_fg, w_fg, w_out, b_out, dilations) and dskip, and their
    times; returns records by kernel."""
    from movenet_tpu_torch.ops import stack_kernel as sk
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks

    x = args[0]
    rec = {}
    # tolerance: bf16 outputs whose float32 sums the kernel and torch add
    # in other orders may sit one bf16 step apart, and a step in h moves
    # the layers above: 2% of each output's scale, as the save forward
    got = ks.stack_fwd_tails(*args)
    want = sk.stack_fwd_tails_plain(*args)
    errs, equal, of_scale = {}, {}, {}
    for name, u, w in zip(("skip", "ckpt"), got, want):
        if not w.numel():
            continue
        errs[name] = _err(u, w)
        equal[name] = float((u == w).float().mean())
        of_scale[name] = errs[name] / _scale(w)
        check(errs[name] <= 2e-2 * _scale(w),
              f"stack_fwd_tails {label} {name}: max err {errs[name]:.3g}, "
              f"scale {_scale(w):.3g}")
    rec["stack_fwd_tails"] = dict(
        max_abs_err=max(errs.values()), errs=errs, equal=equal,
        of_scale=of_scale,
        ms=time_cuda(torch, lambda: ks.run_fwd_tails(
            ks.library(), *args, stream=ks._stream(x)), 5),
        plain_ms=time_cuda(torch, lambda: sk.stack_fwd_tails_plain(*args),
                           2))
    # backward from the plain checkpoints and the seeded dskip: dx and
    # dctx (bf16) within 2%, every gradient within grad_tol of its scale
    bargs = (x, want[1], *args[1:-1], dskip, args[-1])
    got = ks.stack_bwd_tails(*bargs)
    want = sk.stack_bwd_tails_plain(*bargs)
    errs = {}
    for name, u, w in zip(("dx", "dctx", "db_fg", "dw_fg", "dw_out",
                           "db_out"), got, want):
        if w is None:
            continue
        errs[name] = _err(u, w)
        tol = (2e-2 if name in ("dx", "dctx") else grad_tol) * _scale(w)
        check(errs[name] <= tol, f"stack_bwd_tails {label} {name}: max "
              f"err {errs[name]:.3g}, scale {_scale(w):.3g}")
    rec["stack_bwd_tails"] = dict(
        max_abs_err=max(errs.values()), errs=errs,
        ms=time_cuda(torch, lambda: ks.run_bwd_tails(
            ks.library(), *bargs, stream=ks._stream(x)), 5),
        plain_ms=time_cuda(torch, lambda: sk.stack_bwd_tails_plain(*bargs),
                           2))
    for name, r in rec.items():
        errs = ", ".join(f"{k} {v:.3g}" for k, v in r["errs"].items())
        extra = ""
        if "equal" in r:
            extra = "; bit-equal share " + ", ".join(
                f"{k} {v:.6f}" for k, v in r["equal"].items()) \
                + "; of scale " + ", ".join(
                    f"{k} {v:.4f}" for k, v in r["of_scale"].items())
        print(f"recompute kernel {name} {label} vs plain: {errs}{extra}; "
              f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms",
              flush=True)
    return rec


def phase_tails_kernels(torch, np, model, batch):
    """The recompute kernels against their plain versions at experiment
    02's widths on the model's own inputs, then at the flagship width
    (layer 10 x stack 3, R=S=64, B=2, T=160000, no ctx, seeded random x
    and weights); returns (records by kernel at experiment 02, records at
    the flagship)."""
    from movenet_tpu_torch.models import fused
    from movenet_tpu_torch.ops import stack_kernel as sk

    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(5)
    with torch.no_grad():
        ctx, (b_fg, w_fg, w_out, b_out) = fused._prepare_trunk(
            model, batch.codes, batch.video, None)
        # the encoder's output, flat (B, T, R)
        ctx = sk.ctx_flatten(ctx, bf) if sk.ctx_is_proj(ctx) else ctx
        x = sk.front_embed(model.front_cur, model.front_past, batch.codes,
                           bf)
        t, s = x.shape[1], w_out.shape[2] - x.shape[2]
        dskip = (torch.randn(2, t, s, generator=g, device="cuda")
                 * 1e-3).to(bf)
        # float32 sums over 320000 rows in other orders: 1e-3 of each
        # gradient's scale, as phase_train_kernels
        exp02 = tails_compare(torch, (x, ctx, b_fg, w_fg, w_out, b_out,
                                      tuple(model.dilations)), dskip,
                              "experiment 02", 1e-3)
        del x, ctx
        dil = tuple(2 ** i for i in range(10)) * 3
        n, r = len(dil), 64

        def rn(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device="cuda") * scale

        args = (rn(2, t, r, scale=0.5).to(bf), None,
                rn(n * 2, 2 * r, scale=0.1),
                rn(n, 2 * r, 2 * r, scale=(2 * r) ** -0.5),
                rn(n, r, 2 * r, scale=r ** -0.5), rn(n, 2 * r, scale=0.1),
                dil)
        dskip = (rn(2, t, r) * 1e-3).to(bf)
        flagship = tails_compare(torch, args, dskip, "flagship", 1e-3)
    return exp02, flagship


def phase_recompute_vs_save(torch, np, model, batch):
    """One fused_train_loss loss + backward through the save strategy and
    through the recompute strategy on the same weights and batch: the
    kernels each launches, the loss and every gradient against each
    other, and each one's peak device memory."""
    from movenet_tpu_torch.models import fused
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks

    runs = {}
    for strategy in ("save", "recompute"):
        model.fused_strategy = strategy
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ks.reset_launch_counts()
        t0 = time.perf_counter()
        loss, _ = fused.fused_train_loss(model, batch.codes, batch.video)
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        runs[strategy] = dict(
            loss=float(loss.detach()), ms=ms,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=dict(ks.launch_counts),
            grads={n: p.grad.detach().float().clone()
                   for n, p in model.named_parameters()
                   if p.grad is not None})
    model.fused_strategy = "recompute"
    model.zero_grad(set_to_none=True)
    s, r = runs["save"], runs["recompute"]
    check(s["launches"]["stack_fwd"] == 1 and s["launches"]["stack_bwd"] == 1
          and s["launches"]["stack_fwd_tails"] == 0,
          f"save launches {s['launches']}")
    check(r["launches"]["stack_fwd_tails"] == 1
          and r["launches"]["stack_bwd_tails"] == 1
          and r["launches"]["stack_fwd"] == 0,
          f"recompute launches {r['launches']}")
    # tolerance: the recompute strategy rounds h to bf16 after every layer
    # and gates from the unrounded taps, the save strategy keeps h in
    # float32 and gates from the rounded taps.  In float32 the two give
    # the same gradients; in bf16 the parity loss's gradients (CE on the
    # softmax) cancel so much that the rounding moves every leaf by about
    # 8% of its norm (measured with the plain versions at T=1280): loss
    # within 1e-3 relative, each leaf's gradient within 20% of its norm
    loss_rel = abs(r["loss"] - s["loss"]) / abs(s["loss"])
    check(np.isfinite(r["loss"]) and loss_rel <= 1e-3,
          f"recompute loss {r['loss']} vs save {s['loss']}")
    check(set(r["grads"]) == set(s["grads"]), "gradient leaves differ")
    worst, worst_name = 0.0, ""
    for name, gs in s["grads"].items():
        rel = float((r["grads"][name] - gs).norm() / (gs.norm() + 1e-30))
        check(rel <= 0.2, f"recompute vs save gradient {name}: {rel:.3g} "
              "of its norm")
        if rel > worst:
            worst, worst_name = rel, name
    check(worst > 0.0, "recompute and save gave identical gradients")
    saved_gb = s["peak_gb"] - r["peak_gb"]
    print(f"recompute vs save (B=2, T=160000, S=8, bf16): loss "
          f"{r['loss']:.7f} vs {s['loss']:.7f} (relative {loss_rel:.3g}); "
          f"largest gradient difference {worst:.3g} of the norm "
          f"({worst_name}); peak memory {r['peak_gb']:.3f} GB vs "
          f"{s['peak_gb']:.3f} GB ({saved_gb:.3f} GB less); loss + "
          f"backward {r['ms']:.1f} ms vs {s['ms']:.1f} ms (first calls)",
          flush=True)
    check(saved_gb >= 0.55, f"recompute peak memory only {saved_gb:.3f} GB "
          "below save")
    return dict(loss_rel=loss_rel, worst=worst, worst_name=worst_name,
                peak_save=s["peak_gb"], peak_recompute=r["peak_gb"])


class merged_route:
    """Within the block the train step's fused loss takes ``merge_head``
    (neither package's trainer has an option for it)."""

    def __init__(self, merge: bool):
        self.merge = merge

    def __enter__(self):
        import functools

        from movenet_tpu_torch.models import fused

        self.real = fused.fused_train_loss
        fused.fused_train_loss = functools.partial(self.real,
                                                   merge_head=self.merge)
        return self

    def __exit__(self, *exc):
        from movenet_tpu_torch.models import fused

        fused.fused_train_loss = self.real
        return False


def phase_merged_head(torch, np, cfg, model, batch):
    """The merged trunk + head kernels against their plain versions on the
    merged loss's own inputs; fused_train_loss(merge_head=True) against
    the split route from the same weights; 1 + N_TRAIN AdamW steps on each
    route.  Returns (records by kernel, main-path launches, summary)."""
    import copy

    from movenet_tpu_torch.models import fused
    from movenet_tpu_torch.ops import stack_kernel as sk
    from movenet_tpu_torch.ops.cuda import head_loss as kh
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks
    from movenet_tpu_torch.train import create_train_state, make_train_step
    from movenet_tpu_torch.utils.time_stack_bwd import FWD_GRIDS, by_grid

    b, t = batch.codes.shape
    dil = tuple(model.dilations)
    rf = model.receptive_fields
    head = (model.head1.kernel, model.head1.bias, model.head2.kernel,
            model.head2.bias)
    rec = {}
    with torch.no_grad():
        inputs = fused._merged_inputs(model, batch.codes, batch.video, None)
        check(inputs is not None, "the merged route does not apply at the "
              "breakdancing shapes")
        x, ctx, _, w_fg, w_out, _, tgt = inputs
        fargs = (*inputs, *head, dil, rf, True)
        # tolerance: the save forward's (phase 9): bf16 outputs whose
        # float32 sums the kernel and torch add in other orders may sit one
        # bf16 step apart, 2% of each output's scale (the bit-equal share
        # is printed); the loss sum rtol 1e-5; the match count within 10
        # rows (first-argmax ties within float32 noise), as the head phase
        loss, match, *got = ks.stack_head_fwd(*fargs)
        wl, wm, *want = sk.stack_head_fwd_plain(*fargs)
        errs = {"loss": abs(float(loss) - float(wl)) / abs(float(wl)),
                "match": abs(float(match) - float(wm))}
        check(errs["loss"] <= 1e-5, f"stack_head_fwd loss {float(loss)} vs "
              f"plain {float(wl)}")
        check(errs["match"] <= 10, f"stack_head_fwd match {float(match)} vs "
              f"plain {float(wm)}")
        equal = {}
        for name, u, w in zip(("skip", "hsave", "tfsg"), got, want):
            errs[name] = _err(u, w)
            equal[name] = float((u == w).float().mean())
            check(errs[name] <= 2e-2 * _scale(w), f"stack_head_fwd {name}: "
                  f"max err {errs[name]:.3g}, scale {_scale(w):.3g}")
        del got

        def head_fwd():
            return ks.run_head_fwd(ks.library(), *fargs,
                                   stream=ks._stream(x))

        rec["stack_head_fwd"] = dict(
            max_abs_err=max(errs[n] for n in ("skip", "hsave", "tfsg")),
            errs=errs, equal=equal,
            ms=time_cuda(torch, head_fwd, 5),
            plain_ms=time_cuda(torch, lambda: sk.stack_head_fwd_plain(
                *fargs), 2),
            by_grid=by_grid(torch, head_fwd, FWD_GRIDS))
        print(grid_line("merged kernel stack_head_fwd (breakdancing)",
                        rec["stack_head_fwd"]["by_grid"]), flush=True)
        # backward from the plain forward's saved tensors, as the save
        # backward's phase: float32 sums over 320000 rows in other orders,
        # 1e-3 of each gradient's scale; dx and dctx (bf16) 2%
        skip, hsave, tfsg = want
        dloss = torch.tensor(1.0 / (b * (t - rf)), device="cuda")
        bargs = (hsave, tfsg, ctx, w_fg, w_out, skip, tgt, *head, dloss, dil,
                 rf, True)
        got = ks.stack_head_bwd(*bargs)
        want = sk.stack_head_bwd_plain(*bargs)
        errs = {}
        for name, u, w in zip(("dx", "dctx", "db_fg", "dw_fg", "dw_out",
                               "db_out", "dw1", "db1", "dw2", "db2"), got,
                              want):
            errs[name] = _err(u, w)
            tol = (2e-2 if name in ("dx", "dctx") else 1e-3) * _scale(w)
            check(errs[name] <= tol, f"stack_head_bwd {name}: max err "
                  f"{errs[name]:.3g}, scale {_scale(w):.3g}")
        del got, want
        rec["stack_head_bwd"] = dict(
            max_abs_err=max(errs.values()), errs=errs,
            ms=time_cuda(torch, lambda: ks.run_head_bwd(
                ks.library(), *bargs, stream=ks._stream(x)), 5),
            plain_ms=time_cuda(torch, lambda: sk.stack_head_bwd_plain(
                *bargs), 2),
            by_grid=by_grid(torch, lambda: ks.run_head_bwd(
                ks.library(), *bargs, stream=ks._stream(x))))
        print(grid_line("merged kernel stack_head_bwd (breakdancing)",
                        rec["stack_head_bwd"]["by_grid"]), flush=True)
        del inputs, fargs, bargs, x, ctx, skip, hsave, tfsg
    for name, r in rec.items():
        errs = ", ".join(f"{k} {v:.3g}" for k, v in r["errs"].items())
        extra = ""
        if "equal" in r:
            extra = "; bit-equal share " + ", ".join(
                f"{k} {v:.6f}" for k, v in r["equal"].items())
        print(f"merged kernel {name} vs plain: {errs}{extra}; kernel "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms", flush=True)

    # the main path: fused_train_loss with merge_head=True, and the split
    # route from the same weights
    launches = {k: 0 for k in MERGED_KERNELS}
    runs = {}
    for merge in (True, False):
        model.zero_grad(set_to_none=True)
        ks.reset_launch_counts()
        kh.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = fused.fused_train_loss(model, batch.codes, batch.video,
                                         merge_head=merge)
        loss.backward()
        torch.cuda.synchronize()
        counts = {**ks.launch_counts, **kh.launch_counts}
        runs[merge] = dict(
            loss=float(loss.detach()), counts=counts,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            grads={n: p.grad.detach().float().clone()
                   for n, p in model.named_parameters()
                   if p.grad is not None})
    model.zero_grad(set_to_none=True)
    m, sp = runs[True], runs[False]
    want_m = {"stack_head_fwd": 1, "stack_head_bwd": 1, "stack_fwd": 0,
              "stack_bwd": 0, "head_fwd": 0, "head_bwd": 0}
    want_s = {"stack_head_fwd": 0, "stack_head_bwd": 0, "stack_fwd": 1,
              "stack_bwd": 1, "head_fwd": 1, "head_bwd": 1}
    check(all(m["counts"][k] == v for k, v in want_m.items()),
          f"merged route launches {m['counts']}")
    check(all(sp["counts"][k] == v for k, v in want_s.items()),
          f"split route launches {sp['counts']}")
    for k in MERGED_KERNELS:
        launches[k] += m["counts"][k]
    # tolerance: both routes start from the same embedding and trunk
    # weights; the loss within 1e-6 relative.  JAX defines the two routes'
    # gradients differently in bf16 (the merged forward gates from the
    # unrounded taps, its head backward takes float32 operands and its
    # dskip stays float32): with the plain versions on the CPU at these
    # widths (T=12800) every leaf differs by up to 9.9% of its scale (9.3%
    # of its norm, 0.38% of the scale on average) and the routes agree to
    # 1e-7 in float32.  So each leaf within 20% of its norm and its mean
    # difference within 1% of its scale (the recompute phase's bar).
    loss_rel = abs(m["loss"] - sp["loss"]) / abs(sp["loss"])
    check(np.isfinite(m["loss"]) and loss_rel <= 1e-6,
          f"merged loss {m['loss']} vs split {sp['loss']}")
    check(set(m["grads"]) == set(sp["grads"]), "gradient leaves differ")
    worst = dict(norm=(0.0, ""), scale=(0.0, ""), mean=(0.0, ""))
    for name, gs in sp["grads"].items():
        d = m["grads"][name] - gs
        scale = float(gs.abs().max()) + 1e-30
        vals = dict(norm=float(d.norm() / (gs.norm() + 1e-30)),
                    scale=float(d.abs().max()) / scale,
                    mean=abs(float(d.mean())) / scale)
        check(vals["norm"] <= 0.2 and vals["mean"] <= 1e-2,
              f"merged vs split gradient {name}: {vals}")
        for k, v in vals.items():
            if v > worst[k][0]:
                worst[k] = (v, name)
    print(f"merged vs split route (breakdancing, bf16): loss "
          f"{m['loss']:.7f} vs {sp['loss']:.7f} (relative {loss_rel:.3g}); "
          f"largest gradient difference {worst['norm'][0]:.3g} of the norm "
          f"({worst['norm'][1]}), {worst['scale'][0]:.3g} of the scale "
          f"({worst['scale'][1]}), mean {worst['mean'][0]:.3g} of the scale "
          f"({worst['mean'][1]}); peak memory of a loss + backward "
          f"{m['peak_gb']:.3f} GB vs {sp['peak_gb']:.3f} GB", flush=True)
    del runs

    # 1 warm-up + N_TRAIN AdamW steps on each route from the same weights
    steps = {}
    for merge in (True, False):
        mod = copy.deepcopy(model)
        state = create_train_state(mod, cfg, device="cuda")
        step = make_train_step(mod, cfg)
        losses, times = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with merged_route(merge):
            for i in range(N_TRAIN + 1):
                ks.reset_launch_counts()
                kh.reset_launch_counts()
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                counts = {**ks.launch_counts, **kh.launch_counts}
                want = want_m if merge else want_s
                check(all(counts[k] == v for k, v in want.items()),
                      f"merge_head={merge} step {i}: launches {counts}")
                if merge:
                    for k in MERGED_KERNELS:
                        launches[k] += counts[k]
                loss = float(metrics["loss"])
                check(np.isfinite(loss), f"merge_head={merge} step {i}: "
                      f"loss {loss}")
                losses.append(loss)
        steps[merge] = dict(losses=losses,
                            step_ms=float(np.median(times[1:])),
                            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del mod, state, step
    # tolerance: as the train phase, 1e-3 relative per step (the routes'
    # losses agreed within 1.4e-6 over 6 steps with the plain versions on
    # the CPU at T=12800)
    for i, (a, w) in enumerate(zip(steps[True]["losses"],
                                   steps[False]["losses"])):
        check(abs(a - w) <= 1e-3 * abs(w),
              f"step {i}: merged loss {a} vs split {w}")
    step_rel = max(abs(a - w) / abs(w) for a, w in zip(
        steps[True]["losses"], steps[False]["losses"]))
    mk, sl = steps[True], steps[False]
    print(f"merged vs split train steps: losses {mk['losses']} vs "
          f"{sl['losses']} (largest relative difference {step_rel:.3g}); "
          f"step {mk['step_ms']:.2f} ms vs {sl['step_ms']:.2f} ms (median of "
          f"{N_TRAIN} after a warm-up); peak memory {mk['peak_gb']:.2f} GB "
          f"vs {sl['peak_gb']:.2f} GB", flush=True)
    return rec, launches, dict(loss_rel=loss_rel, worst=worst,
                               step_rel=step_rel, steps=steps)


def phase_gated_block(torch, np, model, batch):
    """The gated-block kernels against their plain versions at R=S=64,
    B=2, T=160000, bf16, flat ctx, d in GATED_DILATIONS, with their times;
    then the per-block trunk (one fused_gated_block per layer, forward
    and backward) against the whole-stack save trunk on the same inputs.
    Returns (records by kernel, main-path launches, summary)."""
    from movenet_tpu_torch.models import fused
    from movenet_tpu_torch.ops import gated_block as gb
    from movenet_tpu_torch.ops import stack_kernel as sk
    from movenet_tpu_torch.ops.cuda import gated_block as kg
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks

    b, t = batch.codes.shape
    dil = tuple(model.dilations)
    bf = torch.bfloat16
    with torch.no_grad():
        ctx, (b_fg, w_fg, w_out, b_out) = fused._prepare_trunk(
            model, batch.codes, batch.video, None)
        ctx = sk.ctx_flatten(ctx, bf)
        x = sk.front_embed(model.front_cur, model.front_past, batch.codes,
                           bf)
    n_layers, r = len(dil), x.shape[-1]
    g = torch.Generator(device="cuda").manual_seed(9)
    dres = (torch.randn(x.shape, generator=g, device="cuda") * 1e-3).to(bf)
    dskip = (torch.randn(b, t, w_out.shape[2] - r, generator=g,
                         device="cuda") * 1e-3).to(bf)
    args = (x, ctx, b_fg.reshape(n_layers, b, -1)[0].contiguous(), w_fg[0],
            w_out[0])
    b_out0 = b_out[0].reshape(1, -1)
    rec = {}
    with torch.no_grad():
        for d in GATED_DILATIONS:
            # tolerance: float32 sums in other orders rounded to bf16 may
            # sit one bf16 step apart: res, skip, dh and dctx within 1% of
            # their scale; the float32 gradients, sums over 320000 rows,
            # within 1e-3 of their scale, as the save backward's phase
            got = kg.gated_block_fwd(*args, b_out0, d)
            want = gb.gated_block_fwd_plain(*args, b_out0, d)
            errs = {}
            for name, u, w in zip(("res", "skip"), got, want):
                errs[name] = _err(u, w)
                check(errs[name] <= 1e-2 * _scale(w), f"gated_block_fwd "
                      f"d={d} {name}: max err {errs[name]:.3g}, scale "
                      f"{_scale(w):.3g}")
            rec[("gated_block_fwd", d)] = dict(
                max_abs_err=max(errs.values()), errs=errs,
                ms=time_cuda(torch, lambda: kg.run_fwd(
                    kg.library(), *args, b_out0, d, kg._stream(x)), 5),
                plain_ms=time_cuda(torch, lambda: gb.gated_block_fwd_plain(
                    *args, b_out0, d), 2))
            got = kg.gated_block_bwd(*args, dres, dskip, d)
            want = gb.gated_block_bwd_plain(*args, dres, dskip, d)
            errs = {}
            for name, u, w in zip(("dh", "dctx", "db_fg", "dw_fg", "dw_out",
                                   "db_out"), got, want):
                errs[name] = _err(u, w)
                tol = (1e-2 if name in ("dh", "dctx") else 1e-3) * _scale(w)
                check(errs[name] <= tol, f"gated_block_bwd d={d} {name}: "
                      f"max err {errs[name]:.3g}, scale {_scale(w):.3g}")
            rec[("gated_block_bwd", d)] = dict(
                max_abs_err=max(errs.values()), errs=errs,
                ms=time_cuda(torch, lambda: kg.run_bwd(
                    kg.library(), *args, dres, dskip, d, kg._stream(x)), 5),
                plain_ms=time_cuda(torch, lambda: gb.gated_block_bwd_plain(
                    *args, dres, dskip, d), 2))
    for (name, d), r_ in rec.items():
        errs = ", ".join(f"{k} {v:.3g}" for k, v in r_["errs"].items())
        print(f"gated kernel {name} d={d} vs plain: {errs}; kernel "
              f"{r_['ms']:.3f} ms, plain {r_['plain_ms']:.3f} ms",
              flush=True)

    # the main path of the per-block route, forward and backward, against
    # the whole-stack save trunk (its non-embed form) on the same inputs
    leaves = (x, ctx, b_fg, w_fg, w_out, b_out)
    gskip = (torch.randn(b, t, w_out.shape[2] - r, generator=g,
                         device="cuda") * 1e-3).to(bf)
    out = {}
    for route in ("per-block", "whole-stack"):
        ls = [v.detach().clone().requires_grad_() for v in leaves]
        kg.reset_launch_counts()
        ks.reset_launch_counts()

        def run():
            if route == "per-block":
                return fused._per_block_trunk(*ls, dil)
            return sk.fused_stack(*ls, dil, strategy="save")

        skip = run()
        skip.backward(gskip)
        torch.cuda.synchronize()
        counts = {**kg.launch_counts, **ks.launch_counts}
        out[route] = (skip.detach().float(), [v.grad.float() for v in ls],
                      counts)

        def fwd_bwd():
            for v in ls:
                v.grad = None
            run().backward(gskip)

        out[route] += (time_cuda(torch, fwd_bwd, 3),)
    pb, ws = out["per-block"], out["whole-stack"]
    check(pb[2]["gated_block_fwd"] == n_layers
          and pb[2]["gated_block_bwd"] == n_layers
          and pb[2]["stack_fwd"] == 0,
          f"per-block trunk launches {pb[2]}")
    check(ws[2]["stack_fwd"] == 1 and ws[2]["stack_bwd"] == 1
          and ws[2]["gated_block_fwd"] == 0,
          f"whole-stack trunk launches {ws[2]}")
    launches = {k: pb[2][k] for k in GATED_KERNELS}
    # tolerance: the per-block route rounds h to bf16 after every block
    # and takes float32 operands; the whole-stack trunk keeps h float32
    # and rounds its product operands to bf16.  With the plain versions on
    # the CPU at these widths (T=12800) the skip sums differ by up to 0.9%
    # of their scale and every gradient by up to 1.4% (the two agree
    # exactly in float32): skip within 3% of its scale, each gradient
    # within 5% of its scale and its mean difference within 5e-4
    diffs = {"skip": _err(pb[0], ws[0]) / _scale(ws[0])}
    check(diffs["skip"] <= 3e-2, f"per-block skip {diffs['skip']:.3g} of "
          "the scale from the whole-stack trunk")
    for name, u, w in zip(("x", "ctx", "b_fg", "w_fg", "w_out", "b_out"),
                          pb[1], ws[1]):
        diffs[name] = _err(u, w) / _scale(w)
        mean = abs(float((u - w).mean())) / _scale(w)
        check(diffs[name] <= 5e-2 and mean <= 5e-4, f"per-block gradient "
              f"{name}: {diffs[name]:.3g} of the scale, mean {mean:.3g}")
    print("per-block vs whole-stack trunk (9 layers, B=2, T=160000, bf16, "
          "flat ctx): largest difference of the scale " + ", ".join(
              f"{k} {v:.3g}" for k, v in diffs.items())
          + f"; forward + backward {pb[3]:.3f} ms vs {ws[3]:.3f} ms",
          flush=True)
    return rec, launches, dict(diffs=diffs, per_block_ms=pb[3],
                               whole_stack_ms=ws[3])


class timed_train_steps:
    """Within the block the trainer's train steps are timed, each to a
    synchronised card (observation only).  ``record``: for that many
    first steps also keep the config, the weights the step starts from,
    its batch and its metrics, on the CPU."""

    def __init__(self, torch, record=0):
        self.torch = torch
        self.record = record
        self.ms = []
        self.weights, self.batches, self.metrics = [], [], []
        self.config = None

    def __enter__(self):
        from movenet_tpu_torch.train import trainer

        self.real = trainer.make_train_step
        torch, ms = self.torch, self.ms

        def make(model, config, group=None, mesh=None):
            step = self.real(model, config, group, mesh=mesh)
            self.config = config

            def timed(state, batch):
                keep = len(ms) < self.record
                if keep:
                    self.weights.append({
                        k: v.detach().cpu().clone()
                        for k, v in state.module.state_dict().items()})
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(state, batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                if keep:
                    self.batches.append(batch.to("cpu"))
                    self.metrics.append({k: float(v)
                                         for k, v in out[1].items()})
                return out

            return timed

        trainer.make_train_step = make
        return self

    def __exit__(self, *exc):
        from movenet_tpu_torch.train import trainer

        trainer.make_train_step = self.real
        return False


def cli_argv(ds, out, logs, extra):
    """Experiment 02's flags with the recompute strategy, 4 steps an
    epoch."""
    return ["--dataset", str(ds), *EXP02_FLAGS, "--fused_strategy",
            "recompute", "--val_batch_size", "2", "--n_steps_per_epoch", "4",
            "--model_output_path", str(out), "--logger", "jsonl",
            "--training_logs_path", str(logs), *extra]


def cli_run(ds, out, logs, extra):
    """The trainer CLI with experiment 02's flags and the recompute
    strategy."""
    return trainer_cli(cli_argv(ds, out, logs, extra))


def phase_trainer_cli(torch, np, root):
    """The trainer CLI for 1 epoch of 4 steps on synthetic clips at the
    real format; returns (launches, median step ms, dataset dir)."""
    from movenet_tpu_torch.data import kinetics_index, make_synthetic_dataset
    from movenet_tpu_torch.ops.cuda import head_loss as kh
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks

    t0 = time.perf_counter()
    ds = root / "exp02_clips"
    make_synthetic_dataset(ds, splits=("train", "valid"),
                           categories=["breakdancing"], clips_per_category=8)
    n_val = len(kinetics_index(ds, train=False)) // 2
    print(f"trainer data: 8 train + {2 * n_val} valid clips (16 kHz, 16 fps, "
          f"10 s, 96x96) written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    ks.reset_launch_counts()
    kh.reset_launch_counts()
    t0 = time.perf_counter()
    with timed_train_steps(torch) as steps:
        state = cli_run(ds, root / "run", root / "logs",
                        ["--n_epochs", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**ks.launch_counts, **kh.launch_counts}
    check(state.step == 4, f"trainer CLI took {state.step} steps, not 4")
    want = {"stack_fwd_tails": 4 + n_val, "stack_bwd_tails": 4,
            "stack_fwd": 0, "stack_bwd": 0}
    check(all(launches[k] == v for k, v in want.items()),
          f"trainer CLI launches {launches}, expected {want}")
    lines = [json.loads(l) for l in
             (root / "logs" / "metrics.jsonl").read_text().splitlines()]
    losses = [l["loss"] for l in lines if l["tag"] in ("train", "val")]
    check(losses and all(np.isfinite(losses)), f"losses {losses}")
    ckpt = root / "run" / "checkpoints" / "0"
    meta = json.loads((ckpt / "state.json").read_text())
    check(meta == {"step": 4} and (ckpt / "params.npz").is_file()
          and (ckpt / "optimizer.pt").is_file(),
          f"checkpoint 0: {sorted(p.name for p in ckpt.iterdir())}, {meta}")
    median = float(np.median(steps.ms[1:]))
    print(f"trainer CLI (experiment 02 flags, --fused_strategy recompute): "
          f"4 steps + {n_val} validation batches in {wall:.1f} s with the "
          f"data; step ms {[round(v, 2) for v in steps.ms]} (median after "
          f"the first {median:.2f}); losses {[round(v, 6) for v in losses]};"
          f" launches {launches}; checkpoint 0 at step 4", flush=True)
    return launches, median, ds


def phase_resume(torch, np, root, ds):
    """--n_epochs 2 --auto_resume 1 on the same run continues at epoch 1
    to step 8; an uninterrupted 2-epoch run ends with the same params and
    optimizer state."""
    resumed = cli_run(ds, root / "run", root / "logs", ["--n_epochs", "2"])
    lines = [json.loads(l) for l in
             (root / "logs" / "metrics.jsonl").read_text().splitlines()]
    epochs = [int(l["epoch"]) for l in lines if l["tag"] == "epoch"]
    check(resumed.step == 8 and epochs == [0, 1],
          f"resumed run: step {resumed.step}, epochs logged {epochs}")
    whole = cli_run(ds, root / "whole", root / "logs_whole",
                    ["--n_epochs", "2"])
    check(whole.step == 8, f"uninterrupted run: step {whole.step}")
    diff = 0.0
    pr = resumed.module.state_dict()
    for name, w in whole.module.state_dict().items():
        diff = max(diff, _err(pr[name], w))
    ow, orr = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    check(ow["param_groups"] == orr["param_groups"]
          and set(ow["state"]) == set(orr["state"]),
          "optimizer state layout differs")
    opt_diff = 0.0
    for i, st in ow["state"].items():
        for k, v in st.items():
            opt_diff = max(opt_diff, _err(orr["state"][i][k], v))
    print(f"resume: started at epoch 1, ended at step 8; against the "
          f"uninterrupted run: params max difference {diff:.3g}, optimizer "
          f"state {opt_diff:.3g}", flush=True)
    check(diff == 0.0 and opt_diff == 0.0,
          "the resumed run's params or optimizer state differ from the "
          "uninterrupted run's")


# the data-parallel phase: 1 + 3 steps on a global batch of 4
# breakdancing rows, two ranks of 2 rows
DP_STEPS = 4
DP_BATCH = 4
DP_DEADLINE_S = 600


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_batch(torch, np):
    """The global batch: 4 rows of seeded codes and video at the
    breakdancing clip format."""
    from movenet_tpu_torch.train import Batch
    from movenet_tpu_torch.utils.fixtures import BREAKDANCING

    rng = np.random.default_rng(1)
    t = BREAKDANCING["max_audio_frames"]
    f = BREAKDANCING["max_video_frames"]
    return Batch(
        codes=torch.from_numpy(rng.integers(0, 64, size=(DP_BATCH, t))).int(),
        video=torch.from_numpy(rng.standard_normal(
            (DP_BATCH, f, 64, 64, 1)).astype(np.float32)))


def dp_steps(torch, step, state, batch, before=None):
    """DP_STEPS train steps; per step its loss, accuracy, grad_norm, ms
    (host clock to a synchronised card), the training kernels' launches
    and the params' digest after it.  ``before``: a list that gets the
    weights (a CPU state dict) before each step."""
    from movenet_tpu_torch.ops.cuda import head_loss as kh
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks
    from movenet_tpu_torch.train.trainer import params_digest

    recs = []
    for _ in range(DP_STEPS):
        if before is not None:
            before.append({k: v.detach().cpu().clone()
                           for k, v in state.module.state_dict().items()})
        torch.cuda.synchronize()
        ks.reset_launch_counts()
        kh.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {**ks.launch_counts, **kh.launch_counts}
        recs.append(dict(
            ms=ms, launches={k: counts[k] for k in TRAIN_KERNELS},
            digest=params_digest(state.module),
            **{k: float(m[k]) for k in ("loss", "accuracy", "grad_norm")}))
    return recs


def dp_rank(rank, port, out):
    """One of two data-parallel ranks on cuda:0 over gloo (a spawned
    worker): the breakdancing model, this rank's 2 rows of the global
    batch, ``make_parallel_train_step``."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from movenet_tpu_torch.config import TrainingConfig
    from movenet_tpu_torch.parallel import (
        initialize_distributed,
        make_parallel_train_step,
        shard_batch,
    )
    from movenet_tpu_torch.train import create_train_state
    from movenet_tpu_torch.utils.fixtures import breakdancing

    # two "processes" of one rank each, both on card 0: NCCL takes no two
    # ranks on one device, gloo does
    initialize_distributed(TrainingConfig(num_processes=2, process_id=rank),
                           device="cuda", backend="gloo",
                           address=f"127.0.0.1:{port}")
    try:
        cfg, model, _ = breakdancing(device="cuda")
        shard = shard_batch(dp_batch(torch, np), rank, 2).to("cuda")
        state = create_train_state(model, cfg, device="cuda")
        weights = []
        recs = dp_steps(torch, make_parallel_train_step(model, cfg), state,
                        shard, weights)
        Path(out, f"rank{rank}.json").write_text(json.dumps(recs))
        if rank == 0:
            torch.save(weights, Path(out, "weights.pt"))
    finally:
        torch.distributed.destroy_process_group()


def phase_data_parallel(torch, np, root, ds):
    """(a) The trainer CLI as a user runs it (a subprocess) with phase
    14's flags and a coordinator at world size 1: the launcher spawns one
    rank, which joins an NCCL group and all-reduces every step; its
    checkpoint after step 4 must equal phase 14's, bit for bit.  (b) Two
    ranks on this card over gloo through the library API, against one
    process on all 4 rows: each step's loss and grad_norm within 1e-3
    relative of the one process's step from the weights the ranks held
    before it, and the loss of the one process's own 1 + 3 steps within
    1e-3 at each step (its grad_norm is printed beside: Adam moves the
    elements whose gradient is rounding noise by up to lr, so the two
    trajectories' gradients part); the ranks' params equal after every
    step, each training kernel launched once a step in each rank.
    Returns the ranks' launches."""
    import torch.multiprocessing as mp

    from movenet_tpu_torch.train import create_train_state, make_train_step
    from movenet_tpu_torch.utils.fixtures import breakdancing

    t_phase = time.perf_counter()
    port = free_port()
    argv = cli_argv(ds, root / "dp_run", root / "dp_logs",
                    ["--n_epochs", "1", "--coordinator_address",
                     f"127.0.0.1:{port}", "--num_processes", "1",
                     "--process_id", "0"])
    proc = subprocess.Popen(
        [sys.executable, "-m", "movenet_tpu_torch.train.cli", *argv],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=DP_DEADLINE_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise PhaseFailed(f"the data-parallel CLI ran past {DP_DEADLINE_S} s")
    check(proc.returncode == 0, f"the data-parallel CLI exited "
          f"{proc.returncode}: {log[-3000:]}")
    wall_a = time.perf_counter() - t_phase
    want = ["distributed runtime: rank 0 of 1 over nccl", "mesh: data=1 seq=1",
            "the 1 ranks' params are equal"]
    found = [next((l for l in log.splitlines() if w in l), None)
             for w in want]
    check(all(found), f"the data-parallel CLI's log lacks "
          f"{[w for w, l in zip(want, found) if l is None]}")
    a_dir = root / "dp_run" / "checkpoints" / "0"
    b_dir = root / "run" / "checkpoints" / "0"
    pa, pb = np.load(a_dir / "params.npz"), np.load(b_dir / "params.npz")
    check(sorted(pa.files) == sorted(pb.files), "params leaves differ")
    p_diff = [k for k in pa.files if not np.array_equal(pa[k], pb[k])]
    oa, ob = (torch.load(d / "optimizer.pt", map_location="cpu",
                         weights_only=True) for d in (a_dir, b_dir))
    o_same = oa["param_groups"] == ob["param_groups"] \
        and set(oa["state"]) == set(ob["state"]) \
        and all(set(oa["state"][i]) == set(st) and all(
            torch.equal(torch.as_tensor(oa["state"][i][k]),
                        torch.as_tensor(v)) for k, v in st.items())
            for i, st in ob["state"].items())
    meta = [json.loads((d / "state.json").read_text())
            for d in (a_dir, b_dir)]
    for line in found:
        print(f"data parallel (a): {line.split(': ', 3)[-1]}", flush=True)
    print(f"data parallel (a): the trainer CLI with --coordinator_address "
          f"127.0.0.1:{port} --num_processes 1 --process_id 0 (phase 14's "
          f"flags, 4 steps) in {wall_a:.1f} s with the data; checkpoint 0 "
          f"{meta[0]} against the in-process run's {meta[1]}: params "
          f"{'bit-equal' if not p_diff else f'differ in {p_diff}'}, "
          f"optimizer state {'bit-equal' if o_same else 'differs'}",
          flush=True)
    check(not p_diff and o_same and meta[0] == meta[1] == {"step": 4},
          "the NCCL run's checkpoint differs from the in-process run's")

    t0 = time.perf_counter()
    out = root / "dp_ranks"
    out.mkdir()
    ctx = mp.spawn(dp_rank, args=(free_port(), str(out)), nprocs=2,
                   join=False)
    deadline = time.perf_counter() + DP_DEADLINE_S
    while not ctx.join(timeout=5):
        if time.perf_counter() > deadline:
            for p in ctx.processes:
                p.kill()
            raise PhaseFailed(f"the gloo ranks ran past {DP_DEADLINE_S} s")
    wall_b = time.perf_counter() - t0
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in (0, 1)]
    cfg, model, _ = breakdancing(device="cuda")
    state = create_train_state(model, cfg, device="cuda")
    step, batch = make_train_step(model, cfg), dp_batch(torch, np).to("cuda")
    one = dp_steps(torch, step, state, batch)
    at_ranks = []
    for weights in torch.load(out / "weights.pt", weights_only=True):
        model.load_state_dict(weights)
        state, m = step(state, batch)
        at_ranks.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    bad = []
    for i, (r0, r1, o, a) in enumerate(zip(*ranks, one, at_ranks)):
        for r, rec in enumerate((r0, r1)):
            print(f"data parallel (b) rank {r} step {i}: loss "
                  f"{rec['loss']:.6f} grad_norm {rec['grad_norm']:.6g}; "
                  f"{rec['ms']:.2f} ms; launches {rec['launches']}; params "
                  f"sha256 {rec['digest'][:16]}", flush=True)
            if any(v != 1 for v in rec["launches"].values()):
                bad.append(f"rank {r} step {i} launches {rec['launches']}")
        print(f"data parallel (b) one process step {i} (4 rows): loss "
              f"{o['loss']:.6f} grad_norm {o['grad_norm']:.6g}; "
              f"{o['ms']:.2f} ms; from the ranks' weights: loss "
              f"{a['loss']:.6f} grad_norm {a['grad_norm']:.6g}", flush=True)
        if r0 != {**r1, "ms": r0["ms"]}:
            bad.append(f"step {i}: the ranks differ")
        for k, want in (("loss", a), ("grad_norm", a), ("loss", o)):
            if abs(r0[k] - want[k]) > 1e-3 * abs(want[k]):
                bad.append(f"step {i}: {k} {r0[k]} against one process's "
                           f"{want[k]}")
    med = [float(np.median([r["ms"] for r in recs[1:]]))
           for recs in (*ranks, one)]
    print(f"data parallel (b): 2 gloo ranks on one card, 2 rows each (B=2, "
          f"T=160000, breakdancing, bf16), {DP_STEPS} steps in "
          f"{wall_b:.1f} s with the spawn; step ms (median after the first) "
          f"rank 0 {med[0]:.2f}, rank 1 {med[1]:.2f} (both ranks share the "
          f"card), one process on 4 rows {med[2]:.2f}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    check(not bad, f"data parallel (b): {bad}")
    return {k: sum(rec["launches"][k] for recs in ranks for rec in recs)
            for k in TRAIN_KERNELS}


# the flagship widths through the trainer CLI (README's flagship: layer 10
# x stack 3, C=256, R=S=64) at batch 2 with the fused blocks and the
# default strategy: hsave would be 30*2*160000*64*2 = 1.23 GB, so "auto"
# resolves to recompute, as in the JAX package
FLAGSHIP_FLAGS = ["--layer_size", "10", "--stack_size", "3",
                  "--residual_channels", "64", "--skip_channels", "64",
                  "--input_channels", "256", "--batch_size", "2",
                  "--fused_blocks", "1"]


def _trunk_save_is_replay(torch, model, batch, dtype):
    """The model's trunk on the batch, as its fused loss runs it with the
    replay strategy (the codes' embedding as x; the video's projection
    triple, which the trainer's clip length gives), through ``fused_stack``
    with save and with replay from the same leaves and a seeded dskip: the
    same skip and the same gradient of every leaf, bit for bit, but for
    W_fg's in bf16, which replay forms from the float32 h as the TPU
    kernel does: that one within phase 23's bar of the plain replay's."""
    from movenet_tpu_torch.models import fused
    from movenet_tpu_torch.ops import stack_kernel as sk

    dt, dil = model.dtype, tuple(model.dilations)
    with torch.no_grad():
        ctx, trunk = fused._prepare_trunk(model, batch.codes, batch.video,
                                          None)
        x = sk.front_embed(model.front_cur, model.front_past, batch.codes,
                           dt)
    check(sk.ctx_is_proj(ctx), f"flagship {dtype}: the trunk's video ctx "
          "is not the projection triple")
    s = trunk[2].shape[2] - x.shape[2]
    g = torch.Generator(device=x.device).manual_seed(23)
    dskip = (torch.randn(*x.shape[:2], s, generator=g, device=x.device)
             * 1e-3).to(dt)
    runs = {}
    for strategy in ("save", "replay"):
        leaves = [v.detach().clone().requires_grad_(True)
                  for v in (x, *ctx, *trunk)]
        out = sk.fused_stack(leaves[0], tuple(leaves[1:4]), *leaves[4:], dil,
                             strategy=strategy)
        out.backward(dskip)
        runs[strategy] = (out.detach(), [v.grad for v in leaves])
        del out, leaves
    (so, sg), (ro, rg) = runs["save"], runs["replay"]
    names = ("x", "xc", "wup", "bup", "b_fg", "w_fg", "w_out", "b_out")
    check(torch.equal(so, ro), f"flagship {dtype}: the trunk's skip through "
          "replay differs from save's")
    differ = [n for n, u, v in zip(names, sg, rg) if not torch.equal(u, v)]
    bf16 = dtype == "bfloat16"
    check(set(differ) <= ({"w_fg"} if bf16 else set()),
          f"flagship {dtype}: the trunk's gradients of {differ} through "
          "replay differ from save's")
    note = ""
    if bf16:
        trip = tuple(ctx)
        args = (x, sk.ctx_flatten(trip, dt), *trunk, dil)
        want = _replay_dw_fg_plain(torch, x, args[1],
                                   sk._ctx_proj_args(trip), args, dskip)
        err = _err(rg[names.index("w_fg")], want)
        check(err <= TRUNK_REPLAY_BARS["bf16"]["bwd"] * _scale(want),
              f"flagship bf16: replay's W_fg gradient {err:.3g} from the "
              f"plain replay's, scale {_scale(want):.3g}")
        note = (f" (W_fg's from the float32 h: {err:.3g} from the plain "
                f"replay's, scale {_scale(want):.3g})")
    print(f"flagship {dtype}: the trained trunk through replay (video "
          "projection triple) gives save's skip and every gradient bit for "
          f"bit{note}", flush=True)


def phase_flagship_cli(torch, np, root):
    """The trainer CLI at FLAGSHIP_FLAGS for 1 epoch of 4 steps on
    synthetic clips at the real format: the trunk runs only the recompute
    kernels and the losses are finite; then one loss + backward of the
    trained model on seeded random codes and video through each strategy
    for its peak device memory, and the trunk on that batch through save
    and replay, held bit for bit (``_trunk_save_is_replay``).  Returns a
    summary."""
    from movenet_tpu_torch.data import kinetics_index, make_synthetic_dataset
    from movenet_tpu_torch.models import fused
    from movenet_tpu_torch.ops.cuda import head_loss as kh
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks
    from movenet_tpu_torch.train import Batch

    ds = root / "flagship_clips"
    make_synthetic_dataset(ds, splits=("train", "valid"),
                           categories=["breakdancing"], clips_per_category=8)
    n_val = len(kinetics_index(ds, train=False)) // 2
    ks.reset_launch_counts()
    kh.reset_launch_counts()
    with timed_train_steps(torch) as steps:
        state = trainer_cli(["--dataset", str(ds), *FLAGSHIP_FLAGS,
                          "--n_epochs", "1", "--n_steps_per_epoch", "4",
                          "--val_batch_size", "2", "--model_output_path",
                          str(root / "flagship_run"), "--logger", "jsonl",
                          "--training_logs_path",
                          str(root / "flagship_logs")])
    torch.cuda.synchronize()
    launches = {**ks.launch_counts, **kh.launch_counts}
    check(state.step == 4, f"flagship CLI took {state.step} steps, not 4")
    want = {"stack_fwd_tails": 4 + n_val, "stack_bwd_tails": 4,
            "stack_fwd": 0, "stack_bwd": 0}
    check(all(launches[k] == v for k, v in want.items()),
          f"flagship CLI launches {launches}, expected {want} (the default "
          "strategy must resolve to recompute)")
    lines = [json.loads(l) for l in (root / "flagship_logs" / "metrics.jsonl")
             .read_text().splitlines()]
    losses = [l["loss"] for l in lines if l["tag"] in ("train", "val")]
    check(losses and all(np.isfinite(losses)), f"flagship losses {losses}")
    median = float(np.median(steps.ms[1:]))
    model = state.module
    rng = np.random.default_rng(0)
    batch = Batch(
        codes=torch.from_numpy(rng.integers(
            0, 256, size=(2, model.max_audio_frames))).int(),
        video=torch.from_numpy(rng.standard_normal(
            (2, model.max_video_frames, 64, 64, 1)).astype(np.float32))
    ).to("cuda")
    # one loss + backward through each strategy, in the run's bf16 and in
    # float32 (the same weights: the compute dtype is the model's setting)
    peaks, ms = {}, {}
    keys = {"save": "stack_fwd", "replay": "stack_fwd_replay",
            "recompute": "stack_fwd_tails"}
    for dtype in ("bfloat16", "float32"):
        model.compute_dtype = dtype
        sfx = "_f32" if dtype == "float32" else ""
        for strategy in ("save", "replay", "recompute"):
            model.fused_strategy = strategy
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ks.reset_launch_counts()
            t0 = time.perf_counter()
            loss, _ = fused.fused_train_loss(model, batch.codes, batch.video)
            loss.backward()
            torch.cuda.synchronize()
            ms[(dtype, strategy)] = (time.perf_counter() - t0) * 1e3
            peaks[(dtype, strategy)] = torch.cuda.max_memory_allocated() / 1e9
            check(np.isfinite(float(loss.detach())),
                  f"{strategy} {dtype} loss")
            check(ks.launch_counts[keys[strategy] + sfx] == 1,
                  f"{strategy} {dtype}: {ks.launch_counts}")
            del loss
        torch.cuda.empty_cache()
        _trunk_save_is_replay(torch, model, batch, dtype)
        torch.cuda.empty_cache()
    model.compute_dtype = "bfloat16"
    model.fused_strategy = None
    model.zero_grad(set_to_none=True)
    print(f"flagship trainer CLI ({' '.join(FLAGSHIP_FLAGS)}, default "
          f"strategy: recompute): 4 steps + {n_val} validation batches; step "
          f"ms {[round(v, 2) for v in steps.ms]} (median after the first "
          f"{median:.2f}); losses {[round(v, 6) for v in losses]}; launches "
          f"{launches}", flush=True)
    for dtype in ("bfloat16", "float32"):
        print(f"flagship one loss + backward ({dtype}): peak memory "
              + ", ".join(f"{st} {peaks[(dtype, st)]:.3f} GB"
                          for st in keys)
              + "; " + ", ".join(f"{st} {ms[(dtype, st)]:.1f} ms"
                                 for st in keys)
              + " (first calls)", flush=True)
    for dtype, least in REPLAY_SAVING_GB.items():
        saved = peaks[(dtype, "save")] - peaks[(dtype, "replay")]
        check(saved >= least, f"flagship {dtype}: replay's peak memory only "
              f"{saved:.3f} GB below save's (at least {least})")
    return dict(step_ms=median, peaks={st: peaks[("bfloat16", st)]
                                       for st in keys},
                peaks_by_dtype=peaks, launches=launches)


def f32_head_compare(torch, s, c, b, fwd_name, bwd_name, grid=False):
    """The float32 head kernels against their plain versions at (S, C, B),
    T = 160000 (seeded skip, parity CE, RF 3072), within F32_BARS; their
    times by CUDA events beside the bf16 form's (skip rounded to bf16) and
    the plain version's, and with ``grid`` the backward's device time by
    grid.  Returns (forward record, backward record), each with its
    bound."""
    from movenet_tpu_torch.ops import head_loss as hl
    from movenet_tpu_torch.ops.cuda import head_loss as kh
    from movenet_tpu_torch.utils.time_stack_bwd import by_grid

    t, bf, hlib = 160_000, torch.bfloat16, kh.library()
    label = f"S={s} C={c} B={b}"
    g = torch.Generator(device="cuda").manual_seed(s * c + b)
    rf = 3072
    n_valid = b * (t - rf)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    codes = torch.randint(0, c, (b, t), generator=g, device="cuda",
                          dtype=torch.int32)
    prev = torch.cat([torch.full_like(codes[:, :1], -1), codes[:, :-1]], 1)
    pack = torch.cat([codes, prev, torch.roll(codes, -1, 1)],
                     0).t().contiguous()
    with torch.no_grad():
        skip = rn(b, t, s)
        hargs = (skip, pack, rn(s, c, scale=0.25), rn(c, scale=0.1),
                 rn(c, c, scale=2.5 / c ** 0.5), rn(c, scale=0.1), rf,
                 True, 2 * b)
        hst = kh._stream(skip)
        loss, match, p = kh.head_fwd(*hargs)
        wl, wm, wp = hl.head_fwd_plain(*hargs)
        errs = {"loss": abs(float(loss) - float(wl)) / abs(float(wl)),
                "match": abs(float(match) - float(wm)),
                "p": _err(p, wp)}
        check(errs["loss"] <= F32_BARS["loss"],
              f"{fwd_name} {label}: loss {float(loss)} vs plain "
              f"{float(wl)}")
        check(errs["match"] <= F32_BARS["match"] * n_valid,
              f"{fwd_name} {label}: match {float(match)} vs plain "
              f"{float(wm)} of {n_valid} rows")
        check(errs["p"] <= F32_BARS["p"], f"{fwd_name} {label}: p max err "
              f"{errs['p']:.3g}")
        del p
        bfh = (skip.to(bf), *hargs[1:])
        fwd = dict(
            errs=errs, max_abs_err=errs["p"],
            ms=time_cuda(torch, lambda: kh.run_fwd(hlib, *hargs,
                                                   stream=hst), 3),
            bf16_ms=time_cuda(torch, lambda: kh.run_fwd(hlib, *bfh,
                                                        stream=hst), 3),
            plain_ms=time_cuda(torch, lambda: hl.head_fwd_plain(*hargs), 1))
        dloss = torch.tensor(1.0 / n_valid, device="cuda")
        hb = (skip, pack, wp, *hargs[2:6], rf, True, dloss, 2 * b)
        bar = F32_BARS["head_bwd"]
        errs = _check_grads(f"{bwd_name} {label}", kh.head_bwd(*hb),
                            hl.head_bwd_plain(*hb),
                            dict(dskip=bar, dw1=bar, db1=bar, dw2=bar,
                                 db2=bar))
        bfhb = (skip.to(bf), pack, wp, *hargs[2:6], rf, True, dloss, 2 * b)
        bwd = dict(
            errs=errs, max_abs_err=max(errs.values()),
            ms=time_cuda(torch, lambda: kh.run_bwd(hlib, *hb, stream=hst),
                         3),
            bf16_ms=time_cuda(torch, lambda: kh.run_bwd(hlib, *bfhb,
                                                        stream=hst), 3),
            plain_ms=time_cuda(torch, lambda: hl.head_bwd_plain(*hb), 1))
        if grid:
            print(grid_line(f"f32 kernel {bwd_name} {label}",
                            by_grid(torch, lambda: kh.run_bwd(
                                hlib, *hb, stream=hst), F32_TAILS_GRIDS)),
                  flush=True)
        del wp, hb, bfh, bfhb, skip
    bounds = train_bounds(b, t, 1, 8, s, c, c, 16, False, act=4,
                          peak=TF32_OPS_S)
    fwd["bound"], bwd["bound"] = bounds["head_fwd"], bounds["head_bwd"]
    return fwd, bwd


def phase_f32_tails_kernels(torch, np):
    """Phase 9g (a): the float32 recompute forms against their plain
    versions (TF32 off) at F32_TAILS_SHAPES (seeded float32 x, flat ctx,
    weights and dskip; the backward from the plain checkpoints), and the
    wide float32 head at F32_WIDE_HEADS (seeded skip, parity CE, RF 3072),
    within F32_BARS; each form's time by CUDA events beside the bf16 form's
    on the same shapes (the activations rounded to bf16) and the plain
    version's; the backwards' device time by grid at the flagship's
    shapes.  Returns records by (name, shape label)."""
    from movenet_tpu_torch.ops import stack_kernel as sk
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks
    from movenet_tpu_torch.utils.time_stack_bwd import by_grid

    t, f32, bf = 160_000, torch.float32, torch.bfloat16
    lib = ks.library()
    rec = {}
    for label, (b, dil, r, s) in F32_TAILS_SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(7 + len(dil) + s)
        n, win = len(dil), 3 * r

        def rn(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device="cuda") * scale

        with torch.no_grad():
            args = (rn(b, t, r, scale=0.5), rn(b, t, r, scale=0.5),
                    rn(n * b, 2 * r, scale=0.1),
                    rn(n, win, 2 * r, scale=win ** -0.5),
                    rn(n, r, r + s, scale=r ** -0.5), rn(n, r + s, scale=0.1),
                    dil)
            st = ks._stream(args[0])
            got = ks.stack_fwd_tails(*args)
            want = sk.stack_fwd_tails_plain(*args)
            errs = {}
            for name, u, w in zip(("skip", "ckpt"), got, want):
                check(u.dtype == f32, f"stack_fwd_tails_f32 {label} {name} "
                      f"is {u.dtype}")
                errs[name] = _err(u, w)
                check(errs[name] <= F32_BARS["fwd"] * _scale(w),
                      f"stack_fwd_tails_f32 {label} {name}: max err "
                      f"{errs[name]:.3g}, scale {_scale(w):.3g}")
            ckpt = want[1]
            del got, want
            bfa = (args[0].to(bf), args[1].to(bf), *args[2:])
            rec[("stack_fwd_tails_f32", label)] = dict(
                errs=errs, max_abs_err=max(errs.values()),
                ms=time_cuda(torch, lambda: ks.run_fwd_tails(
                    lib, *args, stream=st), 3),
                bf16_ms=time_cuda(torch, lambda: ks.run_fwd_tails(
                    lib, *bfa, stream=st), 3),
                plain_ms=time_cuda(
                    torch, lambda: sk.stack_fwd_tails_plain(*args), 1))
            dskip = rn(b, t, s, scale=1e-3)
            bargs = (args[0], ckpt, *args[1:-1], dskip, dil)
            got = ks.stack_bwd_tails(*bargs)
            want = sk.stack_bwd_tails_plain(*bargs)
            errs = {}
            for name, u, w in zip(("dx", "dctx", "db_fg", "dw_fg",
                                   "dw_out", "db_out"), got, want):
                check(u.dtype == f32, f"stack_bwd_tails_f32 {label} {name} "
                      f"is {u.dtype}")
                errs[name] = _err(u, w)
                check(errs[name] <= F32_BARS["bwd"] * _scale(w),
                      f"stack_bwd_tails_f32 {label} {name}: max err "
                      f"{errs[name]:.3g}, scale {_scale(w):.3g}")
            del got, want
            _, ckpt_bf = ks.run_fwd_tails(lib, *bfa, stream=st)
            bfb = (bfa[0], ckpt_bf, *bfa[1:-1], dskip.to(bf), dil)
            rec[("stack_bwd_tails_f32", label)] = dict(
                errs=errs, max_abs_err=max(errs.values()),
                ms=time_cuda(torch, lambda: ks.run_bwd_tails(
                    lib, *bargs, stream=st), 3),
                bf16_ms=time_cuda(torch, lambda: ks.run_bwd_tails(
                    lib, *bfb, stream=st), 3),
                plain_ms=time_cuda(
                    torch, lambda: sk.stack_bwd_tails_plain(*bargs), 1))
            if label == "flagship":
                print(grid_line("f32 kernel stack_bwd_tails_f32 flagship",
                                by_grid(torch, lambda: ks.run_bwd_tails(
                                    lib, *bargs, stream=st),
                                    F32_TAILS_GRIDS)), flush=True)
            del args, bfa, bargs, bfb, ckpt, ckpt_bf
        bounds = tails_bounds(b, t, n, r, s, win, sk.tails_every(n), act=4)
        for name in F32_TAILS_KERNELS:
            rec[(name, label)]["bound"] = bounds[name[:-4]]
    for s, c, b in F32_WIDE_HEADS:
        label = f"S={s} C={c} B={b}"
        fwd, bwd = f32_head_compare(torch, s, c, b, "head_fwd_f32_wide",
                                    "head_bwd_f32_wide",
                                    (s, c, b) == F32_WIDE_HEADS[0])
        rec[("head_fwd_f32_wide", label)] = fwd
        rec[("head_bwd_f32_wide", label)] = bwd
    for (name, label), r in rec.items():
        shape = label
        if label in F32_TAILS_SHAPES:
            b, dil, rr, s = F32_TAILS_SHAPES[label]
            shape = (f"{label}: B={b}, T=160000, L={len(dil)}, R={rr}, "
                     f"S={s}, flat ctx")
        print(f"f32 kernel {name} {shape} (float32) vs plain: "
              + ", ".join(f"{k} {x:.3g}" for k, x in r["errs"].items())
              + f"; kernel {r['ms']:.3f} ms, bf16 form {r['bf16_ms']:.3f} "
              f"ms, plain (TF32 off) {r['plain_ms']:.3f} ms, bound "
              f"{r['bound'][0]:.3f} ms ({r['bound'][1]})", flush=True)
    return rec


def f32_routes(torch, np, mc, run, batch, fused_want, label):
    """From checkpoint 0 of ``run``: one loss + backward through the fused
    route, which must launch exactly ``fused_want``, and through the
    unfused route (``window_logits``: torch ops, TF32 off), which must
    launch no training kernel; their losses, grad norms and every leaf
    within F32_ROUTE_BARS.  Returns (errs, the unfused route's peak GB)."""
    from movenet_tpu_torch.models.convert import load_jax_params
    from movenet_tpu_torch.models.wavenet import make_wavenet
    from movenet_tpu_torch.ops.cuda import gated_block as kg
    from movenet_tpu_torch.ops.cuda import head_loss as kh
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks
    from movenet_tpu_torch.train import loop
    from movenet_tpu_torch.train.checkpoint import restore_params

    mods = (ks, kh, kg)
    tree, _ = restore_params(run, 0)
    model = load_jax_params(make_wavenet(mc), tree).to("cuda")
    batch = batch.to("cuda")
    parity = mc.parity_softmax_output
    routes = {}
    for fused in (True, False):
        model.zero_grad(set_to_none=True)
        for mod in mods:
            mod.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = loop._loss_and_metrics(model, parity, fused)(batch)
        loss.backward()
        torch.cuda.synchronize()
        grads = {k: q.grad.detach().clone()
                 for k, q in model.named_parameters() if q.grad is not None}
        routes[fused] = dict(
            loss=float(loss.detach()), grads=grads,
            norm=float(torch.sqrt(sum((x.double() ** 2).sum()
                                      for x in grads.values()))),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches={k: v for mod in mods
                      for k, v in mod.launch_counts.items()})
        del loss
    f, u = routes[True], routes[False]
    want = {k: 0 for k in f["launches"]}
    check(u["launches"] == want, f"{label}: unfused route launches "
          f"{u['launches']}")
    want.update(fused_want)
    check(f["launches"] == want, f"{label}: fused route launches "
          f"{f['launches']}")
    check(set(f["grads"]) == set(u["grads"]), "gradient leaves differ")
    errs = {"loss": abs(f["loss"] - u["loss"]) / abs(u["loss"]),
            "grad_norm": abs(f["norm"] - u["norm"]) / u["norm"]}
    check(errs["loss"] <= F32_ROUTE_BARS["loss"],
          f"{label}: fused loss {f['loss']} vs unfused {u['loss']}")
    check(errs["grad_norm"] <= F32_ROUTE_BARS["grad_norm"],
          f"{label}: fused grad_norm {f['norm']} vs unfused {u['norm']}")
    leaf, leaf_name = 0.0, ""
    for k, gu in u["grads"].items():
        e = _err(f["grads"][k], gu) / max(_scale(gu), 1e-30)
        check(e <= F32_ROUTE_BARS["leaf"], f"{label}: fused vs unfused "
              f"gradient {k}: {e:.3g} of its scale")
        if e > leaf:
            leaf, leaf_name = e, k
    errs["leaf"] = leaf
    print(f"{label}: loss {f['loss']:.8f} vs {u['loss']:.8f} (relative "
          f"{errs['loss']:.3g}), grad_norm {f['norm']:.8g} vs "
          f"{u['norm']:.8g} (relative {errs['grad_norm']:.3g}), largest "
          f"leaf difference {leaf:.3g} of its scale ({leaf_name}); peak "
          f"memory fused {f['peak_gb']:.3f} GB, unfused {u['peak_gb']:.3f} "
          "GB", flush=True)
    del model, routes
    torch.cuda.empty_cache()
    return errs, u["peak_gb"]


def phase_f32_flagship_cli(torch, np, root):
    """Phase 9g (b, c): the trainer CLI with FLAGSHIP_FLAGS and
    --compute_dtype float32 for 1 epoch of 4 steps on phase 16's clips: the
    default strategy resolves to recompute (hsave 2.46 GB in float32), the
    trunk runs only the float32 recompute forms and the head only the
    wide float32 forms (the forwards once a train step and validation
    batch, the backwards once a step), finite losses, the update ms and
    peak memory.  Then from checkpoint 0's weights and the run's first
    batch the fused route against the unfused one (``f32_routes``); where
    the unfused route does not fit the card at B = 2, on the batch's first
    row.  Returns (launches, record)."""
    from movenet_tpu_torch.config import arg_parser, config_from_args
    from movenet_tpu_torch.data import kinetics_index
    from movenet_tpu_torch.models.wavenet import make_wavenet
    from movenet_tpu_torch.ops import stack_kernel as sk
    from movenet_tpu_torch.ops.cuda import gated_block as kg
    from movenet_tpu_torch.ops.cuda import head_loss as kh
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks

    ds = root / "flagship_clips"
    run, logs = root / "f32_flagship_run", root / "f32_flagship_logs"
    argv = ["--dataset", str(ds), *FLAGSHIP_FLAGS, "--compute_dtype",
            "float32", "--n_epochs", "1", "--n_steps_per_epoch", "4",
            "--val_batch_size", "2", "--model_output_path", str(run),
            "--logger", "jsonl", "--training_logs_path", str(logs)]
    cfg = config_from_args(arg_parser().parse_args(argv))
    mc = cfg.model_config
    dil = tuple(make_wavenet(mc).dilations)
    strategy = sk.resolve_strategy(
        "auto", (cfg.batch_size, mc.max_audio_frames, mc.residual_channels),
        len(dil), dil, 4)
    check(strategy == "recompute", f"float32 flagship: strategy {strategy}")
    n_val = len(kinetics_index(ds, train=False)) // 2
    mods = (ks, kh, kg)
    for mod in mods:
        mod.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with timed_train_steps(torch, record=1) as steps:
        state = trainer_cli(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: v for mod in mods for k, v in mod.launch_counts.items()}
    want = {k: 0 for k in launches}
    want.update(stack_fwd_tails_f32=4 + n_val, stack_bwd_tails_f32=4,
                head_fwd_f32_wide=4 + n_val, head_bwd_f32_wide=4)
    check(launches == want, f"float32 flagship CLI launches {launches}, "
          f"expected {want}")
    check(state.step == 4, f"float32 flagship CLI took {state.step} steps")
    lines = [json.loads(l) for l in (logs / "metrics.jsonl").read_text()
             .splitlines()]
    losses = [l["loss"] for l in lines if l["tag"] in ("train", "val")]
    check(losses and all(np.isfinite(losses)),
          f"float32 flagship losses {losses}")
    median = float(np.median(steps.ms[1:]))
    print(f"f32 flagship trainer CLI ({' '.join(FLAGSHIP_FLAGS)} "
          f"--compute_dtype float32; strategy {strategy}): 4 steps + {n_val}"
          f" validation batches in {wall:.1f} s; step ms "
          f"{[round(v, 2) for v in steps.ms]} (median after the first "
          f"{median:.2f}); peak memory {peak_gb:.3f} GB; losses "
          f"{[round(v, 6) for v in losses]}; launches {launches}",
          flush=True)
    del state
    torch.cuda.empty_cache()
    fused_want = dict(stack_fwd_tails_f32=1, stack_bwd_tails_f32=1,
                      head_fwd_f32_wide=1, head_bwd_f32_wide=1)
    batch, rows = steps.batches[0], 2
    try:
        errs, unfused_gb = f32_routes(
            torch, np, mc, run, batch, fused_want,
            "f32 flagship fused vs unfused (checkpoint 0, the run's first "
            "batch, B=2, T=160000)")
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        rows = 1
        # the first row; its codes pack formed again from its codes
        one = type(batch)(codes=batch.codes[:1],
                          video=None if batch.video is None
                          else batch.video[:1],
                          labels=None if batch.labels is None
                          else batch.labels[:1])
        errs, unfused_gb = f32_routes(
            torch, np, mc, run, one, fused_want,
            "f32 flagship fused vs unfused (checkpoint 0, the first row of "
            "the run's first batch: the unfused route does not fit the "
            "card at B=2)")
    return launches, dict(step_ms=median, ms=steps.ms, peak_gb=peak_gb,
                          wall_s=wall, errs=errs, rows=rows,
                          unfused_gb=unfused_gb)


# phase 23: the replay strategy's kernels (the save strategy without
# hsave: the layer inputs rebuilt in the backward), in bf16 and float32,
# counted apart from the save and recompute forms
TRUNK_REPLAY_KERNELS = {
    "stack_fwd_replay": ("movenet_tpu_torch/csrc/stack_kernel.cu",
                         "movenet_tpu/ops/pallas/stack_kernel.py:280"),
    "stack_bwd_replay": ("movenet_tpu_torch/csrc/stack_kernel.cu",
                         "movenet_tpu/ops/pallas/stack_kernel.py:1486"),
}
TRUNK_REPLAY_KERNELS.update(
    {f"{k}_f32": v for k, v in list(TRUNK_REPLAY_KERNELS.items())})
# its bars, of each output's largest magnitude: in bf16 phase 9's (the
# forward's outputs 2%, gradients 1e-3, the bf16 dx and dctx 2%), in
# float32 phase 9f's (TF32 off on the plain side)
TRUNK_REPLAY_BARS = {"bf16": {"fwd": 2e-2, "bwd": 1e-3, "act": 2e-2},
                     "f32": {"fwd": F32_BARS["fwd"], "bwd": F32_BARS["bwd"],
                             "act": F32_BARS["bwd"]}}
# the grids of its backward at the flagship's shapes
TRUNK_REPLAY_GRIDS = (("weights", "stack_wt"),
                      ("rebuild", "stack_rebuild"),
                      ("layer", "stack_bwd_layer_kernel|stack_bwd_wg_kernel"),
                      ("wgrad W_fg",
                       "stack_wgrad_kernel<[047]|stack_wgrad_wg_kernel"),
                      ("wgrad W_out", "stack_wgrad_kernel<[16]"),
                      ("dx", "stack_dx_kernel"),
                      ("reductions", "reduce_kernel"))
# the least peak-memory saving of replay against save over one loss +
# backward at the flagship (phase 16), GB, by compute dtype
REPLAY_SAVING_GB = {"bfloat16": 0.5, "float32": 1.2}


def replay_bounds(b, t, l, r, s, win, every, act=2, proj=False):
    """(bound_ms, bound_by) of the replay kernels: the forward reads x and
    ctx and writes skip, the taps and the float32 checkpoints; the backward
    reads x, the checkpoints, the taps, ctx and dskip and writes dx, dctx
    and the gradients; with the projection triple (``proj``) it reads xc
    and W_up and writes the coarse dxc, dW_up and db_up in place of the
    flat dctx.  Operations: the forward's products at the bf16 peak (the
    float32 form's at the TF32 peak); the backward's rebuilds (R x R a row
    for each of the L - ceil(L/every) rebuilt layers) at the same peak,
    plus the save backward's gradient products (with the triple also
    dxc = dctx W_up^T and dW_up = xc^T dctx) at the TF32 peak, counted
    once."""
    m = b * t
    w_bytes = 4 * l * (win * 2 * r + r * (r + s) + b * 2 * r + r + s)
    ctx = act * m * r if win == 3 * r else 0
    ckpt = 4 * m * r * len(range(every, l, every))
    taps = act * l * m * 2 * r
    grads = 4 * l * (win * 2 * r + r * (r + s) + r + s + b * 2 * r)
    fwd_bytes = act * m * r + ctx + w_bytes + act * m * s + taps + ckpt
    # the ctx gradient: flat, or the coarse dxc with xc read and the
    # projection's weights read and their gradients written
    dctx = (2 * act * m * r // 10 + 2 * 4 * 10 * r * (r + 1)) if proj \
        else ctx
    bwd_bytes = act * m * r + ckpt + taps + ctx + act * m * s + w_bytes \
        + act * m * r + dctx + grads
    fwd_ops = 2 * m * l * (win * 2 * r + r * (r + s))
    rebuild_ops = 2 * m * r * r * (l - len(range(0, l, every)))
    grad_ops = 2 * m * l * ((r + s) * r + 2 * r * win + (win + 1) * 2 * r
                            + (r + 1) * (r + s)) \
        + (2 * m * r * (2 * r + 1) if proj else 0)
    low = TF32_OPS_S if act == 4 else BF16_OPS_S

    def bound(nbytes, ops_ms):
        tb = nbytes / HBM_BYTES_S * 1e3
        return (tb, "bytes") if tb >= ops_ms else (ops_ms, "operations")

    sfx = "_f32" if act == 4 else ""
    return {"stack_fwd_replay" + sfx: bound(fwd_bytes, fwd_ops / low * 1e3),
            "stack_bwd_replay" + sfx: bound(
                bwd_bytes, (rebuild_ops / low + grad_ops / TF32_OPS_S) * 1e3)}


def _replay_case(torch, lib, args, dskip, label, dt_name, proj=None):
    """One shape, ctx form and dtype of phase 23 (a): the replay kernels
    against their plain versions within TRUNK_REPLAY_BARS, and against the
    save kernels' non-embed form from the same x bit for bit (the forward's
    skip and taps, the checkpoints against hsave, every rebuilt float32
    layer input against the checkpoints and, rounded, hsave, the
    backward's outputs but for dW_fg in bf16, which takes the float32 h as
    the TPU kernel does and is held to the plain version below); their
    times beside the save kernels' and the plain versions'.  ``proj`` (xc, wup_t): the backward folds the
    projection triple's gradient in, ctx in args being its flat form.
    Returns (fwd record, bwd record)."""
    from movenet_tpu_torch.ops import stack_kernel as sk
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks
    from movenet_tpu_torch.utils.time_stack_bwd import by_grid

    bars = TRUNK_REPLAY_BARS[dt_name]
    x, ctx, _, w_fg, w_out, b_out, dil = args
    what = f"replay {dt_name} {label}"
    st = ks._stream(x)
    got = ks.run_fwd_replay(lib, *args, stream=st)
    want = sk.stack_fwd_replay_plain(*args)
    errs = {}
    for name, u, w in zip(("skip", "ckpt", "tfsg"), got, want):
        check(u.dtype == w.dtype and u.shape == w.shape,
              f"{what} {name}: {u.dtype} {tuple(u.shape)}")
        errs[name] = _err(u, w)
        check(errs[name] <= bars["fwd"] * _scale(w), f"{what} {name}: max "
              f"err {errs[name]:.3g}, scale {_scale(w):.3g}")
    # bit for bit against the save strategy from the same x
    skip, hsave, tfsg = ks.run_fwd_x(lib, *args, stream=st)
    check(torch.equal(got[0], skip) and torch.equal(got[2], tfsg),
          f"{what}: the forward's skip or taps differ from the save "
          "forward's")
    n = len(dil)
    for i, l in enumerate(sk.ckpt_layers(n, sk.tails_every(n))):
        check(torch.equal(got[1][i].to(x.dtype), hsave[l]),
              f"{what}: checkpoint {i} is not the save forward's input of "
              f"layer {l}")
    rebuilt = ks.run_replay_inputs(lib, x, got[1], got[2], w_out, b_out,
                                   stream=st)
    check(torch.equal(rebuilt.to(x.dtype), hsave), f"{what}: the rebuilt "
          "layer inputs differ from the save forward's hsave")
    check(all(torch.equal(rebuilt[l], got[1][i]) for i, l in enumerate(
        sk.ckpt_layers(n, sk.tails_every(n)))),
        f"{what}: the rebuilt layer inputs differ from the checkpoints")
    del rebuilt
    bk = (x, got[1], got[2], ctx, w_fg, w_out, b_out, dskip, dil, proj)
    bs = (hsave, tfsg, ctx, w_fg, w_out, dskip, dil, proj)
    # in bf16 W_fg's gradient (index 3) takes the float32 h: not save's
    differ = {i for i, (u, v) in enumerate(zip(
        ks.run_bwd_replay(lib, *bk, stream=st),
        ks.run_bwd_x(lib, *bs, stream=st))) if u is not None
        and not torch.equal(u, v)}
    check(differ <= ({3} if dt_name == "bf16" else set()),
          f"{what}: the backward's outputs {sorted(differ)} differ from the "
          "save backward's")
    fwd = dict(errs=errs, max_abs_err=max(errs.values()),
               ms=time_cuda(torch, lambda: ks.run_fwd_replay(
                   lib, *args, stream=st), 3),
               save_ms=time_cuda(torch, lambda: ks.run_fwd_x(
                   lib, *args, stream=st), 3),
               plain_ms=time_cuda(
                   torch, lambda: sk.stack_fwd_replay_plain(*args), 1))
    bwd = dict(ms=time_cuda(torch, lambda: ks.run_bwd_replay(
                   lib, *bk, stream=st), 3),
               save_ms=time_cuda(torch, lambda: ks.run_bwd_x(
                   lib, *bs, stream=st), 3))
    if label.startswith("flagship"):
        bwd["by_grid"] = by_grid(torch, lambda: ks.run_bwd_replay(
            lib, *bk, stream=st), TRUNK_REPLAY_GRIDS)
        print(grid_line(f"kernel stack_bwd_replay {dt_name} {label}",
                        bwd["by_grid"]), flush=True)
    del got, skip, hsave, tfsg, bk, bs
    # against the plain backward from the plain forward's saved tensors
    bargs = (x, want[1], want[2], ctx, w_fg, w_out, b_out, dskip, dil, proj)
    errs = {}
    for name, u, w in zip(("dx", "dctx", "db_fg", "dw_fg", "dw_out",
                           "db_out", "dwup_aug"),
                          ks.run_bwd_replay(lib, *bargs, stream=st),
                          sk.stack_bwd_replay_plain(*bargs)):
        if w is None:
            continue
        check(u.dtype == w.dtype, f"{what} {name} is {u.dtype}")
        errs[name] = _err(u, w)
        bar = bars["act" if name in ("dx", "dctx") else "bwd"]
        check(errs[name] <= bar * _scale(w), f"{what} {name}: max err "
              f"{errs[name]:.3g}, scale {_scale(w):.3g}")
    bwd.update(errs=errs, max_abs_err=max(errs.values()),
               plain_ms=time_cuda(
                   torch, lambda: sk.stack_bwd_replay_plain(*bargs), 1))
    return fwd, bwd


def phase_trunk_replay_kernels(torch, np):
    """Phase 23 (a): the replay kernels in bf16 and float32 at
    F32_TAILS_SHAPES (the flagship's trunk and experiment 02's, T=160000;
    seeded x, weights and dskip) with a flat ctx and with the projection
    triple, the form that the trainer's video context takes at these
    lengths, through ``_replay_case``; then at the flagship
    ``fused_stack`` through the save and the replay strategy with autograd
    from the same x, in each dtype and ctx form: the same skip and
    gradients, and the launches of the float32 non-embed save forms.
    Returns (records by (name, shape label), those launches); the labels
    are the shape's, with " proj" for the triple."""
    from movenet_tpu_torch.ops import stack_kernel as sk
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks

    t, lib = 160_000, ks.library()
    rec, non_embed = {}, {}
    for shape, (b, dil, r, s) in F32_TAILS_SHAPES.items():
        n, win = len(dil), 3 * r
        for dt_name, dt in (("bf16", torch.bfloat16),
                            ("f32", torch.float32)):
            for ctx_kind in ("flat", "proj"):
                g = torch.Generator(device="cuda").manual_seed(
                    11 + n + s + 2 * (ctx_kind == "proj"))

                def rn(*shape, scale=1.0):
                    return torch.randn(*shape, generator=g,
                                       device="cuda") * scale

                sfx = "_f32" if dt_name == "f32" else ""
                label = shape if ctx_kind == "flat" else f"{shape} proj"
                with torch.no_grad():
                    x = rn(b, t, r, scale=0.5).to(dt)
                    trip = proj = None
                    if ctx_kind == "flat":
                        ctx = rn(b, t, r, scale=0.5).to(dt)
                    else:
                        trip = (rn(b, t // 10, r, scale=0.5).to(dt),
                                rn(r, 10 * r, scale=r ** -0.5),
                                rn(10 * r, scale=0.1))
                        ctx = sk.ctx_flatten(trip, dt)
                        proj = sk._ctx_proj_args(trip)
                    args = (x, ctx, rn(n * b, 2 * r, scale=0.1),
                            rn(n, win, 2 * r, scale=win ** -0.5),
                            rn(n, r, r + s, scale=r ** -0.5),
                            rn(n, r + s, scale=0.1), dil)
                    dskip = (rn(b, t, s) * 1e-3).to(dt)
                    fwd, bwd = _replay_case(torch, lib, args, dskip, label,
                                            dt_name, proj)
                bounds = replay_bounds(b, t, n, r, s, win,
                                       sk.tails_every(n),
                                       act=4 if sfx else 2,
                                       proj=proj is not None)
                for name, r_ in (("stack_fwd_replay" + sfx, fwd),
                                 ("stack_bwd_replay" + sfx, bwd)):
                    r_["bound"] = bounds[name]
                    rec[(name, label)] = r_
                if shape != "flagship":
                    continue
                # the user's entry: fused_stack, save against replay
                ctx_in = trip if trip is not None else (ctx,)
                k = len(ctx_in)
                leaves = [v.detach().clone().requires_grad_(True)
                          for v in (x, *ctx_in, *args[2:-1])]
                runs = {}
                for strategy in ("save", "replay"):
                    for v in leaves:
                        v.grad = None
                    ks.reset_launch_counts()
                    c = tuple(leaves[1:1 + k]) if k == 3 else leaves[1]
                    out = sk.fused_stack(leaves[0], c, *leaves[1 + k:], dil,
                                         strategy=strategy)
                    out.backward(dskip)
                    torch.cuda.synchronize()
                    runs[strategy] = (out.detach(), [v.grad for v in leaves],
                                      dict(ks.launch_counts))
                (so, sg, sl), (ro, rg, rl) = runs["save"], runs["replay"]
                # W_fg's gradient: in bf16 replay's takes the float32 h
                iw = 2 + k
                check(torch.equal(so, ro) and all(
                    torch.equal(u, v) for i, (u, v) in enumerate(zip(sg, rg))
                    if sfx or i != iw),
                    f"fused_stack {dt_name} {label}: replay's skip or "
                    "gradients differ from save's")
                if not sfx:
                    want = _replay_dw_fg_plain(torch, x, ctx, proj, args,
                                               dskip)
                    err = _err(rg[iw], want)
                    check(err <= TRUNK_REPLAY_BARS["bf16"]["bwd"]
                          * _scale(want), f"fused_stack bf16 {label}: "
                          f"replay's W_fg gradient {err:.3g} from the plain "
                          f"replay's, scale {_scale(want):.3g}")
                want = {k_: 0 for k_ in sl}
                want.update({"stack_fwd" + sfx: 1, "stack_bwd" + sfx: 1})
                check(sl == want,
                      f"fused_stack save {dt_name} {label}: launches {sl}")
                want = {k_: 0 for k_ in rl}
                want.update({"stack_fwd_replay" + sfx: 1,
                             "stack_bwd_replay" + sfx: 1})
                check(rl == want,
                      f"fused_stack replay {dt_name} {label}: launches {rl}")
                if sfx:
                    for k_ in ("stack_fwd_f32", "stack_bwd_f32"):
                        non_embed[k_] = non_embed.get(k_, 0) + sl[k_]
                del leaves, runs, so, sg, ro, rg, args, x, ctx, trip, proj
            torch.cuda.empty_cache()
    for (name, label), r in rec.items():
        b, dil, rr, s = F32_TAILS_SHAPES[label.split()[0]]
        ctx_form = "projection triple" if label.endswith("proj") \
            else "flat ctx"
        print(f"kernel {name} {label} (B={b}, T=160000, L={len(dil)}, "
              f"R={rr}, S={s}, {ctx_form}) vs plain: "
              + ", ".join(f"{k} {x:.3g}" for k, x in r["errs"].items())
              + f"; bit-equal to the save kernels; kernel {r['ms']:.3f} ms, "
              f"save form {r['save_ms']:.3f} ms, plain {r['plain_ms']:.3f} "
              f"ms, bound {r['bound'][0]:.3f} ms ({r['bound'][1]})",
              flush=True)
    return rec, non_embed


def _replay_dw_fg_plain(torch, x, ctx, proj, args, dskip):
    """W_fg's gradient of the plain replay strategy on ``args`` = (x, the
    flat ctx, b_fg, w_fg, w_out, b_out, dilations), dskip and ``proj``
    (the triple's (xc, wup_t), or None)."""
    from movenet_tpu_torch.ops import stack_kernel as sk

    _, ckpt, tfsg = sk.stack_fwd_replay_plain(*args)
    return sk.stack_bwd_replay_plain(x, ckpt, tfsg, ctx, *args[3:6], dskip,
                                     args[-1], proj)[3]


def phase_trunk_replay_cli(torch, np, root):
    """Phase 23 (c): the trainer CLI with FLAGSHIP_FLAGS --fused_strategy
    replay for 1 epoch of 4 steps on phase 16's clips, in bf16 and with
    --compute_dtype float32: the trunk runs only the replay kernels and the
    head only its kernels at C = 256 (the forwards once a train step and
    validation batch, the backwards once a step), finite losses, update ms
    and peak memory.  Returns (launches, records by dtype)."""
    from movenet_tpu_torch.data import kinetics_index
    from movenet_tpu_torch.ops.cuda import gated_block as kg
    from movenet_tpu_torch.ops.cuda import head_loss as kh
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks

    ds = root / "flagship_clips"
    n_val = len(kinetics_index(ds, train=False)) // 2
    mods = (ks, kh, kg)
    launches, recs = {}, {}
    for dtype, sfx, head in (("bfloat16", "", ""),
                             ("float32", "_f32", "_f32_wide")):
        run, logs = root / f"replay_run_{dtype}", root / f"replay_logs_{dtype}"
        for mod in mods:
            mod.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with timed_train_steps(torch) as steps:
            state = trainer_cli([
                "--dataset", str(ds), *FLAGSHIP_FLAGS, "--fused_strategy",
                "replay", "--compute_dtype", dtype, "--n_epochs", "1",
                "--n_steps_per_epoch", "4", "--val_batch_size", "2",
                "--model_output_path", str(run), "--logger", "jsonl",
                "--training_logs_path", str(logs)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        got = {k: v for mod in mods for k, v in mod.launch_counts.items()}
        want = {k: 0 for k in got}
        want.update({"stack_fwd_replay" + sfx: 4 + n_val,
                     "stack_bwd_replay" + sfx: 4,
                     "head_fwd" + head: 4 + n_val, "head_bwd" + head: 4})
        check(got == want, f"replay trainer CLI ({dtype}) launches {got}, "
              f"expected {want}")
        check(state.step == 4, f"replay trainer CLI ({dtype}) took "
              f"{state.step} steps")
        lines = [json.loads(l) for l in (logs / "metrics.jsonl").read_text()
                 .splitlines()]
        losses = [l["loss"] for l in lines if l["tag"] in ("train", "val")]
        check(losses and all(np.isfinite(losses)),
              f"replay trainer CLI ({dtype}) losses {losses}")
        median = float(np.median(steps.ms[1:]))
        print(f"replay trainer CLI ({' '.join(FLAGSHIP_FLAGS)} "
              f"--fused_strategy replay --compute_dtype {dtype}): 4 steps + "
              f"{n_val} validation batches in {wall:.1f} s; step ms "
              f"{[round(v, 2) for v in steps.ms]} (median after the first "
              f"{median:.2f}); peak memory {peak_gb:.3f} GB; losses "
              f"{[round(v, 6) for v in losses]}; launches {got}", flush=True)
        launches.update({k: got[k] for k in ("stack_fwd_replay" + sfx,
                                             "stack_bwd_replay" + sfx)})
        recs[dtype] = dict(step_ms=median, peak_gb=peak_gb, wall_s=wall)
        del state
        torch.cuda.empty_cache()
    return launches, recs


PACKED_KERNELS = {
    "head_fwd_packed": ("movenet_tpu_torch/csrc/head_loss.cu",
                        "movenet_tpu/ops/pallas/head_loss.py:169"),
    "head_bwd_packed": ("movenet_tpu_torch/csrc/head_loss.cu",
                        "movenet_tpu/ops/pallas/head_loss.py:218"),
}
# the head kernels at experiment 03's and 04's C = 128 (S = 8, B = 3 and
# 2) and at C = 256 with S = 16 and with the flagship's S = 64 (B = 2)
WIDE_HEADS = ((8, 128, 3), (8, 128, 2), (16, 256, 2), (64, 256, 2))


def packed_bounds(m, s, c, b, t):
    """(bound_ms, bound_by) of the packed head kernels: skip, targets and
    the weights read (backward: dskip and the gradients written too);
    every product on float32 operands on the tensor cores, at the TF32
    peak counted once (the split passes are the design's cost, not the
    work), the backward rebuilding y and z."""
    hw = 4 * (s * c + c * c + 2 * c)
    fwd_bytes = 2 * m * s + 4 * t * b + hw
    bwd_bytes = fwd_bytes + 2 * m * s + hw
    fwd_ops = 2 * m * (s * c + c * c)
    bwd_ops = 2 * m * (3 * s * c + 3 * c * c)

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_S * 1e3, ops / TF32_OPS_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    return {"head_fwd_packed": bound(fwd_bytes, fwd_ops),
            "head_bwd_packed": bound(bwd_bytes, bwd_ops)}


def _check_grads(label, got, want, tols):
    errs = {}
    for name, x, y in zip(("dskip", "dw1", "db1", "dw2", "db2"), got, want):
        errs[name] = _err(x, y)
        check(errs[name] <= tols[name] * _scale(y),
              f"{label} {name}: max err {errs[name]:.3g}, scale "
              f"{_scale(y):.3g}")
    return errs


def phase_packed_head(torch, np, model, batch):
    """PACKED_HEAD on at the breakdancing head shapes (B=2, T=160000,
    S=C=64, bf16 skip, seeded), parity on and off: the packed kernels
    against their plain versions and, loosely, against the unpacked
    kernels (which round the product operands to bf16); their times
    beside the unpacked pair's on the same inputs, with the packed
    kernels' registers, spills and shared memory; and the op's route
    (fused_head_loss at tgt_off 0, forward + backward, the main path of
    this form) through each packed kernel once."""
    from movenet_tpu_torch.ops import head_loss as hl
    from movenet_tpu_torch.ops.cuda import head_loss as kh

    b, t = batch.codes.shape
    s, c = model.skip_channels, model.input_channels
    rf = model.receptive_fields
    g = torch.Generator(device="cuda").manual_seed(9)
    skip = torch.randn(b, t, s, generator=g, device="cuda").to(torch.bfloat16)
    tgt = torch.roll(batch.codes.int(), -1, 1).t().contiguous()
    w = tuple(x.detach() for x in (model.head1.kernel, model.head1.bias,
                                   model.head2.kernel, model.head2.bias))
    dloss = torch.tensor(1.0 / (b * (t - rf)), device="cuda")
    lib, st = kh.library(), kh._stream(skip)
    rec = {"head_fwd_packed": {}, "head_bwd_packed": {}}
    with torch.no_grad():
        for parity in (True, False):
            args = (skip, tgt, *w, rf, parity)
            # tolerance: float32 sums of 320000 rows in other orders, loss
            # rtol 1e-4; both sides form z from float32 operands, so the
            # match counts are equal
            loss, match = kh.head_fwd_packed(*args)
            wl, wm = hl.head_fwd_packed_plain(*args)
            check(abs(float(loss) - float(wl)) <= 1e-4 * abs(float(wl)),
                  f"head_fwd_packed parity={parity}: loss {float(loss)} vs "
                  f"plain {float(wl)}")
            check(float(match) == float(wm),
                  f"head_fwd_packed parity={parity}: match {float(match)} vs "
                  f"plain {float(wm)}")
            # against the unpacked kernel (bf16 operands): within 1e-2
            ul, um, up = kh.head_fwd(skip, tgt, *w, rf, parity, 0)
            unpacked_rel = abs(float(ul) - float(loss)) / abs(float(loss))
            check(unpacked_rel <= 1e-2, f"packed vs unpacked loss "
                  f"{float(loss)} vs {float(ul)}")
            # gradients: float32 sums in other orders, 1e-3 of each
            # gradient's scale, dskip (bf16) 1%; against the unpacked
            # kernels, whose operands are rounded to bf16 and whose parity
            # gradients cancel, each within 20% of its norm (the
            # recompute-vs-save bar of phase 11)
            got = kh.head_bwd_packed(*args, dloss)
            want = hl.head_bwd_packed_plain(*args, dloss)
            errs = _check_grads("head_bwd_packed", got, want,
                                dict(dskip=1e-2, dw1=1e-3, db1=1e-3,
                                     dw2=1e-3, db2=1e-3))
            unpacked = kh.head_bwd(skip, tgt, up, *w, rf, parity, dloss, 0)
            un_errs = {}
            for name, x, y in zip(("dskip", "dw1", "db1", "dw2", "db2"),
                                  got, unpacked):
                x, y = x.float(), y.float()
                un_errs[name] = float((x - y).norm() / (y.norm() + 1e-30))
                check(un_errs[name] <= 0.2, f"packed vs unpacked {name}: "
                      f"{un_errs[name]:.3g} of the norm")
            key = f"parity={parity}"
            rec["head_fwd_packed"][key] = dict(
                max_abs_err=abs(float(loss) - float(wl)),
                loss=float(loss), match=float(match),
                unpacked_loss_rel=unpacked_rel,
                ms=time_cuda(torch, lambda: kh.run_fwd(
                    lib, skip, tgt, *w, rf, parity, 0, False, st,
                    packed=True), 5),
                plain_ms=time_cuda(
                    torch, lambda: hl.head_fwd_packed_plain(*args), 2))
            rec["head_bwd_packed"][key] = dict(
                max_abs_err=max(errs.values()), errs=errs,
                unpacked_errs=un_errs,
                ms=time_cuda(torch, lambda: kh.run_bwd(
                    lib, skip, tgt, None, *w, rf, parity, dloss, 0, st), 5),
                plain_ms=time_cuda(
                    torch, lambda: hl.head_bwd_packed_plain(*args, dloss), 2))
    # the unpacked pair on the same inputs (parity CE), timed beside them
    with torch.no_grad():
        unpacked_ms = time_cuda(torch, lambda: kh.run_fwd(
            lib, skip, tgt, *w, rf, True, 0, True, st), 5)
        up = kh.run_fwd(lib, skip, tgt, *w, rf, True, 0, True, st)[2]
        unpacked_ms += time_cuda(torch, lambda: kh.run_bwd(
            lib, skip, tgt, up, *w, rf, True, dloss, 0, st), 5)
        del up
    # the op with the switch on: forward + backward through the packed
    # kernels, no softmax saved, no unpacked launch
    saved = hl.PACKED_HEAD
    hl.PACKED_HEAD = True
    try:
        leaves = [x.clone().requires_grad_(True) for x in (skip, *w)]
        kh.reset_launch_counts()
        loss, _ = hl.fused_head_loss(leaves[0], tgt, *leaves[1:], rf, True, 0)
        (loss / (b * (t - rf))).backward()
        torch.cuda.synchronize()
        launches = dict(kh.launch_counts)
    finally:
        hl.PACKED_HEAD = saved
    want = {k: 0 for k in launches}
    want.update(head_fwd_packed=1, head_bwd_packed=1)
    check(launches == want, f"packed route launches {launches}")
    want = hl.head_bwd_packed_plain(skip, tgt, *w, rf, True, dloss)
    _check_grads("packed route", [x.grad for x in leaves], want,
                 dict(dskip=1e-2, dw1=1e-3, db1=1e-3, dw2=1e-3, db2=1e-3))
    for name, byp in rec.items():
        for key, r in byp.items():
            print(f"packed {name} {key} vs plain: max err "
                  f"{r['max_abs_err']:.3g}; kernel {r['ms']:.3f} ms, plain "
                  f"{r['plain_ms']:.3f} ms"
                  + (f"; match {r['match']:.0f} equal; loss within "
                     f"{r['unpacked_loss_rel']:.3g} of the unpacked kernel's"
                     if "match" in r else
                     "; against the unpacked kernels, of the norm: "
                     + ", ".join(f"{k} {v:.3g}"
                                 for k, v in r["unpacked_errs"].items())),
                  flush=True)
    print(f"packed route (PACKED_HEAD on, fused_head_loss tgt_off 0): "
          f"launches {launches}", flush=True)
    from movenet_tpu_torch.ops.cuda import build
    ptxas = dict(ptxas_report(build.build_logs.get("head_loss", "")))
    for bwd, name in enumerate(PACKED_KERNELS):
        kernel = f"{name}_kernel"
        print(f"packed {kernel}: {ptxas.get(kernel, 'not in the nvcc log')}"
              f"; dynamic shared memory "
              f"{lib.movenet_head_packed_smem(bwd)} bytes a block",
              flush=True)
    packed_ms = sum(rec[k]["parity=True"]["ms"] for k in PACKED_KERNELS)
    print(f"packed pair (parity): {packed_ms:.3f} ms against the unpacked "
          f"pair's {unpacked_ms:.3f} ms (head_fwd + head_bwd) on the same "
          f"inputs", flush=True)
    for r in rec.values():
        r["parity=True"]["unpacked_pair_ms"] = unpacked_ms
    return rec, {k: launches[k] for k in PACKED_KERNELS}


def phase_wide_head(torch, np):
    """The head kernels at WIDE_HEADS (T = 160000, bf16, parity CE,
    targets in the codes pack; seeded random skip, codes and weights)
    against their plain versions, with their times; records by (name, S,
    C, B)."""
    from movenet_tpu_torch.ops import head_loss as hl
    from movenet_tpu_torch.ops.cuda import head_loss as kh

    t, rf = 160_000, 24
    rec = {}
    for s, c, b in WIDE_HEADS:
        g = torch.Generator(device="cuda").manual_seed(s * c + b)
        codes = torch.randint(0, c, (b, t), generator=g, device="cuda",
                              dtype=torch.int32)
        prev = torch.cat([torch.full_like(codes[:, :1], -1), codes[:, :-1]],
                         1)
        pack = torch.cat([codes, prev, torch.roll(codes, -1, 1)],
                         0).t().contiguous()
        skip = torch.randn(b, t, s, generator=g, device="cuda").to(
            torch.bfloat16)
        w1 = torch.randn(s, c, generator=g, device="cuda") / 4
        b1 = torch.randn(c, generator=g, device="cuda") * 0.1
        w2 = torch.randn(c, c, generator=g, device="cuda") * (2.5 / c ** 0.5)
        b2 = torch.randn(c, generator=g, device="cuda") * 0.1
        hargs = (skip, pack, w1, b1, w2, b2, rf, True, 2 * b)
        with torch.no_grad():
            # tolerances as the train kernels' phase: loss rtol 1e-4,
            # matches within 10 rows, p 2e-4, gradients 1e-3 of their
            # scale, dskip (bf16) 1%
            loss, match, p = kh.head_fwd(*hargs)
            wl, wm, wp = hl.head_fwd_plain(*hargs)
            check(abs(float(loss) - float(wl)) <= 1e-4 * abs(float(wl)),
                  f"head_fwd S={s} C={c} B={b}: loss {float(loss)} vs "
                  f"{float(wl)}")
            check(abs(float(match) - float(wm)) <= 10,
                  f"head_fwd S={s} C={c} B={b}: match {float(match)} vs "
                  f"{float(wm)}")
            perr = _err(p, wp)
            check(perr <= 2e-4, f"head_fwd S={s} C={c}: p err {perr:.3g}")
            del wp
            dloss = torch.tensor(1.0 / (b * (t - rf)), device="cuda")
            hb = (skip, pack, p, w1, b1, w2, b2, rf, True, dloss, 2 * b)
            errs = _check_grads(f"head_bwd S={s} C={c} B={b}",
                                kh.head_bwd(*hb), hl.head_bwd_plain(*hb),
                                dict(dskip=1e-2, dw1=1e-3, db1=1e-3,
                                     dw2=1e-3, db2=1e-3))
            lib, st = kh.library(), kh._stream(skip)
            rec[("head_fwd", s, c, b)] = dict(
                max_abs_err=perr, ms=time_cuda(
                    torch, lambda: kh.run_fwd(lib, *hargs, stream=st), 5),
                plain_ms=time_cuda(torch, lambda: hl.head_fwd_plain(*hargs),
                                   2))
            rec[("head_bwd", s, c, b)] = dict(
                max_abs_err=max(errs.values()), errs=errs, ms=time_cuda(
                    torch, lambda: kh.run_bwd(lib, *hb, stream=st), 5),
                plain_ms=time_cuda(torch, lambda: hl.head_bwd_plain(*hb), 2))
            del p, hb
    for (name, s, c, b), r in rec.items():
        print(f"wide head {name} S={s} C={c} B={b} (T=160000, bf16) vs "
              f"plain: max err {r['max_abs_err']:.3g}; kernel "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms", flush=True)
    return rec


# the save kernels at the experiments' widths (B, R, S, dilations); V =
# their --input_channels 128
NARROW_TRUNKS = {"exp03": (3, 32, 8, (1, 2, 1, 2)),
                 "exp04": (2, 16, 8, tuple(2 ** i for i in range(14)))}


def phase_narrow_trunk(torch, np):
    """The save kernels (embed form, the video as the stride-10 projection
    triple) at experiment 03's and 04's shapes, T = 160000, bf16, seeded
    random codes, table, triple and weights, forward and backward against
    their plain versions, with their times; records by (name, exp)."""
    from movenet_tpu_torch.ops import stack_kernel as sk
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks
    from movenet_tpu_torch.utils.time_stack_bwd import FWD_GRIDS, by_grid

    t, v, bf = 160_000, 128, torch.bfloat16
    rec = {}
    for exp, (b, r, s, dil) in NARROW_TRUNKS.items():
        g = torch.Generator(device="cuda").manual_seed(r + len(dil))
        n = len(dil)

        def rn(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device="cuda") * scale

        codes = torch.randint(0, v, (b, t), generator=g, device="cuda",
                              dtype=torch.int32)
        prev = torch.cat([torch.full_like(codes[:, :1], -1), codes[:, :-1]],
                         1)
        pack = torch.cat([codes, prev, torch.roll(codes, -1, 1)],
                         0).t().contiguous()
        trip = (rn(b, t // 10, r, scale=0.5).to(bf),
                rn(r, 10 * r, scale=r ** -0.5), rn(10 * r, scale=0.1))
        with torch.no_grad():
            ctx = sk.ctx_flatten(trip, bf)
            proj = sk._ctx_proj_args(trip)
            win = 3 * r
            fargs = (pack, rn(2 * v, r, scale=0.5).to(bf),
                     ctx, rn(n * b, 2 * r, scale=0.1),
                     rn(n, win, 2 * r, scale=win ** -0.5),
                     rn(n, r, r + s, scale=r ** -0.5),
                     rn(n, r + s, scale=0.1), dil, b)
            # tolerances as the train kernels' phase: forward 2% of each
            # output's scale, backward 1e-3 of each gradient's, dxc 2%
            got, want = ks.stack_fwd(*fargs), sk.stack_fwd_plain(*fargs)
            errs, equal = {}, {}
            for name, x, y in zip(("skip", "hsave", "tfsg"), got, want):
                errs[name] = _err(x, y)
                equal[name] = float((x == y).float().mean())
                check(errs[name] <= 2e-2 * _scale(y),
                      f"stack_fwd {exp} {name}: max err {errs[name]:.3g}")
            del got
            lib, st = ks.library(), ks._stream(pack)

            def fwd():
                return ks.run_fwd(lib, *fargs, st)

            rec[("stack_fwd", exp)] = dict(
                max_abs_err=max(errs.values()), errs=errs, equal=equal,
                ms=time_cuda(torch, fwd, 5),
                plain_ms=time_cuda(torch, lambda: sk.stack_fwd_plain(*fargs),
                                   2),
                by_grid=by_grid(torch, fwd, FWD_GRIDS))
            print(grid_line(f"narrow trunk stack_fwd {exp}",
                            rec[("stack_fwd", exp)]["by_grid"]), flush=True)
            _, hsave, tfsg = want
            dskip = rn(b, t, s, scale=1e-3).to(bf)
            bargs = (hsave, tfsg, ctx, fargs[4], fargs[5], dskip, pack, v,
                     dil, proj)
            got, want = ks.stack_bwd(*bargs), sk.stack_bwd_plain(*bargs)
            errs = {}
            for name, x, y in zip(("dtab", "dxc", "db_fg", "dw_fg", "dw_out",
                                   "db_out", "dwup_aug"), got, want):
                errs[name] = _err(x, y)
                tol = (2e-2 if name == "dxc" else 1e-3) * _scale(y)
                check(errs[name] <= tol, f"stack_bwd {exp} {name}: max err "
                      f"{errs[name]:.3g}, scale {_scale(y):.3g}")
            del got, want
            rec[("stack_bwd", exp)] = dict(
                max_abs_err=max(errs.values()), errs=errs,
                ms=time_cuda(torch, lambda: ks.run_bwd(lib, *bargs,
                                                       stream=st), 5),
                plain_ms=time_cuda(torch, lambda: sk.stack_bwd_plain(*bargs),
                                   2),
                by_grid=by_grid(torch, lambda: ks.run_bwd(lib, *bargs,
                                                          stream=st)),
                bound=train_bounds(b, t, n, r, s, 128, v, win, True))
            print(grid_line(f"narrow trunk stack_bwd {exp}",
                            rec[("stack_bwd", exp)]["by_grid"]), flush=True)
            rec[("stack_fwd", exp)]["bound"] = rec[("stack_bwd", exp)][
                "bound"]
            del hsave, tfsg, bargs, fargs
    for (name, exp), r in rec.items():
        b, rr, s, dil = NARROW_TRUNKS[exp]
        equal = ""
        if "equal" in r:
            equal = "; bit-equal share " + ", ".join(
                f"{k} {x:.6f}" for k, x in r["equal"].items())
        print(f"narrow trunk {name} {exp} (B={b}, T=160000, L={len(dil)}, "
              f"R={rr}, S={s}, V=128, bf16, video triple) vs plain: "
              + ", ".join(f"{k} {x:.3g}" for k, x in r["errs"].items())
              + f"{equal}; kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms", flush=True)
    return rec


class recorded_schedule:
    """Within the block each update's LR and beta1 (as the optimizer holds
    them when it steps) are recorded (observation only)."""

    def __enter__(self):
        from movenet_tpu_torch.train import optim

        self.real = optim.Schedules.apply
        seen = self.seen = []
        real = self.real

        def apply(sched, optimizer, step):
            real(sched, optimizer, step)
            group = optimizer.param_groups[0]
            seen.append((step, group["lr"], group["betas"][0]))

        optim.Schedules.apply = apply
        return self

    def __exit__(self, *exc):
        from movenet_tpu_torch.train import optim

        optim.Schedules.apply = self.real
        return False


def preempt_after(n):
    """A PreemptionGuard class whose flag rises at its n-th read (the
    resume check's cut at the end of epoch 0)."""
    from movenet_tpu_torch.train import trainer

    class Guard(trainer.PreemptionGuard):
        def __init__(self, install=True):
            super().__init__(install=False)
            self.reads = 0

        @property
        def requested(self):
            self.reads += 1
            return self.reads >= n

        @requested.setter
        def requested(self, value):
            pass

    return Guard


def exp_run(name, ds, out, logs, extra):
    from movenet_tpu_torch.utils.fixtures import script_flags

    return trainer_cli(["--dataset", str(ds), *script_flags(name),
                     "--model_output_path", str(out), "--logger", "jsonl",
                     "--training_logs_path", str(logs),
                     "--log_every_n_steps", "1", *extra])


EXP_NAMES = {"exp03": "03_kinetics_scale_up",
             "exp04": "04_kinetics_receptive_field",
             "exp00": "00_audio_only_debug",
             "exp01": "01_audio_video_debug"}
# cuts: epochs, steps per epoch and the clip count only
EXP_CUTS = {"exp03": ["--n_epochs", "2", "--n_steps_per_epoch", "1"],
            "exp04": ["--n_epochs", "2", "--n_steps_per_epoch", "2"],
            "exp00": ["--n_epochs", "1", "--n_steps_per_epoch", "10"],
            "exp01": ["--n_epochs", "1", "--n_steps_per_epoch", "10"]}
# the unfused route's first two updates again, each from the card's
# weights before it on its batch: update 0 on the CPU in the run's bf16,
# update 1 in float32 on the card and on the CPU (there bf16 rounding
# alone parts the two grad_norms by 1.2e-3).  Relative bars, PERF.md:
# bf16, the loss below the spread of a random model's near-uniform
# losses; float32, the bars of tests/test_torch_parallel.py
REPLAY_BARS = {"bf16": {"loss": 1e-5, "grad_norm": 1e-3},
               "float32": {"loss": 1e-5, "grad_norm": 1e-4}}


def replay(torch, rec, i, device, dtype=None):
    """Recorded trainer step ``i`` again on ``device``: the run's config
    (its compute dtype, or ``dtype``), the step's weights and batch; the
    metrics and the host ms."""
    from dataclasses import replace

    from movenet_tpu_torch.models.wavenet import make_wavenet
    from movenet_tpu_torch.train import create_train_state, make_train_step

    cfg = rec.config
    if dtype is not None:
        cfg = replace(cfg, model_config=replace(cfg.model_config,
                                                compute_dtype=dtype))
    model = make_wavenet(cfg.model_config)
    model.load_state_dict(rec.weights[i])
    # the loss and grad_norm of an update do not depend on the LR
    state = create_train_state(model, cfg, device=device,
                               steps_per_epoch=len(rec.batches))
    t0 = time.perf_counter()
    _, m = make_train_step(model, cfg)(state, rec.batches[i])
    return dict(ms=(time.perf_counter() - t0) * 1e3,
                **{k: float(v) for k, v in m.items()})


def phase_experiments(torch, np, root):
    """Experiments 03, 04, 00 and 01 through the trainer CLI with their
    scripts' flags on synthetic clips at the real format; per run the
    per-update losses, the LR and beta1 of every update against the
    port's schedule at that run's total steps, step ms, peak memory and
    launch counts (03/04: the head kernels at C = 128 and the save trunk
    kernels at the new widths launched, no recompute kernel; 00/01, the
    unfused route: no training kernel).  00's and 01's first two updates
    run again from the card's weights before each (``replay``,
    ``REPLAY_BARS``).
    Then experiment 04 is cut at the end of epoch 0 and resumed: params,
    optimizer state, LR and beta1 equal the uninterrupted run's bit for
    bit.  Returns (records, launches, the clips' directory)."""
    import math

    from movenet_tpu_torch.config import arg_parser, config_from_args
    from movenet_tpu_torch.data import kinetics_index, make_synthetic_dataset
    from movenet_tpu_torch.ops.cuda import gated_block as kg
    from movenet_tpu_torch.ops.cuda import head_loss as kh
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks
    from movenet_tpu_torch.train import optim, trainer
    from movenet_tpu_torch.utils.fixtures import script_flags

    t0 = time.perf_counter()
    ds = root / "exp_clips"
    make_synthetic_dataset(ds, splits=("train",), categories=["breakdancing"],
                           clips_per_category=30, seed=0)
    make_synthetic_dataset(ds, splits=("valid",), categories=["breakdancing"],
                           clips_per_category=6, seed=1)
    n_train = len(kinetics_index(ds, train=True))
    n_val = len(kinetics_index(ds, train=False))
    print(f"experiment data: {n_train} train + {n_val} valid clips (16 kHz, "
          f"16 fps, 10 s, 96x96) written in {time.perf_counter() - t0:.1f} "
          f"s; cuts: the clip count, " + "; ".join(
              f"{k} {' '.join(v)}" for k, v in EXP_CUTS.items()), flush=True)
    recs, launches, states = {}, {}, {}
    for exp, name in EXP_NAMES.items():
        cfg = config_from_args(arg_parser().parse_args(
            ["--dataset", str(ds), *script_flags(name), *EXP_CUTS[exp]]))
        mc = cfg.model_config
        unfused = not cfg.fused_blocks
        ks.reset_launch_counts()
        kh.reset_launch_counts()
        kg.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        with timed_train_steps(torch, 2 if unfused else 0) as steps, \
                recorded_schedule() as sch:
            state = exp_run(name, ds, root / exp, root / f"{exp}_logs",
                            EXP_CUTS[exp])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        states[exp] = state
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        counts = {**ks.launch_counts, **kh.launch_counts,
                  **kg.launch_counts}
        lines = [json.loads(l) for l in (root / f"{exp}_logs" /
                                         "metrics.jsonl").read_text()
                 .splitlines()]
        train = [l for l in lines if l["tag"] == "train"]
        spe = min(n_train // (cfg.batch_size * cfg.accumulation_steps),
                  cfg.n_steps_per_epoch)
        n_updates = cfg.n_epochs * spe
        check(state.step == n_updates and len(train) == n_updates,
              f"{exp}: {state.step} updates, {len(train)} logged, expected "
              f"{n_updates}")
        losses = [l["loss"] for l in train]
        check(all(np.isfinite(losses)), f"{exp}: losses {losses}")
        # the LR and beta1 of every update: the port's schedule at this
        # run's total steps (OneCycleLR: n_epochs * ceil(steps per epoch /
        # accumulation steps)), or the config's constant LR and 0.9
        total = cfg.n_epochs * math.ceil(spe / cfg.accumulation_steps)
        if cfg.scheduler == "OneCycleLR":
            lr_f = optim.onecycle_schedule(cfg.max_learning_rate, total,
                                           cfg.lr_pct_start)
            b1_f = optim.onecycle_momentum_schedule(total, cfg.lr_pct_start)
            want = [(i, float(lr_f(i)), float(b1_f(i)))
                    for i in range(n_updates)]
        else:
            check(cfg.scheduler is None, f"{exp}: scheduler {cfg.scheduler}")
            want = [(i, cfg.learning_rate, 0.9) for i in range(n_updates)]
        check(sch.seen == want, f"{exp}: LR/beta1 {sch.seen}, expected "
              f"{want}")
        logged = [l["learning_rate"] for l in train]
        check(all(abs(a - w[1]) <= 1e-6 * w[1] for a, w in zip(logged, want)),
              f"{exp}: logged learning_rate {logged}")
        micro = n_updates * cfg.accumulation_steps
        val_batches = n_val // cfg.val_batch_size
        if unfused:
            want_counts = {k: 0 for k in counts}
        else:
            want_counts = {"stack_fwd": micro + cfg.n_epochs * val_batches,
                           "stack_bwd": micro, "head_bwd": micro,
                           "head_fwd": micro + cfg.n_epochs * val_batches,
                           "stack_fwd_tails": 0, "stack_bwd_tails": 0,
                           "head_fwd_packed": 0, "head_bwd_packed": 0}
        check(all(counts[k] == v for k, v in want_counts.items()),
              f"{exp}: launches {counts}, expected {want_counts}")
        median = float(np.median(steps.ms[1:] if len(steps.ms) > 1
                                 else steps.ms))
        recs[exp] = dict(
            losses=losses, lr_beta1=sch.seen, step_ms=steps.ms,
            median_ms=median, wall_s=wall, peak_gb=peak_gb,
            shape=f"B={cfg.batch_size} x {cfg.accumulation_steps} "
                  f"microbatches, T=160000, L={len(state.module.dilations)}, "
                  f"R={mc.residual_channels}, S={mc.skip_channels}, "
                  f"C={mc.input_channels}, bf16, "
                  + ("video" if cfg.use_video else "no video")
                  + (", unfused" if unfused else ""))
        for k in ("stack_fwd", "stack_bwd", "head_fwd", "head_bwd"):
            launches[k] = launches.get(k, 0) + counts[k]
        print(f"{exp} trainer CLI ({name}.sh flags + {' '.join(EXP_CUTS[exp])}"
              f"; {recs[exp]['shape']}): {n_updates} updates + "
              f"{cfg.n_epochs * val_batches} validation batches in "
              f"{wall:.1f} s with the data; losses "
              f"{[round(v, 6) for v in losses]}; LR, beta1 per update "
              f"{[(round(a, 9), round(b, 6)) for _, a, b in sch.seen]}; "
              f"step ms {[round(v, 1) for v in steps.ms]} (median after the "
              f"first {median:.1f}); peak memory {peak_gb:.3f} GB; launches "
              f"{counts}", flush=True)
        if unfused:
            check(len(steps.batches) == 2,
                  f"{exp}: {len(steps.batches)} steps recorded")
            t1 = time.perf_counter()
            runs = {"bf16": (steps.metrics[0], replay(torch, steps, 0, "cpu")),
                    "float32": (replay(torch, steps, 1, "cuda", "float32"),
                                replay(torch, steps, 1, "cpu", "float32"))}
            bad, read = [], []
            for kind, (card, cpu) in runs.items():
                for k, tol in REPLAY_BARS[kind].items():
                    rel = abs(card[k] - cpu[k]) / abs(cpu[k])
                    read.append(f"{kind} {k} {card[k]!r} / {cpu[k]!r}, "
                                f"{rel:.3g} (bar {tol:g})")
                    if rel > tol:
                        bad.append(read[-1])
            recs[exp]["cpu"] = {kind: cpu for kind, (_, cpu) in runs.items()}
            print(f"{exp} updates 0 (bf16) and 1 (float32) again, each from "
                  f"the card's weights before it on its batch, whole batch "
                  f"({time.perf_counter() - t1:.1f} s; CPU host ms "
                  f"{round(runs['bf16'][1]['ms'])}, "
                  f"{round(runs['float32'][1]['ms'])}): card / CPU, "
                  f"relative difference: " + "; ".join(read), flush=True)
            check(not bad, f"{exp}: {bad}")
    # experiment 04 cut at the end of epoch 0 (the guard's third read),
    # resumed with --auto_resume 1, against the uninterrupted run above
    whole = states["exp04"]
    real_guard = trainer.PreemptionGuard
    trainer.PreemptionGuard = preempt_after(3)
    try:
        cut = exp_run(EXP_NAMES["exp04"], ds, root / "exp04_cut",
                      root / "exp04_cut_logs", EXP_CUTS["exp04"])
    finally:
        trainer.PreemptionGuard = real_guard
    check(cut.step == 2, f"experiment 04 cut at step {cut.step}, not 2")
    resumed = exp_run(EXP_NAMES["exp04"], ds, root / "exp04_cut",
                      root / "exp04_cut_logs",
                      EXP_CUTS["exp04"] + ["--auto_resume", "1"])
    check(resumed.step == whole.step, f"resumed run ended at step "
          f"{resumed.step}, the uninterrupted at {whole.step}")
    diff = 0.0
    pr = resumed.module.state_dict()
    for name, w in whole.module.state_dict().items():
        diff = max(diff, _err(pr[name], w))
    ow, orr = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    groups_equal = ow["param_groups"] == orr["param_groups"]
    check(groups_equal and set(ow["state"]) == set(orr["state"]),
          f"optimizer param groups (LR, beta1) or state layout differ: "
          f"{[(g['lr'], g['betas']) for g in orr['param_groups']]} vs "
          f"{[(g['lr'], g['betas']) for g in ow['param_groups']]}")
    opt_diff = 0.0
    for i, st in ow["state"].items():
        for k, v in st.items():
            opt_diff = max(opt_diff, _err(orr["state"][i][k], v))
    g = ow["param_groups"][0]
    print(f"experiment 04 resume: cut at step 2, resumed to step "
          f"{resumed.step}; against the uninterrupted run: params max "
          f"difference {diff:.3g}, optimizer state {opt_diff:.3g}, LR "
          f"{g['lr']!r} and beta1 {g['betas'][0]!r} equal", flush=True)
    check(diff == 0.0 and opt_diff == 0.0, "the resumed run's params or "
          "optimizer state differ from the uninterrupted run's")
    return recs, launches, ds


# the sequence-parallel phase: 1 + 3 steps of experiment 01 on a (data 1,
# seq 2) mesh, two ranks on this card
SEQ_STEPS = 4
SEQ_EXP = "01_audio_video_debug"


def seq_batches(torch, ds, cfg):
    """The first SEQ_STEPS batches of experiment 01's train loader over
    ``ds`` (every row: the one data index's), with each one's sha256."""
    import hashlib
    from itertools import islice

    from movenet_tpu_torch.data import get_dataloader

    mc = cfg.model_config
    loader = get_dataloader(ds, input_channels=mc.input_channels,
                            batch_size=cfg.batch_size,
                            use_video=cfg.use_video, num_workers=4,
                            max_audio_frames=mc.max_audio_frames,
                            max_video_frames=mc.max_video_frames)
    epoch = loader.epoch(0)
    try:
        batches = list(islice(epoch, SEQ_STEPS))
    finally:
        epoch.close()
    check(len(batches) == SEQ_STEPS, f"{len(batches)} batches loaded")
    digests = []
    for b in batches:
        h = hashlib.sha256()
        for t in (b.codes, b.video, b.labels):
            h.update(t.contiguous().view(torch.uint8).numpy())
        digests.append(h.hexdigest())
    return batches, digests


def seq_rank(rank, port, out, ds):
    """One of two ranks of a (data 1, seq 2) mesh on cuda:0 over gloo (a
    spawned worker): experiment 01's model, each loaded batch cut to this
    rank's window (``shard_batch``), ``make_parallel_train_step``."""
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from movenet_tpu_torch.config import TrainingConfig
    from movenet_tpu_torch.ops.cuda import gated_block as kg
    from movenet_tpu_torch.ops.cuda import head_loss as kh
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks
    from movenet_tpu_torch.parallel import (
        Mesh,
        initialize_distributed,
        make_parallel_train_step,
        shard_batch,
    )
    from movenet_tpu_torch.train import create_train_state
    from movenet_tpu_torch.train.trainer import params_digest
    from movenet_tpu_torch.utils.fixtures import experiment

    initialize_distributed(TrainingConfig(num_processes=2, process_id=rank),
                           device="cuda", backend="gloo",
                           address=f"127.0.0.1:{port}")
    try:
        cfg, model = experiment(SEQ_EXP, device="cuda")
        mesh = Mesh(1, 2)
        batches, digests = seq_batches(torch, ds, cfg)
        state = create_train_state(model, cfg, device="cuda")
        step = make_parallel_train_step(model, cfg, mesh=mesh)
        weights, recs = [], []
        for batch, digest in zip(batches, digests):
            shard = shard_batch(batch, rank, mesh.data, mesh.seq, model)
            if rank == 0:
                weights.append({k: v.detach().cpu().clone()
                                for k, v in model.state_dict().items()})
            shard = shard.to("cuda")
            for k in (ks, kh, kg):
                k.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, shard)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            recs.append(dict(
                ms=ms, batch=digest, window=list(shard.codes.shape),
                launches=sum(sum(k.launch_counts.values())
                             for k in (ks, kh, kg)),
                digest=params_digest(state.module),
                **{k: float(m[k]) for k in ("loss", "accuracy",
                                            "grad_norm")}))
        Path(out, f"rank{rank}.json").write_text(json.dumps(recs))
        if rank == 0:
            torch.save(weights, Path(out, "weights.pt"))
    finally:
        torch.distributed.destroy_process_group()


def phase_seq_parallel(torch, np, root, ds):
    """Two gloo ranks on this card at (data 1, seq 2) with experiment 01's
    flags at full width train SEQ_STEPS steps through the library API;
    each step's loss and grad_norm against one process on the same rows
    from the ranks' weights before it.  Returns the step ms (rank 0's
    median after the first, and the one process's)."""
    import torch.multiprocessing as mp

    from movenet_tpu_torch.train import create_train_state, make_train_step
    from movenet_tpu_torch.utils.fixtures import experiment

    t0 = time.perf_counter()
    out = root / "seq_ranks"
    out.mkdir()
    ctx = mp.spawn(seq_rank, args=(free_port(), str(out), str(ds)),
                   nprocs=2, join=False)
    deadline = time.perf_counter() + DP_DEADLINE_S
    while not ctx.join(timeout=5):
        if time.perf_counter() > deadline:
            for p in ctx.processes:
                p.kill()
            raise PhaseFailed(f"the seq ranks ran past {DP_DEADLINE_S} s")
    wall = time.perf_counter() - t0
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in (0, 1)]
    cfg, model = experiment(SEQ_EXP, device="cuda")
    state = create_train_state(model, cfg, device="cuda")
    step = make_train_step(model, cfg)
    batches, digests = seq_batches(torch, ds, cfg)
    one = []
    for weights, batch in zip(torch.load(out / "weights.pt",
                                         weights_only=True), batches):
        model.load_state_dict(weights)
        batch = batch.to("cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        one.append(dict(ms=(time.perf_counter() - t1) * 1e3,
                        **{k: float(m[k]) for k in ("loss", "grad_norm")}))
    bad = []
    for i, (r0, r1, o) in enumerate(zip(*ranks, one)):
        for r, rec in enumerate((r0, r1)):
            print(f"sequence parallel rank {r} step {i}: window "
                  f"{rec['window']}; loss {rec['loss']:.6f} grad_norm "
                  f"{rec['grad_norm']:.6g}; {rec['ms']:.2f} ms; launches "
                  f"{rec['launches']}; batch sha256 {rec['batch'][:16]}; "
                  f"params sha256 {rec['digest'][:16]}", flush=True)
            if rec["launches"]:
                bad.append(f"rank {r} step {i}: {rec['launches']} "
                           "training-kernel launches")
            if rec["batch"] != digests[i]:
                bad.append(f"rank {r} step {i}: another batch than the "
                           "one process's")
        print(f"sequence parallel one process step {i} (3 rows, whole "
              f"clips) from the ranks' weights: loss {o['loss']:.6f} "
              f"grad_norm {o['grad_norm']:.6g}; {o['ms']:.2f} ms",
              flush=True)
        if {k: v for k, v in r0.items() if k not in ("ms", "window")} != \
                {k: v for k, v in r1.items() if k not in ("ms", "window")}:
            bad.append(f"step {i}: the ranks differ")
        for k in ("loss", "grad_norm"):
            if abs(r0[k] - o[k]) > 1e-3 * abs(o[k]):
                bad.append(f"step {i}: {k} {r0[k]} against one process's "
                           f"{o[k]}")
    med = [float(np.median([r["ms"] for r in recs[1:]]))
           for recs in (*ranks, one)]
    print(f"sequence parallel: 2 gloo ranks on one card at (data 1, seq 2),"
          f" experiment 01's flags (B=3, T=160000 in two windows, video, "
          f"bf16, unfused), {SEQ_STEPS} steps in {wall:.1f} s with the "
          f"spawn; step ms (median after the first) rank 0 {med[0]:.2f}, "
          f"rank 1 {med[1]:.2f} (both ranks share the card), one process "
          f"on the whole clips {med[2]:.2f}; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(not bad, f"sequence parallel: {bad}")
    return med


# phase 24: the R = 128 model of scripts/probe_r128_mfu.py through the
# wide save trunk kernels and the wide head (utils/fixtures.PROBE_R128: the
# breakdancing cell at R = S = 128, C = 64), and experiment 02's CLI at
# --residual_channels 128 (R = 128, S = 8)
PROBE_TAG = "probe R=128"
PROBE_SHAPE = ("probe R=128: B=2, T=160000, L=9, R=S=128, C=64, bf16, "
               "video triple")
EXP02_R128_TAG = "exp02 R=128"
EXP02_R128_SHAPE = ("experiment 02 CLI at --residual_channels 128: B=2, "
                    "T=160000, L=9, R=128, S=8, C=64, bf16, video triple")
# generated samples of each of phase 24's AR cases
N_WIDE_GEN = 1024


def phase_wide_kernels(torch, np):
    """Phase 24 (a, b): the four training kernels at the probe's full
    shapes against their plain versions (phase 9's checks and bars: the
    forward on the flat ctx, the backward with the projection triple, and
    here the backward with the flat ctx too), then phase 10's 1 + 5
    ``make_train_step`` steps through the kernels and plain from one set of
    weights.  The same kernel checks at experiment 02's CLI widths at
    --residual_channels 128 ((128, 8), C = 64).  Returns (model, batch,
    records, (128, 8) records, runs, launches); the model is left
    trained."""
    from movenet_tpu_torch.models import fused
    from movenet_tpu_torch.ops import stack_kernel as sk
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks
    from movenet_tpu_torch.utils.fixtures import PROBE_R128, breakdancing
    from movenet_tpu_torch.utils.time_stack_bwd import by_grid

    cfg, model, batch = breakdancing(device="cuda", widths=PROBE_R128)
    rec = phase_train_kernels(torch, np, cfg, model, batch, PROBE_TAG)
    b, t = batch.codes.shape
    dil = tuple(model.dilations)
    with torch.no_grad():
        ctx, (b_fg, w_fg, w_out, b_out) = fused._prepare_trunk(
            model, batch.codes, batch.video, None)
        ctx_flat = sk.ctx_flatten(ctx, torch.bfloat16)
        pack = fused._codes_pack(batch.codes, True)
        table2 = torch.cat([model.front_cur, model.front_past],
                           0).to(torch.bfloat16)
        _, hsave, tfsg = sk.stack_fwd_plain(pack, table2, ctx_flat, b_fg,
                                            w_fg, w_out, b_out, dil, b)
        g = torch.Generator(device="cuda").manual_seed(5)
        dskip = (torch.randn(b, t, model.skip_channels, generator=g,
                             device="cuda") * 1e-3).to(torch.bfloat16)
        bargs = (hsave, tfsg, ctx_flat, w_fg, w_out, dskip, pack, 64, dil,
                 None)
        got, want = ks.stack_bwd(*bargs), sk.stack_bwd_plain(*bargs)
        errs = {}
        for name, x, y in zip(("dtab", "dctx", "db_fg", "dw_fg", "dw_out",
                               "db_out"), got, want):
            errs[name] = _err(x, y)
            tol = (2e-2 if name == "dctx" else 1e-3) * _scale(y)
            check(errs[name] <= tol, f"stack_bwd {PROBE_TAG} flat ctx {name}:"
                  f" max err {errs[name]:.3g}, scale {_scale(y):.3g}")
        del got, want
        lib, st = ks.library(), ks._stream(tfsg)
        rec["stack_bwd flat"] = dict(
            max_abs_err=max(errs.values()), errs=errs,
            ms=time_cuda(torch, lambda: ks.run_bwd(lib, *bargs, stream=st),
                         5),
            plain_ms=time_cuda(torch, lambda: sk.stack_bwd_plain(*bargs), 2),
            by_grid=by_grid(torch, lambda: ks.run_bwd(lib, *bargs,
                                                      stream=st)))
        del hsave, tfsg, bargs
    print(grid_line(f"train kernel stack_bwd ({PROBE_TAG}, flat ctx)",
                    rec["stack_bwd flat"]["by_grid"]), flush=True)
    print(f"train kernel stack_bwd ({PROBE_TAG}, flat ctx) vs plain: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f"; kernel {rec['stack_bwd flat']['ms']:.3f} ms, plain "
          f"{rec['stack_bwd flat']['plain_ms']:.3f} ms", flush=True)
    # experiment 02's CLI widths at --residual_channels 128 (S = 8)
    from movenet_tpu_torch.utils.fixtures import experiment, random_batch

    cfg2, model2 = experiment("02_kinetics_breakdancing",
                              extra=("--residual_channels", "128"))
    rec2 = phase_train_kernels(
        torch, np, cfg2, model2,
        random_batch(cfg2.model_config, 2, seed=1), EXP02_R128_TAG)
    del model2
    runs, launches = phase_train(torch, np, cfg, model, batch,
                                 f"train {PROBE_TAG}")
    return model, batch, rec, rec2, runs, launches


def phase_wide_generate(torch, np, model, batch, tag=PROBE_TAG):
    """Phase 24 (d): greedy B=1 generation from the trained probe model
    through the AR kernel's video form, exact and fast, prompted by the
    batch's first RF codes and conditioned by its video: codes equal to
    the plain version's; times (and the ring's slab size).  Phase 25 (d)
    runs the same on the flagship's depth at R = S = 128 (``tag``)."""
    from movenet_tpu_torch.ops.cuda import ar_sampler as ars

    rf = model.receptive_fields
    model.eval()
    out = {}
    for fast in (False, True):
        inp = ars.prepare(model, batch.codes[:1, :rf], rf + N_WIDE_GEN,
                          temperature=0.0, seed=0, parity_sampling=True,
                          fast=fast, video=batch.video[:1])
        before = dict(ars.launch_counts)
        got = ars.ar_sampler(inp)
        torch.cuda.synchronize()
        check(ars.launch_counts[inp.name] == before[inp.name] + 1,
              f"{inp.name} not launched")
        t0 = time.perf_counter()
        want = ars.ar_sampler_plain(inp)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        equal = bool(torch.equal(got.cpu(), want.cpu()))
        check(equal, f"{tag} {inp.name}: kernel and plain codes "
              f"differ at {(got != want).nonzero()[:3].tolist()}")
        slab = ars._default_slab(inp, 1)
        out[inp.name] = dict(equal=equal, plain_ms=plain_ms, slab=slab,
                             ms=time_cuda(torch, lambda: ars.ar_sampler(inp),
                                          3))
        print(f"generate {tag} {inp.name} (greedy B=1, video, n = RF "
              f"+ {N_WIDE_GEN}, {slab // 1024} KB slabs): codes equal to "
              f"plain; kernel {out[inp.name]['ms']:.2f} ms "
              f"({out[inp.name]['ms'] * 1e3 / N_WIDE_GEN:.2f} us/step), "
              f"plain {plain_ms:.1f} ms", flush=True)
    model.train()
    return out


def phase_wide_cli(torch, np, root, ds):
    """Phase 24 (c): the trainer CLI with experiment 02's flags and
    --residual_channels 128 (the CLI's skip width 8) for 1 epoch of 3 steps
    on phase 14's clips: the default strategy resolves to save, so the
    wide save kernels at (128, 8) and the head run (no recompute kernel),
    the losses are finite; update ms and peak memory."""
    from movenet_tpu_torch.data import kinetics_index
    from movenet_tpu_torch.ops.cuda import head_loss as kh
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks

    n_val = len(kinetics_index(ds, train=False)) // 2
    ks.reset_launch_counts()
    kh.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with timed_train_steps(torch) as steps:
        state = trainer_cli([
            "--dataset", str(ds), *EXP02_FLAGS, "--residual_channels", "128",
            "--val_batch_size", "2", "--n_steps_per_epoch", "3",
            "--n_epochs", "1", "--model_output_path", str(root / "wide_run"),
            "--logger", "jsonl", "--training_logs_path",
            str(root / "wide_logs")])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {**ks.launch_counts, **kh.launch_counts}
    m = state.module
    check(state.step == 3, f"trainer CLI took {state.step} steps, not 3")
    check((m.residual_channels, m.skip_channels) == (128, 8),
          f"--residual_channels 128 built R={m.residual_channels}, "
          f"S={m.skip_channels}")
    want = {"stack_fwd": 3 + n_val, "stack_bwd": 3, "head_fwd": 3 + n_val,
            "head_bwd": 3, "stack_fwd_tails": 0, "stack_bwd_tails": 0,
            "stack_fwd_replay": 0, "stack_bwd_replay": 0}
    check(all(launches[k] == v for k, v in want.items()),
          f"trainer CLI at --residual_channels 128: launches {launches}, "
          f"expected {want}")
    lines = [json.loads(l) for l in (root / "wide_logs" / "metrics.jsonl")
             .read_text().splitlines()]
    losses = [l["loss"] for l in lines if l["tag"] in ("train", "val")]
    check(losses and all(np.isfinite(losses)), f"losses {losses}")
    median = float(np.median(steps.ms[1:]))
    print(f"trainer CLI (experiment 02 flags, --residual_channels 128: R=128,"
          f" S=8): 3 steps + {n_val} validation batches; step ms "
          f"{[round(v, 2) for v in steps.ms]} (median after the first "
          f"{median:.2f}); peak memory {peak:.3f} GB; losses "
          f"{[round(v, 6) for v in losses]}; launches {launches}", flush=True)
    return dict(launches=launches, step_ms=median, peak_gb=peak)


# phase 25: the recompute and replay strategies at R = 128: the flagship's
# depth at R = S = 128 (utils/fixtures.FLAGSHIP_TRAIN at residual_channels
# = skip_channels = 128: layer 10 x stack 3, C = 256) and experiment 02's
# CLI at --residual_channels 128 --remat 1 (R = 128, S = 8)
WIDE_TAILS_KERNELS = {
    f"{k} (R=128)": v for k, v in (
        *TAILS_KERNELS.items(),
        *((k, TRUNK_REPLAY_KERNELS[k]) for k in ("stack_fwd_replay",
                                                 "stack_bwd_replay")))}
FLAGSHIP_R128_TAG = "flagship R=128"
FLAGSHIP_R128_FLAGS = [("128" if v == "64" else v) for v in FLAGSHIP_FLAGS]
# (B, dilations, R, S) of its kernel shapes, T = 160000: the flagship's
# depth and experiment 02's
WIDE_TAILS_SHAPES = {
    FLAGSHIP_R128_TAG: (2, tuple(2 ** i for i in range(10)) * 3, 128, 128),
    EXP02_R128_TAG: (2, (1, 2, 4) * 3, 128, 8)}
# the grids of its recompute backward at the flagship's depth: the weight
# copies (bf16, and the layer launches' TF32 images), the wide forward's
# rebuilds and taps launches, the layer launches (kernel B's block in its
# bf16 recompute form) and W_fg's gradient on wgmma
WIDE_TAILS_GRIDS = (("weights", "stack_wt"),
                    ("rebuilds and taps", "stack_layer_kernel"),
                    ("layer", "stack_bwd_wg_kernel"),
                    ("wgrad W_fg", "stack_wgrad_wg_kernel<0"),
                    ("wgrad W_out", "stack_wgrad_kernel<3"),
                    ("dx", "stack_dx_kernel"),
                    ("reductions", "reduce_kernel"))


def phase_wide_tails_kernels(torch, np):
    """Phase 25 (a): the recompute and replay kernels at R = 128 against
    their plain versions at WIDE_TAILS_SHAPES (seeded x, weights and
    dskip), with a flat ctx and with the video projection triple (the
    recompute kernels take the triple's flat form, as the trainer hands it
    to them): the recompute kernels through ``tails_compare`` (phase 11's
    bars; the backward also by grid at the flagship's depth), the replay
    kernels through ``_replay_case`` (phase 23's bars, and bit for bit
    against the wide save kernels: every rebuilt layer input against
    hsave).  Returns records by (kernel line name, shape label), each with
    its bound."""
    from movenet_tpu_torch.ops import stack_kernel as sk
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks
    from movenet_tpu_torch.utils.time_stack_bwd import by_grid

    t, lib, bf = 160_000, ks.library(), torch.bfloat16
    rec = {}
    for shape, (b, dil, r, s) in WIDE_TAILS_SHAPES.items():
        n, win, every = len(dil), 3 * r, sk.tails_every(len(dil))
        for ctx_kind in ("flat", "proj"):
            g = torch.Generator(device="cuda").manual_seed(
                31 + n + s + 2 * (ctx_kind == "proj"))

            def rn(*shape, scale=1.0):
                return torch.randn(*shape, generator=g,
                                   device="cuda") * scale

            label = shape if ctx_kind == "flat" else f"{shape} proj"
            with torch.no_grad():
                x = rn(b, t, r, scale=0.5).to(bf)
                proj = None
                if ctx_kind == "flat":
                    ctx = rn(b, t, r, scale=0.5).to(bf)
                else:
                    trip = (rn(b, t // 10, r, scale=0.5).to(bf),
                            rn(r, 10 * r, scale=r ** -0.5),
                            rn(10 * r, scale=0.1))
                    ctx = sk.ctx_flatten(trip, bf)
                    proj = sk._ctx_proj_args(trip)
                    del trip
                args = (x, ctx, rn(n * b, 2 * r, scale=0.1),
                        rn(n, win, 2 * r, scale=win ** -0.5),
                        rn(n, r, r + s, scale=r ** -0.5),
                        rn(n, r + s, scale=0.1), dil)
                dskip = (rn(b, t, s) * 1e-3).to(bf)
                tails = tails_compare(torch, args, dskip, label, 1e-3)
                if shape == FLAGSHIP_R128_TAG and ctx_kind == "proj":
                    _, ckpt = ks.run_fwd_tails(lib, *args, stream=ks._stream(x))
                    bargs = (x, ckpt, *args[1:-1], dskip, dil)
                    tails["stack_bwd_tails"]["by_grid"] = by_grid(
                        torch, lambda: ks.run_bwd_tails(
                            lib, *bargs, stream=ks._stream(x)),
                        WIDE_TAILS_GRIDS)
                    print(grid_line(f"kernel stack_bwd_tails {label}",
                                    tails["stack_bwd_tails"]["by_grid"]),
                          flush=True)
                    del ckpt, bargs
                fwd, bwd = _replay_case(torch, lib, args, dskip, label,
                                        "bf16", proj)
                del x, ctx, args, dskip, proj
            torch.cuda.empty_cache()
            tb = tails_bounds(b, t, n, r, s, win, every)
            rb = replay_bounds(b, t, n, r, s, win, every,
                               proj=ctx_kind == "proj")
            for name in TAILS_KERNELS:
                tails[name]["bound"] = tb[name]
                rec[(f"{name} (R=128)", label)] = tails[name]
            for name, r_ in (("stack_fwd_replay", fwd),
                             ("stack_bwd_replay", bwd)):
                r_["bound"] = rb[name]
                rec[(f"{name} (R=128)", label)] = r_
    for (name, label), r_ in rec.items():
        print(f"kernel {name} {label}: kernel {r_['ms']:.3f} ms, plain "
              f"{r_['plain_ms']:.3f} ms, bound {r_['bound'][0]:.3f} ms "
              f"({r_['bound'][1]})"
              + (f", save form {r_['save_ms']:.3f} ms" if "save_ms" in r_
                 else ""), flush=True)
    return rec


def phase_wide_tails_cli(torch, np, root, ds):
    """Phase 25 (b, c): (b) the trainer CLI at the flagship's depth at R =
    S = 128 (FLAGSHIP_R128_FLAGS) for 1 epoch of 4 steps on phase 16's
    clips, first with no strategy flag (the default resolves recompute:
    only the recompute trunk kernels and the head's run), then with
    --fused_strategy replay (only the replay trunk kernels); finite losses,
    update ms and peak memory; then one loss + backward of the first run's
    trained model on seeded codes and video through the save, replay and
    recompute strategies, each one's peak device memory and ms; (c)
    experiment 02's CLI with --residual_channels 128 --remat 1 for 3
    updates on phase 14's clips (``ds``): recompute at (128, 8).  Returns
    (the trained flagship model, its seeded batch, launches of the R = 128
    kernels on these runs, records)."""
    from movenet_tpu_torch.data import kinetics_index
    from movenet_tpu_torch.models import fused
    from movenet_tpu_torch.ops.cuda import gated_block as kg
    from movenet_tpu_torch.ops.cuda import head_loss as kh
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks
    from movenet_tpu_torch.train import Batch

    mods = (ks, kh, kg)
    flag_ds = root / "flagship_clips"
    runs, launches, model = {}, {k: 0 for k in WIDE_TAILS_KERNELS}, None
    cases = (("recompute", flag_ds, FLAGSHIP_R128_FLAGS, [], 4,
              ("stack_fwd_tails", "stack_bwd_tails")),
             ("replay", flag_ds, FLAGSHIP_R128_FLAGS,
              ["--fused_strategy", "replay"], 4,
              ("stack_fwd_replay", "stack_bwd_replay")),
             ("exp02 remat", ds, EXP02_FLAGS,
              ["--residual_channels", "128", "--remat", "1"], 3,
              ("stack_fwd_tails", "stack_bwd_tails")))
    for key, data, flags, extra, n_steps, (fwd, bwd) in cases:
        n_val = len(kinetics_index(data, train=False)) // 2
        run, logs = root / f"r128_run_{len(runs)}", root / f"r128_logs_{len(runs)}"
        for mod in mods:
            mod.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with timed_train_steps(torch) as steps:
            state = trainer_cli([
                "--dataset", str(data), *flags, *extra, "--n_epochs", "1",
                "--n_steps_per_epoch", str(n_steps), "--val_batch_size", "2",
                "--model_output_path", str(run), "--logger", "jsonl",
                "--training_logs_path", str(logs)])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        got = {k: v for mod in mods for k, v in mod.launch_counts.items()}
        m = state.module
        check(state.step == n_steps, f"R=128 trainer CLI ({key}) took "
              f"{state.step} steps, not {n_steps}")
        check(m.residual_channels == 128, f"R=128 trainer CLI ({key}) built "
              f"R={m.residual_channels}")
        want = {k: 0 for k in got}
        want.update({fwd: n_steps + n_val, bwd: n_steps,
                     "head_fwd": n_steps + n_val, "head_bwd": n_steps})
        check(got == want, f"R=128 trainer CLI ({key}) launches {got}, "
              f"expected {want}")
        lines = [json.loads(l) for l in (logs / "metrics.jsonl").read_text()
                 .splitlines()]
        losses = [l["loss"] for l in lines if l["tag"] in ("train", "val")]
        check(losses and all(np.isfinite(losses)),
              f"R=128 trainer CLI ({key}) losses {losses}")
        median = float(np.median(steps.ms[1:]))
        print(f"trainer CLI {key} at R=128 ({' '.join(flags + extra)}; "
              f"R={m.residual_channels}, S={m.skip_channels}): {n_steps} "
              f"steps + {n_val} validation batches; step ms "
              f"{[round(v, 2) for v in steps.ms]} (median after the first "
              f"{median:.2f}); peak memory {peak:.3f} GB; losses "
              f"{[round(v, 6) for v in losses]}; launches {got}", flush=True)
        for k in (fwd, bwd):
            launches[f"{k} (R=128)"] += got[k]
        runs[key] = dict(step_ms=median, peak_gb=peak, launches=got)
        if key == "recompute":
            model = state.module
        del state
        torch.cuda.empty_cache()
    # one loss + backward of the trained flagship model through each
    # strategy, for its peak device memory
    rng = np.random.default_rng(0)
    batch = Batch(
        codes=torch.from_numpy(rng.integers(
            0, model.input_channels, size=(2, model.max_audio_frames))).int(),
        video=torch.from_numpy(rng.standard_normal(
            (2, model.max_video_frames, 64, 64, 1)).astype(np.float32))
    ).to("cuda")
    keys = {"save": "stack_fwd", "replay": "stack_fwd_replay",
            "recompute": "stack_fwd_tails"}
    peaks, ms = {}, {}
    for strategy in keys:
        model.fused_strategy = strategy
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ks.reset_launch_counts()
        t0 = time.perf_counter()
        loss, _ = fused.fused_train_loss(model, batch.codes, batch.video)
        loss.backward()
        torch.cuda.synchronize()
        ms[strategy] = (time.perf_counter() - t0) * 1e3
        peaks[strategy] = torch.cuda.max_memory_allocated() / 1e9
        check(np.isfinite(float(loss.detach())), f"{strategy} loss")
        check(ks.launch_counts[keys[strategy]] == 1,
              f"{FLAGSHIP_R128_TAG} {strategy}: {ks.launch_counts}")
        del loss
    model.fused_strategy = None
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    print(f"{FLAGSHIP_R128_TAG} one loss + backward (bf16, B=2, T=160000): "
          "peak memory " + ", ".join(f"{k} {peaks[k]:.3f} GB" for k in keys)
          + "; " + ", ".join(f"{k} {ms[k]:.1f} ms" for k in keys)
          + " (first calls)", flush=True)
    return model, batch, launches, dict(runs=runs, peaks=peaks, ms=ms)


# phase 26: float32 training at R = 128: the float32 recompute forms at the
# wide pairs (the wide float32 forward's slab walk; its backward's taps
# launches and wide layer launches) and the float32 head at 64 < S <= 128
WIDE_F32_KERNELS = {f"{k} (R=128)": v for k, v in F32_TAILS_KERNELS.items()}
WIDE_F32_HEAD_KERNELS = {"head_fwd_f32 (S=128)": TRAIN_KERNELS["head_fwd"],
                         "head_bwd_f32 (S=128)": TRAIN_KERNELS["head_bwd"]}
# the head's (S, C, B): the flagship's depth at R = S = 128 (C = 256, the
# wide kernels) and experiment 02 at --residual_channels 128
# --skip_channels 128 (C = 64)
WIDE_F32_HEADS = ((128, 256, 2), (128, 64, 2))
# the grids of its recompute backward at the flagship's depth: the taps
# launches are the forward's kernel, as the rebuilds
WIDE_F32_GRIDS = (("weights", "stack_wt_split_kernel"),
                  ("rebuilds and taps", "stack_layer_wg_f32_kernel"),
                  ("layer", "stack_bwd_wg_kernel"),
                  ("wgrad W_fg", "stack_wgrad_kernel<4"),
                  ("wgrad W_out", "stack_wgrad_kernel<6"),
                  ("dx", "stack_dx_kernel"),
                  ("reductions", "reduce_kernel"))


def phase_wide_f32_kernels(torch, np):
    """Phase 26 (a): the float32 recompute forms at R = 128 against their
    plain versions (TF32 off) at WIDE_TAILS_SHAPES (seeded float32 x,
    weights and dskip), with a flat ctx and with the video projection
    triple's flat form, within F32_BARS; the backward from the plain
    checkpoints, by grid at the flagship's depth with the triple; at
    experiment 02's shapes with the flat ctx the forward with a checkpoint
    at every layer against the default checkpoints and the backward from
    every layer input against the default backward, bit for bit (the
    rebuilds are the forward); then the float32 head at WIDE_F32_HEADS
    (``f32_head_compare``).  Each form's time beside its bf16 form's and
    the plain version's.  Returns records by (kernel line name, shape
    label), each with its bound."""
    from movenet_tpu_torch.ops import stack_kernel as sk
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks
    from movenet_tpu_torch.utils.time_stack_bwd import by_grid

    t, f32, bf = 160_000, torch.float32, torch.bfloat16
    lib = ks.library()
    rec = {}
    for shape, (b, dil, r, s) in WIDE_TAILS_SHAPES.items():
        n, win, every = len(dil), 3 * r, sk.tails_every(len(dil))
        for ctx_kind in ("flat", "proj"):
            g = torch.Generator(device="cuda").manual_seed(
                41 + n + s + 2 * (ctx_kind == "proj"))

            def rn(*shape_, scale=1.0):
                return torch.randn(*shape_, generator=g,
                                   device="cuda") * scale

            label = shape if ctx_kind == "flat" else f"{shape} proj"
            with torch.no_grad():
                x = rn(b, t, r, scale=0.5)
                if ctx_kind == "flat":
                    ctx = rn(b, t, r, scale=0.5)
                else:
                    ctx = sk.ctx_flatten(
                        (rn(b, t // 10, r, scale=0.5),
                         rn(r, 10 * r, scale=r ** -0.5),
                         rn(10 * r, scale=0.1)), f32)
                args = (x, ctx, rn(n * b, 2 * r, scale=0.1),
                        rn(n, win, 2 * r, scale=win ** -0.5),
                        rn(n, r, r + s, scale=r ** -0.5),
                        rn(n, r + s, scale=0.1), dil)
                st = ks._stream(x)
                what = f"stack_fwd_tails_f32 (R=128) {label}"
                got = ks.stack_fwd_tails(*args)
                want = sk.stack_fwd_tails_plain(*args)
                errs = {}
                for name, u, w in zip(("skip", "ckpt"), got, want):
                    check(u.dtype == f32, f"{what} {name} is {u.dtype}")
                    errs[name] = _err(u, w)
                    check(errs[name] <= F32_BARS["fwd"] * _scale(w),
                          f"{what} {name}: max err {errs[name]:.3g}, scale "
                          f"{_scale(w):.3g}")
                ckpt = want[1]
                del got, want
                bfa = (x.to(bf), ctx.to(bf), *args[2:])
                fwd = dict(
                    errs=errs, max_abs_err=max(errs.values()),
                    ms=time_cuda(torch, lambda: ks.run_fwd_tails(
                        lib, *args, stream=st), 3),
                    bf16_ms=time_cuda(torch, lambda: ks.run_fwd_tails(
                        lib, *bfa, stream=st), 3),
                    plain_ms=time_cuda(
                        torch, lambda: sk.stack_fwd_tails_plain(*args), 1))
                dskip = rn(b, t, s, scale=1e-3)
                bargs = (x, ckpt, *args[1:-1], dskip, dil)
                what = f"stack_bwd_tails_f32 (R=128) {label}"
                got = ks.stack_bwd_tails(*bargs)
                want = sk.stack_bwd_tails_plain(*bargs)
                errs = {}
                for name, u, w in zip(("dx", "dctx", "db_fg", "dw_fg",
                                       "dw_out", "db_out"), got, want):
                    check(u.dtype == f32, f"{what} {name} is {u.dtype}")
                    errs[name] = _err(u, w)
                    check(errs[name] <= F32_BARS["bwd"] * _scale(w),
                          f"{what} {name}: max err {errs[name]:.3g}, scale "
                          f"{_scale(w):.3g}")
                del got, want
                _, ckpt_bf = ks.run_fwd_tails(lib, *bfa, stream=st)
                bfb = (bfa[0], ckpt_bf, *bfa[1:-1], dskip.to(bf), dil)
                bwd = dict(
                    errs=errs, max_abs_err=max(errs.values()),
                    ms=time_cuda(torch, lambda: ks.run_bwd_tails(
                        lib, *bargs, stream=st), 3),
                    bf16_ms=time_cuda(torch, lambda: ks.run_bwd_tails(
                        lib, *bfb, stream=st), 3),
                    plain_ms=time_cuda(
                        torch, lambda: sk.stack_bwd_tails_plain(*bargs), 1))
                del bfb, ckpt_bf
                if shape == FLAGSHIP_R128_TAG and ctx_kind == "proj":
                    bwd["by_grid"] = by_grid(torch, lambda: ks.run_bwd_tails(
                        lib, *bargs, stream=st), WIDE_F32_GRIDS)
                    print(grid_line(f"f32 kernel stack_bwd_tails_f32 "
                                    f"{label}", bwd["by_grid"]), flush=True)
                if shape == EXP02_R128_TAG and ctx_kind == "flat":
                    # the rebuilds and the taps launches are the forward
                    skip1, every_layer = ks.run_fwd_tails(lib, *args,
                                                          stream=st, every=1)
                    skip_k, ckpt_k = ks.run_fwd_tails(lib, *args, stream=st)
                    check(torch.equal(skip1, skip_k) and all(
                        torch.equal(ckpt_k[i], every_layer[l - 1])
                        for i, l in enumerate(sk.ckpt_layers(n, every))),
                        f"float32 R=128 {label}: the checkpoints differ "
                        "from the forward's layer inputs")
                    tail = (*args[1:-1], dskip, dil)
                    check(all((u is None and v is None) or torch.equal(u, v)
                              for u, v in zip(
                                  ks.run_bwd_tails(lib, x, every_layer, *tail,
                                                   stream=st, every=1),
                                  ks.run_bwd_tails(lib, x, ckpt_k, *tail,
                                                   stream=st))),
                          f"float32 R=128 {label}: the backward from rebuilt "
                          "inputs differs from the backward from every "
                          "layer's input")
                    print(f"f32 kernel stack_bwd_tails_f32 (R=128) {label}: "
                          "the rebuilt layer inputs are the forward's, bit "
                          "for bit", flush=True)
                    del skip1, every_layer, skip_k, ckpt_k
                del x, ctx, args, bfa, bargs, ckpt, dskip
            torch.cuda.empty_cache()
            bounds = tails_bounds(b, t, n, r, s, win, every, act=4)
            for name, r_ in (("stack_fwd_tails", fwd),
                             ("stack_bwd_tails", bwd)):
                r_["bound"] = bounds[name]
                rec[(f"{name}_f32 (R=128)", label)] = r_
    for s, c, b in WIDE_F32_HEADS:
        label = f"S={s} C={c} B={b}"
        fwd, bwd = f32_head_compare(torch, s, c, b, "head_fwd_f32 (S=128)",
                                    "head_bwd_f32 (S=128)",
                                    (s, c, b) == WIDE_F32_HEADS[0])
        rec[("head_fwd_f32 (S=128)", label)] = fwd
        rec[("head_bwd_f32 (S=128)", label)] = bwd
    for (name, label), r_ in rec.items():
        print(f"f32 kernel {name} {label} (float32) vs plain: "
              + ", ".join(f"{k} {x:.3g}" for k, x in r_["errs"].items())
              + f"; kernel {r_['ms']:.3f} ms, bf16 form {r_['bf16_ms']:.3f} "
              f"ms, plain (TF32 off) {r_['plain_ms']:.3f} ms, bound "
              f"{r_['bound'][0]:.3f} ms ({r_['bound'][1]})", flush=True)
    return rec


def phase_wide_f32_cli(torch, np, root, ds):
    """Phase 26 (b, c): (b) the trainer CLI at the flagship's depth at R =
    S = 128 in float32 (FLAGSHIP_R128_FLAGS --compute_dtype float32) for 1
    epoch of 4 steps on phase 16's clips: the default strategy resolves to
    recompute, the trunk runs only the float32 recompute forms (at R =
    128) and the head only the wide float32 forms (at S = 128), launched
    exactly; finite losses, update ms and peak memory; then from
    checkpoint 0 the fused route against the unfused one (``f32_routes``,
    on the first row where B = 2 does not fit the unfused route); (c)
    experiment 02's CLI with --compute_dtype float32 --residual_channels
    128 (S = 8: the float32 head at (8, 64)) and then also with
    --skip_channels 128 (the float32 head at (128, 64)), 3 updates each on
    phase 14's clips (``ds``), launched exactly.  Returns (launches of the
    kernel line's phase 26 entries on these runs, records)."""
    from movenet_tpu_torch.config import arg_parser, config_from_args
    from movenet_tpu_torch.data import kinetics_index
    from movenet_tpu_torch.models.wavenet import make_wavenet
    from movenet_tpu_torch.ops import stack_kernel as sk
    from movenet_tpu_torch.ops.cuda import gated_block as kg
    from movenet_tpu_torch.ops.cuda import head_loss as kh
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks

    mods = (ks, kh, kg)
    flag_ds = root / "flagship_clips"
    f32 = ["--compute_dtype", "float32"]
    launches = {k: 0 for k in {**WIDE_F32_KERNELS, **WIDE_F32_HEAD_KERNELS}}
    runs, first = {}, None
    cases = (("flagship", flag_ds, FLAGSHIP_R128_FLAGS, f32, 4),
             ("exp02 R=128", ds, EXP02_FLAGS,
              f32 + ["--residual_channels", "128"], 3),
             ("exp02 R=S=128", ds, EXP02_FLAGS,
              f32 + ["--residual_channels", "128", "--skip_channels",
                     "128"], 3))
    for key, data, flags, extra, n_steps in cases:
        run = root / f"f32_r128_run_{len(runs)}"
        logs = root / f"f32_r128_logs_{len(runs)}"
        argv = ["--dataset", str(data), *flags, *extra, "--n_epochs", "1",
                "--n_steps_per_epoch", str(n_steps), "--val_batch_size", "2",
                "--model_output_path", str(run), "--logger", "jsonl",
                "--training_logs_path", str(logs)]
        cfg = config_from_args(arg_parser().parse_args(argv))
        mc = cfg.model_config
        dil = tuple(make_wavenet(mc).dilations)
        strategy = sk.resolve_strategy(
            "auto", (cfg.batch_size, mc.max_audio_frames,
                     mc.residual_channels), len(dil), dil, 4)
        check(strategy == "recompute",
              f"float32 R=128 {key}: strategy {strategy}")
        n_val = len(kinetics_index(data, train=False)) // 2
        for mod in mods:
            mod.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with timed_train_steps(torch, record=1) as steps:
            state = trainer_cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        got = {k: v for mod in mods for k, v in mod.launch_counts.items()}
        m = state.module
        check(state.step == n_steps, f"float32 R=128 trainer CLI ({key}) "
              f"took {state.step} steps, not {n_steps}")
        check((m.residual_channels, m.skip_channels, m.compute_dtype) ==
              (128, mc.skip_channels, "float32"),
              f"float32 R=128 trainer CLI ({key}) built R="
              f"{m.residual_channels}, S={m.skip_channels}, "
              f"{m.compute_dtype}")
        head = "head_fwd_f32_wide" if mc.input_channels > kh.F32_RING_C \
            else "head_fwd_f32"
        want = {k: 0 for k in got}
        want.update({"stack_fwd_tails_f32": n_steps + n_val,
                     "stack_bwd_tails_f32": n_steps,
                     head: n_steps + n_val,
                     head.replace("fwd", "bwd"): n_steps})
        check(got == want, f"float32 R=128 trainer CLI ({key}) launches "
              f"{got}, expected {want}")
        lines = [json.loads(l) for l in (logs / "metrics.jsonl").read_text()
                 .splitlines()]
        losses = [l["loss"] for l in lines if l["tag"] in ("train", "val")]
        check(losses and all(np.isfinite(losses)),
              f"float32 R=128 trainer CLI ({key}) losses {losses}")
        median = float(np.median(steps.ms[1:]))
        print(f"f32 trainer CLI {key} ({' '.join(flags + extra)}; R="
              f"{m.residual_channels}, S={m.skip_channels}, C="
              f"{m.input_channels}; strategy {strategy}): {n_steps} steps + "
              f"{n_val} validation batches in {wall:.1f} s; step ms "
              f"{[round(v, 2) for v in steps.ms]} (median after the first "
              f"{median:.2f}); peak memory {peak:.3f} GB; losses "
              f"{[round(v, 6) for v in losses]}; launches {got}", flush=True)
        for k in ("stack_fwd_tails_f32", "stack_bwd_tails_f32"):
            launches[f"{k} (R=128)"] += got[k]
        if mc.skip_channels == 128:
            for k in ("head_fwd", "head_bwd"):
                launches[f"{k}_f32 (S=128)"] += \
                    got[head.replace("head_fwd", k)]
        runs[key] = dict(step_ms=median, peak_gb=peak, wall_s=wall,
                         launches=got, ms=steps.ms)
        if first is None:
            first = (mc, run, steps.batches[0])
        del state
        torch.cuda.empty_cache()
    mc, run, batch = first
    fused_want = dict(stack_fwd_tails_f32=1, stack_bwd_tails_f32=1,
                      head_fwd_f32_wide=1, head_bwd_f32_wide=1)
    rows = 2
    try:
        errs, unfused_gb = f32_routes(
            torch, np, mc, run, batch, fused_want,
            f"{FLAGSHIP_R128_TAG} float32 fused vs unfused (checkpoint 0, "
            "the run's first batch, B=2, T=160000)")
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        rows = 1
        one = type(batch)(codes=batch.codes[:1],
                          video=None if batch.video is None
                          else batch.video[:1],
                          labels=None if batch.labels is None
                          else batch.labels[:1])
        errs, unfused_gb = f32_routes(
            torch, np, mc, run, one, fused_want,
            f"{FLAGSHIP_R128_TAG} float32 fused vs unfused (checkpoint 0, "
            "the first row of the run's first batch: the unfused route does "
            "not fit the card at B=2)")
    return launches, dict(runs=runs, errs=errs, rows=rows,
                          unfused_gb=unfused_gb)


def main() -> int:
    import numpy as np
    import torch

    t_run = time.perf_counter()
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
        from movenet_tpu_torch.ops.cuda import stack_kernel as ks
        for name, log in build.build_logs.items():
            for kernel, what in ptxas_report(log):
                note = bwd_smem_note(ks.library(), kernel) \
                    if name == "stack_kernel" else ""
                print(f"  nvcc {name}: {kernel}: {what}{note}")
        ring_smem_report()
        wgmma_sass_report(libs["stack_kernel"])

        phase = "kernel vs plain"
        mc, model = flagship_model(torch)
        rf = model.receptive_fields
        check(rf == 3072, f"flagship RF is {rf}")
        rate = stream_rate(model)
        records = phase_compare(torch, np, model, rf, rate)
        bad = [r["label"] for r in records if not r["equal"]]
        check(not bad, f"kernel and plain disagree: {bad}")

        phase = "spec kernel vs plain"
        spec_records = phase_spec_compare(torch, np, model, rf, rate)
        bad = [r["label"] for r in spec_records
               if not (r["equal"] and r["hits"] == r["plain_hits"]
                       and r["equal_standard"]
                       and r["hits"] == r["replay"])]
        check(not bad, f"speculative kernel disagrees: {bad}")

        with tempfile.TemporaryDirectory() as tmp:
            run_dir = Path(tmp) / "run"
            write_checkpoint(np, mc, model, run_dir)
            phase = "serve"
            launches = phase_serve(torch, np, mc, rf, run_dir)
            phase = "generate CLI"
            cli_launches = phase_cli(torch, np, rf, run_dir)
            for k, v in cli_launches.items():
                launches[k] += v

            phase = "video kernel vs plain"
            ds = Path(tmp) / "clips"
            clips = video_clips(torch, np, ds, mc)
            video_records = phase_compare(torch, np, model, rf, rate,
                                          clips)
            bad = [r["label"] for r in video_records if not r["equal"]]
            check(not bad, f"video kernel and plain disagree: {bad}")

            phase = "generate CLI with --dataset"
            video_run = Path(tmp) / "video_run"
            write_checkpoint(np, mc, model, video_run, use_video=True)
            for k, v in phase_dataset_cli(torch, np, mc, model, rf,
                                          video_run, ds).items():
                launches[k] += v
        records += video_records

        phase = "train kernels vs plain"
        from movenet_tpu_torch.utils.fixtures import breakdancing
        cfg, bd_model, bd_batch = breakdancing(device="cuda")
        train_recs = phase_train_kernels(torch, np, cfg, bd_model, bd_batch)
        phase = "train"
        runs, train_launches = phase_train(torch, np, cfg, bd_model,
                                           bd_batch)
        launches.update(train_launches)
        phase = "9f (a) float32 kernels vs plain"
        t0 = time.perf_counter()
        f32_recs = phase_f32_kernels(torch, np)
        f32_train = phase_f32_step(torch, np)
        f32_s = time.perf_counter() - t0

        phase = "recompute kernels vs plain"
        _, e2_model, e2_batch = exp02_setup(torch, np)
        tails_recs, tails_flagship = phase_tails_kernels(torch, np, e2_model,
                                                         e2_batch)
        rvs = phase_recompute_vs_save(torch, np, e2_model, e2_batch)
        del e2_model, e2_batch
        phase = "9g (a) float32 recompute and wide head kernels vs plain"
        t0 = time.perf_counter()
        f32_tails_recs = phase_f32_tails_kernels(torch, np)
        f32g_s = time.perf_counter() - t0
        phase = "23 (a) replay kernels vs plain"
        t0 = time.perf_counter()
        replay_recs, replay_non_embed = phase_trunk_replay_kernels(torch, np)
        replay_s = time.perf_counter() - t0

        phase = "merged head"
        t0 = time.perf_counter()
        merged_recs, merged_launches, merged = phase_merged_head(
            torch, np, cfg, bd_model, bd_batch)
        launches.update(merged_launches)
        phase = "gated block"
        gated_recs, gated_launches, gated = phase_gated_block(
            torch, np, bd_model, bd_batch)
        launches.update(gated_launches)
        print(f"merged head + gated block phases: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        phase = "24 (a, b) the probe's kernels and train steps at R = 128"
        t0 = time.perf_counter()
        (probe_model, probe_batch, wide_recs24, wide_recs24_s8, wide_runs,
         wide_launches) = phase_wide_kernels(torch, np)
        phase = "24 (d) generation from the trained probe model"
        wide_gen = phase_wide_generate(torch, np, probe_model, probe_batch)
        del probe_model, probe_batch
        wide_s = time.perf_counter() - t0
        phase = "25 (a) recompute and replay kernels at R = 128 vs plain"
        t0 = time.perf_counter()
        r128_recs = phase_wide_tails_kernels(torch, np)
        r128_s = time.perf_counter() - t0
        phase = "26 (a) float32 recompute kernels at R = 128 and head at " \
            "S = 128 vs plain"
        t0 = time.perf_counter()
        f32w_recs = phase_wide_f32_kernels(torch, np)
        f32w_s = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as tmp:
            phase = "trainer CLI"
            cli_launches, cli_step_ms, ds = phase_trainer_cli(
                torch, np, Path(tmp))
            for k in TAILS_KERNELS:
                launches[k] = cli_launches[k]
            phase = "resume"
            phase_resume(torch, np, Path(tmp), ds)
            phase = "9f (b, c) float32 trainer CLI"
            t0 = time.perf_counter()
            f32_launches, f32_cli = phase_f32_cli(torch, np, Path(tmp), ds)
            f32_s += time.perf_counter() - t0
            for k in F32_KERNELS:
                launches[k] = f32_launches[k]
            print(f"phase 9f: {f32_s:.1f} s", flush=True)
            phase = "data parallel"
            for k, v in phase_data_parallel(torch, np, Path(tmp),
                                            ds).items():
                launches[k] += v
            phase = "flagship trainer CLI"
            flag_cli = phase_flagship_cli(torch, np, Path(tmp))
            for k in TAILS_KERNELS:
                launches[k] += flag_cli["launches"][k]
            phase = "23 (c) replay trainer CLI"
            t0 = time.perf_counter()
            replay_launches, replay_cli = phase_trunk_replay_cli(
                torch, np, Path(tmp))
            launches.update(replay_launches)
            replay_s += time.perf_counter() - t0
            print(f"phase 23: {replay_s:.1f} s", flush=True)
            phase = "24 (c) trainer CLI at --residual_channels 128"
            t0 = time.perf_counter()
            wide_cli = phase_wide_cli(torch, np, Path(tmp), ds)
            wide_s += time.perf_counter() - t0
            print(f"phase 24: {wide_s:.1f} s", flush=True)
            phase = "25 (b, c) trainer CLI at R = 128, recompute and replay"
            t0 = time.perf_counter()
            r128_model, r128_batch, r128_launches, r128_cli = \
                phase_wide_tails_cli(torch, np, Path(tmp), ds)
            phase = "25 (d) generation from the trained R = 128 flagship"
            r128_gen = phase_wide_generate(torch, np, r128_model, r128_batch,
                                           FLAGSHIP_R128_TAG)
            del r128_model, r128_batch
            torch.cuda.empty_cache()
            r128_s += time.perf_counter() - t0
            print(f"phase 25: {r128_s:.1f} s", flush=True)
            phase = "9g (b, c) float32 flagship trainer CLI"
            t0 = time.perf_counter()
            f32g_launches, f32g_cli = phase_f32_flagship_cli(torch, np,
                                                             Path(tmp))
            f32g_s += time.perf_counter() - t0
            for k in {**F32_TAILS_KERNELS, **F32_WIDE_KERNELS}:
                launches[k] = f32g_launches[k]
            print(f"phase 9g: {f32g_s:.1f} s", flush=True)
            phase = "26 (b, c) float32 trainer CLI at R = 128"
            t0 = time.perf_counter()
            f32w_launches, f32w_cli = phase_wide_f32_cli(torch, np,
                                                         Path(tmp), ds)
            f32w_s += time.perf_counter() - t0
            print(f"phase 26: {f32w_s:.1f} s", flush=True)

        phase = "packed head"
        packed_recs, packed_launches = phase_packed_head(torch, np, bd_model,
                                                         bd_batch)
        launches.update(packed_launches)
        phase = "wide head"
        wide_recs = phase_wide_head(torch, np)
        phase = "narrow trunk"
        narrow_recs = phase_narrow_trunk(torch, np)
        with tempfile.TemporaryDirectory() as tmp:
            phase = "experiments 03, 04, 00 and 01"
            exp_recs, exp_launches, exp_ds = phase_experiments(
                torch, np, Path(tmp))
            phase = "sequence parallel"
            seq_ms = phase_seq_parallel(torch, np, Path(tmp), exp_ds)
        for k, v in exp_launches.items():
            launches[k] += v

        phase = "times"
        for exp, r in exp_recs.items():
            print(f"time {exp} trainer CLI ({r['shape']}): update "
                  f"{r['median_ms']:.2f} ms (median after the first, "
                  f"{len(r['step_ms'])} updates), peak memory "
                  f"{r['peak_gb']:.3f} GB; {card}", flush=True)
        print(f"time sequence parallel (experiment 01, data 1 x seq 2, two "
              f"gloo ranks on one card): step {seq_ms[0]:.2f} ms (rank 0, "
              f"median), one process on the whole clips {seq_ms[2]:.2f} ms; "
              f"{card}", flush=True)
        for (name, exp), r in narrow_recs.items():
            print(f"time {name} {exp}: kernel {r['ms']:.3f} ms, plain "
                  f"{r['plain_ms']:.3f} ms; {card}", flush=True)
        for (name, s_, c_, b_), r in wide_recs.items():
            print(f"time {name} S={s_} C={c_} B={b_}: kernel {r['ms']:.3f} "
                  f"ms, plain {r['plain_ms']:.3f} ms; {card}", flush=True)
        for name, byp in packed_recs.items():
            for key, r in byp.items():
                print(f"time {name} {key} (B=2, T=160000, S=C=64, bf16 "
                      f"skip): kernel {r['ms']:.3f} ms, plain "
                      f"{r['plain_ms']:.3f} ms"
                      + (f", unpacked pair {r['unpacked_pair_ms']:.3f} ms"
                         if "unpacked_pair_ms" in r else "")
                      + f"; {card}", flush=True)
        sr = {k: train_recs[k]["ms"] for k in TRAIN_KERNELS}
        print(f"time merged (breakdancing, B=2, T=160000, bf16): forward "
              f"{merged_recs['stack_head_fwd']['ms']:.3f} ms against the "
              f"split route's trunk + head {sr['stack_fwd'] + sr['head_fwd']:.3f}"
              f" ms, backward {merged_recs['stack_head_bwd']['ms']:.3f} ms "
              f"against {sr['stack_bwd'] + sr['head_bwd']:.3f} ms; train step "
              f"{merged['steps'][True]['step_ms']:.2f} ms against "
              f"{merged['steps'][False]['step_ms']:.2f} ms; {card}",
              flush=True)
        for (name, d), r in gated_recs.items():
            print(f"time {name} d={d} (B=2, T=160000, R=S=64, bf16, flat "
                  f"ctx): kernel {r['ms']:.3f} ms, plain "
                  f"{r['plain_ms']:.3f} ms; {card}", flush=True)
        print(f"time per-block trunk forward + backward "
              f"{gated['per_block_ms']:.3f} ms, whole-stack save trunk "
              f"{gated['whole_stack_ms']:.3f} ms; {card}", flush=True)
        print(f"time recompute (experiment 02 CLI, B=2, T=160000, S=8, "
              f"bf16): trainer step {cli_step_ms:.2f} ms (median), peak "
              f"memory of a loss + backward {rvs['peak_recompute']:.3f} GB "
              f"(save {rvs['peak_save']:.3f} GB); {card}", flush=True)
        for name, r in tails_recs.items():
            print(f"time {name}: kernel {r['ms']:.3f} ms, plain "
                  f"{r['plain_ms']:.3f} ms; flagship (L=30, R=S=64, B=2, "
                  f"T=160000, no ctx) kernel {tails_flagship[name]['ms']:.3f}"
                  f" ms, plain {tails_flagship[name]['plain_ms']:.3f} ms; "
                  f"{card}", flush=True)
        print(f"time flagship trainer CLI (recompute): step "
              f"{flag_cli['step_ms']:.2f} ms (median), peak memory of a loss "
              f"+ backward {flag_cli['peaks']['recompute']:.3f} GB (save "
              f"{flag_cli['peaks']['save']:.3f} GB); {card}", flush=True)
        trunk = sum(tails_flagship[k]["ms"] for k in TAILS_KERNELS)
        head = sum(wide_recs[(k, 64, 256, 2)]["ms"]
                   for k in ("head_fwd", "head_bwd"))
        print(f"time flagship trainer step by part: {flag_cli['step_ms']:.2f}"
              f" ms = recompute trunk kernels {trunk:.3f} ms (phase 11, no "
              f"ctx) + head kernels at (64, 256, 2) {head:.3f} ms (phase 18)"
              f" + the rest {flag_cli['step_ms'] - trunk - head:.2f} ms; "
              f"{card}", flush=True)
        for name in TRAIN_KERNELS:
            for tag, recs in ((PROBE_TAG, wide_recs24),
                              (EXP02_R128_TAG, wide_recs24_s8)):
                r = recs[name]
                print(f"time {name} {tag}: kernel {r['ms']:.3f} ms, plain "
                      f"{r['plain_ms']:.3f} ms; {card}", flush=True)
        r = wide_recs24["stack_bwd flat"]
        print(f"time stack_bwd {PROBE_TAG} flat ctx: kernel {r['ms']:.3f} ms,"
              f" plain {r['plain_ms']:.3f} ms; {card}", flush=True)
        wk, wp = wide_runs["kernels"], wide_runs["plain"]
        print(f"time train {PROBE_TAG} (B=2, T=160000, bf16): step "
              f"{wk['step_ms']:.2f} ms, {1e3 / wk['step_ms']:.3f} steps/s, "
              f"plain step {wp['step_ms']:.2f} ms, peak memory "
              f"{wk['peak_gb']:.2f} GB (plain {wp['peak_gb']:.2f} GB); "
              f"{card}", flush=True)
        print(f"time trainer CLI {EXP02_R128_TAG}: update "
              f"{wide_cli['step_ms']:.2f} ms (median after the first), peak "
              f"memory {wide_cli['peak_gb']:.3f} GB; {card}", flush=True)
        for name, r in wide_gen.items():
            print(f"time generate {PROBE_TAG} {name} (B=1, video): kernel "
                  f"{r['ms']:.2f} ms for {N_WIDE_GEN} samples, plain "
                  f"{r['plain_ms']:.1f} ms; {card}", flush=True)
        for key, r in r128_cli["runs"].items():
            print(f"time trainer CLI {key} at R=128: update "
                  f"{r['step_ms']:.2f} ms (median after the first), peak "
                  f"memory {r['peak_gb']:.3f} GB; {card}", flush=True)
        print(f"time {FLAGSHIP_R128_TAG} one loss + backward peaks: "
              + ", ".join(f"{k} {v:.3f} GB" for k, v in
                          r128_cli["peaks"].items()) + f"; {card}",
              flush=True)
        for name, r in r128_gen.items():
            print(f"time generate {FLAGSHIP_R128_TAG} {name} (B=1, video, "
                  f"{r['slab'] // 1024} KB slabs): kernel {r['ms']:.2f} ms "
                  f"for {N_WIDE_GEN} samples, plain {r['plain_ms']:.1f} ms; "
                  f"{card}", flush=True)
        for (name, label), r in r128_recs.items():
            print(f"time {name} {label}: kernel {r['ms']:.3f} ms, plain "
                  f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.3f} ms; "
                  f"{card}", flush=True)
        for (name, label), r in f32w_recs.items():
            print(f"time {name} {label}: kernel {r['ms']:.3f} ms, bf16 form "
                  f"{r['bf16_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                  f"bound {r['bound'][0]:.3f} ms; {card}", flush=True)
        for key, r in f32w_cli["runs"].items():
            print(f"time f32 trainer CLI {key} at R=128 (float32, "
                  f"recompute): update {r['step_ms']:.2f} ms (median after "
                  f"the first), peak memory {r['peak_gb']:.3f} GB; {card}",
                  flush=True)
        print(f"time {FLAGSHIP_R128_TAG} float32 routes: the unfused "
              f"route's loss + backward on {f32w_cli['rows']} row(s) peaked "
              f"at {f32w_cli['unfused_gb']:.3f} GB; {card}", flush=True)
        k, pl = runs["kernels"], runs["plain"]
        print(f"time train (breakdancing, B=2, T=160000, bf16): step "
              f"{k['step_ms']:.2f} ms, {1e3 / k['step_ms']:.3f} steps/s, "
              f"plain step {pl['step_ms']:.2f} ms, peak memory "
              f"{k['peak_gb']:.2f} GB; {card}", flush=True)
        for name, r in train_recs.items():
            print(f"time {name}: kernel {r['ms']:.3f} ms, plain "
                  f"{r['plain_ms']:.3f} ms; {card}", flush=True)
        for (name, label), r in f32_recs.items():
            print(f"time {name} {label}: kernel {r['ms']:.3f} ms, bf16 form "
                  f"{r['bf16_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                  f"bound {r['bound'][0]:.3f} ms; {card}", flush=True)
        print(f"time f32 train (breakdancing, B=2, T=160000, float32): step "
              f"{f32_train['step_ms']:.2f} ms, peak memory "
              f"{f32_train['peak_gb']:.2f} GB (bf16 {k['step_ms']:.2f} ms); "
              f"{card}", flush=True)
        print(f"time f32 trainer CLI (experiment 02 flags, float32): update "
              f"{f32_cli['step_ms']:.2f} ms (median after the first), peak "
              f"memory {f32_cli['peak_gb']:.3f} GB; {card}", flush=True)
        for (name, label), r in f32_tails_recs.items():
            print(f"time {name} {label}: kernel {r['ms']:.3f} ms, bf16 form "
                  f"{r['bf16_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                  f"bound {r['bound'][0]:.3f} ms; {card}", flush=True)
        for (name, label), r in replay_recs.items():
            print(f"time {name} {label}: kernel {r['ms']:.3f} ms, save form "
                  f"{r['save_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                  f"bound {r['bound'][0]:.3f} ms; {card}", flush=True)
        pk = flag_cli["peaks_by_dtype"]
        for dtype, r in replay_cli.items():
            print(f"time replay flagship trainer CLI ({dtype}): update "
                  f"{r['step_ms']:.2f} ms (median after the first), peak "
                  f"memory {r['peak_gb']:.3f} GB; one loss + backward peaks "
                  f"save {pk[(dtype, 'save')]:.3f} GB, replay "
                  f"{pk[(dtype, 'replay')]:.3f} GB, recompute "
                  f"{pk[(dtype, 'recompute')]:.3f} GB; {card}", flush=True)
        print(f"time f32 flagship trainer CLI (float32, recompute, C=256): "
              f"update {f32g_cli['step_ms']:.2f} ms (median after the "
              f"first; bf16 {flag_cli['step_ms']:.2f} ms), peak memory "
              f"{f32g_cli['peak_gb']:.3f} GB; the unfused route's loss + "
              f"backward on {f32g_cli['rows']} row(s) peaked at "
              f"{f32g_cli['unfused_gb']:.3f} GB; {card}", flush=True)
        audio_only = {r["label"]: r for r in records}
        for r in records:
            beside = ""
            twin = audio_only.get(r["label"].replace("video ", "", 1))
            if twin is not r and twin is not None:
                beside = (f"; audio-only kernel {twin['sps']:.0f} samples/s "
                          f"({twin['ms'] * 1e3 / N_COMPARE:.1f} us/step)")
            print(f"time {r['label']}: kernel {r['sps']:.0f} samples/s "
                  f"({r['ms']:.2f} ms for {r['batch']}x{N_COMPARE}, "
                  f"{r['us_per_step']:.2f} us/step; stream bound "
                  f"{r['stream_bound_ms'] * 1e3 / N_COMPARE:.2f} us/step), "
                  f"plain {r['plain_sps']:.0f} samples/s ({r['plain_ms']:.1f}"
                  f" ms){beside}; {card}", flush=True)
        for r in spec_records:
            print(f"time spec {r['label']}: {r['us_per_sample']:.3f} us per "
                  f"generated sample, {r['us_per_iter']:.3f} us per "
                  f"iteration, standard kernel "
                  f"{r['standard_us_per_sample']:.3f} us per step; hits "
                  f"{r['hits']}/{N_COMPARE}; stream bound "
                  f"{r['stream_bound_ms']:.3f} ms; plain {r['plain_ms']:.1f} "
                  f"ms; {card}", flush=True)

        phase = "kernels line"
        from movenet_tpu_torch.ops.cuda import ar_sampler as ars
        kernels = []
        for name in REPLACES:
            mine = [r for r in records + spec_records if r["name"] == name]
            timed = [r for r in mine if r["batch"] == 1][0]
            video = "_ctx_" in name
            bound_ms, bound_by = ar_bound(model, 1, N_COMPARE, video)
            kernels.append({
                "name": name, "route": "cuda",
                "source": ars.KERNEL_SOURCE,
                "replaces": REPLACES[name]
                + (" (has_ctx=True)" if video else ""),
                "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": timed["ms"], "plain_ms": timed["plain_ms"],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None,
                "matches_plain": all(r["equal"] for r in mine),
                "shape": f"B=1, n=RF+{N_COMPARE}"
                + (", video (160 frames)" if video else ""),
                "stream_bound_ms": timed["stream_bound_ms"],
                **({"us_per_iteration": timed["us_per_iter"]}
                   if "us_per_iter" in timed
                   else {"us_per_step": timed["us_per_step"]})})
        mc = cfg.model_config
        bounds = train_bounds(
            2, mc.max_audio_frames, len(bd_model.dilations),
            mc.residual_channels, mc.skip_channels, mc.input_channels,
            mc.input_channels, 3 * mc.residual_channels, True)
        for name, (source, replaces) in TRAIN_KERNELS.items():
            r = train_recs[name]
            widths = []
            for (n, exp), x in narrow_recs.items():
                if n == name:
                    b_, r_, s_, dil = NARROW_TRUNKS[exp]
                    widths.append(dict(
                        shape=f"{exp}: B={b_}, T=160000, L={len(dil)}, "
                              f"R={r_}, S={s_}, V=128, bf16, video triple",
                        ms=x["ms"], plain_ms=x["plain_ms"],
                        max_abs_err=x["max_abs_err"],
                        bound_ms=x["bound"][name][0],
                        bound_by=x["bound"][name][1],
                        **({"by_grid_ms": x["by_grid"]} if "by_grid" in x
                           else {})))
            for (n, s_, c_, b_), x in wide_recs.items():
                if n == name:
                    hb = train_bounds(b_, 160_000, 1, 8, s_, c_, c_, 16,
                                      False)[name]
                    widths.append(dict(
                        shape=f"S={s_}, C={c_}, B={b_}, T=160000, bf16",
                        ms=x["ms"], plain_ms=x["plain_ms"],
                        max_abs_err=x["max_abs_err"], bound_ms=hb[0],
                        bound_by=hb[1]))
            # phase 24: the wide forms at the probe's shapes (launches of
            # its 1 + 5 kernel steps) and at experiment 02's CLI widths at
            # --residual_channels 128 (launches of the CLI's 3 updates and
            # validation batches)
            for shape, x, s_, n_launch in (
                    (PROBE_SHAPE, wide_recs24[name], 128,
                     wide_launches[name]),
                    (EXP02_R128_SHAPE, wide_recs24_s8[name], 8,
                     wide_cli["launches"][name])):
                wb = train_bounds(2, 160_000, 9, 128, s_, 64, 64, 3 * 128,
                                  True)[name]
                widths.append(dict(
                    shape=shape, ms=x["ms"], plain_ms=x["plain_ms"],
                    max_abs_err=x["max_abs_err"], bound_ms=wb[0],
                    bound_by=wb[1], launches=n_launch,
                    **({"by_grid_ms": x["by_grid"]} if "by_grid" in x
                       else {})))
            if name == "stack_bwd":
                x = wide_recs24["stack_bwd flat"]
                wb = train_bounds(2, 160_000, 9, 128, 128, 64, 64, 3 * 128,
                                  False)[name]
                widths.append(dict(
                    shape=PROBE_SHAPE.replace("video triple", "flat ctx"),
                    ms=x["ms"], plain_ms=x["plain_ms"],
                    max_abs_err=x["max_abs_err"], bound_ms=wb[0],
                    bound_by=wb[1], by_grid_ms=x["by_grid"]))
            check(all(w.get("launches", 1) > 0 for w in widths),
                  f"{name}: a wide form was not launched on its path")
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max([r["max_abs_err"]]
                                   + [w["max_abs_err"] for w in widths]),
                "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1], "library_ms": None,
                "matches_plain": True,
                "shape": "breakdancing: B=2, T=160000, L=9, R=S=C=64, bf16",
                "widths": widths,
                **({"by_grid_ms": r["by_grid"]} if "by_grid" in r else {})})
        from movenet_tpu_torch.ops.stack_kernel import tails_every
        tb = tails_bounds(2, 160_000, 9, 64, 8, 3 * 64, tails_every(9))
        tbf = tails_bounds(2, 160_000, 30, 64, 64, 2 * 64, tails_every(30))
        for name, (source, replaces) in TAILS_KERNELS.items():
            r, f = tails_recs[name], tails_flagship[name]
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"], f["max_abs_err"]),
                "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": tb[name][0],
                "bound_by": tb[name][1], "library_ms": None,
                "matches_plain": True,
                "shape": "experiment 02 CLI: B=2, T=160000, L=9, R=C=64, "
                         "S=8, bf16, flat ctx",
                "widths": [dict(
                    shape="flagship: B=2, T=160000, L=30 (dilations 1..512 "
                          "x 3), R=S=64, bf16, no ctx",
                    ms=f["ms"], plain_ms=f["plain_ms"],
                    max_abs_err=f["max_abs_err"], bound_ms=tbf[name][0],
                    bound_by=tbf[name][1])]})
        mb = merged_bounds(2, mc.max_audio_frames, len(bd_model.dilations),
                           mc.residual_channels, mc.skip_channels,
                           mc.input_channels, 3 * mc.residual_channels)
        for name, (source, replaces) in MERGED_KERNELS.items():
            r = merged_recs[name]
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": mb[name][0],
                "bound_by": mb[name][1], "library_ms": None,
                "matches_plain": True,
                "shape": "breakdancing, merged: B=2, T=160000, L=9, "
                         "R=S=C=64, bf16, flat ctx",
                **({"by_grid_ms": r["by_grid"]} if "by_grid" in r else {})})
        gbd = gated_bounds(2, mc.max_audio_frames, mc.residual_channels,
                           mc.skip_channels, 3 * mc.residual_channels)
        for name, (source, replaces) in GATED_KERNELS.items():
            mine = [r for (n, _), r in gated_recs.items() if n == name]
            r = gated_recs[(name, GATED_DILATIONS[0])]
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(x["max_abs_err"] for x in mine),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": gbd[name][0], "bound_by": gbd[name][1],
                "library_ms": None, "matches_plain": True,
                "shape": f"one block: B=2, T=160000, R=S=64, bf16, flat "
                         f"ctx, d={GATED_DILATIONS[0]} (ms; max_abs_err "
                         f"over d in {list(GATED_DILATIONS)})"})
        pb = packed_bounds(2 * mc.max_audio_frames, 64, 64, 2,
                           mc.max_audio_frames)
        for name, (source, replaces) in PACKED_KERNELS.items():
            byp = packed_recs[name]
            r = byp["parity=True"]
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(x["max_abs_err"] for x in byp.values()),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": pb[name][0], "bound_by": pb[name][1],
                "library_ms": None, "matches_plain": True,
                "unpacked_pair_ms": r["unpacked_pair_ms"],
                "shape": "PACKED_HEAD on, breakdancing head: B=2, T=160000, "
                         "S=C=64, bf16 skip, parity CE (max_abs_err over "
                         "parity on and off)"})
        for name, (source, replaces) in F32_KERNELS.items():
            r = f32_recs[(name, "exp02")]
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces + " (float32)",
                "launches": launches[name],
                "max_abs_err": max(x["max_abs_err"] for (n, _), x in
                                   f32_recs.items() if n == name),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": None, "matches_plain": True,
                "bf16_ms": r["bf16_ms"],
                # the trunk's non-embed form's launches through
                # fused_stack(..., "save") in phase 23 (a), beside the
                # embed form's above
                **({"non_embed_launches": replay_non_embed[name]}
                   if name in replay_non_embed else {}),
                "shape": "experiment 02 CLI: B=2, T=160000, L=9, R=C=64, S=8, "
                         "float32, video triple (max_abs_err over the "
                         "widths)",
                "widths": [dict(
                    shape=f"{label}: B={b_}, T=160000, L={len(dil)}, R={r_}, "
                          f"S={s_}, V=C={v_}, float32, video triple",
                    ms=x["ms"], bf16_ms=x["bf16_ms"], plain_ms=x["plain_ms"],
                    max_abs_err=x["max_abs_err"], bound_ms=x["bound"][0],
                    bound_by=x["bound"][1])
                    for (n, label), x in f32_recs.items()
                    if n == name and label != "exp02"
                    for b_, dil, r_, s_, v_ in [F32_SHAPES[label]]]})
        main_shape = {"stack_fwd_tails_f32": "flagship",
                      "stack_bwd_tails_f32": "flagship",
                      "head_fwd_f32_wide": "S=64 C=256 B=2",
                      "head_bwd_f32_wide": "S=64 C=256 B=2"}
        for name, (source, replaces) in {**F32_TAILS_KERNELS,
                                         **F32_WIDE_KERNELS}.items():
            r = f32_tails_recs[(name, main_shape[name])]
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces + " (float32"
                + (", C = 256)" if "wide" in name else ")"),
                "launches": launches[name],
                "max_abs_err": max(x["max_abs_err"] for (n, _), x in
                                   f32_tails_recs.items() if n == name),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": None, "matches_plain": True,
                "bf16_ms": r["bf16_ms"],
                "shape": ("flagship: B=2, T=160000, L=30 (dilations 1..512 "
                          "x 3), R=S=64, float32, flat ctx"
                          if "tails" in name else
                          "S=64, C=256, B=2, T=160000, float32, parity CE")
                + " (max_abs_err over the widths)",
                "widths": [dict(
                    shape=label, ms=x["ms"], bf16_ms=x["bf16_ms"],
                    plain_ms=x["plain_ms"], max_abs_err=x["max_abs_err"],
                    bound_ms=x["bound"][0], bound_by=x["bound"][1])
                    for (n, label), x in f32_tails_recs.items()
                    if n == name and label != main_shape[name]]})
        for name, (source, replaces) in TRUNK_REPLAY_KERNELS.items():
            f32 = name.endswith("_f32")
            # the trainer's own form: the flagship with the video triple
            r = replay_recs[(name, "flagship proj")]
            others = [(label, x) for (n, label), x in replay_recs.items()
                      if n == name and label != "flagship proj"]
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces + " (save_h=False"
                + (", float32)" if f32 else ")"),
                "launches": launches[name],
                "max_abs_err": max([r["max_abs_err"]]
                                   + [x["max_abs_err"] for _, x in others]),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": None, "matches_plain": True,
                "save_ms": r["save_ms"],
                "shape": "flagship: B=2, T=160000, L=30 (dilations 1..512 "
                         "x 3), R=S=64, " + ("float32" if f32 else "bf16")
                         + ", video projection triple (max_abs_err over the "
                         "widths)",
                **({"by_grid_ms": r["by_grid"]} if "by_grid" in r else {}),
                "widths": [dict(
                    shape=label, ms=x["ms"], save_ms=x["save_ms"],
                    plain_ms=x["plain_ms"], max_abs_err=x["max_abs_err"],
                    bound_ms=x["bound"][0], bound_by=x["bound"][1],
                    **({"by_grid_ms": x["by_grid"]} if "by_grid" in x
                       else {}))
                    for label, x in others]})
        # phase 25: the recompute and replay kernels at R = 128, timed at
        # the flagship's depth with the video triple (the trainer's form),
        # launched by the trainer CLI runs of phase 25 (b, c)
        for name, (source, replaces) in WIDE_TAILS_KERNELS.items():
            main_label = f"{FLAGSHIP_R128_TAG} proj"
            r = r128_recs[(name, main_label)]
            others = [(label, x) for (n, label), x in r128_recs.items()
                      if n == name and label != main_label]
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces + (" (save_h=False, R = 128)"
                                        if "replay" in name
                                        else " (R = 128)"),
                "launches": r128_launches[name],
                "max_abs_err": max([r["max_abs_err"]]
                                   + [x["max_abs_err"] for _, x in others]),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": None, "matches_plain": True,
                **({"save_ms": r["save_ms"]} if "save_ms" in r else {}),
                "shape": "flagship depth at R=S=128: B=2, T=160000, L=30 "
                         "(dilations 1..512 x 3), bf16, video projection "
                         "triple (max_abs_err over the widths)",
                **({"by_grid_ms": r["by_grid"]} if "by_grid" in r else {}),
                "widths": [dict(
                    shape=label, ms=x["ms"], plain_ms=x["plain_ms"],
                    max_abs_err=x["max_abs_err"], bound_ms=x["bound"][0],
                    bound_by=x["bound"][1],
                    **({"save_ms": x["save_ms"]} if "save_ms" in x else {}),
                    **({"by_grid_ms": x["by_grid"]} if "by_grid" in x
                       else {}))
                    for label, x in others]})
        # phase 26: the float32 recompute forms at R = 128, timed at the
        # flagship's depth with the video triple, and the float32 head at
        # S = 128, timed at the flagship's (128, 256, 2); launched by the
        # trainer CLI runs of phase 26 (b, c)
        main_label = {**{k: f"{FLAGSHIP_R128_TAG} proj"
                         for k in WIDE_F32_KERNELS},
                      **{k: "S=128 C=256 B=2" for k in WIDE_F32_HEAD_KERNELS}}
        for name, (source, replaces) in {**WIDE_F32_KERNELS,
                                         **WIDE_F32_HEAD_KERNELS}.items():
            r = f32w_recs[(name, main_label[name])]
            others = [(label, x) for (n, label), x in f32w_recs.items()
                      if n == name and label != main_label[name]]
            trunk = "tails" in name
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces + (" (float32, R = 128)" if trunk
                                        else " (float32, S = 128)"),
                "launches": f32w_launches[name],
                "max_abs_err": max([r["max_abs_err"]]
                                   + [x["max_abs_err"] for _, x in others]),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": None, "matches_plain": True,
                "bf16_ms": r["bf16_ms"],
                "shape": ("flagship depth at R=S=128: B=2, T=160000, L=30 "
                          "(dilations 1..512 x 3), float32, video "
                          "projection triple" if trunk else
                          "S=128, C=256, B=2, T=160000, float32, parity CE")
                + " (max_abs_err over the widths)",
                **({"by_grid_ms": r["by_grid"]} if "by_grid" in r else {}),
                "widths": [dict(
                    shape=label, ms=x["ms"], bf16_ms=x["bf16_ms"],
                    plain_ms=x["plain_ms"], max_abs_err=x["max_abs_err"],
                    bound_ms=x["bound"][0], bound_by=x["bound"][1])
                    for label, x in others]})
        # every form of the fourteen TPU kernel functions: the AR kernel's
        # four and the speculative kernel's two, the ten training kernels,
        # the two packed ones, the four float32 save and C <= 128 head
        # forms, the four float32 recompute and wide head forms, the
        # replay strategy's four (bf16 and float32), the recompute and
        # replay forms at R = 128 and the float32 recompute and head forms
        # at R = S = 128
        check(len(kernels) == 38, f"{len(kernels)} kernels in the line")
        check(all(k["launches"] > 0 for k in kernels),
              "a kernel of the path was not launched")
        print(f"chip_smoke: every phase passed in "
              f"{time.perf_counter() - t_run:.1f} s", flush=True)
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
