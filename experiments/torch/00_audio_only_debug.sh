#!/usr/bin/env bash
# movenet_tpu_torch twin of experiments/00_audio_only_debug.sh: the same flags through
# the port's trainer CLI, on the CUDA card (it raises without one).
# Experiment 00: audio-only debug (reference: experiments/00_audio_only_debug.mk:5-13)
# kinetics-debug, lr 3e-4, ch 64/64, layer 3 stack 3 (RF=24), ckpt every 25
set -euo pipefail
DATASET=${1:?usage: 00_audio_only_debug.sh <dataset_dir> [extra flags...]}; shift || true
exec python -m movenet_tpu_torch.train.cli \
  --dataset "$DATASET" \
  --use_video 0 \
  --n_epochs 500 \
  --learning_rate 0.0003 \
  --input_channels 64 \
  --residual_channels 64 \
  --layer_size 3 \
  --stack_size 3 \
  --checkpoint_every 25 \
  "$@"
