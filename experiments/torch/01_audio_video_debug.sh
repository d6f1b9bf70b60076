#!/usr/bin/env bash
# movenet_tpu_torch twin of experiments/01_audio_video_debug.sh: the same flags through
# the port's trainer CLI, on the CUDA card (it raises without one).
# Experiment 01: audio+video debug (reference: experiments/01_audio_video_debug.mk:10-18)
# Resume chains via --pretrained_model_path <prev_run_dir> or --auto_resume 1.
set -euo pipefail
DATASET=${1:?usage: 01_audio_video_debug.sh <dataset_dir> [extra flags...]}; shift || true
exec python -m movenet_tpu_torch.train.cli \
  --dataset "$DATASET" \
  --use_video 1 \
  --n_epochs 500 \
  --learning_rate 0.0003 \
  --input_channels 64 \
  --residual_channels 64 \
  --layer_size 3 \
  --stack_size 3 \
  --checkpoint_every 25 \
  "$@"
