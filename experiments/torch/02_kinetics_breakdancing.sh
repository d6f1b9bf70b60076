#!/usr/bin/env bash
# movenet_tpu_torch twin of experiments/02_kinetics_breakdancing.sh: the same flags through
# the port's trainer CLI, on the CUDA card (it raises without one).
# Experiment 02: single-category breakdancing run
# (reference: experiments/02_kinetics_breakdancing.mk:6-15,44-66)
# Spot-instance auto-resume becomes --auto_resume 1 (checkpoint+opt state).
set -euo pipefail
DATASET=${1:?usage: 02_kinetics_breakdancing.sh <dataset_dir> [extra flags...]}; shift || true
exec python -m movenet_tpu_torch.train.cli \
  --dataset "$DATASET" \
  --use_video 1 \
  --n_epochs 10 \
  --batch_size 2 \
  --learning_rate 0.0003 \
  --input_channels 64 \
  --residual_channels 64 \
  --layer_size 3 \
  --stack_size 3 \
  --checkpoint_every 1 \
  --fused_blocks 1 \
  --auto_resume 1 \
  "$@"
