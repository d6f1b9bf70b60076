#!/usr/bin/env bash
# movenet_tpu_torch twin of experiments/04_kinetics_receptive_field.sh: the same flags through
# the port's trainer CLI, on the CUDA card (it raises without one).
# Experiment 04: large receptive field (reference: experiments/04_kinetics_receptive_field.mk)
# layer 14 stack 1 -> RF=16384 (~1s of audio), weight_decay 0.1,
# generation of 20000 samples; --remat 1 keeps the 160k-sample
# activations within HBM.
set -euo pipefail
DATASET=${1:?usage: 04_kinetics_receptive_field.sh <dataset_dir> [extra flags...]}; shift || true
exec python -m movenet_tpu_torch.train.cli \
  --dataset "$DATASET" \
  --use_video 1 \
  --n_epochs 100 \
  --batch_size 2 \
  --accumulation_steps 3 \
  --learning_rate 0.0003 \
  --max_learning_rate 0.0003 \
  --scheduler OneCycleLR \
  --weight_decay 0.1 \
  --input_channels 128 \
  --residual_channels 16 \
  --layer_size 14 \
  --stack_size 1 \
  --remat 1 \
  --generate_n_samples 20000 \
  --checkpoint_every 1 \
  --fused_blocks 1 \
  "$@"
