#!/usr/bin/env bash
# movenet_tpu_torch twin of experiments/03_kinetics_scale_up.sh: the same flags through
# the port's trainer CLI, on the CUDA card (it raises without one).
# Experiment 03: multi-device scale-up (reference: experiments/03_kinetics_scale_up.mk)
# The reference used 4xV100 DDP; in the port --mesh_data -1 fits the data
# axis to the largest divisor of the batch that the host's cards allow (on
# four cards: three ranks of one row, one card idle) and spawns one process
# a rank over NCCL. bs=3, input_ch 128, res_ch 32, layer 2 stack 2 (RF=8),
# grad accumulation 10.
set -euo pipefail
DATASET=${1:?usage: 03_kinetics_scale_up.sh <dataset_dir> [extra flags...]}; shift || true
exec python -m movenet_tpu_torch.train.cli \
  --dataset "$DATASET" \
  --use_video 1 \
  --n_epochs 100 \
  --batch_size 3 \
  --accumulation_steps 10 \
  --learning_rate 0.0003 \
  --input_channels 128 \
  --residual_channels 32 \
  --layer_size 2 \
  --stack_size 2 \
  --num_workers 4 \
  --checkpoint_every 1 \
  --fused_blocks 1 \
  --mesh_data -1 \
  "$@"
