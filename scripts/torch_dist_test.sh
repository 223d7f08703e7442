#!/usr/bin/env bash
# Multi-card detector evaluation with the PyTorch port: torchrun starts
# one process a card, each joins through eval/dist.maybe_initialize
# (nccl) and evaluates its contiguous shard; rank 0 merges the results.
#   NPROC=8 scripts/torch_dist_test.sh <checkpoint.pth> <ann.json> \
#       <img_root> [extra flags]
# On the CPU (gloo, the plain PyTorch path): add --device cpu.
set -euo pipefail
CHECKPOINT=$1
ANN=$2
IMG_ROOT=$3
NPROC=${NPROC:-$(nvidia-smi --list-gpus 2>/dev/null | wc -l)}
[ "$NPROC" -gt 0 ] || NPROC=1
exec torchrun --standalone --nproc_per_node "$NPROC" \
    -m wedetect_tpu_torch.cli.test \
    --checkpoint "$CHECKPOINT" --ann "$ANN" --img-root "$IMG_ROOT" \
    "${@:4}"
