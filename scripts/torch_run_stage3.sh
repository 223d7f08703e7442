#!/usr/bin/env bash
# WeDetect-Ref SFT stage 3 with the PyTorch port: torchrun starts one
# process a card, each joins through eval/dist.maybe_initialize (nccl),
# and cli/train_ref.py shards the parameters, their gradients and the
# optimizer state over every rank (ZeRO-3)
# (--fsdp -1, make_mesh(data=1, fsdp=world)); every rank takes the same
# sample. Stage default LR 1e-5 and the stage's freeze schedule come from
# train/ref_lm.stage_optimizer (stage 3: train/ref_sft.ref_optimizer).
#   DATA=<referring data json> CKPT=<hf checkpoint dir> \
#   OUT=output/stage3 NPROC=8 scripts/torch_run_stage3.sh [extra flags]
set -euo pipefail
DATA=${DATA:?set DATA=<path to referring data json>}
CKPT=${CKPT:-}
OUT=${OUT:-output/stage3}
PROPOSALS=${PROPOSALS:?set PROPOSALS=<per-image proposal json>}
NPROC=${NPROC:-$(nvidia-smi --list-gpus 2>/dev/null | wc -l)}
[ "$NPROC" -gt 0 ] || NPROC=1
mkdir -p "$OUT"
torchrun --standalone --nproc_per_node "$NPROC" \
    -m wedetect_tpu_torch.cli.train_ref \
    --stage 3 --data "$DATA" \
    ${CKPT:+--ref_checkpoint "$CKPT"} \
    --ckpt-dir "$OUT" --proposals "$PROPOSALS" \
    "$@" 2>&1 | tee -a "$OUT/stage3_log.txt"
