#!/bin/sh
# From-scratch REINFORCE with --enable-stop on the 1.5k toy set, for the
# port: scripts/run_rl_scratch_stop.sh with the same arguments, environment
# variables and flags, run by `python -m jolineedle_tpu_torch.main`. The
# shared yolox-nano backbone, episodes of 20 steps, batch 16, and an
# entropy floor of 0.02 (the fine-tune's 0.01 never revisits STOP).
#
# Usage: sh jolineedle_tpu_torch/scripts/run_rl_scratch_stop.sh <work_dir> \
#          [max_iters] [entropy]
#
# DATASET_DIR (default: toyds_big in the working directory) is read from
# the environment.
#
# The JAX package's result for this recipe (full-test final validation over
# the 150 test images from the last checkpoint after 30k + 40k iterations,
# greedy, merged boxes; docs/experiment_log.md:664-705): single-start mAP
# 0.604, stop_used 0.000 (STOP never fires from scratch), patches found
# 0.828, bbox found 0.987, yolo_map 0.886. The port has not yet run it on
# the card.
set -e
WORK_DIR=${1:?work_dir required}
MAX_ITERS=${2:-30000}
ENTROPY=${3:-0.02}
DATASET_DIR=${DATASET_DIR:-toyds_big}
exec python -m jolineedle_tpu_torch.main \
  --seed 1 \
  --dataset-dir "$DATASET_DIR" \
  --training-mode reinforce \
  --work-dir "$WORK_DIR" \
  --max-iters "$MAX_ITERS" \
  --test-every 1000 \
  --test-samples 20 \
  --env-name scratch_stop \
  --group r3 \
  --model-type gpt-nano \
  --image-processor yolox-nano \
  --concat-embeddings \
  --decoder-pos-encoding \
  --use-positional-embedding \
  --enable-stop \
  --entropy-weight "$ENTROPY" \
  --max-seq-len 20 \
  --batch-size 16 \
  --gradient-accumulation 8 \
  --steps-per-dispatch 4 \
  --patch-size 64 \
  --minimum-image-size 0 \
  --detector-conf-threshold 0.1 \
  --merge-bboxes \
  --lr 1e-4 \
  --yolo-lr 1e-4 \
  --num-workers 1
