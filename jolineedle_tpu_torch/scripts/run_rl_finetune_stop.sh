#!/bin/sh
# The REINFORCE STOP fine-tune of a supervised flagship checkpoint, for the
# port: scripts/run_rl_finetune_stop.sh with the same arguments,
# environment variables and flags, run by
# `python -m jolineedle_tpu_torch.main`. It warm-starts from the supervised
# run (--init-from, the port's .pt files or the JAX package's msgpack ones),
# enables STOP and stretches the episode to 20 steps; the best checkpoint is
# tracked by trajectory mAP (--best-metric map).
#
# Usage: sh jolineedle_tpu_torch/scripts/run_rl_finetune_stop.sh <work_dir> \
#          <sup_run_dir> [detector] [max_iters] [entropy]
#
#   sup_run_dir  the supervised run directory (e.g. runs/sup_s1/r3_sup_yolox-s
#                from run_sup_flagship.sh)
#   detector     must match the supervised run's --image-processor
#                (yolox-nano, the default, or yolox-s with --gpt-backbone
#                yolox-nano as in the flagship recipe)
#
# DATASET_DIR (default: toyds_big in the working directory; it must be the
# supervised run's) and EXTRA_FLAGS (appended to the flags, e.g.
# "--compute-dtype float32") are read from the environment.
#
# The JAX package's result for this recipe with yolox-s, from its yolox-s
# flagship checkpoint (full-test final validation over the 150 test images
# from the best checkpoint, greedy, merged boxes;
# docs/experiment_log.md:564-603): single-start mAP 0.623, stop_used 0.513,
# stop_misused 0.04, patches found 0.894, yolo_map 0.891. The port has not
# yet run it on the card.
set -e
WORK_DIR=${1:?work_dir required}
SUP_RUN=${2:?supervised run dir required}
DETECTOR=${3:-yolox-nano}
MAX_ITERS=${4:-10000}
ENTROPY=${5:-0.01}
DATASET_DIR=${DATASET_DIR:-toyds_big}
if [ "$DETECTOR" = "yolox-nano" ]; then
  BACKBONE_FLAGS="--image-processor yolox-nano"
else
  BACKBONE_FLAGS="--image-processor $DETECTOR --gpt-backbone yolox-nano"
fi
exec python -m jolineedle_tpu_torch.main \
  --seed 2 \
  --dataset-dir "$DATASET_DIR" \
  --training-mode reinforce \
  --init-from "$SUP_RUN" \
  --work-dir "$WORK_DIR" \
  --max-iters "$MAX_ITERS" \
  --test-every 1000 \
  --test-samples 20 \
  --env-name "rlft_$DETECTOR" \
  --group r3 \
  --model-type gpt-nano \
  $BACKBONE_FLAGS \
  --concat-embeddings \
  --decoder-pos-encoding \
  --use-positional-embedding \
  --enable-stop \
  --entropy-weight "$ENTROPY" \
  --max-seq-len 20 \
  --batch-size 16 \
  --gradient-accumulation 4 \
  --steps-per-dispatch 4 \
  --patch-size 64 \
  --minimum-image-size 0 \
  --detector-conf-threshold 0.1 \
  --merge-bboxes \
  --lr 3e-5 \
  --yolo-lr 2e-5 \
  --best-metric map \
  --num-workers 1 \
  $EXTRA_FLAGS
