#!/bin/sh
# One seed of the REINFORCE STOP fine-tune on the card, from the port's own
# supervised flagship, timed and checked: the 1.5k toy set
# (make_toyds_big), then run_sup_flagship.sh <work>/sup yolox-s under
# time_recipe.py (or the supervised run directory the caller names), then
# run_rl_finetune_stop.sh <work>/rlft <sup run> yolox-s under time_recipe.py,
# then eval_checkpoint.py --ckpt best on the fine-tune, which must agree
# with its final validation within 1e-6. The runs stay where they were
# trained; the small files (logs, metrics, best_model.txt, config.json, the
# eval curves, the cross-check and the quality bands) go to the output
# directory.
#
# Usage: SEED=1 sh jolineedle_tpu_torch/scripts/run_rlft_seed.sh [out_dir] \
#          [work_dir] [sup_run_dir]
#
#   out_dir      default chiprun_out/rlft_s$SEED
#   work_dir     default build/runs/rlft_s$SEED (the fine-tune is
#                <work_dir>/rlft/r3_rlft_yolox-s)
#   sup_run_dir  a supervised yolox-s flagship run to start from (its
#                checkpoint_best.pt, and metrics.json for the warm start's
#                mAP); default: train one at SEED into <work_dir>/sup
#
# SEED is the supervised leg's (the fine-tune's own seed is the recipe's, 2).
# A supervised leg trained here also leaves its checkpoint_best.pt,
# config.json and metrics.json in <out_dir>/sup_run (about 40 MB), to start
# a later fine-tune from.
# The dataset is written to build/toyds_big unless DATASET_DIR names one
# that exists. Give the command a time limit of about 3,600 s with the
# supervised leg (1,640-1,835 s of it on one NVIDIA H100 80GB HBM3 at a
# 700 W power limit, PERF.md), and about 1,500 s without it.
set -e
SEED=${SEED:-1}
OUT=${1:-chiprun_out/rlft_s$SEED}
WORK=${2:-build/runs/rlft_s$SEED}
SUP_RUN=${3:-}
DATASET_DIR=${DATASET_DIR:-build/toyds_big}
export SEED DATASET_DIR
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
if [ ! -f "$DATASET_DIR/train.txt" ]; then
  python -m jolineedle_tpu_torch.scripts.make_toyds_big "$DATASET_DIR"
fi
if [ -z "$SUP_RUN" ]; then
  python -m jolineedle_tpu_torch.scripts.time_recipe --log "$OUT/sup_log.txt" \
    -- sh jolineedle_tpu_torch/scripts/run_sup_flagship.sh "$WORK/sup" yolox-s \
    | tail -n 1 > "$OUT/sup_time_recipe.json"
  SUP_RUN="$WORK/sup/r3_sup_yolox-s"
  cp "$SUP_RUN/best_model.txt" "$OUT/sup_best_model.txt"
  mkdir -p "$OUT/sup_run"
  cp "$SUP_RUN/checkpoint_best.pt" "$SUP_RUN/config.json" "$SUP_RUN/metrics.json" \
    "$OUT/sup_run/"
fi
python -m jolineedle_tpu_torch.scripts.time_recipe --test-every 1000 --log "$OUT/log.txt" \
  -- sh jolineedle_tpu_torch/scripts/run_rl_finetune_stop.sh "$WORK/rlft" "$SUP_RUN" yolox-s \
  | tail -n 1 > "$OUT/time_recipe.json"
RUN="$WORK/rlft/r3_rlft_yolox-s"
cp "$RUN/metrics.json" "$RUN/best_model.txt" "$RUN/config.json" "$OUT/"
python -m jolineedle_tpu_torch.scripts.dump_metric_curves "$RUN" map yolo_map stop \
  prop_patches_found episode_length > "$OUT/curves.md"
python -m jolineedle_tpu_torch.scripts.eval_checkpoint "$RUN" --ckpt best \
  | tee "$OUT/eval_checkpoint.txt" | tail -n 1
python - "$OUT" "$SUP_RUN" <<'PY'
import json, sys
out, sup_run = sys.argv[1:]
final = json.load(open(f"{out}/metrics.json"))
line = [l for l in open(f"{out}/eval_checkpoint.txt") if l.startswith("FULL-TEST: ")][-1]
check = json.loads(line[len("FULL-TEST: "):])
keys = ("map", "yolo_map", "stop_used", "stop_misused", "prop_patches_found",
        "episode_length")
diff = {k: abs(final[k] - check[k]) for k in keys}
print("eval_checkpoint against the final validation:", json.dumps(diff))
# The JAX runs' range (0.621-0.623 mAP, yolo_map 0.888-0.891, stop_used
# 0.500-0.513, misused 0.033-0.04; docs/experiment_log.md:564-603, :972-990)
# widened by the 0.08 that a run wobbles (:421-460).
bands = {"map": (0.54, 0.70), "yolo_map": (0.81, 0.97), "stop_used": (0.42, 0.59),
         "stop_misused": (0.0, 0.12), "episode_length": (0.0, 20.0 - 1e-9)}
try:
    warm = json.load(open(f"{sup_run}/metrics.json"))["map"]
    bands["map_above_warm_start"] = (warm + 1e-9, 1.0)
except FileNotFoundError:
    warm = None
value = dict(final, map_above_warm_start=final["map"])
verdict = {k: {"value": value[k], "band": band, "in": band[0] <= value[k] <= band[1]}
           for k, band in bands.items()}
json.dump({"warm_start_map": warm, "bands": verdict}, open(f"{out}/bands.json", "w"), indent=1)
print("bands:", json.dumps({k: v["in"] for k, v in verdict.items()}))
sys.exit(0 if max(diff.values()) <= 1e-6 else 1)
PY
