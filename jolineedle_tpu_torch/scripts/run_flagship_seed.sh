#!/bin/sh
# One seed of the supervised flagship recipe on the card, timed and checked:
# the 1.5k toy set (make_toyds_big), then run_sup_flagship.sh <run> yolox-s
# under time_recipe.py (pace, tests, wall time, memory), then
# eval_checkpoint.py --ckpt best on the run, which must agree with the
# trainer's final validation. The run directory stays where it was trained;
# the small files (log, metrics, best_model.txt, config.json, the eval
# curves and the cross-check) go to the output directory.
#
# Usage: SEED=1 sh jolineedle_tpu_torch/scripts/run_flagship_seed.sh [out_dir] [work_dir]
#
#   out_dir   default chiprun_out/sup_s$SEED
#   work_dir  default build/runs/sup_s$SEED (the run is <work_dir>/r3_sup_yolox-s)
#
# The dataset is written to build/toyds_big unless DATASET_DIR names one
# that exists. The recipe takes 1,640-1,835 s of wall time on one NVIDIA
# H100 80GB HBM3 at a 700 W power limit (PERF.md), so give the command a
# time limit of about 3,000 s.
set -e
SEED=${SEED:-1}
OUT=${1:-chiprun_out/sup_s$SEED}
WORK=${2:-build/runs/sup_s$SEED}
DATASET_DIR=${DATASET_DIR:-build/toyds_big}
export SEED DATASET_DIR
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
if [ ! -f "$DATASET_DIR/train.txt" ]; then
  python -m jolineedle_tpu_torch.scripts.make_toyds_big "$DATASET_DIR"
fi
python -m jolineedle_tpu_torch.scripts.time_recipe --log "$OUT/log.txt" \
  -- sh jolineedle_tpu_torch/scripts/run_sup_flagship.sh "$WORK" yolox-s \
  | tail -n 1 > "$OUT/time_recipe.json"
RUN="$WORK/r3_sup_yolox-s"
cp "$RUN/metrics.json" "$RUN/best_model.txt" "$RUN/config.json" "$OUT/"
python -m jolineedle_tpu_torch.scripts.dump_metric_curves "$RUN" map prop_patches_found \
  stop > "$OUT/curves.md"
python -m jolineedle_tpu_torch.scripts.eval_checkpoint "$RUN" --ckpt best \
  | tee "$OUT/eval_checkpoint.txt" | tail -n 1
python - "$OUT" <<'PY'
import json, sys
out = sys.argv[1]
final = json.load(open(f"{out}/metrics.json"))
line = [l for l in open(f"{out}/eval_checkpoint.txt") if l.startswith("FULL-TEST: ")][-1]
check = json.loads(line[len("FULL-TEST: "):])
keys = ("map", "map_multistart_2", "supervised_map", "prop_patches_found")
diff = {k: abs(final[k] - check[k]) for k in keys}
print("eval_checkpoint against the final validation:", json.dumps(diff))
sys.exit(0 if max(diff.values()) <= 1e-6 else 1)
PY
