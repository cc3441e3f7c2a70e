#!/bin/sh
# One seed of the REINFORCE STOP fine-tune on the card, from the port's own
# supervised flagship, timed and checked: the 1.5k toy set
# (make_toyds_big), then run_sup_flagship.sh <work>/sup $DETECTOR under
# time_recipe.py (or the supervised run directory the caller names), then
# run_rl_finetune_stop.sh <work>/rlft <sup run> $DETECTOR under time_recipe.py,
# then eval_checkpoint.py --ckpt best on the fine-tune, which must agree
# with its final validation within 1e-6, and eval_checkpoint.py --ckpt last
# on the weights the fine-tune ended its training with (time_recipe.py
# --keep-last copies them into <work_dir>/rlft_last before the final
# validation writes the best's over them). The runs stay where they were
# trained; the small files (logs, metrics, best_model.txt, config.json, the
# sampled tests' curves, the cross-check, the quality bands of the best and
# the last checkpoint in bands.json, each leg's pace and clocks in
# pace.json) go to the output directory.
#
# Usage: SEED=1 [DETECTOR=yolox-s] sh jolineedle_tpu_torch/scripts/run_rlft_seed.sh \
#          [out_dir] [work_dir] [sup_run_dir]
#
#   DETECTOR     yolox-s (the default: a yolox-s detector and a separate
#                yolox-nano embedder) or yolox-nano (the recipes' own
#                default: the shared yolox-nano pairing); it picks the
#                quality bands too
#   out_dir      default chiprun_out/rlft_s$SEED
#   work_dir     default build/runs/rlft_s$SEED (the fine-tune is
#                <work_dir>/rlft/r3_rlft_$DETECTOR)
#   sup_run_dir  a supervised flagship run of the same pairing to start
#                from (its checkpoint_best.pt, and metrics.json for the warm
#                start's mAP); default: train one at SEED into <work_dir>/sup
#
# SEED is the supervised leg's; RLFT_SEED the fine-tune's (default 2, the
# recipe's own --seed: a later --seed in EXTRA_FLAGS takes its place).
# A supervised leg trained here also leaves its checkpoint_best.pt,
# config.json and metrics.json in <out_dir>/sup_run (about 40 MB), to start
# a later fine-tune from.
# The dataset is written to build/toyds_big unless DATASET_DIR names one
# that exists. Give the command a time limit of about 3,600 s with the
# supervised leg (1,640-1,835 s of it on one NVIDIA H100 80GB HBM3 at a
# 700 W power limit, PERF.md), and about 1,500 s without it.
set -e
SEED=${SEED:-1}
RLFT_SEED=${RLFT_SEED:-2}
DETECTOR=${DETECTOR:-yolox-s}
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
    -- sh jolineedle_tpu_torch/scripts/run_sup_flagship.sh "$WORK/sup" "$DETECTOR" \
    | tail -n 1 > "$OUT/sup_time_recipe.json"
  SUP_RUN="$WORK/sup/r3_sup_$DETECTOR"
  cp "$SUP_RUN/best_model.txt" "$OUT/sup_best_model.txt"
  mkdir -p "$OUT/sup_run"
  cp "$SUP_RUN/checkpoint_best.pt" "$SUP_RUN/config.json" "$SUP_RUN/metrics.json" \
    "$OUT/sup_run/"
fi
RUN="$WORK/rlft/r3_rlft_$DETECTOR"
EXTRA_FLAGS="${EXTRA_FLAGS:-} --seed $RLFT_SEED" \
  python -m jolineedle_tpu_torch.scripts.time_recipe --test-every 1000 --log "$OUT/log.txt" \
  --keep-last "$RUN" "$WORK/rlft_last" \
  -- sh jolineedle_tpu_torch/scripts/run_rl_finetune_stop.sh "$WORK/rlft" "$SUP_RUN" "$DETECTOR" \
  | tail -n 1 > "$OUT/time_recipe.json"
cp "$RUN/metrics.json" "$RUN/best_model.txt" "$RUN/config.json" "$OUT/"
python -m jolineedle_tpu_torch.scripts.dump_metric_curves "$RUN" map yolo_map stop \
  prop_patches_found episode_length > "$OUT/curves.md"
python -m jolineedle_tpu_torch.scripts.eval_checkpoint "$RUN" --ckpt best \
  | tee "$OUT/eval_checkpoint.txt" | tail -n 1
python -m jolineedle_tpu_torch.scripts.eval_checkpoint "$WORK/rlft_last" --ckpt last \
  | tee "$OUT/eval_checkpoint_last.txt" | tail -n 1
python - "$OUT" "$SUP_RUN" "$RLFT_SEED" "$DETECTOR" <<'PY'
import json, os, sys
out, sup_run, rlft_seed, detector = sys.argv[1:]
final = json.load(open(f"{out}/metrics.json"))
full_test = lambda name: json.loads([l for l in open(f"{out}/{name}")
                                     if l.startswith("FULL-TEST: ")][-1][len("FULL-TEST: "):])
check, last = full_test("eval_checkpoint.txt"), full_test("eval_checkpoint_last.txt")
keys = ("map", "yolo_map", "stop_used", "stop_misused", "prop_patches_found",
        "episode_length")
diff = {k: abs(final[k] - check[k]) for k in keys}
print("eval_checkpoint against the final validation:", json.dumps(diff))
# The JAX runs of the pairing widened by the 0.08 that a run wobbles
# (docs/experiment_log.md:421-460). yolox-s: 0.621-0.623 mAP, yolo_map
# 0.888-0.891, stop_used 0.500-0.513, misused 0.033-0.04 (:564-603,
# :972-990); yolox-nano: the first leg's 10k checkpoint, mAP 0.572, yolo_map
# 0.719, stop_used 0.507, misused 0.007 (:461-518).
bands = {"yolox-s": {"map": (0.54, 0.70), "yolo_map": (0.81, 0.97),
                     "stop_used": (0.42, 0.59), "stop_misused": (0.0, 0.12)},
         "yolox-nano": {"map": (0.49, 0.65), "yolo_map": (0.64, 0.80),
                        "stop_used": (0.43, 0.59), "stop_misused": (0.0, 0.09)}}[detector]
bands["episode_length"] = (0.0, 20.0 - 1e-9)
try:
    warm = json.load(open(f"{sup_run}/metrics.json"))["map"]
    bands["map_above_warm_start"] = (warm + 1e-9, 1.0)
except FileNotFoundError:
    warm = None
verdict = {}
for name, row in (("best", final), ("last", last)):
    value = dict(row, map_above_warm_start=row["map"])
    verdict[name] = {k: {"value": value[k], "band": band, "in": band[0] <= value[k] <= band[1]}
                     for k, band in bands.items()}
    print(f"bands ({name} checkpoint):", json.dumps({k: v["in"] for k, v in verdict[name].items()}))
json.dump({"detector": detector, "rlft_seed": int(rlft_seed), "warm_start_map": warm,
           **verdict},
          open(f"{out}/bands.json", "w"), indent=1)
# Each leg's pace and the clocks nvidia-smi reported meanwhile (time_recipe).
legs = {"supervised": "sup_time_recipe.json", "finetune": "time_recipe.json"}
pace = {leg: {k: v for k, v in json.load(open(f"{out}/{name}")).items()
              if k in ("card", "wall_s", "s_per_iter", "test_s", "final_s", "max_sm_clock_mhz",
                       "sm_clock_mhz", "mem_clock_mhz", "max_power_draw_w")}
        for leg, name in legs.items() if os.path.exists(f"{out}/{name}")}
json.dump(pace, open(f"{out}/pace.json", "w"), indent=1)
print("pace:", json.dumps(pace))
sys.exit(0 if max(diff.values()) <= 1e-6 else 1)
PY
