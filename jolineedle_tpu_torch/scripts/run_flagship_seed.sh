#!/bin/sh
# One seed of the supervised flagship recipe on the card, timed and checked:
# the 1.5k toy set (make_toyds_big), then run_sup_flagship.sh <run>
# $DETECTOR under time_recipe.py (pace, tests, wall time, memory), then
# eval_checkpoint.py --ckpt best on the run, which must agree with the
# trainer's final validation. The run directory stays where it was trained;
# the small files (log, metrics, best_model.txt, config.json, the eval
# curves, the cross-check and the final validation against the pairing's
# quality bands in bands.json) go to the output directory.
#
# Usage: SEED=1 [DETECTOR=yolox-s] [INIT_FROM=<run dir> [STREAM_SEED=K | JAX_KEYS=N]
#          [TPU_PRECISION=1]] sh jolineedle_tpu_torch/scripts/run_flagship_seed.sh \
#          [out_dir] [work_dir]
#
#   DETECTOR  yolox-s (the default: a yolox-s detector and a separate
#             yolox-nano embedder) or yolox-nano (the recipe's own default:
#             the shared yolox-nano pairing)
#   INIT_FROM a run directory whose weights the run starts from: the
#             recipe's flags plus --init-from, run to their end by
#             sup_probe.py --tests 0 (run_sup_flagship.sh itself takes no
#             extra flag), e.g. the JAX package's initial state of the seed
#             (root main.py with the recipe's flags, --max-iters 1); the
#             weights and train state the run ends its training with are
#             kept in <work_dir>/last
#   STREAM_SEED with INIT_FROM only: the seed of the train step's device
#             draws (dropout, photometric augmentation; stream_seed.py),
#             SEED still seeding the host batches, tests and evals
#   JAX_KEYS  with INIT_FROM only, instead of STREAM_SEED: the key route
#             (stream_seed.py --jax-keys N), the JAX package's own draws
#             from the step keys of its loop at --steps-per-dispatch N
#             from PRNGKey(SEED)
#   TPU_PRECISION=1 with INIT_FROM only: the train step's float32 Dense
#             products at a TPU's default precision
#             (stream_seed.py --tpu-default-precision)
#   out_dir   default chiprun_out/sup_s$SEED
#   work_dir  default build/runs/sup_s$SEED (the run is
#             <work_dir>/r3_sup_$DETECTOR)
#
# The dataset is written to build/toyds_big unless DATASET_DIR names one
# that exists. The yolox-s recipe takes 1,640-1,981 s of wall time on one
# NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md), so give the
# command a time limit of about 3,000 s.
set -e
SEED=${SEED:-1}
DETECTOR=${DETECTOR:-yolox-s}
OUT=${1:-chiprun_out/sup_s$SEED}
WORK=${2:-build/runs/sup_s$SEED}
DATASET_DIR=${DATASET_DIR:-build/toyds_big}
export SEED DATASET_DIR
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
if [ ! -f "$DATASET_DIR/train.txt" ]; then
  python -m jolineedle_tpu_torch.scripts.make_toyds_big "$DATASET_DIR"
fi
if [ -n "$STREAM_SEED$JAX_KEYS$TPU_PRECISION" ] && [ -z "$INIT_FROM" ]; then
  echo "STREAM_SEED, JAX_KEYS and TPU_PRECISION are taken only with INIT_FROM" >&2
  exit 2
fi
if [ -n "$INIT_FROM" ]; then
  python -m jolineedle_tpu_torch.scripts.sup_probe "$OUT" "$WORK" --detector "$DETECTOR" \
    --seed "$SEED" --tests 0 ${STREAM_SEED:+--stream-seed "$STREAM_SEED"} \
    ${JAX_KEYS:+--jax-keys "$JAX_KEYS"} ${TPU_PRECISION:+--tpu-default-precision} \
    -- --init-from "$INIT_FROM"
else
  python -m jolineedle_tpu_torch.scripts.time_recipe --log "$OUT/log.txt" \
    -- sh jolineedle_tpu_torch/scripts/run_sup_flagship.sh "$WORK" "$DETECTOR" \
    | tail -n 1 > "$OUT/time_recipe.json"
fi
RUN="$WORK/r3_sup_$DETECTOR"
cp "$RUN/metrics.json" "$RUN/best_model.txt" "$RUN/config.json" "$OUT/"
python -m jolineedle_tpu_torch.scripts.dump_metric_curves "$RUN" map prop_patches_found \
  stop > "$OUT/curves.md"
python -m jolineedle_tpu_torch.scripts.eval_checkpoint "$RUN" --ckpt best \
  | tee "$OUT/eval_checkpoint.txt" | tail -n 1
python - "$OUT" "$DETECTOR" <<'PY'
import json, sys
out, detector = sys.argv[1:]
final = json.load(open(f"{out}/metrics.json"))
line = [l for l in open(f"{out}/eval_checkpoint.txt") if l.startswith("FULL-TEST: ")][-1]
check = json.loads(line[len("FULL-TEST: "):])
keys = ("map", "map_multistart_2", "supervised_map", "prop_patches_found")
diff = {k: abs(final[k] - check[k]) for k in keys}
print("eval_checkpoint against the final validation:", json.dumps(diff))
# The JAX runs of the pairing widened by the 0.08 that a run wobbles
# (docs/experiment_log.md:421-460). yolox-s: the first run and protocol
# seeds 1-3, 0.362-0.436 single-start, 0.541-0.603 multistart-2, 0.806-0.889
# detector (:519-547, :1111-1130); yolox-nano: seed 1 of the current
# recipe, 0.450 / 0.589 / 0.779 (:421-460).
bands = {"yolox-s": {"map": (0.28, 0.52), "map_multistart_2": (0.46, 0.68),
                     "supervised_map": (0.73, 0.97)},
         "yolox-nano": {"map": (0.35, 0.53), "map_multistart_2": (0.50, 0.67),
                        "supervised_map": (0.69, 0.86)}}[detector]
verdict = {k: {"value": final[k], "band": band, "in": band[0] <= final[k] <= band[1]}
           for k, band in bands.items()}
print("bands:", json.dumps({k: v["in"] for k, v in verdict.items()}))
json.dump({"detector": detector, "best": verdict}, open(f"{out}/bands.json", "w"), indent=1)
sys.exit(0 if max(diff.values()) <= 1e-6 else 1)
PY
