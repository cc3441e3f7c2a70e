#!/bin/sh
# Several samples of the REINFORCE STOP fine-tune from one supervised run,
# side by side on one card: run_rlft_seed.sh once for each fine-tune seed
# in RLFT_SEEDS, all started together (a fine-tune's graphed step leaves the
# card idle 43 % of the time, PERF.md), each into its own output and work
# directory. The toy set is written first, once. Exits non-zero if any
# sample failed; each sample's output is in <out_dir>/run.txt.
#
# Usage: SEED=1 RLFT_SEEDS="2 3 4" [DETECTOR=yolox-s] \
#          sh jolineedle_tpu_torch/scripts/run_rlft_samples.sh <sup_run_dir> [out_root] [work_root]
#
#   DETECTOR     the pairing, as run_rlft_seed.sh takes it (default yolox-s)
#   sup_run_dir  the supervised flagship run of that pairing to start from (its
#                checkpoint_best.pt, config.json and metrics.json, e.g. the
#                sup_run directory a run_rlft_seed.sh call brought back)
#   out_root     default chiprun_out: sample f<seed> goes to
#                <out_root>/rlft_s$SEED_f<seed>
#   work_root    default build/runs
#
# The samples share the card, so each one's pace in pace.json is the shared
# pace, not a fine-tune's own.
set -e
SUP_RUN=${1:?supervised run dir required}
SEED=${SEED:-1}
RLFT_SEEDS=${RLFT_SEEDS:-2 3 4}
DETECTOR=${DETECTOR:-yolox-s}
OUT_ROOT=${2:-chiprun_out}
WORK_ROOT=${3:-build/runs}
DATASET_DIR=${DATASET_DIR:-build/toyds_big}
export SEED DATASET_DIR DETECTOR
if [ ! -f "$DATASET_DIR/train.txt" ]; then
  python -m jolineedle_tpu_torch.scripts.make_toyds_big "$DATASET_DIR"
fi
pids=""
for f in $RLFT_SEEDS; do
  out="$OUT_ROOT/rlft_s${SEED}_f$f"
  mkdir -p "$out"
  RLFT_SEED=$f sh jolineedle_tpu_torch/scripts/run_rlft_seed.sh "$out" \
    "$WORK_ROOT/rlft_s${SEED}_f$f" "$SUP_RUN" > "$out/run.txt" 2>&1 &
  pids="$pids $!"
done
rc=0
for pid in $pids; do
  wait "$pid" || rc=1
done
for f in $RLFT_SEEDS; do
  echo "== fine-tune seed $f"
  tail -n 4 "$OUT_ROOT/rlft_s${SEED}_f$f/run.txt"
done
exit $rc
