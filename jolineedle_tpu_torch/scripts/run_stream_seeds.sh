#!/bin/sh
# Several runs of the supervised flagship recipe from one initial state and
# one seed's host batches, side by side on one card, differing only in the
# train step's device draws: run_flagship_seed.sh once for each K in
# STREAM_SEEDS (INIT_FROM, SEED and STREAM_SEED=K), all started together,
# where a K of the form jN or jNt is the key route instead (JAX_KEYS=N: the
# JAX loop's step keys of --steps-per-dispatch N from PRNGKey(SEED); t adds
# TPU_PRECISION=1),
# each into its own output and work directory. The toy set is written
# first, once. Then the trained states of the runs with the highest and
# the lowest full-test single-start mAP (ties: the first in STREAM_SEEDS)
# are copied into <out_root>/trained/k<K>/: the best weights
# (checkpoint_best.pt), the weights and train state that training ended
# with (checkpoint.pt, train_state.pt, kept by time_recipe --keep-last
# before the final validation), config.json and metrics.json, about 21 MB
# a run for the shared yolox-nano pairing. Exits non-zero if any run
# failed; each run's output is in <out_root>/stream_s$SEED_k<K>/run.txt.
#
# Usage: INIT_FROM=<run dir> SEED=1 STREAM_SEEDS="2 3 4" [DETECTOR=yolox-nano] \
#        (or STREAM_SEEDS="j1 j4 j1t": the key route at spd 1 and 4, and at
#        spd 1 with the TPU-precision option) \
#          sh jolineedle_tpu_torch/scripts/run_stream_seeds.sh [out_root] [work_root]
#
#   out_root  default chiprun_out
#   work_root default build/runs
#
# The runs share the card, so each one's pace in its time_recipe.json is
# the shared pace. Three shared yolox-nano runs need a time limit of about
# 3,000 s (PERF.md).
set -e
INIT_FROM=${INIT_FROM:?INIT_FROM required}
SEED=${SEED:-1}
STREAM_SEEDS=${STREAM_SEEDS:-2 3 4}
DETECTOR=${DETECTOR:-yolox-nano}
OUT_ROOT=${1:-chiprun_out}
WORK_ROOT=${2:-build/runs}
DATASET_DIR=${DATASET_DIR:-build/toyds_big}
export SEED DATASET_DIR DETECTOR INIT_FROM
if [ ! -f "$DATASET_DIR/train.txt" ]; then
  python -m jolineedle_tpu_torch.scripts.make_toyds_big "$DATASET_DIR"
fi
pids=""
for k in $STREAM_SEEDS; do
  out="$OUT_ROOT/stream_s${SEED}_k$k"
  mkdir -p "$out"
  case "$k" in
    j*t) route="JAX_KEYS=$(echo "$k" | tr -d jt) TPU_PRECISION=1" ;;
    j*) route="JAX_KEYS=${k#j}" ;;
    *) route="STREAM_SEED=$k" ;;
  esac
  env $route sh jolineedle_tpu_torch/scripts/run_flagship_seed.sh "$out" \
    "$WORK_ROOT/stream_s${SEED}_k$k" > "$out/run.txt" 2>&1 &
  pids="$pids $!"
done
rc=0
for pid in $pids; do
  wait "$pid" || rc=1
done
for k in $STREAM_SEEDS; do
  echo "== stream seed $k"
  tail -n 3 "$OUT_ROOT/stream_s${SEED}_k$k/run.txt"
done
python - "$OUT_ROOT" "$WORK_ROOT" "$SEED" "$DETECTOR" $STREAM_SEEDS <<'PY'
import json, shutil, sys
from pathlib import Path
out_root, work_root, seed, detector, *ks = sys.argv[1:]
done = {}
for k in ks:
    metrics = Path(out_root) / f"stream_s{seed}_k{k}" / "metrics.json"
    if metrics.is_file():
        done[k] = json.loads(metrics.read_text())["map"]
print("single-start by stream seed:", json.dumps(done))
for k in dict.fromkeys((max(done, key=done.get), min(done, key=done.get)) if done else ()):
    work = Path(work_root) / f"stream_s{seed}_k{k}"
    dest = Path(out_root) / "trained" / f"k{k}"
    dest.mkdir(parents=True, exist_ok=True)
    run = work / f"r3_sup_{detector}"
    shutil.copy2(run / "checkpoint_best.pt", dest)
    shutil.copy2(run / "metrics.json", dest)
    for name in ("checkpoint.pt", "train_state.pt", "config.json"):
        shutil.copy2(work / "last" / name, dest)
    print("kept", dest, sorted(p.name for p in dest.iterdir()))
PY
exit $rc
