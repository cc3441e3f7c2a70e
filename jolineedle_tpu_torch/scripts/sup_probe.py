"""Probe the supervised recipe's curve with extra flags, on the card.

Runs the CLI with ``run_sup_flagship.sh``'s own flags (read from its
``exec`` line, its shell variables set as the script sets them), the
``extra`` flags appended after them (the last of a repeated flag wins), under
``time_recipe.py``, and stops it after its first ``--tests`` sampled tests
(every 2,500 iterations of the 20k cosine schedule, which stays the
recipe's); ``--tests 0`` runs it to its end, the final validation of its
best checkpoint included. Writes the stamped log and ``time_recipe``'s
JSON line (pace, memory, each test's single-start, multistart-2 and
detector mAP) into ``out_dir``:

    python -m jolineedle_tpu_torch.scripts.sup_probe out/f32_s1 runs/f32_s1 \\
        --detector yolox-nano --seed 1 --tests 3 -- --compute-dtype float32

``--stream-seed K`` runs the CLI through ``stream_seed.py``, which seeds
the train step's device draws with ``K`` and leaves everything else to
``--seed``. A run to its end (``--tests 0``) keeps the weights and train
state that it ends its training with in ``<work_dir>/last`` (``time_recipe
--keep-last``) before the final validation writes the best weights over
them.

``DATASET_DIR`` (default ``build/toyds_big``, written there by
``make_toyds_big`` when it holds no training set) is read from the
environment. Exits non-zero unless the run printed ``--tests`` tests (with
``--tests 0``: unless the run ended with exit code 0).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shlex
import sys
from pathlib import Path

from . import make_toyds_big, time_recipe

RECIPE = Path(__file__).with_name("run_sup_flagship.sh")
ENTRY = ["python", "-m", "jolineedle_tpu_torch.main"]


def recipe_argv(values: dict) -> list:
    """The flags of ``run_sup_flagship.sh``'s ``exec`` line after the entry
    point, with its shell variables set to ``values``; an unquoted
    variable splits into words, as sh splits it."""
    text = re.sub(r"\\\n", " ", RECIPE.read_text())
    (line,) = [line for line in text.splitlines() if line.strip().startswith("exec ")]
    args = shlex.split(line)[1:]
    assert args[:3] == ENTRY, args[:3]
    out = []
    for arg in args[3:]:
        value = re.sub(r"\$(\w+)", lambda m: values[m.group(1)], arg)
        out += value.split() if arg.startswith("$") else [value]
    return out


def backbone_flags(detector: str) -> str:
    """``BACKBONE_FLAGS`` as ``run_sup_flagship.sh`` sets it."""
    if detector == "yolox-nano":
        return "--image-processor yolox-nano"
    return f"--image-processor {detector} --gpt-backbone yolox-nano"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                     epilog="flags after -- are appended to the recipe's")
    parser.add_argument("out_dir", type=Path)
    parser.add_argument("work_dir", type=Path)
    parser.add_argument("--detector", default="yolox-nano")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--tests", type=int, default=3,
                        help="sampled tests before the stop (0: run to the end)")
    parser.add_argument("--stream-seed", type=int, default=None,
                        help="seed the train step's device draws apart from --seed")
    argv = list(sys.argv[1:] if argv is None else argv)
    cut = argv.index("--") if "--" in argv else len(argv)
    args, extra = parser.parse_args(argv[:cut]), argv[cut + 1:]
    dataset = Path(os.environ.get("DATASET_DIR", "build/toyds_big"))
    if not (dataset / "train.txt").is_file():
        make_toyds_big.main([str(dataset)])
    values = {"SEED": str(args.seed), "DATASET_DIR": str(dataset),
              "WORK_DIR": str(args.work_dir), "MAX_ITERS": "20000", "SPD": "1",
              "DETECTOR": args.detector, "BACKBONE_FLAGS": backbone_flags(args.detector)}
    entry = ENTRY[1:] if args.stream_seed is None else [
        "-m", "jolineedle_tpu_torch.scripts.stream_seed", "--stream-seed", str(args.stream_seed),
        "--"]
    command = [sys.executable, *entry, *recipe_argv(values), *extra]
    args.out_dir.mkdir(parents=True, exist_ok=True)
    stop = (["--stop-after-tests", str(args.tests)] if args.tests else
            ["--keep-last", str(args.work_dir / f"r3_sup_{args.detector}"),
             str(args.work_dir / "last")])
    result = time_recipe.main(["--log", str(args.out_dir / "log.txt"), *stop, "--", *command])
    (args.out_dir / "time_recipe.json").write_text(json.dumps(result) + "\n")
    if not args.tests:
        return result["rc"]
    return 0 if len(result["tests"]) >= args.tests else 1


if __name__ == "__main__":
    sys.exit(main())
