"""Peak device memory and time of REINFORCE train steps by batch size.

Builds the train CLI's trainer at the flagship config (gpt-nano, yolox-nano
embedder and detector, concat embeddings, sinusoidal positions, grid
position, STOP, 448 px patches, 20 steps, bfloat16) on a toy dataset of
2688x2688 images written under ``build/train_memory/``, then for each batch
size takes two train steps (the second applies an optimizer update, with
gradient accumulation 2) and prints, per step, the wall time, the phase
times (CUDA events: rollout, loss forward+backward, detection, optimizer)
and ``torch.cuda.max_memory_allocated``. A batch size that does not fit is
reported as out of memory, with the peak reached. Needs an NVIDIA GPU:

    python -m jolineedle_tpu_torch.scripts.train_memory --batch-sizes 16 64 128
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

from .. import config
from ..data.toy import generate_toy_dataset
from ..env.actions import get_actions_info
from ..main import build_both_datasets
from ..models.gpt import GPT
from ..train.reinforce import ReinforceTrainer

ROOT = Path(__file__).resolve().parents[2]
FLAGS = [
    "--training-mode", "reinforce", "--model-type", "gpt-nano",
    "--image-processor", "yolox-nano", "--gpt-backbone", "yolox-nano", "--concat-embeddings",
    "--decoder-pos-encoding", "--use-positional-embedding", "--enable-stop",
    "--max-seq-len", "20", "--patch-size", "448", "--minimum-image-size", "0",
    "--dropout", "0.0", "--max-det-patches", "4", "--max-boxes", "4", "--devices", "0",
    "--compute-dtype", "bfloat16", "--gradient-accumulation", "2",
]


def measure(batch_size: int, data_dir: Path, work_dir: Path, seed: int) -> dict:
    train_config, model_config = config.args_to_config(config.get_args(
        FLAGS + ["--dataset-dir", str(data_dir), "--work-dir", str(work_dir),
                 "--batch-size", str(batch_size), "--seed", str(seed)]))
    train_set, test_set = build_both_datasets(train_config, model_config, data_dir)
    torch.manual_seed(seed)
    model = GPT.from_config(model_config, get_actions_info(train_config))
    trainer = ReinforceTrainer(train_config, model, None, train_set, test_set)
    batch = trainer._build_env_batch([i % len(train_set) for i in range(batch_size)], seed)
    steps = []
    try:
        for _ in range(2):
            trainer.phase_events = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            trainer.train_step(batch)
            torch.cuda.synchronize()
            marks = trainer.phase_events
            steps.append({
                "wall_ms": (time.perf_counter() - start) * 1e3,
                "phases_ms": {name: a.elapsed_time(b)
                              for (_, a), (name, b) in zip(marks, marks[1:])},
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            })
        return {"batch_size": batch_size, "steps": steps}
    except torch.cuda.OutOfMemoryError as exc:
        return {"batch_size": batch_size, "out_of_memory": str(exc).splitlines()[0],
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "steps": steps}
    finally:
        del trainer, model, batch
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch-sizes", type=int, nargs="+", default=[16, 64, 128])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_memory: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    root = ROOT / "build" / "train_memory"
    shutil.rmtree(root, ignore_errors=True)
    generate_toy_dataset(root / "toy", n_train=8, n_test=2, image_size=(2688, 2688),
                         seed=args.seed, box_size=(48, 200))
    for batch_size in args.batch_sizes:
        result = measure(batch_size, root / "toy", root / "out", args.seed)
        result["card"] = card
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
