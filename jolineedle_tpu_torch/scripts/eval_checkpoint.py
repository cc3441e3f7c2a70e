"""Full-test validation of a saved run's checkpoint, with the port.

The counterpart of ``scripts/eval_checkpoint.py``, with the same arguments:

    python -m jolineedle_tpu_torch.scripts.eval_checkpoint <run_dir>
        [--ckpt best|last] [--dataset-dir DIR] [--merge-bboxes|--no-merge-bboxes]

It rebuilds the run's trainer from its ``config.json``, loads the named
checkpoint's weights with the params-only loader (``checkpoint.
load_params_only``: the port's ``checkpoint*.pt`` or the JAX package's
``checkpoint*.msgpack``), switches the eval ids to the whole test set and
runs one test cycle, as the trainer does after training (reference:
src/trainer.py:138-165), then prints ``FULL-TEST: {json}`` of the mean
metrics. ``--dataset-dir`` overrides the run's recorded dataset location
(required for a config.json that predates it); ``--merge-bboxes`` and
``--no-merge-bboxes`` override the run's box merging for this validation.

It writes nothing into ``run_dir``: the trainer's work dir is a temporary
directory, deleted afterwards. It runs on the GPU unless the caller passes
``device="cpu"`` to :func:`main`, or, from the command line, on the device
that ``JOLINEEDLE_TORCH_DEVICE`` names (as the train CLI does).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from pathlib import Path

import numpy as np

from .. import checkpoint as ckpt
from .. import resolve_device
from ..config import config_from_file
from ..env.actions import get_actions_info
from ..main import build_both_datasets
from ..models.gpt import GPT


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("run_dir", help="run directory with config.json")
    parser.add_argument("--ckpt", choices=["best", "last"], default="best")
    parser.add_argument("--dataset-dir", default=None)
    parser.add_argument(
        "--merge-bboxes", dest="merge_bboxes", default=None, action="store_true",
        help="override the run's --merge-bboxes for this validation",
    )
    parser.add_argument("--no-merge-bboxes", dest="merge_bboxes", action="store_false")
    return parser.parse_args(argv)


def load_run(run_dir: Path, which: str, dataset_dir, device):
    """What the validation scripts read from a saved run: its configs (the
    classes filter as a set), its dataset directory (``dataset_dir``, else
    the recorded one), the ``which`` ("best" or "last") checkpoint file,
    the datasets, and a fresh model of the config on ``device``."""
    train_config, model_config = config_from_file(run_dir / "config.json")
    if isinstance(getattr(train_config, "filter_classes", None), list):
        train_config.filter_classes = set(train_config.filter_classes)
    dataset_dir = dataset_dir or getattr(train_config, "dataset_dir", None)
    if dataset_dir is None:
        raise SystemExit(
            "--dataset-dir is required: this run's config.json predates the "
            "recorded dataset_dir field"
        )
    path = ckpt.model_file(run_dir, best=which == "best")
    if path is None:
        raise FileNotFoundError(f"{run_dir} holds no {which} checkpoint (.pt or .msgpack)")
    train_ds, test_ds = build_both_datasets(train_config, model_config, dataset_dir)
    model = GPT.from_config(model_config, get_actions_info(train_config), device=device)
    return train_config, dataset_dir, path, train_ds, test_ds, model


def main(argv=None, device=None) -> dict:
    """Validate; returns the printed metrics."""
    args = get_args(argv)
    run_dir = Path(args.run_dir)
    device = resolve_device(device)
    train_config, _, path, train_ds, test_ds, model = load_run(run_dir, args.ckpt,
                                                               args.dataset_dir, device)
    if train_config.training_mode == "reinforce":
        from ..train.reinforce import ReinforceTrainer as TrainerClass
    else:
        from ..train.supervised import SupervisedTrainer as TrainerClass
    if args.merge_bboxes is not None:
        train_config.merge_bboxes = args.merge_bboxes
    with tempfile.TemporaryDirectory(prefix="eval_checkpoint_") as work_dir:
        # The trainer saves checkpoints and metrics after a test: here, not
        # into the run being validated.
        train_config.work_dir = work_dir
        train_config.env_name = run_dir.name + "_eval"
        trainer = TrainerClass(train_config, model, None, train_ds, test_ds, device)
        print("loading", path)
        ckpt.load_params_only(path, model)
        trainer.test_env_ids = list(range(len(test_ds)))
        trainer.test()
    out = {k: float(np.mean(v)) for k, v in trainer.last_test_metrics.items()}
    print("FULL-TEST:", json.dumps(out))
    return out


if __name__ == "__main__":
    main(device=os.environ.get("JOLINEEDLE_TORCH_DEVICE") or None)
