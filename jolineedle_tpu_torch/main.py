"""Training CLI of the port: ``python -m jolineedle_tpu_torch.main``.

The counterpart of ``main.py`` with the same flags (``config.py`` is the same
parser), the same ``config.json`` and the same work-dir layout: datasets from
``--dataset-dir``, the model from the config, a logger, the trainer of
``--training-mode``, then ``--init-from`` / ``--resume-training`` and
``trainer.run()``. It runs on one CUDA device, or on ``device="cpu"`` when a
caller asks (the tests do).

Both training modes are ported: ``supervised`` (the default,
``train/supervised.py``) and ``reinforce`` (``train/reinforce.py``).
``--init-from`` and ``--detection-checkpoint`` read the port's ``.pt`` and
the JAX package's ``.msgpack`` files; ``--no-recurrent-embedding`` rolls
out with the full-prefix forward (``train/rollout.py``).

Not ported yet, and refused with "not yet ported": ``--measure-flops``,
``--device-data-cache on`` (``auto`` streams the images of each batch, which
gives the same pixels), ``--steps-per-dispatch`` above 1 (a TPU dispatch
workaround) and more than one device in ``--devices``.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

from . import resolve_device
from .config import args_to_config, get_args, save_config
from .data.dataset import build_datasets
from .env.actions import get_actions_info
from .models.gpt import GPT
from .observe.logger import Logger


def build_both_datasets(train_config, model_config, dataset_dir):
    return build_datasets(
        dataset_dir,
        min_keypoints=train_config.min_keypoints,
        max_keypoints=train_config.max_keypoints,
        patch_size=model_config.patch_size,
        max_ep_len=model_config.block_size,
        rotations=train_config.rotations,
        translations=train_config.translations,
        test_size=train_config.test_size,
        test_pattern=train_config.test_pattern,
        seed=train_config.seed,
        train_size=train_config.train_size,
        binomial_keypoints=train_config.binomial_keypoints,
        minimum_image_size=train_config.minimum_image_size,
        filter_classes=train_config.filter_classes,
    )


def _refuse_unported(train_config) -> None:
    refused = {
        "--measure-flops": bool(train_config.measure_flops),
        "--device-data-cache on": getattr(train_config, "device_data_cache", "auto") == "on",
        "--steps-per-dispatch > 1": int(getattr(train_config, "steps_per_dispatch", 1)) > 1,
        "more than one device in --devices": len(train_config.gpu_ids) > 1,
    }
    for flag, asked in refused.items():
        if asked:
            raise NotImplementedError(f"{flag} is not yet ported to jolineedle_tpu_torch")
    if train_config.training_mode not in ("supervised", "reinforce"):
        raise ValueError(f"Unknown training mode: {train_config.training_mode}")


def launch_training(train_config, model_config, dataset_dir, device=None):
    """Build the datasets, model, logger and trainer, restore what the flags
    ask for, and train. Returns the trainer."""
    _refuse_unported(train_config)
    device = resolve_device(device)
    train_dataset, test_dataset = build_both_datasets(train_config, model_config, dataset_dir)
    torch.manual_seed(train_config.seed)
    model = GPT.from_config(model_config, get_actions_info(train_config), device=device)
    logger = Logger(train_config, model_config)

    if train_config.training_mode == "supervised":
        from .train.supervised import SupervisedTrainer as TrainerClass
    else:
        from .train.reinforce import ReinforceTrainer as TrainerClass

    trainer = TrainerClass(train_config, model, logger, train_dataset, test_dataset, device)

    if train_config.init_from is not None:
        if train_config.resume_training is not None:
            raise ValueError(
                "--init-from (params-only warm start) and --resume-training"
                " (full-state restore) are mutually exclusive"
            )
        trainer.load_params_checkpoint(train_config.init_from)

    if train_config.resume_training is not None:
        print("Resuming from", train_config.resume_training)
        trainer.load_checkpoint(train_config.resume_training)
        visdom_pkl = os.path.join(train_config.resume_training, "visdom.pkl")
        if os.path.isfile(visdom_pkl):
            from .observe.visualizer import VisdomPlotter

            logger.visdom = VisdomPlotter.load(visdom_pkl, env_name=train_config.env_name)

    if train_config.detection_checkpoint is not None:
        print("Load detection checkpoint from", train_config.detection_checkpoint)
        trainer.load_detection_checkpoint(train_config.detection_checkpoint)

    trainer.run()
    return trainer


def main(args, device=None):
    """The CLI body on parsed ``args``; runs on ``device`` (default: the
    GPU). Returns the trainer."""
    train_config, model_config = args_to_config(args)
    _refuse_unported(train_config)
    device = resolve_device(device)
    random.seed(train_config.seed)
    np.random.seed(train_config.seed)
    if args.group != "":
        train_config.env_name = f"{args.group}_{train_config.env_name}"
    print(
        f"training env_name = {train_config.env_name}",
        f"\nUsing positional encoding = {model_config.use_pos_emb}",
        f"\nConcatenating embeddings = {model_config.concat_emb}",
    )
    save_config(model_config, train_config)
    return launch_training(train_config, model_config, args.dataset_dir, device)


if __name__ == "__main__":
    main(get_args())
