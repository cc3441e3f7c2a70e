"""Training CLI of the port: ``python -m jolineedle_tpu_torch.main``.

The counterpart of ``main.py`` with the same flags (``config.py`` is the same
parser), the same ``config.json`` and the same work-dir layout: datasets from
``--dataset-dir``, the model from the config, a logger, the trainer of
``--training-mode``, then ``--init-from`` / ``--resume-training`` and
``trainer.run()``. It runs on the CUDA devices of ``--devices``, or on
``device="cpu"`` when a caller asks (the tests do).

``--devices`` with more than one index trains data-parallel, one process per
device (``parallel/mesh.py``): rank r on ``cuda:<r-th index>``, joined by
NCCL (gloo on the CPU), a global batch of ``--batch-size × W`` rows, what the
JAX package computes on a mesh over those devices. The CLI process writes
``config.json``, spawns the ranks and returns their ``Trainer.summary()``s;
rank 0 alone prints, tests and writes the run directory. Under torchrun (its
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``;
several hosts) each process is one rank, the ``l``-th local rank on the
``l``-th index of ``--devices``, and ``main`` returns its trainer. A repeated
index is refused. ``chip_smoke.py`` runs ``--devices`` over
every visible card (``0 1 2 3`` on four); torchrun across hosts has not
yet run on any card.

Both training modes are ported: ``supervised`` (the default,
``train/supervised.py``) and ``reinforce`` (``train/reinforce.py``).
``--init-from`` and ``--detection-checkpoint`` read the port's ``.pt`` and
the JAX package's ``.msgpack`` files; ``--no-recurrent-embedding`` rolls
out with the full-prefix forward (``train/rollout.py``).

``--device-data-cache`` means what it means there (``data/device_pool.py``):
``auto`` (the default) keeps the training set on the device when its padded
pixels fit the budget, else streams each batch's pixels; ``on`` always keeps
it there, ``off`` always streams. Each trainer prints the route it took and
keeps the pool as ``trainer.pool`` (None when streaming).

``--measure-flops`` builds the trainer as for training (datasets, model,
checkpoints to load), prints the FLOP and parameter report of
``utils/flops.py`` (counted on a ``meta`` copy of the model: no kernel runs)
and returns without training.

``--measure-flops`` runs once, on the first device, before any rank is
spawned.

``--steps-per-dispatch N`` trains in chunks of N iterations, the JAX
package's one dispatch of N scanned steps. On the card a chunk is a loop
over its steps (``Trainer.train_loop``), so the run equals the N = 1 run;
the host looks only at a chunk's end: the printed loss, the REINFORCE return
window and the tests follow the chunks, and N must divide ``--test-every``
(and, with ``--reward-norm``, ``--gradient-accumulation``), as there.
"""

from __future__ import annotations

import json
import os
import random
import sys

import numpy as np
import torch

from . import resolve_device
from .config import args_to_config, get_args, save_config
from .data.dataset import build_datasets
from .env.actions import get_actions_info
from .models.gpt import GPT
from .observe.logger import Logger
from .parallel import mesh


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


def _refuse_bad_flags(train_config) -> None:
    if len(set(train_config.gpu_ids)) != len(train_config.gpu_ids):
        raise ValueError(f"--devices {list(train_config.gpu_ids)} repeats an index:"
                         " one rank runs on each device")
    if train_config.training_mode not in ("supervised", "reinforce"):
        raise ValueError(f"Unknown training mode: {train_config.training_mode}")


def build_trainer(world, train_config, model_config, dataset_dir, log=True):
    """The trainer of the flags on the rank ``world``: the datasets, the
    model from the seed, a logger on rank 0 (when ``log``), the trainer of
    ``--training-mode``, what ``--init-from``, ``--resume-training`` and
    ``--detection-checkpoint`` ask for, then rank 0's weights and statistics
    on every rank."""
    train_dataset, test_dataset = build_both_datasets(train_config, model_config, dataset_dir)
    torch.manual_seed(train_config.seed)
    model = GPT.from_config(model_config, get_actions_info(train_config), device=world.device)
    logger = Logger(train_config, model_config) if log and world.is_main else None

    if train_config.training_mode == "supervised":
        from .train.supervised import SupervisedTrainer as TrainerClass
    else:
        from .train.reinforce import ReinforceTrainer as TrainerClass

    trainer = TrainerClass(train_config, model, logger, train_dataset, test_dataset,
                           world.device, world=world)

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
        if logger is not None and os.path.isfile(visdom_pkl):
            from .observe.visualizer import VisdomPlotter

            logger.visdom = VisdomPlotter.load(visdom_pkl, env_name=train_config.env_name)

    if train_config.detection_checkpoint is not None:
        print("Load detection checkpoint from", train_config.detection_checkpoint)
        trainer.load_detection_checkpoint(train_config.detection_checkpoint)

    mesh.broadcast_tensors(model.state_dict().values(), world)
    return trainer


def launch_training(train_config, model_config, dataset_dir, device=None, world=None):
    """Build the trainer (:func:`build_trainer`) and train, or, with
    ``--measure-flops``, print the FLOP report instead. Runs as the rank
    ``world`` (default: alone on ``device``). Returns the trainer."""
    _refuse_bad_flags(train_config)
    world = mesh.single(resolve_device(device)) if world is None else world
    trainer = build_trainer(world, train_config, model_config, dataset_dir)

    if train_config.measure_flops:
        from .utils.flops import measure_flops

        if world.is_main:
            trainer.flops_report = measure_flops(trainer, model_config, train_config)
        return trainer

    trainer.run()
    return trainer


def train_rank(world, train_config, model_config, dataset_dir) -> dict:
    """One rank of a data-parallel run (what :func:`main` spawns): train,
    and report the trainer's summary and the top-level packages this
    process imported."""
    mesh.quiet_unless_main(world)
    trainer = launch_training(train_config, model_config, dataset_dir, world=world)
    summary = trainer.summary()
    summary["packages"] = sorted({name.split(".")[0] for name in sys.modules})
    return summary


def main(args, device=None):
    """The CLI body on parsed ``args``; runs on the GPUs of ``--devices``
    unless ``device`` is the CPU. Returns the trainer; with more than one
    device, the ranks' summaries (:func:`train_rank`)."""
    train_config, model_config = args_to_config(args)
    _refuse_bad_flags(train_config)
    random.seed(train_config.seed)
    np.random.seed(train_config.seed)
    if args.group != "":
        train_config.env_name = f"{args.group}_{train_config.env_name}"
    world = mesh.join_from_env(train_config.gpu_ids, device)
    devices = [world.device] if world is not None else mesh.rank_devices(train_config.gpu_ids,
                                                                         device)
    if world is None or world.is_main:
        print(
            f"training env_name = {train_config.env_name}",
            f"\nUsing positional encoding = {model_config.use_pos_emb}",
            f"\nConcatenating embeddings = {model_config.concat_emb}",
        )
        save_config(model_config, train_config)
    if world is not None:
        mesh.quiet_unless_main(world)
        try:
            return launch_training(train_config, model_config, args.dataset_dir, world=world)
        finally:
            mesh.close_world(world)
    if len(devices) == 1 or train_config.measure_flops:
        return launch_training(train_config, model_config, args.dataset_dir, devices[0])
    return mesh.launch(train_rank, (train_config, model_config, str(args.dataset_dir)), devices)


def cli(argv=None):
    """``python -m jolineedle_tpu_torch.main``: :func:`main` on the parsed
    command line, on the device that ``JOLINEEDLE_TORCH_DEVICE`` names
    (``cpu`` runs the plain PyTorch versions, as the recipes' CPU tests
    do; unset: the GPUs of ``--devices``). On the card it prints, at the
    end, this process's peak of ``torch.cuda.max_memory_allocated`` and its
    kernels' launches (the ranks of a data-parallel run count their own)."""
    result = main(get_args(argv), device=os.environ.get("JOLINEEDLE_TORCH_DEVICE") or None)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        from .ops import attention, conv

        launches = {fn.__name__: fn.launches for fn in (
            conv.dwblock_bn_silu, conv.conv3x3_bn_silu, conv.conv3x3, attention.flash_attention)}
        print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
              " (max_memory_allocated)", flush=True)
        print(f"kernel launches: {json.dumps(launches)}", flush=True)
    return result


if __name__ == "__main__":
    cli()
