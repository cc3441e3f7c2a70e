"""Task-ceiling measurement with the port: oracle-driven single-start eval.

The counterpart of ``scripts/eval_oracle_ceiling.py``, with the same
arguments:

    python -m jolineedle_tpu_torch.scripts.eval_oracle_ceiling <run_dir>
        [--ckpt best|last] [--dataset-dir DIR]

It replays the oracle's actions (the greedy keypoint teacher the supervised
trainer imitates, ``SupervisedTrainer.optimal_next_action``) through the
supervised eval pipeline: the same episode length, the same start (the env's
own seeded start of each test image), the same batched detection with the
run's detector (``Trainer._batched_patch_detections``: the fused conv
kernels on the card) and the same per-patch mAP with missed patches as
false negatives. The result is the best single-start trajectory mAP and
patches-found the dataset allows at that episode budget: the ceiling to
quote a policy's single-start numbers against. It prints
``ORACLE-CEILING: {json}``.

The run is the port's (``checkpoint*.pt``) or the JAX package's
(``checkpoint*.msgpack``), loaded with ``checkpoint.load_params_only``. It
writes nothing into ``run_dir``: the trainer's work dir is a temporary
directory, deleted afterwards. It runs on the GPU unless the caller passes
``device="cpu"`` to :func:`main`.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np

from .. import checkpoint as ckpt
from .. import resolve_device
from ..env.actions import get_actions_info
from ..env.oracle import OracleEnv
from ..train.supervised import SupervisedTrainer
from .eval_checkpoint import load_run


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("run_dir", help="run directory with config.json")
    parser.add_argument("--ckpt", choices=["best", "last"], default="best")
    parser.add_argument("--dataset-dir", default=None)
    return parser.parse_args(argv)


def oracle_episodes(trainer, test_ds):
    """Per test image, its oracle env (at the episode's end) and the
    replay of the oracle's actions (``SupervisedTrainer._replay_episode``).

    Each episode is built as ``eval_envs`` builds its first start (the
    image and the env from a generator seeded with the image's index, the
    env's own random start), but every action is the oracle's."""
    cfg = trainer.config
    T = cfg.test_max_seq_len
    n_actions = get_actions_info(cfg)[0].nclasses
    episodes = []
    for image_id in range(len(test_ds)):
        item = test_ds.__getitem__(image_id, np.random.default_rng(image_id))
        boxes = np.asarray(item["bboxes"], np.float64).reshape(-1, 4)
        env = OracleEnv(item["image"].shape[:2], cfg.patch_size, boxes,
                        np.random.default_rng(image_id))
        env.reset(None)
        start = env.position
        actions = []
        for _ in range(T - 1):
            action = SupervisedTrainer.optimal_next_action(env)
            actions.append(action.value)
            env.step(action)
        replayed = {
            "actions": np.array(actions, np.int32)[None],
            "logits": np.zeros((1, T - 1, n_actions), np.float32),
            "logit_masks": np.ones((1, T - 1), np.float32),
        }
        env.reset(start)
        episodes.append((env, trainer._replay_episode(item, env, replayed, T)))
    return episodes


def main(argv=None, device=None) -> dict:
    """Measure; returns the printed numbers."""
    args = get_args(argv)
    run_dir = Path(args.run_dir)
    device = resolve_device(device)
    train_config, dataset_dir, path, train_ds, test_ds, model = load_run(
        run_dir, args.ckpt, args.dataset_dir, device)
    with tempfile.TemporaryDirectory(prefix="eval_oracle_ceiling_") as work_dir:
        train_config.work_dir = work_dir
        train_config.env_name = run_dir.name + "_oracle"
        trainer = SupervisedTrainer(train_config, model, None, train_ds, test_ds, device)
        print("loading", path)
        ckpt.load_params_only(path, model)
        episodes = oracle_episodes(trainer, test_ds)
        dets = trainer._batched_patch_detections([rep["det_request"] for _, rep in episodes])
        maps, props, stopped, ep_len = [], [], [], []
        for (env, rep), det in zip(episodes, dets):
            sample, metrics, bboxes = trainer._finish_episode(rep, det)
            maps.append(trainer._per_patch_map(env, [sample], [bboxes])["map"])
            props.append(metrics["prop_patches_found"])
            stopped.append(metrics["stopped_inside_bbox"])
            ep_len.append(metrics["episode_length"])
    out = {
        "n_images": len(episodes),
        "ep_len": float(np.mean(ep_len)),
        "map": float(np.mean(maps)),
        "prop_patches_found": float(np.mean(props)),
        "stopped_inside_bbox": float(np.mean(stopped)),
        "dataset_dir": str(dataset_dir),
        "ckpt": args.ckpt,
    }
    print("ORACLE-CEILING:", json.dumps(out))
    return out


if __name__ == "__main__":
    main()
