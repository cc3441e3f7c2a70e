"""Supervised (imitation-learning) trainer: ``--training-mode supervised``.

The counterpart of ``jolineedle_tpu/train/supervised.py``:

- the trajectory labels come from the numpy oracle in the input pipeline
  (``train/batching.py``), built on the ``Prefetcher``'s threads. Under
  ``--device-data-cache`` (``data/device_pool.py``) the training set lives
  on the device, the batches carry only indices, geometry and labels, and
  the train step gathers the patches there (and replays the geometric
  augmentations); otherwise each batch's patches come up from the host as
  uint8;
- a train step (``supervised.py:103-220``): the photometric augmentation of
  the decision patches, the teacher-forced forward in train mode (dropout
  from the trainer's generator, batch-statistics BatchNorm in the embedder;
  the attention on the flash kernel, the convs as PyTorch convs, under
  autograd in a ``gpt_backbone`` embedder and forward only in the shared
  detector backbone, whose gradient stops at its FPN), the class-weighted
  action cross-entropy; then the augmentation
  of the detector's patches, the train-mode detector and its SimOTA loss;
  then the two-group AdamW with accumulation (no clip). The BatchNorm
  running statistics are updated in place by each forward in turn, so the
  detector's continue from what the decision forward left, as the JAX step
  chains its mutable ``batch_stats``. On the card and on one rank, the
  train-mode embedder (either kind) and detector run as CUDA graphs
  captured at the first step (``train/graphs.py``, ``Trainer.step_graphs``);
- the autoregressive eval runs the no-grad KV-cache rollout
  (``train/rollout.py``, the fused conv kernels) from each episode's start
  position and class, then replays it on the host oracle for the optimal
  action after every step; the teacher-forced eval (``eval_supervised``)
  runs the no-grad forward on oracle batches (the conv kernels in its
  embedder and detector, the flash kernel in its decoder).

The trainer's generator draws, every step and in this order, the decision
patches' augmentation, the dropout masks and the detector patches'
augmentation; the JAX step splits one key three ways instead, so the draws
differ (the losses on the same augmented patches do not, see
:func:`decision_loss` and :func:`detection_loss`). On the key route
(``Trainer.key_stream``) the step splits the JAX loop's step key three
ways as the JAX step does (``supervised.py:110``), and draws JAX's own
numbers from them.

The eval's trajectory panels (the model's and the oracle's trajectories of
up to 6 images picked by ``visual_rng``, and with ``--failure-select-rate``
the worst images' trajectories from a second ``eval_envs``) are built on
every test, matplotlib or not, and drawn by ``Trainer.log_eval``. The
worst-images pass runs without the JAX trainer's ``try/except`` around it
(``supervised.py:915-930``): it launches the conv kernels, and a failure
there fails the test. It ranks the images by ``Trainer.worst_ids``, which
averages a per-episode criterion over each image's starts.

``--steps-per-dispatch`` N > 1 (``_build_multi_train_step``, N steps in one
scan) is ``Trainer.train_loop``'s chunks: a loop over the chunk's steps.
"""

from __future__ import annotations

import copy
from collections import defaultdict
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.device_pool import aug_canvases, gather_canvas_patches, gather_pool_patches
from ..env.actions import Action
from ..env.batched_env import NeedleEnv
from ..env.oracle import OracleEnv, gather_patches, generate_sample, move_towards
from ..ops.augment import detection_augment
from ..ops.nms import nms_numpy, postprocess, sigmoid_np
from ..ops.simota import yolox_losses
from ..parallel.mesh import data_parallel, global_count, reduce_metrics
from ..utils.geometry import BBox, Position, parse_bbox_predictions, parse_bbox_targets
from ..utils.metrics import average_precision_50
from . import graphs as train_graphs
from .batching import build_supervised_batch
from .rollout import rollout
from .trainer import Trainer

#: The batch entries every train step uploads to the device: the labels.
LABEL_KEYS = ("current_actions", "class_id", "positions", "reference_actions", "masks",
              "bboxes_yolox", "yolox_valid")
#: What a streamed batch adds: the uint8 pixels of both patch sets.
PIXEL_KEYS = ("patches", "patches_yolox")
#: What a device pool's batch adds: the images and patches to gather, and the
#: augmentations to replay (those of them the batch has).
POOL_KEYS = ("image_idx", "yolox_positions", "base_hw", "aug_rot", "aug_shift")


def upload_keys(batch: Dict[str, np.ndarray]) -> Tuple[str, ...]:
    """The entries of ``batch`` that a train step uploads."""
    extra = PIXEL_KEYS if "patches" in batch else POOL_KEYS
    return LABEL_KEYS + tuple(k for k in extra if k in batch)


def action_ce_metrics(logits, targets, masks, class_weight):
    """Class-weighted CE and accuracy over the non-padding tokens
    (``supervised.py:56-69``); tensors in, scalar tensors out. Inside
    ``parallel.mesh.data_parallel`` both are divided by the global batch's
    token count: this rank's shares."""
    n_act = logits.shape[-1]
    logits = logits.reshape(-1, n_act)
    targets = targets.reshape(-1).long()
    mask = masks.reshape(-1).float()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, targets[:, None])[:, 0] * class_weight[targets]
    denom = global_count(mask.sum()).clamp_min(1.0)  # the global batch's
    action_loss = (nll * mask).sum() / denom
    accuracy = ((logits.argmax(-1) == targets).float() * mask).sum() / denom
    return action_loss, accuracy


def action_ce_metrics_np(logits, targets, masks, class_weight):
    """Numpy twin of :func:`action_ce_metrics` for the host-side eval
    metrics (``supervised.py:72-86``)."""
    logits = np.asarray(logits, np.float32).reshape(-1, logits.shape[-1])
    targets = np.asarray(targets).reshape(-1)
    mask = np.asarray(masks, np.float32).reshape(-1)
    shifted = logits - logits.max(axis=1, keepdims=True)
    logp = shifted - np.log(np.exp(shifted).sum(axis=1, keepdims=True))
    nll = -logp[np.arange(len(targets)), targets]
    nll = nll * np.asarray(class_weight)[targets]
    denom = max(mask.sum(), 1.0)
    action_loss = float((nll * mask).sum() / denom)
    accuracy = float(((logits.argmax(-1) == targets) * mask).sum() / denom)
    return action_loss, accuracy


def decision_loss(model, patches, batch, class_weight, generator=None):
    """The weighted action CE of the teacher-forced forward in train mode on
    already augmented decision ``patches [B, T, P, P, C]`` (float in [0,
    1]) and the batch's tensors (``supervised.py:137-158``): dropout from
    ``generator`` (or a JAX key); batch-statistics BatchNorm in the embedder, which updates
    its running statistics in place. Returns (loss, metrics)."""
    logits, _ = model(patches, batch["current_actions"].long(), batch["class_id"].long(),
                      batch["positions"].long(), train=True, generator=generator)
    action_loss, accuracy = action_ce_metrics(logits, batch["reference_actions"],
                                              batch["masks"], class_weight)
    metrics = {
        "action_loss": action_loss.detach(),
        "action_accuracy": accuracy,
        "episode_length": batch["masks"].sum(dim=1).mean(),
    }
    return action_loss, metrics


def detection_loss(model, det, batch):
    """The SimOTA losses of the train-mode detector on already augmented
    detector patches ``det [B, K, P, P, C]`` (``supervised.py:161-199``).
    Run after :func:`decision_loss`, its BatchNorm running statistics
    continue from what that forward left. Returns the ``yolox_losses``
    dict."""
    B, K = det.shape[:2]
    head, _ = model.yolox_outputs(det.reshape((B * K,) + det.shape[2:]), train=True)
    targets = batch["bboxes_yolox"]
    return yolox_losses(head, targets.reshape((B * K,) + targets.shape[2:]),
                        batch["yolox_valid"].reshape(-1))


class SupervisedTrainer(Trainer):
    best_metric_name = "map"

    def __init__(self, config, model, logger, train_dataset, test_dataset, device=None,
                 world=None):
        super().__init__(config, model, logger, train_dataset, test_dataset, device, world)
        weight = np.ones((self.actions_info[0].nclasses,), np.float32)
        if config.stop_enabled:
            weight[Action.STOP.value] = config.stop_weight
        self.class_weight_np = weight  # host copy for the eval metrics
        self.class_weight = torch.from_numpy(weight).to(self.device)

    # --- the train step ---------------------------------------------------------
    def _pool_patches(self, dev, positions, canvases):
        """uint8 patches at ``positions`` from the device pool: from the
        batch's augmented ``canvases`` when it has them, else from the pool
        (``supervised.py:109-135``)."""
        if canvases is not None:
            return gather_canvas_patches(canvases, positions, self.config.patch_size)
        return gather_pool_patches(self.pool.images, dev["image_idx"], positions,
                                   self.config.patch_size)

    def train_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One iteration on a host batch of ``build_supervised_batch`` (this
        rank's rows); returns its metrics over the global batch as device
        scalars (no host synchronisation).
        A batch without ``patches`` takes its pixels from ``self.pool``.
        Each loss term is differentiated as soon as it is computed: the same
        summed gradient, with the decoder's activations freed before the
        detector runs."""
        cfg = self.config
        self._mark("start")
        dev = {k: torch.from_numpy(batch[k]).to(self.device) for k in upload_keys(batch)}
        self._mark("upload")
        canvases = None
        if "patches" in dev:
            raw = dev["patches"]
        else:
            if "aug_rot" in dev or "aug_shift" in dev:
                canvases = aug_canvases(self.pool.images, dev["image_idx"], dev.get("aug_rot"),
                                        dev.get("aug_shift"), dev.get("base_hw"))
            raw = self._pool_patches(dev, dev["positions"], canvases)
        k_aug1, k_aug2, k_drop = self.step_draws(3)
        with data_parallel(self.world, self.optimizer.trained_params()), \
                train_graphs.active(self.step_graphs()):
            patches = detection_augment(k_aug1, raw)
            loss, metrics = decision_loss(self.model, patches, dev, self.class_weight, k_drop)
            loss.backward()
            loss = loss.detach()
            self._mark("decision")
            if cfg.detection_enabled:
                if "patches_yolox" in dev:
                    raw = dev["patches_yolox"]
                else:
                    # The streamed batch's padding patches are zeros; so are these.
                    raw = self._pool_patches(dev, dev["yolox_positions"], canvases)
                    raw = raw * dev["yolox_valid"][:, :, None, None, None].to(raw.dtype)
                det = detection_augment(k_aug2, raw)
                ylo = detection_loss(self.model, det, dev)
                ylo["total_loss"].backward()
                loss = loss + ylo["total_loss"].detach()
                for name, value in ylo.items():
                    metrics[f"yolo_{name}"] = value.detach()
                metrics["yolo_loss"] = ylo["total_loss"].detach()
                self._mark("detection")
        metrics["loss"] = loss
        metrics = reduce_metrics(metrics, self.world, self.RANK_MEAN_METRICS, self.GLOBAL_METRICS)
        self.optimizer.step()
        self.step += 1
        self._mark("optimizer")
        return metrics

    # --- train loop (reference: src/supervised.py:812-911) ----------------------
    def train_iterations(self):
        """``max_iters - 1`` iterations, as the JAX loop runs
        (``supervised.py:343``, ``:360``)."""
        return range(1, self.config.max_iters)

    def build_batch(self, indices, seed: int) -> Dict[str, np.ndarray]:
        return build_supervised_batch(self.train_dataset, indices, self.config,
                                      np.random.default_rng(seed),
                                      with_pixels=self.pool is None)

    # --- autoregressive eval ----------------------------------------------------
    @staticmethod
    def optimal_next_action(env: OracleEnv) -> Action:
        """Best next action from the greedy keypoint ordering
        (``supervised.py:392-399``)."""
        keypoints = env.build_keypoints_trajectory()
        return env.remove_stop_action(move_towards(env.position, keypoints[0]))

    def _dispatch_eval_rollout(self, images, boxes, rows, generator, sample_actions):
        """The autoregressive eval rollout of one chunk (``supervised.py:
        401-452``): ``test_max_seq_len - 1`` steps from each row's start
        position and class, no all-found termination, collecting the
        logits and actions."""
        cfg = self.config
        env = NeedleEnv(torch.from_numpy(images).to(self.device), boxes, cfg.patch_size,
                        cfg.test_max_seq_len - 1, 1, cfg.stop_enabled,
                        terminate_on_all_found=False, device=self.device)
        classes = torch.tensor([int(r["class_id"]) for r in rows], device=self.device)
        positions = torch.tensor([tuple(r["position"]) for r in rows], device=self.device)
        ro = rollout(self.model, env, sample=sample_actions, generator=generator,
                     classes=classes, collect=("logits", "actions"), positions=positions)
        ro.pop("final_state")
        return ro

    def test_model_on_env(
        self,
        item: dict,
        max_ep_len: int,
        class_id: int,
        sample_actions: bool = False,
        position: Optional[Tuple[int, int]] = None,
        env: Optional[OracleEnv] = None,
        sample_rng: Optional[np.random.Generator] = None,
        rollout: Optional[dict] = None,
    ) -> tuple:
        """Greedy or sampled rollout on one image, its oracle replay and its
        detections: (sample, metrics, bbox_outs) (``supervised.py:454-498``)."""
        cfg = self.config
        image = item["image"]
        boxes = np.asarray(item["bboxes"], np.float64).reshape(-1, 4)
        if env is None:
            env = OracleEnv(image.shape[:2], cfg.patch_size, boxes)
        env.reset(position)
        if rollout is None:
            if sample_rng is None:
                sample_rng = np.random.default_rng(0)
            rollout = self._batched_eval_rollouts(
                [{"image": image, "boxes": boxes, "class_id": class_id,
                  "position": env.position, "seed": int(sample_rng.integers(2**31))}],
                sample_actions,
            )[0]
        rep = self._replay_episode(item, env, rollout=rollout, max_ep_len=max_ep_len)
        det = self._batched_patch_detections([rep["det_request"]])[0]
        return self._finish_episode(rep, det)

    def _replay_episode(self, item: dict, env: OracleEnv, rollout: dict,
                        max_ep_len: int) -> dict:
        """Host stage of the autoregressive eval (``supervised.py:500-563``):
        the oracle replay for the optimal labels, and the episode's padded
        detection request. The logits taken BEFORE a step are paired with
        the optimal action at the state AFTER it (reference:
        src/supervised.py:333-351)."""
        cfg = self.config
        image = item["image"]
        ro = rollout
        step_masks = ro["logit_masks"][0].astype(bool)  # [T-1]
        n_steps = int(step_masks.sum())
        taken = ro["actions"][0][:n_steps]
        all_logits = ro["logits"][0][:n_steps]

        positions = [env.position]
        true_actions = []
        pred_logits = []
        labels = [env.position in env.bbox_patches]
        for t in range(n_steps):
            env.step(Action(int(taken[t])))
            true_actions.append(self.optimal_next_action(env).value)
            pred_logits.append(all_logits[t])
            positions.append(env.position)
            labels.append(env.position in env.bbox_patches)

        visited = np.array(positions, np.int32)
        n_visited = len(visited)
        T_pad = max(max_ep_len, n_visited)
        patches = gather_patches(image, visited, cfg.patch_size)
        patches_padded = np.zeros((T_pad,) + patches.shape[1:], patches.dtype)
        patches_padded[:n_visited] = patches
        patch_valid = np.arange(T_pad) < n_visited
        local_bboxes = np.zeros((T_pad, cfg.max_boxes, 6), np.float32)
        for i, pos in enumerate(visited):
            local = env.cap_local_bboxes(env.local_bboxes(tuple(pos)), cfg.max_boxes)
            local_bboxes[i, : len(local)] = local

        return {
            "visited": visited,
            "n_visited": n_visited,
            "patches": patches,
            "true_actions": true_actions,
            "pred_logits": pred_logits,
            "labels": labels,
            "stopped_inside_bbox": float(labels[-1]),
            "prop_patches_found": (len(env.visited_bbox_patches) / len(env.bbox_patches)
                                   if len(env.bbox_patches) > 0 else 0.0),
            "local_bboxes": local_bboxes,
            "det_request": {"patches": patches_padded, "targets": local_bboxes,
                            "valid": patch_valid},
        }

    def _finish_episode(self, rep: dict, det: dict) -> tuple:
        """(sample, metrics, bbox_outs) from a replay and its batched
        detection result (``supervised.py:565-604``)."""
        cfg = self.config
        n_visited = rep["n_visited"]
        head_out = det["head"]
        bbox_outs = postprocess(
            head_out["boxes"], sigmoid_np(head_out["obj_logits"]),
            sigmoid_np(head_out["cls_logits"]),
            conf_threshold=self.model.detector_conf_threshold, patch_size=cfg.patch_size,
        )[:n_visited]
        local_bboxes = rep["local_bboxes"][:n_visited]

        metrics = {}
        if rep["pred_logits"]:
            targets = np.array(rep["true_actions"])[None]
            al, acc = action_ce_metrics_np(np.stack(rep["pred_logits"])[None], targets,
                                           np.ones_like(targets, np.float32),
                                           self.class_weight_np)
            metrics["action_loss"] = al
            metrics["action_accuracy"] = acc
        metrics["episode_length"] = float(n_visited)
        for name, value in det["losses"].items():
            metrics[f"yolo_{name}"] = float(value)
        metrics["yolo_loss"] = metrics["yolo_total_loss"]
        metrics["loss"] = metrics.get("action_loss", 0.0) + metrics["yolo_loss"]
        metrics["stopped_inside_bbox"] = rep["stopped_inside_bbox"]
        metrics["prop_patches_found"] = rep["prop_patches_found"]

        sample = {
            "positions": rep["visited"],
            "patches": rep["patches"],
            "masks": np.ones((n_visited,), np.float32),
            "local_bboxes": local_bboxes,
        }
        return sample, metrics, bbox_outs

    # --- multi-start aggregation (reference: src/supervised.py:569-636) ---------
    def _per_patch_map(self, env, samples, bboxes) -> dict:
        """mAP over the visited patches, multi-start predictions NMS-deduped,
        missed bbox patches counted as false negatives (``supervised.py:
        607-648``; its NMS score is obj_conf * cls_conf, where the reference
        passes the class column)."""
        visited = {tuple(p) for s in samples for p in s["positions"]}
        predicted: Dict[tuple, list] = {}
        for sample, bbs in zip(samples, bboxes):
            for pos, bb in zip(sample["positions"], bbs):
                if bb is not None:
                    predicted.setdefault(tuple(pos), []).append(np.asarray(bb))

        pred_boxes, pred_scores, gt_boxes = [], [], []

        def add_patch(pos, preds):
            local = env.local_bboxes(pos)
            gt = local[local[:, 5] == 1][:, 1:5]
            if preds is None or len(preds) == 0:
                pred_boxes.append(np.zeros((0, 4)))
                pred_scores.append(np.zeros((0,)))
            else:
                preds = np.concatenate(preds)
                keep = nms_numpy(preds[:, :4], preds[:, 4] * preds[:, 5], 0.5)
                pred_boxes.append(preds[keep, :4])
                pred_scores.append(preds[keep, 4] * preds[keep, 5])
            gt_boxes.append(gt)

        for pos in sorted(visited):
            add_patch(pos, predicted.get(pos))
        for pos in sorted(env.bbox_patches - visited):
            add_patch(pos, None)

        return {"map": average_precision_50(pred_boxes, pred_scores, gt_boxes)
                if sum(len(g) for g in gt_boxes) > 0 else 0.0}

    # --- full evaluation (reference: src/supervised.py:638-810) -----------------
    def eval_envs(self, dataset, env_ids, eval_mode: str = "multistart",
                  sample_actions: bool = False):
        """The autoregressive eval of ``env_ids`` (``supervised.py:651-805``):
        the start positions of each image (``multistart``: two random,
        ``rollouts``: the env's twice, ``corners``: the four corners), one
        batched rollout pass, the host replays, one batched detection pass,
        then each episode's metrics and the multi-start mAP and found
        proportions. Returns (metrics as lists, panels): for up to 6 images
        picked by ``visual_rng``, ``model_images`` holds the first start's
        trajectory with its targets and predictions and ``sample_images``
        the oracle's trajectory from that start, each as
        ``plot_model_prediction`` keywords. The oracle sample draws from the
        episode's seeded generator (``OracleEnv.rng``, seeded with the
        episode's index), as the JAX eval's does: the same panel each run."""
        visual_ids = set(self.visual_rng.choice(
            np.arange(len(env_ids)), size=min(6, len(env_ids)), replace=False).tolist())
        panels = {"model_images": [], "sample_images": []}
        all_metrics = defaultdict(list)
        cfg = self.config
        episodes = []  # (item, env, positions)
        rows = []
        for loop_id, env_id in enumerate(env_ids):
            seed = loop_id
            item = dataset.__getitem__(int(env_id), np.random.default_rng(seed))
            boxes = np.asarray(item["bboxes"], np.float64).reshape(-1, 4)
            env = OracleEnv(item["image"].shape[:2], cfg.patch_size, boxes,
                            np.random.default_rng(seed))
            if eval_mode == "multistart":
                positions = [None, None]
            elif eval_mode == "rollouts":
                positions = [env.position] * 2
            else:  # corners
                positions = [(0, 0), (env.patch_height - 1, 0), (0, env.patch_width - 1),
                             (env.patch_height - 1, env.patch_width - 1)]
            for i, position in enumerate(positions):
                env.reset(position)
                positions[i] = env.position
                rows.append({"image": item["image"], "boxes": boxes,
                             "class_id": item["class_id"], "position": env.position,
                             "seed": seed})
            episodes.append((item, env, positions))

        rollouts = self._batched_eval_rollouts(rows, sample_actions)
        reps = []
        row_id = 0
        for item, env, positions in episodes:
            for position in positions:
                env.reset(position)
                reps.append(self._replay_episode(item, env, rollouts[row_id],
                                                 cfg.test_max_seq_len))
                row_id += 1
        dets = self._batched_patch_detections([rep["det_request"] for rep in reps])

        row_id = 0
        for loop_id, (item, env, positions) in enumerate(episodes):
            all_samples, all_bboxes = [], []
            for _ in positions:
                sample, metrics, bboxes = self._finish_episode(reps[row_id], dets[row_id])
                row_id += 1
                all_samples.append(sample)
                all_bboxes.append(bboxes)
                for name, value in metrics.items():
                    all_metrics[name].append(value)
            for n_starts in range(1, len(positions) + 1):
                m = self._per_patch_map(env, all_samples[:n_starts], all_bboxes[:n_starts])
                suffix = f"_{eval_mode}_{n_starts}" if n_starts != 1 else ""
                for name, value in m.items():
                    all_metrics[f"{name}{suffix}"].append(value)
                visited = {tuple(p) for s in all_samples[:n_starts] for p in s["positions"]}
                all_metrics[f"prop_patches_found_traj{suffix}"].append(
                    len(visited & env.bbox_patches) / len(env.bbox_patches)
                    if env.bbox_patches else 0.0)

            if loop_id in visual_ids:
                sample = all_samples[0]
                panels["model_images"].append(dict(
                    image=item["image"], patches=sample["patches"],
                    positions=sample["positions"],
                    true_bboxes=parse_bbox_targets(sample["local_bboxes"], sample["positions"],
                                                   cfg.patch_size),
                    predicted_bboxes=parse_bbox_predictions(all_bboxes[0], sample["positions"],
                                                            cfg.patch_size)))
                gen = generate_sample(
                    env, max_ep_len=env.patch_width * env.patch_height,
                    min_keypoints=dataset.min_keypoints, max_keypoints=dataset.max_keypoints,
                    binomial_keypoints=dataset.binomial_keypoints, position=positions[0])
                n = int(gen["masks"].sum())
                panels["sample_images"].append(dict(
                    image=item["image"],
                    patches=gather_patches(item["image"], gen["positions"][:n], cfg.patch_size),
                    positions=gen["positions"][:n],
                    true_bboxes=[BBox(Position(y=b[1], x=b[0]), Position(y=b[3], x=b[2]))
                                 for b in env.raw_bboxes]))
        return all_metrics, panels

    def eval_supervised(self, dataset, env_ids):
        """Teacher-forced eval on oracle batches of ``env_ids`` in chunks of
        ``batch_size`` (``supervised.py:807-890``): the weighted CE and
        accuracy of the no-grad forward, the detector's losses on the
        batch's detector patches, and their per-patch mAP."""
        all_metrics = defaultdict(list)
        cfg = self.config
        bs = cfg.batch_size
        rng = np.random.default_rng(cfg.seed)
        for start in range(0, len(env_ids), bs):
            ids = env_ids[start : start + bs]
            batch = build_supervised_batch(dataset, ids, cfg, rng)
            logits = self._forward(batch["patches"], batch["current_actions"],
                                   batch["class_id"], batch["positions"]).cpu().numpy()
            al, acc = action_ce_metrics_np(logits, batch["reference_actions"], batch["masks"],
                                           self.class_weight_np)
            all_metrics["action_loss"].append(al)
            all_metrics["action_accuracy"].append(acc)
            all_metrics["episode_length"].append(float(batch["masks"].sum(axis=1).mean()))

            if cfg.detection_enabled:
                B, K = batch["patches_yolox"].shape[:2]
                flat = lambda x: torch.from_numpy(x.reshape((B * K,) + x.shape[2:])).to(
                    self.device)
                targets = batch["bboxes_yolox"].reshape((B * K,) + batch["bboxes_yolox"].shape[2:])
                with torch.no_grad():
                    head, _ = self.model.yolox_outputs(flat(batch["patches_yolox"]))
                    ylo = yolox_losses(head, torch.from_numpy(targets).to(self.device),
                                       flat(batch["yolox_valid"]))
                for name, value in ylo.items():
                    all_metrics[f"yolo_{name}"].append(float(value))
                all_metrics["yolo_loss"].append(float(ylo["total_loss"]))
                all_metrics["loss"].append(float(al) + float(ylo["total_loss"]))
                head_np = {k: v.cpu().numpy() for k, v in head.items()}
                outs = postprocess(
                    head_np["boxes"], sigmoid_np(head_np["obj_logits"]),
                    sigmoid_np(head_np["cls_logits"]),
                    conf_threshold=self.model.detector_conf_threshold,
                    patch_size=cfg.patch_size,
                )
                pred_boxes, pred_scores, gt_boxes = [], [], []
                for t, o in zip(targets, outs):
                    gt_boxes.append(t[t[:, 5] == 1][:, 1:5])
                    if o is None:
                        pred_boxes.append(np.zeros((0, 4)))
                        pred_scores.append(np.zeros((0,)))
                    else:
                        pred_boxes.append(o[:, :4])
                        pred_scores.append(o[:, 4] * o[:, 5])
                all_metrics["map"].append(
                    average_precision_50(pred_boxes, pred_scores, gt_boxes)
                    if sum(len(g) for g in gt_boxes) > 0 else 0.0)
        return all_metrics

    def test(self, sample_actions: bool = False):
        """Test cycle (``supervised.py:892-942``): the autoregressive eval
        with its panels, the worst-images pass (``--failure-select-rate``:
        a second ``eval_envs`` on the images with the lowest best-metric
        values, averaged over each image's starts, whose model panels become
        ``worst_images``) and the
        teacher-forced eval, on the test set (and the training set with
        ``--eval-training-set``), each on an un-augmented view of its
        dataset; best-checkpoint tracking, the checkpoints and
        ``metrics.json``."""
        cfg = self.config
        evals = [(self.test_dataset, self.test_env_ids, "test")]
        if cfg.eval_training_set:
            evals.append((self.train_dataset, self.train_env_ids, "train"))
        for dataset, env_ids, mode in evals:
            # A shallow copy, not a flag change: the prefetcher's threads keep
            # building augmented training batches from the original meanwhile.
            dataset = copy.copy(dataset)
            dataset.translations = dataset.rotations = False
            metrics, panels = self.eval_envs(dataset, env_ids, sample_actions=sample_actions)
            worst_count = int(cfg.failure_select_rate * len(dataset))
            if worst_count > 0 and metrics[self.best_metric_name]:
                worst_ids = self.worst_ids(metrics, len(env_ids), worst_count)
                _, worst = self.eval_envs(dataset, np.asarray(env_ids)[worst_ids])
                panels["worst_images"] = worst["model_images"]
            for name, values in self.eval_supervised(dataset, env_ids).items():
                metrics["supervised_" + name] = values
            self.last_test_metrics = metrics
            self.record_best_metric(metrics)
            self.log_eval(metrics, panels, mode)
        self.save_state()
        self.save_metrics()
