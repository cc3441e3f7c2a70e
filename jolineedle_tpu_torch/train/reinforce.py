"""REINFORCE trainer: sampled glimpse rollouts and a policy-gradient step.

The counterpart of ``jolineedle_tpu/train/reinforce.py``. The JAX train step
differentiates through its whole ``lax.scan`` rollout (KV-cache decode and
embedder included). Here the rollout is the no-grad host loop of
``train/rollout.py`` (its YOLOX blocks on the fused eval kernels), and
:func:`reinforce_loss` recomputes the log-probabilities of the sampled
actions with one teacher-forced forward of the decoder (prev-action input
``[0, a_0 .. a_{T-2}]``, the positions and patches the rollout saw) in eval
mode: no dropout and running-statistics BatchNorm, as ``decode_step`` runs
(``gpt.py:385``). Decode and forward are the same function
(``gpt.py:372-376``), so the gradient is the JAX one. The forward's attention
is the flash kernel on the card; a ``gpt_backbone`` embedder's convs are
PyTorch convs that autograd differentiates, while the shared detector
backbone (no ``gpt_backbone``), whose gradient stops at its FPN, embeds
forward only on the fused conv kernels, as in the rollout.

A train step (``reinforce.py:126-233``): the batch's images, uploaded from
the host or, under ``--device-data-cache`` (``data/device_pool.py``), taken
from the training set on the device with its augmentations replayed there;
rollout; the action loss
``-logprob * advantage`` and the entropy term over the live steps, with the
advantages normalised by the previous accumulation window's return
mean and Bessel-corrected std; then, with detection on, the SimOTA loss of
the train-mode detector on env-sampled, photometrically augmented patches;
backward; the optimizer (accumulation, clip 1.0, two AdamW groups).

On the card and on one rank the step replays CUDA graphs
(``train/graphs.py``): the sampled rollout (from its second step of a
shape), the recompute's embedder (a ``gpt_backbone`` one under autograd,
or the shared backbone forward only) and the train-mode detector, with the
step's draws, kernels and gradients as the eager step has them
(``chip_smoke.py`` phases 11d and 11e hold the two).
"""

from __future__ import annotations

import copy
from collections import defaultdict
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.device_pool import aug_canvases, gather_pool_images
from ..env.batched_env import NeedleEnv
from ..env.oracle import gather_patches
from ..ops.augment import detection_augment
from ..ops.nms import postprocess, sigmoid_np
from ..ops.simota import yolox_losses
from ..parallel.mesh import data_parallel, global_count, reduce_metrics
from ..utils.geometry import BBox, Position, merge_boxes_batched, parse_bbox_predictions
from ..utils.metrics import compute_detection_metrics, patch_bboxes2full_image
from . import graphs as train_graphs
from .rollout import compute_rollout_metrics, rollout
from .trainer import Trainer


def fixed_training_shape(dataset, patch_size: int) -> Tuple[int, int]:
    """Static (H, W) that fits every transformed training image, read from
    the image headers only (``reinforce.py:66-93``)."""
    from PIL import Image

    max_h = max_w = patch_size
    for path in dataset.image_paths:
        with Image.open(path) as im:
            w, h = im.size
        m = dataset.minimum_image_size
        if m and (w < m or h < m):
            ratio = w / h
            if w < m:
                w = m
                h = int(w / ratio)
            if h < m:
                h = m
                w = int(h * ratio)
        max_h, max_w = max(max_h, h), max(max_w, w)
    if dataset.rotations:
        max_h = max_w = max(max_h, max_w)
    round_up = lambda v: -(-v // patch_size) * patch_size
    return round_up(max_h), round_up(max_w)


def teacher_forced(model, env: NeedleEnv,
                   ro: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``[B, T]`` log-probabilities and entropies of a rollout's taken
    actions, from one teacher-forced forward in eval mode over the patches
    at the rollout's positions (the previous actions ``[0, a_0 .. a_{T-2}]``):
    what the rollout's own decode steps computed, differentiable."""
    actions = ro["actions"]
    B, T = actions.shape
    positions = ro["positions"][:, :T]
    patches = env.gather_patches_at(positions)
    prev_actions = torch.cat([torch.zeros_like(actions[:, :1]), actions[:, :-1]], dim=1)
    classes = torch.zeros(B, dtype=torch.long, device=actions.device)
    logits, _ = model(patches, prev_actions, classes, positions, train=False)
    logp_all = F.log_softmax(logits.float(), dim=-1)
    logprobs = logp_all.gather(-1, actions[..., None])[..., 0]
    entropies = -(logp_all.exp() * logp_all).sum(-1)
    return logprobs, entropies


def reinforce_loss(
    model,
    env: NeedleEnv,
    ro: Dict[str, torch.Tensor],
    return_mean: float,
    return_std: float,
    entropy_weight: float,
    reward_norm: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The REINFORCE loss of a sampled rollout ``ro`` (from :func:`rollout`
    with ``collect=("actions",)``), differentiable in the model's weights.

    The log-probabilities and entropies of the taken actions come from
    :func:`teacher_forced`; ``ro["returns"]`` and ``ro["logit_masks"]`` are
    data.
    Returns (loss, metrics) as ``reinforce.py:168-187`` computes them.
    Inside ``parallel.mesh.data_parallel`` the mask sum that divides both
    terms is the global batch's: the loss is this rank's share."""
    logprobs, entropies = teacher_forced(model, env, ro)
    masks = ro["logit_masks"]
    returns = ro["returns"]
    advantages = (returns - return_mean) / (return_std + 1e-8) if reward_norm else returns
    msum = global_count(masks.sum()).clamp_min(1.0)  # the global batch's (reinforce.py:173)
    action_loss = -(logprobs * advantages * masks).sum() / msum
    entropy_loss = -(entropies * masks).sum() / msum
    loss = action_loss + entropy_weight * entropy_loss
    metrics = {
        "action_loss": action_loss.detach(),
        "entropy_loss": entropy_loss.detach(),
        "returns": (ro["rewards"] * masks).sum(dim=1).mean(),
        "episode_length": masks.sum(dim=1).mean(),
        # window stats for the cross-batch return normalisation
        "ret_sum": (returns * masks).sum(),
        "ret_sumsq": (returns**2 * masks).sum(),
        "ret_count": masks.sum(),
    }
    return loss, metrics


class ReinforceTrainer(Trainer):
    best_metric_name = "prop_patches_found"

    def __init__(self, config, model, logger, train_dataset, test_dataset, device=None,
                 world=None):
        super().__init__(config, model, logger, train_dataset, test_dataset, device, world)
        self.max_ep_len = config.max_seq_len
        self.entropy_weight = config.entropy_weight
        self.stop_enabled = config.stop_enabled
        # Return-normalisation window (reference: src/reinforce.py:69-71).
        self.last_return_mean = 0.0
        self.last_return_std = 1.0
        self._window_stats = []  # (sum, sumsq, count) device scalars
        # self.generator draws the rollouts' reset positions and actions, the
        # detection negatives and the augmentation, in that order, every step.

    def train_state(self) -> dict:
        state = super().train_state()
        state.update(
            return_window=[self.last_return_mean, self.last_return_std],
            window_stats=[[float(v) for v in s] for s in self._window_stats],
        )
        return state

    def load_train_state(self, state: dict) -> None:
        super().load_train_state(state)
        self.last_return_mean, self.last_return_std = state["return_window"]
        self._window_stats = [tuple(s) for s in state["window_stats"]]

    # --- return-normalisation window (reference: reinforce.py:92-106) ---------
    def _update_return_stats(self):
        if not self._window_stats:
            self.last_return_mean, self.last_return_std = 0.0, 1.0
            return
        total = float(sum(float(s[0]) for s in self._window_stats))
        totalsq = float(sum(float(s[1]) for s in self._window_stats))
        count = float(sum(float(s[2]) for s in self._window_stats))
        if count == 0:
            mean, std = 0.0, 1.0
        elif count == 1:
            mean, std = total, 1.0
        else:
            mean = total / count
            var = max(totalsq - count * mean * mean, 0.0) / (count - 1)
            std = var**0.5
        self.last_return_mean, self.last_return_std = mean, std
        self._window_stats = []

    # --- host batch assembly ----------------------------------------------------
    @property
    def fixed_shape(self):
        if not hasattr(self, "_fixed_shape"):
            self._fixed_shape = fixed_training_shape(self.train_dataset, self.config.patch_size)
        return self._fixed_shape

    def _build_env_batch(self, indices, seed: int = 0,
                         with_pixels: bool = True) -> Dict[str, np.ndarray]:
        """``[B, max_boxes, 4]`` padded boxes and either the uint8 ``[B, Hf,
        Wf, C]`` images padded to the static training shape or, with
        ``with_pixels=False`` (the device pool's route), the images' indices
        and the augmentations to replay (``reinforce.py:296-350``)."""
        cfg = self.config
        hf, wf = self.fixed_shape
        ds = self.train_dataset
        rng = np.random.default_rng(seed)
        images, boxes = [], []
        aug_rot, aug_shift, base_hw = [], [], []
        for idx in indices:
            if with_pixels:
                item = ds.__getitem__(int(idx), rng)
                img = item["image"]
                if img.dtype != np.uint8:
                    img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
                h, w = img.shape[:2]
                images.append(np.pad(img, ((0, hf - h), (0, wf - w), (0, 0))))
            else:
                item = ds.get_geometry(int(idx), rng)  # the same draws, no decode
                aug_rot.append(item["aug_rot"])
                aug_shift.append(item["aug_shift"])
                base_hw.append(item["base_hw"])
            b = np.asarray(item["bboxes"], np.float32).reshape(-1, 4)[: cfg.max_boxes]
            boxes.append(np.pad(b, ((0, cfg.max_boxes - len(b)), (0, 0))))
        batch = {"bboxes": np.stack(boxes)}
        if with_pixels:
            batch["image"] = np.stack(images)
        else:
            batch["image_idx"] = np.asarray(indices, np.int32)
            if ds.rotations or ds.translations:
                batch["base_hw"] = np.asarray(base_hw, np.int32)
            if ds.rotations:
                batch["aug_rot"] = np.asarray(aug_rot, np.int32)
            if ds.translations:
                batch["aug_shift"] = np.asarray(aug_shift, np.int32)
        return batch

    def _batch_images(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """The ``[B, Hf, Wf, C]`` uint8 images of a batch on the device
        (``reinforce.py:126-152``): uploaded, or from ``self.pool``, by
        index when the pool already has the training shape and nothing is
        to be replayed, else through ``aug_canvases`` at that shape."""
        if "image" in batch:
            return torch.from_numpy(batch["image"]).to(self.device)
        dev = {k: torch.from_numpy(batch[k]).to(self.device)
               for k in ("image_idx", "aug_rot", "aug_shift", "base_hw") if k in batch}
        pool = self.pool.images
        if ("aug_rot" in dev or "aug_shift" in dev
                or tuple(pool.shape[1:3]) != tuple(self.fixed_shape)):
            return aug_canvases(pool, dev["image_idx"], dev.get("aug_rot"), dev.get("aug_shift"),
                                dev.get("base_hw"), out_hw=tuple(self.fixed_shape))
        return gather_pool_images(pool, dev["image_idx"])

    # --- the train step ---------------------------------------------------------
    def train_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One REINFORCE iteration on a host batch (this rank's rows);
        returns its metrics over the global batch as device scalars (no host
        synchronisation)."""
        cfg = self.config
        self._mark("start")
        images = self._batch_images(batch)
        self._mark("upload")
        graphs = self.step_graphs()
        with data_parallel(self.world, self.optimizer.trained_params()), \
                train_graphs.active(graphs):
            env = NeedleEnv(images, batch["bboxes"], cfg.patch_size, self.max_ep_len, 1,
                            self.stop_enabled,
                            stop_bonus_scale=getattr(cfg, "stop_bonus_scale", 1.0),
                            device=self.device)
            if graphs is not None:
                ro = graphs.rollout(env, self.generator)
            else:
                ro = rollout(self.model, env, sample=True, generator=self.generator,
                             collect=("actions",))
            self._mark("rollout")
            loss, metrics = reinforce_loss(self.model, env, ro, self.last_return_mean,
                                           self.last_return_std, self.entropy_weight,
                                           cfg.reward_norm)
            # Backward per loss term: the same summed gradient, and the rollout
            # recompute's activations are freed before the detector runs.
            loss.backward()
            self._mark("loss")
            if cfg.detection_enabled:
                patches, targets, pvalid = env.get_detection_batch(
                    self.generator, cfg.max_det_patches, sample_neg=1)
                det = detection_augment(self.generator, patches)
                B, K = det.shape[:2]
                head, _ = self.model.yolox_outputs(det.reshape((B * K,) + det.shape[2:]),
                                                   train=True)
                ylo = yolox_losses(head, targets.reshape((B * K,) + targets.shape[2:]),
                                   pvalid.reshape(-1))
                ylo["total_loss"].backward()
                loss = loss.detach() + ylo["total_loss"].detach()
                for name, value in ylo.items():
                    metrics[f"yolo_{name}"] = value.detach()
                metrics["yolo_loss"] = ylo["total_loss"].detach()
                self._mark("detection")
        metrics["loss"] = loss.detach()
        metrics = reduce_metrics(metrics, self.world, self.RANK_MEAN_METRICS, self.GLOBAL_METRICS)
        self.optimizer.step()
        self.step += 1
        self._mark("optimizer")
        return metrics

    # --- train loop (reference: src/reinforce.py:267-362) -----------------------
    def build_batch(self, indices, seed: int) -> Dict[str, np.ndarray]:
        return self._build_env_batch(indices, seed, with_pixels=self.pool is None)

    def train_pool(self):
        pool = self.build_pool()
        if pool is not None:
            # A pool padded beyond the training shape cannot fill the env's
            # images (``reinforce.py:380-397``).
            hp, wp = pool.images.shape[1:3]
            hf, wf = self.fixed_shape
            if hp > hf or wp > wf:
                print("device pool: pad shape exceeds fixed training shape, streaming instead")
                pool = None
        return pool

    def steps_per_dispatch(self) -> int:
        """As the base, and with ``--reward-norm`` it must also divide
        ``--gradient-accumulation`` (``reinforce.py:399-411``): the return
        statistics then change only between chunks, as at N = 1."""
        cfg = self.config
        spd = max(1, int(getattr(cfg, "steps_per_dispatch", 1)))
        if spd > 1 and (cfg.test_every % spd
                        or (cfg.reward_norm and cfg.gradient_accumulation % spd)):
            raise ValueError(
                f"--steps-per-dispatch {spd} must divide --test-every {cfg.test_every} and"
                f" (with reward normalization) --gradient-accumulation"
                f" {cfg.gradient_accumulation}")
        return spd

    def after_chunk(self, it: int, chunk_metrics) -> None:
        """The chunk's summed return statistics join the window once
        (``reinforce.py:488-495``; float64 sums, so that the window equals
        N = 1's per-iteration entries); the statistics update at the end of
        each accumulation window."""
        cfg = self.config
        if cfg.reward_norm:
            self._window_stats.append(tuple(
                sum(m[k].double() for m in chunk_metrics)
                for k in ("ret_sum", "ret_sumsq", "ret_count")))
            if it % cfg.gradient_accumulation == 0:
                self._update_return_stats()

    # --- evaluation --------------------------------------------------------------
    def compute_rollout_metrics(self, ro: Dict[str, np.ndarray]) -> Dict[str, float]:
        return compute_rollout_metrics(ro, self.config, self.last_return_mean,
                                       self.last_return_std)

    def _batched_detection_batches(self, items):
        """Per image: every positive patch (``get_detection_batch`` with no
        negatives), grouped by image shape and chunked to ``EVAL_CHUNK``
        images per env. Returns per item (patches [K, P, P, C] float in
        [0, 1], targets [K, N, 6], valid [K]) as numpy (``reinforce.py:
        585-639``)."""
        cfg = self.config
        groups = defaultdict(list)
        for i, item in enumerate(items):
            groups[item["image"].shape].append(i)
        results = [None] * len(items)
        for ids in groups.values():
            for start in range(0, len(ids), self.EVAL_CHUNK):
                chunk = ids[start : start + self.EVAL_CHUNK]
                images = np.stack([items[i]["image"] for i in chunk])
                boxes = np.zeros((len(chunk), cfg.max_boxes, 4), np.float32)
                for j, i in enumerate(chunk):
                    b = np.asarray(items[i]["bboxes"], np.float32).reshape(-1, 4)
                    boxes[j, : min(len(b), cfg.max_boxes)] = b[: cfg.max_boxes]
                env = NeedleEnv(torch.from_numpy(images).to(self.device), boxes,
                                cfg.patch_size, self.max_ep_len, 1, self.stop_enabled,
                                device=self.device)
                gen = torch.Generator(device=self.device).manual_seed(0)
                patches, targets, valid = (
                    t.cpu().numpy()
                    for t in env.get_detection_batch(gen, cfg.max_det_patches, sample_neg=0))
                for j, i in enumerate(chunk):
                    results[i] = (patches[j], targets[j], valid[j])
        return results

    def _traj_det_request(self, item: dict, ro: dict):
        """The visited patches of one eval image, padded to max_ep_len + 1."""
        cfg = self.config
        positions = ro["positions"][0]
        n_valid = int(ro["masks"][0].sum())
        patches = gather_patches(item["image"], positions[:n_valid], cfg.patch_size)
        T_pad = self.max_ep_len + 1
        padded = np.zeros((T_pad,) + patches.shape[1:], patches.dtype)
        padded[:n_valid] = patches
        return {"patches": padded, "valid": np.arange(T_pad) < n_valid}, patches

    def eval_on_sample(self, item: dict, plot_traj: bool = False, sample_actions: bool = False,
                       rollout: Optional[dict] = None, dets: Optional[dict] = None):
        """Rollout and detection metrics of one eval image, and with
        ``plot_traj`` its trajectory panel (reference: src/reinforce.py:
        417-493; ``reinforce.py:659-794``). Returns (metrics, panel), the
        panel as :meth:`_panel` builds it, or None.

        ``rollout`` and ``dets`` come batched across images from
        :meth:`test`; without them this runs the image's own eval rollout
        and detections (the standalone path of the worst-images pass)."""
        cfg = self.config
        boxes = np.asarray(item["bboxes"], np.float32).reshape(-1, 4)
        if rollout is None:
            rollout = self._batched_eval_rollouts([{"image": item["image"], "boxes": boxes}],
                                                  sample_actions)[0]
        ro = rollout
        metrics = self.compute_rollout_metrics(ro)
        positions = ro["positions"][0]
        n_valid = int(ro["masks"][0].sum())
        full_img_targets = [np.concatenate(
            [np.zeros((len(boxes), 1), np.float64), boxes.astype(np.float64)], axis=1)]
        if not cfg.detection_enabled:
            return metrics, self._panel(item, boxes, positions[:n_valid], None) if plot_traj else None
        traj_req, _ = self._traj_det_request(item, ro)
        traj_det = dets["traj"] if dets is not None else self._batched_patch_detections([traj_req])[0]
        head = traj_det["head"]
        traj_preds = postprocess(
            head["boxes"], sigmoid_np(head["obj_logits"]), sigmoid_np(head["cls_logits"]),
            conf_threshold=self.model.detector_conf_threshold, patch_size=cfg.patch_size,
        )[:n_valid]
        offsets = positions[:n_valid][:, [1, 0]] * cfg.patch_size
        full_img_preds = patch_bboxes2full_image([traj_preds], offsets[None],
                                                 np.ones((1, n_valid), bool))
        if cfg.merge_bboxes:
            full_img_preds = merge_boxes_batched(full_img_preds, target=False)
            full_img_targets = list(merge_boxes_batched(full_img_targets, target=True))
        metrics.update(compute_detection_metrics(full_img_preds, full_img_targets))

        # Detector metrics on every positive patch (reference:
        # src/reinforce.py:469-479).
        if dets is not None:
            det_patches, det_targets, det_valid = dets["batch"]
            det_result = dets["batch_det"]
        else:
            det_patches, det_targets, det_valid = self._batched_detection_batches([item])[0]
            det_result = None
        k_valid = det_valid.astype(bool)
        if k_valid.any():
            if det_result is None:
                det_result = self._batched_patch_detections(
                    [{"patches": det_patches, "targets": det_targets, "valid": k_valid}])[0]
            det_head = det_result["head"]
            det_preds = postprocess(
                det_head["boxes"], sigmoid_np(det_head["obj_logits"]),
                sigmoid_np(det_head["cls_logits"]),
                conf_threshold=self.model.detector_conf_threshold, patch_size=cfg.patch_size,
            )
            det_preds = [p for p, v in zip(det_preds, k_valid) if v]
            det_gts = []
            for rows, v in zip(det_targets, k_valid):
                if v:
                    keep = rows[rows[:, 5] == 1]
                    det_gts.append(np.concatenate([keep[:, :1], keep[:, 1:5]], axis=1))
            for name, value in compute_detection_metrics(det_preds, det_gts).items():
                metrics["yolo_" + name] = value
            for name, value in det_result["losses"].items():
                metrics["yolo_" + name] = float(value)
        panel = self._panel(item, boxes, positions[:n_valid], full_img_preds[0]) if plot_traj else None
        return metrics, panel

    def _panel(self, item, boxes, positions, preds) -> dict:
        """The :func:`plot_model_prediction` keywords of one trajectory
        (``reinforce.py:781-793``): the image, the visited patches and
        positions, the true boxes and the full-image predictions ``preds``
        (rows, or None)."""
        return dict(
            image=item["image"], positions=positions,
            patches=gather_patches(item["image"], positions, self.config.patch_size),
            true_bboxes=[BBox(Position(y=b[1], x=b[0]), Position(y=b[3], x=b[2])) for b in boxes],
            predicted_bboxes=parse_bbox_predictions([preds]))

    def test(self, sample_actions: bool = False):
        """Test cycle (reference: src/reinforce.py:364-415;
        ``reinforce.py:796-870``): batched eval rollouts, batched
        detections, per-image metrics; the trajectory panels of up to 6
        images picked by ``visual_rng``; with ``--failure-select-rate``, the
        worst images' panels, each from its own fresh rollout; then
        best-checkpoint tracking, the checkpoints and ``metrics.json``."""
        dataset = copy.copy(self.test_dataset)
        dataset.translations = dataset.rotations = False
        env_ids = self.test_env_ids
        panels = {"model_images": []}
        visual_ids = set(self.visual_rng.choice(
            np.arange(len(env_ids)), size=min(6, len(env_ids)), replace=False).tolist())
        items = [dataset.__getitem__(int(env_id), np.random.default_rng(loop_id))
                 for loop_id, env_id in enumerate(env_ids)]
        rollouts = self._batched_eval_rollouts(
            [{"image": it["image"], "boxes": it["bboxes"]} for it in items], sample_actions)
        dets_list = [None] * len(items)
        if self.config.detection_enabled:
            traj_dets = self._batched_patch_detections(
                [self._traj_det_request(it, ro)[0] for it, ro in zip(items, rollouts)])
            batches = self._batched_detection_batches(items)
            batch_dets = self._batched_patch_detections(
                [{"patches": p, "targets": t, "valid": v} for p, t, v in batches])
            dets_list = [{"traj": td, "batch": b, "batch_det": bd}
                         for td, b, bd in zip(traj_dets, batches, batch_dets)]
        all_metrics = defaultdict(list)
        for loop_id, (item, ro, dets) in enumerate(zip(items, rollouts, dets_list)):
            plot_traj = loop_id in visual_ids
            metrics, panel = self.eval_on_sample(item, plot_traj, sample_actions, ro, dets)
            if plot_traj:
                panels["model_images"].append(panel)
            for name, value in metrics.items():
                all_metrics[name].append(value)

        worst_count = int(self.config.failure_select_rate * len(dataset))
        if worst_count > 0 and all_metrics[self.best_metric_name]:
            worst_ids = self.worst_ids(all_metrics, len(env_ids), worst_count)
            panels["worst_images"] = []
            for worst_id in worst_ids:
                item = dataset.__getitem__(int(np.asarray(env_ids)[worst_id]),
                                           np.random.default_rng(int(worst_id)))
                panels["worst_images"].append(self.eval_on_sample(item, True)[1])

        self.last_test_metrics = all_metrics
        self.record_best_metric(all_metrics)
        self.log_eval(all_metrics, panels, "test")
        self.save_state()
        self.save_metrics()
