"""Inference and eval CLI of the port: ``python -m jolineedle_tpu_torch.infer``.

The counterpart of ``infer.py:44-229`` with the same flags. It loads
``config.json`` and the best checkpoint from ``--model-dir`` (the port's
``checkpoint_best.pt`` or, from a JAX run directory,
``checkpoint_best.msgpack``), then ``--detection-checkpoint`` (a JAX msgpack
of the detector's weights) if given, pads each image
to a patch multiple, runs one sampled rollout per image, detects on the
visited patches, moves the boxes to full-image coordinates and prints, per
image, the objects found, the steps and the latency, then the mean metrics
over the images that have targets.

``infer_image`` is the per-image body on numpy arrays (no PIL), so a script
can serve images it made itself. A ``config.json`` that sets
``--no-recurrent-embedding`` serves through the full-prefix rollout.
``--output-dir`` (trajectory plots) is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import os
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .checkpoint import load_detection_params, load_model_file, model_file
from .config import config_from_file
from .data.dataset import complete_to_patch_size
from .env.actions import get_actions_info
from .env.oracle import gather_patches
from .models.gpt import GPT
from .ops.nms import postprocess, sigmoid_np
from .train.rollout import compute_rollout_metrics, eval_rollout, to_numpy
from .utils.metrics import compute_detection_metrics, patch_bboxes2full_image


def get_infer_args(args=None):
    parser = argparse.ArgumentParser(
        description="Inference and test script for JoliNeedle (PyTorch/CUDA port)"
    )
    parser.add_argument(
        "--model-dir", required=True,
        help="Model directory, used to load the model checkpoint",
    )
    parser.add_argument("--input-images", nargs="*", help="Input images to perform inference on")
    parser.add_argument("--dataset", help="Dataset over which perform tests and compute metrics")
    parser.add_argument("--output-dir", help="Output directory for images, metrics...")
    parser.add_argument(
        "--track-object", action="store_true",
        help="Kept for parity with the reference CLI; a no-op there too",
    )
    parser.add_argument(
        "--detection-checkpoint", type=str,
        help="Load detection model from a separate checkpoint file",
    )
    return parser.parse_args(args)


def load_bboxes(bbox_fname):
    """bbox txt lines 'class x1 y1 x2 y2' -> [n, 4]."""
    bboxes = []
    with open(bbox_fname) as bbox_file:
        for line in bbox_file:
            parts = line.strip().split()
            if len(parts) >= 5:
                bboxes.append([int(float(i)) for i in parts[1:5]])
    return np.array(bboxes, np.float32).reshape(-1, 4)


def load_model_dir(model_dir, device=None, detection_checkpoint=None):
    """(train_config, model_config, GPT with the best checkpoint) of a model
    directory, the port's (``checkpoint_best.pt``) or the JAX package's
    (``checkpoint_best.msgpack``), on ``device`` (default: the GPU), in eval
    mode; then the detector's weights from ``detection_checkpoint``, which
    turns detection on (``infer.py:102-104``). A directory with both files
    raises."""
    train_config, model_config = config_from_file(os.path.join(model_dir, "config.json"))
    if isinstance(getattr(train_config, "filter_classes", None), list):
        train_config.filter_classes = set(train_config.filter_classes)
    model = GPT.from_config(model_config, get_actions_info(train_config), device=device)
    path = model_file(model_dir, best=True)
    if path is None:
        raise FileNotFoundError(f"{model_dir} holds neither checkpoint_best.pt nor"
                                " checkpoint_best.msgpack")
    load_model_file(model, path)
    if detection_checkpoint is not None:
        load_detection_params(detection_checkpoint, model)
        train_config.detection_enabled = True
    return train_config, model_config, model.eval()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def infer_image(
    model,
    train_config,
    image: np.ndarray,
    boxes: Optional[np.ndarray],
    seed: int,
    warm_up: bool = False,
) -> dict:
    """Serve one ``[H, W, 3]`` uint8 image: pad, roll out (sampled, with a
    generator seeded by ``seed``), detect on the visited patches and, when
    ``boxes`` ``[n, 4]`` are given, score.

    Returns the rollout (numpy, batch of 1), ``positions``, ``n_valid``,
    the full-image predictions, ``obj_count``, ``metrics`` (or None),
    ``rollout_ms`` (the rollout alone, as ``infer.py:165-169`` times it) and
    ``request_ms`` (rollout, detection and postprocess). ``warm_up`` runs the
    rollout once first, outside both times.
    """
    dev = model.device
    patch_size = train_config.patch_size
    request_start = time.perf_counter()
    image = complete_to_patch_size(image, patch_size)
    has_targets = boxes is not None
    boxes = np.zeros((0, 4), np.float32) if boxes is None else boxes
    # Static box cap, as the JAX CLI: the rollout's shapes do not depend on
    # the box count.
    n_cap = max(int(getattr(train_config, "max_boxes", 8)), 1)
    boxes_padded = np.zeros((1, n_cap, 4), np.float32)
    boxes_padded[0, : min(len(boxes), n_cap)] = boxes[:n_cap]
    images_d = torch.tensor(image[None], device=dev)

    def run():
        gen = torch.Generator(device=dev).manual_seed(seed)
        return eval_rollout(model, images_d, boxes_padded, train_config, sample=True,
                            generator=gen, device=dev)

    if warm_up:
        run()
        _sync(dev)
        request_start = time.perf_counter()
    start = time.perf_counter()
    ro = to_numpy(run())
    rollout_ms = (time.perf_counter() - start) * 1000

    positions = ro["positions"][0]
    n_valid = int(ro["masks"][0].sum())
    patches = gather_patches(image, positions[:n_valid], patch_size)

    full_img_preds = [None]
    if train_config.detection_enabled:
        with torch.no_grad():
            head, _ = model.yolox_outputs(torch.from_numpy(patches).to(dev))
        head = {k: v.cpu().numpy() for k, v in head.items()}
        traj_preds = postprocess(
            head["boxes"],
            sigmoid_np(head["obj_logits"]),
            sigmoid_np(head["cls_logits"]),
            conf_threshold=model.detector_conf_threshold,
            patch_size=patch_size,
        )
        offsets = positions[:n_valid][:, [1, 0]] * patch_size
        full_img_preds = patch_bboxes2full_image(
            [traj_preds], offsets[None], np.ones((1, n_valid), bool)
        )
    request_ms = (time.perf_counter() - request_start) * 1000

    metrics = None
    if has_targets:
        metrics = compute_rollout_metrics(ro, train_config)
        full_img_targets = [
            np.concatenate([np.zeros((len(boxes), 1)), boxes.astype(np.float64)], axis=1)
        ]
        metrics.update(compute_detection_metrics(full_img_preds, full_img_targets))
    return {
        "rollout": ro,
        "positions": positions,
        "n_valid": n_valid,
        "preds": full_img_preds[0],
        "obj_count": 0 if full_img_preds[0] is None else len(full_img_preds[0]),
        "metrics": metrics,
        "rollout_ms": rollout_ms,
        "request_ms": request_ms,
    }


def infer(args, device=None):
    """The CLI body: every image of ``--dataset`` and ``--input-images``."""
    if args.output_dir:
        raise NotImplementedError(
            "--output-dir (trajectory plots) is not yet ported to jolineedle_tpu_torch"
        )
    device = resolve_device(device)
    train_config, _, model = load_model_dir(args.model_dir, device, args.detection_checkpoint)

    image_paths, target_paths = [], []
    if args.dataset:
        # Relative entries resolve against the list file's directory.
        base = os.path.dirname(os.path.abspath(args.dataset))
        with open(args.dataset) as dset_file:
            for line in dset_file:
                parts = line.strip().split()
                image_paths.append(parts[0] if os.path.isabs(parts[0])
                                   else os.path.join(base, parts[0]))
                target_paths.append(parts[1] if os.path.isabs(parts[1])
                                    else os.path.join(base, parts[1]))
    if args.input_images:
        image_paths += args.input_images

    from PIL import Image

    all_metrics = defaultdict(list)
    for img_id, image_path in enumerate(image_paths):
        print("Processing image %d/%d %s" % (img_id + 1, len(image_paths), image_path))
        image = np.asarray(Image.open(image_path).convert("RGB"))
        boxes = load_bboxes(target_paths[img_id]) if img_id < len(target_paths) else None
        out = infer_image(model, train_config, image, boxes, seed=img_id, warm_up=img_id == 0)
        print("Found %d objects in %d steps and %0.2fms"
              % (out["obj_count"], out["positions"].shape[0], out["rollout_ms"]))
        if out["metrics"] is not None:
            for name, value in out["metrics"].items():
                all_metrics[name].append(float(value))

    if len(target_paths) > 0:
        for name, values in all_metrics.items():
            print("%s: %0.3f" % (name, np.mean(values)))
    return all_metrics


if __name__ == "__main__":
    infer(get_infer_args())
