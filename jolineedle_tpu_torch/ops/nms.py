"""Detection postprocess: confidence filtering + class-agnostic NMS.

The numpy half of ``jolineedle_tpu/ops/nms.py`` (lines 22-105), copied as
functions: that module imports JAX at its top. ``nms_mask`` is its
fixed-shape device NMS (``nms.py:107-144``) on tensors.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def sigmoid_np(x) -> np.ndarray:
    """Stable numpy sigmoid for host-side postprocess inputs."""
    x = np.asarray(x, np.float64)
    e = np.exp(-np.abs(x))
    return np.where(x >= 0, 1.0 / (1.0 + e), e / (1.0 + e))


def nms_numpy(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Indices kept by greedy NMS (xyxy boxes), score-descending."""
    boxes = np.asarray(boxes, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores, kind="stable")
    keep = []
    area = np.clip(boxes[:, 2] - boxes[:, 0], 0, None) * np.clip(
        boxes[:, 3] - boxes[:, 1], 0, None
    )
    while order.size > 0:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        iou = inter / np.maximum(area[i] + area[rest] - inter, 1e-12)
        order = rest[iou <= iou_threshold]
    return np.array(keep, dtype=np.int64)


def postprocess(
    boxes_cxcywh: np.ndarray,  # [B, A, 4]
    obj_probs: np.ndarray,  # [B, A]
    cls_probs: np.ndarray,  # [B, A, nc]
    conf_threshold: float,
    nms_threshold: float = 0.45,
    patch_size: Optional[int] = None,
) -> List[Optional[np.ndarray]]:
    """Per-image ``[n, 7]`` arrays (x1, y1, x2, y2, obj, cls_conf, cls_id)
    or None — same contract as upstream postprocess + the reference's clamp
    to the patch (reference: src/models/yolox.py:93-113). NMS runs on the
    UNCLAMPED boxes and the clamp applies after, exactly like the reference
    (upstream postprocess then ``clamp_outputs``) — clamping first would
    change suppression decisions for boxes crossing the patch border."""
    boxes_cxcywh = np.asarray(boxes_cxcywh)
    obj_probs = np.asarray(obj_probs)
    cls_probs = np.asarray(cls_probs)
    B = boxes_cxcywh.shape[0]
    out: List[Optional[np.ndarray]] = []
    for i in range(B):
        cls_conf = cls_probs[i].max(axis=-1)
        cls_id = cls_probs[i].argmax(axis=-1)
        conf = obj_probs[i] * cls_conf
        keep = conf >= conf_threshold
        if not keep.any():
            out.append(None)
            continue
        b = boxes_cxcywh[i][keep]
        xyxy = np.concatenate([b[:, :2] - b[:, 2:4] / 2, b[:, :2] + b[:, 2:4] / 2], -1)
        scores = conf[keep]
        keep_nms = nms_numpy(xyxy, scores, nms_threshold)
        if patch_size is not None:
            xyxy = np.clip(xyxy, 0, patch_size - 1)
        rows = np.concatenate(
            [
                xyxy[keep_nms],
                obj_probs[i][keep][keep_nms, None],
                cls_conf[keep][keep_nms, None],
                cls_id[keep][keep_nms, None].astype(np.float64),
            ],
            axis=-1,
        )
        out.append(rows)
    return out


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """Fixed-shape greedy NMS: the keep mask ``[N]`` of ``[N, 4]`` xyxy
    ``boxes`` with ``[N]`` ``scores`` among the ``[N]`` bool ``valid`` rows
    (``jolineedle_tpu/ops/nms.py:107-144``).

    N iterations, each keeping the best remaining box (the first of tied
    scores) and suppressing the boxes whose IoU with it exceeds the
    threshold. No shape depends on the data and nothing waits for the
    device inside the loop: the pairwise IoU ``[N, N]`` is computed once,
    with each entry's arithmetic that of the JAX ``iou_with`` row."""
    n = boxes.shape[0]
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    xx1 = torch.maximum(x1[:, None], x1[None, :])
    yy1 = torch.maximum(y1[:, None], y1[None, :])
    xx2 = torch.minimum(x2[:, None], x2[None, :])
    yy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = (xx2 - xx1).clamp_min(0) * (yy2 - yy1).clamp_min(0)
    iou = inter / (area[:, None] + area[None, :] - inter).clamp_min(1e-12)
    over = iou > iou_threshold
    idx = torch.arange(n, device=boxes.device)
    remaining = valid.clone()
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    for _ in range(n):
        i = torch.argmax(torch.where(remaining, scores, neg_inf)).reshape(1)
        any_left = remaining.any()
        picked = idx == i
        keep = keep | (picked & any_left)
        suppress = over.index_select(0, i)[0] & any_left
        remaining = remaining & ~suppress & ~picked
    return keep
