"""SimOTA label assignment and the YOLOX detection losses, in PyTorch.

The counterpart of ``jolineedle_tpu/ops/simota.py``: a dense ``[B, G, A]``
computation with validity masks instead of upstream YOLOX's data-dependent
candidate sets. Non-candidates get a huge cost, the dynamic top-k becomes a
rank comparison (a double argsort, stable as ``jnp.argsort`` is), and padded
ground truths and padded patches are masked. The shapes are fixed, so
nothing here waits on the card.

Kept from the JAX module: the strict edge comparisons (an anchor centre on
a box or centre-region edge is outside, ``simota.py:34-35``), and the
gradient that flows through ``matched_iou`` into the classification target
(``simota.py:163, 218``; upstream YOLOX detaches it, the JAX package does
not). Losses: iou (1 - IoU^2), objectness, classification and L1, with
reg weight 5, each normalised by the foreground count.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.mesh import global_count

CENTER_RADIUS = 2.5
HIGH_COST = 100000.0
TOPK_CANDIDATES = 10


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    xy, wh = boxes[..., :2], boxes[..., 2:4]
    return torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x1y1, x2y2 = boxes[..., :2], boxes[..., 2:4]
    return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=-1)


def iou_cxcywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of broadcastable cxcywh boxes ``a [..., 4]`` and ``b [..., 4]``
    (the arithmetic of ``pairwise_iou_cxcywh``, ``simota.py:48-59``)."""
    ax, bx = cxcywh_to_xyxy(a), cxcywh_to_xyxy(b)
    lt = torch.maximum(ax[..., :2], bx[..., :2])
    rb = torch.minimum(ax[..., 2:4], bx[..., 2:4])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = a[..., 2].clamp_min(0) * a[..., 3].clamp_min(0)
    area_b = b[..., 2].clamp_min(0) * b[..., 3].clamp_min(0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-12), torch.zeros_like(inter))


def _bce_logits(logits, targets):
    """Elementwise binary cross-entropy with logits (stable)."""
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _bce_probs(p, targets, eps=1e-8):
    p = p.clamp(eps, 1 - eps)
    return -(targets * torch.log(p) + (1 - targets) * torch.log(1 - p))


def simota_assign(
    pred_boxes: torch.Tensor,  # [B, A, 4] cxcywh pixels (decoded)
    obj_logits: torch.Tensor,  # [B, A]
    cls_logits: torch.Tensor,  # [B, A, nc]
    gt_boxes: torch.Tensor,  # [B, G, 4] cxcywh pixels
    gt_classes: torch.Tensor,  # [B, G] int
    gt_valid: torch.Tensor,  # [B, G] bool
    grids: torch.Tensor,  # [A, 2] (x, y)
    strides: torch.Tensor,  # [A]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (fg_mask [B, A], matched_gt [B, A] int64, matched_iou [B, A]),
    the batched form of ``simota.py:74-164``."""
    A = pred_boxes.shape[1]
    G = gt_boxes.shape[1]
    nc = cls_logits.shape[-1]

    centers = (grids + 0.5) * strides[:, None]  # [A, 2]
    cx, cy = centers[None, None, :, 0], centers[None, None, :, 1]  # [1, 1, A]
    gt_xyxy = cxcywh_to_xyxy(gt_boxes)  # [B, G, 4]
    in_box = (
        (cx > gt_xyxy[..., 0:1]) & (cx < gt_xyxy[..., 2:3])
        & (cy > gt_xyxy[..., 1:2]) & (cy < gt_xyxy[..., 3:4])
    )  # [B, G, A]
    r = CENTER_RADIUS * strides[None, None, :]
    in_center = (
        (cx > gt_boxes[..., 0:1] - r) & (cx < gt_boxes[..., 0:1] + r)
        & (cy > gt_boxes[..., 1:2] - r) & (cy < gt_boxes[..., 1:2] + r)
    )
    valid = gt_valid[..., None]  # [B, G, 1]
    candidate = (in_box | in_center) & valid
    strong = in_box & in_center
    union = candidate.any(1, keepdim=True)  # [B, 1, A]

    ious = iou_cxcywh(gt_boxes[:, :, None, :], pred_boxes[:, None, :, :])  # [B, G, A]
    iou_cost = -torch.log(ious + 1e-8)

    cls_prob = torch.sigmoid(cls_logits) * torch.sigmoid(obj_logits)[..., None]
    cls_prob = torch.sqrt(cls_prob.clamp(0, 1))  # [B, A, nc]
    gt_onehot = F.one_hot(gt_classes.long(), nc).to(cls_prob.dtype)  # [B, G, nc]
    pair_cls_cost = _bce_probs(cls_prob[:, None], gt_onehot[:, :, None]).sum(-1)  # [B, G, A]

    cost = (
        pair_cls_cost
        + 3.0 * iou_cost
        + HIGH_COST * (~strong).float()
        + 1e9 * (~(union & valid)).float()
    )

    masked_ious = torch.where(union, ious, torch.zeros_like(ious))
    topk_ious = masked_ious.topk(min(TOPK_CANDIDATES, A), dim=-1).values
    dynamic_k = topk_ious.sum(-1).to(torch.int32).clamp_min(1)  # [B, G]

    order = torch.argsort(cost, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    matching = (rank < dynamic_k[..., None]) & union & valid  # [B, G, A]

    n_matches = matching.sum(1, keepdim=True)  # [B, 1, A]
    best_gt = cost.argmin(1)  # [B, A]
    only_best = F.one_hot(best_gt, G).transpose(1, 2).bool()  # [B, G, A]
    matching = torch.where(n_matches > 1, only_best, matching)

    fg_mask = matching.any(1)
    matched_gt = matching.to(torch.uint8).argmax(1)  # first match; 0 where none (gated)
    matched_iou = (matching * ious).sum(1)
    return fg_mask, matched_gt, matched_iou


def yolox_losses(
    head_out: Dict[str, torch.Tensor],
    targets: torch.Tensor,  # [B, N, 6] rows (cls, x1, y1, x2, y2, obj), local px
    patch_valid: Optional[torch.Tensor] = None,  # [B] bool (padded patches)
    with_assignment: bool = False,
) -> Dict[str, torch.Tensor]:
    """Batched SimOTA losses (``simota.py:167-243``): ``total_loss``,
    ``iou_loss``, ``l1_loss``, ``conf_loss``, ``cls_loss``, ``num_fg``.
    Rows whose obj column is not 1 are padding; ``patch_valid`` masks padded
    patches. ``with_assignment`` adds ``fg_mask``, ``matched_gt`` and
    ``matched_iou``. Inside ``parallel.mesh.data_parallel`` ``num_fg``, the
    denominator of every loss, is the global batch's."""
    boxes = head_out["boxes"]
    obj_logits = head_out["obj_logits"]
    cls_logits = head_out["cls_logits"]
    raw_reg = head_out["raw_reg"]
    grids, strides = head_out["grids"], head_out["strides"]
    B = boxes.shape[0]
    if patch_valid is None:
        patch_valid = torch.ones(B, dtype=torch.bool, device=boxes.device)

    gt_cls = targets[..., 0].to(torch.int32)
    gt_xyxy = targets[..., 1:5].float()
    gt_valid = (targets[..., 5] > 0.5) & patch_valid[:, None]
    gt_cxcywh = xyxy_to_cxcywh(gt_xyxy)

    fg_mask, matched_gt, matched_iou = simota_assign(
        boxes, obj_logits, cls_logits, gt_cxcywh, gt_cls, gt_valid, grids, strides
    )
    fg_mask = fg_mask & patch_valid[:, None]
    fg = fg_mask.float()
    # Global over the ranks inside parallel.mesh.data_parallel (simota.py:198).
    num_fg = global_count(fg.sum()).clamp_min(1.0)

    matched_boxes = torch.gather(gt_cxcywh, 1, matched_gt[..., None].expand(-1, -1, 4))
    matched_cls = torch.gather(gt_cls, 1, matched_gt)  # [B, A]

    iou = iou_cxcywh(matched_boxes, boxes)
    loss_iou = ((1.0 - iou**2) * fg).sum() / num_fg

    obj_bce = _bce_logits(obj_logits, fg)
    loss_obj = (obj_bce * patch_valid[:, None].float()).sum() / num_fg

    nc = cls_logits.shape[-1]
    cls_target = F.one_hot(matched_cls.long(), nc).float() * matched_iou[..., None]
    cls_bce = _bce_logits(cls_logits, cls_target).sum(-1)
    loss_cls = (cls_bce * fg).sum() / num_fg

    l1_target = torch.cat(
        [
            matched_boxes[..., :2] / strides[None, :, None] - grids[None],
            torch.log(matched_boxes[..., 2:4].clamp_min(1e-8) / strides[None, :, None]),
        ],
        dim=-1,
    )
    loss_l1 = ((raw_reg - l1_target).abs().sum(-1) * fg).sum() / num_fg

    total = 5.0 * loss_iou + loss_obj + loss_cls + loss_l1
    out = {
        "total_loss": total,
        "iou_loss": loss_iou,
        "l1_loss": loss_l1,
        "conf_loss": loss_obj,
        "cls_loss": loss_cls,
        "num_fg": num_fg,
    }
    if with_assignment:
        out.update(fg_mask=fg_mask, matched_gt=matched_gt, matched_iou=matched_iou)
    return out
