"""The IoU-head loss (counterpart of ``tmae_tpu/ops/losses.py``'s
``centernet_iou_loss``)."""

from __future__ import annotations

import torch

from .geometry import boxes_iou3d_aligned


def centernet_iou_loss(iou_pred, mask, pred_boxes, gt_boxes):
    """L1 between the predicted IoU channel ``iou_pred`` [B, M] and
    ``2 IoU3D(pred_boxes, gt_boxes) - 1`` at the positive slots ``mask``
    [B, M]; boxes [B, M, 7]. The target carries no gradient (the aligned
    IoU: ``IOU_ALIGNED`` on the card)."""
    m = mask.to(iou_pred.dtype)
    with torch.no_grad():
        target = 2.0 * boxes_iou3d_aligned(pred_boxes, gt_boxes) - 1.0
    l1 = (iou_pred - target).abs() * m
    return l1.sum() / m.sum().clamp(min=1e-4)
