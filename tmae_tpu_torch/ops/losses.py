"""Losses of the heads (counterpart of ``tmae_tpu/ops/losses.py``): the
weighted smooth-L1, the 3D box corners and the corner loss, and the
IoU-head loss."""

from __future__ import annotations

import math

import torch

from ..parallel.dist import global_sum
from .geometry import boxes_iou3d_aligned


def weighted_smooth_l1(pred, target, weights=None, beta: float = 1.0 / 9.0,
                       code_weights=None):
    """Elementwise smooth-L1 of ``pred - target`` [..., D] (quadratic below
    ``beta``), times per-code weights [D] and per-row ``weights`` [...].
    Returns [..., D]."""
    diff = pred - target
    if code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=diff.dtype,
                                      device=diff.device)
    ad = diff.abs()
    loss = torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


_CORNERS = ((1, 1, -1), (1, -1, -1), (-1, -1, -1), (-1, 1, -1),
            (1, 1, 1), (1, -1, 1), (-1, -1, 1), (-1, 1, 1))


def boxes_to_corners_3d(boxes):
    """[..., 7] → the 8 corners [..., 8, 3]: bottom face then top, in the
    box's heading."""
    tmpl = torch.tensor(_CORNERS, dtype=boxes.dtype, device=boxes.device) / 2.0
    local = tmpl * boxes[..., None, 3:6]
    c = torch.cos(boxes[..., 6])[..., None]
    s = torch.sin(boxes[..., 6])[..., None]
    rx = local[..., 0] * c - local[..., 1] * s
    ry = local[..., 0] * s + local[..., 1] * c
    return torch.stack([rx, ry, local[..., 2]], -1) + boxes[..., None, 0:3]


def corner_loss(pred_boxes, gt_boxes, beta: float = 1.0):
    """The mean over the 8 corners of the smooth-L1 (Huber, ``beta``) of
    each corner's distance, against the ground truth and against it turned
    by pi, the smaller of the two: pred / gt [..., 7] → [...]."""
    pc = boxes_to_corners_3d(pred_boxes)
    flipped = torch.cat([gt_boxes[..., :6], gt_boxes[..., 6:7] + math.pi],
                        -1)

    def huber(d):
        ad = torch.linalg.vector_norm(d, dim=-1)
        return torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)

    return torch.minimum(
        huber(pc - boxes_to_corners_3d(gt_boxes)).mean(-1),
        huber(pc - boxes_to_corners_3d(flipped)).mean(-1))


def centernet_iou_loss(iou_pred, mask, pred_boxes, gt_boxes):
    """L1 between the predicted IoU channel ``iou_pred`` [B, M] and
    ``2 IoU3D(pred_boxes, gt_boxes) - 1`` at the positive slots ``mask``
    [B, M]; boxes [B, M, 7]. The target carries no gradient (the aligned
    IoU: ``IOU_ALIGNED`` on the card). Normalised by the positive slots of
    the global batch."""
    m = mask.to(iou_pred.dtype)
    with torch.no_grad():
        target = 2.0 * boxes_iou3d_aligned(pred_boxes, gt_boxes) - 1.0
    l1 = (iou_pred - target).abs() * m
    return l1.sum() / global_sum(m.sum()).clamp(min=1e-4)
