"""Anchor-based dense head of the SECOND and PointPillars families
(counterpart of ``tmae_tpu/models/anchor_head.py:22-275``): static anchors
per class, the axis-aligned target assignment as one masked argmax, the
sigmoid focal, smooth-L1 (sin-difference) and direction losses, and the
decode.

Layout: the head's maps are ``[B, H, W, A * k]`` with the ``A`` anchors of
a location in class order (each class's sizes and rotations), so the flat
anchor axis is location-major: location, then class, then the class's
anchors. Targets follow it, and so do the anchors the loss and the decode
read (:meth:`AnchorHeadSingle.anchors_flat`), as the reference's
``torch.cat(self.anchors, dim=-3)`` orders them. (The JAX package's
``all_anchors_flat`` orders them class-major, which pairs a location's
predictions with another location's anchors once there are two classes:
ROADMAP.md, F10.)
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.box_coder import ResidualCoder, limit_period, nearest_bev_iou
from ..parallel import dist
from .layers import conv2d_nhwc


def generate_anchors(anchor_cfgs, grid_size, pc_range):
    """Per class, the anchors [H, W, Z * S * R, 7] (numpy f32) of the
    feature map ``grid_size // feature_map_stride`` (the JAX package's
    ``generate_anchors``)."""
    nx, ny = int(grid_size[0]), int(grid_size[1])
    out = []
    for cfg in anchor_cfgs:
        stride = int(cfg.get('feature_map_stride', 1))
        fx, fy = nx // stride, ny // stride
        sizes = np.asarray(cfg['anchor_sizes'], np.float32)
        rots = np.asarray(cfg['anchor_rotations'], np.float32)
        heights = np.asarray(cfg['anchor_bottom_heights'], np.float32)
        if bool(cfg.get('align_center', False)):
            x_stride = (pc_range[3] - pc_range[0]) / fx
            y_stride = (pc_range[4] - pc_range[1]) / fy
            x_off, y_off = x_stride / 2, y_stride / 2
        else:
            x_stride = (pc_range[3] - pc_range[0]) / (fx - 1)
            y_stride = (pc_range[4] - pc_range[1]) / (fy - 1)
            x_off = y_off = 0.0
        xs = pc_range[0] + x_off + np.arange(fx) * x_stride
        ys = pc_range[1] + y_off + np.arange(fy) * y_stride
        S, R, Z = len(sizes), len(rots), len(heights)
        anc = np.zeros((fy, fx, Z, S, R, 7), np.float32)
        anc[..., 0] = xs[None, :, None, None, None]
        anc[..., 1] = ys[:, None, None, None, None]
        anc[..., 2] = (heights[None, None, :, None, None]
                       + sizes[None, None, None, :, 2] / 2)
        anc[..., 3:6] = sizes[None, None, None, :, None, :]
        anc[..., 6] = rots[None, None, None, None, :]
        out.append(anc.reshape(fy, fx, Z * S * R, 7))
    return out


def assign_anchor_targets(anchors_flat, gt_boxes, gt_mask, gt_labels,
                          class_id, matched_t, unmatched_t, coder):
    """Axis-aligned assignment of one anchor class over a batch:
    anchors_flat [A, 7], gt_boxes [B, M, 7+], gt_mask / gt_labels [B, M].
    Returns labels [B, A] (-1 ignored, 0 background, ``class_id``
    foreground), reg_targets [B, A, code] and weights [B, A]. An anchor is
    positive at IoU >= ``matched_t`` with its best box, or when it reaches
    some box's best IoU exactly (ties: every such anchor; a box's best IoU
    of 0 forces none); argmax ties take the first box; a sample without a
    box of the class labels every anchor 0."""
    in_class = gt_mask & (gt_labels == class_id)
    iou = nearest_bev_iou(anchors_flat[None], gt_boxes[..., :7])
    iou = torch.where(in_class[:, None, :], iou, -1.0)
    any_gt = in_class.any(1, keepdim=True)
    a2g_max, a2g_idx = iou.max(2)
    g2a_max = iou.max(1, keepdim=True).values
    g2a_max = torch.where(g2a_max == 0, -1.0, g2a_max)
    force = ((iou == g2a_max) & in_class[:, None, :]
             & (g2a_max > 0)).any(2)
    pos = (a2g_max >= matched_t) | force
    neg = (a2g_max < unmatched_t) & ~force
    labels = torch.where(pos, class_id, torch.where(neg, 0, -1))
    labels = torch.where(any_gt, labels, 0)
    tgt = torch.gather(gt_boxes, 1, a2g_idx[..., None].expand(
        -1, -1, gt_boxes.shape[-1]))
    reg = coder.encode(tgt, anchors_flat[None].expand(tgt.shape[0], -1, -1))
    fg = pos & any_gt
    return labels, torch.where(fg[..., None], reg, 0.0), fg.float()


def sigmoid_focal_loss(preds, one_hot, weights, gamma=2.0, alpha=0.25):
    """Sigmoid focal loss per anchor and class, times ``weights`` [B, A]."""
    p = torch.sigmoid(preds)
    alpha_w = one_hot * alpha + (1 - one_hot) * (1 - alpha)
    pt = one_hot * (1 - p) + (1 - one_hot) * p
    bce = (preds.clamp(min=0) - preds * one_hot
           + torch.log1p(torch.exp(-preds.abs())))
    return alpha_w * pt.pow(gamma) * bce * weights[..., None]


def smooth_l1(diff, beta=1.0 / 9.0):
    ad = diff.abs()
    return torch.where(ad < beta, 0.5 * ad ** 2 / beta, ad - 0.5 * beta)


class AnchorHeadSingle(nn.Module):
    """1x1 convolutions with bias giving the class, box and (with
    ``USE_DIRECTION_CLASSIFIER``) direction maps, in f32 as flax's
    ``nn.Conv`` computes them from the bf16 map."""

    def __init__(self, model_cfg, cin, class_names, grid_size, pc_range):
        super().__init__()
        self.model_cfg = model_cfg
        self.class_names = list(class_names)
        self.num_class = len(self.class_names)
        anchors = generate_anchors(model_cfg['ANCHOR_GENERATOR_CONFIG'],
                                   grid_size, pc_range)
        self.per_class = [a.shape[2] for a in anchors]
        self.map_hw = anchors[0].shape[:2]
        self.num_anchors_per_loc = sum(self.per_class)
        # location-major: [H, W, A, 7], each location's anchors in class
        # order
        self.register_buffer(
            'anchors', torch.from_numpy(np.concatenate(anchors, 2)),
            persistent=False)
        box_cfg = model_cfg.get('TARGET_ASSIGNER_CONFIG', {}).get(
            'BOX_CODER_CONFIG', {})
        self.coder = ResidualCoder(
            7, bool(box_cfg.get('encode_angle_by_sincos', False)))
        A = self.num_anchors_per_loc
        self.conv_cls = nn.Conv2d(cin, A * self.num_class, 1)
        self.conv_box = nn.Conv2d(cin, A * self.coder.code_size, 1)
        self.use_dir = bool(model_cfg.get('USE_DIRECTION_CLASSIFIER', False))
        if self.use_dir:
            self.num_dir_bins = int(model_cfg.get('NUM_DIR_BINS', 2))
            self.conv_dir = nn.Conv2d(cin, A * self.num_dir_bins, 1)

    def forward(self, x):
        convs = [('cls_preds', self.conv_cls), ('box_preds', self.conv_box)]
        if self.use_dir:
            convs.append(('dir_cls_preds', self.conv_dir))
        return {k: conv2d_nhwc(x, c.weight, bias=c.bias, dtype=torch.float32)
                for k, c in convs}

    def anchors_flat(self):
        """[H * W * A, 7] in the maps' order."""
        return self.anchors.reshape(-1, 7)

    def assign_targets(self, gt_boxes, gt_mask):
        """gt_boxes [B, M, 8] (class 1-indexed last), gt_mask [B, M] →
        ``box_cls_labels`` [B, H*W*A], ``box_reg_targets`` [B, H*W*A,
        code], ``reg_weights`` [B, H*W*A], in the maps' order."""
        ta = self.model_cfg['ANCHOR_GENERATOR_CONFIG']
        B = gt_boxes.shape[0]
        H, W = self.map_hw
        labels = gt_boxes[..., 7].long()
        out, lo = [], 0
        for cfg, a in zip(ta, self.per_class):
            flat = self.anchors[:, :, lo:lo + a].reshape(-1, 7)
            lo += a
            cls_id = self.class_names.index(cfg['class_name']) + 1
            lab, reg, w = assign_anchor_targets(
                flat, gt_boxes.float(), gt_mask, labels, cls_id,
                float(cfg['matched_threshold']),
                float(cfg['unmatched_threshold']), self.coder)
            out.append((lab.reshape(B, H, W, a),
                        reg.reshape(B, H, W, a, -1), w.reshape(B, H, W, a)))
        lab, reg, w = zip(*out)
        return {'box_cls_labels': torch.cat(lab, -1).reshape(B, -1),
                'box_reg_targets': torch.cat(reg, -2).reshape(
                    B, -1, self.coder.code_size),
                'reg_weights': torch.cat(w, -1).reshape(B, -1)}


def anchor_head_loss(head: AnchorHeadSingle, outputs, targets, loss_cfg):
    """Focal class loss over the cared anchors, smooth-L1 box loss with the
    sin-difference heading over the positives and, with the direction
    classifier, its cross-entropy over the positives; each over the
    sample's positives (at least 1) and the batch (under data parallelism
    the global batch). Returns (loss, parts)."""
    B = outputs['cls_preds'].shape[0]
    n_batch = B * dist.world()
    C = head.num_class
    cls_preds = outputs['cls_preds'].reshape(B, -1, C)
    box_preds = outputs['box_preds'].reshape(B, -1, head.coder.code_size)
    labels = targets['box_cls_labels']
    positives = labels > 0
    cared = (labels >= 0).float()
    pos_norm = positives.sum(1, keepdim=True).float().clamp(min=1.0)
    cls_weights = cared / pos_norm
    one_hot = F.one_hot(labels.clamp(min=0), C + 1)[..., 1:].float()
    lw = loss_cfg['LOSS_WEIGHTS']
    cls_loss = (sigmoid_focal_loss(cls_preds, one_hot, cls_weights).sum()
                / n_batch * lw['cls_weight'])
    reg_weights = positives.float() / pos_norm
    rt0 = targets['box_reg_targets']
    bp = torch.cat([box_preds[..., :6],
                    torch.sin(box_preds[..., 6:7]) * torch.cos(rt0[..., 6:7]),
                    box_preds[..., 7:]], -1)
    rt = torch.cat([rt0[..., :6],
                    torch.cos(box_preds[..., 6:7]) * torch.sin(rt0[..., 6:7]),
                    rt0[..., 7:]], -1)
    code_w = torch.tensor(lw['code_weights'][:head.coder.code_size],
                          dtype=torch.float32, device=bp.device)
    reg = smooth_l1(bp - rt) * code_w
    loc_loss = ((reg.sum(-1) * reg_weights).sum() / n_batch
                * lw['loc_weight'])
    total = cls_loss + loc_loss
    parts = {'rpn_loss_cls': cls_loss, 'rpn_loss_loc': loc_loss}
    if head.use_dir and 'dir_cls_preds' in outputs:
        nb = head.num_dir_bins
        dir_offset = float(head.model_cfg.get('DIR_OFFSET', 0.78539))
        rot_gt = rt0[..., 6] + head.anchors_flat()[None, :, 6]
        offset_rot = limit_period(rot_gt - dir_offset, 0, 2 * math.pi)
        dir_targets = (offset_rot / (2 * math.pi / nb)).long().clamp(0, nb - 1)
        dir_preds = outputs['dir_cls_preds'].reshape(B, -1, nb)
        ce = -(F.log_softmax(dir_preds, -1)
               * F.one_hot(dir_targets, nb).float()).sum(-1)
        dir_loss = (ce * reg_weights).sum() / n_batch * lw['dir_weight']
        total = total + dir_loss
        parts['rpn_loss_dir'] = dir_loss
    return total, parts


def anchor_head_predict(head: AnchorHeadSingle, outputs):
    """(class logits [B, A, num_class], decoded boxes [B, A, 7]); with the
    direction classifier the heading is folded into its bin's period."""
    B = outputs['cls_preds'].shape[0]
    cls_preds = outputs['cls_preds'].reshape(B, -1, head.num_class)
    box_preds = outputs['box_preds'].reshape(B, -1, head.coder.code_size)
    boxes = head.coder.decode(box_preds, head.anchors_flat()[None])
    if head.use_dir and 'dir_cls_preds' in outputs:
        dir_offset = float(head.model_cfg.get('DIR_OFFSET', 0.78539))
        dir_limit = float(head.model_cfg.get('DIR_LIMIT_OFFSET', 0.0))
        nb = head.num_dir_bins
        dir_labels = outputs['dir_cls_preds'].reshape(B, -1, nb).argmax(-1)
        period = 2 * math.pi / nb
        rot = limit_period(boxes[..., 6] - dir_offset, dir_limit, period)
        boxes = torch.cat([boxes[..., :6], (
            rot + dir_offset + period * dir_labels.to(boxes.dtype))[..., None],
            boxes[..., 7:]], -1)
    return cls_preds, boxes
