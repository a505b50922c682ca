"""The two-stage RoI head's pieces (counterpart of
``tmae_tpu/models/roi_head.py``): the proposal layer, the RoI sampler and
its targets in each RoI's canonical frame, the local residual coding, the
decode back to the world, and the RCNN loss.

Wherever the JAX package takes ``jax.lax.top_k`` or ``argsort``, which put
the lower index first among equal values, this module sorts stably
(:func:`top_k_stable`), so ties break the same way on the card and on the
CPU. The sampler's IoU of every RoI against every ground-truth box is one
launch of kernel ``IOU_PAIRS`` a step (``ops/geometry.boxes_iou_pairs``);
its uniform draw comes from a ``torch.Generator`` or is handed in.
"""

from __future__ import annotations

import math

import torch

from ..ops.box_coder import limit_period
from ..ops.geometry import boxes_iou_pairs, nms_keep
from ..ops.losses import corner_loss, weighted_smooth_l1
from ..parallel.dist import global_sum


def _rotate_z(pts, angle):
    """pts [..., 3] turned by ``angle`` [...] about +z."""
    c, s = torch.cos(angle), torch.sin(angle)
    x = pts[..., 0] * c - pts[..., 1] * s
    y = pts[..., 0] * s + pts[..., 1] * c
    return torch.stack([x, y, pts[..., 2]], -1)


def top_k_stable(values, k: int):
    """The ``k`` largest of ``values`` along the last axis, largest first,
    the lower index first among equal values (``jax.lax.top_k``'s order).
    Returns (values, indices)."""
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _take(t, idx):
    """t [B, N, ...] at idx [B, K] → [B, K, ...]."""
    if t.dim() == 2:
        return t.gather(1, idx)
    return t.gather(1, idx.reshape(*idx.shape, *[1] * (t.dim() - 2)).expand(
        *idx.shape, *t.shape[2:]))


def proposal_layer(cls_preds, box_preds, valid, nms_cfg, num_out: int):
    """Class-agnostic proposals: each anchor's best class score, the top
    ``NMS_PRE_MAXSIZE``, greedy rotated NMS at ``NMS_THRESH`` keeping at
    most ``num_out`` (one ``nms_keep`` for every sample), the kept boxes
    moved to the front. cls_preds [B, N, C] (probabilities), box_preds
    [B, N, 7+], valid [B, N] → (rois [B, num_out, 7+], roi_scores (0 where
    none), roi_labels (1-indexed), roi_mask)."""
    B, N, _ = cls_preds.shape
    pre = int(nms_cfg.get('NMS_PRE_MAXSIZE', N))
    scores = cls_preds.amax(-1)
    labels = cls_preds.argmax(-1) + 1
    scores = torch.where(valid, scores, float('-inf'))
    top, order = top_k_stable(scores, min(pre, N))
    boxes = _take(box_preds, order)
    keep = nms_keep(boxes[..., :7], torch.isfinite(top),
                    float(nms_cfg['NMS_THRESH']), num_out)
    rank = keep.long().cumsum(1) - 1
    dest = torch.where(keep & (rank < num_out), rank, num_out)
    D = box_preds.shape[-1]
    rois = box_preds.new_zeros(B, num_out + 1, D).scatter_(
        1, dest[..., None].expand(-1, -1, D), boxes)[:, :num_out]
    rs = torch.full((B, num_out + 1), float('-inf'), dtype=top.dtype,
                    device=top.device).scatter_(1, dest, top)[:, :num_out]
    rl = torch.zeros(B, num_out + 1, dtype=torch.long,
                     device=top.device).scatter_(
        1, dest, _take(labels, order))[:, :num_out]
    mask = torch.isfinite(rs)
    return rois, torch.where(mask, rs, 0.0), rl, mask


def sample_rois_for_rcnn(rois, roi_scores, roi_labels, roi_mask, gt_boxes,
                         gt_mask, sampler_cfg, generator=None, uniform=None):
    """``ROI_PER_IMAGE`` RoIs a sample for the RCNN stage, by priority
    bands: foreground (IoU >= min(REG_FG_THRESH, CLS_FG_THRESH)) up to
    ``FG_RATIO`` of them at random, then hard background (the hard ratio's
    band) over easy background (below CLS_BG_THRESH_LO), then the
    foreground over the quota. ``uniform`` [B, N] in [0, 1) orders each
    band (drawn from ``generator`` when not given). Returns a dict of
    [B, R] tensors: the RoIs, their scores, labels and mask, the ground
    truth each overlaps most and that IoU."""
    R = int(sampler_cfg['ROI_PER_IMAGE'])
    fg_per_img = int(round(float(sampler_cfg['FG_RATIO']) * R))
    reg_fg = float(sampler_cfg['REG_FG_THRESH'])
    fg_thresh = min(reg_fg, float(sampler_cfg['CLS_FG_THRESH']))
    bg_lo = float(sampler_cfg['CLS_BG_THRESH_LO'])
    hard_ratio = float(sampler_cfg.get('HARD_BG_RATIO', 0.8))
    iou = boxes_iou_pairs(rois[..., :7], gt_boxes[..., :7], '3d', roi_mask,
                          gt_mask)
    max_ov = iou.amax(-1)
    assign = iou.argmax(-1)
    fg = (max_ov >= fg_thresh) & roi_mask
    easy_bg = (max_ov < bg_lo) & roi_mask
    hard_bg = ~fg & ~easy_bg & roi_mask & (max_ov < reg_fg)
    r = uniform if uniform is not None else torch.rand(
        max_ov.shape, generator=generator, device=max_ov.device)
    prio = torch.where(
        fg, 3.0 + r,
        torch.where(hard_bg, 1.0 + hard_ratio + r,
                    torch.where(easy_bg, 1.0 + (1.0 - hard_ratio) * r,
                                -1.0)))
    # the foreground over the quota drops below the background bands
    fg_rank = torch.where(fg, r, -1.0)
    if fg_per_img > 0:
        kth = torch.sort(fg_rank, dim=-1).values[..., -fg_per_img, None]
        prio = torch.where(fg & (fg_rank < kth), 0.5 + r, prio)
    top, sel = top_k_stable(prio, R)
    return {'rois': _take(rois, sel), 'roi_scores': _take(roi_scores, sel),
            'roi_labels': _take(roi_labels, sel),
            'roi_mask': _take(roi_mask, sel) & (top > 0.0),
            'gt_of_rois_src': _take(gt_boxes, _take(assign, sel)),
            'gt_iou_of_rois': _take(max_ov, sel)}


def assign_roi_targets(rois, roi_scores, roi_labels, roi_mask, gt_boxes,
                       gt_mask, sampler_cfg, generator=None, uniform=None):
    """The sampled RoIs (:func:`sample_rois_for_rcnn`) and their targets:
    ``reg_valid_mask`` (IoU > REG_FG_THRESH), ``rcnn_cls_labels`` by
    ``CLS_SCORE_TYPE`` (-1 ignored) and ``gt_of_rois``, each RoI's ground
    truth in the RoI's canonical frame."""
    t = sample_rois_for_rcnn(rois, roi_scores, roi_labels, roi_mask,
                             gt_boxes, gt_mask, sampler_cfg, generator,
                             uniform)
    ious = t['gt_iou_of_rois']
    t['reg_valid_mask'] = (ious > float(sampler_cfg['REG_FG_THRESH'])) & \
        t['roi_mask']
    score_type = sampler_cfg.get('CLS_SCORE_TYPE', 'roi_iou')
    fg_t = float(sampler_cfg['CLS_FG_THRESH'])
    bg_t = float(sampler_cfg['CLS_BG_THRESH'])
    if score_type == 'cls':
        labels = torch.where(ious > fg_t, 1.0, 0.0)
        labels = torch.where((ious > bg_t) & (ious < fg_t), -1.0, labels)
    elif score_type == 'roi_iou':
        labels = torch.where(ious > fg_t, 1.0, torch.where(
            ious < bg_t, 0.0, (ious - bg_t) / (fg_t - bg_t)))
    else:
        raise NotImplementedError(score_type)
    t['rcnn_cls_labels'] = torch.where(t['roi_mask'], labels, -1.0)
    gt, rr = t['gt_of_rois_src'], t['rois']
    roi_ry = limit_period(rr[..., 6], offset=0.5, period=2 * math.pi)
    ctr = _rotate_z(gt[..., :3] - rr[..., :3], -roi_ry)
    heading = limit_period(gt[..., 6] - roi_ry, offset=0.5, period=math.pi)
    t['gt_of_rois'] = torch.cat([ctr, gt[..., 3:6], heading[..., None]], -1)
    return t


def _zeroed(rois, channels):
    """A copy of rois [..., 7+] with ``channels`` set to 0."""
    out = rois.clone()
    out[..., list(channels)] = 0.0
    return out


def encode_local_residuals(gt_of_rois, rois, coder):
    """Regression targets of the canonical ground truth against each RoI
    at the origin with heading 0."""
    return coder.encode(gt_of_rois[..., :7],
                        _zeroed(rois[..., :7], (0, 1, 2, 6)))


def decode_rcnn_boxes(rcnn_reg, rois, coder):
    """The RCNN residuals decoded against each RoI at the origin (with its
    heading), then turned by the RoI's heading and moved to its centre:
    world boxes [..., 7+]."""
    local = coder.decode(rcnn_reg, _zeroed(rois[..., :7], (0, 1, 2)))
    ctr = _rotate_z(local[..., :3], rois[..., 6]) + rois[..., :3]
    return torch.cat([ctr, local[..., 3:]], -1)


def roi_head_loss(rcnn_cls, rcnn_reg, targets, coder, loss_cfg):
    """Binary cross-entropy over the labelled RoIs, weighted smooth-L1 on
    the local residuals and, with ``CORNER_LOSS_REGULARIZATION``, the
    corner loss of the decoded boxes, both over the foreground RoIs (the
    background's residuals are not decoded); the counts are those of the
    global batch under data parallelism. Returns (loss, parts)."""
    lw = loss_cfg['LOSS_WEIGHTS']
    labels = targets['rcnn_cls_labels']
    cls_valid = (labels >= 0).float()
    logits = rcnn_cls[..., 0]
    bce = (logits.clamp(min=0) - logits * labels
           + torch.log1p(torch.exp(-logits.abs())))
    cls_loss = ((bce * cls_valid).sum()
                / global_sum(cls_valid.sum()).clamp(min=1.0)
                * float(lw['rcnn_cls_weight']))
    fg = targets['reg_valid_mask'].float()
    n_fg = global_sum(fg.sum()).clamp(min=1.0)
    reg_targets = encode_local_residuals(targets['gt_of_rois'],
                                         targets['rois'], coder)
    reg_l = weighted_smooth_l1(rcnn_reg, reg_targets[..., :rcnn_reg.shape[-1]],
                               weights=fg,
                               code_weights=lw.get('code_weights'))
    reg_loss = reg_l.sum() / n_fg * float(lw['rcnn_reg_weight'])
    total = cls_loss + reg_loss
    parts = {'rcnn_loss_cls': cls_loss, 'rcnn_loss_reg': reg_loss}
    if loss_cfg.get('CORNER_LOSS_REGULARIZATION', False):
        # the foreground RoIs' corners only, as the reference selects them:
        # a background RoI's residuals may decode to a box of infinite size,
        # or its RoI be so large that a corner's distance overflows; a
        # product with the mask would keep their NaN, and so would the
        # gradient of a decode of their residuals
        keep = targets['reg_valid_mask']
        decoded = decode_rcnn_boxes(torch.where(keep[..., None], rcnn_reg,
                                                0.0), targets['rois'], coder)
        corner = corner_loss(decoded[..., :7],
                             targets['gt_of_rois_src'][..., :7])
        corner_l = (torch.where(keep, corner, 0.0).sum() / n_fg
                    * float(lw['rcnn_corner_weight']))
        total = total + corner_l
        parts['rcnn_loss_corner'] = corner_l
    parts['rcnn_loss'] = total
    return total, parts
