"""SSD3D, the 3DSSD-style single-stage point detector (counterpart of
``tmae_tpu/models/ssd3d.py``): the fusion-sampling PointNet++ backbone
straight from the raw points, then the vote head; the training loss is the
head's, and serving decodes the votes' boxes for the host NMS.
"""

from __future__ import annotations

import torch
from torch import nn

from .point_head_vote import (PointHeadVote, point_coder,
                              point_head_vote_loss, point_head_vote_predict)
from .pointnet2_backbone import PointNet2SAMSG


class SSD3D(nn.Module):
    """PointNet2SAMSG (``backbone_3d``) → PointHeadVote (``point_head``) on
    the batch's ``points`` [B, P, 3 + C] and ``point_mask``. ``cin``: the
    point channels after x, y, z."""

    def __init__(self, cfg, cin: int):
        super().__init__()
        model_cfg = cfg['MODEL']
        self.backbone_3d = PointNet2SAMSG(model_cfg['BACKBONE_3D'], cin)
        self.point_head = PointHeadVote(model_cfg['POINT_HEAD'],
                                        len(cfg['CLASS_NAMES']),
                                        self.backbone_3d.out_channels)

    def forward(self, batch: dict, sample_idx=None):
        """``sample_idx``: the backbone's centres per level, taken instead
        of sampling (:class:`PointNet2SAMSG`). Returns ``head_out``,
        ``backbone_out`` and an ``occ_overflow`` of 0 (no window
        buckets)."""
        pts, mask = batch['points'], batch['point_mask']
        feats = pts[..., 3:] if pts.shape[-1] > 3 else None
        bb = self.backbone_3d(pts[..., :3], mask, feats, sample_idx)
        head = self.point_head(bb['point_coords'], bb['point_mask'],
                               bb['point_features'])
        return {'head_out': head, 'backbone_out': bb,
                'occ_overflow': torch.zeros(1, pts.shape[0],
                                            dtype=torch.int32,
                                            device=pts.device)}


def ssd3d_coder(cfg):
    return point_coder(cfg['MODEL']['POINT_HEAD'])


def ssd3d_loss(cfg, outputs, batch):
    """The vote head's loss. Returns (loss, parts)."""
    return point_head_vote_loss(outputs['head_out'], batch['gt_boxes'],
                                batch['gt_mask'], ssd3d_coder(cfg),
                                cfg['MODEL']['POINT_HEAD'],
                                len(cfg['CLASS_NAMES']))


def ssd3d_predict(cfg, outputs):
    """Each vote's box, best class score, class (1-indexed) and validity:
    dict of [B, K, 7] and [B, K] tensors, in vote order."""
    scores, boxes = point_head_vote_predict(outputs['head_out'],
                                            ssd3d_coder(cfg))
    return {'pred_boxes': boxes[..., :7], 'pred_scores': scores.amax(-1),
            'pred_labels': scores.argmax(-1) + 1,
            'pred_valid': outputs['head_out']['vote_mask']}


def score_sorted_candidates(cfg, pred):
    """The host NMS's candidates from predictions ``pred`` (dict of
    ``pred_boxes``, ``pred_scores``, ``pred_labels``, ``pred_valid``), as
    the reference's class-agnostic NMS takes them before its kernel: the
    valid ones of score >= ``MODEL.POST_PROCESSING.SCORE_THRESH``, sorted
    by score with the valid ones first (a stable sort: equal scores keep
    their order), the top ``NMS_PRE_MAXSIZE`` → (boxes [B, K', 7],
    scores, labels, valid)."""
    post = cfg['MODEL']['POST_PROCESSING']
    scores = pred['pred_scores']
    valid = pred['pred_valid'] & (
        scores >= float(post.get('SCORE_THRESH', 0.0)))
    key = torch.where(valid, scores, float('-inf'))
    order = key.sort(dim=-1, descending=True, stable=True).indices
    order = order[:, :int(post['NMS_CONFIG']['NMS_PRE_MAXSIZE'])]
    take = lambda t: t.gather(1, order if t.dim() == 2 else
                              order[..., None].expand(-1, -1, t.shape[-1]))
    return (take(pred['pred_boxes']), take(scores),
            take(pred['pred_labels']), take(valid))


def ssd3d_candidates(cfg, outputs):
    """:func:`score_sorted_candidates` of the votes' predictions."""
    return score_sorted_candidates(cfg, ssd3d_predict(cfg, outputs))
