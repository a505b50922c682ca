"""GraphRCNN without cameras (counterpart of ``tmae_tpu/models/
graph_rcnn.py``): the SECONDNet first stage (MeanVFE, VoxelBackBone8x,
BaseBEVBackbone, AnchorHeadSingle), class-agnostic proposals, the RoI
sampler when training, and the second stage: each RoI's DFVS pool of
points (``ops/roi_pool.roilocal_dfvs_pool3d``: kernel ``DFPS`` on the
card), a k-NN graph over them, a stack of edge convolutions with channel
calibration (``AttnGNNLayer``), and the RCNN class and box outputs.

Kernels on the card: ``NMS_MASK`` and ``NMS_SCAN`` (the proposals' NMS),
``IOU_PAIRS`` (the sampler, training only) and ``DFPS`` (the pool). The
k-NN and the pool's point-in-box test are torch ops: the JAX package has
no Pallas kernel for them.

The camera branch (``IMG_CONFIG``, ``IMG_BACKBONE``, a batch's
``images``) is not ported: building or running it raises.

Random draws: the sampler's uniform draw and the shortcut's dropout come
from the generators handed to the forward (``generators``, the training
step's, seeded from the seed and the step) or are handed in, as the tests
hand over the JAX package's draw and keep masks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.box_coder import ResidualCoder
from ..ops.roi_pool import roilocal_dfvs_pool3d
from .anchor_head import anchor_head_loss, anchor_head_predict
from .layers import LinearBNReLU, MaskedBatchNorm
from .point_head_vote import enlarge_box3d
from .roi_head import (assign_roi_targets, decode_rcnn_boxes,
                       proposal_layer, roi_head_loss)
from .second_net import SECONDNet
from .ssd3d import score_sorted_candidates

CAMERA_REFUSAL = ('GraphRCNN\'s camera path (IMG_CONFIG, IMG_BACKBONE, '
                  'images) is not ported yet (ROADMAP.md, queue 1: the '
                  'camera path)')
DROPOUT = 0.1  # ShortcutLayer's, fixed as in the JAX package


def _knn_idx(x, k: int):
    """x [N, T, C] → the indices [N, T, k] of each token's k nearest
    tokens by squared L2 (itself included), nearest first, the lower index
    first among equal distances (the JAX package's top_k of -d2)."""
    d2 = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    return torch.sort(d2, dim=-1, stable=True).indices[..., :k]


def _graph_feature(x, idx):
    """x [N, T, C], idx [N, T, k] → edge features [N, T, k, 2C]: each
    neighbour less the centre, then the centre."""
    N, T, C = x.shape
    k = idx.shape[-1]
    flat = idx + torch.arange(N, device=x.device)[:, None, None] * T
    nbr = x.reshape(N * T, C)[flat.reshape(-1)].reshape(N, T, k, C)
    ctr = x[:, :, None, :].expand(N, T, k, C)
    return torch.cat([nbr - ctr, ctr], -1)


def dropout(x, keep=None, generator=None, rate: float = DROPOUT):
    """flax's ``nn.Dropout``: kept values scaled by 1 / (1 - rate), the
    rest 0; ``keep`` (bools of x's shape) handed in or drawn uniform <
    1 - rate from ``generator``."""
    if keep is None:
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class ShortcutLayer(nn.Module):
    """Residual MLP block over per-RoI vectors: x + dropout(x), masked BN,
    Linear-ReLU-dropout-Linear, a dropped residual add, masked BN
    (dropout in train mode only)."""

    def __init__(self, channels: int, hidden: int):
        super().__init__()
        self.norm1 = MaskedBatchNorm(channels)
        self.conv1 = nn.Linear(channels, hidden)
        self.conv2 = nn.Linear(hidden, channels)
        self.norm2 = MaskedBatchNorm(channels)

    def forward(self, x, mask, keep=None, generator=None):
        """``keep``: the three dropout keep masks (x's, the hidden's, the
        residual's), or None to draw them from ``generator``."""
        drop = ((lambda i, v: dropout(v, None if keep is None else keep[i],
                                      generator))
                if self.training else (lambda i, v: v))
        x = x + drop(0, x)
        x = self.norm1(x, mask)
        h = drop(1, F.relu(self.conv1(x)))
        x = x + drop(2, self.conv2(h))
        return self.norm2(x, mask)


class AttnGNNLayer(nn.Module):
    """Edge convolutions over a k-NN graph of each RoI's pooled points
    (the graph of the coordinates, or of the features each layer with
    ``USE_FEATS_DIS``), their outputs concatenated, a sigmoid channel
    gate, the expansion MLPs, a max over the RoI's points, then the
    reduction and the shortcut block."""

    def __init__(self, cfg, cin: int):
        super().__init__()
        self.cfg = cfg
        self.k = int(cfg['K'])
        widths = [int(w) for w in cfg['MLPS']]
        c = cin
        for li, w in enumerate(widths):
            setattr(self, f'edge{li}', LinearBNReLU(2 * c, w))
            c = w
        self.num_edge = len(widths)
        cat = sum(widths)
        self.calib0 = LinearBNReLU(cat, int(cfg['CALIB_DIM']))
        self.calib1 = nn.Linear(int(cfg['CALIB_DIM']), cat)
        c = cat
        exps = [int(w) for w in cfg['EXP_MLPS']]
        for wi, w in enumerate(exps):
            setattr(self, f'exp{wi}', LinearBNReLU(c, w))
            c = w
        self.num_exp = len(exps)
        self.use_reduction = bool(cfg.get('USE_REDUCTION', True))
        out = int(cfg['OUT_DIM'])
        if self.use_reduction:
            self.reduction = LinearBNReLU(c, out)
            c = out
        self.use_short_cut = bool(cfg.get('USE_SHORT_CUT', True))
        if self.use_short_cut:
            self.shortcut = ShortcutLayer(out, out)
        self.out_channels = c

    def forward(self, xyz, feats, roi_mask, keep=None, generator=None):
        """xyz [B, M, K, 3], feats [B, M, K, C], roi_mask [B, M] →
        [B, M, out_channels]."""
        B, M, K, _ = xyz.shape
        k = self.k
        x = torch.cat([xyz, feats], -1).reshape(B * M, K, -1)
        tok = roi_mask.reshape(B * M, 1).expand(B * M, K)
        edge_mask = tok.repeat_interleave(k, 1)
        by_feats = bool(self.cfg.get('USE_FEATS_DIS', False))
        idx = None if by_feats else _knn_idx(xyz.reshape(B * M, K, 3), k)
        outs = []
        for li in range(self.num_edge):
            e = _graph_feature(x, idx if idx is not None else _knn_idx(x, k))
            e = getattr(self, f'edge{li}')(e.reshape(B * M, K * k, -1),
                                           edge_mask)
            x = e.reshape(B * M, K, k, -1).amax(2)
            outs.append(x)
        x = torch.cat(outs, -1)
        g = self.calib1(self.calib0(x, tok))
        x = torch.sigmoid(g) * x
        for wi in range(self.num_exp):
            x = getattr(self, f'exp{wi}')(x, tok)
        x = torch.where(tok[..., None], x, float('-inf')).amax(1)
        x = torch.where(roi_mask.reshape(B * M, 1), x, 0.0).reshape(B, M, -1)
        if self.use_reduction:
            x = self.reduction(x, roi_mask)
        if self.use_short_cut:
            x = self.shortcut(x, roi_mask, keep, generator)
        return x


class GraphRCNNHead(nn.Module):
    """The DFVS pool of each (enlarged) RoI, each pooled point given the
    RoI's corner extents, AttnGNNLayer, a shared LinearBNReLU(256), and
    the class and box outputs (``rcnn_cls`` [B, M, 1], ``rcnn_reg`` [B, M,
    code_size]). ``num_point_features``: x, y, z and the point features."""

    def __init__(self, roi_cfg, num_point_features: int, num_class: int = 1):
        super().__init__()
        if roi_cfg.get('IMG_CONFIG'):
            raise NotImplementedError(CAMERA_REFUSAL)
        self.cfg = roi_cfg
        self.attn_gnn = AttnGNNLayer(roi_cfg['ATTN_GNN_CONFIG'],
                                     num_point_features + 6)
        self.shared_fc = LinearBNReLU(self.attn_gnn.out_channels, 256)
        code_size = int(roi_cfg['TARGET_CONFIG'].get(
            'BOX_CODER_CONFIG', {}).get('code_size', 7))
        self.cls_out = nn.Linear(256, num_class)
        self.reg_out = nn.Linear(256, code_size)

    def forward(self, points, point_mask, rois, roi_mask, keep=None,
                generator=None):
        dfvs = self.cfg['DFVS_CONFIG']
        width = float(dfvs.get('POOL_EXTRA_WIDTH', 1.0))
        pooled, empty = roilocal_dfvs_pool3d(
            points, point_mask, enlarge_box3d(rois[..., :7], [width] * 3),
            roi_mask, num_dvs_points=int(dfvs.get('NUM_DVS_POINTS', 256)),
            num_fps_points=int(dfvs.get('NUM_FPS_POINTS', 64)))
        half = rois[..., 3:6] / 2
        corners = torch.cat([-half, half], -1)
        B, M, K, _ = pooled.shape
        pooled = torch.cat([pooled, corners[:, :, None].expand(B, M, K, 6)],
                           -1)
        live = roi_mask & ~empty
        pooled = torch.where(live[..., None, None], pooled, 0.0)
        feats = self.attn_gnn(pooled[..., :3], pooled[..., 3:], live, keep,
                              generator)
        x = self.shared_fc(feats, roi_mask)
        return self.cls_out(x), self.reg_out(x)


class GraphRCNN(SECONDNet):
    """SECONDNet's first stage (``vfe``, ``backbone_3d``, ``backbone_2d``,
    ``dense_head``) → proposals → (training: the RoI sampler) →
    GraphRCNNHead (``roi_head``)."""

    rng_streams = ('proposal', 'dropout')

    def __init__(self, cfg, spec, num_point_features):
        if cfg['MODEL'].get('IMG_BACKBONE'):
            raise NotImplementedError(CAMERA_REFUSAL)
        super().__init__(cfg, spec, num_point_features)
        self.roi_cfg = cfg['MODEL']['ROI_HEAD']
        self.roi_head = GraphRCNNHead(self.roi_cfg, num_point_features)

    def forward(self, batch: dict, generators=None, proposals=None,
                roi_uniform=None, dropout_keep=None):
        """Returns the first stage's outputs and ``rois``, ``roi_scores``,
        ``roi_labels``, ``roi_mask``, ``roi_targets`` (training) and
        ``rcnn_cls`` / ``rcnn_reg``. ``generators``: {'proposal': ...,
        'dropout': ...} for the training draws; ``proposals`` (rois,
        scores, labels, mask), ``roi_uniform`` [B, N] and ``dropout_keep``
        (the shortcut's three keep masks) are taken as given instead."""
        if 'images' in batch:
            raise NotImplementedError(CAMERA_REFUSAL)
        gens = generators or {}
        out = super().forward(batch)
        cls_preds, box_preds = anchor_head_predict(self.dense_head,
                                                   out['anchor_outputs'])
        cls_preds = torch.sigmoid(cls_preds).detach()
        box_preds = box_preds.detach()
        nms_cfg = self.roi_cfg['NMS_CONFIG']['TRAIN' if self.training
                                             else 'TEST']
        if proposals is None:
            proposals = proposal_layer(
                cls_preds, box_preds,
                torch.ones(cls_preds.shape[:2], dtype=torch.bool,
                           device=cls_preds.device),
                nms_cfg, int(nms_cfg['NMS_POST_MAXSIZE']))
        rois, roi_scores, roi_labels, roi_mask = proposals
        targets = None
        if self.training:
            targets = assign_roi_targets(
                rois, roi_scores, roi_labels, roi_mask, batch['gt_boxes'],
                batch['gt_mask'], self.roi_cfg['TARGET_CONFIG'],
                generator=gens.get('proposal'), uniform=roi_uniform)
            rois, roi_mask = targets['rois'], targets['roi_mask']
        rcnn_cls, rcnn_reg = self.roi_head(
            batch['points'], batch['point_mask'], rois, roi_mask,
            dropout_keep, gens.get('dropout'))
        out.update(rois=rois, roi_scores=roi_scores, roi_labels=roi_labels,
                   roi_mask=roi_mask, roi_targets=targets, rcnn_cls=rcnn_cls,
                   rcnn_reg=rcnn_reg)
        return out


def rcnn_coder(cfg) -> ResidualCoder:
    return ResidualCoder(int(cfg['MODEL']['ROI_HEAD']['TARGET_CONFIG'].get(
        'BOX_CODER_CONFIG', {}).get('code_size', 7)))


def graph_rcnn_predict(cfg, outputs):
    """The final boxes: the RCNN residuals decoded against the RoIs, score
    sqrt(sigmoid(rcnn_cls) * roi_score), the proposals' labels, valid
    where the RoI is; dict of [B, M, 7] and [B, M] tensors, in RoI
    order."""
    boxes = decode_rcnn_boxes(outputs['rcnn_reg'], outputs['rois'][..., :7],
                              rcnn_coder(cfg))
    cls = torch.sigmoid(outputs['rcnn_cls'][..., 0])
    scores = torch.sqrt((cls * outputs['roi_scores']).clamp(min=0.0))
    return {'pred_boxes': boxes[..., :7],
            'pred_scores': torch.where(outputs['roi_mask'], scores, 0.0),
            'pred_labels': outputs['roi_labels'],
            'pred_valid': outputs['roi_mask']}


def graph_rcnn_candidates(cfg, outputs):
    """The host NMS's candidates (the reference's post-processing): the
    predictions of score >= ``SCORE_THRESH``, sorted by score with the
    valid ones first, the top ``NMS_PRE_MAXSIZE``."""
    return score_sorted_candidates(cfg, graph_rcnn_predict(cfg, outputs))


def graph_rcnn_loss(cfg, dense_head, outputs, batch):
    """The first stage's anchor loss (unless ``FREEZE_LAYERS``) plus the
    RCNN loss. Returns (loss, parts)."""
    model_cfg = cfg['MODEL']
    total, parts = 0.0, {}
    if model_cfg.get('FREEZE_LAYERS') is None:
        rpn_targets = dense_head.assign_targets(batch['gt_boxes'],
                                                batch['gt_mask'])
        total, parts = anchor_head_loss(
            dense_head, outputs['anchor_outputs'], rpn_targets,
            model_cfg['DENSE_HEAD']['LOSS_CONFIG'])
        parts = dict(parts)
    rcnn, rcnn_parts = roi_head_loss(
        outputs['rcnn_cls'], outputs['rcnn_reg'], outputs['roi_targets'],
        rcnn_coder(cfg), model_cfg['ROI_HEAD']['LOSS_CONFIG'])
    parts.update(rcnn_parts)
    return total + rcnn, parts
