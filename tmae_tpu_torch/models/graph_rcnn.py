"""GraphRCNN (counterpart of ``tmae_tpu/models/graph_rcnn.py``): the
SECONDNet first stage (MeanVFE, VoxelBackBone8x, BaseBEVBackbone,
AnchorHeadSingle), class-agnostic proposals, the RoI sampler when
training, and the second stage: each RoI's DFVS pool of points
(``ops/roi_pool.roilocal_dfvs_pool3d``: kernel ``DFPS`` on the card), a
k-NN graph over them, a stack of edge convolutions with channel
calibration (``AttnGNNLayer``), and the RCNN class and box outputs.

The camera branch (``MODEL.IMG_BACKBONE`` with ``ROI_HEAD.IMG_CONFIG``):
DLASeg (``models/dla.py``) runs on the batch's ``images``, the head's
``img_conv*`` 1x1 convolutions (``IMG_CONFIG.MLPS``) follow, and each
pooled point, carried back to the world from its RoI's frame, takes the
image features at its pixel (``models/point_sample.py``, with F16's
scale), concatenated before the RoI's corner extents. As in the JAX
package, a config with ``IMG_BACKBONE`` but no ``IMG_CONFIG`` runs DLASeg
and leaves its features unused, and ``IMG_CONFIG`` without
``IMG_BACKBONE`` has no image branch.

Kernels on the card: ``NMS_MASK`` and ``NMS_SCAN`` (the proposals' NMS),
``IOU_PAIRS`` (the sampler, training only) and ``DFPS`` (the pool); with
cameras ``DCN_COLS``, ``DCN_COORD_BWD`` and ``BILINEAR_GRAD`` (DLASeg's
DCNv2) and ``POINT_SAMPLE`` (and ``BILINEAR_GRAD`` in its backward). The
k-NN and the pool's point-in-box test are torch ops: the JAX package has
no Pallas kernel for them.

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
from .dla import DLASeg
from .layers import LinearBNReLU, MaskedBatchNorm, conv2d_nhwc
from .point_sample import point_sample
from .point_head_vote import enlarge_box3d
from .roi_head import (assign_roi_targets, decode_rcnn_boxes,
                       proposal_layer, roi_head_loss)
from .second_net import SECONDNet
from .ssd3d import score_sorted_candidates

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
    """The DFVS pool of each (enlarged) RoI, with ``image_channels`` and
    ``IMG_CONFIG`` each pooled point's image features, each pooled point
    given the RoI's corner extents, AttnGNNLayer, a shared
    LinearBNReLU(256), and the class and box outputs (``rcnn_cls`` [B, M,
    1], ``rcnn_reg`` [B, M, code_size]). ``num_point_features``: x, y, z
    and the point features; ``image_channels``: the width of the image
    features handed in (0: no image branch)."""

    def __init__(self, roi_cfg, num_point_features: int, num_class: int = 1,
                 image_channels: int = 0):
        super().__init__()
        self.cfg = roi_cfg
        self.img_cfg = roi_cfg.get('IMG_CONFIG') if image_channels else None
        cin = num_point_features + 6
        if self.img_cfg:
            c = image_channels
            self.img_mlps = [int(w) for w in self.img_cfg.get('MLPS', [])]
            for ci, w in enumerate(self.img_mlps):
                setattr(self, f'img_conv{ci}', nn.Conv2d(c, w, 1, bias=False))
                c = w
            cin += c
        self.attn_gnn = AttnGNNLayer(roi_cfg['ATTN_GNN_CONFIG'], cin)
        self.shared_fc = LinearBNReLU(self.attn_gnn.out_channels, 256)
        code_size = int(roi_cfg['TARGET_CONFIG'].get(
            'BOX_CODER_CONFIG', {}).get('code_size', 7))
        self.cls_out = nn.Linear(256, num_class)
        self.reg_out = nn.Linear(256, code_size)

    def image_features(self, pooled, rois, image_inputs):
        """The image features [B, M, K, C] at the pooled points [B, M, K,
        3+] (canonical in their RoI's frame) through ``img_conv*``."""
        feats2d = image_inputs['image_features']
        for ci in range(len(self.img_mlps)):
            feats2d = F.relu(conv2d_nhwc(
                feats2d, getattr(self, f'img_conv{ci}').weight,
                dtype=torch.float32))
        c = torch.cos(rois[..., 6])[..., None]
        s = torch.sin(rois[..., 6])[..., None]
        cx = pooled[..., 0] * c - pooled[..., 1] * s
        cy = pooled[..., 0] * s + pooled[..., 1] * c
        world = torch.stack([cx, cy, pooled[..., 2]], -1) + rois[..., None, :3]
        B, M, K, _ = world.shape
        feats, _ = point_sample(
            world.reshape(B, M * K, 3), feats2d,
            image_inputs['trans_lidar_to_cam'],
            image_inputs['trans_cam_to_img'], image_inputs['image_shape'],
            image_inputs['image_scale'],
            feat_stride=int(self.img_cfg.get('FEAT_STRIDE', 4)),
            aug_inverse=image_inputs.get('aug_inverse'),
            image_flip=image_inputs.get('image_flip'))
        return feats.reshape(B, M, K, -1)

    def forward(self, points, point_mask, rois, roi_mask, keep=None,
                generator=None, image_inputs=None):
        """``image_inputs``: ``image_features`` [B, Hf, Wf, C] and the
        batch's ``trans_lidar_to_cam``, ``trans_cam_to_img``,
        ``image_shape``, ``image_scale`` (``aug_inverse`` and
        ``image_flip`` where it has them); needed with an image branch."""
        dfvs = self.cfg['DFVS_CONFIG']
        width = float(dfvs.get('POOL_EXTRA_WIDTH', 1.0))
        pooled, empty = roilocal_dfvs_pool3d(
            points, point_mask, enlarge_box3d(rois[..., :7], [width] * 3),
            roi_mask, num_dvs_points=int(dfvs.get('NUM_DVS_POINTS', 256)),
            num_fps_points=int(dfvs.get('NUM_FPS_POINTS', 64)))
        if self.img_cfg:
            if image_inputs is None:
                raise ValueError('GraphRCNNHead with IMG_CONFIG needs the '
                                 'image inputs')
            pooled = torch.cat(
                [pooled, self.image_features(pooled, rois, image_inputs)], -1)
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
    GraphRCNNHead (``roi_head``); with ``IMG_BACKBONE``, DLASeg
    (``img_backbone``) on the batch's ``images``."""

    rng_streams = ('proposal', 'dropout')

    def __init__(self, cfg, spec, num_point_features):
        super().__init__(cfg, spec, num_point_features)
        self.roi_cfg = cfg['MODEL']['ROI_HEAD']
        img_cfg = cfg['MODEL'].get('IMG_BACKBONE')
        self.img_backbone = DLASeg(img_cfg) if img_cfg else None
        self.roi_head = GraphRCNNHead(
            self.roi_cfg, num_point_features,
            image_channels=(self.img_backbone.out_channels
                            if self.img_backbone else 0))

    def image_inputs(self, batch: dict):
        """DLASeg's features of the batch's ``images`` [B, H, W, 3] and the
        camera keys the head reads."""
        if 'images' not in batch:
            raise ValueError('GraphRCNN with IMG_BACKBONE needs the batch\'s '
                             'images (DATA_CONFIG.CAMERA_CONFIG)')
        out = {'image_features': self.img_backbone(batch['images'])}
        for k in ('trans_lidar_to_cam', 'trans_cam_to_img', 'image_shape',
                  'image_scale', 'aug_inverse', 'image_flip'):
            if k in batch:
                out[k] = batch[k]
        return out

    def forward(self, batch: dict, generators=None, proposals=None,
                roi_uniform=None, dropout_keep=None):
        """Returns the first stage's outputs and ``rois``, ``roi_scores``,
        ``roi_labels``, ``roi_mask``, ``roi_targets`` (training) and
        ``rcnn_cls`` / ``rcnn_reg``. ``generators``: {'proposal': ...,
        'dropout': ...} for the training draws; ``proposals`` (rois,
        scores, labels, mask), ``roi_uniform`` [B, N] and ``dropout_keep``
        (the shortcut's three keep masks) are taken as given instead."""
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
        image_inputs = (self.image_inputs(batch) if self.img_backbone
                        else None)
        rcnn_cls, rcnn_reg = self.roi_head(
            batch['points'], batch['point_mask'], rois, roi_mask,
            dropout_keep, gens.get('dropout'), image_inputs)
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
