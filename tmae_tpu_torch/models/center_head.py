"""CenterHead forward, CenterNet losses and decode (counterpart of
``tmae_tpu/models/center_head.py``: ``SeparateHead``, ``CenterHead``, the
focal / L1 / IoU-head losses of ``center_head_loss`` and
``decode_and_nms``). Rotated NMS runs on the card (``nms_on_device``:
``ops/geometry.nms_keep``), or on the host after the decode
(``models/detectors.host_nms``). The optional IoU head (an ``iou`` entry in
``HEAD_DICT``) rectifies the scores of ``multi_class_nms``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import centernet as C
from ..ops.geometry import nms_keep
from ..ops.losses import centernet_iou_loss
from .layers import BatchNorm2d, ConvBNReLU, conv2d_nhwc


class SeparateHead(nn.Module):
    """Per-target conv stacks: (num_conv - 1) x [Conv3x3-BN-ReLU] + Conv3x3
    with bias, the last in f32."""

    def __init__(self, cin, head_dict: dict, use_bias: bool):
        super().__init__()
        self.head_dict = head_dict
        for name, hc in head_dict.items():
            for k in range(int(hc['num_conv']) - 1):
                self.add_module(f'{name}_conv{k}', ConvBNReLU(
                    cin, cin, kernel=3, use_bias=use_bias, eps=1e-5,
                    momentum=0.1))
            self.add_module(f'{name}_out',
                            nn.Conv2d(cin, int(hc['out_channels']), 3))

    def forward(self, x):
        out = {}
        for name, hc in self.head_dict.items():
            y = x
            for k in range(int(hc['num_conv']) - 1):
                y = getattr(self, f'{name}_conv{k}')(y)
            conv = getattr(self, f'{name}_out')
            out[name] = conv2d_nhwc(y, conv.weight, 1, 1, bias=conv.bias,
                                    dtype=torch.float32)
        return out


class CenterHead(nn.Module):

    def __init__(self, model_cfg, cin):
        super().__init__()
        cfg = model_cfg
        shared = int(cfg['SHARED_CONV_CHANNEL'])
        use_bias = bool(cfg.get('USE_BIAS_BEFORE_NORM', False))
        self.shared_conv = nn.Conv2d(cin, shared, 3, bias=use_bias)
        self.shared_bn = BatchNorm2d(shared, eps=1e-5, momentum=0.1)
        sep = dict(cfg['SEPARATE_HEAD_CFG']['HEAD_DICT'])
        self.heads = []
        for gi, names in enumerate(cfg['CLASS_NAMES_EACH_HEAD']):
            hd = {k: dict(v) for k, v in sep.items()}
            hd['hm'] = {'out_channels': len(names),
                        'num_conv': int(cfg['NUM_HM_CONV'])}
            head = SeparateHead(shared, hd, use_bias)
            self.add_module(f'head_{gi}', head)
            self.heads.append(head)

    def forward(self, spatial_features):
        """[B, H, W, C] → one dict of NHWC maps per head group (f32)."""
        x = conv2d_nhwc(spatial_features, self.shared_conv.weight, 1, 1,
                        bias=self.shared_conv.bias, dtype=torch.float32)
        x = F.relu(self.shared_bn(x))
        return [head(x) for head in self.heads]


def sigmoid_clamped(x):
    return torch.clamp(torch.sigmoid(x), 1e-4, 1 - 1e-4)


def focal_loss_centernet(pred, gt):
    """CornerNet focal loss on clamped sigmoids ``pred`` and gaussian targets
    ``gt`` of the same layout, normalised by the number of centers."""
    pos = (gt == 1.0).to(pred.dtype)
    neg = (gt < 1.0).to(pred.dtype)
    neg_w = torch.pow(1 - gt, 4)
    pos_loss = (torch.log(pred) * torch.square(1 - pred) * pos).sum()
    neg_loss = (torch.log(1 - pred) * torch.square(pred) * neg_w * neg).sum()
    num_pos = pos.sum()
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / num_pos.clamp(min=1.0))


def reg_loss_centernet(pred_maps, inds, targets, mask, code_weights):
    """Masked L1 at the center cells: ``pred_maps`` [B, H, W, D] NHWC,
    ``inds`` [B, M] flat y * W + x, ``targets`` [B, M, D]."""
    pred = C.gather_feat_nhwc(pred_maps, inds)
    m = mask.to(pred.dtype)[..., None]
    num = m.sum().clamp(min=1.0)
    per_dim = ((pred - targets).abs() * m).sum((0, 1)) / num
    return (per_dim * torch.as_tensor(code_weights, dtype=pred.dtype,
                                      device=pred.device)).sum()


def _decode_boxes_at_inds(pd, inds, voxel_size, pc_range,
                          feature_map_stride: int, W: int):
    """Predicted boxes [B, M, 7] decoded from the head maps at the target
    cells ``inds`` (the IoU loss's box reconstruction)."""
    ys = torch.div(inds, W, rounding_mode='floor').float()
    xs = (inds % W).float()
    ctr = C.gather_feat_nhwc(pd['center'], inds)
    cz = C.gather_feat_nhwc(pd['center_z'], inds)[..., 0]
    dims = torch.exp(C.gather_feat_nhwc(pd['dim'], inds))
    rot = C.gather_feat_nhwc(pd['rot'], inds)
    angle = torch.atan2(rot[..., 1], rot[..., 0])
    xs = (xs + ctr[..., 0]) * feature_map_stride * voxel_size[0] + pc_range[0]
    ys = (ys + ctr[..., 1]) * feature_map_stride * voxel_size[1] + pc_range[1]
    return torch.stack([xs, ys, cz, dims[..., 0], dims[..., 1], dims[..., 2],
                        angle], -1)


def center_head_loss(pred_dicts, target_dicts, head_order, loss_weights,
                     iou_cfg=None):
    """Total loss over the head groups and its parts
    ``{hm_loss_head_i, loc_loss_head_i}``, and ``iou_loss_head_i`` when a
    group predicts an ``iou`` map and ``iou_cfg`` (voxel_size, pc_range,
    feature_map_stride) is given: L1 between the iou channel at the target
    cells and 2 IoU3D(decoded boxes, gt boxes) - 1, the boxes detached."""
    total = 0.0
    parts = {}
    for gi, (pd, td) in enumerate(zip(pred_dicts, target_dicts)):
        hm = sigmoid_clamped(pd['hm'])
        hm_loss = focal_loss_centernet(hm, td['heatmap'].permute(0, 2, 3, 1))
        hm_loss = hm_loss * float(loss_weights['cls_weight'])
        reg = torch.cat([pd[k] for k in head_order], dim=-1)
        loc_loss = reg_loss_centernet(
            reg, td['inds'], td['target_boxes'], td['mask'],
            [float(c) for c in loss_weights['code_weights']],
        ) * float(loss_weights['loc_weight'])
        total = total + hm_loss + loc_loss
        parts[f'hm_loss_head_{gi}'] = hm_loss
        parts[f'loc_loss_head_{gi}'] = loc_loss
        if 'iou' in pd and iou_cfg is not None:
            pred_boxes = _decode_boxes_at_inds(
                {k: v.detach() for k, v in pd.items()}, td['inds'],
                iou_cfg['voxel_size'], iou_cfg['pc_range'],
                iou_cfg['feature_map_stride'], pd['hm'].shape[2])
            iou_pred = C.gather_feat_nhwc(pd['iou'], td['inds'])[..., 0]
            iou_loss = centernet_iou_loss(
                iou_pred, td['mask'], pred_boxes, td['iou_boxes'],
            ) * float(loss_weights.get('iou_weight', 1.0))
            total = total + iou_loss
            parts[f'iou_loss_head_{gi}'] = iou_loss
    return total, parts


def decode(pred_dicts, post_cfg, voxel_size, pc_range,
           feature_map_stride: int, class_id_maps,
           nms_on_device: bool = True):
    """Static-shape decode: exact top-K over each group's heatmap logits,
    box decode, range and score filter, then a stable sort by score (for
    ``multi_class_nms``, by the IoU-rectified score
    ``score^(1-r) iou^r`` with the class's rectifier r, and those scores
    are returned). Returns (boxes [B, K', 7], scores, labels 1-indexed,
    valid), candidates score-sorted with the valid ones first; with
    ``nms_on_device``, ``valid`` is also the rotated NMS's keep mask
    (``nms_gpu``: class-agnostic; ``multi_class_nms``: per class, with the
    class's threshold and cap)."""
    nms_cfg = post_cfg['NMS_CONFIG']
    nms_type = str(nms_cfg.get('NMS_TYPE', 'nms_gpu'))
    if nms_type not in ('nms_gpu', 'multi_class_nms'):
        raise NotImplementedError(f'NMS_TYPE {nms_type} is not ported')
    multi_class = nms_type == 'multi_class_nms'
    K = int(post_cfg['MAX_OBJ_PER_SAMPLE'])
    lim = [float(v) for v in post_cfg['POST_CENTER_LIMIT_RANGE']]
    score_thresh = float(post_cfg['SCORE_THRESH'])
    B, H, W, _ = pred_dicts[0]['hm'].shape
    dev = pred_dicts[0]['hm'].device
    lo = torch.tensor(lim[:3], device=dev)
    hi = torch.tensor(lim[3:6], device=dev)
    boxes_all, scores_all, labels_all, valid_all = [], [], [], []
    ious_all = []
    for gi, pd in enumerate(pred_dicts):
        Cg = pd['hm'].shape[-1]
        logits, i_all = C.exact_topk_flat(pd['hm'].reshape(B, H * W * Cg), K)
        scores = torch.sigmoid(logits)
        cls = i_all % Cg
        inds = i_all // Cg
        ys = (inds // W).float()
        xs = (inds % W).float()
        ctr = C.gather_feat_nhwc(pd['center'], inds)
        rot = C.gather_feat_nhwc(pd['rot'], inds)
        cz = C.gather_feat_nhwc(pd['center_z'], inds)[..., 0]
        dims = torch.exp(C.gather_feat_nhwc(pd['dim'], inds))
        angle = torch.atan2(rot[..., 1], rot[..., 0])
        if multi_class and 'iou' in pd:
            # the IoU head's raw channel mapped to [0, 1]
            iou = C.gather_feat_nhwc(pd['iou'], inds)[..., 0]
            ious_all.append(torch.clamp((iou + 1.0) * 0.5, 0.0, 1.0))
        elif multi_class:
            ious_all.append(torch.ones_like(scores))
        xs = (xs + ctr[..., 0]) * feature_map_stride * voxel_size[0] + pc_range[0]
        ys = (ys + ctr[..., 1]) * feature_map_stride * voxel_size[1] + pc_range[1]
        boxes = torch.cat([xs[..., None], ys[..., None], cz[..., None], dims,
                           angle[..., None]], -1)
        ok = (boxes[..., :3] >= lo).all(-1) & (boxes[..., :3] <= hi).all(-1)
        ok &= scores > score_thresh
        gmap = torch.as_tensor(class_id_maps[gi], dtype=torch.long, device=dev)
        labels = gmap[cls.clamp(0, gmap.shape[0] - 1)] + 1
        boxes_all.append(boxes)
        scores_all.append(scores)
        labels_all.append(labels)
        valid_all.append(ok)
    boxes = torch.cat(boxes_all, 1)
    scores = torch.cat(scores_all, 1)
    labels = torch.cat(labels_all, 1)
    valid = torch.cat(valid_all, 1)
    if multi_class:
        rect = torch.tensor([float(r) for r in nms_cfg['IOU_RECTIFIER']],
                            device=dev)
        r = rect[(labels - 1).clamp(0, rect.shape[0] - 1)]
        scores = (torch.pow(scores.clamp(min=1e-8), 1.0 - r)
                  * torch.pow(torch.cat(ious_all, 1).clamp(min=1e-8), r))
    order = torch.argsort(-torch.where(valid, scores, -1.0), dim=1,
                          stable=True)
    take = lambda a: torch.gather(a, 1, order)
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 7))
    scores, labels, valid = take(scores), take(labels), take(valid)
    if nms_on_device:
        if multi_class:
            keep = nms_keep(boxes, valid, nms_cfg['NMS_THRESH'],
                            nms_cfg['NMS_POST_MAXSIZE'], labels=labels)
        else:
            keep = nms_keep(boxes, valid, float(nms_cfg['NMS_THRESH']),
                            int(nms_cfg['NMS_POST_MAXSIZE']))
        valid = valid & keep
    return boxes, scores, labels, valid
