"""CenterHead forward and decode (counterpart of
``tmae_tpu/models/center_head.py``: ``SeparateHead``, ``CenterHead`` and
``decode_and_nms(..., nms_on_device=False)``). Rotated NMS runs on the host
(``models/detectors.host_nms``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import centernet as C
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
                    cin, cin, kernel=3, use_bias=use_bias, eps=1e-5))
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
        self.shared_bn = BatchNorm2d(shared, eps=1e-5)
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


def decode(pred_dicts, post_cfg, voxel_size, pc_range,
           feature_map_stride: int, class_id_maps):
    """Static-shape decode: exact top-K over each group's heatmap logits,
    box decode, range and score filter, then a stable sort by score.
    Returns (boxes [B, K', 7], scores, labels 1-indexed, valid), candidates
    score-sorted with the valid ones first."""
    nms_cfg = post_cfg['NMS_CONFIG']
    if str(nms_cfg.get('NMS_TYPE', 'nms_gpu')) != 'nms_gpu':
        raise NotImplementedError('the port decodes for NMS_TYPE nms_gpu')
    K = int(post_cfg['MAX_OBJ_PER_SAMPLE'])
    lim = [float(v) for v in post_cfg['POST_CENTER_LIMIT_RANGE']]
    score_thresh = float(post_cfg['SCORE_THRESH'])
    B, H, W, _ = pred_dicts[0]['hm'].shape
    dev = pred_dicts[0]['hm'].device
    lo = torch.tensor(lim[:3], device=dev)
    hi = torch.tensor(lim[3:6], device=dev)
    boxes_all, scores_all, labels_all, valid_all = [], [], [], []
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
    order = torch.argsort(-torch.where(valid, scores, -1.0), dim=1,
                          stable=True)
    take = lambda a: torch.gather(a, 1, order)
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 7))
    return boxes, take(scores), take(labels), take(valid)
