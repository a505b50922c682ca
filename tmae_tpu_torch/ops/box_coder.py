"""Box coders (counterpart of ``tmae_tpu/ops/box_coder.py``), in f32 as the
JAX package computes them: the anchor-residual coder and the axis-aligned
BEV IoU of the anchor heads, and the point-to-box coders of the point heads
(``PointResidualCoder``; ``PointBinResidualCoder``, SSD3D's, with the
heading in bins)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


class ResidualCoder:
    """Anchor-residual encoding: centre offsets over the anchor's BEV
    diagonal (z over its height), log size ratios, the heading difference
    (or its cos / sin differences with ``encode_angle_by_sincos``); extra
    channels as differences."""

    def __init__(self, code_size=7, encode_angle_by_sincos=False):
        self.code_size = code_size + (1 if encode_angle_by_sincos else 0)
        self.encode_angle_by_sincos = encode_angle_by_sincos

    def encode(self, boxes, anchors):
        """boxes [..., 7+], anchors [..., 7+] → [..., code_size]."""
        xa, ya, za, dxa, dya, dza, ra = anchors[..., :7].split(1, -1)
        xg, yg, zg, dxg, dyg, dzg, rg = boxes[..., :7].split(1, -1)
        dxa, dya, dza, dxg, dyg, dzg = (t.clamp(min=1e-5) for t in
                                        (dxa, dya, dza, dxg, dyg, dzg))
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        out = [(xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza,
               torch.log(dxg / dxa), torch.log(dyg / dya),
               torch.log(dzg / dza)]
        if self.encode_angle_by_sincos:
            out += [torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]
        else:
            out.append(rg - ra)
        if boxes.shape[-1] > 7:
            out.append(boxes[..., 7:] - anchors[..., 7:])
        return torch.cat(out, -1)

    def decode(self, encodings, anchors):
        xa, ya, za, dxa, dya, dza, ra = anchors[..., :7].split(1, -1)
        if self.encode_angle_by_sincos:
            xt, yt, zt, dxt, dyt, dzt = encodings[..., :6].split(1, -1)
            cost, sint = encodings[..., 6:7], encodings[..., 7:8]
            extras = encodings[..., 8:]
        else:
            xt, yt, zt, dxt, dyt, dzt, rt = encodings[..., :7].split(1, -1)
            extras = encodings[..., 7:]
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        if self.encode_angle_by_sincos:
            rg = torch.atan2(sint + torch.sin(ra), cost + torch.cos(ra))
        else:
            rg = rt + ra
        out = [xt * diag + xa, yt * diag + ya, zt * dza + za,
               torch.exp(dxt) * dxa, torch.exp(dyt) * dya,
               torch.exp(dzt) * dza, rg]
        if extras.shape[-1]:
            out.append(extras + anchors[..., 7:])
        return torch.cat(out, -1)


def limit_period(val, offset=0.5, period=math.pi):
    """``val`` wrapped into [-offset * period, (1 - offset) * period)."""
    return val - torch.floor(val / period + offset) * period


def aligned_bev_boxes(boxes):
    """[..., 7] → axis-aligned BEV [x1, y1, x2, y2], the sizes swapped when
    the wrapped heading is nearer +-pi/2 than 0."""
    rot = limit_period(boxes[..., 6], 0.5, math.pi).abs()
    swap = rot > math.pi / 4
    dx = torch.where(swap, boxes[..., 4], boxes[..., 3])
    dy = torch.where(swap, boxes[..., 3], boxes[..., 4])
    return torch.stack([boxes[..., 0] - dx / 2, boxes[..., 1] - dy / 2,
                        boxes[..., 0] + dx / 2, boxes[..., 1] + dy / 2], -1)


def nearest_bev_iou(boxes_a, boxes_b):
    """Axis-aligned nearest-BEV IoU [..., N, M] of boxes_a [..., N, 7] and
    boxes_b [..., M, 7]."""
    a = aligned_bev_boxes(boxes_a)[..., :, None, :]
    b = aligned_bev_boxes(boxes_b)[..., None, :, :]
    ix = (torch.minimum(a[..., 2], b[..., 2])
          - torch.maximum(a[..., 0], b[..., 0])).clamp(min=0)
    iy = (torch.minimum(a[..., 3], b[..., 3])
          - torch.maximum(a[..., 1], b[..., 1])).clamp(min=0)
    inter = ix * iy
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter).clamp(min=1e-6)


def _mean_size_of(mean_size, classes, like):
    """The per-class mean sizes ``mean_size`` [num_cls, 3] of the classes
    ``classes`` (1-indexed, clipped to the table): three [...] tensors."""
    table = torch.as_tensor(mean_size, dtype=torch.float32, device=like.device)
    anc = table[(classes.long() - 1).clamp(0, table.shape[0] - 1)]
    return anc[..., 0], anc[..., 1], anc[..., 2]


def _encode_centre_size(mean_size, gt_boxes, points, gt_classes):
    """Centre offsets and log sizes of the point coders: over the class's
    mean-size BEV diagonal (z over its height) and log ratios with
    ``mean_size``, else plain differences and logs."""
    g = torch.cat([gt_boxes[..., :3], gt_boxes[..., 3:6].clamp(min=1e-5),
                   gt_boxes[..., 6:]], -1)
    xg, yg, zg, dxg, dyg, dzg = g[..., :6].unbind(-1)
    xa, ya, za = points[..., :3].unbind(-1)
    if mean_size is None:
        return (xg - xa, yg - ya, zg - za, torch.log(dxg), torch.log(dyg),
                torch.log(dzg))
    dxa, dya, dza = _mean_size_of(mean_size, gt_classes, points)
    diag = torch.sqrt(dxa ** 2 + dya ** 2)
    return ((xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza,
            torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza))


def _decode_centre_size(mean_size, encodings, points, pred_classes):
    xt, yt, zt, dxt, dyt, dzt = encodings[..., :6].unbind(-1)
    xa, ya, za = points[..., :3].unbind(-1)
    if mean_size is None:
        return (xt + xa, yt + ya, zt + za, torch.exp(dxt), torch.exp(dyt),
                torch.exp(dzt))
    dxa, dya, dza = _mean_size_of(mean_size, pred_classes, points)
    diag = torch.sqrt(dxa ** 2 + dya ** 2)
    return (xt * diag + xa, yt * diag + ya, zt * dza + za,
            torch.exp(dxt) * dxa, torch.exp(dyt) * dya, torch.exp(dzt) * dza)


class PointResidualCoder:
    """Point-to-box residuals: centre offsets and log sizes against the
    class's mean size (``use_mean_size``), the heading as cos / sin; extra
    box channels appended as they are."""

    def __init__(self, code_size=8, use_mean_size=True, mean_size=None):
        self.code_size = code_size
        self.mean_size = mean_size if use_mean_size else None

    def encode(self, gt_boxes, points, gt_classes=None):
        """gt_boxes [..., 7+], points [..., 3], gt_classes [...] (1-indexed)
        → [..., 8 (+ extras)]."""
        parts = _encode_centre_size(self.mean_size, gt_boxes, points,
                                    gt_classes)
        rg = gt_boxes[..., 6]
        out = torch.stack([*parts, torch.cos(rg), torch.sin(rg)], -1)
        if gt_boxes.shape[-1] > 7:
            out = torch.cat([out, gt_boxes[..., 7:]], -1)
        return out

    def decode(self, encodings, points, pred_classes=None):
        parts = _decode_centre_size(self.mean_size, encodings, points,
                                    pred_classes)
        rg = torch.atan2(encodings[..., 7], encodings[..., 6])
        out = torch.stack([*parts, rg], -1)
        if encodings.shape[-1] > 8:
            out = torch.cat([out, encodings[..., 8:]], -1)
        return out


class PointBinResidualCoder:
    """Point-to-box coding with the heading in ``angle_bin_num`` bins (a
    one-hot bin and a residual in the bin, as a fraction of it): code size
    6 + 2 bins (+ 2 with velocity)."""

    def __init__(self, angle_bin_num=12, use_mean_size=True, mean_size=None,
                 pred_velo=False, **kwargs):
        self.angle_bin_num = int(angle_bin_num)
        self.pred_velo = bool(pred_velo)
        self.code_size = 6 + 2 * self.angle_bin_num + (2 if pred_velo else 0)
        self.mean_size = mean_size if use_mean_size else None

    def encode_angle(self, angle):
        """angle [...] → (bin one-hot [..., N], the residual in its bin at
        the bin's slot [..., N]); the moduli are floor moduli (``jnp.mod``,
        not ``fmod``)."""
        two_pi = 2 * math.pi
        per = two_pi / self.angle_bin_num
        shifted = torch.remainder(torch.remainder(angle, two_pi) + per / 2,
                                  two_pi)
        cls = torch.floor(shifted / per).long()
        # by comparison, as jax.nn.one_hot: a bin past the last (a shifted
        # angle rounded up to 2 pi) gives no bin, not an error
        one_hot = (cls[..., None] == torch.arange(
            self.angle_bin_num, device=cls.device)).to(torch.float32)
        res = (shifted - (cls.to(shifted.dtype) * per + per / 2)) / per
        return one_hot, one_hot * res[..., None]

    def decode_angle(self, angle_cls, angle_res):
        """(bin logits or one-hot [..., N], residuals [..., N]) → angle
        [...]; an argmax tie takes the first bin."""
        idx = angle_cls.argmax(-1)
        one_hot = F.one_hot(idx, self.angle_bin_num).to(angle_res.dtype)
        res = (one_hot * angle_res).sum(-1)
        per = 2 * math.pi / self.angle_bin_num
        return (idx.to(angle_res.dtype) + res) * per

    def encode(self, gt_boxes, points, gt_classes=None):
        """gt_boxes [..., 7+], points [..., 3], gt_classes [...] (1-indexed)
        → [..., code_size (+ extras)]."""
        parts = _encode_centre_size(self.mean_size, gt_boxes, points,
                                    gt_classes)
        rg_cls, rg_res = self.encode_angle(gt_boxes[..., 6])
        out = torch.cat([torch.stack(parts, -1), rg_cls, rg_res], -1)
        if gt_boxes.shape[-1] > 7:
            out = torch.cat([out, gt_boxes[..., 7:]], -1)
        return out

    def decode(self, encodings, points, pred_classes=None):
        n = self.angle_bin_num
        parts = _decode_centre_size(self.mean_size, encodings, points,
                                    pred_classes)
        rg = self.decode_angle(encodings[..., 6:6 + n],
                               encodings[..., 6 + n:6 + 2 * n])
        out = torch.stack([*parts, rg], -1)
        if self.pred_velo:
            out = torch.cat([out, encodings[..., 6 + 2 * n:8 + 2 * n]], -1)
        return out
