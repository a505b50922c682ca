"""The anchor-residual box coder and the axis-aligned BEV IoU of the anchor
heads (counterpart of ``tmae_tpu/ops/box_coder.py:9-106``), in f32 as the
JAX package computes them."""

from __future__ import annotations

import math

import torch


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
