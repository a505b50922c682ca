"""2D BEV backbones on NHWC maps (counterpart of ``tmae_tpu/models/bev.py``):
``SSTBEVBackbone``, 3x3 Conv-BN-ReLU blocks with shortcut adds;
``BaseBEVBackbone``, per-level strided conv stacks whose outputs are
upsampled (``DeconvBNReLU``) or downsampled and concatenated (SECOND,
PointPillars); ``HeightCompression``, the depth axis folded into the
channels."""

from __future__ import annotations

import torch
from torch import nn

from .layers import ConvBNReLU, DeconvBNReLU


class SSTBEVBackbone(nn.Module):

    def __init__(self, model_cfg, cin):
        super().__init__()
        self.shortcut_at = set(model_cfg.get('CONV_SHORTCUT', []))
        num_filter = int(model_cfg.get('NUM_FILTER', cin))
        self.conv_in = None
        if cin != num_filter:
            self.conv_in = ConvBNReLU(cin, num_filter, kernel=1, padding=0)
            cin = num_filter
        self.convs = []
        for i, kw in enumerate(model_cfg['CONV_KWARGS']):
            conv = ConvBNReLU(cin, int(kw['out_channels']),
                              kernel=int(kw['kernel_size']),
                              stride=int(kw.get('stride', 1)),
                              dilation=int(kw.get('dilation', 1)),
                              padding=kw.get('padding', None))
            self.add_module(f'conv_{i}', conv)
            self.convs.append(conv)
            cin = int(kw['out_channels'])
        self.out_channels = cin

    def forward(self, x):
        if self.conv_in is not None:
            x = self.conv_in(x)
        for i, conv in enumerate(self.convs):
            y = conv(x)
            x = x + y if i in self.shortcut_at else y
        return x


class BaseBEVBackbone(nn.Module):
    """Level i: ``block{i}_in`` (3x3 at ``LAYER_STRIDES[i]``) and
    ``LAYER_NUMS[i]`` 3x3 blocks ``block{i}_{j}``; then ``up{i}``, a
    deconvolution by ``UPSAMPLE_STRIDES[i]`` (or ``down{i}``, a strided
    conv, below 1) to ``NUM_UPSAMPLE_FILTERS[i]``; the levels' outputs
    concatenated."""

    def __init__(self, model_cfg, cin):
        super().__init__()
        nums = list(model_cfg.get('LAYER_NUMS', []))
        strides = list(model_cfg.get('LAYER_STRIDES', [1] * len(nums)))
        filters = list(model_cfg.get('NUM_FILTERS', []))
        up_strides = list(model_cfg.get('UPSAMPLE_STRIDES', []))
        up_filters = list(model_cfg.get('NUM_UPSAMPLE_FILTERS', []))
        self.levels = []
        for i, n in enumerate(nums):
            f = int(filters[i])
            blocks = [ConvBNReLU(cin, f, kernel=3, stride=int(strides[i]))]
            self.add_module(f'block{i}_in', blocks[0])
            for j in range(int(n)):
                blocks.append(ConvBNReLU(f, f, kernel=3))
                self.add_module(f'block{i}_{j}', blocks[-1])
            cin = f
            up = None
            if i < len(up_strides):
                s = up_strides[i]
                if s >= 1:
                    up = DeconvBNReLU(f, int(up_filters[i]), int(s))
                    self.add_module(f'up{i}', up)
                else:
                    k = int(round(1 / s))
                    up = ConvBNReLU(f, int(up_filters[i]), kernel=k,
                                    stride=k, padding=0)
                    self.add_module(f'down{i}', up)
            self.levels.append((blocks, up))
        ups = [int(up_filters[i]) for i in range(min(len(nums),
                                                     len(up_strides)))]
        self.out_channels = sum(ups) if ups else cin

    def forward(self, x):
        ups = []
        for blocks, up in self.levels:
            for blk in blocks:
                x = blk(x)
            if up is not None:
                ups.append(up(x))
        if len(ups) > 1:
            return torch.cat(ups, -1)
        return ups[0] if ups else x


class HeightCompression(nn.Module):
    """[B, Z, H, W, C] → [B, H, W, Z*C]."""

    def forward(self, x):
        B, Z, H, W, C = x.shape
        return x.permute(0, 2, 3, 1, 4).reshape(B, H, W, Z * C)
