"""2D BEV backbone (counterpart of ``tmae_tpu/models/bev.py:SSTBEVBackbone``):
3x3 Conv-BN-ReLU blocks with shortcut adds on NHWC maps."""

from __future__ import annotations

from torch import nn

from .layers import ConvBNReLU


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
