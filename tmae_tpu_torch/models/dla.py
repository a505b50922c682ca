"""DLA-34 image backbone with deformable-conv aggregation, GraphRCNN's camera
branch (counterpart of ``tmae_tpu/models/dla.py``; the reference's
``pcdet/models/img_backbones/dla.py``).

NHWC and f32, as the JAX package computes it: the recursive Tree / Root
aggregation of DLA, the DLAUp / IDAUp pyramid whose ``proj_*`` and
``node_*`` are DCNv2 blocks (``layers.DeformConvBNReLU``: kernels
``DCN_COLS``, ``DCN_COORD_BWD`` and ``BILINEAR_GRAD`` on the card), and the
JAX package's fixed bilinear upsampling in place of the reference's
transposed convolution (its documented deviation, followed here). The
upsampling is a product with a fixed interpolation matrix on each axis
(half-pixel centres, the edge sample renormalised onto the edge pixel, as
``jax.image.resize``), so its backward is a product too: no scatter, and a
step repeats bit for bit. Batch norms: dense, eps 1e-5, torch momentum 0.1
(flax's 0.9).

Precision: the branch runs its convolutions and DCN's tap product in full
f32 on the card. ``build_detector`` turns TF32 off for cuDNN and cuBLAS
(``torch.backends.cudnn.allow_tf32``, ``torch.backends.cuda.matmul.
allow_tf32``; ``device.full_f32``) once, for the whole run, when the
config has a camera branch; this module sets no precision itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d, DeformConvBNReLU, conv2d_nhwc

BN = dict(eps=1e-5, momentum=0.1)
LEVELS = (1, 1, 1, 2, 2, 1)
CHANNELS = (16, 32, 64, 128, 256, 512)


class _ConvBNReLU(nn.Module):

    def __init__(self, cin, features, kernel=3, stride=1, dilation=1):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.conv = nn.Conv2d(cin, features, kernel, bias=False)
        self.bn = BatchNorm2d(features, **BN)

    def forward(self, x):
        pad = self.dilation * (self.conv.kernel_size[0] // 2)
        return F.relu(self.bn(conv2d_nhwc(
            x, self.conv.weight, self.stride, pad, self.dilation,
            dtype=torch.float32)))


class BasicBlock(nn.Module):
    """Two 3x3 convs and the residual add."""

    def __init__(self, cin, planes, stride=1, dilation=1):
        super().__init__()
        self.dilation = dilation
        self.conv1 = _ConvBNReLU(cin, planes, 3, stride, dilation)
        self.conv2 = nn.Conv2d(planes, planes, 3, bias=False)
        self.bn2 = BatchNorm2d(planes, **BN)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = conv2d_nhwc(self.conv1(x), self.conv2.weight, 1, self.dilation,
                          self.dilation, dtype=torch.float32)
        return F.relu(self.bn2(out) + residual)


class Root(nn.Module):
    """1x1 conv over the concatenated children."""

    def __init__(self, cin, features, residual=False):
        super().__init__()
        self.residual = residual
        self.conv = nn.Conv2d(cin, features, 1, bias=False)
        self.bn = BatchNorm2d(features, **BN)

    def forward(self, children):
        x = self.bn(conv2d_nhwc(torch.cat(children, -1), self.conv.weight,
                                dtype=torch.float32))
        if self.residual:
            x = x + children[0]
        return F.relu(x)


def max_pool(x, s: int):
    """flax ``nn.max_pool`` over s x s windows at stride s ('VALID')."""
    B, H, W, C = x.shape
    x = x[:, :H // s * s, :W // s * s]
    return x.reshape(B, H // s, s, W // s, s, C).amax((2, 4))


class Tree(nn.Module):
    """The recursive deep-aggregation tree."""

    def __init__(self, levels, in_channels, out_channels, stride=1,
                 level_root=False, root_dim=0, root_residual=False):
        super().__init__()
        self.levels, self.stride, self.level_root = levels, stride, level_root
        root_dim = root_dim or 2 * out_channels
        if level_root:
            root_dim += in_channels
        self.project = in_channels != out_channels
        if self.project:
            self.project_conv = nn.Conv2d(in_channels, out_channels, 1,
                                          bias=False)
            self.project_bn = BatchNorm2d(out_channels, **BN)
        if levels == 1:
            self.tree1 = BasicBlock(in_channels, out_channels, stride)
            self.tree2 = BasicBlock(out_channels, out_channels, 1)
            self.root = Root(root_dim, out_channels, root_residual)
        else:
            self.tree1 = Tree(levels - 1, in_channels, out_channels, stride,
                              root_residual=root_residual)
            self.tree2 = Tree(levels - 1, out_channels, out_channels,
                              root_dim=root_dim + out_channels,
                              root_residual=root_residual)

    def forward(self, x, residual=None, children=None):
        children = [] if children is None else children
        bottom = max_pool(x, self.stride) if self.stride > 1 else x
        if self.project:
            residual = self.project_bn(conv2d_nhwc(
                bottom, self.project_conv.weight, dtype=torch.float32))
        else:
            residual = bottom
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1)
            return self.root([x2, x1, *children])
        x1 = self.tree1(x, residual)
        children.append(x1)
        return self.tree2(x1, children=children)


class DLA(nn.Module):
    """DLA-34's trunk: the six level maps, at strides 1 to 32."""

    def __init__(self, levels=LEVELS, channels=CHANNELS):
        super().__init__()
        ch = self.channels = list(channels)
        self.base_layer = _ConvBNReLU(3, ch[0], kernel=7)
        self.levels = list(levels)
        cin = ch[0]
        for i in range(levels[0]):
            setattr(self, f'level0_{i}', _ConvBNReLU(cin, ch[0]))
        for i in range(levels[1]):
            setattr(self, f'level1_{i}', _ConvBNReLU(
                ch[0] if i == 0 else ch[1], ch[1], stride=2 if i == 0 else 1))
        for li in range(2, 6):
            setattr(self, f'level{li}', Tree(levels[li], ch[li - 1], ch[li],
                                             stride=2, level_root=li != 2))

    def forward(self, x):
        x = self.base_layer(x)
        outs = []
        for i in range(self.levels[0]):
            x = getattr(self, f'level0_{i}')(x)
        outs.append(x)
        for i in range(self.levels[1]):
            x = getattr(self, f'level1_{i}')(x)
        outs.append(x)
        for li in range(2, 6):
            x = getattr(self, f'level{li}')(x)
            outs.append(x)
        return outs


def up_matrix(n: int, factor: int, device=None) -> torch.Tensor:
    """[n factor, n]: ``jax.image.resize``'s bilinear upsampling by an
    integer factor along one axis (output o samples the input at (o + 0.5)
    / factor - 0.5; a sample before the first or past the last pixel takes
    that pixel)."""
    src = (torch.arange(n * factor, dtype=torch.float64) + 0.5) / factor - 0.5
    i0 = torch.floor(src)
    frac = src - i0
    m = torch.zeros(n * factor, n, dtype=torch.float64)
    rows = torch.arange(n * factor)
    m.index_put_((rows, i0.clamp(0, n - 1).long()), 1 - frac, accumulate=True)
    m.index_put_((rows, (i0 + 1).clamp(0, n - 1).long()), frac,
                 accumulate=True)
    return m.float().to(device)


def resize_up(x, factor: int):
    """x [B, H, W, C] → [B, H factor, W factor, C], bilinear."""
    if factor == 1:
        return x
    _, H, W, _ = x.shape
    uh = up_matrix(H, factor, x.device)
    uw = up_matrix(W, factor, x.device)
    return torch.einsum('pw,bowc->bopc', uw,
                        torch.einsum('oh,bhwc->bowc', uh, x))


class IDAUp(nn.Module):
    """Iterative deep aggregation over a span of levels: each level's
    ``proj_j`` (DCN), a bilinear upsampling, then ``node_j`` (DCN) of its
    sum with the level before."""

    def __init__(self, out_channels, in_channels, up_factors):
        super().__init__()
        self.up_factors = [int(f) for f in up_factors]
        for j in range(1, len(in_channels)):
            setattr(self, f'proj_{j}', DeformConvBNReLU(in_channels[j],
                                                        out_channels))
            setattr(self, f'node_{j}', DeformConvBNReLU(out_channels,
                                                        out_channels))

    def forward(self, layers, startp: int, endp: int):
        layers = list(layers)
        for i in range(startp + 1, endp):
            j = i - startp
            y = resize_up(getattr(self, f'proj_{j}')(layers[i]),
                          self.up_factors[j])
            layers[i] = getattr(self, f'node_{j}')(y + layers[i - 1])
        return layers


class DLAUp(nn.Module):
    """The pyramid of IDAUp stages ``ida_i``."""

    def __init__(self, channels, scales):
        super().__init__()
        channels = list(channels)
        scales = list(scales)
        in_channels = list(channels)
        self.stages = len(channels) - 1
        for i in range(self.stages):
            j = -i - 2
            setattr(self, f'ida_{i}', IDAUp(
                channels[j], in_channels[j:],
                [s // scales[j] for s in scales[j:]]))
            scales[j + 1:] = [scales[j]] * len(scales[j + 1:])
            in_channels[j + 1:] = [channels[j]] * len(channels[j + 1:])

    def forward(self, layers):
        layers = list(layers)
        out = [layers[-1]]
        for i in range(self.stages):
            j = -i - 2
            layers[j:] = getattr(self, f'ida_{i}')(layers[j:], 0,
                                                   len(layers[j:]))
            out.insert(0, layers[-1])
        return out


class DLASeg(nn.Module):
    """DLA-34, DLAUp and a final IDAUp → the stride-``DOWN_RATIO`` map of
    ``out_channels`` (config: DOWN_RATIO 2/4/8/16, LAST_LEVEL)."""

    def __init__(self, model_cfg):
        super().__init__()
        name = model_cfg.get('NAME', 'DLASeg')
        if name != 'DLASeg':
            raise NotImplementedError(f'image backbone {name} is not ported: '
                                      'the port has DLASeg')
        down_ratio = int(model_cfg.get('DOWN_RATIO', 4))
        last_level = int(model_cfg.get('LAST_LEVEL', 5))
        self.first = first = int(down_ratio).bit_length() - 1
        self.last_level = last_level
        self.base = DLA()
        ch = self.base.channels
        self.dla_up = DLAUp(ch[first:], [2 ** i for i in
                                          range(len(ch[first:]))])
        self.ida_up = IDAUp(ch[first], ch[first:last_level],
                            [2 ** i for i in range(last_level - first)])
        self.out_channels = ch[first]

    def forward(self, image):
        """image [B, H, W, 3] → features [B, H / d, W / d, out_channels]."""
        up = self.dla_up(self.base(image)[self.first:])
        y = list(up[:self.last_level - self.first])
        return self.ida_up(y, 0, len(y))[-1]
