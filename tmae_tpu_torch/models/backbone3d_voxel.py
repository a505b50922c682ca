"""VoxelBackBone8x, the SECOND-family 3D sparse-conv backbone, and the
height compression to BEV (counterpart of
``tmae_tpu/models/backbone3d_voxel.py``), on the gather-based 3D sparse
convolution of ``ops/sparse3d.py``. Kernels are ``[27, Cin, Cout]``
(z slowest), the JAX package's layout, so its weights load as they are.

``conv_out`` keeps the JAX package's 3^3 kernel (where the reference has
(3, 1, 1)) at stride (2, 1, 1), padded (0, 1, 1): y and x keep their
extent, so the BEV map has the anchors' size. The JAX package pads it 0 on
every axis, which takes two cells off y and x and leaves the head's maps
smaller than its anchors (ROADMAP.md, F11).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sparse3d import (build_index_grid, downsample_coords_3d,
                            gather_neighbors, neighbor_slots,
                            sparse_conv3d_apply)
from .layers import MaskedBatchNorm

CONV_OUT_PADDING = (0, 1, 1)


class SubMConv3dBlock(nn.Module):
    """Submanifold 3D conv (same active set in and out) + masked BN +
    ReLU."""

    def __init__(self, cin, cout, kernel=3):
        super().__init__()
        self.kernel = kernel
        self.weight = nn.Parameter(torch.empty(kernel ** 3, cin, cout))
        self.bn = MaskedBatchNorm(cout)

    def forward(self, feat, coords, mask, grid_dhw, index_grid):
        nb = gather_neighbors(index_grid, coords, mask, grid_dhw,
                              kernel=self.kernel)
        x = sparse_conv3d_apply(feat, nb, self.weight)
        x = torch.where(mask[..., None], x, 0.0)
        return F.relu(self.bn(x, mask))


class SparseConv3dBlock(nn.Module):
    """Strided 3D sparse conv (a new active set of at most ``max_out``
    voxels) + masked BN + ReLU."""

    def __init__(self, cin, cout, stride=2, padding=1, kernel=3, max_out=0):
        super().__init__()
        self.stride, self.padding, self.kernel = stride, padding, kernel
        self.max_out = max_out
        self.weight = nn.Parameter(torch.empty(kernel ** 3, cin, cout))
        self.bn = MaskedBatchNorm(cout)

    def forward(self, feat, coords, mask, grid_dhw, index_grid):
        coords, mask, out_dhw = downsample_coords_3d(
            coords, mask, grid_dhw, self.stride, self.padding, self.kernel,
            self.max_out or feat.shape[1])
        nb = neighbor_slots(index_grid, coords, mask, grid_dhw, self.kernel,
                            self.stride, self.padding)
        x = sparse_conv3d_apply(feat, nb, self.weight)
        x = torch.where(mask[..., None], x, 0.0)
        return F.relu(self.bn(x, mask)), coords, mask, out_dhw


class VoxelBackBone8x(nn.Module):
    """16 → 32 → 64 → 64 channels with 8x spatial downsampling, then
    ``conv_out`` to 128 at z-stride 2. ``grid_dhw`` is the input's sparse
    shape, z already + 1 as spconv's; ``max_voxels`` the active-set caps
    per level (the last repeated to five)."""

    def __init__(self, grid_dhw, max_voxels, cin):
        super().__init__()
        caps = list(max_voxels)
        while len(caps) < 5:
            caps.append(caps[-1])
        self.grid_dhw = tuple(grid_dhw)
        self.conv_input = SubMConv3dBlock(cin, 16)
        self.conv1 = SubMConv3dBlock(16, 16)
        self.stages = []
        c = 16
        for i, (ch, pad) in enumerate(((32, 1), (64, 1), (64, (0, 1, 1)))):
            name = f'conv{i + 2}'
            blocks = (SparseConv3dBlock(c, ch, 2, pad, max_out=caps[i + 1]),
                      SubMConv3dBlock(ch, ch), SubMConv3dBlock(ch, ch))
            for suffix, blk in zip(('_down', '_subm1', '_subm2'), blocks):
                self.add_module(name + suffix, blk)
            self.stages.append(blocks)
            c = ch
        self.conv_out = SparseConv3dBlock(c, 128, (2, 1, 1), CONV_OUT_PADDING,
                                          max_out=caps[4])

    def forward(self, feat, coords, mask):
        """Returns (feat [B, V4, 128], coords, mask, (D, H, W), hidden: the
        (feat, coords, mask, dhw) of ``x_conv1`` .. ``x_conv4``)."""
        dhw = self.grid_dhw
        ig = build_index_grid(coords, mask, dhw)
        x = self.conv_input(feat, coords, mask, dhw, ig)
        x = self.conv1(x, coords, mask, dhw, ig)
        hidden = {'x_conv1': (x, coords, mask, dhw)}
        for i, (down, subm1, subm2) in enumerate(self.stages):
            x, coords, mask, dhw_out = down(x, coords, mask, dhw, ig)
            dhw = dhw_out
            ig = build_index_grid(coords, mask, dhw)
            x = subm1(x, coords, mask, dhw, ig)
            x = subm2(x, coords, mask, dhw, ig)
            hidden[f'x_conv{i + 2}'] = (x, coords, mask, dhw)
        x, coords, mask, dhw = self.conv_out(x, coords, mask, dhw, ig)
        return x, coords, mask, dhw, hidden


def height_compression(feat, coords_zyx, mask, dhw):
    """Sparse [B, V, C] at depth D → dense BEV [B, H, W, D*C] (channel
    index z * C + c)."""
    D, H, W = dhw
    B, V, C = feat.shape
    c = coords_zyx.long()
    flat = torch.where(mask, (c[..., 0] * H + c[..., 1]) * W + c[..., 2],
                       D * H * W)
    src = torch.where(mask[..., None], feat, 0.0)
    dense = feat.new_zeros(B, D * H * W + 1, C).scatter(
        1, flat[..., None].expand(B, V, C), src)[:, :-1]
    return dense.reshape(B, D, H, W, C).permute(0, 2, 3, 1, 4).reshape(
        B, H, W, D * C)
