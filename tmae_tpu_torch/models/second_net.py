"""SECONDNet (counterpart of ``tmae_tpu/models/second_net.py``): MeanVFE over
the host voxels → VoxelBackBone8x → height compression → BaseBEVBackbone →
AnchorHeadSingle.

Batch: ``voxels`` [B, V, T, C], ``voxel_num_points`` [B, V],
``voxel_coords_zyx`` [B, V, 3] and ``voxel_mask`` [B, V] from the
``transform_points_to_voxels`` processor.
"""

from __future__ import annotations

import torch
from torch import nn

from .anchor_head import AnchorHeadSingle
from .backbone3d_voxel import (CONV_OUT_PADDING, VoxelBackBone8x,
                               height_compression)
from .bev import BaseBEVBackbone
from .pointpillar import anchor_outputs
from .vfe import MeanVFE


def bev_depth(grid_dhw) -> int:
    """The depth VoxelBackBone8x leaves of a (D, H, W) input: three stride-2
    convolutions (padding 1, 1 and 0 in z), then conv_out's stride 2."""
    d = int(grid_dhw[0])
    for pad, stride in ((1, 2), (1, 2), (0, 2), (CONV_OUT_PADDING[0], 2)):
        d = (d + 2 * pad - 3) // stride + 1
    return d


class SECONDNet(nn.Module):

    def __init__(self, cfg, spec, num_point_features):
        super().__init__()
        model_cfg = cfg['MODEL']
        self.spec = spec
        nx, ny, nz = spec.grid_size
        # spconv's sparse shape: one z cell of headroom
        grid_dhw = (nz + 1, ny, nx)
        self.vfe = MeanVFE()
        self.backbone_3d = VoxelBackBone8x(
            grid_dhw, [int(v) for v in cfg['RUNTIME']['MAX_VOXELS']],
            num_point_features)
        self.backbone_2d = BaseBEVBackbone(model_cfg['BACKBONE_2D'],
                                           128 * bev_depth(grid_dhw))
        self.dense_head = AnchorHeadSingle(
            model_cfg['DENSE_HEAD'], self.backbone_2d.out_channels,
            cfg['CLASS_NAMES'], (nx, ny), spec.pc_range)

    def forward(self, batch: dict):
        mask = batch['voxel_mask']
        feat = self.vfe(batch['voxels'], batch['voxel_num_points'])
        feat = torch.where(mask[..., None], feat, 0.0)
        x, coords, mask, dhw, _ = self.backbone_3d(
            feat, batch['voxel_coords_zyx'], mask)
        bev = height_compression(x, coords, mask, dhw)
        return anchor_outputs(self.dense_head, self.backbone_2d(bev))
