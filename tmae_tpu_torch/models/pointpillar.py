"""PointPillar (counterpart of ``tmae_tpu/models/pointpillar.py``): PillarVFE
over the host voxels → the pillars scattered onto the BEV grid →
BaseBEVBackbone → AnchorHeadSingle.

Batch: ``voxels`` [B, V, T, C], ``voxel_num_points`` [B, V],
``voxel_coords`` [B, V, 2] (y, x) and ``voxel_mask`` [B, V] from the
``transform_points_to_voxels`` processor.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.voxelize import scatter_to_grid
from .anchor_head import AnchorHeadSingle
from .bev import BaseBEVBackbone
from .vfe import PillarVFE


def anchor_outputs(head, spatial2d):
    """The anchor families' forward outputs: the head's maps, the BEV map
    and an ``occ_overflow`` of 0 (no window buckets)."""
    B = spatial2d.shape[0]
    return {'anchor_outputs': head(spatial2d),
            'spatial_features_2d': spatial2d,
            'occ_overflow': torch.zeros(1, B, dtype=torch.int32,
                                        device=spatial2d.device)}


class PointPillar(nn.Module):

    def __init__(self, cfg, spec, num_point_features):
        super().__init__()
        model_cfg = cfg['MODEL']
        vfe_cfg = model_cfg['VFE']
        self.spec = spec
        filters = list(vfe_cfg.get('NUM_FILTERS', [64]))
        self.vfe = PillarVFE(
            spec, filters, num_point_features=num_point_features,
            use_absolute_xyz=vfe_cfg.get('USE_ABSLOTE_XYZ', True),
            with_distance=vfe_cfg.get('WITH_DISTANCE', False))
        self.backbone_2d = BaseBEVBackbone(model_cfg['BACKBONE_2D'],
                                           int(filters[-1]))
        nx, ny, _ = spec.grid_size
        self.dense_head = AnchorHeadSingle(
            model_cfg['DENSE_HEAD'], self.backbone_2d.out_channels,
            cfg['CLASS_NAMES'], (nx, ny), spec.pc_range)

    def forward(self, batch: dict):
        feat = self.vfe(batch['voxels'], batch['voxel_num_points'],
                        batch['voxel_coords'])
        nx, ny, _ = self.spec.grid_size
        bev = scatter_to_grid(feat, batch['voxel_coords'],
                              batch['voxel_mask'], (ny, nx))
        return anchor_outputs(self.dense_head, self.backbone_2d(bev))
