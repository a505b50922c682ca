"""CenterPoint detector with the SiamWCA backbone, the serving path of
``tools/cfgs/once_models/t_mae.yaml`` (counterpart of
``tmae_tpu/models/detectors.py:45-206,270-297,346-417``):

host voxelization → TemporalDynVFE → SiamWCA → SSTBEVBackbone → CenterHead →
decode → host rotated NMS.

Batch layout (dict of tensors, as the JAX package's host pipeline ships it):
``points``/``points_prev`` [B, P, 4], ``point_mask``/``point_mask_prev``
[B, P], and per frame (``cur``/``prv``) the host voxelization ``pv_*``,
``pvalid_*``, ``vcoords_*``, ``vmask_*`` and the sorted extras ``vmean_*``,
``vends_*``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.geometry_np import nms_bev
from ..ops.voxelize import VoxelSpec
from .bev import SSTBEVBackbone
from .center_head import CenterHead, decode
from .siamwca import SiamWCA, stage_caps
from .sst import VoxelSet
from .vfe import TemporalDynVFE

HOSTVOX_KEYS = (('point_voxel', 'pv'), ('point_valid', 'pvalid'),
                ('voxel_coords', 'vcoords'), ('voxel_mask', 'vmask'),
                ('voxel_mean_xyz', 'vmean'), ('seg_ends', 'vends'))


def make_voxel_spec(data_cfg, runtime_cfg) -> VoxelSpec:
    proc = [p for p in data_cfg['DATA_PROCESSOR']
            if p['NAME'] in ('calculate_grid_size', 'transform_points_to_voxels')]
    voxel_size = tuple(proc[-1]['VOXEL_SIZE']) if proc else (0.32, 0.32, 8.0)
    return VoxelSpec(
        pc_range=tuple(data_cfg['POINT_CLOUD_RANGE']),
        voxel_size=voxel_size,
        max_points=int(runtime_cfg['MAX_POINTS']),
        max_voxels=int(runtime_cfg['MAX_VOXELS'][0]),
    )


def _grid_hw(spec: VoxelSpec):
    nx, ny, _ = spec.grid_size
    return (ny, nx)


class CenterPoint(nn.Module):
    """VFE → SiamWCA → BACKBONE_2D → CenterHead, eval mode."""

    def __init__(self, cfg):
        super().__init__()
        model_cfg = cfg['MODEL']
        self.spec = make_voxel_spec(cfg['DATA_CONFIG'], cfg['RUNTIME'])
        vfe_cfg = model_cfg['VFE']
        b3d = model_cfg['BACKBONE_3D']
        if vfe_cfg['NAME'] != 'TemporalDynVFE' or b3d['NAME'] != 'SiamWCA':
            raise NotImplementedError(
                'the port runs CenterPoint with TemporalDynVFE + SiamWCA')
        mlps = [list(m) for m in vfe_cfg['MLPS']]
        self.vfe = TemporalDynVFE(
            self.spec, mlps,
            use_absolute_xyz=vfe_cfg.get('USE_ABSLOTE_XYZ', True),
            use_cluster_xyz=vfe_cfg.get('USE_CLUSTER_XYZ', True),
            with_distance=vfe_cfg.get('WITH_DISTANCE', False))
        self.backbone_3d = SiamWCA(b3d, stage_caps(cfg['RUNTIME']),
                                   cin=mlps[-1][-1])
        fuse_out = sum(int(b3d['FUSE_LAYER'][s]['NUM_UPSAMPLE_FILTER'])
                       for s in b3d['FEATURES_SOURCE'])
        fuse_out //= len(b3d['FEATURES_SOURCE'])
        self.backbone_2d = SSTBEVBackbone(model_cfg['BACKBONE_2D'], fuse_out)
        self.dense_head = CenterHead(model_cfg['DENSE_HEAD'],
                                     self.backbone_2d.out_channels)

    def forward(self, batch: dict):
        """Returns ``pred_dicts`` (NHWC head maps per group),
        ``spatial_features_2d`` and ``occ_overflow`` ([stages*2, B]: occupied
        windows over a bucket cap, SST stages then WCA blocks)."""
        hw = _grid_hw(self.spec)

        def hostvox(which):
            return {k: batch[f'{short}_{which}'] for k, short in HOSTVOX_KEYS
                    if f'{short}_{which}' in batch}

        cur, prv = self.vfe(batch['points'], batch['point_mask'],
                            batch['points_prev'], batch['point_mask_prev'],
                            hostvox('cur'), hostvox('prv'))
        vs = [VoxelSet(d['voxel_features'], d['voxel_coords'],
                       d['voxel_mask'], hw) for d in (cur, prv)]
        spatial, overflow = self.backbone_3d(*vs)
        spatial2d = self.backbone_2d(spatial)
        return {'pred_dicts': self.dense_head(spatial2d),
                'spatial_features_2d': spatial2d,
                'occ_overflow': torch.stack(overflow)}


def build_detector(cfg, device=None) -> CenterPoint:
    """The eval-mode detector on ``device`` (the card when None; raises when
    there is none)."""
    return CenterPoint(cfg).to(resolve_device(device)).eval()


@torch.no_grad()
def init_random_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights (no checkpoint is in the repository): weights
    at 1/sqrt(fan_in), biases and BN statistics near their identity values,
    tau 1. Drawn on the CPU from one ``torch.Generator``, so the same seed
    gives the same model on every device."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda t, s=1.0: (torch.randn(t.shape, generator=g) * s).to(t)
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if name == 'tau':
                p.fill_(1.0)
            elif p.dim() >= 2:
                fan_in = (p.shape[0] if isinstance(mod, nn.ConvTranspose2d)
                          else p[0].numel())
                p.copy_(rand(p, fan_in ** -0.5))
            elif name == 'weight':  # norm scales
                p.copy_(1.0 + rand(p, 0.1))
            else:
                p.copy_(rand(p, 0.1))
        for name, b in mod.named_buffers(recurse=False):
            if name == 'running_mean':
                b.copy_(rand(b, 0.1))
            elif name == 'running_var':
                b.copy_(0.5 + torch.rand(b.shape, generator=g).to(b))
    return model


def batch_to_device(batch: dict, device) -> dict:
    """Numpy batch from the host pipeline → tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items() if isinstance(v, np.ndarray)}


def centerpoint_predict(cfg, outputs):
    """Decode → (boxes [B, K, 7], scores, labels 1-indexed, valid), score
    sorted; rotated NMS is left to :func:`host_nms`."""
    head_cfg = cfg['MODEL']['DENSE_HEAD']
    spec = make_voxel_spec(cfg['DATA_CONFIG'], cfg['RUNTIME'])
    stride = int(head_cfg['TARGET_ASSIGNER_CONFIG'].get('FEATURE_MAP_STRIDE', 1))
    class_names = list(cfg['CLASS_NAMES'])
    id_maps = [np.asarray([class_names.index(n) for n in g], np.int64)
               for g in head_cfg['CLASS_NAMES_EACH_HEAD']]
    return decode(outputs['pred_dicts'], dict(head_cfg['POST_PROCESSING']),
                  spec.voxel_size, spec.pc_range, stride, id_maps)


def host_nms(cfg, boxes, scores, labels, valid):
    """Greedy rotated-BEV NMS per sample on score-sorted candidates (numpy).
    Returns the updated valid mask."""
    nms_cfg = cfg['MODEL']['DENSE_HEAD']['POST_PROCESSING']['NMS_CONFIG']
    to_np = lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)
    boxes, scores, valid = to_np(boxes), to_np(scores), to_np(valid).copy()
    thresh = float(nms_cfg['NMS_THRESH'])
    post = int(nms_cfg['NMS_POST_MAXSIZE'])
    for b in range(boxes.shape[0]):
        n = int(valid[b].sum())
        if n == 0:
            continue
        kept = nms_bev(boxes[b, :n, :7].astype(np.float64), scores[b, :n],
                       thresh, post_maxsize=post)
        keep = np.zeros(n, bool)
        keep[kept] = True
        valid[b, :n] &= keep
    return valid
