"""Two-frame dynamic pillar VFE (counterpart of ``tmae_tpu/models/vfe.py``
``DynPillarEncoder`` and ``TemporalDynVFE``): a per-point MLP, then a
per-pillar max. With host-sorted inputs (``seg_ends`` shipped) the max is
kernel K5, differentiated in train mode by the JAX package's tie rule;
otherwise the scatter path sorts on the device. A batch without the host
voxelization (configs without RUNTIME.HOST_VOXELIZE) is voxelized on the
device. In train mode the encoder runs under remat and its batch norms
update their running statistics once per frame, current then previous."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.sorted_segments import (sorted_segment_max,
                                   sorted_segment_max_train)
from ..ops.voxelize import VoxelSpec, segment_max, segment_mean, voxelize
from .layers import LinearBNReLU, remat


class DynPillarEncoder(nn.Module):
    """Single-frame pillar VFE ('mean' sample + MLPs + per-pillar max)."""

    def __init__(self, spec: VoxelSpec, mlps, num_point_features=4,
                 use_absolute_xyz=True, use_cluster_xyz=True,
                 with_distance=False, compute_dtype='f32'):
        super().__init__()
        self.spec = spec
        # 'bf16' rounds the point features once to bf16 before the MLPs, as
        # the JAX package casts them there; its f32 Linear weights promote
        # the products back to f32, so nothing after that rounding changes.
        # Any other value runs in f32, as in the JAX package.
        self.round_bf16 = compute_dtype == 'bf16'
        self.mlps = [list(m) for m in mlps]
        self.use_absolute_xyz = use_absolute_xyz
        self.use_cluster_xyz = use_cluster_xyz
        self.with_distance = with_distance
        cin = 3 + (num_point_features if use_absolute_xyz
                   else num_point_features - 3)
        cin += 3 if use_cluster_xyz else 0
        cin += 1 if with_distance else 0
        self.stacks = []
        for k, widths in enumerate(self.mlps):
            layers = []
            for w in widths:
                layer = LinearBNReLU(cin, w)
                self.add_module(f'mlp{k}_{w}', layer)
                layers.append(layer)
                cin = w
            self.stacks.append(layers)
            cin = 2 * cin  # per-point features + pillar max, when not last

    def forward(self, points, point_mask, vox: dict):
        """points [B, P, 4]; ``vox`` the host voxelization (tensors):
        point_voxel, point_valid, voxel_coords, voxel_mask and optionally
        voxel_mean_xyz and seg_ends; empty to voxelize on the device.
        Returns the voxel features, coords and mask, and the point-to-voxel
        map (point_voxel, point_valid) that the MAE targets take."""
        spec = self.spec
        if 'point_voxel' not in vox:
            vox = voxelize(points, point_mask, spec)
        V = spec.max_voxels
        pv = vox['point_voxel'].long()
        pvalid = vox['point_valid']
        if 'voxel_mean_xyz' in vox:
            sampled_xyz = vox['voxel_mean_xyz']
        else:
            sampled_xyz = segment_mean(points, pv, V, valid=pvalid)[..., :3]
        vs = spec.voxel_size
        rng = spec.pc_range
        coords = vox['voxel_coords']
        safe_pv = pv.clamp(max=V - 1)
        own = torch.gather(coords, 1, safe_pv[..., None].expand(-1, -1, 2))
        cx = (own[..., 1].to(points.dtype) + 0.5) * vs[0] + rng[0]
        cy = (own[..., 0].to(points.dtype) + 0.5) * vs[1] + rng[1]
        cz = torch.full_like(cx, 0.5 * vs[2] + rng[2])
        feats = [torch.stack([points[..., 0] - cx, points[..., 1] - cy,
                              points[..., 2] - cz], -1)]
        feats.append(points if self.use_absolute_xyz else points[..., 3:])
        if self.use_cluster_xyz:
            mean_at = torch.gather(sampled_xyz, 1,
                                   safe_pv[..., None].expand(-1, -1, 3))
            feats.append(points[..., :3] - mean_at)
        if self.with_distance:
            feats.append(torch.linalg.norm(points[..., :3], dim=-1,
                                           keepdim=True))
        x = torch.cat(feats, -1)
        x = torch.where(pvalid[..., None], x, 0.0)
        if self.round_bf16:
            x = x.to(torch.bfloat16).float()

        sorted_max = 'seg_ends' in vox
        ssm = sorted_segment_max_train if self.training else sorted_segment_max
        for k, layers in enumerate(self.stacks):
            for layer in layers:
                x = layer(x, pvalid)
            if sorted_max:
                x_max = ssm(x, pv, vox['seg_ends'], vox['voxel_mask'], V)
            else:
                x_max = segment_max(torch.where(pvalid[..., None], x,
                                                -torch.inf), pv, V)
            if k == len(self.stacks) - 1:
                x = x_max
            else:
                back = torch.gather(
                    x_max, 1, safe_pv[..., None].expand(-1, -1, x.shape[-1]))
                x = torch.cat([x, back], -1)
        return {
            'voxel_features': torch.where(vox['voxel_mask'][..., None], x, 0.0),
            'voxel_coords': vox['voxel_coords'],
            'voxel_mask': vox['voxel_mask'],
            'point_voxel': vox['point_voxel'],
            'point_valid': pvalid,
        }


class TemporalDynVFE(nn.Module):
    """Runs the shared pillar encoder on the current and previous frame."""

    def __init__(self, spec: VoxelSpec, mlps, remat: bool = True, **kwargs):
        super().__init__()
        self.remat = remat
        self.encoder = DynPillarEncoder(spec, mlps, **kwargs)

    def forward(self, points, point_mask, points_prev, point_mask_prev,
                vox_cur: dict, vox_prv: dict, prev_needed: bool = True):
        """(current frame's outputs, previous frame's); with ``prev_needed``
        False (streaming serving: the previous frame's pyramid comes from a
        cache) only the current frame runs and the second is None."""
        rm = self.training and self.remat
        cur = remat(self.encoder, points, point_mask, vox_cur, enabled=rm)
        if not prev_needed:
            return cur, None
        prv = remat(self.encoder, points_prev, point_mask_prev, vox_prv,
                    enabled=rm)
        return cur, prv
