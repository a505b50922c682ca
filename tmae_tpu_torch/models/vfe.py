"""Voxel feature encoders (counterpart of ``tmae_tpu/models/vfe.py``).

``DynPillarEncoder`` / ``TemporalDynVFE``, the two-frame dynamic pillar
VFE of the T-MAE configs: a per-point MLP, then a
per-pillar max. With host-sorted inputs (``seg_ends`` shipped) the max is
kernel K5, differentiated in train mode by the JAX package's tie rule;
otherwise the scatter path sorts on the device. A batch without the host
voxelization (configs without RUNTIME.HOST_VOXELIZE) is voxelized on the
device. In train mode the encoder runs under remat and its batch norms
update their running statistics once per frame, current then previous.

``DynVFE`` runs the pillar encoder on one frame and always voxelizes it on
the device, as the JAX package's does. ``MeanVFE`` and ``PillarVFE`` read
the host voxelizer's ``[B, V, T, C]`` voxels (``transform_points_to_voxels``:
SECOND, PointPillars)."""

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
        """points [B, P, C] (x, y, z, then C - 3 features); ``vox`` the host voxelization (tensors):
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


class DynVFE(nn.Module):
    """Single-frame dynamic VFE: the pillar encoder (flax name
    ``DynPillarEncoder_0``) on the current frame, voxelized on the
    device whatever the batch ships."""

    def __init__(self, spec: VoxelSpec, mlps, **kwargs):
        super().__init__()
        self.DynPillarEncoder_0 = DynPillarEncoder(spec, mlps, **kwargs)

    def forward(self, points, point_mask):
        return self.DynPillarEncoder_0(points, point_mask, {})


class MeanVFE(nn.Module):
    """The mean of each voxel's points: voxels [B, V, T, C] (zero padded)
    and counts [B, V] → [B, V, C]."""

    def forward(self, voxels, voxel_num_points):
        cnt = voxel_num_points[..., None].to(voxels.dtype).clamp(min=1.0)
        return voxels.sum(2) / cnt


class PillarVFE(nn.Module):
    """PointPillars encoder over host voxels: each point with its offsets
    from the pillar's point mean and centre (and its distance), masked
    Linear-BN-ReLU layers over the [B, V*T] point rows (flax names
    ``LinearBNReLU_{i}``), the max over the pillar's points; empty pillars
    give 0."""

    def __init__(self, spec: VoxelSpec, num_filters, num_point_features=4,
                 use_absolute_xyz=True, with_distance=False):
        super().__init__()
        self.spec = spec
        self.use_absolute_xyz, self.with_distance = (use_absolute_xyz,
                                                     with_distance)
        cin = (num_point_features if use_absolute_xyz
               else num_point_features - 3) + 6 + int(with_distance)
        self.layers = []
        for i, w in enumerate(num_filters):
            layer = LinearBNReLU(cin, int(w))
            self.add_module(f'LinearBNReLU_{i}', layer)
            self.layers.append(layer)
            cin = int(w)

    def forward(self, voxels, voxel_num_points, voxel_coords):
        """voxels [B, V, T, C], voxel_num_points [B, V], voxel_coords
        [B, V, 2] (y, x) → [B, V, num_filters[-1]]."""
        B, V, T, _ = voxels.shape
        vs, rng = self.spec.voxel_size, self.spec.pc_range
        n = voxel_num_points[..., None]
        pmask = torch.arange(T, device=voxels.device) < n   # [B, V, T]
        cnt = n[..., None].to(voxels.dtype).clamp(min=1.0)
        xyz = voxels[..., :3]
        mean = torch.where(pmask[..., None], xyz, 0.0).sum(2, keepdim=True)
        f_cluster = xyz - mean / cnt
        cx = (voxel_coords[..., 1:2].to(voxels.dtype) + 0.5) * vs[0] + rng[0]
        cy = (voxel_coords[..., 0:1].to(voxels.dtype) + 0.5) * vs[1] + rng[1]
        f_center = torch.stack([voxels[..., 0] - cx, voxels[..., 1] - cy,
                                voxels[..., 2] - (0.5 * vs[2] + rng[2])], -1)
        feats = [voxels if self.use_absolute_xyz else voxels[..., 3:],
                 f_cluster, f_center]
        if self.with_distance:
            feats.append(torch.linalg.norm(xyz, dim=-1, keepdim=True))
        x = torch.where(pmask[..., None], torch.cat(feats, -1), 0.0)
        flat = pmask.reshape(B, V * T)
        for layer in self.layers:
            x = layer(x.reshape(B, V * T, -1), flat).reshape(B, V, T, -1)
        out = torch.where(pmask[..., None], x, -torch.inf).amax(2)
        return torch.where(voxel_num_points[..., None] > 0, out, 0.0)
