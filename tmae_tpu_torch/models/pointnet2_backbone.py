"""The PointNet++ set-abstraction layers of the point-based detectors
(counterpart of ``tmae_tpu/models/pointnet2_backbone.py``'s ``GroupedMSG``,
``SetAbstractionFSMSG`` and ``PointNet2SAMSG``): multi-scale grouping around
given centres, the fusion-sampling layer that draws its centres with D-FPS
and F-FPS (``ops/pointnet2.py``: the kernels DFPS, FFPS and BALL_QUERY on
the card), and SSD3D's stack of them.

Module names are the flax names (``sa_{i}``, ``scale{s}_mlp{w}``,
``agg_mlp{w}``), so ``utils/from_jax.params_from_jax`` loads the JAX
package's weights. Every MLP is ``LinearBNReLU`` in f32; the batch norms of
a scale count every one of the K slots of a non-empty group of a valid
centre, wrap-repeated duplicates included.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.pointnet2 import (ball_query_multi, farthest_point_sample,
                             farthest_point_sample_ffps, gather_points,
                             group_balls)
from .layers import LinearBNReLU

SAMPLERS = ('d-fps', 'f-fps')


class GroupedMSG(nn.Module):
    """Multi-scale grouping around given centres: the ball queries of every
    radius in one call (dilated, ``min_radius`` the previous radius, with
    ``dilated``), then per radius the group's centre-relative coordinates
    and features through the scale's MLP and the max over the group; the
    scales concatenated. ``cin``: the point feature channels (0 without
    features)."""

    def __init__(self, cin, radii, nsamples, mlps, dilated: bool = False):
        super().__init__()
        self.radii = [float(r) for r in radii]
        self.nsamples = [int(n) for n in nsamples]
        self.widths = [[int(w) for w in m] for m in mlps]
        self.dilated = dilated
        for si, widths in enumerate(self.widths):
            c = cin + 3
            for wi, w in enumerate(widths):
                self.add_module(f'scale{si}_mlp{wi}', LinearBNReLU(c, w))
                c = w
        self.out_channels = sum(w[-1] for w in self.widths)

    def forward(self, xyz, mask, features, centers, center_mask):
        outs = []
        balls = ball_query_multi(self.radii, self.nsamples, xyz, mask,
                                 centers, center_mask, self.dilated)
        for si, ((idx, cnt), widths) in enumerate(zip(balls, self.widths)):
            grouped = group_balls(idx, cnt, xyz, centers, center_mask,
                                  features)
            B, S, K, C = grouped.shape
            live = (cnt > 0) & center_mask
            gmask = live[..., None].expand(B, S, K).reshape(B, S * K)
            x = grouped.reshape(B, S * K, C)
            for wi in range(len(widths)):
                x = getattr(self, f'scale{si}_mlp{wi}')(x, gmask)
            x = x.reshape(B, S, K, -1)
            # amax splits the gradient among the group's equal maxima (the
            # wrap-repeated slots), as jnp.max does
            x = torch.where(gmask.reshape(B, S, K, 1), x,
                            float('-inf')).amax(2)
            outs.append(torch.where(live[..., None], x, 0.0))
        return torch.cat(outs, -1)


def sampler_plan(level, npoints, ranges, methods):
    """The samplers of one level: [(count, (start, end), method)]. The lists
    pair up one to one, or a level lists two counts with one range and the
    method ``f-fps``: 3DSSD's fusion sampling, F-FPS for the first count and
    D-FPS for the second over the same range (``ssd3d_once.yaml``'s level 1;
    the JAX package zips the lists and drops the second count). Any other
    mismatch is refused, naming the level."""
    npoints, ranges, methods = list(npoints), list(ranges), list(methods)
    if (len(npoints) == 2 and len(ranges) == 1 and methods == ['f-fps']):
        ranges, methods = ranges * 2, ['f-fps', 'd-fps']
    if not len(npoints) == len(ranges) == len(methods):
        raise ValueError(
            f'SA level {level}: NPOINTS {npoints}, SAMPLE_RANGE {ranges} and '
            f'SAMPLE_METHOD {methods} differ in length (only two counts with '
            "one range and ['f-fps'], fusion sampling, are read)")
    for m in methods:
        if m not in SAMPLERS:
            raise NotImplementedError(f'SA level {level}: sample method {m} '
                                      f'(have {list(SAMPLERS)})')
    return [(int(n), (int(r[0]), int(r[1])), m)
            for n, r, m in zip(npoints, ranges, methods)]


class SetAbstractionFSMSG(GroupedMSG):
    """Fusion-sampling SA layer: centres drawn by the level's samplers (each
    from a static index range of the input order, D-FPS on coordinates or
    F-FPS on coordinates and features, concatenated in order), multi-scale
    grouping around them, then the aggregation MLP (``agg_mlp{w}``). With
    ``new_xyz`` given no sampling is made (the vote head's aggregation)."""

    def __init__(self, cin, radii, nsamples, mlps, samplers=(),
                 dilated: bool = False, weight_gamma: float = 1.0,
                 aggregation_mlp=()):
        super().__init__(cin, radii, nsamples, mlps, dilated)
        self.samplers = list(samplers)
        self.weight_gamma = float(weight_gamma)
        c = self.out_channels
        for wi, w in enumerate(aggregation_mlp):
            self.add_module(f'agg_mlp{wi}', LinearBNReLU(c, int(w)))
            c = int(w)
        self.n_agg = len(aggregation_mlp)
        self.out_channels = c

    def sample(self, xyz, mask, features):
        """The centres' indices [B, S] int32 into the layer's points."""
        idx = []
        for n, (r0, r1), method in self.samplers:
            r1 = xyz.shape[1] if r1 == -1 else r1
            xyz_s, mask_s = xyz[:, r0:r1], mask[:, r0:r1]
            if method == 'd-fps':
                i = farthest_point_sample(xyz_s, mask_s, n)
            else:
                i = farthest_point_sample_ffps(
                    xyz_s, None if features is None else features[:, r0:r1],
                    mask_s, n, self.weight_gamma)
            idx.append(i + r0)
        return torch.cat(idx, -1)

    def forward(self, xyz, mask, features, new_xyz=None, new_mask=None,
                idx=None):
        """(new_xyz [B, S, 3], new_mask, features [B, S, out_channels],
        the centres' indices or None when ``new_xyz`` was given). ``idx``:
        the centres' indices to take instead of sampling."""
        if new_xyz is None:
            if idx is None:
                idx = self.sample(xyz, mask, features)
            new_xyz = gather_points(xyz, idx)
            new_mask = mask.gather(1, idx.long())
        x = super().forward(xyz, mask, features, new_xyz, new_mask)
        for wi in range(self.n_agg):
            x = getattr(self, f'agg_mlp{wi}')(x, new_mask)
        return new_xyz, new_mask, x, idx


class PointNet2SAMSG(nn.Module):
    """SSD3D's backbone: a stack of ``SetAbstractionFSMSG`` levels over the
    raw points (SA_CONFIG's NPOINTS, SAMPLE_RANGE, SAMPLE_METHOD, RADIUS,
    NSAMPLE, MLPS, AGGREGATION_MLPS, DILATED_RADIUS_GROUP, WEIGHT_GAMMA);
    the last level feeds the vote head. ``cin``: the point feature channels
    after x, y, z."""

    def __init__(self, model_cfg, cin: int):
        super().__init__()
        sa = model_cfg['SA_CONFIG']
        agg = sa.get('AGGREGATION_MLPS') or [()] * len(sa['NPOINTS'])
        self.levels = len(sa['NPOINTS'])
        for i in range(self.levels):
            layer = SetAbstractionFSMSG(
                cin, sa['RADIUS'][i], sa['NSAMPLE'][i], sa['MLPS'][i],
                samplers=sampler_plan(i, sa['NPOINTS'][i],
                                      sa['SAMPLE_RANGE'][i],
                                      sa['SAMPLE_METHOD'][i]),
                dilated=bool(sa.get('DILATED_RADIUS_GROUP', False)),
                weight_gamma=float(sa.get('WEIGHT_GAMMA', 1.0)),
                aggregation_mlp=agg[i])
            self.add_module(f'sa_{i}', layer)
            cin = layer.out_channels
        self.out_channels = cin

    def forward(self, points_xyz, point_mask, point_features,
                sample_idx=None):
        """``sample_idx``: per level, the centres' indices [B, S] to take
        instead of sampling (one side's choices handed to the other, as the
        MAE mask is). Returns the last level's ``point_coords``,
        ``point_mask`` and ``point_features``, every level's ``sa_xyz`` and
        ``sa_mask`` (the input first), and the levels' ``sample_idx``."""
        xyz, mask, feats, idxs = [points_xyz], [point_mask], point_features, []
        for i in range(self.levels):
            nx, nm, feats, idx = getattr(self, f'sa_{i}')(
                xyz[-1], mask[-1], feats,
                idx=None if sample_idx is None else sample_idx[i])
            xyz.append(nx)
            mask.append(nm)
            idxs.append(idx)
        return {'point_coords': xyz[-1], 'point_mask': mask[-1],
                'point_features': feats, 'sa_xyz': xyz, 'sa_mask': mask,
                'sample_idx': idxs}
