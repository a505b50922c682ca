"""RoI pooling of the second-stage and point heads (counterpart of
``tmae_tpu/ops/roi_pool.py``): the point-in-box test, a fixed number of
points gathered per RoI in its canonical frame, the RoI-aware voxel max
pool, and the RoI-local DFVS pool of GraphRCNN (the gathered points, then a
farthest-point subset: kernel ``DFPS`` on the card).

The pools are dense, as the JAX package's: every point is tested against
every box ([B, P, M]), and a point belongs to the first box that holds it.
"""

from __future__ import annotations

import torch

from .pointnet2 import farthest_point_sample, gather_points


def points_in_boxes(points_xyz: torch.Tensor, boxes: torch.Tensor,
                    box_mask: torch.Tensor | None = None,
                    margin: float = 0.0) -> torch.Tensor:
    """[B, P, 3] x [B, M, 7+] → int32 [B, P]: the index of the first box
    (among those ``box_mask`` keeps) that holds the point, grown by
    ``margin`` on every side, or -1."""
    d = points_xyz[:, :, None, :2] - boxes[:, None, :, :2]
    c = torch.cos(boxes[..., 6])[:, None]
    s = torch.sin(boxes[..., 6])[:, None]
    u = d[..., 0] * c + d[..., 1] * s
    v = -d[..., 0] * s + d[..., 1] * c
    half = boxes[:, None, :, 3:6] / 2 + margin
    inside = ((u.abs() <= half[..., 0]) & (v.abs() <= half[..., 1])
              & ((points_xyz[:, :, None, 2] - boxes[:, None, :, 2]).abs()
                 <= half[..., 2]))
    if box_mask is not None:
        inside &= box_mask[:, None, :]
    first = inside.to(torch.uint8).argmax(-1).int()
    return torch.where(inside.any(-1), first, -1)


def roipoint_pool3d(points: torch.Tensor, point_mask: torch.Tensor,
                    boxes: torch.Tensor, box_mask: torch.Tensor,
                    num_sampled: int):
    """A fixed number of points per RoI, in its canonical frame: points
    [B, P, 3 + C] x boxes [B, M, 7+] → (pooled [B, M, K, 3 + C], empty
    [B, M]). A box takes its points in list order (a stable sort by box),
    the first K of them, then repeats them in turn to fill K slots; xyz
    become the offset from the box's centre turned by minus its heading;
    an empty box gives zeros."""
    B, P, C = points.shape
    M, K = boxes.shape[1], num_sampled
    dev = points.device
    box_idx = points_in_boxes(points[..., :3], boxes, box_mask)
    key = torch.where(point_mask & (box_idx >= 0), box_idx, M).long()
    s, order = torch.sort(key, dim=1, stable=True)
    pos = torch.arange(P, device=dev).expand(B, P)
    # rank of each point within its box: its place in the sorted list
    # less the place of its box's first point
    start = torch.searchsorted(s, s)
    rank = torch.empty_like(key).scatter_(1, order, pos - start)
    dest = torch.where((rank < K) & (key < M), key * K + rank, M * K)
    buf = points.new_zeros(B, M * K + 1, C).scatter_(
        1, dest[..., None].expand(B, P, C), points)[:, :-1]
    cnt = torch.zeros(B, M + 1, dtype=torch.long, device=dev).scatter_add_(
        1, key, torch.ones_like(key))[:, :M].clamp(max=K)
    slot = torch.arange(K, device=dev) % cnt.clamp(min=1)[..., None]
    buf = buf.reshape(B, M, K, C).gather(
        2, slot[..., None].expand(B, M, K, C))
    d = buf[..., :3] - boxes[:, :, None, :3]
    c = torch.cos(boxes[..., 6])[..., None]
    sn = torch.sin(boxes[..., 6])[..., None]
    u = d[..., 0] * c + d[..., 1] * sn
    v = -d[..., 0] * sn + d[..., 1] * c
    canon = torch.cat([u[..., None], v[..., None], d[..., 2:3], buf[..., 3:]],
                      -1)
    return torch.where((cnt > 0)[..., None, None], canon, 0.0), cnt == 0


def roiaware_pool3d(points: torch.Tensor, point_mask: torch.Tensor,
                    point_features: torch.Tensor, boxes: torch.Tensor,
                    box_mask: torch.Tensor, out_size: int = 6,
                    num_sampled: int = 128):
    """Max-pooled RoI features on an ``out_size``^3 grid in each box's
    canonical frame, over the box's first ``num_sampled`` points
    (:func:`roipoint_pool3d`): [B, M, G, G, G, C], 0 in cells without a
    point and for masked or empty boxes."""
    pooled, empty = roipoint_pool3d(
        torch.cat([points[..., :3], point_features], -1), point_mask, boxes,
        box_mask, num_sampled)
    B, M, K, _ = pooled.shape
    C = point_features.shape[-1]
    G = out_size
    rel = (pooled[..., :3] / boxes[:, :, None, 3:6].clamp(min=1e-4)
           + 0.5) * G
    cell = rel.to(torch.int32).clamp(0, G - 1).long()
    flat = (cell[..., 0] * G + cell[..., 1]) * G + cell[..., 2]  # [B, M, K]
    out = torch.full((B, M, G ** 3, C), float('-inf'), dtype=pooled.dtype,
                     device=pooled.device).scatter_reduce(
        2, flat[..., None].expand(B, M, K, C), pooled[..., 3:], 'amax')
    out = torch.where(torch.isfinite(out), out, 0.0)
    out = torch.where((box_mask & ~empty)[..., None, None], out, 0.0)
    return out.reshape(B, M, G, G, G, C)


def roilocal_dfvs_pool3d(points: torch.Tensor, point_mask: torch.Tensor,
                         boxes: torch.Tensor, box_mask: torch.Tensor,
                         num_dvs_points: int = 256,
                         num_fps_points: int = 64):
    """GraphRCNN's RoI-local pool (the reference's DFVS pooling): each
    (already enlarged) box's ``num_dvs_points`` gathered points
    (:func:`roipoint_pool3d`), then the ``num_fps_points`` that D-FPS picks
    from them in the canonical frame (one sample a RoI: kernel ``DFPS`` on
    the card). The repeated points lie at distance 0 from their first copy,
    so FPS takes them only once the distinct points are used up. Returns
    (pooled [B, M, num_fps_points, 3 + C], empty [B, M])."""
    pooled, empty = roipoint_pool3d(points, point_mask, boxes, box_mask,
                                    num_dvs_points)
    B, M, K, C = pooled.shape
    flat = pooled.reshape(B * M, K, C)
    ones = torch.ones(B * M, K, dtype=torch.bool, device=flat.device)
    idx = farthest_point_sample(flat[..., :3].contiguous(), ones,
                                num_fps_points)
    out = gather_points(flat, idx).reshape(B, M, num_fps_points, C)
    return torch.where((box_mask & ~empty)[..., None, None], out, 0.0), empty
