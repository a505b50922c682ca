"""CenterNet targets and decode helpers (counterpart of
``tmae_tpu/ops/centernet.py``: ``gaussian_radius``,
``assign_center_targets``, ``exact_topk_flat`` and ``gather_feat_nhwc``).
Targets are batched torch ops on the boxes' device: a fixed-patch gaussian
splat reduced with a max, no per-box host loop."""

from __future__ import annotations

import torch

# Fixed gaussian patch half-size: radii above it flatten only the far tail of
# the gaussian (value < exp(-4.5)) outside the patch.
RMAX = 24


def gaussian_radius(height, width, min_overlap=0.5):
    """Minimum of CenterNet's three quadratic roots, keeping the reference's
    radius quirk: the third root is ``(b3 + sq3) / 2``, not ``/ (2 * a3)``."""
    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 ** 2 - 4 * a1 * c1, min=0))) / 2
    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2 ** 2 - 4 * a2 * c2, min=0))) / 2
    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def assign_center_targets(gt_boxes, gt_mask, num_classes: int,
                          feature_map_size, point_cloud_range, voxel_size,
                          feature_map_stride: int = 1,
                          gaussian_overlap: float = 0.1, min_radius: int = 2):
    """gt_boxes [B, M, 8] (x, y, z, dx, dy, dz, heading, class 1-indexed),
    gt_mask [B, M] bool; ``feature_map_size`` is (W, H). Returns heatmap
    [B, num_classes, H, W], target_boxes [B, M, 8], inds [B, M], mask
    [B, M] (the box lies on the map with a positive footprint) and
    iou_boxes [B, M, 7] (each slot's box, the IoU head's target)."""
    W, H = feature_map_size
    pc, vs = point_cloud_range, voxel_size
    B, M, _ = gt_boxes.shape
    dev = gt_boxes.device
    x, y, z = gt_boxes[..., 0], gt_boxes[..., 1], gt_boxes[..., 2]
    coord_x = torch.clamp((x - pc[0]) / vs[0] / feature_map_stride, 0, W - 0.5)
    coord_y = torch.clamp((y - pc[1]) / vs[1] / feature_map_stride, 0, H - 0.5)
    cx_int = coord_x.to(torch.int64)
    cy_int = coord_y.to(torch.int64)
    dx = gt_boxes[..., 3] / vs[0] / feature_map_stride
    dy = gt_boxes[..., 4] / vs[1] / feature_map_stride
    radius = gaussian_radius(dx, dy, min_overlap=gaussian_overlap)
    radius = torch.clamp(radius.to(torch.int64), min=min_radius)
    valid = gt_mask & (dx > 0) & (dy > 0)
    cls_id = torch.clamp(gt_boxes[..., 7].to(torch.int64) - 1, 0,
                         num_classes - 1)

    off = torch.arange(-RMAX, RMAX + 1, device=dev)
    oy, ox = off[:, None], off[None, :]
    sigma = (2 * radius.float() + 1) / 6.0
    g = torch.exp(-(ox * ox + oy * oy).float()
                  / (2 * sigma[..., None, None] ** 2))            # [B, M, P, P]
    r4 = radius[..., None, None]
    inside = (ox.abs() <= r4) & (oy.abs() <= r4)
    g = torch.where(inside & valid[..., None, None], g, 0.0)
    gy = cy_int[..., None, None] + oy
    gx = cx_int[..., None, None] + ox
    in_map = (gy >= 0) & (gy < H) & (gx >= 0) & (gx < W)
    flat_idx = torch.where(in_map & valid[..., None, None],
                           cls_id[..., None, None] * (H * W) + gy * W + gx,
                           num_classes * H * W)
    heat = torch.zeros(B, num_classes * H * W + 1, device=dev)
    heat.scatter_reduce_(1, flat_idx.reshape(B, -1), g.reshape(B, -1), 'amax')
    heatmap = heat[:, :-1].reshape(B, num_classes, H, W)

    tb = torch.stack([
        coord_x - cx_int, coord_y - cy_int, z,
        *torch.log(torch.clamp(gt_boxes[..., 3:6], min=1e-6)).unbind(-1),
        torch.cos(gt_boxes[..., 6]), torch.sin(gt_boxes[..., 6])], -1)
    tb = torch.where(valid[..., None], tb, 0.0)
    inds = torch.where(valid, cy_int * W + cx_int, 0)
    return {'heatmap': heatmap, 'target_boxes': tb, 'inds': inds,
            'mask': valid,
            'iou_boxes': torch.where(valid[..., None], gt_boxes[..., :7], 0.0)}


def gather_feat_nhwc(feat: torch.Tensor, inds: torch.Tensor):
    """feat [B, H, W, C], inds [B, K] flat cell index → [B, K, C]."""
    B, H, W, C = feat.shape
    return torch.gather(feat.reshape(B, H * W, C), 1,
                        inds.long()[..., None].expand(-1, -1, C))


def exact_topk_flat(flat: torch.Tensor, K: int):
    """Exact top-K along dim 1 of ``flat`` [B, N]: values by value
    descending, ties by index ascending, and at the K-th value the lowest
    indices are kept. ``torch.topk`` is exact but leaves the order of equal
    values unspecified, so only its K-th value is used here; this is the
    order ``lax.top_k`` gives the JAX package."""
    B = flat.shape[0]
    kth = torch.topk(flat, K, dim=1, sorted=True).values[:, -1:]
    greater = flat > kth
    equal = flat == kth
    need = K - greater.sum(1, keepdim=True)
    keep = greater | (equal & (equal.cumsum(1) <= need))
    idx = torch.nonzero(keep)[:, 1].reshape(B, K)  # ascending index
    vals = torch.gather(flat, 1, idx)
    order = torch.argsort(vals, dim=1, descending=True, stable=True)
    return torch.gather(vals, 1, order), torch.gather(idx, 1, order)
