"""Point-in-box tests of the second-stage and point heads (counterpart of
``tmae_tpu/ops/roi_pool.py``'s ``points_in_boxes``)."""

from __future__ import annotations

import torch


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
