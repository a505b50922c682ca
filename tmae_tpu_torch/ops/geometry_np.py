"""Host-side (numpy) greedy rotated-BEV NMS (counterpart of
``tmae_tpu/ops/geometry_np.py:nms_bev``, which the JAX package's host NMS
falls back to).

Intersection of two rotated rectangles = convex hull of (corners of A inside
B) ∪ (corners of B inside A) ∪ (edge-edge crossings); area by angle-sorted
shoelace. Boxes are ``[x, y, z, dx, dy, dz, heading]``.

The JAX package computes the intersection for every pair of candidates.
Here it is computed only for pairs whose circumscribed circles meet; every
other pair has no intersection, so its IoU is exactly 0. Each computed pair
goes through the same arithmetic as there, so the kept set is the same.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-8


def boxes_to_corners_bev(boxes: np.ndarray) -> np.ndarray:
    """[N, 7] → [N, 4, 2] CCW BEV corners."""
    x, y = boxes[:, 0], boxes[:, 1]
    dx, dy, ang = boxes[:, 3], boxes[:, 4], boxes[:, 6]
    tmpl = np.array([[0.5, 0.5], [-0.5, 0.5], [-0.5, -0.5], [0.5, -0.5]])
    local = tmpl[None] * np.stack([dx, dy], -1)[:, None, :]  # [N,4,2]
    c, s = np.cos(ang), np.sin(ang)
    rx = local[..., 0] * c[:, None] - local[..., 1] * s[:, None]
    ry = local[..., 0] * s[:, None] + local[..., 1] * c[:, None]
    return np.stack([rx + x[:, None], ry + y[:, None]], -1)


def _corners_in_box(pts, boxes):
    """pts [..., K, 2] vs boxes [..., 7] → bool [..., K]."""
    d = pts - boxes[..., None, 0:2]
    c, s = np.cos(boxes[..., 6]), np.sin(boxes[..., 6])
    u = d[..., 0] * c[..., None] + d[..., 1] * s[..., None]
    v = -d[..., 0] * s[..., None] + d[..., 1] * c[..., None]
    return (np.abs(u) <= boxes[..., None, 3] / 2 + 1e-5) & (
        np.abs(v) <= boxes[..., None, 4] / 2 + 1e-5
    )


def pair_intersection_area(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """BEV intersection area of aligned pairs: A, B [K, 7] → [K]."""
    K = len(A)
    if K == 0:
        return np.zeros((0,))
    pa = boxes_to_corners_bev(A)  # [K,4,2]
    pb = boxes_to_corners_bev(B)
    cand = np.zeros((K, 24, 2))
    valid = np.zeros((K, 24), bool)
    cand[:, 0:4] = pa
    valid[:, 0:4] = _corners_in_box(pa, B)
    cand[:, 4:8] = pb
    valid[:, 4:8] = _corners_in_box(pb, A)

    # edge-edge crossings: edges a_i→a_{i+1}, b_j→b_{j+1}
    a1 = pa
    a2 = np.roll(pa, -1, axis=1)
    b1 = pb
    b2 = np.roll(pb, -1, axis=1)
    r = a2 - a1  # [K,4,2]
    sv = b2 - b1
    qp = b1[:, None, :, :] - a1[:, :, None, :]  # [K,4,4,2]
    rxs = r[:, :, None, 0] * sv[:, None, :, 1] - r[:, :, None, 1] * sv[:, None, :, 0]
    qpxs = qp[..., 0] * sv[:, None, :, 1] - qp[..., 1] * sv[:, None, :, 0]
    qpxr = qp[..., 0] * r[:, :, None, 1] - qp[..., 1] * r[:, :, None, 0]
    nz = np.abs(rxs) > _EPS
    denom = np.where(nz, rxs, 1.0)
    t = qpxs / denom
    u = qpxr / denom
    ok = nz & (t >= -1e-6) & (t <= 1 + 1e-6) & (u >= -1e-6) & (u <= 1 + 1e-6)
    pt = a1[:, :, None, :] + t[..., None] * r[:, :, None, :]
    cand[:, 8:24] = pt.reshape(K, 16, 2)
    valid[:, 8:24] = ok.reshape(K, 16)

    nval = valid.sum(-1)
    has = nval >= 3
    w = valid.astype(np.float64)
    centroid = (cand * w[..., None]).sum(1) / np.maximum(nval, 1)[..., None]
    rel = cand - centroid[:, None, :]
    ang = np.arctan2(rel[..., 1], rel[..., 0])
    ang = np.where(valid, ang, np.inf)
    order = np.argsort(ang, axis=-1)
    rel_sorted = np.take_along_axis(rel, order[..., None], axis=1)
    valid_sorted = np.take_along_axis(valid, order, axis=1)
    # invalid slots repeat the first (valid) point so they add zero area
    first = rel_sorted[:, 0:1, :]
    rel_sorted = np.where(valid_sorted[..., None], rel_sorted, first)
    nxt = np.roll(rel_sorted, -1, axis=1)
    cross = rel_sorted[..., 0] * nxt[..., 1] - rel_sorted[..., 1] * nxt[..., 0]
    area = 0.5 * np.abs(cross.sum(-1))
    return np.where(has, area, 0.0)


def nms_bev(boxes: np.ndarray, scores: np.ndarray, thresh: float,
            pre_maxsize: int | None = None, post_maxsize: int | None = None):
    """Greedy rotated-BEV NMS. Returns kept indices into the original
    arrays, highest score first."""
    order = np.argsort(-scores, kind='stable')
    if pre_maxsize is not None:
        order = order[:pre_maxsize]
    b = boxes[order]
    n = len(order)
    if n == 0:
        return np.zeros((0,), np.int64)
    # a higher-scored box i can only suppress a later box j > i whose
    # circumscribed circle meets its own
    rad = 0.5 * np.hypot(b[:, 3], b[:, 4])
    d2 = ((b[:, None, 0] - b[None, :, 0]) ** 2
          + (b[:, None, 1] - b[None, :, 1]) ** 2)
    near = d2 <= (rad[:, None] + rad[None, :] + 1e-3) ** 2
    i, j = np.nonzero(np.triu(near, 1))
    inter = pair_intersection_area(b[i], b[j])
    area = b[:, 3] * b[:, 4]
    iou = np.zeros((n, n))
    iou[i, j] = inter / np.clip(area[i] + area[j] - inter, 1e-6, None)
    suppressed = np.zeros(n, bool)
    keep = []
    for k in range(n):
        if suppressed[k]:
            continue
        keep.append(order[k])
        suppressed |= iou[k] > thresh
        suppressed[k] = True
    keep = np.asarray(keep, np.int64)
    if post_maxsize is not None:
        keep = keep[:post_maxsize]
    return keep
