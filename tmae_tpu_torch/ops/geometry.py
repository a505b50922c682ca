"""Rotated-box geometry on the device: BEV and 3D IoU and greedy rotated
NMS (counterpart of ``tmae_tpu/ops/geometry.py``).

The intersection of two rotated rectangles is rectangle A clipped by the
four half-planes of rectangle B (Sutherland–Hodgman) in 8 vertex slots, its
area by the shoelace formula. The plain versions repeat the JAX package's
arithmetic step for step in f32 (pad slots duplicate the first vertex, the
division guarded by ``|denom| > 1e-12``, fewer than 3 vertices give area 0),
and sum the shoelace's terms slot after slot, the order the kernels take.

The CUDA kernels (``csrc/iou_nms.cu``) share one device function that clips
one pair in registers with the same arithmetic:

* ``IOU_PAIRS``: BEV or 3D IoU of every pair, [N, M];
* ``IOU_ALIGNED``: 3D IoU of aligned pairs (the IoU-head loss), a pair on
  8 lanes of a warp, lane s holding vertex slot s;
* ``NMS_MASK``: the suppression bitmask of each sample's score-sorted
  candidates, uint64 [B, K, ceil(K / 64)]: bit j of row i is set when
  j > i, both are valid (in multi-class mode: of the same class) and
  their BEV IoU exceeds the (class's) threshold. It clips only the pairs
  of one class whose circumscribed circles may meet (``SKIP_ABS``,
  ``SKIP_REL``: a pair further apart has IoU exactly 0), spread over the
  threads of blocks of 16 row boxes against 64 column boxes;
* ``NMS_SCAN``: one warp per sample walks the rows in blocks of 64, its
  removed words in registers, and writes the keep mask [B, K], counting
  kept boxes (per class) against the cap; K at most ``SCAN_MAX_K``.

The per-class thresholds and caps (at most 32 classes) go to the launch by
value from the host.

Classes never suppress each other in multi-class mode, so one mask and one
scan give the JAX package's loop over classes. No function here syncs with
the host.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import as_kernel_arg, on_card
from ..utils.build import CudaKernel, I, P, stream_handle

IOU_PAIRS = CudaKernel('iou_nms.cu', 'launch_iou_pairs',
                       [P, P, I, I, I, P, P])
IOU_ALIGNED = CudaKernel('iou_nms.cu', 'launch_iou_aligned', [P, P, I, P, P])
NMS_MASK = CudaKernel('iou_nms.cu', 'launch_nms_mask',
                      [P, P, P, P, I, I, I, P, P])
NMS_SCAN = CudaKernel('iou_nms.cu', 'launch_nms_scan',
                      [P, P, P, P, I, I, I, P, P])

SLOTS = 8  # vertex slots: a rectangle clipped by a rectangle has at most 8
# NMS_MASK skips a pair when the distance of the centres exceeds the sum of
# the half diagonals plus SKIP_ABS metres plus SKIP_REL times the pair's
# coordinate scale (|x| + |y| of both centres and both radii): a margin
# over the f32 rounding of the corners and of the clip (csrc/iou_nms.cu
# kSkipAbs, kSkipRel)
SKIP_ABS = 1e-3
SKIP_REL = 1e-4
SCAN_MAX_K = 64 * 32 * 64  # NMS_SCAN: 64 removed words a lane of the warp
# f32 operations of one pair's clip as the kernel computes it: per edge of
# B, the signed distance of 8 slots (2 mul, 3 sub) and at most 2 crossings
# (sub, div, then sub, mul, add in x and y); the shoelace (2 mul, 1 sub,
# 1 add per slot), its half and abs; the IoU (2 add or sub, max, div).
PAIR_CLIP_FLOPS = 4 * (SLOTS * 5 + 2 * 8) + SLOTS * 4 + 2 + 4


def boxes_to_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 7] → [..., 4, 2] counter-clockwise BEV corners."""
    x, y = boxes[..., 0], boxes[..., 1]
    dx, dy, ang = boxes[..., 3], boxes[..., 4], boxes[..., 6]
    tmpl = torch.tensor([[0.5, 0.5], [-0.5, 0.5], [-0.5, -0.5], [0.5, -0.5]],
                        dtype=boxes.dtype, device=boxes.device)
    local = tmpl * torch.stack([dx, dy], -1)[..., None, :]
    c, s = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    rx = local[..., 0] * c - local[..., 1] * s
    ry = local[..., 0] * s + local[..., 1] * c
    return torch.stack([rx + x[..., None], ry + y[..., None]], -1)


def sh_intersection_area_flat(boxes_a: torch.Tensor,
                              boxes_b: torch.Tensor) -> torch.Tensor:
    """BEV intersection area of row-wise pairs: [K, 7] x [K, 7] → [K].
    Rectangle A clipped by the four half-planes of B in 8 slots, as the
    JAX package's ``_sh_intersection_area_flat`` does it."""
    K = boxes_a.shape[0]
    S = SLOTS
    dev, dt = boxes_a.device, boxes_a.dtype
    ca = boxes_to_corners_bev(boxes_a)
    cb = boxes_to_corners_bev(boxes_b)
    poly = torch.zeros(K, S, 2, dtype=dt, device=dev)
    poly[:, :4] = ca
    nvert = torch.full((K,), 4, dtype=torch.int64, device=dev)
    slot = torch.arange(S, device=dev).expand(K, S)
    for e in range(4):
        active = slot < nvert[:, None]
        # pad slots duplicate the first vertex, so roll(-1) is the cyclic
        # next vertex of every active slot
        poly = torch.where(active[..., None], poly, poly[:, :1])
        e0 = cb[:, e]
        ex = cb[:, (e + 1) % 4] - e0
        d = (ex[:, None, 0] * (poly[..., 1] - e0[:, None, 1])
             - ex[:, None, 1] * (poly[..., 0] - e0[:, None, 0]))
        inside_geo = d >= 0
        inside = inside_geo & active
        p_next = torch.roll(poly, -1, 1)
        d_next = torch.roll(d, -1, 1)
        inside_next = torch.roll(inside_geo, -1, 1)
        denom = d - d_next
        t = d / torch.where(denom.abs() > 1e-12, denom,
                            torch.ones((), dtype=dt, device=dev))
        xpt = poly + t[..., None] * (p_next - poly)
        crossing = (inside_geo ^ inside_next) & active
        # emit p if inside, then the crossing point: compact into S slots
        emit_pts = torch.stack([poly, xpt], 2).reshape(K, 2 * S, 2)
        emit_ok = torch.stack([inside, crossing], 2).reshape(K, 2 * S)
        pos = emit_ok.long().cumsum(1) - 1
        dest = torch.where(emit_ok & (pos < S), pos, S)
        buf = torch.zeros(K, S + 1, 2, dtype=dt, device=dev)
        buf.scatter_(1, dest[..., None].expand(K, 2 * S, 2), emit_pts)
        poly = buf[:, :S]
        nvert = emit_ok.sum(1).clamp(max=S)
    active = slot < nvert[:, None]
    poly = torch.where(active[..., None], poly, poly[:, :1])
    p_next = torch.roll(poly, -1, 1)
    crossz = poly[..., 0] * p_next[..., 1] - poly[..., 1] * p_next[..., 0]
    crossz = torch.where(active, crossz, 0.0)
    # summed slot after slot, in one written-out order, as the kernels sum
    total = crossz[:, 0]
    for s in range(1, S):
        total = total + crossz[:, s]
    return torch.where(nvert >= 3, 0.5 * total.abs(), 0.0)


def intersection_area_bev(boxes_a, boxes_b):
    """[N, 7] x [M, 7] → [N, M] BEV intersection areas (plain)."""
    N, M = boxes_a.shape[0], boxes_b.shape[0]
    a = boxes_a[:, :7].repeat_interleave(M, 0)
    b = boxes_b[:, :7].repeat(N, 1)
    return sh_intersection_area_flat(a, b).reshape(N, M)


def _iou3d_from_bev(inter_bev, a, b):
    """3D IoU from the BEV intersection and the boxes' z extents; ``a`` and
    ``b`` broadcast against ``inter_bev``."""
    amax, amin = a[..., 2] + a[..., 5] / 2, a[..., 2] - a[..., 5] / 2
    bmax, bmin = b[..., 2] + b[..., 5] / 2, b[..., 2] - b[..., 5] / 2
    inter_h = (torch.minimum(amax, bmax) - torch.maximum(amin, bmin)).clamp(
        min=0)
    inter = inter_bev * inter_h
    vol_a = a[..., 3] * a[..., 4] * a[..., 5]
    vol_b = b[..., 3] * b[..., 4] * b[..., 5]
    return inter / (vol_a + vol_b - inter).clamp(min=1e-6)


def boxes_iou_bev_plain(boxes_a, boxes_b):
    inter = intersection_area_bev(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return inter / (area_a + area_b - inter).clamp(min=1e-6)


def boxes_iou3d_plain(boxes_a, boxes_b):
    return _iou3d_from_bev(intersection_area_bev(boxes_a, boxes_b),
                           boxes_a[:, None], boxes_b[None, :])


def boxes_iou3d_aligned_plain(boxes_a, boxes_b):
    shp = boxes_a.shape[:-1]
    a = boxes_a.reshape(-1, boxes_a.shape[-1])[:, :7]
    b = boxes_b.reshape(-1, boxes_b.shape[-1])[:, :7]
    return _iou3d_from_bev(sh_intersection_area_flat(a, b), a, b).reshape(shp)


def _boxes_arg(boxes):
    return as_kernel_arg(boxes[..., :7] if boxes.shape[-1] != 7 else boxes,
                         torch.float32)


def _iou_pairs(boxes_a, boxes_b, mode: int):
    a, b = _boxes_arg(boxes_a), _boxes_arg(boxes_b)
    N, M = a.shape[0], b.shape[0]
    out = torch.empty(N, M, dtype=torch.float32, device=a.device)
    if N and M:
        IOU_PAIRS(a.data_ptr(), b.data_ptr(), N, M, mode, out.data_ptr(),
                  stream_handle())
    return out


def boxes_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor):
    """[N, 7] x [M, 7] → [N, M] BEV IoU (kernel ``IOU_PAIRS`` on the
    card)."""
    if not on_card(boxes_a, boxes_b):
        return boxes_iou_bev_plain(boxes_a, boxes_b)
    return _iou_pairs(boxes_a, boxes_b, 0)


def boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor):
    """[N, 7] x [M, 7] → [N, M] 3D IoU (kernel ``IOU_PAIRS`` on the
    card)."""
    if not on_card(boxes_a, boxes_b):
        return boxes_iou3d_plain(boxes_a, boxes_b)
    return _iou_pairs(boxes_a, boxes_b, 1)


def boxes_iou3d_aligned(boxes_a: torch.Tensor, boxes_b: torch.Tensor):
    """3D IoU of aligned pairs: [..., >=7] x [..., >=7] → [...] (kernel
    ``IOU_ALIGNED`` on the card). No gradient: its one user, the IoU-head
    loss, takes it as a target."""
    if not on_card(boxes_a, boxes_b):
        return boxes_iou3d_aligned_plain(boxes_a, boxes_b)
    shp = boxes_a.shape[:-1]
    a = _boxes_arg(boxes_a.detach().reshape(-1, boxes_a.shape[-1]))
    b = _boxes_arg(boxes_b.detach().reshape(-1, boxes_b.shape[-1]))
    out = torch.empty(a.shape[0], dtype=torch.float32, device=a.device)
    if a.shape[0]:
        IOU_ALIGNED(a.data_ptr(), b.data_ptr(), a.shape[0], out.data_ptr(),
                    stream_handle())
    return out.reshape(shp)


def class_params(thresh, post, multi: bool):
    """Per-class thresholds and caps as lists (one class unless
    ``multi``; ``post`` may be one int for all classes)."""
    if not multi:
        return [float(thresh)], [int(post)]
    threshs = [float(t) for t in thresh]
    posts = (list(post) if isinstance(post, (list, tuple))
             else [int(post)] * len(threshs))
    return threshs, [int(p) for p in posts]


def _class_index(valid, labels, ncls):
    """0-based class of each candidate, -1 where it takes no part (invalid,
    or a label outside 1..ncls)."""
    if labels is None:
        return torch.where(valid, 0, -1)
    lab = labels.long() - 1
    return torch.where(valid & (lab >= 0) & (lab < ncls), lab, -1)


def nms_mask_plain(boxes, valid, labels, threshs):
    """The suppression relation as bools [B, K, K]: [b, i, j] when j > i,
    both take part, they share a class and their BEV IoU exceeds that
    class's threshold (row i is box A of the clip)."""
    B, K = valid.shape
    cls = _class_index(valid, labels, len(threshs))
    th = torch.tensor(threshs, dtype=torch.float32, device=boxes.device)
    upper = torch.ones(K, K, dtype=torch.bool, device=boxes.device).triu(1)
    out = []
    for b in range(B):
        iou = boxes_iou_bev_plain(boxes[b, :, :7], boxes[b, :, :7])
        c = cls[b]
        same = (c[:, None] == c[None, :]) & (c[:, None] >= 0)
        out.append(upper & same & (iou > th[c.clamp(min=0)][:, None]))
    return torch.stack(out)


def nms_scan_plain(sup, valid, labels, posts):
    """Greedy walk over the rows of ``sup`` [B, K, K]: a candidate is kept
    when it takes part, no kept row suppressed it and its class has kept
    fewer than its cap. Returns keep [B, K] bool."""
    B, K = valid.shape
    dev = valid.device
    cls = _class_index(valid, labels, len(posts))
    cap = torch.tensor(posts, dtype=torch.int64, device=dev)
    count = torch.zeros(B, len(posts), dtype=torch.int64, device=dev)
    removed = torch.zeros(B, K, dtype=torch.bool, device=dev)
    keep = torch.zeros(B, K, dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)
    for i in range(K):
        c = cls[:, i].clamp(min=0)
        ok = (cls[:, i] >= 0) & ~removed[:, i] & (count[rows, c] < cap[c])
        keep[:, i] = ok
        count[rows, c] += ok.long()
        removed |= sup[:, i] & ok[:, None]
    return keep


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor, thresh, post,
             labels: torch.Tensor | None = None) -> torch.Tensor:
    """Greedy rotated-BEV NMS of each sample's candidates, sorted by
    descending score: boxes [B, K, >=7], valid [B, K] → keep [B, K] bool.

    With ``labels`` [B, K] (1-indexed) it is multi-class: ``thresh`` and
    ``post`` are per class (``post`` may be one int for all), a box only
    suppresses boxes of its own class, and each class keeps at most its
    cap. Without, one class: every valid box takes part, and at most
    ``post`` are kept. On the card: ``NMS_MASK`` then ``NMS_SCAN``."""
    threshs, posts = class_params(thresh, post, labels is not None)
    if not on_card(boxes, valid, labels):
        return nms_scan_plain(nms_mask_plain(boxes, valid, labels, threshs),
                              valid, labels, posts)
    return nms_scan_bits(nms_mask_bits(boxes, valid, threshs, labels),
                         valid, posts, labels)


def nms_mask_bits(boxes, valid, threshs, labels=None):
    """``NMS_MASK`` on the card (``threshs``: a list, one per class): the
    packed mask int64 [B, K, ceil(K / 64)], the kernel's uint64 words
    (:func:`unpack_mask` gives :func:`nms_mask_plain`'s bools)."""
    B, K = valid.shape
    dev = boxes.device
    mask = torch.empty(B, K, -(-K // 64), dtype=torch.int64, device=dev)
    if B and K:
        bx = _boxes_arg(boxes)
        vd = as_kernel_arg(valid, torch.bool)
        lab = None if labels is None else as_kernel_arg(labels, torch.int32)
        # host values: the launcher passes them by value
        th = (ctypes.c_float * len(threshs))(*threshs)
        NMS_MASK(bx.data_ptr(), vd.data_ptr(),
                 0 if lab is None else lab.data_ptr(), ctypes.addressof(th),
                 B, K, len(threshs), mask.data_ptr(), stream_handle())
    return mask


def nms_scan_bits(mask, valid, posts, labels=None):
    """``NMS_SCAN`` on the card over a packed mask from
    :func:`nms_mask_bits` (``posts``: a list, one cap per class): keep
    [B, K] bool."""
    B, K = valid.shape
    dev = valid.device
    if K > SCAN_MAX_K:
        raise ValueError(f'NMS_SCAN takes at most {SCAN_MAX_K} candidates a '
                         f'sample, got {K}')
    keep = torch.empty(B, K, dtype=torch.bool, device=dev)
    if B and K:
        vd = as_kernel_arg(valid, torch.bool)
        lab = None if labels is None else as_kernel_arg(labels, torch.int32)
        cap = (ctypes.c_int * len(posts))(*posts)
        NMS_SCAN(mask.data_ptr(), vd.data_ptr(),
                 0 if lab is None else lab.data_ptr(), ctypes.addressof(cap),
                 B, K, len(posts), keep.data_ptr(), stream_handle())
    return keep


def unpack_mask(mask: torch.Tensor, K: int) -> torch.Tensor:
    """int64 words [B, K, W] → bools [B, K, K] (bit j % 64 of word j // 64
    is column j)."""
    bits = torch.arange(64, device=mask.device)
    out = (mask[..., None] >> bits) & 1
    return out.reshape(*mask.shape[:-1], -1)[..., :K].bool()


def nms_bev_mask(boxes: torch.Tensor, scores: torch.Tensor,
                 valid: torch.Tensor, thresh: float,
                 post_maxsize: int) -> torch.Tensor:
    """Greedy rotated-BEV NMS of one sample (the JAX package's
    ``nms_bev_mask``): boxes [K, 7] sorted by descending score, ``valid``
    [K] marking real entries, first. Returns keep [K] with at most
    ``post_maxsize`` entries set. ``scores`` only documents the order."""
    return nms_keep(boxes[None], valid[None], thresh, post_maxsize)[0]


def nms_bev_mask_plain(boxes, valid, thresh: float, post_maxsize: int):
    """The JAX package's greedy loop itself, on the plain BEV IoU: each
    valid row in order is kept unless a kept row overlaps it above
    ``thresh``; then the first ``post_maxsize`` kept rows stay."""
    K = boxes.shape[0]
    sup = boxes_iou_bev_plain(boxes[:, :7], boxes[:, :7]) > thresh
    alive = torch.ones(K, dtype=torch.bool, device=boxes.device)
    kept = torch.zeros(K, dtype=torch.bool, device=boxes.device)
    for i in range(K):
        if bool(alive[i]) and bool(valid[i]):
            alive &= ~sup[i]
            kept[i] = True
    rank = kept.long().cumsum(0) - 1
    return kept & (rank < post_maxsize)
