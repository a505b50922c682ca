"""Synthetic two-frame LiDAR scenes at production occupancy (the port's own
copy of the lidar mode of ``tmae_tpu/datasets/once_temporal.py:269-389``).

A 40-beam spinning LiDAR (ONCE sensor class: -25..+15 deg elevation, sensor
~1.9 m above ground) is ray-cast against a rough ground plane, labelled boxes
and unlabelled building- and clutter-scale cuboids, which gives the ground
rings, object faces and occlusion shadows of real BEV grids. With
``density=1.5`` and 100k points a frame has the point count of a real ONCE
frame. ``frame_pair_batch`` adds the in-range mask, the padding to
``MAX_POINTS``, the sorted host voxelization that the serving path ships
(for configs with RUNTIME.HOST_VOXELIZE; without it the model voxelizes on
the device and the batch ships points only), and the scene's labelled boxes
as training takes them.
"""

from __future__ import annotations

import numpy as np

from ..ops.voxelize import VoxelSpec, voxelize_host

CLASS_DIMS = {
    'Car': (4.5, 1.9, 1.6), 'Bus': (11.0, 2.9, 3.2),
    'Truck': (8.0, 2.6, 3.0), 'Pedestrian': (0.7, 0.7, 1.7),
    'Cyclist': (1.8, 0.7, 1.7),
}


def make_scene(index: int, pc_range, class_names, n_box: int = 40) -> dict:
    """Labelled boxes plus occluders of scene ``index`` (seeded)."""
    rng = np.random.RandomState(1000 + index)
    pc = pc_range
    boxes = np.zeros((n_box, 7), np.float32)
    names = []
    margin = 6.0
    for i in range(n_box):
        cls = class_names[rng.randint(len(class_names))]
        d = CLASS_DIMS.get(cls, (4.0, 2.0, 1.6))
        boxes[i] = [
            rng.uniform(pc[0] + margin, pc[3] - margin),
            rng.uniform(pc[1] + margin, pc[4] - margin),
            rng.uniform(-1.0, 0.5),
            d[0] * rng.uniform(0.9, 1.1),
            d[1] * rng.uniform(0.9, 1.1),
            d[2] * rng.uniform(0.9, 1.1),
            rng.uniform(-np.pi, np.pi),
        ]
        names.append(cls)
    n_bld, n_clutter = 14, 150
    occl = np.zeros((n_bld + n_clutter, 7), np.float32)
    for i in range(n_bld):
        ang = rng.uniform(-np.pi, np.pi)
        r = rng.uniform(15.0, 70.0)
        occl[i] = [
            r * np.cos(ang), r * np.sin(ang), rng.uniform(1.0, 3.0),
            rng.uniform(5.0, 25.0), rng.uniform(3.0, 12.0),
            rng.uniform(4.0, 10.0), rng.uniform(-np.pi, np.pi),
        ]
    for i in range(n_bld, n_bld + n_clutter):
        ang = rng.uniform(-np.pi, np.pi)
        r = rng.uniform(5.0, 72.0)
        occl[i] = [
            r * np.cos(ang), r * np.sin(ang), rng.uniform(-1.5, 0.0),
            rng.uniform(0.5, 4.0), rng.uniform(0.5, 3.0),
            rng.uniform(0.5, 2.5), rng.uniform(-np.pi, np.pi),
        ]
    return {'boxes': boxes, 'names': np.asarray(names), 'occluders': occl}


def render_lidar(scene: dict, rng: np.random.RandomState, pc_range,
                 density: float = 1.5, max_points: int = 100000):
    """Ray-cast one sweep; returns [N, 4] (x, y, z, intensity) f32."""
    boxes = scene['boxes']
    occluders = scene['occluders']
    pc = pc_range
    n_beams = 40
    elev = np.deg2rad(np.linspace(-25.0, 15.0, n_beams))
    n_az = int(2048 * density)
    az = np.deg2rad(np.arange(n_az) * (360.0 / n_az) + rng.uniform(0, 0.25))
    ce, se = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(az), np.sin(az)
    dx = ce[:, None] * ca[None, :]
    dy = ce[:, None] * sa[None, :]
    dz = np.broadcast_to(se[:, None], dx.shape)
    t_best = np.full(dx.shape, np.inf, np.float32)
    zg = -1.9 + rng.uniform(-0.05, 0.05)
    zray = zg + rng.normal(0, 0.10, dx.shape)
    with np.errstate(divide='ignore'):
        t_g = np.where(dz < -1e-6, zray / dz, np.inf)
    t_best = np.minimum(t_best, t_g)
    for b in np.concatenate([boxes, occluders], axis=0):
        c, s = np.cos(b[6]), np.sin(b[6])
        ox = -(b[0] * c + b[1] * s)
        oy = -(-b[0] * s + b[1] * c)
        oz = -b[2]
        rdx = dx * c + dy * s
        rdy = -dx * s + dy * c
        tmin = np.full(dx.shape, 0.0, np.float32)
        tmax = np.full(dx.shape, np.inf, np.float32)
        for o, d, half in ((ox, rdx, b[3] / 2), (oy, rdy, b[4] / 2),
                           (oz, dz, b[5] / 2)):
            with np.errstate(divide='ignore', invalid='ignore'):
                inv = 1.0 / d
            t1 = (-half - o) * inv
            t2 = (half - o) * inv
            lo, hi = np.minimum(t1, t2), np.maximum(t1, t2)
            par_in = np.abs(d) < 1e-8
            inside = np.abs(o) <= half
            lo = np.where(par_in, np.where(inside, 0.0, np.inf), lo)
            hi = np.where(par_in, np.where(inside, np.inf, -np.inf), hi)
            tmin = np.maximum(tmin, lo)
            tmax = np.minimum(tmax, hi)
        t_hit = np.where((tmax >= tmin) & (tmin > 0.5), tmin, np.inf)
        t_best = np.minimum(t_best, t_hit)
    r_max = float(max(pc[3], pc[4])) * 1.5
    hit = np.isfinite(t_best) & (t_best < r_max)
    t = (t_best + rng.normal(0, 0.02, t_best.shape))[hit]
    px = (dx[hit] * t).astype(np.float32)
    py = (dy[hit] * t).astype(np.float32)
    pz = (dz[hit] * t).astype(np.float32)
    inten = rng.uniform(0, 1, len(px)).astype(np.float32)
    pts = np.stack([px, py, pz, inten], -1)
    if len(pts) > max_points:
        pts = pts[rng.choice(len(pts), max_points, replace=False)]
    return pts.astype(np.float32)


def in_range(points: np.ndarray, pc_range) -> np.ndarray:
    """Keep points inside the x/y range (mask_points_outside_range)."""
    m = ((points[:, 0] >= pc_range[0]) & (points[:, 0] <= pc_range[3])
         & (points[:, 1] >= pc_range[1]) & (points[:, 1] <= pc_range[4]))
    return points[m]


def pad_points(points: np.ndarray, max_points: int):
    out = np.zeros((max_points, points.shape[1]), np.float32)
    n = min(len(points), max_points)
    out[:n] = points[:n]
    mask = np.zeros((max_points,), bool)
    mask[:n] = True
    return out, mask


def gt_from_scene(scene: dict, class_names, max_gt: int):
    """The scene's boxes of the configured classes as ``gt_boxes``
    [max_gt, 8] (the label, 1-indexed in ``class_names`` order, in the last
    column) and ``gt_mask`` [max_gt], as the JAX package's dataset hands
    them to training (``prepare_data``)."""
    keep = np.array([n in class_names for n in scene['names']], bool)
    boxes = scene['boxes'][keep][:max_gt]
    labels = np.array([class_names.index(n) + 1
                       for n in scene['names'][keep][:max_gt]], np.float32)
    gt = np.zeros((max_gt, 8), np.float32)
    gt[:len(boxes), :7] = boxes
    gt[:len(boxes), 7] = labels
    mask = np.zeros((max_gt,), bool)
    mask[:len(boxes)] = True
    return gt, mask


def frame_pair_batch(spec: VoxelSpec, class_names, indices=(0,),
                     density: float = 1.5, points_per_frame: int = 100000,
                     n_box: int = 40, max_gt: int = 500,
                     host_voxelize: bool = True) -> dict:
    """Numpy batch of current/previous frame pairs of scenes ``indices``
    with the sorted host voxelization (``host_voxelize``; else the points
    as rendered) and the labelled boxes (``gt_boxes`` [B, max_gt, 8],
    ``gt_mask``), keyed as ``models/detectors.py`` expects."""
    pc = spec.pc_range
    class_names = list(class_names)
    frames = {'cur': [], 'prv': []}
    gts = []
    for index in indices:
        scene = make_scene(index, pc, class_names, n_box)
        gts.append(gt_from_scene(scene, class_names, max_gt))
        for which, base in (('cur', 2000), ('prv', 3000)):
            rng = np.random.RandomState(base + index)
            pts = in_range(render_lidar(scene, rng, pc, density,
                                        points_per_frame), pc)
            frames[which].append(pad_points(pts, spec.max_points))
    batch = {}
    for which, pk, mk in (('cur', 'points', 'point_mask'),
                          ('prv', 'points_prev', 'point_mask_prev')):
        pts = np.stack([p for p, _ in frames[which]])
        mask = np.stack([m for _, m in frames[which]])
        if not host_voxelize:
            batch[pk], batch[mk] = pts, mask
            continue
        hv = voxelize_host(pts, mask, spec, sort_points=True)
        batch[pk] = hv['points']
        batch[mk] = hv['point_mask']
        batch[f'pv_{which}'] = hv['point_voxel']
        batch[f'pvalid_{which}'] = hv['point_valid']
        batch[f'vcoords_{which}'] = hv['voxel_coords']
        batch[f'vmask_{which}'] = hv['voxel_mask']
        batch[f'vmean_{which}'] = hv['voxel_mean_xyz']
        batch[f'vends_{which}'] = hv['seg_ends']
    batch['gt_boxes'] = np.stack([g for g, _ in gts])
    batch['gt_mask'] = np.stack([m for _, m in gts])
    return batch
