"""Synthetic two-frame LiDAR scenes at production occupancy (the port's own
copy of the lidar mode of ``tmae_tpu/datasets/once_temporal.py:269-389``); ``make_scene`` and
``render_lidar`` also make the scenes and frames of
``datasets/once_temporal.SyntheticONCEDataset`` in its lidar mode.

A 40-beam spinning LiDAR (ONCE sensor class: -25..+15 deg elevation, sensor
~1.9 m above ground) is ray-cast against a rough ground plane, labelled boxes
and unlabelled building- and clutter-scale cuboids, which gives the ground
rings, object faces and occlusion shadows of real BEV grids. With
``density=1.5`` and 100k points a frame has the point count of a real ONCE
frame. ``frame_pair_batch`` adds the in-range mask, the padding to
``MAX_POINTS``, the sorted host voxelization that the serving path ships
(for configs with RUNTIME.HOST_VOXELIZE; without it the model voxelizes on
the device and the batch ships points only), and the scene's labelled boxes
as training takes them. ``waymo_sequence`` renders the same scenes as
Waymo TFRecord frames: the top LiDAR's range images from a moving vehicle.
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
    t_best = ray_cast(np.concatenate([boxes, occluders], axis=0), dx, dy, dz,
                      rng)
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


def ray_cast(cuboids, dx, dy, dz, rng, ground=-1.9):
    """Distance along each unit ray (dx, dy, dz) from the sensor at the
    origin to its first hit: a rough ground plane ``ground`` m below it
    (drawn from ``rng``) or a cuboid of ``cuboids`` [N, 7]; inf where
    nothing is hit."""
    t_best = np.full(dx.shape, np.inf, np.float32)
    zg = ground + rng.uniform(-0.05, 0.05)
    zray = zg + rng.normal(0, 0.10, dx.shape)
    with np.errstate(divide='ignore'):
        t_g = np.where(dz < -1e-6, zray / dz, np.inf)
    t_best = np.minimum(t_best, t_g)
    for b in cuboids:
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
    return t_best


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
                     host_voxelize: bool = True,
                     num_point_features: int = 4) -> dict:
    """Numpy batch of current/previous frame pairs of scenes ``indices``
    with the sorted host voxelization (``host_voxelize``; else the points
    as rendered) and the labelled boxes (``gt_boxes`` [B, max_gt, 8],
    ``gt_mask``), keyed as ``models/detectors.py`` expects. Points carry
    x, y, z, intensity and, past 4 ``num_point_features`` (Waymo's
    elongation), columns drawn uniform in [0, 0.2) after the render."""
    pc = spec.pc_range
    class_names = list(class_names)
    frames = {'cur': [], 'prv': []}
    gts = []
    for index in indices:
        scene = make_scene(index, pc, class_names, n_box)
        gts.append(gt_from_scene(scene, class_names, max_gt))
        for which, base in (('cur', 2000), ('prv', 3000)):
            rng = np.random.RandomState(base + index)
            pts = render_lidar(scene, rng, pc, density, points_per_frame)
            extra = rng.uniform(0, 0.2, (len(pts), num_point_features - 4))
            pts = in_range(np.concatenate(
                [pts, extra.astype(np.float32)], 1), pc)
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


# ---------------------------------------------------------------------------
# Waymo sequences: the scenes above seen by Waymo's top LiDAR from a moving
# vehicle, written as TFRecords of Frame protos (datasets/waymo_decode.py)
# ---------------------------------------------------------------------------

WAYMO_BEAMS, WAYMO_COLUMNS = 64, 2650      # the top LiDAR's range image
WAYMO_INCLINATION = (np.deg2rad(-17.6), np.deg2rad(2.4))
WAYMO_TOP_HEIGHT = 1.9   # the sensor above the vehicle frame's ground
WAYMO_TYPES = {'Vehicle': 1, 'Pedestrian': 2, 'Cyclist': 4}
TOP_LIDAR = 1            # LaserName.TOP


def waymo_pose(fi: int) -> np.ndarray:
    """Vehicle-to-world pose [4, 4] of frame ``fi`` (10 Hz) of a vehicle
    that drives at 10 m/s and turns at 0.05 rad/s."""
    yaw = 0.005 * fi
    pose = np.eye(4)
    pose[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    pose[:2, 3] = [fi * np.cos(yaw / 2), fi * np.sin(yaw / 2)]
    return pose


def boxes_in_frame(boxes: np.ndarray, pose: np.ndarray,
                   z_offset: float = 0.0) -> np.ndarray:
    """World boxes [N, 7] in the frame of the vehicle at ``pose``, then
    ``z_offset`` added to their z."""
    inv = np.linalg.inv(pose)
    out = np.asarray(boxes, np.float64).copy()
    out[:, :3] = boxes[:, :3] @ inv[:3, :3].T + inv[:3, 3]
    out[:, 2] += z_offset
    out[:, 6] = (boxes[:, 6] - np.arctan2(pose[1, 0], pose[0, 0])
                 + np.pi) % (2 * np.pi) - np.pi
    return out


def render_range_image(scene: dict, pose: np.ndarray,
                       rng: np.random.RandomState, pc_range):
    """One sweep of the top LiDAR from the vehicle at ``pose`` over the
    world ``scene`` (whose ground is 1.9 m below the sensor): range
    image [64, 2650, 4] (range, -1 where nothing is hit within 75 m;
    intensity; elongation; NLZ, 1 inside the scene's no-label zones
    ``scene['nlz']`` and -1 elsewhere) in the decoder's beam and column
    convention (``waymo_decode.range_image_to_points``: row 0 the highest
    beam, column 0 just under +pi azimuth), and the count of its points
    inside the x/y range of ``pc_range``."""
    H, W = WAYMO_BEAMS, WAYMO_COLUMNS
    incl = np.linspace(*WAYMO_INCLINATION, H)[::-1]
    azimuth = ((np.arange(W, 0, -1) - 0.5) / W * 2 - 1) * np.pi
    ci, si = np.cos(incl)[:, None], np.sin(incl)[:, None]
    dx = ci * np.cos(azimuth)[None, :]
    dy = ci * np.sin(azimuth)[None, :]
    dz = np.broadcast_to(si, dx.shape)
    # the cuboids in the sensor's frame (the scene's z is the sensor's)
    cuboids = boxes_in_frame(np.concatenate([scene['boxes'],
                                             scene['occluders']]), pose)
    t = ray_cast(cuboids, dx, dy, dz, rng)
    # a return lost on a quarter of the rays (dark or specular surfaces)
    hit = np.isfinite(t) & (t < 75.0) & (rng.uniform(size=t.shape) >= 0.25)
    rng_m = np.where(hit, t + rng.normal(0, 0.02, t.shape), -1.0)
    ri = np.zeros((H, W, 4), np.float32)
    ri[..., 0] = rng_m
    ri[..., 1] = np.where(hit, rng.uniform(0, 1.5, t.shape), 0)
    ri[..., 2] = np.where(hit, rng.uniform(0, 0.2, t.shape), 0)
    xy = np.stack([dx * rng_m, dy * rng_m], -1)
    nlz = np.zeros(t.shape, bool)
    for zone in scene['nlz']:
        c = zone[:2] - pose[:2, 3]
        rot = pose[:2, :2].T @ c
        nlz |= np.all(np.abs(xy - rot) <= zone[2:4] / 2, -1)
    ri[..., 3] = np.where(hit & nlz, 1.0, -1.0)
    n_in_range = int((hit & (np.abs(xy[..., 0]) <= pc_range[3])
                      & (np.abs(xy[..., 1]) <= pc_range[4])).sum())
    return ri, n_in_range


def waymo_sequence(index: int, n_frames: int, pc_range, class_names,
                   name: str):
    """Frame protos (bytes) of a ``n_frames`` sequence of scene ``index``
    (``make_scene``, static in the world; two 12 m no-label zones beside
    the path) seen from a vehicle moving as ``waymo_pose`` says: per
    frame the top
    LiDAR's range image with its pixel poses (the frame's pose at every
    pixel), the calibration (the sensor 1.9 m above the vehicle frame,
    64 beams between -17.6 and +2.4 degrees), the pose and the labelled
    boxes in the vehicle frame. Returns (frames, in-range point count of
    each frame)."""
    from .waymo_decode import encode_frame

    scene = make_scene(index, pc_range, list(class_names))
    # (x, y, dx, dy) of the no-label zones, beside the vehicle's path
    scene['nlz'] = np.array([[5.0, 15.0, 12.0, 12.0],
                             [-10.0, -20.0, 12.0, 12.0]])
    extrinsic = np.eye(4)
    extrinsic[2, 3] = WAYMO_TOP_HEIGHT
    calib = {TOP_LIDAR: (extrinsic, *WAYMO_INCLINATION, ())}
    keep = np.array([n in WAYMO_TYPES for n in scene['names']], bool)
    frames, counts = [], []
    for fi in range(n_frames):
        pose = waymo_pose(fi)
        ri, n_in_range = render_range_image(
            scene, pose, np.random.RandomState(8000 + 100 * index + fi),
            pc_range)
        yaw = np.arctan2(pose[1, 0], pose[0, 0])
        pixel_pose = np.zeros(ri.shape[:2] + (6,), np.float32)
        pixel_pose[..., 2] = yaw
        pixel_pose[..., 3:5] = pose[:2, 3]
        boxes = boxes_in_frame(scene['boxes'][keep], pose, WAYMO_TOP_HEIGHT)
        labels = [(b, WAYMO_TYPES[n])
                  for b, n in zip(boxes, scene['names'][keep])]
        frames.append(encode_frame(
            name, 1_000_000 + 100_000 * fi, pose,
            {TOP_LIDAR: (ri, pixel_pose)}, calib, labels))
        counts.append(n_in_range)
    return frames, counts
