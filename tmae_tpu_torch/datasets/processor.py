"""Point-cloud processors and static-shape collation (the port's copy of
``tmae_tpu/datasets/processor.py``; numpy, on the host).

Range mask, shuffle, grid size, point sampling and the host voxelizer of the
precomputed-voxel families, the image processors of the camera pipeline
(``imrescale``, ``imflip``, ``imnormalize``, ``impad``: ``image_ops.py``),
channel selection, and the collation of samples into fixed [B, P, C] /
[B, M, 8] arrays with masks.

Beyond the JAX package's batch, a camera sample carries what F16 needs
(ROADMAP.md, found in the reference): ``image_scale`` (w, h), the scale
``imrescale`` applied to the raw image, ``image_shape`` (h, w), the image's
shape before ``impad``, and with ``imflip`` configured ``image_flip``; the
collation stacks them beside ``images``. F17: a batch whose samples are
not all world-transformed (``random_world_flip`` draws for each sample)
gets ``aug_inverse`` for every sample, the identity where there was no
transform; the JAX package's collation raises or leaves it out.
"""

from __future__ import annotations

import numpy as np

from .image_ops import imflip, imnormalize, impad, imrescale


def mask_points_outside_range(points, pc_range):
    m = (
        (points[:, 0] >= pc_range[0]) & (points[:, 0] <= pc_range[3])
        & (points[:, 1] >= pc_range[1]) & (points[:, 1] <= pc_range[4])
    )
    return points[m]


def mask_boxes_outside_range(gt_boxes, pc_range):
    m = (
        (gt_boxes[:, 0] >= pc_range[0]) & (gt_boxes[:, 0] <= pc_range[3])
        & (gt_boxes[:, 1] >= pc_range[1]) & (gt_boxes[:, 1] <= pc_range[4])
    )
    return m


class DataProcessor:
    def __init__(self, processor_cfgs, pc_range, training, rng=None):
        self.pc_range = np.asarray(pc_range, np.float32)
        self.training = training
        self.rng = rng or np.random.RandomState()
        self.voxel_size = None
        self.grid_size = None
        self.cfgs = list(processor_cfgs)
        for cfg in self.cfgs:
            if cfg['NAME'] in ('calculate_grid_size', 'transform_points_to_voxels'):
                vs = np.asarray(cfg['VOXEL_SIZE'], np.float64)
                self.voxel_size = vs
                self.grid_size = np.round(
                    (self.pc_range[3:6] - self.pc_range[0:3]) / vs
                ).astype(np.int64)

    def __call__(self, data):
        for cfg in self.cfgs:
            name = cfg['NAME']
            if name == 'mask_points_and_boxes_outside_range':
                for key in ('points', 'points_prev'):
                    if data.get(key) is not None:
                        data[key] = mask_points_outside_range(
                            data[key], self.pc_range
                        )
                if (
                    data.get('gt_boxes') is not None
                    and cfg.get('REMOVE_OUTSIDE_BOXES', True) and self.training
                ):
                    m = mask_boxes_outside_range(data['gt_boxes'], self.pc_range)
                    data['gt_boxes'] = data['gt_boxes'][m]
                    if data.get('gt_names') is not None:
                        data['gt_names'] = data['gt_names'][m]
            elif name == 'shuffle_points':
                enabled = cfg['SHUFFLE_ENABLED']['train' if self.training else 'test']
                if enabled:
                    for key in ('points', 'points_prev'):
                        if data.get(key) is not None:
                            perm = self.rng.permutation(len(data[key]))
                            data[key] = data[key][perm]
            elif name == 'sample_points':
                n = cfg['NUM_POINTS']['train' if self.training else 'test']
                for key in ('points', 'points_prev'):
                    pts = data.get(key)
                    if pts is None:
                        continue
                    if len(pts) > n:
                        idx = self.rng.choice(len(pts), n, replace=False)
                        data[key] = pts[idx]
            elif name == 'imrescale':
                scales = cfg['IMAGE_SCALES']['train' if self.training
                                             else 'test']
                img, (ws, hs) = imrescale(
                    data['image'], scales, cfg.get('KEEP_RATIO', True),
                    self.rng,
                )
                data['image'] = img
                data['image_scale'] = data['image_scale'] * np.asarray(
                    [ws, hs], np.float32)
                data['image_shape'] = np.asarray(img.shape[:2], np.int32)
            elif name == 'imflip':
                ratio = cfg['FLIP_RATIO']['train' if self.training else 'test']
                flip = bool(self.rng.rand() < ratio)
                if flip:
                    data['image'] = imflip(data['image'])
                data['image_flip'] = np.asarray(
                    flip != bool(data.get('image_flip', False)))
            elif name == 'imnormalize':
                data['image'] = imnormalize(
                    data['image'], cfg['MEAN'], cfg['STD'],
                    cfg.get('TO_RGB', False),
                )
            elif name == 'impad':
                data['image'] = impad(data['image'], cfg['SIZE_DIVISOR'])
            elif name in ('calculate_grid_size', 'transform_points_to_voxels'):
                data['grid_size'] = self.grid_size
                data['voxel_size'] = self.voxel_size
                if name == 'transform_points_to_voxels':
                    data.update(self.voxelize_host(
                        data['points'],
                        max_points_per_voxel=cfg.get('MAX_POINTS_PER_VOXEL', 32),
                        max_voxels=cfg.get('MAX_NUMBER_OF_VOXELS', {}).get(
                            'train' if self.training else 'test', 40000),
                    ))
        return data

    def voxelize_host(self, points, max_points_per_voxel=32, max_voxels=40000):
        """Host voxelizer (spconv VoxelGenerator equivalent) for precomputed-voxel
        model families. Returns voxels [N, T, C], coords [N, 3] (z,y,x), counts."""
        vs = self.voxel_size
        coords = np.floor(
            (points[:, :3] - self.pc_range[:3]) / vs
        ).astype(np.int64)
        valid = np.all((coords >= 0) & (coords < self.grid_size), axis=1)
        points, coords = points[valid], coords[valid]
        ids = (coords[:, 2] * self.grid_size[1] + coords[:, 1]) * self.grid_size[0] \
            + coords[:, 0]
        order = np.argsort(ids, kind='stable')
        ids_s = ids[order]
        uniq, starts, counts = np.unique(ids_s, return_index=True,
                                         return_counts=True)
        n = min(len(uniq), max_voxels)
        T = max_points_per_voxel
        C = points.shape[1]
        voxels = np.zeros((n, T, C), np.float32)
        vcoords = np.zeros((n, 3), np.int64)
        vnum = np.zeros((n,), np.int64)
        for i in range(n):
            sel = order[starts[i]:starts[i] + min(counts[i], T)]
            voxels[i, :len(sel)] = points[sel]
            vnum[i] = len(sel)
            c = coords[sel[0]]
            vcoords[i] = [c[2], c[1], c[0]]  # (z, y, x)
        return {'voxels': voxels, 'voxel_coords_zyx': vcoords,
                'voxel_num_points': vnum}


class PointFeatureEncoder:
    """Channel selection (point_feature_encoder.py:45-57): keeps the channels in
    ``used_feature_list`` order out of ``src_feature_list``."""

    def __init__(self, cfg):
        self.src = list(cfg['src_feature_list'])
        self.used = list(cfg['used_feature_list'])

    @property
    def num_point_features(self):
        return len(self.used)

    def __call__(self, points):
        idx = [self.src.index(u) for u in self.used]
        return points[:, idx]


def pad_to(arr, n, axis=0):
    """Pad (or truncate) along axis to exactly n rows; returns (arr, valid_mask)."""
    cur = arr.shape[axis]
    if cur >= n:
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(0, n)
        out = arr[tuple(sl)]
        mask = np.ones(n, bool)
    else:
        pad = [(0, 0)] * arr.ndim
        pad[axis] = (0, n - cur)
        out = np.pad(arr, pad)
        mask = np.zeros(n, bool)
        mask[:cur] = True
    return out, mask


def collate_static(samples, max_points, max_gt, max_voxels=None):
    """Static-shape batch: replaces the reference's ragged ``collate_batch``
    (dataset.py:190-239) with fixed [B, P, C] / [B, M, 8] arrays + masks."""
    B = len(samples)
    out = {}
    keys = samples[0].keys()
    pts0 = samples[0]['points']
    Cp = pts0.shape[1]
    points = np.zeros((B, max_points, Cp), np.float32)
    pmask = np.zeros((B, max_points), bool)
    has_prev = 'points_prev' in keys and samples[0]['points_prev'] is not None
    if has_prev:
        points_prev = np.zeros((B, max_points, Cp), np.float32)
        pmask_prev = np.zeros((B, max_points), bool)
    has_gt = 'gt_boxes' in keys and samples[0].get('gt_boxes') is not None
    if has_gt:
        Cg = samples[0]['gt_boxes'].shape[1]
        gt = np.zeros((B, max_gt, Cg), np.float32)
        gmask = np.zeros((B, max_gt), bool)
    frame_ids = []
    for b, s in enumerate(samples):
        points[b], pmask[b] = pad_to(s['points'].astype(np.float32), max_points)
        if has_prev:
            points_prev[b], pmask_prev[b] = pad_to(
                s['points_prev'].astype(np.float32), max_points
            )
        if has_gt:
            gt[b], gmask[b] = pad_to(s['gt_boxes'].astype(np.float32), max_gt)
        frame_ids.append(s.get('frame_id', b))
    out.update({'points': points, 'point_mask': pmask})
    if has_prev:
        out.update({'points_prev': points_prev, 'point_mask_prev': pmask_prev})
    if has_gt:
        out.update({'gt_boxes': gt, 'gt_mask': gmask})
    # host-voxelized inputs (transform_points_to_voxels path)
    if 'voxels' in keys:
        Vmax = max_voxels or max(len(s['voxels']) for s in samples)
        T, Cv = samples[0]['voxels'].shape[1:]
        voxels = np.zeros((B, Vmax, T, Cv), np.float32)
        vnum = np.zeros((B, Vmax), np.int64)
        vcoords = np.zeros((B, Vmax, 2), np.int32)
        vcoords_zyx = np.zeros((B, Vmax, 3), np.int32)
        vmask = np.zeros((B, Vmax), bool)
        for b, s in enumerate(samples):
            n = min(len(s['voxels']), Vmax)
            s = {k: (v[:n] if k in ('voxels', 'voxel_num_points',
                                    'voxel_coords_zyx') else v)
                 for k, v in s.items()}
            voxels[b, :n] = s['voxels']
            vnum[b, :n] = s['voxel_num_points']
            vcoords[b, :n] = s['voxel_coords_zyx'][:, 1:3]  # (y, x)
            vcoords_zyx[b, :n] = s['voxel_coords_zyx']
            vmask[b, :n] = True
        out.update({'voxels': voxels, 'voxel_num_points': vnum,
                    'voxel_coords': vcoords, 'voxel_coords_zyx': vcoords_zyx,
                    'voxel_mask': vmask})
    # camera inputs (all images must share a shape: imrescale to a single
    # scale + impad make that deterministic)
    if 'image' in keys and samples[0].get('image') is not None:
        out['images'] = np.stack(
            [s['image'].astype(np.float32) for s in samples])
        for k in ('trans_lidar_to_cam', 'trans_cam_to_img'):
            if samples[0].get(k) is not None:
                out[k] = np.stack([s[k].astype(np.float32) for s in samples])
        for k in ('image_scale', 'image_shape', 'image_flip'):
            if samples[0].get(k) is not None:
                out[k] = np.stack([s[k] for s in samples])
    # F17: a world transform that may not happen (random_world_flip)
    # leaves some samples without aug_matrix; they get the identity
    mats = [s.get('aug_matrix') for s in samples]
    if any(m is not None for m in mats):
        eye = np.eye(4, dtype=np.float32)
        out['aug_inverse'] = np.stack([
            np.linalg.inv(eye if m is None else m).astype(np.float32)
            for m in mats
        ])
    out['frame_id'] = frame_ids
    return out
