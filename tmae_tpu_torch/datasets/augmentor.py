"""World augmentations and the GT-database paste augmentation (the port's
copy of ``tmae_tpu/datasets/augmentor.py``; numpy, on the host).

Each world transform draws its parameters once from the dataset's
``RandomState`` and applies them to both frames and the boxes; the draws
happen in the JAX package's order, so one seed gives the same sample there
and here. Sampled GT objects are pasted into both frames. The camera
augmentation ``photo_metric_distortion`` (``image_ops.py``) draws from the
same ``RandomState`` in its place in the queue.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..ops.geometry_np import boxes_iou_bev
from .image_ops import photo_metric_distortion


def rotate_points_z(points, angle):
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], points.dtype)
    out = points.copy()
    out[:, :3] = points[:, :3] @ rot
    return out


def _apply_flip(points, axis):
    points = points.copy()
    if axis == 'x':
        points[:, 1] = -points[:, 1]
    else:
        points[:, 0] = -points[:, 0]
    return points


def _compose_aug(data, mat4):
    """Record the world transform as one composed 4x4 matrix. The reference
    keeps a named replay list (``transformation_3d_list/params``); here the
    linear transforms compose into ``aug_matrix`` (world ← original), whose
    inverse lets PointSample project augmented points back to camera frames."""
    prev = data.get('aug_matrix')
    if prev is None:
        prev = np.eye(4, dtype=np.float32)
    data['aug_matrix'] = (mat4.astype(np.float32) @ prev)


class WorldTransforms:
    """Samples parameters once and applies them to every array of the sample
    (points, points_prev, gt_boxes) — the reference's replayed
    ``transformation_3d_params`` (data_augmentor.py:240-241)."""

    @staticmethod
    def random_world_flip(data, cfg, rng):
        axes = [a for a in cfg['ALONG_AXIS_LIST']
                if rng.rand() < cfg.get('PROBABILITY', 1.0)]
        for ax in axes:
            for key in ('points', 'points_prev'):
                if data.get(key) is not None:
                    data[key] = _apply_flip(data[key], ax)
            gt = data.get('gt_boxes')
            if gt is not None and len(gt):
                if ax == 'x':
                    gt[:, 1] = -gt[:, 1]
                    gt[:, 6] = -gt[:, 6]
                else:
                    gt[:, 0] = -gt[:, 0]
                    gt[:, 6] = -(gt[:, 6] + np.pi)
            m = np.eye(4)
            if ax == 'x':
                m[1, 1] = -1
            else:
                m[0, 0] = -1
            _compose_aug(data, m)
        return data

    @staticmethod
    def random_world_rotation(data, cfg, rng):
        if rng.rand() >= cfg.get('PROBABILITY', 1.0):
            ang = 0.0
        else:
            lo, hi = cfg['WORLD_ROT_ANGLE']
            ang = rng.uniform(lo, hi)
        for key in ('points', 'points_prev'):
            if data.get(key) is not None:
                data[key] = rotate_points_z(data[key], ang)
        gt = data.get('gt_boxes')
        if gt is not None and len(gt):
            gt[:, 0:3] = rotate_points_z(gt[:, 0:3].copy(), ang)
            gt[:, 6] += ang
        m = np.eye(4)
        c_, s_ = np.cos(ang), np.sin(ang)
        m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c_, -s_, s_, c_
        _compose_aug(data, m)
        return data

    @staticmethod
    def random_world_scaling(data, cfg, rng):
        if rng.rand() >= cfg.get('PROBABILITY', 1.0):
            s = 1.0
        else:
            lo, hi = cfg['WORLD_SCALE_RANGE']
            s = rng.uniform(lo, hi)
        for key in ('points', 'points_prev'):
            if data.get(key) is not None:
                data[key][:, :3] *= s
        gt = data.get('gt_boxes')
        if gt is not None and len(gt):
            gt[:, :6] *= s
        m = np.eye(4)
        m[0, 0] = m[1, 1] = m[2, 2] = s
        _compose_aug(data, m)
        return data

    @staticmethod
    def random_world_translation(data, cfg, rng):
        if rng.rand() >= cfg.get('PROBABILITY', 1.0):
            std = [0.0, 0.0, 0.0]
        else:
            std = cfg['NOISE_TRANSLATE_STD']
            if not isinstance(std, (list, tuple)):
                std = [std] * 3
        t = np.array([rng.normal(0, s) for s in std], np.float32)
        for key in ('points', 'points_prev'):
            if data.get(key) is not None:
                data[key][:, :3] += t
        gt = data.get('gt_boxes')
        if gt is not None and len(gt):
            gt[:, :3] += t
        m = np.eye(4)
        m[:3, 3] = t
        _compose_aug(data, m)
        return data

    @staticmethod
    def random_world_drop(data, cfg, rng):
        ratio = cfg['DROP_RATIO'] if rng.rand() < cfg.get('PROBABILITY', 1.0) else 0.0
        for key in ('points', 'points_prev'):
            pts = data.get(key)
            if pts is not None and ratio > 0:
                n = len(pts)
                keep = rng.choice(n, int((1 - ratio) * n), replace=False)
                data[key] = pts[keep]
        return data


def points_in_boxes_mask(points, boxes, margin=0.0):
    """[P] bool — point inside any (enlarged) rotated box. Host-side replacement
    for ``roiaware_pool3d.points_in_boxes_cpu`` on the sampler path."""
    if len(boxes) == 0 or len(points) == 0:
        return np.zeros(len(points), bool)
    mask = np.zeros(len(points), bool)
    for b in boxes:
        d = points[:, :2] - b[0:2]
        c, s = np.cos(b[6]), np.sin(b[6])
        u = d[:, 0] * c + d[:, 1] * s
        v = -d[:, 0] * s + d[:, 1] * c
        inside = (
            (np.abs(u) <= b[3] / 2 + margin)
            & (np.abs(v) <= b[4] / 2 + margin)
            & (np.abs(points[:, 2] - b[2]) <= b[5] / 2 + margin)
        )
        mask |= inside
    return mask


class DataBaseSampler:
    """GT-database paste augmentation (database_sampler.py): per-class sample
    groups with epoch-persistent pointers, BEV-IoU collision rejection, scene-point
    carving, paste into both frames."""

    def __init__(self, root_path, sampler_cfg, class_names, rng=None):
        self.root_path = Path(root_path) if root_path else None
        self.cfg = sampler_cfg
        self.class_names = list(class_names)
        self.rng = rng or np.random.RandomState()
        self.db_infos = {c: [] for c in class_names}
        for info_path in sampler_cfg.get('DB_INFO_PATH', []):
            p = Path(info_path)
            if not p.is_absolute() and self.root_path is not None:
                p = self.root_path / p
            if p.exists():
                with open(p, 'rb') as f:
                    infos = pickle.load(f)
                for c in class_names:
                    self.db_infos[c].extend(infos.get(c, []))
        for prep_key, val in sampler_cfg.get('PREPARE', {}).items():
            if prep_key == 'filter_by_min_points':
                for spec in val:
                    name, n = spec.split(':')
                    n = int(n)
                    self.db_infos[name] = [
                        i for i in self.db_infos.get(name, [])
                        if i['num_points_in_gt'] >= n
                    ]
            elif prep_key == 'filter_by_difficulty':
                for c in class_names:
                    self.db_infos[c] = [
                        i for i in self.db_infos.get(c, [])
                        if i.get('difficulty', 0) not in val
                    ]
        self.sample_groups = {}
        for g in sampler_cfg.get('SAMPLE_GROUPS', []):
            name, n = g.split(':')
            if name in class_names:
                self.sample_groups[name] = {
                    'num': int(n), 'pointer': len(self.db_infos.get(name, [])),
                    'indices': None,
                }
        self.limit_whole_scene = sampler_cfg.get('LIMIT_WHOLE_SCENE', False)
        self.num_point_features = int(sampler_cfg.get('NUM_POINT_FEATURES', 4))
        # FADE_EPOCH: stop pasting after this epoch (database_sampler.py:224-225)
        self.fade_epoch = sampler_cfg.get('FADE_EPOCH', None)
        self.cur_epoch = 0
        # /dev/shm gt-database cache (database_sampler.py:60-95): the reference
        # stacks every object's points into one SharedArray; here the stacked
        # array is an .npy in /dev/shm opened with mmap — the kernel page cache
        # makes it a single physical copy shared by all loader workers.
        self._shm_data = None
        self._shm_offsets = {}
        if sampler_cfg.get('USE_SHARED_MEMORY', False):
            self._setup_shared_memory(
                sampler_cfg.get('SHARED_MEMORY_KEY', 'tmae_gt_database')
            )

    def _setup_shared_memory(self, key):
        import os
        import tempfile

        shm_dir = Path('/dev/shm')
        if not shm_dir.is_dir():
            return
        data_path = shm_dir / f'{key}.npy'
        off_path = shm_dir / f'{key}.offsets.pkl'
        if not (data_path.exists() and off_path.exists()):
            chunks, offsets, cursor = [], {}, 0
            for c in self.class_names:
                for info in self.db_infos.get(c, []):
                    if 'path' not in info:
                        continue
                    pts = self._read_obj_file(info)
                    if pts is None:
                        continue
                    offsets[info['path']] = (cursor, cursor + len(pts))
                    cursor += len(pts)
                    chunks.append(pts)
            if not chunks:
                return
            stacked = np.concatenate(chunks, axis=0)
            # atomic publish: first process wins, racers overwrite identically
            fd, tmp = tempfile.mkstemp(dir=shm_dir, suffix='.npy')
            os.close(fd)
            np.save(tmp, stacked)  # suffix is .npy so no extension is added
            os.replace(tmp, data_path)
            fd, tmp = tempfile.mkstemp(dir=shm_dir, suffix='.pkl')
            with os.fdopen(fd, 'wb') as f:
                pickle.dump(offsets, f)
            os.replace(tmp, off_path)
        self._shm_data = np.load(data_path, mmap_mode='r')
        with open(off_path, 'rb') as f:
            self._shm_offsets = pickle.load(f)

    def _read_obj_file(self, info):
        path = self.root_path / info['path'] if self.root_path else None
        if path is None or not path.exists():
            return None
        return np.fromfile(path, dtype=np.float32).reshape(
            -1, self.num_point_features
        )

    def _sample_class(self, name, num):
        infos = self.db_infos.get(name, [])
        if not infos or num <= 0:
            return []
        g = self.sample_groups[name]
        if g['pointer'] + num >= len(infos):
            g['indices'] = self.rng.permutation(len(infos))
            g['pointer'] = 0
        if g['indices'] is None:
            g['indices'] = self.rng.permutation(len(infos))
        idx = g['indices'][g['pointer']:g['pointer'] + num]
        g['pointer'] += num
        return [infos[i] for i in idx]

    def _load_obj_points(self, info):
        if 'points' in info:
            pts = np.asarray(info['points'], np.float32)
        elif (self._shm_data is not None
              and info.get('path') in self._shm_offsets):
            s, e = self._shm_offsets[info['path']]
            pts = np.array(self._shm_data[s:e], np.float32)
        else:
            path = self.root_path / info['path']
            pts = np.fromfile(path, dtype=np.float32).reshape(
                -1, self.num_point_features
            )
        return pts

    def __call__(self, data):
        gt_boxes = data.get('gt_boxes')
        gt_names = data.get('gt_names')
        if gt_boxes is None:
            return data
        if self.fade_epoch is not None and self.cur_epoch >= int(self.fade_epoch):
            return data
        existing = gt_boxes[:, :7].copy()
        sampled_boxes, sampled_names, sampled_points = [], [], []
        for name, group in self.sample_groups.items():
            num = group['num']
            if self.limit_whole_scene:
                num = group['num'] - int((gt_names == name).sum())
            if num <= 0:
                continue
            for info in self._sample_class(name, num):
                box = np.asarray(info['box3d_lidar'], np.float32)[:7]
                cand = box[None]
                others = (
                    np.concatenate([existing] + (
                        [np.stack(sampled_boxes)] if sampled_boxes else []
                    ), axis=0)
                )
                if len(others):
                    iou = boxes_iou_bev(cand.astype(np.float64),
                                        others.astype(np.float64))
                    if iou.max() > 1e-3:
                        continue
                obj = self._load_obj_points(info)
                obj = obj.copy()
                obj[:, :3] += box[:3]  # db stores object-centered points
                sampled_boxes.append(box)
                sampled_names.append(name)
                sampled_points.append(obj)
        if not sampled_boxes:
            return data
        sb = np.stack(sampled_boxes)
        # carve scene points inside sampled boxes, then paste into BOTH frames
        for key in ('points', 'points_prev'):
            pts = data.get(key)
            if pts is None:
                continue
            keep = ~points_in_boxes_mask(pts, sb)
            paste = np.concatenate(sampled_points, axis=0)
            if paste.shape[1] < pts.shape[1]:
                pad = np.zeros((len(paste), pts.shape[1] - paste.shape[1]),
                               pts.dtype)
                paste = np.hstack([paste, pad])
            data[key] = np.concatenate([paste[:, :pts.shape[1]], pts[keep]], axis=0)
        data['gt_boxes'] = np.concatenate([gt_boxes, np.pad(
            sb, ((0, 0), (0, gt_boxes.shape[1] - 7))
        )], axis=0)
        data['gt_names'] = np.concatenate([gt_names, np.asarray(sampled_names)])
        return data


class DataAugmentor:
    """Queue of augmentations from config (data_augmentor.py:16-23)."""

    def __init__(self, root_path, augmentor_cfg, class_names, rng=None):
        self.rng = rng or np.random.RandomState()
        self.queue = []
        disable = set(augmentor_cfg.get('DISABLE_AUG_LIST', []))
        for cfg in augmentor_cfg['AUG_CONFIG_LIST']:
            name = cfg['NAME']
            if name in disable:
                continue
            if name == 'gt_sampling':
                self.queue.append(
                    DataBaseSampler(root_path, cfg, class_names, rng=self.rng)
                )
            elif name == 'photo_metric_distortion':
                def _pmd(d, c=cfg):
                    if d.get('image') is not None:
                        d['image'] = photo_metric_distortion(
                            d['image'], c, self.rng)
                    return d

                self.queue.append(_pmd)
            else:
                fn = getattr(WorldTransforms, name)
                self.queue.append(
                    (lambda f, c: (lambda d: f(d, c, self.rng)))(fn, cfg)
                )

    def set_epoch(self, epoch):
        for step in self.queue:
            if isinstance(step, DataBaseSampler):
                step.cur_epoch = epoch

    def __call__(self, data):
        for step in self.queue:
            data = step(data)
        gt = data.get('gt_boxes')
        if gt is not None and len(gt):
            # wrap heading to [-pi, pi) (data_augmentor.py:246-252)
            gt[:, 6] = (gt[:, 6] + np.pi) % (2 * np.pi) - np.pi
        return data
