"""ONCE two-frame dataset and its synthetic stand-in (the port's copy of
``tmae_tpu/datasets/once_temporal.py``; numpy, on the host).

``ONCETemporalDataset`` reads the ONCE layout (``<root>/<split>.pkl`` infos,
lidar at ``<root>/data/<seq>/lidar_roof/<frame>.bin``): per-sequence
SCAN_WINDOW intervals, a random or fixed previous-frame gap, ego-point
removal and the quaternion-pose motion compensation of the previous frame
into the current one, and the ONCE AP evaluation. ``SyntheticONCEDataset``
makes ONCE-format scenes from a seed (boxes, two frames; ``lidar`` mode
ray-casts a 40-beam LiDAR with ``datasets/synthetic.py``, ``uniform`` mode
samples box surfaces, ground and clutter), for tests and the card. Camera
inputs are not ported yet and raise.
"""

from __future__ import annotations

import copy
import pickle
from pathlib import Path

import numpy as np

from .dataset import DatasetTemplate, register_dataset
from .once_eval import get_evaluation_results
from .synthetic import make_scene, render_lidar


def quat_to_matrix(q):
    """[x, y, z, w] quaternion → 3x3 rotation matrix (scipy's
    ``Rotation.from_quat`` convention)."""
    x, y, z, w = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def convert_prv_frame_to_cur(pc_prv, pose_prv, pose_cur):
    """Ego-motion compensation. Poses: [qx,qy,qz,qw,tx,ty,tz]; an all-zero
    pose means static → skip."""
    if not np.any(pose_prv):
        pc_global = pc_prv[:, :3]
    else:
        R = quat_to_matrix(pose_prv[:4])
        t = np.asarray(pose_prv[4:], np.float64)
        pc_global = pc_prv[:, :3] @ R.T + t
    if np.any(pose_cur):
        T = np.zeros((4, 4))
        T[:3, :3] = quat_to_matrix(pose_cur[:4])
        T[:3, 3] = np.asarray(pose_cur[4:], np.float64)
        T[3, 3] = 1
        Tinv = np.linalg.inv(T)
        ones = np.ones((len(pc_global), 1))
        pc_global = (np.hstack([pc_global, ones]) @ Tinv.T)[:, :3]
    return np.concatenate(
        [pc_global.astype(pc_prv.dtype), pc_prv[:, 3:]], axis=-1
    )


def remove_ego_points(points, center_radius=1.0):
    m = ~(
        (np.abs(points[:, 0]) < center_radius)
        & (np.abs(points[:, 1]) < center_radius)
    )
    return points[m]


def generate_intervals(frame_counts, scan_window):
    """Per-sequence [start, end) intervals of length scan_window."""
    intervals = []
    offset = 0
    for n in frame_counts:
        s = 0
        while s < n:
            e = min(s + scan_window, n)
            intervals.append((offset + s, offset + e))
            s = e
        offset += n
    return intervals


@register_dataset('ONCETemporalDataset')
class ONCETemporalDataset(DatasetTemplate):
    """Two-frame ONCE loader over info pkls (``<root>/<split>.pkl`` infos with
    per-frame ``frame_id``, ``sequence_id``, ``pose``, optional ``annos``;
    lidar at ``<root>/data/<seq>/lidar_roof/<frame>.bin``)."""

    def __init__(self, dataset_cfg, class_names, training, root_path=None,
                 runtime_cfg=None, seed=None):
        super().__init__(dataset_cfg, class_names, training, root_path,
                         runtime_cfg, seed)
        from ..utils.file_client import FileClient

        fc_cfg = dict(dataset_cfg.get('FILE_CLIENT', {'backend': 'disk'}))
        self.file_client = FileClient(**fc_cfg)
        self.split = dataset_cfg['DATA_SPLIT']['train' if training else 'test']
        self.scan_window = int(dataset_cfg.get('SCAN_WINDOW', 3))
        self.align_two_frames = bool(dataset_cfg.get('ALIGN_TWO_FRAMES', True))
        self.fixed_gap = int(dataset_cfg.get('FIXED_GAP', -1))
        self.sampling_window = max(self.scan_window // 3, 1)
        self.root = Path(root_path) if root_path else None
        self.once_infos = []
        self._load_infos()
        counts = []
        cur_seq, cnt = None, 0
        for info in self.once_infos:
            if info['sequence_id'] != cur_seq:
                if cur_seq is not None:
                    counts.append(cnt)
                cur_seq, cnt = info['sequence_id'], 0
            cnt += 1
        if cur_seq is not None:
            counts.append(cnt)
        self.once_intervals = generate_intervals(counts, self.scan_window)

    def _load_infos(self):
        info_path = None
        if self.root is not None:
            for cand in (self.root / f'once_infos_{self.split}.pkl',
                         self.root / f'{self.split}.pkl'):
                if cand.exists():
                    info_path = cand
                    break
        if info_path is None:
            return
        self.once_infos = self.file_client.load_pickle(info_path)

    def get_lidar(self, seq_id, frame_id):
        path = self.root / 'data' / seq_id / 'lidar_roof' / f'{frame_id}.bin'
        return self.file_client.load_to_numpy(path).reshape(-1, 4)

    def _attach_camera(self, data, info):
        """Camera inputs (``CAMERA_CONFIG.USE_CAMERA``) are not ported yet."""
        cam_cfg = self.dataset_cfg.get('CAMERA_CONFIG')
        if not cam_cfg or not cam_cfg.get('USE_CAMERA', True):
            return data
        raise NotImplementedError('CAMERA_CONFIG.USE_CAMERA is not ported '
                                  'yet (ROADMAP.md, queue 1: the camera '
                                  'path)')

    def __len__(self):
        return len(self.once_intervals)

    def __getitem__(self, index):
        itv = self.once_intervals[index]
        idx = itv[1] - 1
        num_frames = itv[1] - itv[0]
        if self.fixed_gap == -1:
            if num_frames == 1:
                idx_prev = idx
            else:
                idx_prev = int(self.rng.randint(
                    itv[0], itv[0] + self.sampling_window
                ))
        else:
            idx_prev = max(itv[0], idx - self.fixed_gap)

        info = copy.deepcopy(self.once_infos[idx])
        info_prev = copy.deepcopy(self.once_infos[idx_prev])
        points = remove_ego_points(
            self.get_lidar(info['sequence_id'], info['frame_id']), 2
        )
        points_prev = remove_ego_points(
            self.get_lidar(info['sequence_id'], info_prev['frame_id']), 2
        )
        if self.align_two_frames and info['frame_id'] != info_prev['frame_id']:
            try:
                points_prev = convert_prv_frame_to_cur(
                    points_prev, info_prev['pose'], info['pose']
                )
            except (ValueError, np.linalg.LinAlgError):
                return self[int(self.rng.randint(len(self)))]

        data = {
            'points': points,
            'points_prev': points_prev,
            'frame_id': info['frame_id'],
        }
        data = self._attach_camera(data, info)
        if 'annos' in info:
            data['gt_names'] = np.asarray(info['annos']['name'])
            data['gt_boxes'] = np.asarray(info['annos']['boxes_3d'], np.float32)
        out = self.prepare_data(data)
        if out is None:
            return self[int(self.rng.randint(len(self)))]
        return out

    def evaluation(self, det_annos, class_names, native=True, **kwargs):
        """ONCE AP of ``det_annos`` (one per interval, in order);
        ``native=False`` runs it in numpy."""
        gt_annos = [
            copy.deepcopy(self.once_infos[itv[1] - 1]['annos'])
            for itv in self.once_intervals
        ]
        return get_evaluation_results(gt_annos, det_annos, class_names,
                                      native=native)

    @staticmethod
    def generate_prediction_dicts(frame_ids, boxes, scores, labels, valid,
                                  class_names):
        """Decoded candidates (numpy) → ONCE annos, one per sample."""
        annos = []
        cn = np.asarray(class_names)
        for b in range(len(frame_ids)):
            v = np.asarray(valid[b])
            bx = np.asarray(boxes[b])[v]
            sc = np.asarray(scores[b])[v]
            lb = np.asarray(labels[b])[v].astype(np.int64)
            annos.append({
                'frame_id': frame_ids[b],
                'name': cn[np.clip(lb - 1, 0, len(cn) - 1)]
                if len(bx) else np.zeros(0, cn.dtype),
                'score': sc,
                'boxes_3d': bx[:, :7],
            })
        return annos


@register_dataset('SyntheticONCEDataset')
class SyntheticONCEDataset(ONCETemporalDataset):
    """ONCE-format scenes made from a seed (boxes, ground, clutter; two
    frames), for tests and the card: training and evaluation without the
    ONCE dataset."""

    def __init__(self, dataset_cfg, class_names, training, root_path=None,
                 runtime_cfg=None, seed=None):
        self.num_samples = int(dataset_cfg.get('NUM_SYNTHETIC_SAMPLES', 16))
        self.points_per_frame = int(dataset_cfg.get('SYNTHETIC_POINTS', 4096))
        self.boxes_per_frame = int(dataset_cfg.get('SYNTHETIC_BOXES', 8))
        # 'uniform' = fast box+ground+uniform-clutter scenes (tests);
        # 'lidar' = ray-cast 40-beam spinning LiDAR (ONCE sensor class) with
        # ground rings + occlusion shadows — matches the real data's spatial
        # sparsity (~40-60% occupied 8x8 BEV windows vs ~97% for uniform),
        # which the occupied-window compaction path exploits. Benchmarks use
        # this mode so the perf number reflects real-data window occupancy.
        self.synthetic_mode = str(dataset_cfg.get('SYNTHETIC_MODE', 'uniform'))
        # lidar-mode azimuthal density multiplier (bench sensitivity sweeps)
        self.synthetic_density = float(
            dataset_cfg.get('SYNTHETIC_DENSITY', 1.0))
        self._frame_cache = {}
        DatasetTemplate.__init__(self, dataset_cfg, class_names, training,
                                 root_path, runtime_cfg, seed)
        self.scan_window = int(dataset_cfg.get('SCAN_WINDOW', 3))
        self.fixed_gap = int(dataset_cfg.get('FIXED_GAP', -1))
        self.once_intervals = [(i, i + 1) for i in range(self.num_samples)]
        self.once_infos = [
            {'frame_id': f'synth_{i:06d}', 'sequence_id': 'synth',
             'pose': np.zeros(7)}
            for i in range(self.num_samples)
        ]
        self._annos_cache = {}

    def _scene(self, index):
        if index not in self._annos_cache:
            self._annos_cache[index] = make_scene(
                index, self.pc_range, self.class_names, self.boxes_per_frame)
        return self._annos_cache[index]

    def _render_frame(self, scene, jitter_rng):
        """Points on box surfaces + ground plane + clutter."""
        if self.synthetic_mode == 'lidar':
            return render_lidar(scene, jitter_rng, self.pc_range,
                                self.synthetic_density, self.points_per_frame)
        boxes = scene['boxes']
        pts = []
        n_obj = self.points_per_frame // 2 // max(len(boxes), 1)
        for b in boxes:
            local = jitter_rng.uniform(-0.5, 0.5, (n_obj, 3)) * b[3:6]
            c, s = np.cos(b[6]), np.sin(b[6])
            x = local[:, 0] * c - local[:, 1] * s + b[0]
            y = local[:, 0] * s + local[:, 1] * c + b[1]
            z = local[:, 2] + b[2]
            inten = jitter_rng.uniform(0, 1, n_obj)
            pts.append(np.stack([x, y, z, inten], -1))
        n_bg = self.points_per_frame - sum(len(p) for p in pts)
        pc = self.pc_range
        bg = np.stack([
            jitter_rng.uniform(pc[0], pc[3], n_bg),
            jitter_rng.uniform(pc[1], pc[4], n_bg),
            jitter_rng.uniform(-1.8, -1.6, n_bg),
            jitter_rng.uniform(0, 1, n_bg),
        ], -1)
        pts.append(bg)
        return np.concatenate(pts, 0).astype(np.float32)

    def __len__(self):
        return self.num_samples

    def _frame(self, index, which):
        key = (index, which)
        if key not in self._frame_cache:
            scene = self._scene(index)
            rng = np.random.RandomState(
                (2000 if which == 'cur' else 3000) + index)
            self._frame_cache[key] = self._render_frame(scene, rng)
        return self._frame_cache[key]

    def __getitem__(self, index):
        scene = self._scene(index)
        data = {
            'points': self._frame(index, 'cur').copy(),
            'points_prev': self._frame(index, 'prv').copy(),
            'frame_id': f'synth_{index:06d}',
            'gt_names': scene['names'].copy(),
            'gt_boxes': scene['boxes'].copy(),
        }
        out = self.prepare_data(data)
        if out is None:
            return self[(index + 1) % len(self)]
        return out

    def evaluation(self, det_annos, class_names, native=True, **kwargs):
        gt_annos = []
        for i in range(self.num_samples):
            scene = self._scene(i)
            gt_annos.append({
                'name': scene['names'], 'boxes_3d': scene['boxes'][:, :7],
            })
        return get_evaluation_results(gt_annos, det_annos, class_names,
                                      native=native)
