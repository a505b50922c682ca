"""Waymo temporal (two-frame) dataset (the port's copy of
``tmae_tpu/datasets/waymo_temporal.py``; numpy, on the host).

Host-side re-implementation of ``pcdet/datasets/waymo_temporal/waymo_temporal_
dataset.py``: per-sequence npy lidar with NLZ filtering and tanh-compressed
intensity (``:348-358``), SCAN_WINDOW interval pairing with the scan_window==2 /
>3 sampling variants (``:390-470``), 4x4-matrix ego-motion alignment, point-count
limiting, SAMPLED_INTERVAL subsampling, a ``dt`` frame-gap output and the
``/dev/shm`` point cache.

Evaluation: the reference defers to the TF ``waymo_open_dataset`` metrics and
the external C++ ``compute_detection_metrics_main`` binary (``waymo_eval.py:
9-12``, ``README.md:46``). This module provides (a) ``waymo_custom`` — AP and
APH at LEVEL_1 / LEVEL_2 (``datasets/waymo_eval.py``), (b) ``kitti`` — the
ONCE-style 50-point PR AP protocol applied to Waymo classes, and (c)
``create_prediction_files``, which dumps the per-frame prediction pkl that
the official tooling can consume offline.
"""

from __future__ import annotations

import copy
import pickle
from pathlib import Path

import numpy as np

from .dataset import DatasetTemplate, register_dataset
from .once_eval import get_evaluation_results
from .once_temporal import remove_ego_points

WAYMO_CLASSES = ['Vehicle', 'Pedestrian', 'Cyclist']


def transform_points(points, mat4):
    out = points.copy()
    out[:, :3] = points[:, :3] @ np.asarray(mat4)[:3, :3].T + np.asarray(mat4)[:3, 3]
    return out


def align_prev_to_cur(points_prev, pose_prev, pose_cur):
    """prev-frame points → current frame via 4x4 vehicle poses."""
    rel = np.linalg.inv(np.asarray(pose_cur)) @ np.asarray(pose_prev)
    return transform_points(points_prev, rel)


@register_dataset('WaymoTemporalDataset')
class WaymoTemporalDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training, root_path=None,
                 runtime_cfg=None, seed=None):
        super().__init__(dataset_cfg, class_names, training, root_path,
                         runtime_cfg, seed)
        self.split = dataset_cfg['DATA_SPLIT']['train' if training else 'test']
        self.scan_window = int(dataset_cfg.get('SCAN_WINDOW', 2))
        self.align_two_frames = bool(dataset_cfg.get('ALIGN_TWO_FRAMES', True))
        self.fixed_gap = int(dataset_cfg.get('FIXED_GAP', -1))
        self.sampling_window = max(self.scan_window // 3, 1)
        self.sampled_interval = int(
            dataset_cfg.get('SAMPLED_INTERVAL', {}).get(
                'train' if training else 'test', 1)
        )
        self.max_points_cfg = dataset_cfg.get('MAX_NUMBER_OF_POINTS', None)
        self.root = Path(root_path) if root_path else None
        self.data_path = (
            self.root / dataset_cfg.get('PROCESSED_DATA_TAG',
                                        'waymo_processed_data')
            if self.root else None
        )
        self.infos = []
        self._load_infos()
        self.intervals = self._build_intervals()
        # /dev/shm per-frame point cache (waymo_temporal_dataset.py:108-115,
        # 236-288): processed points stored as .npy in /dev/shm; the kernel
        # page cache shares one physical copy across loader workers.
        self.use_shared_memory = (
            bool(dataset_cfg.get('USE_SHARED_MEMORY', False)) and self.training
        )
        self.shared_memory_file_limit = int(
            dataset_cfg.get('SHARED_MEMORY_FILE_LIMIT', 0x7FFFFFFF)
        )
        if self.use_shared_memory:
            self.load_data_to_shared_memory()

    def _shm_key(self, sequence_name, sample_idx):
        return Path('/dev/shm') / f'{sequence_name}___{sample_idx}.npy'

    def load_data_to_shared_memory(self):
        """Pre-load processed frames into /dev/shm
        (waymo_temporal_dataset.py:236-261)."""
        if not Path('/dev/shm').is_dir():
            self.use_shared_memory = False
            return
        infos = self.infos[:self.shared_memory_file_limit]
        for info in infos:
            pc = info['point_cloud']
            key = self._shm_key(pc['lidar_sequence'], pc['sample_idx'])
            if key.exists():
                continue
            points = self._get_lidar_from_disk(
                pc['lidar_sequence'], pc['sample_idx']
            )
            tmp = key.with_suffix('.tmp.npy')
            np.save(tmp, points)
            tmp.replace(key)

    def clean_shared_memory(self):
        """Remove this dataset's cached frames
        (waymo_temporal_dataset.py:263-288)."""
        infos = self.infos[:self.shared_memory_file_limit]
        for info in infos:
            pc = info['point_cloud']
            key = self._shm_key(pc['lidar_sequence'], pc['sample_idx'])
            if key.exists():
                key.unlink()

    def _load_infos(self):
        if self.root is None:
            return
        # reference layout: one pkl per sequence listed in ImageSets/<split>.txt,
        # or a merged waymo_infos_<split>.pkl
        merged = self.root / f'waymo_infos_{self.split}.pkl'
        if merged.exists():
            with open(merged, 'rb') as f:
                self.infos = pickle.load(f)
            return
        split_file = self._split_file()
        if not (split_file.exists() and self.data_path):
            return
        seqs = [
            Path(l.strip()).stem for l in split_file.read_text().splitlines()
            if l.strip()
        ]
        for seq in seqs:
            info_path = self.data_path / seq / f'{seq}.pkl'
            if info_path.exists():
                with open(info_path, 'rb') as f:
                    self.infos.extend(pickle.load(f))
        if self.sampled_interval > 1:
            self.infos = self.infos[::self.sampled_interval]

    def _split_file(self):
        """Sequence-list file; the MVJAR data-efficient benchmark redirects
        train splits to its percentile subsets
        (waymo_temporal_dataset.py:121-147)."""
        deb = self.dataset_cfg.get('DATA_EFFICIENT_BENCHMARK', None)
        if (self.split in ('val', 'test') or deb is None
                or deb.get('percentile', 1) == 1):
            return self.root / 'ImageSets' / f'{self.split}.txt'
        pct, idx = float(deb['percentile']), int(deb['idx'])
        fmt = '%.2f' if pct == 0.05 else '%.1f'
        name = f'waymo_infos_train_r_{fmt % pct}_{idx}_sequence_names'
        return (self.root / 'MVJAR_Data_Efficient_Benchmark'
                / 'sequence_names' / f'{name}.txt')

    def _build_intervals(self):
        """Per-sequence intervals of SCAN_WINDOW frames
        (waymo_temporal_dataset.py:175-202)."""
        seqs = {}
        for i, info in enumerate(self.infos):
            seq = info['point_cloud']['lidar_sequence']
            seqs.setdefault(seq, []).append(i)
        intervals = []
        for seq, idxs in seqs.items():
            s = 0
            while s < len(idxs):
                e = min(s + self.scan_window, len(idxs))
                intervals.append((idxs[s], idxs[e - 1] + 1))
                s = e
        return intervals

    def get_lidar(self, sequence_name, sample_idx):
        if self.use_shared_memory:
            key = self._shm_key(sequence_name, sample_idx)
            if key.exists():
                return np.array(np.load(key, mmap_mode='r'), np.float32)
        return self._get_lidar_from_disk(sequence_name, sample_idx)

    def _get_lidar_from_disk(self, sequence_name, sample_idx):
        lidar_file = self.data_path / sequence_name / ('%04d.npy' % sample_idx)
        feats = np.load(lidar_file)  # (N, 6): x, y, z, intensity, elong, NLZ
        points, nlz = feats[:, 0:5], feats[:, 5]
        if not self.dataset_cfg.get('DISABLE_NLZ_FLAG_ON_POINTS', False):
            points = points[nlz == -1]
        points = points.copy()
        points[:, 3] = np.tanh(points[:, 3])
        return points

    def __len__(self):
        return len(self.intervals)

    def _pick_pair(self, itv):
        num_frames = itv[1] - itv[0]
        if self.training and self.scan_window > 3:
            if num_frames == self.scan_window:
                t = self.rng.choice(np.arange(self.sampling_window), 2,
                                    replace=True)
                t[1] += 2 * self.sampling_window
            else:
                t = self.rng.choice(np.arange(num_frames), 2, replace=False)
        elif num_frames == 1:
            t = np.array([0, 0])
        elif self.fixed_gap >= 0:
            t = np.array([max(0, num_frames - 1 - self.fixed_gap),
                          num_frames - 1])
        else:
            t = np.array([0, 1])
        return itv[0] + int(min(t)), itv[0] + int(max(t))

    def __getitem__(self, index):
        itv = self.intervals[index]
        idx_prev, idx = self._pick_pair(itv)
        info = copy.deepcopy(self.infos[idx])
        info_prev = copy.deepcopy(self.infos[idx_prev])
        pc = info['point_cloud']
        seq = pc['lidar_sequence']
        frame_id = f"{seq}_{pc['sample_idx']:03d}"

        points = self.get_lidar(seq, pc['sample_idx'])
        points_prev = self.get_lidar(
            seq, info_prev['point_cloud']['sample_idx']
        )
        if self.align_two_frames and idx != idx_prev:
            points_prev = align_prev_to_cur(
                points_prev, info_prev['pose'], info['pose']
            )
            points_prev = remove_ego_points(points_prev)

        if self.max_points_cfg:
            cap = int(self.max_points_cfg)
            if len(points) > cap:
                points = points[self.rng.choice(len(points), cap, replace=False)]
            if len(points_prev) > cap:
                points_prev = points_prev[
                    self.rng.choice(len(points_prev), cap, replace=False)
                ]

        data = {
            'points': points, 'points_prev': points_prev, 'frame_id': frame_id,
        }
        if 'annos' in info:
            annos = info['annos']
            names = np.asarray(annos['name'])
            keep = names != 'unknown'
            boxes = np.asarray(annos['gt_boxes_lidar'], np.float32)[keep]
            names = names[keep]
            npts = annos.get('num_points_in_gt')
            if (self.training and npts is not None
                    and self.dataset_cfg.get('FILTER_EMPTY_BOXES_FOR_TRAIN',
                                             False)):
                m = np.asarray(npts)[keep] > 0
                boxes, names = boxes[m], names[m]
            data['gt_names'] = names
            data['gt_boxes'] = boxes[:, :7]
        out = self.prepare_data(data)
        if out is None:
            return self[int(self.rng.randint(len(self)))]
        out['dt'] = np.array(idx - idx_prev)
        return out

    def evaluation(self, det_annos, class_names, eval_metric='waymo_custom',
                   native=True, **kwargs):
        """``waymo_custom`` AP/APH (default) or the ONCE protocol
        (``kitti``) of ``det_annos`` (one per interval, in order);
        ``native=False`` computes the IoU (and the ONCE loops) in numpy."""
        gt_annos = []
        for itv in self.intervals:
            info = self.infos[itv[1] - 1]
            annos = info['annos']
            names = np.asarray(annos['name'])
            keep = names != 'unknown'
            anno = {
                'name': names[keep],
                'boxes_3d': np.asarray(annos['gt_boxes_lidar'])[keep][:, :7],
            }
            if 'num_points_in_gt' in annos:
                anno['num_points_in_gt'] = np.asarray(
                    annos['num_points_in_gt'])[keep]
            gt_annos.append(anno)
        if eval_metric == 'kitti':
            # ONCE-protocol fallback (the reference's 'kitti' dispatch role)
            return get_evaluation_results(
                gt_annos, det_annos, class_names, use_superclass=False,
                iou_thresholds={'Vehicle': 0.7, 'Pedestrian': 0.5,
                                'Cyclist': 0.5},
                native=native,
            )
        from .waymo_eval import waymo_evaluation
        return waymo_evaluation(gt_annos, det_annos, tuple(class_names),
                                native=native)

    @staticmethod
    def generate_prediction_dicts(frame_ids, boxes, scores, labels, valid,
                                  class_names):
        from .once_temporal import ONCETemporalDataset
        return ONCETemporalDataset.generate_prediction_dicts(
            frame_ids, boxes, scores, labels, valid, class_names
        )

    @staticmethod
    def create_prediction_files(det_annos, output_dir):
        """Dump per-frame predictions for the official Waymo metric tooling
        (the role of ``waymo_utils.create_pd_detection``; the protobuf/bin
        conversion runs offline where waymo_open_dataset is installed)."""
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        with open(output_dir / 'waymo_predictions.pkl', 'wb') as f:
            pickle.dump(det_annos, f)
        return output_dir / 'waymo_predictions.pkl'
