"""Single-frame datasets (the port's copy of
``tmae_tpu/datasets/single_frame.py``): the temporal loaders' storage and
infos with one frame per sample and no previous frame, for the
single-frame model families (GD-MAE's SPTBackbone, PointPillar,
SECONDNet)."""

from __future__ import annotations

import copy

import numpy as np

from .dataset import register_dataset
from .once_eval import get_evaluation_results
from .once_temporal import ONCETemporalDataset, remove_ego_points
from .waymo_temporal import WaymoTemporalDataset


@register_dataset('ONCEDataset')
class ONCEDataset(ONCETemporalDataset):
    """ONCE, one info a sample; evaluated with the ONCE AP over every info
    with boxes."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.once_intervals = [(i, i + 1) for i in range(len(self.once_infos))]

    def __getitem__(self, index):
        info = copy.deepcopy(self.once_infos[index])
        points = remove_ego_points(
            self.get_lidar(info['sequence_id'], info['frame_id']), 2)
        data = {'points': points, 'frame_id': info['frame_id']}
        data = self._attach_camera(data, info)
        if 'annos' in info:
            data['gt_names'] = np.asarray(info['annos']['name'])
            data['gt_boxes'] = np.asarray(info['annos']['boxes_3d'],
                                          np.float32)
        out = self.prepare_data(data)
        if out is None:
            return self[int(self.rng.randint(len(self)))]
        return out

    def evaluation(self, det_annos, class_names, native=True, **kwargs):
        gt_annos = [copy.deepcopy(i['annos']) for i in self.once_infos
                    if 'annos' in i]
        return get_evaluation_results(gt_annos, det_annos, class_names,
                                      native=native)


@register_dataset('WaymoDataset')
class WaymoDataset(WaymoTemporalDataset):
    """Waymo, one frame a sample (no point cap, no ``dt``)."""

    def _build_intervals(self):
        return [(i, i + 1) for i in range(len(self.infos))]

    def __getitem__(self, index):
        info = copy.deepcopy(self.infos[index])
        pc = info['point_cloud']
        data = {
            'points': self.get_lidar(pc['lidar_sequence'], pc['sample_idx']),
            'frame_id': f"{pc['lidar_sequence']}_{pc['sample_idx']:03d}",
        }
        if 'annos' in info:
            names = np.asarray(info['annos']['name'])
            keep = names != 'unknown'
            data['gt_names'] = names[keep]
            data['gt_boxes'] = np.asarray(
                info['annos']['gt_boxes_lidar'], np.float32)[keep][:, :7]
        out = self.prepare_data(data)
        if out is None:
            return self[int(self.rng.randint(len(self)))]
        return out
