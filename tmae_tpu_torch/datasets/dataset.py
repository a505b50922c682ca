"""Dataset template, registry and loader (the port's copy of
``tmae_tpu/datasets/dataset.py``; numpy, on the host).

``DatasetTemplate.prepare_data`` runs augmentation, the class filter and
label column, channel selection and the processors; ``collate_batch`` pads
samples to static shapes and, under ``RUNTIME.HOST_VOXELIZE``, adds the
host voxelization (``ops/voxelize.voxelize_host``). ``DataLoader`` shards
the indices per process and prefetches batches in a thread; batches stay
numpy there, and ``models/detectors.batch_to_device`` moves them to the
card on the caller's thread, so the thread never touches CUDA.
"""

from __future__ import annotations

import threading
import queue as queue_mod

import numpy as np

from .augmentor import DataAugmentor
from .processor import (
    DataProcessor, PointFeatureEncoder, collate_static,
)


class DatasetTemplate:
    def __init__(self, dataset_cfg, class_names, training, root_path=None,
                 runtime_cfg=None, seed=None):
        self.dataset_cfg = dataset_cfg
        self.class_names = list(class_names)
        self.training = training
        self.root_path = root_path
        self.runtime_cfg = runtime_cfg or {}
        self.rng = np.random.RandomState(seed)
        self.pc_range = np.asarray(dataset_cfg['POINT_CLOUD_RANGE'], np.float32)

        pfe_cfg = dataset_cfg.get('POINT_FEATURE_ENCODING')
        self.point_feature_encoder = (
            PointFeatureEncoder(pfe_cfg) if pfe_cfg else None
        )
        aug_cfg = dataset_cfg.get('DATA_AUGMENTOR')
        self.augmentor = (
            DataAugmentor(root_path, aug_cfg, class_names, rng=self.rng)
            if (training and aug_cfg) else None
        )
        self.processor = DataProcessor(
            dataset_cfg.get('DATA_PROCESSOR', []), self.pc_range, training,
            rng=self.rng,
        )

    @property
    def max_points(self):
        return int(self.runtime_cfg.get('MAX_POINTS', 131072))

    @property
    def max_gt(self):
        return int(self.runtime_cfg.get('MAX_GT', 256))

    def prepare_data(self, data):
        """Aug → class filter + label column → feature encode → processors.
        Returns None if training and no gt boxes survive (caller resamples),
        matching dataset.py:124-188."""
        if self.training and self.augmentor is not None:
            data = self.augmentor(data)
        if data.get('gt_boxes') is not None and data.get('gt_names') is not None:
            sel = np.array(
                [n in self.class_names for n in data['gt_names']], bool
            )
            data['gt_boxes'] = data['gt_boxes'][sel]
            data['gt_names'] = data['gt_names'][sel]
            labels = np.array(
                [self.class_names.index(n) + 1 for n in data['gt_names']],
                np.float32,
            )
            data['gt_boxes'] = np.concatenate(
                [data['gt_boxes'][:, :7], labels[:, None]], axis=1
            )
        if self.point_feature_encoder is not None:
            for key in ('points', 'points_prev'):
                if data.get(key) is not None:
                    data[key] = self.point_feature_encoder(data[key])
        data = self.processor(data)
        if (
            self.training and data.get('gt_boxes') is not None
            and len(data['gt_boxes']) == 0
        ):
            return None
        return data

    def collate_batch(self, samples):
        mv = self.runtime_cfg.get('MAX_VOXELS')
        out = collate_static(
            samples, self.max_points, self.max_gt,
            max_voxels=int(mv[0]) if mv else None,
        )
        if self.runtime_cfg.get('HOST_VOXELIZE') and 'points' in out:
            # the point→pillar map, made in the prefetch thread
            # (ops/voxelize.voxelize_host gives the device voxelizer's
            # result)
            from ..ops.voxelize import VoxelSpec, voxelize_host
            proc = [p for p in self.dataset_cfg.get('DATA_PROCESSOR', [])
                    if p['NAME'] in ('calculate_grid_size',
                                     'transform_points_to_voxels')]
            voxel_size = (tuple(proc[-1]['VOXEL_SIZE']) if proc
                          else (0.32, 0.32, 8.0))
            spec = VoxelSpec(
                pc_range=tuple(self.pc_range), voxel_size=voxel_size,
                max_points=self.max_points, max_voxels=int(mv[0]),
            )
            # sorting the frame's padded point set by pillar slot (a
            # permutation) lets the host also ship per-pillar means and
            # segment ends, which the VFE's K5 path reads; on by default,
            # HOST_VOXELIZE_SORT: false ships the unsorted points
            sort = bool(self.runtime_cfg.get('HOST_VOXELIZE_SORT', True))
            for which, pk, mk in (('cur', 'points', 'point_mask'),
                                  ('prv', 'points_prev', 'point_mask_prev')):
                if pk not in out:
                    continue
                hv = voxelize_host(out[pk], out[mk], spec, sort_points=sort)
                out[f'pv_{which}'] = hv['point_voxel']
                out[f'pvalid_{which}'] = hv['point_valid']
                out[f'vcoords_{which}'] = hv['voxel_coords']
                out[f'vmask_{which}'] = hv['voxel_mask']
                if sort:
                    out[pk] = hv['points']
                    out[mk] = hv['point_mask']
                    out[f'vmean_{which}'] = hv['voxel_mean_xyz']
                    out[f'vends_{which}'] = hv['seg_ends']
        return out

    def __len__(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, index):  # pragma: no cover - abstract
        raise NotImplementedError


class DataLoader:
    """Prefetching loader: per-process shard (padded to equal length),
    shuffled each epoch, batches collated in a thread into a bounded
    queue."""

    def __init__(self, dataset: DatasetTemplate, batch_size, shuffle=True,
                 seed=0, process_index=0, process_count=1, drop_last=None,
                 prefetch=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.drop_last = drop_last if drop_last is not None else dataset.training
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch
        aug = getattr(self.dataset, 'augmentor', None)
        if aug is not None:
            aug.set_epoch(epoch)

    def _indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        # per-process shard (pad to equal length like DistributedSampler)
        per = int(np.ceil(n / self.process_count))
        padded = np.concatenate([idx, idx[: per * self.process_count - n]])
        return padded[self.process_index::self.process_count]

    def __len__(self):
        per = len(self._indices())
        if self.drop_last:
            return per // self.batch_size
        return int(np.ceil(per / self.batch_size))

    def __iter__(self):
        indices = self._indices()
        nb = len(self)
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)

        def worker():
            try:
                for bi in range(nb):
                    chunk = indices[bi * self.batch_size:
                                    (bi + 1) * self.batch_size]
                    samples = []
                    for i in chunk:
                        s = self.dataset[int(i)]
                        while s is None:  # no gt box left: resample
                            s = self.dataset[int(
                                self.dataset.rng.randint(len(self.dataset)))]
                        samples.append(s)
                    q.put(self.dataset.collate_batch(samples))
            except Exception as e:  # re-raised on the caller's thread
                q.put(e)
            q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            yield item


_DATASETS = {}
NOT_PORTED = {
    'WaymoTemporalDataset': 'ROADMAP.md, module 7: Waymo data',
    'ONCEDataset': 'ROADMAP.md, module 9: single-frame data',
    'WaymoDataset': 'ROADMAP.md, module 9: single-frame data',
}


def register_dataset(name):
    def deco(cls):
        _DATASETS[name] = cls
        return cls
    return deco


def build_dataloader(dataset_cfg, class_names, batch_size, training,
                     runtime_cfg=None, root_path=None, seed=0,
                     process_index=0, process_count=1):
    """(dataset, loader) of ``DATA_CONFIG.DATASET``; the loader shuffles
    (from ``seed``) and drops the last partial batch when ``training``."""
    name = dataset_cfg.get('DATASET', 'SyntheticONCEDataset')
    from . import once_temporal  # noqa: F401  (registers datasets)
    if name in NOT_PORTED:
        raise NotImplementedError(
            f'{name} is not ported yet ({NOT_PORTED[name]})')
    cls = _DATASETS[name]
    ds = cls(dataset_cfg, class_names, training=training,
             root_path=root_path or dataset_cfg.get('DATA_PATH'),
             runtime_cfg=runtime_cfg, seed=seed)
    loader = DataLoader(
        ds, batch_size, shuffle=training, seed=seed,
        process_index=process_index, process_count=process_count,
    )
    return ds, loader
