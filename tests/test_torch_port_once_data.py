"""The port's ONCE loader (``tmae_tpu_torch/datasets``) against the JAX
package's on the CPU: the same config and seed give the same batches, key by
key and bit for bit (``np.array_equal``, same dtypes), for the synthetic
dataset (uniform mode with and without the host voxelization, one lidar-mode
case; evaluation and training with flip, rotation, scaling and translation)
and for ``ONCETemporalDataset`` over the raw-ONCE fixture with infos and the
GT database made by ``tools/create_once_infos.py`` (gt_sampling included,
also through the ``/dev/shm`` cache, each side with its own key); two-process
sharding; and the parts that are not ported yet refuse with an error."""

import copy
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from tmae_tpu.config import Cfg
from tmae_tpu.datasets.dataset import build_dataloader as j_build
from tmae_tpu_torch.datasets.dataset import build_dataloader as t_build

from tests.once_fixture import CLASSES, make_raw_once
from tests.tiny_cfg import tiny_cfg

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / 'tools'))

AUG = [
    {'NAME': 'random_world_flip', 'PROBABILITY': 0.5,
     'ALONG_AXIS_LIST': ['x', 'y']},
    {'NAME': 'random_world_rotation', 'PROBABILITY': 1.0,
     'WORLD_ROT_ANGLE': [-0.785, 0.785]},
    {'NAME': 'random_world_scaling', 'PROBABILITY': 1.0,
     'WORLD_SCALE_RANGE': [0.95, 1.05]},
    {'NAME': 'random_world_translation', 'PROBABILITY': 1.0,
     'NOISE_TRANSLATE_STD': [0.2, 0.2, 0.1]},
]
PROCESSORS = [
    {'NAME': 'mask_points_and_boxes_outside_range',
     'REMOVE_OUTSIDE_BOXES': True},
    {'NAME': 'shuffle_points',
     'SHUFFLE_ENABLED': {'train': True, 'test': False}},
    {'NAME': 'calculate_grid_size', 'VOXEL_SIZE': [0.32, 0.32, 8.0]},
]


def synth_cfg(mode='uniform'):
    cfg = {
        'DATASET': 'SyntheticONCEDataset',
        'POINT_CLOUD_RANGE': [-5.12, -5.12, -5.0, 5.12, 5.12, 3.0],
        'DATA_SPLIT': {'train': 'train', 'test': 'val'},
        'SCAN_WINDOW': 3,
        'NUM_SYNTHETIC_SAMPLES': 5,
        'SYNTHETIC_POINTS': 512,
        'SYNTHETIC_BOXES': 3,
        'SYNTHETIC_MODE': mode,
        'DATA_AUGMENTOR': {'DISABLE_AUG_LIST': ['placeholder'],
                           'AUG_CONFIG_LIST': AUG},
        'DATA_PROCESSOR': PROCESSORS,
    }
    if mode == 'lidar':
        cfg.update(POINT_CLOUD_RANGE=[-20.48, -20.48, -5.0, 20.48, 20.48, 3.0],
                   SYNTHETIC_POINTS=2048, SYNTHETIC_DENSITY=0.25)
    return Cfg.from_dict(cfg)


def runtime(host_voxelize, max_points=768):
    return {'MAX_POINTS': max_points, 'MAX_VOXELS': [128], 'MAX_GT': 8,
            'HOST_VOXELIZE': host_voxelize}


def assert_same_batches(jloader, tloader):
    """Every batch of both loaders equal key by key, bit for bit; returns
    the batches."""
    jb, tb = list(jloader), list(tloader)
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        assert sorted(a) == sorted(b)
        assert a['frame_id'] == b['frame_id']
        for k in a:
            if k == 'frame_id':
                continue
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k
    return tb


@pytest.mark.parametrize('mode,host_voxelize,training', [
    ('uniform', False, False), ('uniform', False, True),
    ('uniform', True, False), ('uniform', True, True),
    ('lidar', True, True)])
def test_synthetic_batches_equal_jax(mode, host_voxelize, training):
    cfg = synth_cfg(mode)
    rt = runtime(host_voxelize, 2048 if mode == 'lidar' else 768)
    loaders = [build(copy.deepcopy(cfg), CLASSES, 2, training,
                     runtime_cfg=rt, seed=3)[1] for build in (j_build, t_build)]
    batches = assert_same_batches(*loaders)
    b = batches[0]
    assert len(batches) == (2 if training else 3)  # training drops the last
    assert b['point_mask'].any() and b['gt_mask'].any()
    assert ('pv_cur' in b) == host_voxelize
    assert ('aug_inverse' in b) == training
    if training:  # the augmentation moved the scene
        ev = list(t_build(copy.deepcopy(cfg), CLASSES, 2, False,
                          runtime_cfg=rt, seed=3)[1])
        assert not any(np.array_equal(e['points'], b['points']) for e in ev)


@pytest.fixture(scope='module')
def raw_once(tmp_path_factory):
    """The raw-ONCE fixture (6 frames of one sequence) with its infos and GT
    database, made by tools/create_once_infos.py."""
    import create_once_infos as coi

    root = make_raw_once(tmp_path_factory.mktemp('once'), n_frames=6)
    for split in ('train', 'val'):
        infos = coi.create_infos(root, split)
    coi.create_gt_database(root, infos, 'train')
    return root


def raw_cfg(**sampler):
    aug = [{'NAME': 'gt_sampling',
            'DB_INFO_PATH': ['once_dbinfos_train.pkl'],
            'PREPARE': {'filter_by_min_points': ['Car:5']},
            'SAMPLE_GROUPS': ['Car:3'],
            'NUM_POINT_FEATURES': 4,
            'LIMIT_WHOLE_SCENE': True, **sampler}] + AUG
    return Cfg.from_dict({
        'DATASET': 'ONCETemporalDataset',
        'POINT_CLOUD_RANGE': [-40.96, -40.96, -5.0, 40.96, 40.96, 3.0],
        'DATA_SPLIT': {'train': 'train', 'test': 'val'},
        'SCAN_WINDOW': 2,
        'ALIGN_TWO_FRAMES': True,
        'DATA_AUGMENTOR': {'DISABLE_AUG_LIST': ['placeholder'],
                           'AUG_CONFIG_LIST': aug},
        'POINT_FEATURE_ENCODING': {
            'encoding_type': 'absolute_coordinates_encoding',
            'used_feature_list': ['x', 'y', 'z', 'intensity'],
            'src_feature_list': ['x', 'y', 'z', 'intensity']},
        'DATA_PROCESSOR': PROCESSORS,
    })


@pytest.mark.parametrize('training,shm', [(False, False), (True, False),
                                          (True, True)])
def test_once_temporal_batches_equal_jax(raw_once, training, shm):
    """Three intervals of two frames (a random previous frame in training,
    FIXED_GAP 1 in evaluation, as the eval CLI sets it); gt_sampling pastes
    Cars into both frames of the training batches."""
    keys = []
    loaders = []
    for side, build in (('jax', j_build), ('torch', t_build)):
        extra = {}
        if shm:
            keys.append(f'tmae_port_once_data_{os.getpid()}_{side}')
            extra = {'USE_SHARED_MEMORY': True,
                     'SHARED_MEMORY_KEY': keys[-1]}
        cfg = raw_cfg(**extra)
        if not training:
            cfg.FIXED_GAP = 1
        loaders.append(build(cfg, CLASSES, 2, training,
                             runtime_cfg=runtime(True, 1024),
                             root_path=str(raw_once), seed=5)[1])
    try:
        batches = assert_same_batches(*loaders)
        if shm:
            sampler = loaders[1].dataset.augmentor.queue[0]
            assert sampler._shm_data is not None
            assert len(sampler._shm_offsets) == 6
    finally:
        for key in keys:
            for suffix in ('.npy', '.offsets.pkl'):
                Path(f'/dev/shm/{key}{suffix}').unlink(missing_ok=True)
    n_gt = batches[0]['gt_mask'].sum(axis=1)
    assert len(batches) == (1 if training else 2)
    assert (n_gt >= (2 if training else 1)).all(), n_gt


def test_two_process_sharding_equals_jax():
    """Process 0 and 1 of 2: each the JAX package's shard, together every
    sample once (5 samples, padded to 6)."""
    cfg = synth_cfg()
    ids = []
    for rank in (0, 1):
        loaders = [build(copy.deepcopy(cfg), CLASSES, 1, False,
                         runtime_cfg=runtime(True), seed=0,
                         process_index=rank, process_count=2)[1]
                   for build in (j_build, t_build)]
        ids.append([b['frame_id'][0]
                    for b in assert_same_batches(*loaders)])
    assert len(ids[0]) == len(ids[1]) == 3
    assert sorted(set(ids[0] + ids[1])) == [f'synth_{i:06d}'
                                             for i in range(5)]


def _camera(cfg):
    cfg.CAMERA_CONFIG = Cfg.from_dict({'USE_CAMERA': True,
                                       'CAM_NAME': 'cam03'})
    return cfg


def _image_processor(cfg):
    cfg.DATA_PROCESSOR = PROCESSORS + [
        {'NAME': 'imnormalize', 'MEAN': [0, 0, 0], 'STD': [1, 1, 1]}]
    return cfg


def _photo_metric(cfg):
    cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST = [{'NAME': 'photo_metric_distortion'}]
    return cfg


def _named(name):
    def set_name(cfg):
        cfg.DATASET = name
        return cfg
    return set_name


@pytest.mark.parametrize('change,training,match', [
    (_camera, False, 'CAMERA_CONFIG'),
    (_image_processor, False, 'imnormalize'),
    (_photo_metric, True, 'photo_metric_distortion'),
    (_named('WaymoTemporalDataset'), False, None),
    (_named('ONCEDataset'), False, None),
    (_named('WaymoDataset'), False, None)],
    ids=['camera', 'image-processor', 'photo-metric', 'waymo-temporal',
         'once-single-frame', 'waymo-single-frame'])
def test_not_ported_parts_refuse(raw_once, change, training, match):
    """Each part that is not ported raises, naming it; ``match`` None: a
    part ported since builds and runs instead: the Waymo datasets with no
    Waymo infos under the ONCE tree (no sample), ONCEDataset with one
    sample a frame of the tree, its first batch a single frame."""
    cfg = change(raw_cfg())
    if match is None:
        ds, loader = t_build(cfg, CLASSES, 1, training,
                             runtime_cfg=runtime(False, 1024),
                             root_path=str(raw_once), seed=0)
        assert type(ds).__name__ == cfg.DATASET
        waymo = cfg.DATASET.startswith('Waymo')
        assert len(ds) == (0 if waymo else 6)
        if len(ds):
            batch = next(iter(loader))
            assert batch['point_mask'].any() and 'points_prev' not in batch
        return
    with pytest.raises(NotImplementedError, match=match):
        _, loader = t_build(cfg, CLASSES, 1, training,
                            runtime_cfg=runtime(False, 1024),
                            root_path=str(raw_once), seed=0)
        next(iter(loader))


@pytest.mark.parametrize('name', ['BaseBEVBackbone', 'NoSuchBackbone'])
def test_not_ported_backbone_2d_refuses(name):
    """A ``BACKBONE_2D`` other than ``SSTBEVBackbone`` or
    ``BaseBEVBackbone`` raises at build time, naming the backbone, where
    the port once built SSTBEVBackbone whatever the name said;
    ``BaseBEVBackbone`` (ported since) builds, and its CenterPoint runs
    with head maps at the grid's size."""
    import torch

    from tests.tiny_cfg import synth_batch
    from tmae_tpu_torch.models.detectors import (batch_to_device,
                                                 build_detector)

    cfg = copy.deepcopy(tiny_cfg())
    cfg.MODEL.BACKBONE_2D.NAME = name
    if name == 'NoSuchBackbone':
        with pytest.raises(NotImplementedError, match=name):
            build_detector(cfg, 'cpu')
        return
    cfg.MODEL.BACKBONE_2D.update(
        LAYER_NUMS=[1, 1], LAYER_STRIDES=[1, 2], NUM_FILTERS=[16, 16],
        UPSAMPLE_STRIDES=[1, 2], NUM_UPSAMPLE_FILTERS=[8, 8])
    model = build_detector(cfg, 'cpu')
    assert type(model.backbone_2d).__name__ == name
    with torch.no_grad():
        out = model(batch_to_device(synth_batch(np.random.RandomState(0)),
                                    'cpu'))
    assert out['spatial_features_2d'].shape == (2, 32, 32, 16)
    assert torch.isfinite(out['pred_dicts'][0]['hm']).all()
