"""The port's Waymo data, infos and evaluation (``tmae_tpu_torch/datasets/
waymo_*.py``, ``tmae_tpu_torch/tools/create_waymo_infos.py``) against the JAX
package's on the CPU, on the same seeded inputs, exactly: the TFRecord
container and the Frame codec byte for byte, decoded frames array for array
(the frames of ``tests/test_waymo_decode._synth_frame_bytes``, a frame with
two lasers, beam inclinations, an extrinsic and pixel poses, and one
production-size frame of the port's synthetic writer); infos, point files
and GT database file for file; ``WaymoTemporalDataset`` items and batches
key by key (SCAN_WINDOW 2, 3 and 5, alignment off, NLZ points kept, a point
cap, empty boxes filtered, a fixed gap, a sampled interval, the
``/dev/shm`` cache); AP and APH with the native and the numpy IoU, the
ONCE-protocol branch, the prediction files. Then the CLI chain on a tiny
grid: ``create_waymo_infos`` → ``tools.train`` (t_mae_ssl_waymo.yaml, then
t_mae_waymo.yaml from its checkpoint) → ``tools.test``."""

import copy
import json
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from tests.test_waymo_decode import _synth_frame_bytes
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.config import Cfg
from tmae_tpu.datasets import waymo_decode as jwd
from tmae_tpu.datasets import waymo_eval as jwe
from tmae_tpu.datasets import waymo_pb as jpb
from tmae_tpu.datasets.dataset import build_dataloader as j_build
from tmae_tpu_torch.config import cfg_from_yaml_file
from tmae_tpu_torch.datasets import synthetic
from tmae_tpu_torch.datasets import waymo_decode as twd
from tmae_tpu_torch.datasets import waymo_eval as twe
from tmae_tpu_torch.datasets import waymo_pb as tpb
from tmae_tpu_torch.datasets.dataset import build_dataloader as t_build
from tmae_tpu_torch.tools import create_waymo_infos as t_cwi
from tmae_tpu_torch.tools import test as test_cli
from tmae_tpu_torch.tools import train as train_cli

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / 'tools'))

CLASSES = ['Vehicle', 'Pedestrian', 'Cyclist']
# sequence names of this process: the /dev/shm cache is keyed by them
SEQS = [f'port-{os.getpid()}-seq{i}' for i in range(2)]


def assert_same(a, b, where=''):
    """Nested dicts / lists / arrays equal, dtypes and types included."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], f'{where}.{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f'{where}[{i}]')
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    else:
        assert a == b, where


# ---------------------------------------------------------------------------
# TFRecord container and Frame codec
# ---------------------------------------------------------------------------


def rich_frame_args(fi, rng):
    """encode_frame arguments of a frame with two lasers (the TOP one with
    beam inclinations, an extrinsic and pixel poses), NLZ cells, a moving
    pose and labels of every type."""
    pose = np.eye(4)
    yaw = 0.1 * fi
    pose[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    pose[:3, 3] = [1.5 * fi, -0.5 * fi, 0.2]
    lasers, calibs = {}, {}
    for name, (H, W) in ((1, (8, 48)), (2, (4, 16))):
        ri = np.zeros((H, W, 4), np.float32)
        hit = rng.rand(H, W) < 0.7
        ri[..., 0] = np.where(hit, rng.uniform(1.0, 30.0, (H, W)), -1.0)
        ri[..., 1] = rng.uniform(0, 2, (H, W))
        ri[..., 2] = rng.uniform(0, 0.3, (H, W))
        ri[..., 3] = np.where(rng.rand(H, W) < 0.2, 1.0, -1.0)
        extr = np.eye(4)
        extr[:3, 3] = rng.uniform(-1, 2, 3)
        c, s = np.cos(0.05 * name), np.sin(0.05 * name)
        extr[:2, :2] = [[c, -s], [s, c]]
        if name == 1:
            pp = np.zeros((H, W, 6), np.float32)
            pp[..., :3] = rng.uniform(-0.02, 0.02, (H, W, 3))
            pp[..., 2] += yaw
            pp[..., 3:] = pose[:3, 3] + rng.uniform(-0.05, 0.05, (H, W, 3))
            beams = sorted(rng.uniform(-0.3, 0.05, H))
        else:
            pp, beams = None, ()
        lasers[name] = (ri, pp)
        calibs[name] = (extr, -0.3, 0.05, beams)
    labels = [(rng.uniform(-10, 10, 7), t) for t in (1, 2, 3, 4, 0)]
    return dict(context_name='ctx_rich', timestamp_micros=5000 + fi,
                pose=pose, lasers=lasers, calibrations=calibs,
                labels=labels)


def test_crc32c_and_tfrecord_bytes_equal_jax(tmp_path):
    rng = np.random.RandomState(0)
    for data in (b'', b'123456789', bytes(32),
                 rng.bytes(1000), rng.bytes(4097)):
        assert twd.crc32c(data) == jwd.crc32c(data)
    payloads = [b'hello', b'', rng.bytes(3000),
                _synth_frame_bytes(0, np.random.RandomState(1))]
    twd.write_tfrecord(tmp_path / 't.tfrecord', payloads)
    jwd.write_tfrecord(tmp_path / 'j.tfrecord', payloads)
    assert ((tmp_path / 't.tfrecord').read_bytes()
            == (tmp_path / 'j.tfrecord').read_bytes())
    for verify in (False, True):
        assert (list(twd.read_tfrecord(tmp_path / 'j.tfrecord', verify))
                == list(jwd.read_tfrecord(tmp_path / 'j.tfrecord', verify))
                == payloads)


@pytest.mark.parametrize('kind', ['synth', 'rich'])
def test_frame_codec_and_decode_equal_jax(kind):
    """encode_frame gives JAX's bytes; on those bytes Frame.parse gives
    JAX's fields and decode_frame JAX's points, pose and labels."""
    if kind == 'synth':
        raw = _synth_frame_bytes(2, np.random.RandomState(3))
    else:
        args = rich_frame_args(2, np.random.RandomState(4))
        raw = twd.encode_frame(**args)
        assert raw == jwd.encode_frame(**args)
    tf, jf = twd.Frame.parse(raw), jwd.Frame.parse(raw)
    assert (tf.context_name, tf.timestamp_micros) == (jf.context_name,
                                                      jf.timestamp_micros)
    assert np.array_equal(tf.pose, jf.pose)
    assert sorted(tf.range_images) == sorted(jf.range_images)
    for name, ri in jf.range_images.items():
        for field in ('range_image', 'pixel_pose'):
            a, b = getattr(tf.range_images[name], field), getattr(ri, field)
            assert (a is None and b is None) or np.array_equal(a, b)
        c, d = tf.laser_calibrations[name], jf.laser_calibrations[name]
        assert c.beam_inclinations == d.beam_inclinations
        assert (c.beam_inclination_min, c.beam_inclination_max) == (
            d.beam_inclination_min, d.beam_inclination_max)
        assert np.array_equal(c.extrinsic, d.extrinsic)
    assert len(tf.labels) == len(jf.labels)
    for (a, t), (b, u) in zip(tf.labels, jf.labels):
        assert t == u and np.array_equal(a, b)
    td, jd = twd.decode_frame(tf), twd.decode_frame(jf)
    assert_same(td, jwd.decode_frame(jf))
    assert_same(td, jd)
    if kind == 'rich':
        assert len(td['points']) and (td['points'][:, 5] == 1).any()


def test_synthetic_waymo_frame_decodes_as_jax():
    """One production-size frame of the port's writer (64 x 2650 top-LiDAR
    range image with pixel poses): the JAX decoder reads what the port's
    does; 100k-131072 points in range, some in the no-label zones, and
    labelled boxes that hold points."""
    pc = [-74.88, -74.88, -2.0, 74.88, 74.88, 4.0]
    (raw,), (n_in_range,) = synthetic.waymo_sequence(0, 1, pc, CLASSES,
                                                     'seq_w')
    td = twd.decode_frame(twd.Frame.parse(raw))
    assert_same(td, jwd.decode_frame(jwd.Frame.parse(raw)))
    pts = td['points']
    assert synthetic.WAYMO_BEAMS * synthetic.WAYMO_COLUMNS == 169600
    assert 100000 <= n_in_range == len(pts) < 131072
    assert 1000 < (pts[:, 5] == 1).sum() < 20000
    assert set(td['annos']['name']) <= set(CLASSES)
    npig = [t_cwi._points_in_box_mask(pts, b).sum()
            for b in td['annos']['gt_boxes_lidar']]
    assert sum(n > 5 for n in npig) >= 5


def test_write_pd_detection_bytes_equal_jax(tmp_path):
    rng = np.random.RandomState(2)
    infos = [{'frame_id': f'seq_{i:03d}', 'metadata': {
        'context_name': 'ctx', 'timestamp_micros': 100 + i}} for i in range(3)]
    infos.append({'frame_id': 'bare'})
    dets = [{'name': np.asarray(CLASSES)[rng.randint(0, 3, n)],
             'score': rng.rand(n),
             'boxes_lidar': rng.uniform(-5, 5, (n, 7))} for n in (4, 0, 2, 1)]
    t = tpb.write_pd_detection(dets, infos, tmp_path / 't.bin')
    j = jpb.write_pd_detection(dets, infos, tmp_path / 'j.bin')
    assert t.read_bytes() == j.read_bytes() and len(t.read_bytes()) > 0


# ---------------------------------------------------------------------------
# infos, point files and GT database
# ---------------------------------------------------------------------------


def write_raw(root):
    """Two TFRecords: SEQS[0] of four frames of ``_synth_frame_bytes``,
    SEQS[1] of three rich frames; train names both, val the second."""
    raw = root / 'raw'
    raw.mkdir(parents=True)
    rng = np.random.RandomState(0)
    jwd.write_tfrecord(raw / f'{SEQS[0]}.tfrecord',
                       [_synth_frame_bytes(i, rng) for i in range(4)])
    jwd.write_tfrecord(raw / f'{SEQS[1]}.tfrecord',
                       [jwd.encode_frame(**rich_frame_args(i, rng))
                        for i in range(3)])
    (root / 'ImageSets').mkdir()
    (root / 'ImageSets' / 'train.txt').write_text(
        ''.join(f'{s}.tfrecord\n' for s in SEQS))
    (root / 'ImageSets' / 'val.txt').write_text(f'{SEQS[1]}\n')
    return raw


def tree_files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob('*')) if p.is_file()}


def test_create_waymo_infos_equal_jax(tmp_path, monkeypatch):
    import create_waymo_infos as j_cwi

    trees = {}
    for side in ('jax', 'port'):
        root = tmp_path / side
        raw = write_raw(root)
        argv = ['--raw_dir', str(raw), '--out_dir',
                str(root / 'waymo_processed_data'), '--splits', 'train',
                'val', '--with_gt_database']
        if side == 'jax':
            monkeypatch.setattr(sys, 'argv', ['create_waymo_infos'] + argv)
            j_cwi.main()
        else:
            written = t_cwi.main(argv)
            assert [len(written[s]) for s in ('train', 'val')] == [7, 3]
        trees[side] = tree_files(root)
    assert list(trees['port']) == list(trees['jax'])
    for path, data in trees['jax'].items():
        assert trees['port'][path] == data, path
    db = pickle.loads(trees['port'][Path('waymo_dbinfos_train.pkl')])
    assert sorted(db) == sorted(CLASSES) and len(db['Vehicle']) >= 4


# ---------------------------------------------------------------------------
# WaymoTemporalDataset
# ---------------------------------------------------------------------------


def make_processed(root, n_frames=7, n_points=500):
    """Per-sequence npy + info pkls of SEQS (the layout create_waymo_infos
    writes): raw intensity in [0, 3), 10% of the points in a no-label
    zone, a vehicle that moves 1 m a frame and turns, four labelled boxes
    (one 'unknown', one with no point), points in the vehicle's box."""
    rng = np.random.RandomState(0)
    (root / 'ImageSets').mkdir(parents=True)
    for split in ('train', 'val'):
        (root / 'ImageSets' / f'{split}.txt').write_text(
            ''.join(f'{s}.tfrecord\n' for s in SEQS))
    data_dir = root / 'waymo_processed_data'
    for seq in SEQS:
        seq_dir = data_dir / seq
        seq_dir.mkdir(parents=True)
        infos = []
        for fi in range(n_frames):
            pts = np.zeros((n_points, 6), np.float32)
            pts[:, :2] = rng.uniform(-22, 22, (n_points, 2))
            pts[:, 2] = rng.uniform(-1.5, 3, n_points)
            pts[:, 3] = rng.uniform(0, 3, n_points)
            pts[:, 4] = rng.uniform(0, 1, n_points)
            pts[:, 5] = np.where(rng.rand(n_points) < 0.9, -1, 1)
            boxes = np.array([[5.0, 2.0, 0.5, 4.5, 2.0, 1.6, 0.2],
                              [-3.0, -8.0, 0.5, 0.8, 0.8, 1.7, 0.0],
                              [9.0, -4.0, 0.5, 1.8, 0.7, 1.7, 1.0],
                              [-6.0, 6.0, 0.5, 1.0, 1.0, 1.0, 0.0]],
                             np.float32)
            boxes[:, :2] += rng.normal(0, 0.2, (4, 2))
            pts[:20, :3] = boxes[0, :3] + rng.uniform(-0.5, 0.5, (20, 3))
            np.save(seq_dir / f'{fi:04d}.npy', pts)
            pose = np.eye(4)
            yaw = 0.05 * fi
            pose[:2, :2] = [[np.cos(yaw), -np.sin(yaw)],
                            [np.sin(yaw), np.cos(yaw)]]
            pose[:3, 3] = [1.0 * fi, 0.3 * fi, 0.0]
            infos.append({
                'point_cloud': {'lidar_sequence': seq, 'sample_idx': fi},
                'frame_id': f'{seq}_{fi:03d}',
                'pose': pose,
                'metadata': {'context_name': seq,
                             'timestamp_micros': 100000 * fi},
                'annos': {
                    'name': np.array(['Vehicle', 'Pedestrian', 'Cyclist',
                                      'unknown']),
                    'gt_boxes_lidar': boxes,
                    'num_points_in_gt': np.array([20, 0, 3, 7], np.int32),
                },
            })
        with open(seq_dir / f'{seq}.pkl', 'wb') as f:
            pickle.dump(infos, f)
    return root


@pytest.fixture(scope='module')
def processed(tmp_path_factory):
    return make_processed(tmp_path_factory.mktemp('waymo'))


def data_cfg(root, **over):
    cfg = {
        'DATASET': 'WaymoTemporalDataset',
        'DATA_PATH': str(root),
        'PROCESSED_DATA_TAG': 'waymo_processed_data',
        'POINT_CLOUD_RANGE': [-20.48, -20.48, -2.0, 20.48, 20.48, 4.0],
        'DATA_SPLIT': {'train': 'train', 'test': 'val'},
        'SAMPLED_INTERVAL': {'train': 1, 'test': 1},
        'SCAN_WINDOW': 2,
        'ALIGN_TWO_FRAMES': True,
        'FILTER_EMPTY_BOXES_FOR_TRAIN': False,
        'DISABLE_NLZ_FLAG_ON_POINTS': False,
        'POINT_FEATURE_ENCODING': {
            'encoding_type': 'absolute_coordinates_encoding',
            'used_feature_list': ['x', 'y', 'z', 'intensity', 'elongation'],
            'src_feature_list': ['x', 'y', 'z', 'intensity', 'elongation']},
        'DATA_AUGMENTOR': {'DISABLE_AUG_LIST': ['placeholder'],
                           'AUG_CONFIG_LIST': [
            {'NAME': 'random_world_flip', 'PROBABILITY': 0.5,
             'ALONG_AXIS_LIST': ['x', 'y']},
            {'NAME': 'random_world_rotation', 'PROBABILITY': 1.0,
             'WORLD_ROT_ANGLE': [-0.785, 0.785]},
            {'NAME': 'random_world_scaling', 'PROBABILITY': 1.0,
             'WORLD_SCALE_RANGE': [0.95, 1.05]}]},
        'DATA_PROCESSOR': [
            {'NAME': 'mask_points_and_boxes_outside_range',
             'REMOVE_OUTSIDE_BOXES': True},
            {'NAME': 'shuffle_points',
             'SHUFFLE_ENABLED': {'train': True, 'test': False}},
            {'NAME': 'calculate_grid_size', 'VOXEL_SIZE': [0.32, 0.32, 6.0]}],
    }
    cfg.update(over)
    return Cfg.from_dict(cfg)


RUNTIME = {'MAX_POINTS': 1024, 'MAX_GT': 8, 'MAX_VOXELS': [512]}


@pytest.mark.parametrize('over,training', [
    ({}, True), ({}, False), ({'SCAN_WINDOW': 3}, True),
    ({'SCAN_WINDOW': 5}, True), ({'SCAN_WINDOW': 5}, False),
    ({'ALIGN_TWO_FRAMES': False}, True),
    ({'DISABLE_NLZ_FLAG_ON_POINTS': True}, True),
    ({'MAX_NUMBER_OF_POINTS': 300}, True),
    ({'FILTER_EMPTY_BOXES_FOR_TRAIN': True}, True),
    ({'FIXED_GAP': 0}, False),
    ({'SAMPLED_INTERVAL': {'train': 2, 'test': 1}}, True),
    ({'USE_SHARED_MEMORY': True}, True)],
    ids=['w2-train', 'w2-test', 'w3-train', 'w5-train', 'w5-test',
         'unaligned', 'nlz-kept', 'max-points', 'filter-empty', 'fixed-gap',
         'sampled-interval', 'shared-memory'])
def test_dataset_items_equal_jax(processed, over, training):
    """Every item (points, points_prev, gt_boxes, gt_names, dt, frame_id,
    after augmentation and the processors) equal to JAX's from the same
    seed; the /dev/shm cache written, read and removed on each side in
    turn."""
    items = {}
    for side, build in (('jax', j_build), ('port', t_build)):
        ds, _ = build(data_cfg(processed, **over), CLASSES, 1, training,
                      runtime_cfg=RUNTIME, seed=3)
        try:
            if over.get('USE_SHARED_MEMORY'):
                keys = [ds._shm_key(*i['point_cloud'].values())
                        for i in ds.infos]
                assert ds.use_shared_memory and all(k.exists() for k in keys)
            items[side] = [ds[i] for i in range(len(ds))]
        finally:
            if over.get('USE_SHARED_MEMORY'):
                ds.clean_shared_memory()
                assert not any(k.exists() for k in keys)
    assert len(items['port']) == len(items['jax']) > 0
    assert_same(items['port'], items['jax'])
    dts = [int(it['dt']) for it in items['port']]
    if over.get('SCAN_WINDOW', 2) == 2 and not over.get('FIXED_GAP') == 0:
        assert dts.count(1) >= 2
    assert all(it['points'].shape[1] == 5 for it in items['port'])


def test_collated_batches_equal_jax(processed):
    """build_dataloader's batches (shuffled, batch 2, augmentation) equal
    to JAX's, key by key."""
    loaders = [build(data_cfg(processed), CLASSES, 2, True,
                     runtime_cfg=RUNTIME, seed=5)[1]
               for build in (j_build, t_build)]
    jb, tb = (list(lo) for lo in loaders)
    assert len(jb) == len(tb) == 4
    for a, b in zip(jb, tb):
        assert a['frame_id'] == b['frame_id']
        assert_same({k: v for k, v in b.items() if k != 'frame_id'},
                    {k: v for k, v in a.items() if k != 'frame_id'})


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def seeded_annos(n_frames=8, n=25, seed=11):
    """Frames of boxes out to 70 m with point counts (some at 5 or below:
    LEVEL_2 only), detected with noise in position, size and heading (some
    flipped by pi), some missed, some false, labels mixed."""
    rng = np.random.RandomState(seed)
    gt, pred = [], []
    for _ in range(n_frames):
        r, a = rng.uniform(2, 70, n), rng.uniform(-np.pi, np.pi, n)
        boxes = np.c_[r * np.cos(a), r * np.sin(a), rng.uniform(-1, 1, n),
                      rng.uniform(0.6, 6, (n, 3)), rng.uniform(-np.pi, np.pi,
                                                               n)]
        names = np.asarray(CLASSES)[rng.randint(0, 3, n)]
        gt.append({'name': names, 'boxes_3d': boxes,
                   'num_points_in_gt': rng.randint(0, 20, n)})
        hit = rng.rand(n) < 0.8
        det = boxes[hit] + np.c_[rng.normal(0, 0.2, (hit.sum(), 3)),
                                 rng.normal(0, 0.1, (hit.sum(), 3)),
                                 rng.normal(0, 0.3, hit.sum())]
        det[:, 3:6] = np.abs(det[:, 3:6]) + 0.1
        det[rng.rand(len(det)) < 0.1, 6] += np.pi
        fp = np.c_[rng.uniform(-60, 60, (6, 2)), rng.uniform(-1, 1, 6),
                   rng.uniform(0.6, 6, (6, 3)), rng.uniform(-np.pi, np.pi, 6)]
        pred.append({
            'name': np.r_[names[hit], np.asarray(CLASSES)[rng.randint(0, 3,
                                                                       6)]],
            'score': rng.uniform(0.1, 1, len(det) + 6),
            'boxes_3d': np.r_[det, fp]})
    return gt, pred


@pytest.mark.parametrize('native', [True, False], ids=['native', 'numpy'])
def test_waymo_evaluation_equal_jax(native):
    gt, pred = seeded_annos()
    want_str, want = jwe.waymo_evaluation(copy.deepcopy(gt),
                                          copy.deepcopy(pred))
    got_str, got = twe.waymo_evaluation(gt, pred, native=native)
    assert got_str == want_str
    assert got == want
    assert 5 < got['mAP/L1'] < 95 and got['mAPH/L2'] < got['mAP/L2']
    assert got['Vehicle/L1/AP'] != got['Vehicle/L2/AP']


@pytest.mark.parametrize('metric', ['waymo_custom', 'kitti'])
@pytest.mark.parametrize('native', [True, False], ids=['native', 'numpy'])
def test_dataset_evaluation_equal_jax(processed, tmp_path, metric, native):
    """``evaluation`` over the test split's intervals (their last frames'
    boxes, 'unknown' dropped) equal to JAX's for both metrics; the
    prediction files equal byte for byte."""
    dsets = [build(data_cfg(processed), CLASSES, 1, False,
                   runtime_cfg=RUNTIME, seed=0)[0]
             for build in (j_build, t_build)]
    rng = np.random.RandomState(1)
    det = []
    for itv in dsets[1].intervals:
        annos = dsets[1].infos[itv[1] - 1]['annos']
        keep = annos['name'] != 'unknown'
        boxes = annos['gt_boxes_lidar'][keep].astype(np.float64)
        boxes[:, :3] += rng.normal(0, 0.1, (len(boxes), 3))
        det.append({'name': annos['name'][keep],
                    'score': rng.uniform(0.2, 1, len(boxes)),
                    'boxes_3d': boxes})
    want = dsets[0].evaluation(copy.deepcopy(det), CLASSES,
                               eval_metric=metric)
    got = dsets[1].evaluation(det, CLASSES, eval_metric=metric,
                              native=native)
    assert got[0] == want[0] and got[1] == want[1]
    t = dsets[1].create_prediction_files(det, tmp_path / 'port')
    j = dsets[0].create_prediction_files(det, tmp_path / 'jax')
    assert t.name == 'waymo_predictions.pkl'
    assert t.read_bytes() == j.read_bytes()


# ---------------------------------------------------------------------------
# the CLI chain on the CPU
# ---------------------------------------------------------------------------


def tiny_waymo_cfg(name, root, tmp) -> Path:
    """The shipped Waymo config with its MODEL section as it is, on a
    64 x 64 grid (20.48 m square) with few points, over ``root``."""
    cfg = json.loads(json.dumps(cfg_from_yaml_file(
        REPO / f'tools/cfgs/waymo_models/{name}.yaml')))
    pc = [-10.24, -10.24, -2.0, 10.24, 10.24, 4.0]
    cfg['DATA_CONFIG'].update(POINT_CLOUD_RANGE=pc, DATA_PATH=str(root))
    cfg['RUNTIME'].update(MAX_POINTS=2048, MAX_VOXELS=[512, 256, 128],
                          MAX_GT=8)
    if 'DENSE_HEAD' in cfg['MODEL']:
        cfg['MODEL']['DENSE_HEAD']['POST_PROCESSING'][
            'POST_CENTER_LIMIT_RANGE'] = pc
    path = tmp / 'cfgs' / 'waymo_models' / f'{name}.yaml'
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_cli_chain_pretrain_finetune_evaluate(tmp_path, monkeypatch):
    """create_waymo_infos → one pretraining step of t_mae_ssl_waymo.yaml →
    one finetune step of t_mae_waymo.yaml from its checkpoint →
    tools.test: finite losses, AP/APH L1/L2 finite and equal to their
    recomputation with the numpy IoU, result.pkl's frame ids in order."""
    monkeypatch.setattr(train_cli, 'OUTPUT_ROOT', tmp_path / 'output')
    monkeypatch.setattr(test_cli, 'OUTPUT_ROOT', tmp_path / 'output')
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    root = tmp_path / 'waymo'
    raw = root / 'raw'
    raw.mkdir(parents=True)
    rng = np.random.RandomState(0)
    twd.write_tfrecord(raw / 'seq_cli.tfrecord',
                       [_synth_frame_bytes(i, rng) for i in range(4)])
    (root / 'ImageSets').mkdir()
    for split in ('train', 'val'):
        (root / 'ImageSets' / f'{split}.txt').write_text('seq_cli\n')
    t_cwi.main(['--raw_dir', str(raw), '--out_dir',
                str(root / 'waymo_processed_data'), '--splits', 'train',
                'val'])
    common = ['--device', 'cpu', '--fix_random_seed', '--batch_size', '2',
              '--epochs', '1']
    pre = train_cli.main(['--cfg_file', str(tiny_waymo_cfg(
        't_mae_ssl_waymo', root, tmp_path))] + common)
    ft_cfg = tiny_waymo_cfg('t_mae_waymo', root, tmp_path)
    ft = train_cli.main(['--cfg_file', str(ft_cfg), '--pretrained_model',
                         str(pre['checkpoints'][-1])] + common)
    for run in (pre, ft):
        assert [s['step'] for s in run['steps']] == [1]
        assert all(np.isfinite(s['loss']) and s['occ_overflow'] == 0
                   for s in run['steps'])
    copied, kept = ft['pretrained']
    assert copied and all(k.startswith(('vfe.', 'backbone_3d.'))
                          for k in copied)
    (result_dir, ap), = test_cli.main(['--cfg_file', str(ft_cfg), '--device',
                                       'cpu', '--batch_size', '2']).items()
    keys = [f'{c}/L{lv}/{m}' for c in CLASSES for lv in (1, 2)
            for m in ('AP', 'APH')]
    assert all(np.isfinite(ap[k]) for k in keys)
    annos = pickle.loads((result_dir / 'result.pkl').read_bytes())
    assert [a['frame_id'] for a in annos] == ['seq_cli_001', 'seq_cli_003']
    ds, _ = t_build(cfg_from_yaml_file(ft_cfg).DATA_CONFIG, CLASSES, 2,
                    False, seed=0)
    _, again = ds.evaluation(annos, CLASSES, native=False)
    assert all(again[k] == ap[k] for k in keys)
    assert torch.get_num_threads() == 1
