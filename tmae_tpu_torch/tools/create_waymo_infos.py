"""Waymo preprocessing of the port (counterpart of
``tools/create_waymo_infos.py``): per-sequence infos, point files and the
GT database from raw TFRecords. Writes ``<out_dir>/<seq>/<seq>.pkl`` and
``%04d.npy`` (N, 6): x, y, z, intensity, elongation, NLZ, the layout that
``datasets/waymo_temporal.WaymoTemporalDataset`` reads, and, for the train
split with ``--with_gt_database``, ``waymo_dbinfos_train.pkl`` and one
object-centred point file per box under ``waymo_gt_database_train/``.

TFRecords are decoded by the port's own decoder
(``datasets/waymo_decode.py``: TFRecord reader, Frame wire format, range
image to points); ``backend='wod'`` keeps the tensorflow +
waymo_open_dataset path for cross-checking where those are installed.

    python -m tmae_tpu_torch.tools.create_waymo_infos \\
        --raw_dir <tfrecords> --out_dir ../data/waymo/waymo_processed_data \\
        --splits train val --with_gt_database
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from ..datasets.waymo_pb import WAYMO_CLASSES


def nlz_from_range_images(range_images, laser_calibrations):
    """No-label-zone flags aligned 1:1 with frame_utils'
    ``convert_range_image_to_point_cloud`` output order: per laser
    (calibration-name order, first return), channel 3 of the range image at
    cells with range > 0. ``range_images``: {laser_name: [ri, ...]} where
    ``ri`` exposes ``.data`` (flat floats) and ``.shape.dims``;
    ``laser_calibrations``: iterable with ``.name``."""
    parts = []
    for c in sorted(laser_calibrations, key=lambda c: c.name):
        ri = range_images[c.name][0]
        ri_t = np.array(ri.data, np.float32).reshape(ri.shape.dims)
        parts.append(ri_t[ri_t[..., 0] > 0][:, 3])
    return np.concatenate(parts).astype(np.float32)


def decode_tfrecord_sequence(tfrecord_path, backend: str = 'native'):
    """TFRecord → list of decoded frame dicts.

    ``backend='native'`` (default): the port's dependency-free decoder
    (``datasets/waymo_decode.decode_tfrecord``). ``backend='wod'``: the
    tensorflow + waymo_open_dataset path, imported only when asked."""
    if backend == 'native':
        from ..datasets.waymo_decode import decode_tfrecord
        return decode_tfrecord(tfrecord_path)
    try:
        import tensorflow as tf
        from waymo_open_dataset import dataset_pb2
        from waymo_open_dataset.utils import frame_utils
    except ImportError as e:
        raise RuntimeError(
            'decoding TFRecords with backend="wod" needs tensorflow + '
            'waymo_open_dataset; use the default native backend, or provide '
            'already-decoded frames to build_sequence_artifacts()') from e

    frames = []
    for data in tf.data.TFRecordDataset(str(tfrecord_path),
                                        compression_type=''):
        frame = dataset_pb2.Frame()
        frame.ParseFromString(bytearray(data.numpy()))
        (range_images, camera_projections, _, range_image_top_pose) = (
            frame_utils.parse_range_image_and_camera_projection(frame))
        points, _ = frame_utils.convert_range_image_to_point_cloud(
            frame, range_images, camera_projections, range_image_top_pose,
            keep_polar_features=True)
        # keep_polar_features → (N, 6): range, intensity, elongation, x, y, z
        pts = np.concatenate(points, axis=0)
        xyz = pts[:, 3:6]
        feat = pts[:, 1:3]  # intensity, elongation
        nlz = nlz_from_range_images(range_images,
                                    frame.context.laser_calibrations)
        if len(nlz) != len(xyz):  # fail loudly, never emit wrong flags
            raise RuntimeError(
                f'NLZ channel decode misaligned with point cloud '
                f'({len(nlz)} vs {len(xyz)} points)')
        points6 = np.concatenate(
            [xyz, feat, nlz[:, None]], axis=1).astype(np.float32)
        names, boxes = [], []
        for label in frame.laser_labels:
            b = label.box
            names.append(WAYMO_CLASSES[label.type])
            boxes.append([b.center_x, b.center_y, b.center_z,
                          b.length, b.width, b.height, b.heading])
        frames.append({
            'points': points6,
            'pose': np.array(frame.pose.transform, np.float64).reshape(4, 4),
            'context_name': frame.context.name,
            'timestamp_micros': frame.timestamp_micros,
            'annos': {
                'name': np.asarray(names),
                'gt_boxes_lidar': np.asarray(boxes, np.float32).reshape(-1, 7),
            },
        })
    return frames


def _points_in_box_mask(points, box):
    d = points[:, :3] - box[:3]
    c, s = np.cos(-box[6]), np.sin(-box[6])
    lx = d[:, 0] * c - d[:, 1] * s
    ly = d[:, 0] * s + d[:, 1] * c
    return (
        (np.abs(lx) <= box[3] / 2) & (np.abs(ly) <= box[4] / 2)
        & (np.abs(d[:, 2]) <= box[5] / 2)
    )


def build_sequence_artifacts(frames, seq_name: str, out_dir: Path):
    """Decoded frames → ``<out_dir>/<seq>/{%04d.npy, <seq>.pkl}``. Returns
    the info list."""
    seq_dir = Path(out_dir) / seq_name
    seq_dir.mkdir(parents=True, exist_ok=True)
    infos = []
    for fi, fr in enumerate(frames):
        np.save(seq_dir / f'{fi:04d}.npy', fr['points'].astype(np.float32))
        annos = dict(fr['annos'])
        boxes = np.asarray(annos['gt_boxes_lidar'], np.float32).reshape(-1, 7)
        npig = np.array([
            int(_points_in_box_mask(fr['points'], b).sum()) for b in boxes
        ], np.int32)
        annos['num_points_in_gt'] = npig
        infos.append({
            'point_cloud': {'lidar_sequence': seq_name, 'sample_idx': fi},
            'frame_id': f'{seq_name}_{fi:03d}',
            'pose': np.asarray(fr['pose'], np.float64),
            'metadata': {
                'context_name': fr.get('context_name', seq_name),
                'timestamp_micros': int(fr.get('timestamp_micros', 0)),
            },
            'annos': annos,
        })
    with open(seq_dir / f'{seq_name}.pkl', 'wb') as f:
        pickle.dump(infos, f)
    return infos


def create_gt_database(root: Path, infos, data_dir: Path, split='train',
                       used_classes=('Vehicle', 'Pedestrian', 'Cyclist')):
    """Object point clips, object-centred, and the db info pkl
    (``waymo_dbinfos_<split>.pkl``) of the GT sampler."""
    db_dir = Path(root) / f'waymo_gt_database_{split}'
    db_dir.mkdir(parents=True, exist_ok=True)
    db = {}
    for info in infos:
        pc = info['point_cloud']
        npy = Path(data_dir) / pc['lidar_sequence'] / (
            '%04d.npy' % pc['sample_idx'])
        points = np.load(npy)
        annos = info.get('annos')
        if annos is None:
            continue
        boxes = np.asarray(annos['gt_boxes_lidar'], np.float32).reshape(-1, 7)
        for gi, box in enumerate(boxes):
            name = str(annos['name'][gi])
            if used_classes and name not in used_classes:
                continue
            m = _points_in_box_mask(points, box)
            obj = points[m].copy()
            obj[:, :3] -= box[:3]
            fname = f"{info['frame_id']}_{name}_{gi}.bin"
            obj.astype(np.float32).tofile(db_dir / fname)
            db.setdefault(name, []).append({
                'name': name,
                'path': f'waymo_gt_database_{split}/{fname}',
                'gt_box': box,
                'num_points_in_gt': int(m.sum()),
                'num_point_features': points.shape[1],
            })
    out = Path(root) / f'waymo_dbinfos_{split}.pkl'
    with open(out, 'wb') as f:
        pickle.dump(db, f)
    print(f'wrote {out} ({sum(len(v) for v in db.values())} objects)')
    return db


def main(argv=None):
    """Decodes each split's sequences (``<root>/ImageSets/<split>.txt``
    names them) and writes their artifacts. Returns {split: infos}."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--raw_dir', required=True,
                        help='directory of .tfrecord sequence files')
    parser.add_argument('--out_dir', required=True,
                        help='processed-data dir (per-sequence npy+pkl)')
    parser.add_argument('--root', default=None,
                        help='dataset root for gt database (default '
                        'out_dir/..)')
    parser.add_argument('--splits', nargs='+', default=['train'])
    parser.add_argument('--with_gt_database', action='store_true')
    args = parser.parse_args(argv)
    raw = Path(args.raw_dir)
    out = Path(args.out_dir)
    root = Path(args.root) if args.root else out.parent
    written = {}
    for split in args.splits:
        split_file = root / 'ImageSets' / f'{split}.txt'
        seqs = [Path(ln.strip()).stem for ln in
                split_file.read_text().splitlines() if ln.strip()]
        all_infos = []
        for seq in seqs:
            frames = decode_tfrecord_sequence(raw / f'{seq}.tfrecord')
            all_infos.extend(build_sequence_artifacts(frames, seq, out))
        if split == 'train' and args.with_gt_database:
            create_gt_database(root, all_infos, out, split)
        written[split] = all_infos
    return written


if __name__ == '__main__':
    main()
