"""ONCE preprocessing of the port (counterpart of
``tools/create_once_infos.py``): info pkls and the GT-sampling database from
the raw ONCE layout (``<root>/data/<seq>/<seq>.json`` and
``lidar_roof/<frame>.bin``, ``<root>/ImageSets/<split>.txt``). Writes
``once_infos_<split>.pkl`` and, for the train split,
``once_dbinfos_train.pkl`` and one object-centred point file per box under
``gt_database_train/``. The points in a box come from the native host ops
(``utils/native.points_in_boxes``); a failed build raises.

    python -m tmae_tpu_torch.tools.create_once_infos \\
        --data_path ../data/once --splits train val
"""

from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path

import numpy as np

from ..utils import native


def _points_in_box_mask(points, box):
    idx = native.points_in_boxes(points[:, :3].astype(np.float32),
                                 box[None, :7].astype(np.float64))
    return idx == 0


def load_sequence(root: Path, seq_id: str):
    """The frame infos of one sequence's ``<seq>.json``: ids, timestamp,
    pose, the sequence's camera calibration and the annotations."""
    ann = root / 'data' / seq_id / f'{seq_id}.json'
    with open(ann) as f:
        meta = json.load(f)
    # sequence-level camera calib (ONCE devkit schema: per-cam cam_to_velo
    # 4x4, cam_intrinsic 3x3, distortion), copied into each frame info
    calib = {
        cam: {
            'cam_to_velo': np.asarray(c['cam_to_velo'], np.float32),
            'cam_intrinsic': np.asarray(c['cam_intrinsic'], np.float32),
            'distortion': np.asarray(c.get('distortion', np.zeros(5)),
                                     np.float32),
        }
        for cam, c in meta.get('calib', {}).items()
    }
    infos = []
    for frame in meta.get('frames', []):
        info = {
            'sequence_id': seq_id,
            'frame_id': str(frame['frame_id']),
            'timestamp': frame.get('timestamp', 0),
            'pose': np.asarray(frame.get('pose', np.zeros(7)), np.float64),
        }
        if calib:
            info['calib'] = calib
        if 'annos' in frame:
            annos = frame['annos']
            info['annos'] = {
                'name': np.asarray(annos['names']),
                'boxes_3d': np.asarray(annos['boxes_3d'], np.float32),
            }
        infos.append(info)
    return infos


def _lidar(root: Path, info):
    return root / 'data' / info['sequence_id'] / 'lidar_roof' / (
        info['frame_id'] + '.bin')


def create_infos(root: Path, split: str, splits_dir='ImageSets'):
    """``once_infos_<split>.pkl`` over the sequences of the split file, with
    each annotated frame's ``num_points_in_gt``. Returns the infos."""
    root = Path(root)
    split_file = root / splits_dir / f'{split}.txt'
    seq_ids = [ln.strip() for ln in split_file.read_text().splitlines()
               if ln.strip()]
    infos = []
    for seq in seq_ids:
        infos.extend(load_sequence(root, seq))
    for info in infos:
        lidar = _lidar(root, info)
        if 'annos' not in info or not lidar.exists():
            continue
        points = np.fromfile(lidar, np.float32).reshape(-1, 4)
        npig = np.zeros(len(info['annos']['name']), np.int32)
        for gi, box in enumerate(info['annos']['boxes_3d']):
            npig[gi] = int(_points_in_box_mask(points, box).sum())
        info['annos']['num_points_in_gt'] = npig
    out = root / f'once_infos_{split}.pkl'
    with open(out, 'wb') as f:
        pickle.dump(infos, f)
    print(f'wrote {out} ({len(infos)} frames)')
    return infos


def create_gt_database(root: Path, infos, split='train'):
    """Per-class object point clips, object-centred, under
    ``gt_database_<split>/`` and their infos in
    ``once_dbinfos_<split>.pkl`` (the layout the GT sampler reads)."""
    root = Path(root)
    db_dir = root / f'gt_database_{split}'
    db_dir.mkdir(exist_ok=True)
    db_infos: dict = {}
    for info in infos:
        lidar = _lidar(root, info)
        if 'annos' not in info or not lidar.exists():
            continue
        points = np.fromfile(lidar, np.float32).reshape(-1, 4)
        for gi, (name, box) in enumerate(
            zip(info['annos']['name'], info['annos']['boxes_3d'])
        ):
            m = _points_in_box_mask(points, box)
            obj = points[m].copy()
            obj[:, :3] -= box[:3]  # object-centred
            fname = f"{info['frame_id']}_{name}_{gi}.bin"
            obj.tofile(db_dir / fname)
            db_infos.setdefault(str(name), []).append({
                'name': str(name),
                'path': str(Path(db_dir.name) / fname),
                'gt_idx': gi,
                'box3d_lidar': np.asarray(box, np.float32),
                'num_points_in_gt': int(m.sum()),
            })
    out = root / f'once_dbinfos_{split}.pkl'
    with open(out, 'wb') as f:
        pickle.dump(db_infos, f)
    total = sum(len(v) for v in db_infos.values())
    print(f'wrote {out} ({total} objects, {len(db_infos)} classes)')
    return db_infos


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--data_path', required=True)
    parser.add_argument('--splits', nargs='+',
                        default=['train', 'val', 'raw_large'])
    parser.add_argument('--with_gt_database', action='store_true',
                        default=True)
    args = parser.parse_args(argv)
    root = Path(args.data_path)
    for split in args.splits:
        if not (root / 'ImageSets' / f'{split}.txt').exists():
            print(f'skip {split}: no split file')
            continue
        infos = create_infos(root, split)
        if split == 'train' and args.with_gt_database:
            create_gt_database(root, infos, split)


if __name__ == '__main__':
    main()
