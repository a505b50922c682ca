"""Slow: the overfit oracle of ``tests/test_overfit_ap.py`` through the port's
own CLIs (``create_once_infos``, ``train`` twice, ``test``), ``--device
cpu``; ``chip_smoke.py`` runs the same chain on the card (phase 14b).

The same raw fixture (6 frames of one sequence), data config, model,
optimizer, epochs (2 pretraining, 250 finetune) and thresholds (max score >
0.3, Vehicle AP > 30); each run saves its last checkpoint only
(``--ckpt_save_interval``), where the JAX oracle saves every epoch, which
changes no weight. One difference in the config: the port runs the
bucketed plan only, so ``RUNTIME`` gives a small bucket beside the full one
(``OVERFIT_CAPS``), each large enough for every window of a frame (81, 25
and 9 shifted windows on the 64, 32 and 16 cell grids), so that no
occupied window overflows a cap (``occ_overflow`` 0 on every step and in
evaluation).
"""

import copy
import json
import pickle
from pathlib import Path

import numpy as np
import pytest

from tests.once_fixture import make_raw_once

# a copy of tests/test_overfit_ap.py's config (BASE, _mini_model), so that
# chip_smoke.py loads no module of the JAX package's tests; a tier-1 test
# (tests/test_torch_port_train_cli.py) holds the copy equal to it
BASE = {
    'CLASS_NAMES': ['Car', 'Bus', 'Truck', 'Pedestrian', 'Cyclist'],
    'DATA_CONFIG': {
        '_BASE_CONFIG_': 'cfgs/dataset_configs/once_temporal_dataset.yaml',
        'DATASET': 'ONCETemporalDataset',
        'POINT_CLOUD_RANGE': [-20.48, -20.48, -5.0, 20.48, 20.48, 3.0],
        'SCAN_WINDOW': 3,
        'ALIGN_TWO_FRAMES': True,
        'DATA_AUGMENTOR': {
            'DISABLE_AUG_LIST': ['placeholder'],
            'AUG_CONFIG_LIST': [
                {'NAME': 'random_world_flip', 'PROBABILITY': 0.0,
                 'ALONG_AXIS_LIST': ['x']},
            ],
        },
        'DATA_PROCESSOR': [
            {'NAME': 'mask_points_and_boxes_outside_range',
             'REMOVE_OUTSIDE_BOXES': True},
            {'NAME': 'calculate_grid_size', 'VOXEL_SIZE': [0.64, 0.64, 8.0]},
        ],
    },
    'RUNTIME': {'MAX_POINTS': 1024, 'MAX_VOXELS': [512, 256, 128],
                'MAX_GT': 8, 'OCC_WINDOW_CAPS': [32, 16, 16]},
    'OPTIMIZATION': {
        'OPTIMIZER': 'adam_onecycle', 'LR': 0.003, 'WEIGHT_DECAY': 0.01,
        'MOMENTUM': 0.9, 'MOMS': [0.95, 0.85], 'PCT_START': 0.4,
        'DIV_FACTOR': 10, 'DECAY_STEP_LIST': [35, 45], 'LR_DECAY': 0.1,
        'GRAD_NORM_CLIP': 10, 'BATCH_SIZE_PER_GPU': 2, 'NUM_EPOCHS': 1,
    },
}


def mini_model(mae: bool):
    sst_block = lambda ds: {
        'NAME': 'SSTBlockV1',
        'PREPROCESS': {'WINDOW_SHAPE': [8, 8, 1], 'DROP_INFO': {
            'train': {'0': {'max_tokens': 64, 'drop_range': [0, 100000]}},
            'test': {'0': {'max_tokens': 64, 'drop_range': [0, 100000]}}}},
        'ENCODER': {'NUM_BLOCKS': 1, 'STRIDE': ds, 'D_MODEL': 128,
                    'NHEAD': 8, 'DIM_FEEDFORWARD': 256,
                    'ACTIVATION': 'gelu',
                    'LAYER_CFG': {'cosine': True, 'tau_min': 0.01}},
    }
    backbone = {
        'NAME': 'SiamWCA_MAE' if mae else 'SiamWCA',
        'SST_BLOCK_LIST': [sst_block(1), sst_block(2), sst_block(2)],
        'FEATURES_SOURCE': ['x_conv1', 'x_conv2', 'x_conv3'],
        'FUSE_LAYER': {
            'x_conv1': {'UPSAMPLE_STRIDE': 1, 'NUM_FILTER': 128,
                        'NUM_UPSAMPLE_FILTER': 64},
            'x_conv2': {'UPSAMPLE_STRIDE': 2, 'NUM_FILTER': 128,
                        'NUM_UPSAMPLE_FILTER': 64},
            'x_conv3': {'UPSAMPLE_STRIDE': 4, 'NUM_FILTER': 128,
                        'NUM_UPSAMPLE_FILTER': 64},
        },
    }
    if mae:
        backbone['MASK_CONFIG'] = {'RATIO': 0.75, 'NUM_PRD_POINTS': 8,
                                   'NUM_GT_POINTS': 16}
        return {
            'NAME': 'TMAE',
            'VFE': {'NAME': 'TemporalDynVFE', 'MLPS': [[64], [128]],
                    'USE_ABSLOTE_XYZ': True, 'USE_CLUSTER_XYZ': True,
                    'WITH_DISTANCE': False},
            'BACKBONE_3D': backbone,
        }
    return {
        'NAME': 'CenterPoint',
        'VFE': {'NAME': 'TemporalDynVFE', 'MLPS': [[64], [128]],
                'USE_ABSLOTE_XYZ': True, 'USE_CLUSTER_XYZ': True,
                'WITH_DISTANCE': False},
        'BACKBONE_3D': backbone,
        'BACKBONE_2D': {'NAME': 'SSTBEVBackbone', 'NUM_FILTER': 64,
                        'CONV_KWARGS': [
                            {'out_channels': 64, 'kernel_size': 3,
                             'dilation': 1, 'padding': 1, 'stride': 1},
                            {'out_channels': 64, 'kernel_size': 3,
                             'dilation': 1, 'padding': 1, 'stride': 1},
                        ],
                        'CONV_SHORTCUT': [0]},
        'DENSE_HEAD': {
            'NAME': 'CenterHead',
            'CLASS_NAMES_EACH_HEAD': [
                ['Car', 'Bus', 'Truck', 'Pedestrian', 'Cyclist']],
            'SHARED_CONV_CHANNEL': 64,
            'USE_BIAS_BEFORE_NORM': True,
            'NUM_HM_CONV': 2,
            'SEPARATE_HEAD_CFG': {
                'HEAD_ORDER': ['center', 'center_z', 'dim', 'rot'],
                'HEAD_DICT': {
                    'center': {'out_channels': 2, 'num_conv': 2},
                    'center_z': {'out_channels': 1, 'num_conv': 2},
                    'dim': {'out_channels': 3, 'num_conv': 2},
                    'rot': {'out_channels': 2, 'num_conv': 2},
                },
            },
            'TARGET_ASSIGNER_CONFIG': {
                'FEATURE_MAP_STRIDE': 1, 'NUM_MAX_OBJS': 8,
                'GAUSSIAN_OVERLAP': 0.1, 'MIN_RADIUS': 2,
            },
            'LOSS_CONFIG': {'LOSS_WEIGHTS': {
                'cls_weight': 1.0, 'loc_weight': 2.0,
                'code_weights': [1.0] * 8}},
            'POST_PROCESSING': {
                'SCORE_THRESH': 0.01, 'POST_CENTER_LIMIT_RANGE':
                    [-25, -25, -10, 25, 25, 10],
                'MAX_OBJ_PER_SAMPLE': 16,
                'NMS_CONFIG': {'NMS_TYPE': 'nms_gpu', 'NMS_THRESH': 0.2,
                               'NMS_PRE_MAXSIZE': 64,
                               'NMS_POST_MAXSIZE': 16},
            },
        },
    }


OVERFIT_CAPS = {'OCC_WINDOW_CAPS': [96, 32, 16],
                'OCC_SMALL_CAPS': [96, 32, 16]}
SCORE_MIN, VEHICLE_AP_MIN = 0.3, 30.0
PRETRAIN_EPOCHS, FINETUNE_EPOCHS = 2, 250


def write_cfg(cfg_dir: Path, name, mae, root, epochs):
    import yaml

    cfg = copy.deepcopy(BASE)
    cfg['DATA_CONFIG']['DATA_PATH'] = str(root)
    cfg['RUNTIME'].update(OVERFIT_CAPS)
    cfg['MODEL'] = mini_model(mae)
    cfg['OPTIMIZATION']['NUM_EPOCHS'] = epochs
    path = cfg_dir / f'{name}.yaml'
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    return path


def run_overfit(tmp: Path, device=None, log=print) -> dict:
    """Fixture, infos, pretraining, finetuning from its last checkpoint and
    ``tools.test`` on the finetune's last checkpoint, every output under
    ``tmp``; ``device`` None means the card. Returns the max score, the
    Vehicle AP, the AP table, the detections, the three CLI results and
    the ``occ_overflow`` of every training step."""
    from tmae_tpu_torch.datasets.once_eval import get_evaluation_results
    from tmae_tpu_torch.tools import create_once_infos as coi
    from tmae_tpu_torch.tools import test as test_cli
    from tmae_tpu_torch.tools import train as train_cli

    root = Path(make_raw_once(tmp / 'once', n_frames=6))
    coi.create_infos(root, 'train')
    coi.create_infos(root, 'val')
    cfg_dir = tmp / 'cfgs' / 'overfit'
    ssl_cfg = write_cfg(cfg_dir, 'overfit_ssl', True, root, PRETRAIN_EPOCHS)
    ft_cfg = write_cfg(cfg_dir, 'overfit_ft', False, root, FINETUNE_EPOCHS)
    dev = [] if device is None else ['--device', str(device)]
    saved = train_cli.OUTPUT_ROOT, test_cli.OUTPUT_ROOT
    train_cli.OUTPUT_ROOT = test_cli.OUTPUT_ROOT = tmp / 'output'
    try:
        common = ['--extra_tag', 'overfit_test', '--fix_random_seed'] + dev
        pre = train_cli.main(['--cfg_file', str(ssl_cfg),
                              '--ckpt_save_interval', str(PRETRAIN_EPOCHS)]
                             + common)
        log(f'pretraining: {len(pre["steps"])} steps, loss '
            f'{pre["steps"][0]["loss"]:.4f} -> {pre["steps"][-1]["loss"]:.4f}')
        ft = train_cli.main(['--cfg_file', str(ft_cfg), '--pretrained_model',
                             str(pre['checkpoints'][-1]),
                             '--ckpt_save_interval', str(FINETUNE_EPOCHS)]
                            + common)
        log(f'finetuning: {len(ft["steps"])} steps, loss '
            f'{ft["steps"][0]["loss"]:.4f} -> {ft["steps"][-1]["loss"]:.4f}')
        ev = test_cli.main(['--cfg_file', str(ft_cfg), '--extra_tag',
                            'overfit_test', '--ckpt',
                            str(ft['checkpoints'][-1])] + dev)
    finally:
        train_cli.OUTPUT_ROOT, test_cli.OUTPUT_ROOT = saved
    (result_dir, ap), = ev.items()
    dets = pickle.loads((result_dir / 'result.pkl').read_bytes())
    infos = pickle.loads((root / 'once_infos_val.pkl').read_bytes())
    gt = [i['annos'] for i in infos[2::3]]  # last frame of each interval
    ap_str, ap_dict = get_evaluation_results(gt, dets, BASE['CLASS_NAMES'])
    scores = np.concatenate([np.asarray(d['score']) for d in dets])
    return {
        'max_score': float(scores.max()) if len(scores) else 0.0,
        'vehicle_ap': max(v for k, v in ap_dict.items() if 'Vehicle' in k),
        'ap_str': ap_str, 'dets': dets, 'pretrain': pre, 'finetune': ft,
        'eval': ap,
        'occ_overflow': [s['occ_overflow'] for r in (pre, ft)
                         for s in r['steps']],
    }


@pytest.mark.slow
def test_port_pretrain_finetune_eval_overfit(tmp_path):
    res = run_overfit(tmp_path, 'cpu')
    print(f'max score {res["max_score"]:.4f}, Vehicle AP '
          f'{res["vehicle_ap"]:.2f}\n{res["ap_str"]}')
    assert len(res['dets']) == 2  # 6 frames / window 3
    assert not any(res['occ_overflow']) and res['eval']['occ_overflow'] == 0
    assert res['max_score'] > SCORE_MIN, res['max_score']
    assert res['vehicle_ap'] > VEHICLE_AP_MIN, (res['vehicle_ap'],
                                                res['ap_str'])
