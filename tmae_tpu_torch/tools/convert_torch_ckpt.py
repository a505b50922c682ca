"""Convert a reference T-MAE checkpoint (``.pth``) into a checkpoint of the
port (counterpart of ``tools/convert_torch_ckpt.py``): the reference names
and layouts go through ``utils/torch_convert.convert_state_dict``, onto the
model that ``--cfg_file`` builds; entries the checkpoint does not hold (or
holds with another shape) keep the training initialisation. Prints the
key-diff report and writes one file, step 0, that
``python -m tmae_tpu_torch.tools.test --ckpt`` and
``python -m tmae_tpu_torch.tools.train --pretrained_model`` read.

    python -m tmae_tpu_torch.tools.convert_torch_ckpt --torch_ckpt tmae.pth \\
        --cfg_file tools/cfgs/once_models/t_mae.yaml --out converted.pth
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from ..config import cfg_from_list, cfg_from_yaml_file
from ..models.detectors import build_detector, init_training_
from ..utils.torch_convert import convert_state_dict


def convert(torch_ckpt, cfg, out) -> dict:
    """Converts ``torch_ckpt`` for the model of ``cfg`` and writes ``out``.
    Returns the report: ``used``, ``shape_mismatch`` ((name, converted
    shape, model shape)), ``kept`` (model entries left at init) and
    ``unmatched`` (reference keys no rule took, and converted names the
    model does not have)."""
    raw = torch.load(torch_ckpt, map_location='cpu', weights_only=True)
    sd = raw.get('model_state', raw.get('state_dict', raw))
    converted, unmatched = convert_state_dict(
        {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)})
    model = init_training_(build_detector(cfg, 'cpu'), seed=0)
    merged = model.state_dict()
    used, mismatch = [], []
    for k, v in converted.items():
        if k not in merged:
            unmatched.append(k)
        elif tuple(v.shape) == tuple(merged[k].shape):
            merged[k] = v
            used.append(k)
        else:
            mismatch.append((k, tuple(v.shape), tuple(merged[k].shape)))
    used_set = set(used)
    kept = [k for k in merged if k not in used_set]
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({'model': merged, 'step': 0, 'source': str(torch_ckpt)}, out)
    return {'used': used, 'total': len(merged), 'shape_mismatch': mismatch,
            'kept': kept, 'unmatched': unmatched}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--torch_ckpt', required=True)
    parser.add_argument('--cfg_file', required=True)
    parser.add_argument('--out', required=True)
    parser.add_argument('--set', dest='set_cfgs', default=None, nargs='*')
    args = parser.parse_args(argv)
    cfg = cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs is not None:
        cfg = cfg_from_list(args.set_cfgs, cfg)
    report = convert(args.torch_ckpt, cfg, args.out)
    print(f'converted {len(report["used"])}/{report["total"]} state_dict '
          'entries')
    for k, s1, s2 in report['shape_mismatch']:
        print('SHAPE MISMATCH', k, s1, 'vs', s2)
    for k in report['kept'][:40]:
        print('kept at init:', k)
    for k in report['unmatched'][:40]:
        print('unmatched torch key:', k)
    print('saved', args.out)
    return report


if __name__ == '__main__':
    main()
