"""Evaluation CLI of the port (counterpart of ``tools/test.py``): loads a
checkpoint saved by ``train/checkpoint.save_checkpoint`` (one, or each new
one of the checkpoint directory with ``--eval_all``) and runs the dataset's
ONCE AP evaluation through ``train/evaluator.eval_one_epoch``.

    python -m tmae_tpu_torch.tools.test \\
        --cfg_file tools/cfgs/once_models/t_mae_synth.yaml --ckpt <file>
    python -m tmae_tpu_torch.tools.test ... --device cpu   # plain versions

Writes ``output/<EXP_GROUP_PATH>/<TAG>/<extra_tag>/eval/<tag>/result.pkl``
(``<tag>``: ``single``, or the checkpoint's file name with ``--eval_all``)
and a log with the config beside it. Runs on the card unless ``--device``
names another device.
"""

from __future__ import annotations

import argparse
import datetime
import logging
import time
from pathlib import Path

from ..config import cfg_from_list, cfg_from_yaml_file, log_config_to_file
from ..datasets.dataset import build_dataloader
from ..device import resolve_device
from ..models.detectors import build_detector
from ..train.checkpoint import latest_checkpoint, restore_checkpoint
from ..train.evaluator import eval_one_epoch

REPO = Path(__file__).resolve().parents[2]
OUTPUT_ROOT = REPO / 'output'


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--cfg_file', type=str, required=True)
    parser.add_argument('--batch_size', type=int, default=None)
    parser.add_argument('--ckpt', type=str, default=None)
    parser.add_argument('--extra_tag', type=str, default='default')
    parser.add_argument('--eval_all', action='store_true')
    parser.add_argument('--max_waiting_mins', type=int, default=30)
    parser.add_argument('--fixed_gap_eval', type=int, default=1)
    parser.add_argument('--set', dest='set_cfgs', default=None, nargs='*')
    parser.add_argument('--device', type=str, default=None,
                        help='torch device (default: the card)')
    parser.add_argument('--fuse_conv_bn', action='store_true',
                        help='not ported yet')
    parser.add_argument('--launcher', choices=['none', 'jax', 'pytorch',
                                               'slurm'], default='none',
                        help='only none is ported')
    parser.add_argument('--tcp_port', type=int, default=18888)
    parser.add_argument('--local_rank', type=int, default=None)
    args = parser.parse_args(argv)
    cfg = cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs is not None:
        cfg = cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def write_config_log(cfg, path: Path):
    """The config, key by key (``log_config_to_file``), into ``path``."""
    logger = logging.getLogger(f'{__name__}.config')
    logger.setLevel(logging.INFO)
    logger.propagate = False
    handler = logging.FileHandler(path)
    logger.addHandler(handler)
    try:
        log_config_to_file(cfg, logger=logger)
    finally:
        logger.removeHandler(handler)
        handler.close()


def main(argv=None):
    """Returns ``{result directory: AP dict}`` of every checkpoint it
    evaluated."""
    args, cfg = parse_config(argv)
    if args.fuse_conv_bn:
        raise NotImplementedError('--fuse_conv_bn is not ported yet '
                                  '(ROADMAP.md, module 11)')
    if args.launcher != 'none':
        raise NotImplementedError('multi-process evaluation is not ported '
                                  'yet (ROADMAP.md, module 8)')
    device = resolve_device(args.device)
    out_dir = OUTPUT_ROOT / cfg.EXP_GROUP_PATH / cfg.TAG / args.extra_tag
    eval_dir = out_dir / 'eval'
    eval_dir.mkdir(parents=True, exist_ok=True)
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(levelname)s %(message)s')
    logger = logging.getLogger('test')
    stamp = datetime.datetime.now().strftime('%Y%m%d-%H%M%S')
    write_config_log(cfg, eval_dir / f'log_eval_{stamp}.txt')

    if args.fixed_gap_eval >= 0:
        cfg.DATA_CONFIG.FIXED_GAP = args.fixed_gap_eval
    batch_size = args.batch_size or int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    dataset, loader = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size, training=False,
        runtime_cfg=cfg.RUNTIME, seed=1024)
    model = build_detector(cfg, device)
    results = {}

    def run_one(ckpt_path, tag):
        step = restore_checkpoint(ckpt_path, model)
        result_dir = eval_dir / tag
        ap_str, ap_dict = eval_one_epoch(
            cfg, model, loader, dataset, cfg.CLASS_NAMES,
            result_dir=result_dir, logger=logger)
        logger.info('ckpt %s (step %d):\n%s', ckpt_path, step, ap_str)
        results[result_dir] = ap_dict

    if not args.eval_all:
        ckpt = args.ckpt or latest_checkpoint(out_dir / 'ckpt')
        if ckpt is None:
            raise FileNotFoundError(f'no --ckpt and no checkpoint in '
                                    f'{out_dir / "ckpt"}')
        run_one(ckpt, 'single')
        return results

    # polling: evaluate each new checkpoint until none has come for
    # max_waiting_mins
    evaluated = set()
    record = eval_dir / 'eval_list.txt'
    if record.exists():
        evaluated = set(record.read_text().split())
    wait_start = time.time()
    while True:
        ckpt = latest_checkpoint(out_dir / 'ckpt')
        if ckpt is None or str(ckpt) in evaluated:
            if (time.time() - wait_start) / 60 > args.max_waiting_mins:
                break
            time.sleep(30)
            continue
        wait_start = time.time()
        run_one(ckpt, ckpt.name)
        evaluated.add(str(ckpt))
        with open(record, 'a') as f:
            f.write(str(ckpt) + '\n')
    return results


if __name__ == '__main__':
    main()
