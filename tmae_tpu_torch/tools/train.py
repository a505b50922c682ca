"""Training CLI of the port (counterpart of ``tools/train.py``): pretraining
(a ``TMAE`` config) or finetuning (``CenterPoint``) on the card, with
pretrained transfer, auto-resume, checkpoint retention and the evaluation
of the trained model.

    python -m tmae_tpu_torch.tools.train \\
        --cfg_file tools/cfgs/once_models/t_mae_ssl.yaml --fix_random_seed
    python -m tmae_tpu_torch.tools.train \\
        --cfg_file tools/cfgs/once_models/t_mae.yaml \\
        --pretrained_model output/.../ckpt/checkpoint_<step>.pth \\
        --num_epochs_to_eval 1
    python -m tmae_tpu_torch.tools.train ... --device cpu   # plain versions

Writes under ``output/<EXP_GROUP_PATH>/<TAG>/<extra_tag>/``: the log
``log_train_<time>.txt`` (with the config), ``metrics.jsonl`` (one line per
logged iteration), ``ckpt/checkpoint_<step>.pth`` every
``--ckpt_save_interval`` epochs (the newest ``--max_ckpt_save_num`` kept)
and, with ``--num_epochs_to_eval``, ``eval/result.pkl``. A run resumes
from ``--ckpt`` or the newest checkpoint of its ``ckpt/``: model,
optimizer and step, so the schedules continue; the epoch restarts at
``step // steps_per_epoch`` and each epoch reshuffles from the seed and the
epoch, and a pretraining step draws its mask from the seed and the step.
"""

from __future__ import annotations

import argparse
import copy
import datetime
import logging
import time
from pathlib import Path

import torch

from ..config import cfg_from_list, cfg_from_yaml_file, log_config_to_file
from ..datasets.dataset import build_dataloader
from ..device import resolve_device
from ..models.detectors import (batch_to_device, build_detector,
                                centerpoint_loss, init_training_, tmae_loss)
from ..train.checkpoint import (checkpoints, latest_checkpoint,
                                load_pretrained_params, restore_checkpoint,
                                save_checkpoint)
from ..train.evaluator import eval_one_epoch
from ..train.optimization import build_optimizer
from ..train.trainer import make_train_step
from ..utils.metrics import AverageMeter, MetricsLogger, Timer

REPO = Path(__file__).resolve().parents[2]
OUTPUT_ROOT = REPO / 'output'
LOSSES = {'TMAE': tmae_loss, 'CenterPoint': centerpoint_loss}
NOT_PORTED = {'GDMAE': 'ROADMAP.md, module 9: single-frame and list path'}
# flags the JAX CLI accepts and ignores
NO_OPS = ('sync_bn', 'amp', 'merge_all_iters_to_one_epoch', 'save_to_file',
          'local_rank', 'start_epoch')
LOG_EVERY = 20


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--cfg_file', type=str, required=True)
    parser.add_argument('--batch_size', type=int, default=None,
                        help='batch size (default: BATCH_SIZE_PER_GPU)')
    parser.add_argument('--epochs', type=int, default=None)
    parser.add_argument('--extra_tag', type=str, default='default')
    parser.add_argument('--ckpt', type=str, default=None)
    parser.add_argument('--pretrained_model', type=str, default=None)
    parser.add_argument('--fix_random_seed', action='store_true')
    parser.add_argument('--ckpt_save_interval', type=int, default=1)
    parser.add_argument('--max_ckpt_save_num', type=int, default=5)
    parser.add_argument('--num_epochs_to_eval', type=int, default=0)
    parser.add_argument('--fixed_gap_eval', type=int, default=-1)
    parser.add_argument('--set', dest='set_cfgs', default=None, nargs='*',
                        help='set extra config keys')
    parser.add_argument('--device', type=str, default=None,
                        help='torch device (default: the card)')
    parser.add_argument('--workers', type=int, default=2,
                        help='loader prefetch depth (a thread, not '
                        'processes)')
    parser.add_argument('--launcher', choices=['none', 'jax', 'pytorch',
                                               'slurm'], default='none',
                        help='only none is ported')
    parser.add_argument('--local_rank', type=int, default=None,
                        help='no-op')
    parser.add_argument('--tcp_port', type=int, default=18888)
    parser.add_argument('--sync_bn', action='store_true', help='no-op')
    parser.add_argument('--amp', action='store_true', help='no-op')
    parser.add_argument('--start_epoch', type=int, default=0,
                        help='no-op: the start epoch follows the step')
    parser.add_argument('--merge_all_iters_to_one_epoch',
                        action='store_true', help='no-op')
    parser.add_argument('--max_waiting_mins', type=int, default=30)
    parser.add_argument('--save_to_file', action='store_true',
                        help='no-op: the log always goes to a file')
    parser.add_argument('--wandb', action='store_true')
    parser.add_argument('--wandb_proj_name', type=str, default='tmae_tpu')
    args = parser.parse_args(argv)
    cfg = cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs is not None:
        cfg = cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def make_logger(path: Path) -> logging.Logger:
    """A logger of this run to the console and to ``path``."""
    logger = logging.getLogger(f'{__name__}.{path}')
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = logging.Formatter('%(asctime)s %(levelname)s %(message)s')
    for h in (logging.StreamHandler(), logging.FileHandler(path)):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def close_logger(logger: logging.Logger):
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()


def read_metrics(pending: list):
    """Fills in each pending ``(record, metrics)`` pair's loss, grad_norm
    and occ_overflow from its step's metrics on the device, all in one
    read, and empties ``pending``."""
    if not pending:
        return
    values = torch.stack([torch.stack([m['loss'].double(),
                                       m['grad_norm'].double(),
                                       m['occ_overflow'].double()])
                          for _, m in pending]).tolist()
    for (rec, _), (loss, grad_norm, overflow) in zip(pending, values):
        rec.update(loss=loss, grad_norm=grad_norm,
                   occ_overflow=int(overflow))
    pending.clear()


def main(argv=None):
    """Trains as the arguments say. Returns a summary: ``out_dir``,
    ``steps_per_epoch``, ``start_step`` (0, or the resumed checkpoint's),
    ``steps`` (one dict per step: step, epoch, loss, grad_norm, the lr it
    applied, occ_overflow, data_s and step_s, the host's seconds from the
    step's start to its return, which leave out the device's tail of a
    step that does not log), ``epochs`` (one dict per epoch: epoch, steps,
    seconds of wall time, data_s and fwd_s summed), ``checkpoints`` (what
    ``ckpt/`` holds at the end), ``pretrained`` ((copied, kept) names, or
    None) and ``eval`` (the AP dict, or None). A step's metrics stay on
    the device until a logged iteration or the epoch's end reads them."""
    args, cfg = parse_config(argv)
    name = cfg.MODEL.NAME
    if args.launcher != 'none':
        raise NotImplementedError('multi-process training is not ported yet '
                                  '(ROADMAP.md, module 8)')
    if name not in LOSSES:
        raise NotImplementedError(
            f'training {name} is not ported yet ('
            + NOT_PORTED.get(name, 'ROADMAP.md, module 10: other detector '
                             'families') + ')')
    device = resolve_device(args.device)
    batch_size = args.batch_size or int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    epochs = args.epochs or int(cfg.OPTIMIZATION.NUM_EPOCHS)
    seed = 666 if args.fix_random_seed else int(time.time()) % 2 ** 31
    is_mae = name == 'TMAE'

    out_dir = OUTPUT_ROOT / cfg.EXP_GROUP_PATH / cfg.TAG / args.extra_tag
    ckpt_dir = out_dir / 'ckpt'
    out_dir.mkdir(parents=True, exist_ok=True)
    stamp = datetime.datetime.now().strftime('%Y%m%d-%H%M%S')
    logger = make_logger(out_dir / f'log_train_{stamp}.txt')
    metrics_log = None
    try:
        logger.info('device %s, seed %d, batch %d, epochs %d', device, seed,
                    batch_size, epochs)
        for flag in NO_OPS:
            if getattr(args, flag) not in (None, False, 0):
                logger.info('--%s is a no-op', flag)
        log_config_to_file(cfg, logger=logger)

        dataset, loader = build_dataloader(
            cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size, training=True,
            runtime_cfg=cfg.RUNTIME, seed=seed)
        loader.prefetch = max(1, args.workers)
        steps_per_epoch = len(loader)
        logger.info('dataset: %d samples, %d steps/epoch', len(dataset),
                    steps_per_epoch)
        if steps_per_epoch == 0:
            raise ValueError(f'{len(dataset)} samples make no batch of '
                             f'{batch_size}')

        model = init_training_(build_detector(cfg, 'cpu'), seed).to(device)
        pretrained = None
        if args.pretrained_model:
            pretrained = load_pretrained_params(args.pretrained_model, model)
            logger.info('loaded pretrained model from %s: %d entries copied, '
                        '%d kept at init', args.pretrained_model,
                        len(pretrained[0]), len(pretrained[1]))
        opt, sched = build_optimizer(
            model.parameters(), dict(cfg.OPTIMIZATION, NUM_EPOCHS=epochs),
            steps_per_epoch)
        loss = LOSSES[name]
        train_step = make_train_step(
            model, lambda out, batch: loss(cfg, out, batch), opt, sched,
            mask_seed=seed + 7 if is_mae else None)

        resume = args.ckpt or latest_checkpoint(ckpt_dir)
        if resume:
            train_step.step = restore_checkpoint(resume, model, opt)
            logger.info('resumed from %s (step %d, epoch %d)', resume,
                        train_step.step, train_step.step // steps_per_epoch)
        start_step = train_step.step

        metrics_log = MetricsLogger(
            out_dir, wandb_project=args.wandb_proj_name if args.wandb
            else None)
        logger.info('metrics to %s', ', '.join(metrics_log.sinks))
        steps, epoch_recs = [], []
        for epoch in range(start_step // steps_per_epoch, epochs):
            loader.set_epoch(epoch)
            epoch_timer, lap = Timer(), Timer()
            data_m, fwd_m = AverageMeter(), AverageMeter()
            pending = []  # records whose metrics are still on the device
            for it, batch in enumerate(loader):
                dev_batch = batch_to_device(
                    {k: v for k, v in batch.items() if k != 'frame_id'},
                    device)
                data_m.update(lap.lap())
                metrics = train_step(dev_batch)
                rec = {'step': train_step.step, 'epoch': epoch,
                       'lr': opt.param_groups[0]['lr'], 'data_s': data_m.val}
                steps.append(rec)
                pending.append((rec, metrics))
                if it % LOG_EVERY == 0:
                    read_metrics(pending)  # waits for the device
                    logger.info(
                        'epoch %d it %d/%d loss %.4f grad %.2f lr %.2e '
                        'data %.2fs fwd %.2fs occ_overflow %d', epoch, it,
                        steps_per_epoch, rec['loss'], rec['grad_norm'],
                        rec['lr'], data_m.sum, fwd_m.sum, rec['occ_overflow'])
                    metrics_log.log(train_step.step, {
                        'train/loss': rec['loss'],
                        'train/grad_norm': rec['grad_norm'],
                        'meta_data/learning_rate': rec['lr'],
                        'train/occ_overflow': rec['occ_overflow'],
                        'time/data_s': data_m.sum, 'time/fwd_s': fwd_m.sum,
                        'epoch': epoch})
                rec['step_s'] = lap.lap()
                fwd_m.update(rec['step_s'])
            read_metrics(pending)
            epoch_recs.append({'epoch': epoch, 'steps': data_m.count,
                               'seconds': epoch_timer.lap(),
                               'data_s': data_m.sum, 'fwd_s': fwd_m.sum})
            logger.info('epoch %d done in %.1fs', epoch,
                        epoch_recs[-1]['seconds'])
            if (epoch + 1) % args.ckpt_save_interval == 0:
                path = save_checkpoint(ckpt_dir, model, opt, train_step.step,
                                       args.max_ckpt_save_num)
                logger.info('saved %s', path)

        ap_dict = None
        if not is_mae and args.num_epochs_to_eval > 0:
            eval_data = copy.deepcopy(cfg.DATA_CONFIG)
            if args.fixed_gap_eval >= 0:
                eval_data.FIXED_GAP = args.fixed_gap_eval
            eval_ds, eval_loader = build_dataloader(
                eval_data, cfg.CLASS_NAMES, batch_size, training=False,
                runtime_cfg=cfg.RUNTIME, seed=seed)
            ap_str, ap_dict = eval_one_epoch(
                cfg, model, eval_loader, eval_ds, cfg.CLASS_NAMES,
                result_dir=out_dir / 'eval', logger=logger)
            logger.info('\n%s', ap_str)
        return {'out_dir': out_dir, 'steps_per_epoch': steps_per_epoch,
                'start_step': start_step, 'steps': steps,
                'epochs': epoch_recs,
                'checkpoints': checkpoints(ckpt_dir),
                'pretrained': pretrained, 'eval': ap_dict}
    finally:
        if metrics_log is not None:
            metrics_log.close()
        close_logger(logger)


if __name__ == '__main__':
    main()
