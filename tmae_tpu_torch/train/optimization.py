"""The optimizers (counterpart of ``tmae_tpu/train/optimization.py``),
each the JAX package's optax chain, applied in its order:

* ``adam_onecycle``: global-norm clipping, Adam with beta1 from the
  anti-phased momentum schedule and beta2 0.99, decoupled weight decay,
  the one-cycle learning rate.
* ``adam``: clipping, Adam (beta1 0.9, beta2 0.999, eps 1e-8), decoupled
  weight decay, the step-decay learning rate (:func:`decay_step_schedule`).
* ``sgd``: clipping, weight decay added to the gradient, a momentum trace
  (no dampening, no Nesterov), the step-decay learning rate.

``torch.optim.AdamW`` with ``lr`` (and ``betas[0]``) set before each step
computes the same update as the Adam chains: its bias correction uses the
current beta1, as optax's does, and its decay ``p *= 1 - lr * wd`` is
optax's ``add_decayed_weights`` after ``scale_by_adam``, scaled by the
learning rate. ``torch.optim.SGD(momentum=m, weight_decay=wd)`` is the
``sgd`` chain: its buffer starts at the first gradient, as optax's trace
(from zeros) does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


def annealing_cos(start, end, pct):
    return end + (start - end) / 2 * (math.cos(math.pi * pct) + 1)


def one_cycle_schedules(total_steps: int, lr_max: float, moms,
                        div_factor: float, pct_start: float):
    """Returns (lr_fn, mom_fn), each step → value: the learning rate anneals
    lr_max / div → lr_max over the first ``pct_start`` of the steps, then →
    lr_max / div / 1e4; beta1 runs moms[0] → moms[1] → moms[0]."""
    low_lr = lr_max / div_factor
    a1 = int(total_steps * pct_start)

    def phases(step):
        p1 = min(max(step / max(a1, 1), 0.0), 1.0)
        p2 = min(max((step - a1) / max(total_steps - a1, 1), 0.0), 1.0)
        return p1, p2

    def lr_fn(step):
        p1, p2 = phases(float(step))
        if step < a1:
            return annealing_cos(low_lr, lr_max, p1)
        return annealing_cos(lr_max, low_lr / 1e4, p2)

    def mom_fn(step):
        p1, p2 = phases(float(step))
        if step < a1:
            return annealing_cos(moms[0], moms[1], p1)
        return annealing_cos(moms[1], moms[0], p2)

    return lr_fn, mom_fn


def decay_step_schedule(total_steps_per_epoch: int, lr: float,
                        decay_step_list, lr_decay: float, lr_clip: float,
                        warmup_epoch: int, use_warmup: bool):
    """Step → learning rate: ``max(lr * lr_decay ** k, lr_clip)`` after the
    k-th epoch of ``decay_step_list`` has begun; with ``use_warmup``, the
    first ``warmup_epoch`` epochs take ``lr * clip(step / warmup steps,
    1e-3, 1)`` instead (the JAX package's expression as written)."""
    decay_steps = [int(x * total_steps_per_epoch) for x in decay_step_list]
    wsteps = warmup_epoch * total_steps_per_epoch

    def lr_fn(step):
        factor = 1.0
        for ds in decay_steps:
            if step >= ds:
                factor *= lr_decay
        cur = max(lr * factor, lr_clip)
        if use_warmup and step < wsteps:
            cur = lr * min(max(step / max(wsteps, 1), 1e-3), 1.0)
        return cur

    return lr_fn


@dataclasses.dataclass
class Schedules:
    """Per-step hyperparameters of a recipe: the learning rate, and beta1
    where the recipe schedules it (``adam_onecycle``; None otherwise)."""

    lr: Callable[[int], float]
    beta1: Callable[[int], float] | None
    grad_clip: float  # global-norm clip; 0 means none


def build_optimizer(params, optim_cfg, steps_per_epoch: int):
    """Returns (the torch optimizer over ``params``, :class:`Schedules`) of
    ``OPTIMIZATION.OPTIMIZER``: ``adam_onecycle``, ``adam`` or ``sgd``."""
    name = optim_cfg['OPTIMIZER']
    clip = float(optim_cfg.get('GRAD_NORM_CLIP', 0) or 0)
    wd = float(optim_cfg.get('WEIGHT_DECAY', 0.0))
    if name in ('adam', 'sgd'):
        lr_fn = decay_step_schedule(
            steps_per_epoch, float(optim_cfg['LR']),
            optim_cfg.get('DECAY_STEP_LIST', []),
            float(optim_cfg.get('LR_DECAY', 0.1)),
            float(optim_cfg.get('LR_CLIP', 1e-7)),
            int(optim_cfg.get('WARMUP_EPOCH', 1)),
            bool(optim_cfg.get('LR_WARMUP', False)))
        if name == 'adam':
            opt = torch.optim.AdamW(params, lr=lr_fn(0), betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=wd)
        else:
            opt = torch.optim.SGD(
                params, lr=lr_fn(0),
                momentum=float(optim_cfg.get('MOMENTUM', 0.9)),
                weight_decay=wd)
        return opt, Schedules(lr_fn, None, clip)
    if name != 'adam_onecycle':
        raise NotImplementedError(
            f'optimizer {name} is not one of the JAX package\'s recipes '
            '(adam_onecycle, adam, sgd)')
    total_steps = int(steps_per_epoch * optim_cfg['NUM_EPOCHS'])
    lr_fn, mom_fn = one_cycle_schedules(
        total_steps, float(optim_cfg['LR']),
        tuple(optim_cfg.get('MOMS', (0.95, 0.85))),
        float(optim_cfg.get('DIV_FACTOR', 10)),
        float(optim_cfg.get('PCT_START', 0.4)))
    opt = torch.optim.AdamW(
        params, lr=lr_fn(0), betas=(mom_fn(0), 0.99), eps=1e-8,
        weight_decay=wd)
    return opt, Schedules(lr_fn, mom_fn, clip)
