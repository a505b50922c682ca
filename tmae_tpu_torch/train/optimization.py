"""The ``adam_onecycle`` optimizer (counterpart of
``tmae_tpu/train/optimization.py``): global-norm clipping, Adam with beta1
from the anti-phased momentum schedule and beta2 0.99, decoupled weight
decay, and the one-cycle learning rate, applied in that order.

``torch.optim.AdamW`` with ``lr`` and ``betas[0]`` set before each step
computes the same update as the JAX package's optax chain: its bias
correction uses the current beta1, as optax's does, and its decay
``p *= 1 - lr * wd`` is optax's ``add_decayed_weights`` scaled by the
learning rate. The plain ``adam`` / ``sgd`` recipes are not ported yet.
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


@dataclasses.dataclass
class Schedules:
    """Per-step hyperparameters of ``adam_onecycle``."""

    lr: Callable[[int], float]
    beta1: Callable[[int], float]
    grad_clip: float  # global-norm clip; 0 means none


def build_optimizer(params, optim_cfg, steps_per_epoch: int):
    """Returns (``torch.optim.AdamW`` over ``params``, :class:`Schedules`)."""
    name = optim_cfg['OPTIMIZER']
    if name != 'adam_onecycle':
        raise NotImplementedError(f'optimizer {name} is not ported yet')
    total_steps = int(steps_per_epoch * optim_cfg['NUM_EPOCHS'])
    lr_fn, mom_fn = one_cycle_schedules(
        total_steps, float(optim_cfg['LR']),
        tuple(optim_cfg.get('MOMS', (0.95, 0.85))),
        float(optim_cfg.get('DIV_FACTOR', 10)),
        float(optim_cfg.get('PCT_START', 0.4)))
    opt = torch.optim.AdamW(
        params, lr=lr_fn(0), betas=(mom_fn(0), 0.99), eps=1e-8,
        weight_decay=float(optim_cfg.get('WEIGHT_DECAY', 0.0)))
    clip = float(optim_cfg.get('GRAD_NORM_CLIP', 0) or 0)
    return opt, Schedules(lr_fn, mom_fn, clip)
