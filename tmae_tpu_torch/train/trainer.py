"""The training step (counterpart of ``tmae_tpu/train/trainer.py``
``make_train_step``): forward in train mode, loss, backward through the
kernels' backward passes, one optimizer update."""

from __future__ import annotations

import torch

from .optimization import Schedules


def collect_occ_overflow(outputs) -> torch.Tensor:
    """Occupied windows that went over a bucket cap (and ran as identity),
    summed over every stage: 0 when the caps hold the batch."""
    return outputs['occ_overflow'].sum()


class TrainStep:
    """``train_step(batch) -> metrics``; ``step`` counts the updates made
    and picks each update's learning rate and beta1."""

    def __init__(self, model, loss_fn, optimizer, schedules: Schedules):
        self.model, self.loss_fn = model, loss_fn
        self.optimizer, self.schedules = optimizer, schedules
        self.params = [p for g in optimizer.param_groups for p in g['params']]
        self.step = 0

    def __call__(self, batch: dict) -> dict:
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        out = self.model(batch)
        loss, parts = self.loss_fn(out, batch)
        loss.backward()
        for p in self.params:  # optax updates every leaf: zero, not absent
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip = self.schedules.grad_clip
        grad_norm = torch.nn.utils.clip_grad_norm_(
            self.params, clip if clip > 0 else float('inf'))
        for g in self.optimizer.param_groups:
            g['lr'] = self.schedules.lr(self.step)
            g['betas'] = (self.schedules.beta1(self.step), g['betas'][1])
        self.optimizer.step()
        self.step += 1
        return {'loss': loss.detach(), 'grad_norm': grad_norm.detach(),
                **{k: v.detach() for k, v in parts.items()},
                'occ_overflow': collect_occ_overflow(out)}


def make_train_step(model, loss_fn, optimizer, schedules: Schedules):
    """``loss_fn(outputs, batch) -> (loss, parts)``. Returns a
    :class:`TrainStep`: ``train_step(batch) -> metrics`` with ``loss``,
    ``grad_norm`` (before clipping), the loss parts and ``occ_overflow``."""
    return TrainStep(model, loss_fn, optimizer, schedules)
