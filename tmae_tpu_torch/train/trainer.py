"""The training step (counterpart of ``tmae_tpu/train/trainer.py``
``make_train_step``): forward in train mode, loss, backward through the
kernels' backward passes, one optimizer update. Where the JAX step folds
named random streams (``rng_names``, e.g. the MAE mask) out of its key, this
one hands a ``torch.Generator`` to the model."""

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

    def __init__(self, model, loss_fn, optimizer, schedules: Schedules,
                 generator=None):
        self.model, self.loss_fn = model, loss_fn
        self.optimizer, self.schedules = optimizer, schedules
        self.generator = generator
        self.params = [p for g in optimizer.param_groups for p in g['params']]
        self.step = 0

    def __call__(self, batch: dict, **model_kwargs) -> dict:
        """``model_kwargs`` go to the model's forward (a pretraining test
        passes the MAE mask this way)."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        if self.generator is not None:
            model_kwargs.setdefault('generator', self.generator)
        out = self.model(batch, **model_kwargs)
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


def make_train_step(model, loss_fn, optimizer, schedules: Schedules,
                    generator=None):
    """``loss_fn(outputs, batch) -> (loss, parts)``. Returns a
    :class:`TrainStep`: ``train_step(batch) -> metrics`` with ``loss``,
    ``grad_norm`` (before clipping), the loss parts and ``occ_overflow``.
    ``generator``: the ``torch.Generator`` (on the model's device) that a
    pretraining model draws its mask from, step after step."""
    return TrainStep(model, loss_fn, optimizer, schedules, generator)
