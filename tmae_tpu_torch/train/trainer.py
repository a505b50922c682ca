"""The training step (counterpart of ``tmae_tpu/train/trainer.py``
``make_train_step``): forward in train mode, loss, backward through the
kernels' backward passes, one optimizer update. Where the JAX step folds
named random streams (``rng_names``, e.g. the MAE mask) out of its key, this
one hands the model a ``torch.Generator`` seeded anew from ``mask_seed`` and
the step count, as the JAX CLI folds the step into its key, so that a
resumed run draws the masks of an uninterrupted one."""

from __future__ import annotations

import numpy as np
import torch

from .optimization import Schedules


def collect_occ_overflow(outputs) -> torch.Tensor:
    """Occupied windows that went over a bucket cap (and ran as identity),
    summed over every stage: 0 when the caps hold the batch."""
    return outputs['occ_overflow'].sum()


def step_seed(seed: int, step: int) -> int:
    """A 64-bit seed from (``seed``, ``step``): the port's ``fold_in``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


class TrainStep:
    """``train_step(batch) -> metrics``; ``step`` counts the updates made
    and picks each update's learning rate, beta1 and (with ``mask_seed``)
    random stream. A resumed run sets ``step`` to the checkpoint's."""

    def __init__(self, model, loss_fn, optimizer, schedules: Schedules,
                 mask_seed=None):
        self.model, self.loss_fn = model, loss_fn
        self.optimizer, self.schedules = optimizer, schedules
        self.mask_seed = mask_seed
        self.params = [p for g in optimizer.param_groups for p in g['params']]
        self.step = 0

    def step_generator(self):
        """The generator of this step's draws, on the parameters' device,
        seeded from ``mask_seed`` and ``step`` (None without a seed)."""
        if self.mask_seed is None:
            return None
        g = torch.Generator(device=self.params[0].device)
        return g.manual_seed(step_seed(self.mask_seed, self.step))

    def __call__(self, batch: dict, **model_kwargs) -> dict:
        """``model_kwargs`` go to the model's forward (a pretraining test
        passes the MAE mask this way)."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        gen = self.step_generator()
        if gen is not None:
            model_kwargs.setdefault('generator', gen)
        out = self.model(batch, **model_kwargs)
        loss, parts = self.loss_fn(out, batch)
        loss.backward()
        for p in self.params:  # optax updates every leaf: zero, not absent
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip = self.schedules.grad_clip
        grad_norm = torch.nn.utils.clip_grad_norm_(
            self.params, clip if clip > 0 else float('inf'))
        beta1 = self.schedules.beta1
        for g in self.optimizer.param_groups:
            g['lr'] = self.schedules.lr(self.step)
            if beta1 is not None:
                g['betas'] = (beta1(self.step), g['betas'][1])
        self.optimizer.step()
        self.step += 1
        return {'loss': loss.detach(), 'grad_norm': grad_norm.detach(),
                **{k: v.detach() for k, v in parts.items()},
                'occ_overflow': collect_occ_overflow(out)}


def make_train_step(model, loss_fn, optimizer, schedules: Schedules,
                    mask_seed=None):
    """``loss_fn(outputs, batch) -> (loss, parts)``. Returns a
    :class:`TrainStep`: ``train_step(batch) -> metrics`` with ``loss``,
    ``grad_norm`` (before clipping), the loss parts and ``occ_overflow``.
    ``mask_seed``: a pretraining model draws each step's mask from a
    ``torch.Generator`` on its device seeded from it and the step
    (:func:`step_seed`)."""
    return TrainStep(model, loss_fn, optimizer, schedules, mask_seed)
