"""The training step (counterpart of ``tmae_tpu/train/trainer.py``
``make_train_step``): forward in train mode, loss, backward through the
kernels' backward passes, one optimizer update. Where the JAX step folds
named random streams (``rng_names``, e.g. the MAE mask) out of its key, this
one hands the model a ``torch.Generator`` seeded anew from ``mask_seed`` and
the step count, as the JAX CLI folds the step into its key, so that a
resumed run draws the masks of an uninterrupted one. A model that names
its streams (``rng_streams``, GraphRCNN's proposal and dropout draws) gets
one generator a stream, seeded from (``mask_seed``, step, stream).

Under data parallelism (``parallel/dist.py``) each rank runs the step on
its slice of the global batch; its loss is its share of the global loss
(the normalizers are global sums), the gradients are summed over the ranks
before the clip, so the grad norm and the update are those of the
one-process step on the global batch, and the metrics are summed over the
ranks. Each rank draws its MAE mask from (seed, step, rank)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..parallel import dist
from .optimization import Schedules


def collect_occ_overflow(outputs) -> torch.Tensor:
    """Occupied windows that went over a bucket cap (and ran as identity),
    summed over every stage: 0 when the caps hold the batch."""
    return outputs['occ_overflow'].sum()


def step_seed(seed: int, step: int, rank=None, stream=None) -> int:
    """A 64-bit seed from (``seed``, ``step``), and ``rank`` and
    ``stream`` when given: the port's ``fold_in``."""
    words = [seed, step] + [w for w in (rank, stream) if w is not None]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0])


def sum_over_ranks(metrics: dict) -> dict:
    """Each scalar of ``metrics`` summed over the ranks, in one
    all-reduce; ``metrics`` itself outside a process group."""
    if not dist.grouped():
        return metrics
    vals = list(metrics.values())
    total = dist.global_sum(torch.stack([v.double() for v in vals]))
    return {k: t.to(v.dtype) for (k, v), t in zip(metrics.items(), total)}


@contextlib.contextmanager
def deterministic_convolutions():
    """cuDNN restricted to its deterministic algorithms while the step's
    forward and backward run: some of the weight-gradient algorithms it
    would pick otherwise sum with float atomics, and a step's gradients
    then change from run to run on the card."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


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

    def step_generator(self, stream=None):
        """The generator of this step's draws (of stream number
        ``stream``), on the parameters' device, seeded from ``mask_seed``,
        ``step``, with more than one rank the rank, and the stream (None
        without a seed)."""
        if self.mask_seed is None:
            return None
        g = torch.Generator(device=self.params[0].device)
        rank = dist.rank() if dist.world() > 1 else None
        return g.manual_seed(step_seed(self.mask_seed, self.step, rank,
                                       stream))

    def __call__(self, batch: dict, **model_kwargs) -> dict:
        """``model_kwargs`` go to the model's forward (a pretraining test
        passes the MAE mask this way)."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        streams = getattr(self.model, 'rng_streams', None)
        if self.mask_seed is not None and streams:
            model_kwargs.setdefault('generators', {
                name: self.step_generator(i)
                for i, name in enumerate(streams)})
        elif self.mask_seed is not None:
            model_kwargs.setdefault('generator', self.step_generator())
        with deterministic_convolutions():
            out = self.model(batch, **model_kwargs)
            loss, parts = self.loss_fn(out, batch)
            loss.backward()
        for p in self.params:  # optax updates every leaf: zero, not absent
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        # the global gradient: a SUM, since each rank's loss is its share of
        # the global loss (a DDP wrapper would average instead)
        dist.all_reduce_grads(self.params)
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
        metrics = sum_over_ranks({
            'loss': loss.detach(), **{k: v.detach() for k, v in parts.items()},
            'occ_overflow': collect_occ_overflow(out)})
        return {'loss': metrics.pop('loss'), 'grad_norm': grad_norm.detach(),
                **metrics}


def make_train_step(model, loss_fn, optimizer, schedules: Schedules,
                    mask_seed=None):
    """``loss_fn(outputs, batch) -> (loss, parts)``. Returns a
    :class:`TrainStep`: ``train_step(batch) -> metrics`` with ``loss``,
    ``grad_norm`` (before clipping), the loss parts and ``occ_overflow``.
    ``mask_seed``: a pretraining model draws each step's mask from a
    ``torch.Generator`` on its device seeded from it and the step
    (:func:`step_seed`)."""
    return TrainStep(model, loss_fn, optimizer, schedules, mask_seed)
