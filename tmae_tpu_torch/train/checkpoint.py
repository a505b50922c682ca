"""Training checkpoints with ``torch.save`` (counterpart of
``tmae_tpu/train/checkpoint.py``, which uses orbax), in its three roles:
full resume (model, optimizer when there is one, step: one file,
``checkpoint_<step>.pth``, pruned to the newest ``max_keep``), the
evaluation load (strict), and the shape-matched weights-only transfer of a
pretrained model (:func:`load_pretrained_params`). ``latest_checkpoint``
finds the newest ``checkpoint_<step>`` file of a directory, as the
training CLI resumes and the evaluation CLI polls."""

from __future__ import annotations

import logging
import re
from pathlib import Path

import torch

log = logging.getLogger(__name__)

_NAME = re.compile(r'checkpoint_(\d+)(\.\w+)?$')


def checkpoints(ckpt_dir) -> list:
    """The ``checkpoint_<step>`` files (any suffix) of ``ckpt_dir``, oldest
    step first."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return []
    steps = {}
    for p in ckpt_dir.iterdir():
        m = _NAME.match(p.name)
        if m and p.is_file():
            steps[p] = int(m.group(1))
    return sorted(steps, key=steps.get)


def save_checkpoint(ckpt_dir, model, optimizer, step: int,
                    max_keep: int | None = None) -> Path:
    """Writes ``ckpt_dir/checkpoint_<step>.pth`` (``optimizer`` may be None:
    weights and step only); with ``max_keep``, then removes all but the
    newest ``max_keep`` checkpoints of ``ckpt_dir`` by step. Returns the
    file."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f'checkpoint_{int(step)}.pth'
    state = {'model': model.state_dict(), 'step': int(step)}
    if optimizer is not None:
        state['optimizer'] = optimizer.state_dict()
    torch.save(state, path)
    if max_keep is not None:
        for old in checkpoints(ckpt_dir)[:-max(int(max_keep), 1)]:
            old.unlink()
    return path


def restore_checkpoint(path, model, optimizer=None) -> int:
    """Loads the model (strict) and, when given, the optimizer state; returns
    the step."""
    state = torch.load(path, map_location='cpu', weights_only=True)
    model.load_state_dict(state['model'], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(state['optimizer'])
    return int(state['step'])


def latest_checkpoint(ckpt_dir):
    """The ``checkpoint_<step>`` file (any suffix) of ``ckpt_dir`` with the
    largest step, or None."""
    found = checkpoints(ckpt_dir)
    return found[-1] if found else None


@torch.no_grad()
def load_pretrained_params(path, model) -> tuple:
    """Shape-matched, non-strict, weights-only transfer (the MAE → finetune
    role): every entry of ``model.state_dict()`` (parameters and batch-norm
    statistics) that the checkpoint at ``path`` holds under the same name
    and shape is copied; the rest keep their values and are logged. Returns
    (the names copied, the names kept)."""
    src = torch.load(path, map_location='cpu', weights_only=True)['model']
    copied, kept = [], []
    for name, dst in model.state_dict().items():
        val = src.get(name)
        if val is None:
            log.info('pretrained: missing %s, keeping init', name)
        elif tuple(val.shape) != tuple(dst.shape):
            log.info('pretrained: shape mismatch at %s (%s vs %s), keeping '
                     'init', name, tuple(val.shape), tuple(dst.shape))
            val = None
        if val is None:
            kept.append(name)
            continue
        dst.copy_(val)
        copied.append(name)
    return copied, kept
