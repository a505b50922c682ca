"""Training checkpoints with ``torch.save`` (counterpart of
``tmae_tpu/train/checkpoint.py``, which uses orbax): model, optimizer (when
there is one) and step in one file. ``latest_checkpoint`` finds the newest
``checkpoint_<step>`` file of a directory, as the evaluation CLI polls
for."""

from __future__ import annotations

import re
from pathlib import Path

import torch

_NAME = re.compile(r'checkpoint_(\d+)(\.\w+)?$')


def save_checkpoint(path, model, optimizer, step: int) -> Path:
    """``optimizer`` may be None (weights and step only)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    state = {'model': model.state_dict(), 'step': int(step)}
    if optimizer is not None:
        state['optimizer'] = optimizer.state_dict()
    torch.save(state, path)
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
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return None
    steps = {}
    for p in ckpt_dir.iterdir():
        m = _NAME.match(p.name)
        if m and p.is_file():
            steps[p] = int(m.group(1))
    return max(steps, key=steps.get) if steps else None
