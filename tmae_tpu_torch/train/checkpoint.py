"""Training checkpoints with ``torch.save`` (counterpart of
``tmae_tpu/train/checkpoint.py``, which uses orbax): model, optimizer and
step in one file."""

from __future__ import annotations

from pathlib import Path

import torch


def save_checkpoint(path, model, optimizer, step: int) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({'model': model.state_dict(),
                'optimizer': optimizer.state_dict(), 'step': int(step)}, path)
    return path


def restore_checkpoint(path, model, optimizer=None) -> int:
    """Loads the model (strict) and, when given, the optimizer state; returns
    the step."""
    state = torch.load(path, map_location='cpu', weights_only=True)
    model.load_state_dict(state['model'], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(state['optimizer'])
    return int(state['step'])
