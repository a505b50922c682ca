"""Training metrics (the port's copy of ``tmae_tpu/utils/metrics.py``):
scalars to ``metrics.jsonl`` always, to TensorBoard event files when
``torch.utils.tensorboard`` imports and to wandb when it imports and a
project is named; and the running meters and lap timer of the training
loop."""

from __future__ import annotations

import json
import time
from pathlib import Path


class AverageMeter:
    """Running mean and current value."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self):
        """Seconds since the last lap (or since the timer was made)."""
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        return dt


class MetricsLogger:
    """``log(step, scalars)`` appends one JSON line per call to
    ``<log_dir>/metrics.jsonl`` (values that do not convert to float are
    left out) and mirrors it to the optional sinks. ``log_dir=None`` makes
    a logger that writes nothing."""

    def __init__(self, log_dir, wandb_project=None):
        self._jsonl = self._tb = self._wandb = None
        self.log_dir = None if log_dir is None else Path(log_dir)
        if self.log_dir is None:
            return
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / 'metrics.jsonl', 'a')
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(str(self.log_dir / 'tensorboard'))
        except Exception:  # tensorboard is not installed
            self._tb = None
        if wandb_project:
            try:
                import wandb
                self._wandb = wandb.init(project=wandb_project,
                                         dir=str(self.log_dir))
            except Exception:  # wandb is not installed
                self._wandb = None

    @property
    def sinks(self) -> list:
        """The names of the sinks that write: ``jsonl``, ``tensorboard``,
        ``wandb``."""
        return [name for name, s in (('jsonl', self._jsonl),
                                     ('tensorboard', self._tb),
                                     ('wandb', self._wandb)) if s is not None]

    def log(self, step: int, scalars: dict):
        if self._jsonl is None:
            return
        rec = {'step': int(step)}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._jsonl.write(json.dumps(rec) + '\n')
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k != 'step':
                    self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(rec, step=step)

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
