"""Weighted bidirectional Chamfer distance (counterpart of
``tmae_tpu/ops/chamfer.py``, plain jnp there and plain PyTorch here): squared
L2, the mean over each cloud's points in each direction, per-cloud weights,
and the weighted sum over clouds divided by ``max(sum(weights), 1e-6)``."""

from __future__ import annotations

import torch


def chamfer_distance(pred: torch.Tensor, gt: torch.Tensor,
                     weights: torch.Tensor | None = None) -> torch.Tensor:
    """pred [N, P, 3], gt [N, G, 3], weights [N] → scalar."""
    d2 = (pred[:, :, None, :] - gt[:, None, :, :]).square().sum(-1)
    per_cloud = d2.min(2).values.mean(1) + d2.min(1).values.mean(1)
    if weights is None:
        return per_cloud.mean()
    return (per_cloud * weights).sum() / weights.sum().clamp(min=1e-6)
