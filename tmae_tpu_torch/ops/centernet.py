"""CenterNet decode helpers (counterpart of
``tmae_tpu/ops/centernet.py:exact_topk_flat`` and ``gather_feat_nhwc``)."""

from __future__ import annotations

import torch


def gather_feat_nhwc(feat: torch.Tensor, inds: torch.Tensor):
    """feat [B, H, W, C], inds [B, K] flat cell index → [B, K, C]."""
    B, H, W, C = feat.shape
    return torch.gather(feat.reshape(B, H * W, C), 1,
                        inds.long()[..., None].expand(-1, -1, C))


def exact_topk_flat(flat: torch.Tensor, K: int):
    """Exact top-K along dim 1 of ``flat`` [B, N]: values by value
    descending, ties by index ascending, and at the K-th value the lowest
    indices are kept. ``torch.topk`` is exact but leaves the order of equal
    values unspecified, so only its K-th value is used here; this is the
    order ``lax.top_k`` gives the JAX package."""
    B = flat.shape[0]
    kth = torch.topk(flat, K, dim=1, sorted=True).values[:, -1:]
    greater = flat > kth
    equal = flat == kth
    need = K - greater.sum(1, keepdim=True)
    keep = greater | (equal & (equal.cumsum(1) <= need))
    idx = torch.nonzero(keep)[:, 1].reshape(B, K)  # ascending index
    vals = torch.gather(flat, 1, idx)
    order = torch.argsort(vals, dim=1, descending=True, stable=True)
    return torch.gather(vals, 1, order), torch.gather(idx, 1, order)
