"""Sinusoidal in-window positional embedding (counterpart of
``tmae_tpu/ops/posembed.py``): coords centred by half a window, frequencies
``T ** (2*(i//2)/L)``, sin on even and cos on odd channels, x-embed then
y-embed concatenated to ``feat_dim``."""

from __future__ import annotations

import torch


def window_pos_embed(pos_yx: torch.Tensor, window: int, feat_dim: int,
                     temperature: float = 1000.0,
                     normalize: bool = False) -> torch.Tensor:
    """pos_yx [..., 2] raw in-window (y, x) coords → [..., feat_dim] f32."""
    assert feat_dim % 2 == 0
    pos_yx = pos_yx.float()
    y = pos_yx[..., 0] - window / 2.0
    x = pos_yx[..., 1] - window / 2.0
    if normalize:
        x = x / window * 2 * 3.1415
        y = y / window * 2 * 3.1415
    L = feat_dim // 2
    i = torch.arange(L, dtype=torch.float32, device=pos_yx.device)
    inv_freq = temperature ** (2 * torch.div(i, 2, rounding_mode='floor') / L)

    def embed(v):
        e = v[..., None] / inv_freq
        sin = torch.sin(e[..., 0::2])
        cos = torch.cos(e[..., 1::2])
        return torch.stack([sin, cos], dim=-1).reshape(e.shape[:-1] + (L,))

    return torch.cat([embed(x), embed(y)], dim=-1)
