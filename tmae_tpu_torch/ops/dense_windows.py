"""Dense window geometry and the constant per-slot positional embedding
(counterpart of ``tmae_tpu/ops/dense_windows.py``).

With ``max_tokens == window**2`` a window slot is its in-window position, so
the window tensor ``[B, NW, w*w, C]`` is a reshape of the padded dense grid.
The shift-s partition offsets the grid by ``off`` (w for shift0, w/2 for
shift1), which becomes top-left zero padding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .posembed import window_pos_embed


def window_geometry(grid_hw, window):
    """(nwy, nwx, padded_h, padded_w)."""
    H, W = grid_hw
    nwy = int(math.ceil(H / window)) + 1
    nwx = int(math.ceil(W / window)) + 1
    return nwy, nwx, nwy * window, nwx * window


def window_view(x: torch.Tensor, window: int, shift: bool) -> torch.Tensor:
    """[B, H, W, C] → [B, NW, window*window, C]."""
    B, H, W, C = x.shape
    nwy, nwx, Hp, Wp = window_geometry((H, W), window)
    off = window // 2 if shift else window
    xp = F.pad(x, (0, 0, off, Wp - W - off, off, Hp - H - off))
    xw = xp.reshape(B, nwy, window, nwx, window, C).permute(0, 1, 3, 2, 4, 5)
    return xw.reshape(B, nwy * nwx, window * window, C)


def window_unview(xw: torch.Tensor, grid_hw, window: int,
                  shift: bool) -> torch.Tensor:
    """Inverse of :func:`window_view`: [B, NW, window*window, C] →
    [B, H, W, C]."""
    H, W = grid_hw
    B, _, _, C = xw.shape
    nwy, nwx, Hp, Wp = window_geometry((H, W), window)
    off = window // 2 if shift else window
    x = xw.reshape(B, nwy, nwx, window, window, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, C)[:, off:off + H, off:off + W]


def slot_pos_embed(window: int, feat_dim: int, temperature: float = 1000.0,
                   normalize: bool = False) -> torch.Tensor:
    """Constant per-slot embedding [window*window, feat_dim] f32: the
    in-window coordinate of slot (iy, ix) is (iy, ix) itself."""
    iy, ix = torch.meshgrid(torch.arange(window), torch.arange(window),
                            indexing='ij')
    pos = torch.stack([iy.reshape(-1), ix.reshape(-1)], -1).float()
    return window_pos_embed(pos, window, feat_dim, temperature, normalize)
