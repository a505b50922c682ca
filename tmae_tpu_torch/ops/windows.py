"""List-path window partition (counterpart of ``tmae_tpu/ops/windows.py``):
compact ``[B, V, C]`` voxel lists assigned to the windows of one shift,
with a rank per voxel inside its window, the slot buffer ``[B, NW, T, C]``
and back. No model of the T-MAE configs runs it (the dense carrier path
covers ``max_tokens == window**2``); it serves configs with a smaller
``max_tokens`` and holds the dense path's semantics in tests.

Window ids follow ``sst_utils.get_window_coors``: shift 0 adds a full
window, shift 1 half a window, ``ceil(extent / window) + 1`` windows per
axis, x-major ids. With ``max_tokens == window**2`` a voxel's slot is its
in-window position; with fewer, its rank among its window's voxels in list
order (a stable sort), and ranks at or past ``max_tokens`` are dropped.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def num_windows(grid_hw: tuple, window: int) -> tuple:
    """(nwy, nwx): ``ceil(extent / window) + 1`` per axis."""
    H, W = grid_hw
    return math.ceil(H / window) + 1, math.ceil(W / window) + 1


@dataclasses.dataclass
class WindowPartition:
    """One shift's window assignment of a voxel list: ``win_slot`` [B, V]
    (window id, ``nw`` for invalid voxels), ``inner_rank`` [B, V], ``keep``
    [B, V] (valid and ranked under ``max_tokens``), ``pos_yx`` [B, V, 2]
    f32 in-window (y, x)."""

    win_slot: torch.Tensor
    inner_rank: torch.Tensor
    keep: torch.Tensor
    pos_yx: torch.Tensor
    nw: int
    max_tokens: int

    @property
    def dest(self):
        """Each voxel's slot in the flat [NW * T] buffer; ``NW * T`` for
        dropped voxels."""
        oob = self.nw * self.max_tokens
        return torch.where(self.keep,
                           self.win_slot * self.max_tokens + self.inner_rank,
                           oob)


def _inner_rank(win: torch.Tensor) -> torch.Tensor:
    """[B, V] window ids → each voxel's position among its window's voxels
    in list order."""
    B, V = win.shape
    order = torch.argsort(win, dim=1, stable=True)
    s = torch.gather(win, 1, order)
    pos = torch.arange(V, device=win.device).expand(B, V)
    newflag = torch.cat([torch.ones_like(s[:, :1], dtype=torch.bool),
                         s[:, 1:] != s[:, :-1]], 1)
    starts = torch.cummax(torch.where(newflag, pos, -1), 1).values
    return torch.empty_like(order).scatter_(1, order, pos - starts)


def window_partition(coords_yx: torch.Tensor, valid: torch.Tensor,
                     grid_hw: tuple, window: int = 8, shift: bool = False,
                     max_tokens: int = 64) -> WindowPartition:
    """coords_yx [B, V, 2] (y, x), valid [B, V] → :class:`WindowPartition`."""
    nwy, nwx = num_windows(grid_hw, window)
    nw = nwy * nwx
    off = window // 2 if shift else window
    y = coords_yx[..., 0].long() + off
    x = coords_yx[..., 1].long() + off
    win = torch.where(valid, (x // window) * nwy + y // window, nw)
    iy, ix = y % window, x % window
    if max_tokens == window * window:
        rank = iy * window + ix
    else:
        rank = _inner_rank(win)
    return WindowPartition(
        win_slot=win, inner_rank=rank, keep=valid & (rank < max_tokens),
        pos_yx=torch.stack([iy, ix], -1).float(), nw=nw,
        max_tokens=max_tokens)


def _window_counts(wp: WindowPartition) -> torch.Tensor:
    """[B, NW] kept voxels per window."""
    B = wp.win_slot.shape[0]
    cnt = torch.zeros(B, wp.nw + 1, dtype=torch.int64,
                      device=wp.win_slot.device)
    return cnt.scatter_add_(1, wp.win_slot, wp.keep.long())[:, :-1]


def couple_partitions(wp_cur: WindowPartition, wp_prv: WindowPartition):
    """Two-frame coupling for windowed cross attention: windows empty in
    either frame are dropped from both. Returns the two partitions with
    their ``keep`` gated."""
    assert wp_cur.nw == wp_prv.nw
    both = (_window_counts(wp_cur) > 0) & (_window_counts(wp_prv) > 0)

    def gate(wp):
        safe = wp.win_slot.clamp(max=wp.nw - 1)
        g = torch.gather(both, 1, safe) & (wp.win_slot < wp.nw)
        return dataclasses.replace(wp, keep=wp.keep & g)

    return gate(wp_cur), gate(wp_prv)


def scatter_to_windows(feat: torch.Tensor, wp: WindowPartition):
    """[B, V, C] → [B, NW, T, C], zeros in empty slots."""
    B, V, C = feat.shape
    T = wp.max_tokens
    src = torch.where(wp.keep[..., None], feat, 0.0)
    buf = feat.new_zeros(B, wp.nw * T + 1, C)
    buf = buf.scatter(1, wp.dest[..., None].expand(B, V, C), src)
    return buf[:, :-1].reshape(B, wp.nw, T, C)


def window_key_mask(wp: WindowPartition) -> torch.Tensor:
    """[B, NW, T] bool: True where a kept voxel occupies the slot."""
    ones = torch.ones(wp.keep.shape + (1,), dtype=torch.float32,
                      device=wp.keep.device)
    return scatter_to_windows(ones, wp)[..., 0] > 0


def gather_from_windows(win_feat: torch.Tensor, wp: WindowPartition):
    """[B, NW, T, C] → [B, V, C]; dropped voxels get zeros."""
    B, NW, T, C = win_feat.shape
    safe = wp.dest.clamp(max=NW * T - 1)
    out = torch.gather(win_feat.reshape(B, NW * T, C), 1,
                       safe[..., None].expand(-1, -1, C))
    return torch.where(wp.keep[..., None], out, 0.0)
