"""Static-shape 3D sparse convolution by neighbour gathering (counterpart
of ``tmae_tpu/ops/sparse3d.py``; the JAX package computes it in XLA, with
no Pallas kernel): a dense int32 index grid of the active voxels' slots
(one scatter), each output voxel's k^3 input slots read from it, and one
product ``[V, k^3 * Cin] x [k^3 * Cin, Cout]`` per convolution, in f32.

Voxel sets: feat [B, V, C], coords [B, V, 3] (z, y, x), mask [B, V].

The neighbour gather's backward sums each voxel's gradients in the order
of the gathered rows (:func:`gather_rows`), so a training step repeats bit
for bit on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .voxelize import grid_compact, segment_sum


def _flat(coords, dhw):
    D, H, W = dhw
    c = coords.long()
    return (c[..., 0] * H + c[..., 1]) * W + c[..., 2]


def build_index_grid(coords_zyx: torch.Tensor, mask: torch.Tensor,
                     grid_dhw: tuple) -> torch.Tensor:
    """[B, V] voxel slots scattered into a dense [B, D*H*W] int32 grid, -1
    where empty; a cell that two slots claim keeps the later slot (the last
    writer, as the JAX package's scatter leaves it)."""
    n = int(np.prod(grid_dhw))
    B, V = mask.shape
    ids = torch.where(mask, _flat(coords_zyx, grid_dhw), n)
    slots = torch.arange(V, dtype=torch.int32,
                         device=mask.device).expand(B, V)
    grid = torch.full((B, n + 1), -1, dtype=torch.int32, device=mask.device)
    return grid.scatter_reduce_(1, ids, slots, 'amax')[:, :n]


def _taps(k: int, pad) -> torch.Tensor:
    """[k^3, 3] (z, y, x) tap offsets less the padding, z slowest."""
    offs = np.stack(np.meshgrid(np.arange(k), np.arange(k), np.arange(k),
                                indexing='ij'), -1).reshape(-1, 3)
    return torch.from_numpy((offs - np.asarray(pad)).astype(np.int64))


def neighbor_slots(index_grid: torch.Tensor, coords: torch.Tensor,
                   mask: torch.Tensor, grid_dhw: tuple, kernel: int,
                   stride, pad) -> torch.Tensor:
    """[B, V, k^3] input slot of each tap of each output voxel (output
    coords ``coords``: taps read input cells ``stride * out + offset -
    pad``), -1 where the cell is outside the grid or empty, or the output
    voxel is not active."""
    D, H, W = grid_dhw
    dev = coords.device
    st = torch.as_tensor(np.broadcast_to(np.asarray(stride), (3,)).copy(),
                         device=dev)
    base = (coords.long()[:, :, None, :] * st
            + _taps(kernel, pad).to(dev)[None, None])
    inb = ((base >= 0) & (base < torch.tensor([D, H, W], device=dev))).all(-1)
    flat = _flat(base, grid_dhw).clamp(0, D * H * W - 1)
    B, V, K = flat.shape
    nb = torch.gather(index_grid, 1, flat.reshape(B, V * K)).reshape(B, V, K)
    return torch.where(inb & mask[..., None], nb, -1)


def gather_neighbors(index_grid: torch.Tensor, coords_zyx: torch.Tensor,
                     mask: torch.Tensor, grid_dhw: tuple, kernel: int = 3,
                     stride: int = 1) -> torch.Tensor:
    """For each output voxel, the input slot of each kernel tap ([B, V,
    k^3], -1 where absent). With ``stride`` > 1, ``coords_zyx`` are output
    coords and the taps sample input cells ``stride * out + offset -
    k // 2``."""
    return neighbor_slots(index_grid, coords_zyx, mask, grid_dhw, kernel,
                          stride, kernel // 2)


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, feat, idx):
        B, V, C = feat.shape
        ctx.save_for_backward(idx)
        ctx.rows = V
        safe = idx.clamp(0, V - 1).long()[..., None].expand(-1, -1, C)
        return torch.where(idx[..., None] >= 0, torch.gather(feat, 1, safe),
                           0.0)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        V = ctx.rows
        return segment_sum(g, torch.where(idx >= 0, idx.long(), V), V), None


def gather_rows(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feat [B, V, C] at idx [B, N] → [B, N, C], 0 where idx < 0. Its
    backward sums each row's gradients in index order
    (``voxelize.segment_sum``), where ``torch.gather``'s, a
    ``scatter_add_``, sums with float atomics on the card in an order that
    changes from run to run."""
    return _GatherRows.apply(feat, idx)


def sparse_conv3d_apply(feat: torch.Tensor, neighbors: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """feat [B, V, Cin], neighbors [B, Vout, K], weights [K, Cin, Cout] →
    [B, Vout, Cout]; absent taps contribute 0."""
    B, V, Cin = feat.shape
    _, Vout, K = neighbors.shape
    g = gather_rows(feat, neighbors.reshape(B, Vout * K))
    return g.reshape(B, Vout, K * Cin) @ weights.reshape(K * Cin, -1)


def downsample_coords_3d(coords_zyx: torch.Tensor, mask: torch.Tensor,
                         grid_dhw: tuple, stride, padding, kernel: int,
                         max_out: int):
    """Active output set of SparseConv3d(kernel, stride, padding): every
    output cell whose field touches an active input, deduplicated by
    :func:`grid_compact` (slots ascending with the cell id, capped at
    ``max_out``); ``stride`` and ``padding`` ints or (z, y, x). Returns
    (coords [B, max_out, 3] int32, mask [B, max_out], output (D, H, W))."""
    st = np.broadcast_to(np.asarray(stride), (3,))
    pd = np.broadcast_to(np.asarray(padding), (3,))
    out_dhw = tuple(int(v) for v in
                    (np.asarray(grid_dhw) + 2 * pd - kernel) // st + 1)
    cands = []
    for axis in range(3):
        c = coords_zyx[..., axis].long()
        s, p = int(st[axis]), int(pd[axis])
        lo = -torch.div(-(c + p - kernel + 1), s, rounding_mode='floor')
        hi = torch.div(c + p, s, rounding_mode='floor')
        n_c = int(np.ceil(kernel / s))
        idx = lo[..., None] + torch.arange(n_c, device=c.device)
        ok = (idx <= hi[..., None]) & (idx >= 0) & (idx < out_dhw[axis])
        cands.append((idx, ok))
    (iz, okz), (iy, oky), (ix, okx) = cands
    nz, ny, nx = iz.shape[-1], iy.shape[-1], ix.shape[-1]
    # every (z, y, x) candidate, z slowest
    expand = lambda a, rep_in, tile: a.repeat_interleave(rep_in, -1).repeat(
        1, 1, tile)
    z, y, x = (expand(iz, ny * nx, 1), expand(iy, nx, nz),
               expand(ix, 1, nz * ny))
    ok = (expand(okz, ny * nx, 1) & expand(oky, nx, nz)
          & expand(okx, 1, nz * ny) & mask[..., None])
    Do, Ho, Wo = out_dhw
    sent = Do * Ho * Wo
    ids = torch.where(ok, (z * Ho + y) * Wo + x, sent)
    slot_cell, _, _ = grid_compact(ids.reshape(ids.shape[0], -1), sent,
                                   max_out)
    new_mask = slot_cell < sent
    zero = torch.zeros_like(slot_cell)
    coords = torch.stack([
        torch.where(new_mask, slot_cell // (Ho * Wo), zero),
        torch.where(new_mask, (slot_cell // Wo) % Ho, zero),
        torch.where(new_mask, slot_cell % Wo, zero)], -1).to(torch.int32)
    return coords, new_mask, out_dhw
