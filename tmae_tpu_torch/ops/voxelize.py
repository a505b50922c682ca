"""Pillarization and segment reductions (counterpart of
``tmae_tpu/ops/voxelize.py``).

Conventions:
  * points ``[B, P, C]`` float, channels ``[x, y, z, feat...]``;
    ``point_mask [B, P]``.
  * voxels ``[B, V, ...]`` with ``voxel_mask [B, V]``, ordered by linear
    pillar id (row-major ``y * nx + x``).
  * ``point_voxel [B, P]`` maps each point to its voxel slot, or ``V`` (the
    out-of-range slot) for invalid or overflow points.

``voxelize_host`` is a numpy copy of the JAX package's host voxelizer: the
serving path voxelizes on the host and ships the slot map, the per-pillar
mean and the segment ends with the batch. ``voxelize`` is the same
assignment on the device in torch ops without a host sync, for configs that
do not set RUNTIME.HOST_VOXELIZE.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .sorted_segments import segmented_running_max, sorted_segment_max_bwd


@dataclasses.dataclass(frozen=True)
class VoxelSpec:
    """Static description of the pillar grid; ``grid_size = (nx, ny, nz)``
    from range and voxel size."""

    pc_range: tuple  # (x0, y0, z0, x1, y1, z1)
    voxel_size: tuple  # (vx, vy, vz)
    max_points: int
    max_voxels: int

    @property
    def grid_size(self):
        rng = np.asarray(self.pc_range, np.float64)
        vs = np.asarray(self.voxel_size, np.float64)
        return tuple(
            np.round((rng[3:6] - rng[0:3]) / vs).astype(np.int64).tolist())


def voxelize_host(points: np.ndarray, point_mask: np.ndarray,
                  spec: VoxelSpec, sort_points: bool = False) -> dict:
    """Assign points to pillars on the host (numpy). Slots ascend with the
    cell id and stop at ``max_voxels``.

    Returns ``voxel_coords [B, V, 2]`` (y, x), ``voxel_mask [B, V]``,
    ``point_voxel [B, P]`` (slot or V), ``point_valid [B, P]`` and
    ``num_voxels [B]``. ``sort_points=True`` also reorders each frame's
    points by slot (a permutation of the padded point set) and adds
    ``points``/``point_mask`` (the permuted arrays), ``voxel_mean_xyz
    [B, V, 3]`` (per-pillar mean xyz) and ``seg_ends [B, V]`` (index of each
    pillar's last point in the sorted order; 0 for empty pillars).
    """
    B, P, _ = points.shape
    V = spec.max_voxels
    nx, ny, _ = spec.grid_size
    rng = np.asarray(spec.pc_range, points.dtype)
    vs = np.asarray(spec.voxel_size, points.dtype)
    grid = np.asarray([nx, ny, spec.grid_size[2]], np.int64)
    coords = np.floor((points[..., :3] - rng[0:3]) / vs).astype(np.int64)
    in_range = np.all((coords >= 0) & (coords < grid), axis=-1)
    valid = in_range & point_mask
    sentinel = nx * ny
    ids = np.where(valid, coords[..., 1] * nx + coords[..., 0], sentinel)

    voxel_coords = np.zeros((B, V, 2), np.int32)
    voxel_mask = np.zeros((B, V), bool)
    point_slot = np.full((B, P), V, np.int32)
    point_valid = np.zeros((B, P), bool)
    counts = np.zeros((B,), np.int32)
    for b in range(B):
        occ = np.zeros(sentinel + 1, bool)
        occ[ids[b]] = True
        occ = occ[:sentinel]
        prefix = np.cumsum(occ)
        n = int(min(prefix[-1], V))
        slot_of = prefix - 1
        cells = np.nonzero(occ)[0][:V]
        voxel_coords[b, :n, 0] = cells // nx
        voxel_coords[b, :n, 1] = cells % nx
        voxel_mask[b, :n] = True
        safe = np.minimum(ids[b], sentinel - 1)
        ps = slot_of[safe]
        ok = valid[b] & (ps < V) & (ps >= 0)
        point_slot[b] = np.where(ok, ps, V).astype(np.int32)
        point_valid[b] = ok
        counts[b] = n
    out = {
        'voxel_coords': voxel_coords,
        'voxel_mask': voxel_mask,
        'point_voxel': point_slot,
        'point_valid': point_valid,
        'num_voxels': counts,
    }
    if sort_points:
        sorted_pts = np.zeros_like(points)
        sorted_mask = np.zeros_like(point_mask)
        mean_xyz = np.zeros((B, V, 3), np.float32)
        seg_ends = np.zeros((B, V), np.int32)
        for b in range(B):
            order = np.argsort(point_slot[b], kind='stable')
            sorted_pts[b] = points[b][order]
            sorted_mask[b] = point_mask[b][order]
            point_slot[b] = point_slot[b][order]
            point_valid[b] = point_valid[b][order]
            nv = int(point_valid[b].sum())  # valid points sort first
            if nv:
                seg = point_slot[b][:nv]
                starts = np.flatnonzero(
                    np.concatenate([[True], seg[1:] != seg[:-1]]))
                cnt = np.diff(np.append(starts, nv))
                sums = np.add.reduceat(
                    sorted_pts[b][:nv, :3].astype(np.float64), starts, axis=0)
                nseg = len(starts)
                mean_xyz[b, :nseg] = (sums / cnt[:, None]).astype(np.float32)
                seg_ends[b, :nseg] = (starts + cnt - 1).astype(np.int32)
        out['points'] = sorted_pts
        out['point_mask'] = sorted_mask
        out['voxel_mean_xyz'] = mean_xyz
        out['seg_ends'] = seg_ends
    return out


def grid_compact(ids: torch.Tensor, num_cells: int, num_out: int):
    """Sort-free 'unique' of cell ids [B, N] (``num_cells`` for invalid
    entries; counterpart of ``_grid_compact``): an occupancy of the cells,
    its prefix sum as each occupied cell's slot, slots ascending with the
    cell id and stopping at ``num_out``. Returns (each slot's cell id
    [B, num_out], ``num_cells`` past the count; each entry's slot [B, N],
    ``num_out`` where invalid or over the cap; the count [B])."""
    B = ids.shape[0]
    dev = ids.device
    occ = torch.zeros(B, num_cells + 1, dtype=torch.int32, device=dev)
    occ = occ.scatter_(1, ids, 1)[:, :num_cells]
    slot_of_cell = occ.cumsum(1, dtype=torch.int64) - 1
    dest = torch.where((occ == 1) & (slot_of_cell < num_out), slot_of_cell,
                       num_out)
    cell_ids = torch.arange(num_cells, device=dev).expand(B, num_cells)
    slot_cell = torch.full((B, num_out + 1), num_cells, dtype=torch.int64,
                           device=dev)
    slot_cell = slot_cell.scatter_(1, dest, cell_ids)[:, :num_out]
    slot = torch.gather(slot_of_cell, 1, ids.clamp(max=num_cells - 1))
    ok = (ids < num_cells) & (slot < num_out) & (slot >= 0)
    count = slot_of_cell[:, -1].add(1).clamp(max=num_out)
    return slot_cell, torch.where(ok, slot, num_out), count


def voxelize(points: torch.Tensor, point_mask: torch.Tensor,
             spec: VoxelSpec) -> dict:
    """Assign points to pillars on the device (counterpart of ``voxelize``:
    ``point_coords`` and :func:`grid_compact`), without a host sync.
    Returns the dict of :func:`voxelize_host` (``sort_points=False``) as
    tensors."""
    V = spec.max_voxels
    nx, ny, nz = spec.grid_size
    dev = points.device
    rng = torch.tensor(spec.pc_range, dtype=points.dtype, device=dev)
    vs = torch.tensor(spec.voxel_size, dtype=points.dtype, device=dev)
    grid = torch.tensor((nx, ny, nz), dtype=torch.int32, device=dev)
    coords = torch.floor((points[..., :3] - rng[:3]) / vs).to(torch.int32)
    valid = ((coords >= 0) & (coords < grid)).all(-1) & point_mask
    cells = nx * ny
    ids = torch.where(valid, coords[..., 1].long() * nx + coords[..., 0],
                      cells)
    slot_cell, point_slot, count = grid_compact(ids, cells, V)
    voxel_mask = slot_cell < cells
    zero = torch.zeros_like(slot_cell)
    return {
        'voxel_coords': torch.stack(
            [torch.where(voxel_mask, slot_cell // nx, zero),
             torch.where(voxel_mask, slot_cell % nx, zero)],
            -1).to(torch.int32),
        'voxel_mask': voxel_mask,
        'point_voxel': point_slot.to(torch.int32),
        'point_valid': point_slot < V,
        'num_voxels': count.to(torch.int32),
    }


def downsample_coords(coords_yx: torch.Tensor, mask: torch.Tensor,
                      grid_hw: tuple, max_out: int):
    """Active output set of a stride-2, k=3, p=1 sparse conv: every output
    cell whose 3x3 field touches an active input (input row y reaches
    output rows y // 2 and (y + 1) // 2, and so for x), deduplicated by
    :func:`grid_compact`, slots ascending with the cell id. Returns
    (coords [B, max_out, 2] int32, mask [B, max_out])."""
    H, W = grid_hw
    Ho, Wo = (H + 1) // 2, (W + 1) // 2
    y, x = coords_yx[..., 0].long(), coords_yx[..., 1].long()
    cy = torch.stack([y // 2, (y + 1) // 2], -1)
    cx = torch.stack([x // 2, (x + 1) // 2], -1)
    yy = cy.repeat_interleave(2, -1).clamp(0, Ho - 1)  # y0 y0 y1 y1
    xx = cx.repeat(1, 1, 2).clamp(0, Wo - 1)           # x0 x1 x0 x1
    cells = Ho * Wo
    ids = torch.where(mask[..., None], yy * Wo + xx, cells)
    slot_cell, _, _ = grid_compact(ids.reshape(ids.shape[0], -1), cells,
                                   max_out)
    new_mask = slot_cell < cells
    zero = torch.zeros_like(slot_cell)
    return torch.stack([torch.where(new_mask, slot_cell // Wo, zero),
                        torch.where(new_mask, slot_cell % Wo, zero)],
                       -1).to(torch.int32), new_mask


def segment_sum(feat: torch.Tensor, seg: torch.Tensor, num_segments: int):
    """feat [B, P, C], seg [B, P] (segment, or >= num_segments to drop) →
    [B, num_segments, C]."""
    B, P, C = feat.shape
    idx = seg.long().clamp(max=num_segments)[..., None].expand(B, P, C)
    acc = feat.new_zeros(B, num_segments + 1, C).scatter_add_(1, idx, feat)
    return acc[:, :num_segments]


def segment_mean(feat, seg, num_segments, valid=None):
    """Per-segment mean; ``valid`` [B, P] excludes rows."""
    if valid is not None:
        feat = torch.where(valid[..., None], feat, 0.0)
        ones = valid.to(feat.dtype)
    else:
        ones = torch.ones(seg.shape, dtype=feat.dtype, device=feat.device)
    acc = segment_sum(torch.cat([feat, ones[..., None]], -1), seg,
                      num_segments)
    return acc[..., :-1] / acc[..., -1:].clamp(min=1.0)


def segment_max(feat: torch.Tensor, seg: torch.Tensor, num_segments: int):
    """Batched segment max over unsorted rows, 0 for empty segments and for
    segments whose rows are all ``-inf``. Rows with segment >= num_segments
    are dropped. Sorts the rows by segment, then runs the segmented scan of
    the sorted path (``sorted_segments.segmented_running_max``). Its
    gradient is split evenly among the rows that reach their segment's max,
    as ``jax.ops.segment_max``'s is (autograd through the scan's pairwise
    maxima would split a three-way tie 1/2, 1/4, 1/4)."""
    return _SegmentMax.apply(feat, seg, num_segments)


class _SegmentMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, seg, num_segments):
        out = _segment_max(feat, seg, num_segments)
        ctx.num_segments = num_segments
        ctx.save_for_backward(feat, seg, out)
        return out

    @staticmethod
    def backward(ctx, g):
        feat, seg, out = ctx.saved_tensors
        V = ctx.num_segments
        present = torch.ones(out.shape[:2], dtype=torch.bool,
                             device=out.device)
        return (sorted_segment_max_bwd(feat, seg, present, out, g, V), None,
                None)


def _segment_max(feat: torch.Tensor, seg: torch.Tensor, num_segments: int):
    B, P, C = feat.shape
    seg = seg.long().clamp(max=num_segments)
    order = torch.argsort(seg, dim=1, stable=True)
    s = torch.gather(seg, 1, order)
    f = torch.gather(feat, 1, order[..., None].expand(B, P, C))
    run = segmented_running_max(f, s)
    ids = torch.arange(num_segments, device=feat.device).expand(B, -1)
    ends = torch.searchsorted(s, ids.contiguous(), right=True) - 1
    safe = ends.clamp(min=0)
    present = (ends >= 0) & (torch.gather(s, 1, safe) == ids)
    out = torch.gather(run, 1, safe[..., None].expand(B, num_segments, C))
    big_neg = torch.finfo(feat.dtype).min
    return torch.where(present[..., None] & (out > big_neg / 2), out, 0.0)


def scatter_to_grid(feat: torch.Tensor, coords_yx: torch.Tensor,
                    mask: torch.Tensor, grid_hw: tuple):
    """Voxel list → dense BEV grid: feat [B, V, C] → [B, H, W, C]."""
    H, W = grid_hw
    B, V, C = feat.shape
    flat = torch.where(mask, coords_yx[..., 0].long() * W
                       + coords_yx[..., 1].long(), H * W)
    src = torch.where(mask[..., None], feat, 0.0)
    out = feat.new_zeros(B, H * W + 1, C)
    out.scatter_(1, flat[..., None].expand(B, V, C), src)
    return out[:, :H * W].reshape(B, H, W, C)


def gather_from_grid(grid: torch.Tensor, coords_yx: torch.Tensor,
                     mask: torch.Tensor):
    """Dense BEV grid [B, H, W, C] → voxel list [B, V, C] at coords."""
    B, H, W, C = grid.shape
    y = coords_yx[..., 0].long().clamp(0, H - 1)
    x = coords_yx[..., 1].long().clamp(0, W - 1)
    flat = (y * W + x)[..., None].expand(-1, -1, C)
    out = torch.gather(grid.reshape(B, H * W, C), 1, flat)
    return torch.where(mask[..., None], out, 0.0)


def occupancy_grid(coords_yx, mask, grid_hw):
    """[B, V] voxel list → [B, H, W] bool occupancy."""
    ones = torch.ones(mask.shape + (1,), dtype=torch.float32,
                      device=mask.device)
    return scatter_to_grid(ones, coords_yx, mask, grid_hw)[..., 0] > 0
