"""Occupied-window compaction for the dense SST/WCA path: the window plans,
the padded carrier, and kernels K1 (gather) and K2 (scatter) with their
plain versions (counterpart of ``tmae_tpu/ops/occ_compact.py``).

Beside the padded-carrier API, the unpadded window API of the JAX package
(``gather_windows``, ``scatter_windows``, ``scatter_windows_into`` on
``[B, H, W, C]`` grids, with their custom VJPs) runs on the card as
``pad_grid``, K1 or K2, then the crop. K2 serves the JAX package's
``_scatter_pallas`` (K13b, into a zero carrier) and ``_scatter_into_pallas``
(K13c, into ``pad_grid(init)``): both are K2's function on another carrier.

Most 8x8 BEV windows of a LiDAR frame are empty. A plan names the occupied
windows of each sample, classed by occupied-cell count into a small (S=16),
a mid (S=48) and a full (T=64) bucket. The serving layer gathers all planned
windows out of the padded carrier ``[B, Hp + w, Wp, C]`` in one call, runs
the bucket kernels on row ranges of that window tensor, and scatters it back
in place. Padding slots of a plan name the dummy window ``(nwy, 0)``, one
window row below the padded grid: the gather gives zeros for them and the
scatter skips them, so they never touch the real grid.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..device import on_card
from ..utils.build import CudaKernel, I, P, stream_handle
from .dense_windows import window_geometry, window_unview, window_view

K1 = CudaKernel('windows.cu', 'launch_gather_windows',
                [P, P, P, I, I, I, I, I, I, P])
K2 = CudaKernel('windows.cu', 'launch_scatter_windows',
                [P, P, P, I, I, I, I, I, I, P])


def round_cap(cap: int, mult: int = 16) -> int:
    return ((int(cap) + mult - 1) // mult) * mult


def window_cell_counts(occ: torch.Tensor, window: int, shift: bool):
    """Per-window occupied-cell counts [B, nwy, nwx] int32."""
    B, H, W = occ.shape
    nwy, nwx, _, _ = window_geometry((H, W), window)
    cnt = window_view(occ[..., None].to(torch.int32), window, shift)
    return cnt[..., 0].sum(-1, dtype=torch.int32).reshape(B, nwy, nwx)


def _indices_from_mask(pool: torch.Tensor, cap: int):
    """Window coords of the True windows of a [B, nwy, nwx] mask in raster
    order (prefix-sum compaction). Returns (idx [B, cap, 2] int32 (wy, wx),
    valid [B, cap] bool, n_true [B] int32, which may exceed cap). Padding
    slots name the dummy window (nwy, 0)."""
    B, nwy, nwx = pool.shape
    NW = nwy * nwx
    flat = pool.reshape(B, NW).to(torch.int64)
    nocc = flat.sum(1)
    dev = pool.device
    valid = torch.arange(cap, device=dev)[None, :] < nocc[:, None]
    slot_of = flat.cumsum(1) - 1
    dest = torch.where((flat > 0) & (slot_of < cap), slot_of, cap)
    ids = torch.arange(NW, device=dev).expand(B, NW)
    slot = torch.full((B, cap + 1), NW, dtype=torch.int64, device=dev)
    slot = slot.scatter(1, dest, ids)[:, :cap]
    idx = torch.stack([slot // nwx, slot % nwx], -1).to(torch.int32)
    return idx, valid, nocc.to(torch.int32)


def occupied_window_indices(occ: torch.Tensor, window: int, shift: bool,
                            cap: int):
    """Occupied windows of each sample, raster order (see
    ``_indices_from_mask``)."""
    return _indices_from_mask(window_cell_counts(occ, window, shift) > 0, cap)


def _window_occ_view(occ: torch.Tensor, window: int, shift: bool):
    """Windowed occupancy [B, NW + 1, T] f32 0/1 with a trailing all-zero
    dummy window."""
    ow = window_view(occ[..., None].float(), window, shift)[..., 0]
    return torch.cat([ow, torch.zeros_like(ow[:, :1])], 1)


def _flat_window(idx: torch.Tensor, nwx: int, NW: int):
    return torch.clamp(idx[..., 0].long() * nwx + idx[..., 1].long(), max=NW)


def _gather_occ_rows(ow: torch.Tensor, idx, nwx: int):
    """Rows of a windowed occupancy for the planned windows: [B, cap, T]."""
    flat = _flat_window(idx, nwx, ow.shape[1] - 1)
    return torch.gather(ow, 1, flat[..., None].expand(-1, -1, ow.shape[2]))


def gather_window_occ(occ: torch.Tensor, idx, grid_hw, window: int,
                      shift: bool) -> torch.Tensor:
    """Per-slot occupancy [B, cap, w*w] (f32 0/1) of the planned windows;
    dummy slots give zeros."""
    _, nwx, _, _ = window_geometry(grid_hw, window)
    return _gather_occ_rows(_window_occ_view(occ, window, shift), idx, nwx)


def _cell_selection(ow, idx, nwx: int, tokens: int):
    """In-window cell ids, occupied cells first, each group in ascending
    order, and their occupancy: ([B, cap, S] int32, [B, cap, S] f32). The
    order is that of a stable descending sort on occupancy, which is what
    ``lax.top_k`` gives the JAX package."""
    m = _gather_occ_rows(ow, idx, nwx)
    occ = m > 0
    n_occ = occ.sum(-1, keepdim=True)
    rank = torch.where(occ, occ.cumsum(-1) - 1, n_occ + (~occ).cumsum(-1) - 1)
    T = m.shape[-1]
    cells = torch.arange(T, device=m.device).expand_as(rank)
    sel = torch.empty_like(rank).scatter_(-1, rank, cells)[..., :tokens]
    return sel.to(torch.int32), torch.gather(m, -1, sel)


@dataclasses.dataclass
class CompactInfo:
    """Full-bucket plan: window coords, slot validity, masks."""

    idx: torch.Tensor          # [B, cap, 2] int32
    valid: torch.Tensor        # [B, cap] bool
    qmask: torch.Tensor        # [B, cap, T] f32
    kmask: torch.Tensor | None = None  # [B, cap, T] f32 (cross only)
    n_occupied: torch.Tensor | None = None  # [B] true count

    def overflow(self) -> torch.Tensor:
        return (self.n_occupied - self.idx.shape[1]).clamp(min=0)


def build_compact_info(occ, window: int, shift: bool, cap: int, grid_hw,
                       kv_occ=None) -> CompactInfo:
    """One plan of every occupied window (up to ``cap``) of the shift's
    partition, with the query (and, given ``kv_occ``, key) masks."""
    idx, valid, nocc = occupied_window_indices(occ, window, shift, cap)
    qmask = gather_window_occ(occ, idx, grid_hw, window, shift)
    kmask = (gather_window_occ(kv_occ, idx, grid_hw, window, shift)
             if kv_occ is not None else None)
    return CompactInfo(idx, valid, qmask, kmask, nocc)


@dataclasses.dataclass
class SmallCompactInfo:
    """Packed-bucket plan: window coords plus each window's selected cells."""

    idx: torch.Tensor          # [B, cap, 2] int32
    valid: torch.Tensor        # [B, cap] bool
    sel: torch.Tensor          # [B, cap, S] int32 (query side)
    qmask: torch.Tensor        # [B, cap, S] f32
    ksel: torch.Tensor | None = None   # [B, cap, S] int32 (cross only)
    kmask: torch.Tensor | None = None  # [B, cap, S] f32 (cross only)
    n_windows: torch.Tensor | None = None  # [B] true count

    def overflow(self) -> torch.Tensor:
        return (self.n_windows - self.idx.shape[1]).clamp(min=0)


@dataclasses.dataclass
class BucketedCompact:
    """Per-(stage, shift) plan; ``cat_idx`` concatenates the buckets' window
    coords in (small, mid, full) order for the one gather and one scatter of
    a serving layer."""

    small: SmallCompactInfo
    full: CompactInfo
    mid: SmallCompactInfo | None = None
    cat_idx: torch.Tensor | None = None  # [B, cap_s + cap_m + cap_f, 2]

    def overflow(self) -> torch.Tensor:
        parts = [b.overflow() for b in (self.small, self.mid, self.full)
                 if b is not None]
        return sum(parts[1:], parts[0])


def _packed_bucket(mask, ow_q, ow_kv, cap, tokens, nwx):
    idx, valid, n = _indices_from_mask(mask, round_cap(cap))
    sel, qm = _cell_selection(ow_q, idx, nwx, tokens)
    ksel = kmask = None
    if ow_kv is not None:
        ksel, kmask = _cell_selection(ow_kv, idx, nwx, tokens)
    return SmallCompactInfo(idx, valid, sel, qm, ksel, kmask, n)


def build_bucketed_compact_info(occ, window, shift, small_cap, full_cap,
                                grid_hw, kv_occ=None,
                                small_tokens: int = 16, mid_cap: int = 0,
                                mid_tokens: int = 48) -> BucketedCompact:
    """Class occupied windows by cell count, on both frames when cross so no
    cell is dropped: <= small_tokens → small bucket; <= mid_tokens (when
    mid_cap > 0) → mid bucket; else the full T = window² bucket."""
    H, W = grid_hw
    _, nwx, _, _ = window_geometry((H, W), window)
    B = occ.shape[0]
    ow_q = _window_occ_view(occ, window, shift)
    ow_kv = (_window_occ_view(kv_occ, window, shift)
             if kv_occ is not None else None)
    cnt_q = ow_q[:, :-1].sum(-1).to(torch.int32).reshape(B, -1, nwx)
    occupied = cnt_q > 0
    n_eff = cnt_q
    if ow_kv is not None:
        cnt_kv = ow_kv[:, :-1].sum(-1).to(torch.int32).reshape(B, -1, nwx)
        n_eff = torch.maximum(cnt_q, cnt_kv)
    small_m = occupied & (n_eff <= small_tokens)
    small = _packed_bucket(small_m, ow_q, ow_kv, small_cap, small_tokens, nwx)
    mid = None
    rest = occupied & ~small_m
    if mid_cap > 0:
        mid_m = rest & (n_eff <= mid_tokens)
        mid = _packed_bucket(mid_m, ow_q, ow_kv, mid_cap, mid_tokens, nwx)
        rest = rest & ~mid_m
    idx_f, valid_f, n_f = _indices_from_mask(rest, round_cap(full_cap))
    qmask_f = _gather_occ_rows(ow_q, idx_f, nwx)
    kmask_f = (_gather_occ_rows(ow_kv, idx_f, nwx)
               if ow_kv is not None else None)
    full = CompactInfo(idx_f, valid_f, qmask_f, kmask_f, n_f)
    cat_idx = torch.cat([b.idx for b in (small, mid, full) if b is not None],
                        dim=1)
    return BucketedCompact(small=small, full=full, mid=mid, cat_idx=cat_idx)


# ---------------------------------------------------------------------------
# Padded carrier
# ---------------------------------------------------------------------------


def pad_grid(xg: torch.Tensor, window: int, shift: bool):
    """[B, H, W, C] → [B, Hp + w, Wp, C]: the shift's top-left offset and one
    extra window row at the bottom (the dummy-slot target)."""
    B, H, W, C = xg.shape
    _, _, Hp, Wp = window_geometry((H, W), window)
    off = window // 2 if shift else window
    return F.pad(xg, (0, 0, off, Wp - W - off, off, Hp + window - H - off))


def unpad_grid(xp: torch.Tensor, grid_hw, window: int, shift: bool):
    H, W = grid_hw
    off = window // 2 if shift else window
    return xp[:, off:off + H, off:off + W, :]


def repad_grid(xp: torch.Tensor, window: int, from_shift: bool,
               to_shift: bool):
    """Move a padded carrier between shift geometries in one copy: the
    content offset moves by ±w/2 and the freed border is zero."""
    if from_shift == to_shift:
        return xp
    off_f = window // 2 if from_shift else window
    off_t = window // 2 if to_shift else window
    d = off_t - off_f
    return F.pad(xp, (0, 0, d, -d, d, -d))


# ---------------------------------------------------------------------------
# K1 / K2: window gather and scatter against the padded carrier
# ---------------------------------------------------------------------------


def _carrier_geometry(xp: torch.Tensor, window: int):
    B, Hp2, Wp, C = xp.shape
    return Wp // window, (Hp2 - window) // window


def _window_rows(xp: torch.Tensor, window: int):
    """Padded carrier → its windows [B, nwy * nwx, w*w, C] (a copy)."""
    B, Hp2, Wp, C = xp.shape
    nwx, nwy = _carrier_geometry(xp, window)
    xw = xp[:, :nwy * window].reshape(B, nwy, window, nwx, window, C)
    return xw.permute(0, 1, 3, 2, 4, 5).reshape(B, nwy * nwx,
                                                window * window, C)


def gather_windows_padded_plain(xp, idx, window: int):
    """Plain version of :func:`gather_windows_padded`."""
    B, _, _, C = xp.shape
    nwx, nwy = _carrier_geometry(xp, window)
    xw = _window_rows(xp, window)
    xw = torch.cat([xw, torch.zeros_like(xw[:, :1])], 1)
    flat = _flat_window(idx, nwx, nwy * nwx)
    T = window * window
    return torch.gather(xw, 1, flat[..., None, None].expand(-1, -1, T, C))


def scatter_windows_into_padded_plain(xw, idx, xp, window: int):
    """Plain version of :func:`scatter_windows_into_padded`."""
    B, _, Wp, C = xp.shape
    nwx, nwy = _carrier_geometry(xp, window)
    NW = nwy * nwx
    T = window * window
    buf = _window_rows(xp, window).to(xw.dtype)
    buf = torch.cat([buf, torch.zeros_like(buf[:, :1])], 1)
    flat = _flat_window(idx, nwx, NW)
    buf.scatter_(1, flat[..., None, None].expand(-1, -1, T, C), xw)
    full = buf[:, :NW].reshape(B, nwy, nwx, window, window, C)
    full = full.permute(0, 1, 3, 2, 4, 5).reshape(B, nwy * window, Wp, C)
    xp[:, :nwy * window] = full
    return xp


def _check_windows(xp, idx, window, C):
    """The kernels copy 16-byte vectors of 8x8 windows."""
    if xp.dtype != torch.bfloat16 or not xp.is_contiguous():
        raise ValueError('window kernels take a contiguous bf16 carrier')
    if xp.data_ptr() % 16:
        raise ValueError('window kernels take a 16-byte aligned carrier')
    if idx.dtype != torch.int32 or idx.shape[-1] != 2 or \
            idx.shape[0] != xp.shape[0]:
        raise ValueError('window plan must be int32 [B, cap, 2]')
    if C % 8 or window != 8:
        raise ValueError('window kernels take 8x8 windows and C % 8 == 0')


def gather_windows_padded(xp: torch.Tensor, idx: torch.Tensor,
                          window: int) -> torch.Tensor:
    """Copy the windows named by ``idx`` [B, cap, 2] out of the padded
    carrier ``xp`` [B, Hp + w, Wp, C] into [B, cap, w*w, C]; dummy slots give
    zeros. Kernel K1 on the card."""
    if not on_card(xp, idx):
        return gather_windows_padded_plain(xp, idx, window)
    B, Hp2, Wp, C = xp.shape
    _check_windows(xp, idx, window, C)
    idx = idx.contiguous()
    cap = idx.shape[1]
    out = torch.empty(B, cap, window * window, C, dtype=xp.dtype,
                      device=xp.device)
    _, nwy = _carrier_geometry(xp, window)
    K1(xp.data_ptr(), idx.data_ptr(), out.data_ptr(), B, Hp2, Wp, C, cap,
       nwy, stream_handle())
    return out


def scatter_windows_into_padded(xw: torch.Tensor, idx: torch.Tensor,
                                xp: torch.Tensor, window: int) -> torch.Tensor:
    """Write the windows ``xw`` [B, cap, w*w, C] back into the padded carrier
    ``xp`` IN PLACE at the windows named by ``idx`` and return ``xp``.
    Windows not in the plan keep their content; dummy slots are skipped.
    Kernel K2 on the card."""
    if not on_card(xw, idx, xp):
        return scatter_windows_into_padded_plain(xw, idx, xp, window)
    B, Hp2, Wp, C = xp.shape
    _check_windows(xp, idx, window, C)
    if (xw.dtype != xp.dtype or not xw.is_contiguous() or xw.data_ptr() % 16
            or xw.shape != (B, idx.shape[1], window * window, C)):
        raise ValueError('scatter takes aligned contiguous windows '
                         '[B, cap, 64, C] of the carrier dtype')
    idx = idx.contiguous()
    _, nwy = _carrier_geometry(xp, window)
    K2(xw.data_ptr(), idx.data_ptr(), xp.data_ptr(), B, Hp2, Wp, C,
       idx.shape[1], nwy, stream_handle())
    return xp


# ---------------------------------------------------------------------------
# Training: differentiable gather and scatter (custom VJPs built from K1 / K2)
# ---------------------------------------------------------------------------


class _GatherWindows(torch.autograd.Function):
    """Forward K1; the VJP scatters g into a zero carrier (K2)."""

    @staticmethod
    def forward(ctx, xp, idx, window):
        ctx.window, ctx.shape = window, xp.shape
        ctx.save_for_backward(idx)
        return gather_windows_padded(xp, idx, window)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        zeros = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        return (scatter_windows_into_padded(g.contiguous(), idx, zeros,
                                            ctx.window), None, None)


class _ScatterWindows(torch.autograd.Function):
    """Forward K2 into a copy of the carrier; the VJP gathers g at the
    planned windows (K1) for the windows and scatters zeros into a copy of g
    there (K2) for the carrier.

    Out of place, unlike the serving scatter: under remat
    (``torch.utils.checkpoint``) the carrier that goes in is an input of the
    checkpointed block, and a block replayed in the backward must find it
    unchanged. An in-place scatter with ``ctx.mark_dirty`` would bump its
    version and make that replay, and any other saved use of the carrier,
    fail. The copy costs one carrier pass per layer."""

    @staticmethod
    def forward(ctx, xw, idx, init, window):
        ctx.window = window
        ctx.save_for_backward(idx)
        return scatter_windows_into_padded(xw.contiguous(), idx, init.clone(),
                                           window)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        g = g.contiguous()
        dxw = gather_windows_padded(g, idx, ctx.window)
        dinit = scatter_windows_into_padded(torch.zeros_like(dxw), idx,
                                            g.clone(), ctx.window)
        return dxw, None, dinit, None


def gather_windows_train(xp, idx, window: int):
    """Differentiable :func:`gather_windows_padded` (counterpart of the JAX
    package's ``gather_windows_padded`` custom VJP)."""
    return _GatherWindows.apply(xp, idx, window)


def scatter_windows_train(xw, idx, init, window: int):
    """Differentiable, out-of-place :func:`scatter_windows_into_padded`:
    returns a new carrier (counterpart of the JAX package's
    ``scatter_windows_into_padded`` custom VJP)."""
    return _ScatterWindows.apply(xw, idx, init, window)


# ---------------------------------------------------------------------------
# The unpadded window API: [B, H, W, C] grids in and out
# ---------------------------------------------------------------------------


class LaunchCount:
    """Launch count of an entry point that another kernel serves: the entry
    adds one where it launches that kernel."""

    def __init__(self):
        self.launches = 0


K13B = LaunchCount()   # scatter_windows: K2 into a zero carrier
K13C = LaunchCount()   # scatter_windows_into: K2 into pad_grid(init)


def gather_windows_plain(xg, idx, grid_hw, window: int, shift: bool):
    """Plain version of :func:`gather_windows` (``_gather_ref``)."""
    _, nwx, _, _ = window_geometry(grid_hw, window)
    xw = window_view(xg, window, shift)
    xw = torch.cat([xw, torch.zeros_like(xw[:, :1])], 1)
    flat = _flat_window(idx, nwx, xw.shape[1] - 1)
    T, C = xw.shape[2:]
    return torch.gather(xw, 1, flat[..., None, None].expand(-1, -1, T, C))


def scatter_windows_into_plain(xw, idx, init, grid_hw, window: int,
                               shift: bool):
    """Plain version of :func:`scatter_windows_into`
    (``_scatter_into_ref``)."""
    _, nwx, _, _ = window_geometry(grid_hw, window)
    buf = window_view(init.to(xw.dtype), window, shift)
    NW = buf.shape[1]
    buf = torch.cat([buf, torch.zeros_like(buf[:, :1])], 1)
    flat = _flat_window(idx, nwx, NW)
    T, C = xw.shape[2:]
    buf = buf.scatter(1, flat[..., None, None].expand(-1, -1, T, C), xw)
    return window_unview(buf[:, :NW], grid_hw, window, shift)


def scatter_windows_plain(xw, idx, grid_hw, window: int, shift: bool):
    """Plain version of :func:`scatter_windows` (``_scatter_ref``): zeros
    outside the planned windows."""
    B, _, _, C = xw.shape
    init = torch.zeros(B, *grid_hw, C, dtype=xw.dtype, device=xw.device)
    return scatter_windows_into_plain(xw, idx, init, grid_hw, window, shift)


def _gather(xg, idx, grid_hw, window, shift):
    if not on_card(xg, idx):
        return gather_windows_plain(xg, idx, grid_hw, window, shift)
    return gather_windows_padded(pad_grid(xg, window, shift).contiguous(),
                                 idx, window)


def _scatter_into(xw, idx, init, grid_hw, window, shift):
    if not on_card(xw, idx, init):
        return scatter_windows_into_plain(xw, idx, init, grid_hw, window,
                                          shift)
    xp = pad_grid(init.to(xw.dtype), window, shift).contiguous()
    xp = scatter_windows_into_padded(xw.contiguous(), idx, xp, window)
    K13C.launches += 1
    return unpad_grid(xp, grid_hw, window, shift)


def _scatter(xw, idx, grid_hw, window, shift):
    if not on_card(xw, idx):
        return scatter_windows_plain(xw, idx, grid_hw, window, shift)
    B, _, _, C = xw.shape
    _, _, Hp, Wp = window_geometry(grid_hw, window)
    xp = torch.zeros(B, Hp + window, Wp, C, dtype=xw.dtype, device=xw.device)
    xp = scatter_windows_into_padded(xw.contiguous(), idx, xp, window)
    K13B.launches += 1
    return unpad_grid(xp, grid_hw, window, shift)


class _GatherGrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xg, idx, grid_hw, window, shift):
        ctx.geom = (grid_hw, window, shift)
        ctx.save_for_backward(idx)
        return _gather(xg, idx, grid_hw, window, shift)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _scatter(g, idx, *ctx.geom), None, None, None, None


class _ScatterGrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xw, idx, grid_hw, window, shift):
        ctx.geom = (grid_hw, window, shift)
        ctx.save_for_backward(idx)
        return _scatter(xw, idx, grid_hw, window, shift)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _gather(g, idx, *ctx.geom), None, None, None, None


class _ScatterIntoGrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xw, idx, init, grid_hw, window, shift):
        ctx.geom = (grid_hw, window, shift)
        ctx.init_dtype = init.dtype
        ctx.save_for_backward(idx)
        return _scatter_into(xw, idx, init, grid_hw, window, shift)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        dxw = _gather(g, idx, *ctx.geom)
        # the visited windows were overwritten: their init gets no gradient
        dinit = _scatter_into(torch.zeros_like(dxw), idx, g, *ctx.geom)
        return dxw, None, dinit.to(ctx.init_dtype), None, None, None


def gather_windows(xg, idx, grid_hw, window: int, shift: bool):
    """The windows named by ``idx`` [B, cap, 2] of the shift's partition of
    ``xg`` [B, H, W, C]: [B, cap, w*w, C], zeros for dummy slots. Its VJP
    scatters the cotangent into zeros. K1 on the card."""
    return _GatherGrid.apply(xg, idx, tuple(grid_hw), window, shift)


def scatter_windows(xw, idx, grid_hw, window: int, shift: bool,
                    zero_fill: bool = False):
    """Inverse of :func:`gather_windows`: [B, cap, w*w, C] → [B, H, W, C];
    its VJP gathers the cotangent. Cells of windows not named by ``idx`` are
    zero whatever ``zero_fill`` says: the JAX package leaves them undefined
    without ``zero_fill``, and zero is one value of "undefined". K2 into a
    zero carrier on the card (the JAX package's K13b)."""
    del zero_fill
    return _ScatterGrid.apply(xw, idx, tuple(grid_hw), window, shift)


def scatter_windows_into(xw, idx, init, grid_hw, window: int, shift: bool):
    """``init`` [B, H, W, C] with the windows named by ``idx`` replaced by
    ``xw`` [B, cap, w*w, C], in ``xw``'s dtype; windows not named keep
    their content. Its VJP gathers the cotangent for ``xw`` and gives
    ``init`` the cotangent with the visited windows zeroed. K2 into
    ``pad_grid(init)`` on the card (the JAX package's K13c)."""
    return _ScatterIntoGrid.apply(xw, idx, init, tuple(grid_hw), window,
                                  shift)
