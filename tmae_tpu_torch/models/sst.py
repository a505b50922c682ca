"""SST encoder on the dense BEV carrier (counterpart of
``tmae_tpu/models/sst.py:62-97,193-688``).

A stage pads its carrier once, keeps it padded across its shifted-window
blocks, and unpads once. In eval mode each encoder layer runs the
combined-bucket serving path of the JAX package (``run_combined``): one
gather of all planned windows (K1, twice in cross mode), the small and mid
bucket kernels (K4) and the full bucket kernel (K3) updating their row
ranges in place, and one scatter back into the carrier (K2). The layer's
weights are prepared once per forward (``TiledWeights``: one pack of its
panels) for all its bucket calls. With
``TMAE_FUSED_INPLACE=1`` in the environment when this module is imported
(and ``TMAE_NO_FUSED_INPLACE`` unset) it runs ``run_fused_inplace``
instead: one K12 launch per bucket, small, mid, then full, each updating
its windows straight in the carrier. Each window reads only itself and the
buckets' windows are disjoint, so the two paths give the same carrier.

In train mode it runs ``run_train_cat``: one differentiable gather, the
training kernels on row slices (K8 for the small and mid buckets, K6 for
the full bucket; their backward is K9 / K7), one concat and one
differentiable scatter into a new carrier. Occupied windows beyond a
bucket's cap are not in the plan, so they keep their input: the layer runs
as identity there, and the stage reports how many windows that was.

A stage without caps (``caps`` None: the config sets no RUNTIME.OCC_*) runs
every layer on the dense grid instead (``sst.py:461-471``): kernel K10 on
all windows of the shift's partition, in train and eval mode, and the
backward through K7 on the windows; no plan and no overflow.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dense_windows import slot_pos_embed, window_unview, window_view
from ..ops.encoder_layer import (TiledWeights, encoder_layer_fused_pipelined,
                                 encoder_layer_rows_full,
                                 encoder_layer_rows_sel, fused_encoder_layer,
                                 fused_encoder_layer_grid, kernel_params)
from ..ops.occ_compact import (BucketedCompact, build_bucketed_compact_info,
                               gather_windows_padded, gather_windows_train,
                               pad_grid, repad_grid,
                               scatter_windows_into_padded,
                               scatter_windows_train, unpad_grid)
from ..ops.voxelize import occupancy_grid, scatter_to_grid
from ..ops.window_attention import fused_window_attention
from .layers import (CARRIER_DTYPE, StridedSparseConvBlock, SubMConvBlock,
                     remat)

COMPUTE_DTYPE = torch.bfloat16
# The serving path's choice, read once at import so that one process never
# runs both paths by accident: the fused in-place layer (K12) when
# TMAE_FUSED_INPLACE is set and TMAE_NO_FUSED_INPLACE is not, else the
# combined gather / rows / scatter path (K1-K4).
_FUSED_INPLACE = bool(os.environ.get('TMAE_FUSED_INPLACE')) and not bool(
    os.environ.get('TMAE_NO_FUSED_INPLACE'))


@dataclasses.dataclass
class VoxelSet:
    """Compact voxel list + grid shape: the VFE-to-backbone interface."""

    feat: torch.Tensor    # [B, V, C]
    coords: torch.Tensor  # [B, V, 2] (y, x)
    mask: torch.Tensor    # [B, V] bool
    grid_hw: tuple

    def to_dense(self):
        return scatter_to_grid(self.feat, self.coords, self.mask, self.grid_hw)

    def occupancy(self):
        return occupancy_grid(self.coords, self.mask, self.grid_hw)


@dataclasses.dataclass
class DenseGrid:
    """Dense BEV activation + occupancy (the carrier)."""

    x: torch.Tensor    # [B, H, W, C]
    occ: torch.Tensor  # [B, H, W] bool

    @property
    def grid_hw(self):
        return (self.x.shape[1], self.x.shape[2])


def no_overflow(occ: torch.Tensor) -> torch.Tensor:
    """The overflow count [B] of a stage without caps: 0."""
    return torch.zeros(occ.shape[0], dtype=torch.int32, device=occ.device)


def occ_downsample(occ: torch.Tensor) -> torch.Tensor:
    """Active output set of a 3x3 / stride 2 / pad 1 sparse conv: a max-pool
    of the occupancy."""
    return F.max_pool2d(occ[:, None].float(), 3, 2, 1)[:, 0] > 0


@dataclasses.dataclass(frozen=True)
class OccCaps:
    """Bucket caps of one pyramid stage (RUNTIME.OCC_*)."""

    full: int
    small: int
    small_tokens: int = 16
    mid: int = 0
    mid_tokens: int = 48


def build_plans(occ, window, caps: OccCaps, kv_occ=None):
    """One bucket plan per shift, shared by every layer of a stage."""
    hw = (occ.shape[1], occ.shape[2])
    return tuple(
        build_bucketed_compact_info(
            occ, window, shift, caps.small, caps.full, hw, kv_occ=kv_occ,
            small_tokens=caps.small_tokens, mid_cap=caps.mid,
            mid_tokens=caps.mid_tokens)
        for shift in (False, True))


class DenseWindowAttention(nn.Module):
    """Cosine multi-head attention over the dense window views of a grid,
    alone (no LayerNorm, FFN or residual): the counterpart of the JAX
    package's ``DenseWindowAttention`` (``models/sst.py:110-187``). Cross
    mode (``cross=True``) takes keys and values from another frame's grid.
    The flat ``[B * NW, 64, C]`` call is :func:`fused_window_attention`: K16
    on the card, its plain version on the CPU. Parameters carry the JAX
    names: self mode's fused ``qk_kernel`` splits into ``q`` and ``k``."""

    def __init__(self, d_model, nhead, window, shift, tau_min=0.01,
                 cross=False):
        super().__init__()
        C = d_model
        self.nhead, self.window, self.shift = nhead, window, shift
        self.tau_min, self.cross = tau_min, cross
        self.q = nn.Linear(C, C)
        self.k = nn.Linear(C, C)
        self.v = nn.Linear(C, C)
        self.out = nn.Linear(C, C)
        self.tau = nn.Parameter(torch.ones(1))
        self.register_buffer('pos', slot_pos_embed(window, C).to(COMPUTE_DTYPE),
                             persistent=False)

    def forward(self, grid: DenseGrid, kv_grid: DenseGrid | None = None):
        """Returns [B, H, W, C] f32, zero at unoccupied query cells."""
        if (kv_grid is not None) != self.cross:
            raise ValueError('cross mode takes a kv grid, self mode none')
        w, shift = self.window, self.shift
        xw = window_view(grid.x.to(COMPUTE_DTYPE), w, shift)
        kvw = (window_view(kv_grid.x.to(COMPUTE_DTYPE), w, shift)
               if self.cross else xw)
        src_occ = (kv_grid if self.cross else grid).occ
        kmask = window_view(src_occ[..., None].float(), w, shift)[..., 0]
        B, NW, T, C = xw.shape
        flat = lambda a: a.reshape(B * NW, *a.shape[2:])
        out = fused_window_attention(
            flat(xw), flat(kvw), flat(kmask), self.pos, self.q.weight.t(),
            self.q.bias, self.k.weight.t(), self.k.bias, self.v.weight.t(),
            self.v.bias, self.out.weight.t(), self.out.bias, self.tau,
            self.nhead, self.tau_min, self.cross)
        out = window_unview(out.reshape(B, NW, T, C), grid.grid_hw, w, shift)
        return torch.where(grid.occ[..., None], out, 0.0).float()


class DenseEncoderLayer(nn.Module):
    """Cosine window attention + FFN with post-LN residuals over the planned
    windows of a padded carrier, updated in place. Self mode, or cross mode
    with keys and values from another frame's carrier."""

    def __init__(self, d_model, nhead, dim_feedforward, window, tau_min=0.01,
                 cross=False):
        super().__init__()
        C, Fd = d_model, dim_feedforward
        self.nhead, self.window = nhead, window
        self.tau_min, self.cross = tau_min, cross
        self.q = nn.Linear(C, C)
        self.k = nn.Linear(C, C)
        self.v = nn.Linear(C, C)
        self.out = nn.Linear(C, C)
        self.tau = nn.Parameter(torch.ones(1))
        self.ln1 = nn.LayerNorm(C)
        self.ffn1 = nn.Linear(C, Fd)
        self.ffn2 = nn.Linear(Fd, C)
        self.ln2 = nn.LayerNorm(C)
        self.register_buffer('pos', slot_pos_embed(window, C).to(COMPUTE_DTYPE),
                             persistent=False)

    def tiled_weights(self) -> TiledWeights:
        """The layer's weights prepared once for the bucket calls of one
        eval-mode forward (K3, K4, K12)."""
        return TiledWeights(self.layer_weights(), self.nhead)

    def layer_weights(self) -> list:
        """The 17 layer tensors in :class:`LayerParams` order (f32)."""
        return [self.q.weight, self.q.bias, self.k.weight, self.k.bias,
                self.v.weight, self.v.bias, self.out.weight, self.out.bias,
                self.tau, self.ln1.weight, self.ln1.bias, self.ffn1.weight,
                self.ffn1.bias, self.ffn2.weight, self.ffn2.bias,
                self.ln2.weight, self.ln2.bias]

    def forward_train(self, xp, kvp, plan: BucketedCompact):
        """``run_train_cat``: returns a new carrier (out of place)."""
        w, cross = self.window, self.cross
        kw = dict(nhead=self.nhead, tau_min=self.tau_min, cross=cross)
        weights = self.layer_weights()
        p = kernel_params(weights)
        xw_all = gather_windows_train(xp, plan.cat_idx, w)
        kv_all = gather_windows_train(kvp, plan.cat_idx, w) if cross else None
        B, _, T, C = xw_all.shape
        flat = lambda a: None if a is None else a.reshape(-1, *a.shape[2:])
        rows = lambda a, lo, cap: None if a is None else a[:, lo:lo + cap]
        outs, lo = [], 0
        for si in (plan.small, plan.mid):
            if si is None or not si.idx.shape[1]:
                continue
            cap = si.idx.shape[1]
            out = fused_encoder_layer(
                flat(rows(xw_all, lo, cap)), flat(rows(kv_all, lo, cap)),
                flat(si.sel), flat(si.ksel if cross else None),
                flat(si.qmask), flat(si.kmask if cross else None), self.pos,
                weights, p, **kw)
            outs.append(out.reshape(B, cap, T, C))
            lo += cap
        ci = plan.full
        if ci.idx.shape[1]:
            cap = ci.idx.shape[1]
            out = fused_encoder_layer(
                flat(rows(xw_all, lo, cap)), flat(rows(kv_all, lo, cap)),
                None, None, flat(ci.qmask),
                flat(ci.kmask if cross else None), self.pos, weights, p,
                **kw)
            outs.append(out.reshape(B, cap, T, C))
        out_all = outs[0] if len(outs) == 1 else torch.cat(outs, 1)
        return scatter_windows_train(out_all, plan.cat_idx, xp, w)

    def forward_grid(self, x, kv, occ, kv_occ, shift: bool):
        """The grid-native layer on [B, H, W, C] grids (K10), returning a new
        grid with unoccupied cells 0; ``kv``/``kv_occ`` the key frame in
        cross mode, else None."""
        weights = self.layer_weights()
        out = fused_encoder_layer_grid(
            x.to(COMPUTE_DTYPE), kv.to(COMPUTE_DTYPE) if self.cross else None,
            occ, kv_occ if self.cross else None, self.pos, weights,
            kernel_params(weights), nhead=self.nhead, tau_min=self.tau_min,
            cross=self.cross, window=self.window, shift=shift)
        return torch.where(occ[..., None], out, 0.0)

    def forward_fused_inplace(self, xp, kvp, plan: BucketedCompact):
        """``run_fused_inplace``: K12 on the small, mid and full buckets in
        turn, each updating its windows of ``xp`` in place."""
        p = self.tiled_weights()
        kw = dict(nhead=self.nhead, tau_min=self.tau_min, cross=self.cross,
                  window=self.window)
        for si in (plan.small, plan.mid):
            if si is not None and si.idx.shape[1]:
                xp = encoder_layer_fused_pipelined(xp, kvp, si, self.pos, p,
                                                   sel=True, **kw)
        if plan.full.idx.shape[1]:
            xp = encoder_layer_fused_pipelined(xp, kvp, plan.full, self.pos,
                                               p, sel=False, **kw)
        return xp

    def forward(self, xp, kvp, plan: BucketedCompact):
        if self.training:
            return self.forward_train(xp, kvp, plan)
        if _FUSED_INPLACE:
            return self.forward_fused_inplace(xp, kvp, plan)
        p = self.tiled_weights()
        w, cross = self.window, self.cross
        kw = dict(nhead=self.nhead, tau_min=self.tau_min, cross=cross)
        xw_all = gather_windows_padded(xp, plan.cat_idx, w)
        kv_all = gather_windows_padded(kvp, plan.cat_idx, w) if cross else None
        lo = 0
        for si in (plan.small, plan.mid):
            if si is None or not si.idx.shape[1]:
                continue
            xw_all = encoder_layer_rows_sel(
                xw_all, kv_all, si.sel, si.ksel if cross else si.sel,
                si.qmask, si.kmask if cross else si.qmask, self.pos, p,
                row_lo=lo, **kw)
            lo += si.idx.shape[1]
        ci = plan.full
        if ci.idx.shape[1]:
            xw_all = encoder_layer_rows_full(
                xw_all, kv_all, ci.qmask, ci.kmask if cross else ci.qmask,
                self.pos, p, row_lo=lo, **kw)
        return scatter_windows_into_padded(xw_all, plan.cat_idx, xp, w)


class DenseShiftBlock(nn.Module):
    """Two encoder layers, shift0 then shift1, on a padded carrier: takes
    the carrier in shift0 geometry and returns it in shift1 geometry."""

    def __init__(self, d_model, nhead, dim_feedforward, window, tau_min=0.01,
                 cross=False):
        super().__init__()
        self.window, self.cross = window, cross
        self.EncoderLayer_0 = DenseEncoderLayer(
            d_model, nhead, dim_feedforward, window, tau_min, cross)
        self.EncoderLayer_1 = DenseEncoderLayer(
            d_model, nhead, dim_feedforward, window, tau_min, cross)

    def forward(self, xp, kv_x, plans):
        w = self.window
        kvp0 = pad_grid(kv_x.to(COMPUTE_DTYPE), w, False) if self.cross else None
        xp = self.EncoderLayer_0(xp, kvp0, plans[0])
        xp = repad_grid(xp, w, False, True)
        kvp1 = repad_grid(kvp0, w, False, True) if self.cross else None
        return self.EncoderLayer_1(xp, kvp1, plans[1])

    def forward_grid(self, x, kv_x, occ, kv_occ):
        """Both layers on the dense grid (no caps): [B, H, W, C] in and
        out."""
        x = self.EncoderLayer_0.forward_grid(x, kv_x, occ, kv_occ, False)
        return self.EncoderLayer_1.forward_grid(x, kv_x, occ, kv_occ, True)


class SSTBlock(nn.Module):
    """One pyramid stage: optional strided conv_down, NUM_BLOCKS shifted
    window blocks on one padded carrier, residual add, SubM conv_out."""

    def __init__(self, cin, encoder_cfg, caps: OccCaps | None, window=8,
                 remat: bool = True, max_tokens: int = 64):
        super().__init__()
        ecfg = encoder_cfg
        d_model = int(ecfg['D_MODEL'])
        if max_tokens != window * window:
            raise NotImplementedError(
                'dense SST path requires max_tokens == window**2 (all T-MAE '
                f'configs), not {max_tokens}; the list-based path for smaller '
                'caps is not ported')
        self.window, self.caps, self.remat = window, caps, remat
        self.stride = int(ecfg.get('STRIDE', 1))
        layer_cfg = ecfg.get('LAYER_CFG', {})
        if ecfg.get('ACTIVATION', 'gelu') != 'gelu' or not layer_cfg.get(
                'cosine', True):
            raise NotImplementedError('the port implements cosine + gelu')
        if self.stride > 1:
            self.conv_down = StridedSparseConvBlock(cin, d_model)
        elif cin != d_model:
            raise NotImplementedError('stride-1 stage needs cin == D_MODEL')
        self.blocks = []
        for i in range(int(ecfg['NUM_BLOCKS'])):
            blk = DenseShiftBlock(d_model, int(ecfg['NHEAD']),
                                  int(ecfg['DIM_FEEDFORWARD']), window,
                                  float(layer_cfg.get('tau_min', 0.01)))
            self.add_module(f'encoder_{i}', blk)
            self.blocks.append(blk)
        self.conv_out = SubMConvBlock(d_model, d_model)

    def forward(self, grid: DenseGrid):
        """Returns (DenseGrid, overflow [B]: occupied windows over a cap)."""
        x, occ = grid.x, grid.occ
        rm = self.training and self.remat  # nn.remat of the JAX package
        if self.stride > 1:
            occ = occ_downsample(occ)
            x = remat(self.conv_down, x, occ, enabled=rm)
        w = self.window
        if self.caps is None:
            g = x.to(COMPUTE_DTYPE)
            for blk in self.blocks:
                g = remat(blk.forward_grid, g, None, occ, None, enabled=rm)
            y = remat(self.conv_out, (x + g).to(CARRIER_DTYPE), occ,
                      enabled=rm)
            return DenseGrid(y, occ), no_overflow(occ)
        plans = build_plans(occ, w, self.caps)
        xp = pad_grid(x.to(COMPUTE_DTYPE), w, False)
        for i, blk in enumerate(self.blocks):
            if i:
                xp = repad_grid(xp, w, True, False)
            xp = remat(blk, xp, None, plans, enabled=rm)
        y = x + unpad_grid(xp, (x.shape[1], x.shape[2]), w, True)
        y = remat(self.conv_out, y.to(CARRIER_DTYPE), occ, enabled=rm)
        return DenseGrid(y, occ), plans[0].overflow() + plans[1].overflow()
