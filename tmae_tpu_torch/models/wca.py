"""Windowed cross-attention between the current and previous frame
(counterpart of ``tmae_tpu/models/wca.py``). Queries are current-frame
cells, keys and values previous-frame cells of the same window. A window
empty in the previous frame has no key, so its attention probabilities are
zero; every current cell still goes through the FFN and LayerNorms."""

from __future__ import annotations

from torch import nn

from ..ops.occ_compact import pad_grid, unpad_grid
from .layers import SubMConvBlock, remat
from .sst import (COMPUTE_DTYPE, DenseGrid, DenseShiftBlock, OccCaps,
                  build_plans, no_overflow)


class WCABlock(nn.Module):
    """Two shifted cross-attention layers → residual add → SubM conv_out."""

    def __init__(self, encoder_cfg, caps: OccCaps | None, window=8):
        super().__init__()
        ecfg = encoder_cfg
        d_model = int(ecfg['D_MODEL'])
        layer_cfg = ecfg.get('LAYER_CFG', {})
        self.window, self.caps = window, caps
        self.block_0 = DenseShiftBlock(
            d_model, int(ecfg['NHEAD']), int(ecfg['DIM_FEEDFORWARD']), window,
            float(layer_cfg.get('tau_min', 0.01)), cross=True)
        self.conv_out = SubMConvBlock(d_model, d_model)

    def forward(self, grid: DenseGrid, grid_prv: DenseGrid):
        """Returns (DenseGrid, overflow [B])."""
        w = self.window
        if self.caps is None:  # the grid-native layers (K10)
            y = grid.x + self.block_0.forward_grid(grid.x, grid_prv.x,
                                                   grid.occ, grid_prv.occ)
            overflow = no_overflow(grid.occ)
        else:
            plans = build_plans(grid.occ, w, self.caps, kv_occ=grid_prv.occ)
            xp = pad_grid(grid.x.to(COMPUTE_DTYPE), w, False)
            xp = self.block_0(xp, grid_prv.x, plans)
            y = grid.x + unpad_grid(xp, grid.grid_hw, w, True)
            overflow = plans[0].overflow() + plans[1].overflow()
        # the JAX package remats conv_out only, not the cross-attention block
        y = remat(self.conv_out, y, grid.occ, enabled=self.training)
        return DenseGrid(y, grid.occ), overflow
