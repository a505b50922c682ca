"""SiamWCA finetune backbone (counterpart of
``tmae_tpu/models/siamwca.py:28-246``): three SST stages encode both frames in
one batch with shared weights, a WCA block fuses each scale, and
``PyramidFuse`` merges the pyramid into the stride-1 BEV map."""

from __future__ import annotations

import torch
from torch import nn

from .layers import CARRIER_DTYPE, ConvBNReLU, DeconvBNReLU
from .sst import DenseGrid, OccCaps, SSTBlock, VoxelSet
from .wca import WCABlock


class PyramidFuse(nn.Module):
    """Per-scale ConvTranspose-BN-ReLU deblocks + 3x3 conv_out fusion."""

    def __init__(self, fuse_layers):
        super().__init__()
        self.deblocks = []
        for i, f in enumerate(fuse_layers):
            d = DeconvBNReLU(int(f['NUM_FILTER']), int(f['NUM_UPSAMPLE_FILTER']),
                             int(f['UPSAMPLE_STRIDE']))
            self.add_module(f'deblock_{i}', d)
            self.deblocks.append(d)
        total = sum(int(f['NUM_UPSAMPLE_FILTER']) for f in fuse_layers)
        self.conv_out = ConvBNReLU(total, total // len(fuse_layers), kernel=3)

    def forward(self, dense_list):
        ups = [d(x) for d, x in zip(self.deblocks, dense_list)]
        # stride-2 grids upsample to ceil(H/2)*2, which can overshoot H by 1
        H = min(u.shape[1] for u in ups)
        W = min(u.shape[2] for u in ups)
        x = torch.cat([u[:, :H, :W] for u in ups], dim=-1)
        return self.conv_out(x)


def remat_stages(runtime, n_stages: int) -> list:
    """RUNTIME.REMAT_STAGES: per-stage remat of the SST blocks (empty means
    every stage)."""
    flags = runtime.get('REMAT_STAGES') or [True] * n_stages
    return [bool(f) for f in flags]


def stage_caps(runtime) -> list:
    """Per-stage bucket caps from RUNTIME.OCC_* (the serving path needs the
    full and small caps; the mid bucket is optional)."""
    full = runtime.get('OCC_WINDOW_CAPS')
    small = runtime.get('OCC_SMALL_CAPS')
    if not full or not small:
        raise NotImplementedError(
            'the port runs the bucketed serving path: RUNTIME.OCC_WINDOW_CAPS '
            'and OCC_SMALL_CAPS must be set')
    mid = runtime.get('OCC_MID_CAPS') or [0] * len(full)
    return [OccCaps(int(f), int(s), int(runtime.get('OCC_SMALL_TOKENS', 16)),
                    int(m), int(runtime.get('OCC_MID_TOKENS', 48)))
            for f, s, m in zip(full, small, mid)]


class SiamWCAEncoder(nn.Module):
    """Pyramid-encode both frames, then cross-attend each scale."""

    def __init__(self, model_cfg, caps, cin, window=8, remat=None):
        super().__init__()
        self.sst_blocks, self.wca_blocks = [], []
        blocks = model_cfg['SST_BLOCK_LIST']
        remat = remat or [True] * len(blocks)
        for i, b in enumerate(blocks):
            ecfg = dict(b['ENCODER'])
            sst = SSTBlock(cin, ecfg, caps[i], window, remat=remat[i])
            wca = WCABlock(ecfg, caps[i], window)
            self.add_module(f'sst_block_{i}', sst)
            self.add_module(f'wca_block_{i}', wca)
            self.sst_blocks.append(sst)
            self.wca_blocks.append(wca)
            cin = int(ecfg['D_MODEL'])

    def forward(self, grid_cur: DenseGrid, grid_prv: DenseGrid):
        """Returns (fused per-scale grids of the current frame, overflow
        per stage: a list of [B] counts, SST then WCA)."""
        B = grid_cur.x.shape[0]
        x = DenseGrid(torch.cat([grid_cur.x, grid_prv.x], 0),
                      torch.cat([grid_cur.occ, grid_prv.occ], 0))
        fused, overflow = [], []
        hidden = []
        for blk in self.sst_blocks:
            x, ov = blk(x)
            hidden.append(x)
            overflow.append(ov[:B] + ov[B:])
        for h, wca in zip(hidden, self.wca_blocks):
            f, ov = wca(DenseGrid(h.x[:B], h.occ[:B]),
                        DenseGrid(h.x[B:], h.occ[B:]))
            fused.append(f)
            overflow.append(ov)
        return fused, overflow


class SiamWCA(nn.Module):
    """Produces the stride-1 ``spatial_features`` map [B, H, W, C]."""

    def __init__(self, model_cfg, caps, cin, remat=None):
        super().__init__()
        self.encoder = SiamWCAEncoder(model_cfg, caps, cin, remat=remat)
        self.fuse = PyramidFuse([dict(model_cfg['FUSE_LAYER'][src])
                                 for src in model_cfg['FEATURES_SOURCE']])

    def forward(self, vs_cur: VoxelSet, vs_prv: VoxelSet):
        g_cur = DenseGrid(vs_cur.to_dense().to(CARRIER_DTYPE),
                          vs_cur.occupancy())
        g_prv = DenseGrid(vs_prv.to_dense().to(CARRIER_DTYPE),
                          vs_prv.occupancy())
        fused, overflow = self.encoder(g_cur, g_prv)
        return self.fuse([f.x for f in fused]), overflow
