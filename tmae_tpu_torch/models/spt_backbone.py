"""Single-frame SST backbones of the GD-MAE family (counterpart of
``tmae_tpu/models/spt_backbone.py``): ``SPTBackbone`` encodes one frame
through the SST stages and fuses the pyramid into the stride-1 BEV map;
``SPTBackboneMAE`` masks 75% of the voxels, encodes the rest, decodes
with the pyramid fuse and predicts each voxel's points, scored by the
Chamfer loss (``siamwca.mae_loss``) on the masked ones.

Each stage gets the config's full bucket plan, mid bucket and
``RUNTIME.REMAT_STAGES`` included, as ``SiamWCA`` gets it. The JAX package
hands ``SPTEncoder`` only the full and small caps and the small bucket's
tokens, so windows of 17-48 tokens go to the full bucket there, which
overflows on a dense frame (ROADMAP.md, F9)."""

from __future__ import annotations

from torch import nn

from .siamwca import PyramidFuse, _max_tokens, mae_outputs, masked_set
from .sst import DenseGrid, SSTBlock, VoxelSet


def _fuse_layers(model_cfg):
    return [dict(model_cfg['FUSE_LAYER'][src])
            for src in model_cfg['FEATURES_SOURCE']]


def fuse_width(model_cfg) -> int:
    """The pyramid fuse's output width."""
    fuse = _fuse_layers(model_cfg)
    return sum(int(f['NUM_UPSAMPLE_FILTER']) for f in fuse) // len(fuse)


class SPTEncoder(nn.Module):
    """The SST stages ``sst_block_{i}`` of ``SST_BLOCK_LIST``."""

    def __init__(self, model_cfg, caps, cin, window=8, remat=None):
        super().__init__()
        blocks = model_cfg['SST_BLOCK_LIST']
        remat = remat or [True] * len(blocks)
        self.blocks = []
        for i, b in enumerate(blocks):
            ecfg = dict(b['ENCODER'])
            blk = SSTBlock(cin, ecfg, caps[i], window, remat=remat[i],
                           max_tokens=_max_tokens(b))
            self.add_module(f'sst_block_{i}', blk)
            self.blocks.append(blk)
            cin = int(ecfg['D_MODEL'])

    def forward(self, grid: DenseGrid):
        """Returns (the per-stage grids, overflow per stage: [B] counts)."""
        hidden, overflow = [], []
        for blk in self.blocks:
            grid, ov = blk(grid)
            hidden.append(grid)
            overflow.append(ov)
        return hidden, overflow


class SPTBackbone(nn.Module):
    """One frame's pyramid and its fuse: the stride-1 BEV map."""

    def __init__(self, model_cfg, caps, cin, remat=None):
        super().__init__()
        self.encoder = SPTEncoder(model_cfg, caps, cin, remat=remat)
        self.fuse = PyramidFuse(_fuse_layers(model_cfg))

    def forward(self, vs: VoxelSet):
        """Returns (spatial features [B, H, W, C], overflow per stage)."""
        hidden, overflow = self.encoder(vs.carrier())
        return self.fuse([h.x for h in hidden]), overflow


class SPTBackboneMAE(nn.Module):
    """Pretraining backbone: the visible voxels through the encoder,
    ``decoder_fuse`` (a pyramid fuse) and a linear ``decoder_pred`` of
    NUM_PRD_POINTS points at every voxel slot; the targets are each
    voxel's first NUM_GT_POINTS points relative to its centre."""

    def __init__(self, model_cfg, caps, cin, spec, remat=None):
        super().__init__()
        mask_cfg = model_cfg['MASK_CONFIG']
        self.ratio = float(mask_cfg['RATIO'])
        self.n_pred = int(mask_cfg['NUM_PRD_POINTS'])
        self.n_gt = int(mask_cfg['NUM_GT_POINTS'])
        self.spec = spec
        self.encoder = SPTEncoder(model_cfg, caps, cin, remat=remat)
        self.decoder_fuse = PyramidFuse(_fuse_layers(model_cfg))
        self.decoder_pred = nn.Linear(fuse_width(model_cfg), self.n_pred * 3)

    def forward(self, vs: VoxelSet, points_xyz, point_voxel, point_valid,
                mae_mask=None, generator=None):
        """``mae_mask`` [B, V] (1 = masked) is drawn with ``generator`` when
        not given. Returns ``pred_points`` [B, V, P, 3], ``gt_points``
        [B, V, G, 3], ``loss_weights`` [B, V], ``mae_mask``,
        ``spatial_features`` and ``occ_overflow`` ([stages, B])."""
        mae_mask, vis = masked_set(vs, mae_mask, self.ratio, generator)
        hidden, overflow = self.encoder(vis.carrier())
        return mae_outputs(self, self.decoder_fuse([h.x for h in hidden]), vs,
                           points_xyz, point_voxel, point_valid, mae_mask,
                           overflow)
