"""SiamWCA backbones (counterpart of ``tmae_tpu/models/siamwca.py``): three
SST stages encode both frames in one batch with shared weights (with
``ASYMMETRIC.ENABLED``, in two passes, the previous frame's first, and with
``SimSiam`` the previous frame's pyramid detached), a WCA block fuses each
scale, and ``PyramidFuse`` merges the pyramid into the stride-1
BEV map. ``SiamWCA`` is the finetune backbone; ``SiamWCA_MAE`` the temporal
masked-autoencoder pretraining backbone, which masks 75% of the current
frame's voxels, encodes the rest against the full previous frame, and
predicts the points of every voxel, scored by a Chamfer loss on the masked
ones."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.chamfer import chamfer_distance
from ..ops.voxelize import gather_from_grid
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


def stage_caps(runtime, n_stages: int) -> list:
    """Per-stage bucket caps from RUNTIME.OCC_* (the full and small caps; the
    mid bucket is optional), or ``None`` per stage when the config sets no
    caps: the stages then run the grid-native layers."""
    full = runtime.get('OCC_WINDOW_CAPS')
    small = runtime.get('OCC_SMALL_CAPS')
    if not full and not small:
        return [None] * n_stages
    if not full or not small:
        raise NotImplementedError(
            'the port runs the bucketed path with RUNTIME.OCC_WINDOW_CAPS and '
            'OCC_SMALL_CAPS both set, or the grid path with neither')
    mid = runtime.get('OCC_MID_CAPS') or [0] * len(full)
    return [OccCaps(int(f), int(s), int(runtime.get('OCC_SMALL_TOKENS', 16)),
                    int(m), int(runtime.get('OCC_MID_TOKENS', 48)))
            for f, s, m in zip(full, small, mid)]


def _max_tokens(blk) -> int:
    """The largest ``max_tokens`` of a stage's ``PREPROCESS.DROP_INFO.train``
    (as ``SiamWCA._max_tokens`` of the JAX package reads it)."""
    drop = blk['PREPROCESS']['DROP_INFO']['train']
    return max(int(v['max_tokens']) for v in dict(drop).values())


class SiamWCAEncoder(nn.Module):
    """Pyramid-encode both frames, then cross-attend each scale."""

    def __init__(self, model_cfg, caps, cin, window=8, remat=None):
        super().__init__()
        asym = model_cfg.get('ASYMMETRIC') or {}
        self.asymmetric = bool(asym.get('ENABLED', False))
        if self.asymmetric and asym.get('HALF_CHANNELS', False):
            raise NotImplementedError(
                'ASYMMETRIC.HALF_CHANNELS runs the previous frame at half '
                'width (C = 64 at stage 1, head dimension 8), and the '
                'encoder kernels are compiled for C = 128/256 with 8 heads '
                'only (ROADMAP.md)')
        self.simsiam = self.asymmetric and bool(asym.get('SimSiam', False))
        self.sst_blocks, self.wca_blocks = [], []
        blocks = model_cfg['SST_BLOCK_LIST']
        remat = remat or [True] * len(blocks)
        for i, b in enumerate(blocks):
            ecfg = dict(b['ENCODER'])
            sst = SSTBlock(cin, ecfg, caps[i], window, remat=remat[i],
                           max_tokens=_max_tokens(b))
            wca = WCABlock(ecfg, caps[i], window)
            self.add_module(f'sst_block_{i}', sst)
            self.add_module(f'wca_block_{i}', wca)
            self.sst_blocks.append(sst)
            self.wca_blocks.append(wca)
            cin = int(ecfg['D_MODEL'])

    def forward(self, grid_cur: DenseGrid, grid_prv: DenseGrid | None,
                hid_prv=None):
        """Returns (fused per-scale grids of the current frame, overflow per
        stage: a list of [B] counts, SST then WCA, the current frame's
        per-stage pyramid). Both frames run through the SST stages in one
        batch of 2B (asymmetric: one pass each, the previous frame's first);
        with ``hid_prv``, the previous frame's pyramid from a cache (the
        previous streaming step's current pyramid), only the current frame
        does (batch B), ``grid_prv`` is not read, and the SST overflow
        counts the current frame only."""
        B = grid_cur.x.shape[0]
        if self.asymmetric:
            if hid_prv is not None:
                raise ValueError('the streaming cache needs the shared-weight '
                                 'encoder: the model is ASYMMETRIC')
            return self._forward_asymmetric(grid_cur, grid_prv)
        if hid_prv is None:
            x = DenseGrid(torch.cat([grid_cur.x, grid_prv.x], 0),
                          torch.cat([grid_cur.occ, grid_prv.occ], 0))
        else:
            x = grid_cur
        hid_cur, overflow = [], []
        prv = [] if hid_prv is None else list(hid_prv)
        for blk in self.sst_blocks:
            x, ov = blk(x)
            hid_cur.append(DenseGrid(x.x[:B], x.occ[:B]))
            if hid_prv is None:
                prv.append(DenseGrid(x.x[B:], x.occ[B:]))
                ov = ov[:B] + ov[B:]
            overflow.append(ov)
        return self._fuse(hid_cur, prv, overflow)

    def _fuse(self, hid_cur, hid_prv, overflow):
        fused = []
        for h, hp, wca in zip(hid_cur, hid_prv, self.wca_blocks):
            f, ov = wca(h, hp)
            fused.append(f)
            overflow.append(ov)
        return fused, overflow, hid_cur

    def _pyramid(self, x):
        hidden, overflow = [], []
        for blk in self.sst_blocks:
            x, ov = blk(x)
            hidden.append(x)
            overflow.append(ov)
        return hidden, overflow

    def _forward_asymmetric(self, grid_cur, grid_prv):
        """The two frames in separate passes through the shared SST
        stages, the previous frame's first (its batch-norm statistics
        update first); ``SimSiam`` stops the gradient at the previous
        frame's pyramid."""
        hid_prv, ov_prv = self._pyramid(grid_prv)
        if self.simsiam:
            hid_prv = [DenseGrid(h.x.detach(), h.occ) for h in hid_prv]
        hid_cur, ov_cur = self._pyramid(grid_cur)
        overflow = [a + b for a, b in zip(ov_cur, ov_prv)]
        return self._fuse(hid_cur, hid_prv, overflow)


class SiamWCA(nn.Module):
    """Produces the stride-1 ``spatial_features`` map [B, H, W, C]."""

    def __init__(self, model_cfg, caps, cin, remat=None):
        super().__init__()
        self.encoder = SiamWCAEncoder(model_cfg, caps, cin, remat=remat)
        self.fuse = PyramidFuse([dict(model_cfg['FUSE_LAYER'][src])
                                 for src in model_cfg['FEATURES_SOURCE']])

    def forward(self, vs_cur: VoxelSet, vs_prv: VoxelSet | None,
                cached_prev=None, return_hidden: bool = False):
        """Returns (spatial features, overflow per stage) and, with
        ``return_hidden``, the current frame's pyramid. Streaming serving
        passes the previous step's pyramid as ``cached_prev``: on
        consecutive frames it is this step's previous-frame pyramid, so the
        previous frame is not encoded again (``vs_prv`` may be None)."""
        g_cur = DenseGrid(vs_cur.to_dense().to(CARRIER_DTYPE),
                          vs_cur.occupancy())
        g_prv = None
        if cached_prev is None:
            g_prv = DenseGrid(vs_prv.to_dense().to(CARRIER_DTYPE),
                              vs_prv.occupancy())
        fused, overflow, hidden = self.encoder(g_cur, g_prv,
                                               hid_prv=cached_prev)
        spatial = self.fuse([f.x for f in fused])
        if return_hidden:
            return spatial, overflow, hidden
        return spatial, overflow


def random_voxel_mask(voxel_mask: torch.Tensor, num_voxels: torch.Tensor,
                      mask_ratio: float, generator=None) -> torch.Tensor:
    """Per-sample random masking of the valid voxels: ``mae_mask`` [B, V]
    f32, 1 where a voxel is masked (removed), 0 where kept or invalid.
    ``int(num_voxels * (1 - ratio))`` voxels are kept per sample (f32
    product, truncated), chosen by uniform noise from ``generator``
    (counterpart of ``random_voxel_mask``; the noise differs from JAX's)."""
    B, V = voxel_mask.shape
    dev = voxel_mask.device
    noise = torch.rand(B, V, generator=generator, device=dev)
    noise = torch.where(voxel_mask, noise, 2.0)  # invalid voxels rank last
    order = torch.argsort(noise, dim=1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(V, device=dev).expand(B, V))
    len_keep = (num_voxels.float() * (1.0 - mask_ratio)).to(torch.int64)
    keep = ranks < len_keep[:, None]
    return torch.where(voxel_mask, 1.0 - keep.float(), 0.0)


def gather_gt_points(points_xyz, point_voxel, point_valid, V: int, K: int):
    """The first K points of each voxel in point order (a stable sort by
    voxel slot), wrap-repeated to fill K; a voxel without points gets K
    zeros. Returns [B, V, K, 3] (counterpart of ``gather_gt_points``)."""
    B, P, _ = points_xyz.shape
    dev = points_xyz.device
    pv = torch.where(point_valid, point_voxel.long(), V)
    order = torch.argsort(pv, dim=1, stable=True)
    s = torch.gather(pv, 1, order)
    pos = torch.arange(P, device=dev).expand(B, P)
    newflag = torch.cat([torch.ones_like(s[:, :1], dtype=torch.bool),
                         s[:, 1:] != s[:, :-1]], 1)
    starts = torch.cummax(torch.where(newflag, pos, -1), 1).values
    rank = torch.empty_like(order).scatter_(1, order, pos - starts)
    dest = torch.where((rank < K) & (pv < V), pv * K + rank, V * K)
    buf = points_xyz.new_zeros(B, V * K + 1, 3).scatter_(
        1, dest[..., None].expand(B, P, 3), points_xyz)[:, :-1]
    cnt = torch.zeros(B, V * K + 1, dtype=torch.int64, device=dev)
    cnt = cnt.scatter_add_(1, dest, torch.ones_like(dest))[:, :-1]
    n = cnt.reshape(B, V, K).sum(-1).clamp(1, K)
    idx = torch.arange(K, device=dev) % n[..., None]
    return torch.gather(buf.reshape(B, V, K, 3), 2,
                        idx[..., None].expand(B, V, K, 3))


class SiamWCA_MAE(nn.Module):
    """Pretraining backbone (counterpart of ``SiamWCA_MAE``): the full
    previous frame and the visible 25% of the current frame through the
    shared encoder, ``PyramidFuse`` as ``decoder_fuse``, and a linear
    ``decoder_pred`` of NUM_PRD_POINTS points per voxel, at every voxel
    slot; the targets are each voxel's first NUM_GT_POINTS points relative
    to its centre."""

    def __init__(self, model_cfg, caps, cin, spec, remat=None):
        super().__init__()
        mask_cfg = model_cfg['MASK_CONFIG']
        self.ratio = float(mask_cfg['RATIO'])
        self.n_pred = int(mask_cfg['NUM_PRD_POINTS'])
        self.n_gt = int(mask_cfg['NUM_GT_POINTS'])
        self.spec = spec
        self.encoder = SiamWCAEncoder(model_cfg, caps, cin, remat=remat)
        fuse = [dict(model_cfg['FUSE_LAYER'][src])
                for src in model_cfg['FEATURES_SOURCE']]
        self.decoder_fuse = PyramidFuse(fuse)
        width = sum(int(f['NUM_UPSAMPLE_FILTER']) for f in fuse) // len(fuse)
        self.decoder_pred = nn.Linear(width, self.n_pred * 3)

    def forward(self, vs_cur: VoxelSet, vs_prv: VoxelSet, points_xyz,
                point_voxel, point_valid, mae_mask=None, generator=None):
        """``mae_mask`` [B, V] (1 = masked) is drawn with ``generator`` when
        not given. Returns ``pred_points`` [B, V, P, 3], ``gt_points``
        [B, V, G, 3], ``loss_weights`` [B, V], ``mae_mask``,
        ``spatial_features`` and ``occ_overflow`` ([stages*2, B])."""
        if mae_mask is None:
            mae_mask = random_voxel_mask(vs_cur.mask, vs_cur.mask.sum(1),
                                         self.ratio, generator)
        visible = vs_cur.mask & (mae_mask == 0.0)
        vis = VoxelSet(torch.where(visible[..., None], vs_cur.feat, 0.0),
                       vs_cur.coords, visible, vs_cur.grid_hw)
        g_vis = DenseGrid(vis.to_dense().to(CARRIER_DTYPE), vis.occupancy())
        g_prv = DenseGrid(vs_prv.to_dense().to(CARRIER_DTYPE),
                          vs_prv.occupancy())
        fused, overflow, _ = self.encoder(g_vis, g_prv)
        spatial = self.decoder_fuse([f.x for f in fused])
        B, V = vs_cur.mask.shape
        pyr = gather_from_grid(spatial, vs_cur.coords, vs_cur.mask)
        pred = self.decoder_pred(pyr.float()).reshape(B, V, self.n_pred, 3)
        gt = gather_gt_points(points_xyz, point_voxel, point_valid, V,
                              self.n_gt)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32,
                                     device=gt.device)
        vs, rng = f32(self.spec.voxel_size), f32(self.spec.pc_range)
        cx = (vs_cur.coords[..., 1].float() + 0.5) * vs[0] + rng[0]
        cy = (vs_cur.coords[..., 0].float() + 0.5) * vs[1] + rng[1]
        cz = (0.5 * vs[2] + rng[2]).expand_as(cx)
        centers = torch.stack([cx, cy, cz], -1)
        return {'pred_points': pred,
                'gt_points': gt - centers[:, :, None, :],
                'loss_weights': mae_mask * vs_cur.mask.float(),
                'mae_mask': mae_mask,
                'spatial_features': spatial,
                'occ_overflow': torch.stack(overflow)}


def mae_loss(out) -> torch.Tensor:
    """Chamfer distance over the masked voxels (counterpart of
    ``SiamWCA_MAE.loss``)."""
    B, V = out['loss_weights'].shape
    return chamfer_distance(out['pred_points'].reshape(B * V, -1, 3),
                            out['gt_points'].reshape(B * V, -1, 3),
                            out['loss_weights'].reshape(B * V))

