"""Detectors (counterpart of ``tmae_tpu/models/detectors.py``,
``pointpillar.py`` and ``second_net.py``):

* ``CenterPoint``: voxelization (on the host, or on the device when the
  batch does not ship it) → TemporalDynVFE → SiamWCA (``t_mae.yaml``,
  ``t_mae_waymo.yaml``), or DynVFE → SPTBackbone (one frame, voxelized on
  the device) → BACKBONE_2D (``SSTBEVBackbone`` or ``BaseBEVBackbone``) →
  CenterHead → decode → rotated NMS on the card (or the native host NMS
  after a decode without it) when serving (eval mode), and the CenterPoint
  loss (:func:`centerpoint_loss`, with the IoU head's term where the config
  has one) when training (train mode);
* ``TMAE``, the masked-autoencoder pretraining shell (``t_mae_ssl.yaml``,
  ``t_mae_ssl_waymo.yaml``): VFE → SiamWCA_MAE, or with DynVFE →
  SPTBackboneMAE (``GDMAE``, the single-frame shell), with the Chamfer
  loss :func:`tmae_loss`;
* ``PointPillar`` and ``SECONDNet``, the anchor-head families over the host
  voxelizer's voxels, with :func:`anchor_loss` and, when serving, the top
  K of the class scores (:func:`anchor_predict`) handed to the host NMS;
* ``SSD3D``, the point detector (``models/ssd3d.py``): the fusion-sampling
  PointNet++ backbone on the raw points and the vote head, with
  :func:`ssd3d_loss` and, when serving, the votes cut by score and sorted
  (:func:`ssd3d_candidates`) for the host NMS.
* ``GraphRCNN`` (``models/graph_rcnn.py``): SECONDNet's first stage,
  proposals, the RoI sampler when training, the DFVS pool and the AttnGNN
  second stage, with the camera branch (DLASeg on the batch's images and
  PointSample's image features of the pooled points) where the config has
  one, with :func:`graph_rcnn_loss` and, when serving, the refined boxes
  cut by score and sorted for the host NMS (``graph_rcnn_candidates``).

Batch layout (dict of tensors, as the JAX package's host pipeline ships it):
``points``/``points_prev`` [B, P, C] (C = :func:`num_point_features`: x, y,
z, intensity on ONCE, and elongation on Waymo), ``point_mask``/
``point_mask_prev`` [B, P], and, under RUNTIME.HOST_VOXELIZE, per frame
(``cur``/``prv``) the host voxelization ``pv_*``, ``pvalid_*``,
``vcoords_*``, ``vmask_*`` and the sorted extras ``vmean_*``, ``vends_*``;
the anchor families read ``voxels``, ``voxel_num_points``,
``voxel_coords`` / ``voxel_coords_zyx`` and ``voxel_mask``.
Detection training adds
``gt_boxes`` [B, M, 8] (class 1-indexed in the last column) and
``gt_mask`` [B, M]. A camera model reads ``images`` [B, H, W, 3],
``trans_lidar_to_cam`` [B, 4, 4], ``trans_cam_to_img`` [B, 3, 4],
``image_shape`` [B, 2], ``image_scale`` [B, 2] and, where the batch has
them, ``aug_inverse`` [B, 4, 4] and ``image_flip`` [B].
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..device import full_f32, resolve_device
from ..ops.geometry import class_params
from ..ops.geometry_np import nms_bev
from ..ops.voxelize import VoxelSpec
from ..ops.centernet import assign_center_targets
from ..utils import native as host
from .anchor_head import anchor_head_loss, anchor_head_predict
from .bev import BaseBEVBackbone, SSTBEVBackbone
from .center_head import CenterHead, center_head_loss, decode
from .graph_rcnn import GraphRCNN, graph_rcnn_loss
from .layers import DeformConvBNReLU
from .pointpillar import PointPillar
from .second_net import SECONDNet
from .siamwca import SiamWCA, SiamWCA_MAE, mae_loss, remat_stages, stage_caps
from .spt_backbone import SPTBackbone, SPTBackboneMAE, fuse_width
from .ssd3d import SSD3D, ssd3d_loss
from .sst import VoxelSet
from .vfe import DynVFE, TemporalDynVFE

HOSTVOX_KEYS = (('point_voxel', 'pv'), ('point_valid', 'pvalid'),
                ('voxel_coords', 'vcoords'), ('voxel_mask', 'vmask'),
                ('voxel_mean_xyz', 'vmean'), ('seg_ends', 'vends'))


def make_voxel_spec(data_cfg, runtime_cfg) -> VoxelSpec:
    proc = [p for p in data_cfg['DATA_PROCESSOR']
            if p['NAME'] in ('calculate_grid_size', 'transform_points_to_voxels')]
    voxel_size = tuple(proc[-1]['VOXEL_SIZE']) if proc else (0.32, 0.32, 8.0)
    return VoxelSpec(
        pc_range=tuple(data_cfg['POINT_CLOUD_RANGE']),
        voxel_size=voxel_size,
        max_points=int(runtime_cfg['MAX_POINTS']),
        max_voxels=int(runtime_cfg['MAX_VOXELS'][0]),
    )


def _grid_hw(spec: VoxelSpec):
    nx, ny, _ = spec.grid_size
    return (ny, nx)


def num_point_features(cfg) -> int:
    """Point channels the model reads: the length of the config's
    ``POINT_FEATURE_ENCODING.used_feature_list`` (4 on ONCE, 5 on Waymo),
    4 without one (the JAX package's VFE takes its width from the data)."""
    pfe = cfg['DATA_CONFIG'].get('POINT_FEATURE_ENCODING')
    return len(pfe['used_feature_list']) if pfe else 4


def _build_vfe(cfg, spec, backbones: dict):
    """The VFE that ``MODEL.VFE.NAME`` names, with the 3D backbone class
    that ``MODEL.BACKBONE_3D.NAME`` names among ``backbones`` ({name:
    (class, VFE name)}): TemporalDynVFE for the two-frame backbones, DynVFE
    for the single-frame ones. Returns (VFE, backbone class)."""
    model_cfg = cfg['MODEL']
    vfe_cfg = model_cfg['VFE']
    b3d = model_cfg['BACKBONE_3D']['NAME']
    cls, vfe_name = backbones.get(b3d, (None, None))
    if vfe_cfg['NAME'] != vfe_name:
        raise NotImplementedError(
            f'the port runs {model_cfg["NAME"]} with ' + ' or '.join(
                f'{v} + {b}' for b, (_, v) in backbones.items()))
    kwargs = dict(
        num_point_features=num_point_features(cfg),
        use_absolute_xyz=vfe_cfg.get('USE_ABSLOTE_XYZ', True),
        use_cluster_xyz=vfe_cfg.get('USE_CLUSTER_XYZ', True),
        with_distance=vfe_cfg.get('WITH_DISTANCE', False),
        compute_dtype=str(cfg['RUNTIME'].get('VFE_COMPUTE', 'f32')))
    mlps = [list(m) for m in vfe_cfg['MLPS']]
    if vfe_name == 'DynVFE':
        return DynVFE(spec, mlps, **kwargs), cls
    return TemporalDynVFE(spec, mlps,
                          remat=bool(cfg['RUNTIME'].get('VFE_REMAT', True)),
                          **kwargs), cls


def _backbone_args(cfg) -> dict:
    """Bucket caps, VFE output width and remat flags of the SST backbones
    (SiamWCA, SPTBackbone and their MAE forms)."""
    b3d, runtime = cfg['MODEL']['BACKBONE_3D'], cfg['RUNTIME']
    n = len(b3d['SST_BLOCK_LIST'])
    return dict(caps=stage_caps(runtime, n),
                cin=cfg['MODEL']['VFE']['MLPS'][-1][-1],
                remat=remat_stages(runtime, n))


def _run_vfe(vfe, spec, batch, prev_needed: bool = True):
    """The current frame (and the previous one, when the VFE is the
    two-frame one and ``prev_needed``) through the VFE: (VoxelSet cur,
    VoxelSet prv or None, the current frame's VFE outputs)."""
    def hostvox(which):
        return {k: batch[f'{short}_{which}'] for k, short in HOSTVOX_KEYS
                if f'{short}_{which}' in batch}

    if isinstance(vfe, DynVFE):
        cur, prv = vfe(batch['points'], batch['point_mask']), None
    else:
        cur, prv = vfe(batch['points'], batch['point_mask'],
                       batch.get('points_prev'), batch.get('point_mask_prev'),
                       hostvox('cur'), hostvox('prv'),
                       prev_needed=prev_needed)
    hw = _grid_hw(spec)
    vs = [None if d is None else
          VoxelSet(d['voxel_features'], d['voxel_coords'], d['voxel_mask'],
                   hw) for d in (cur, prv)]
    return vs[0], vs[1], cur


def previous_frame_batch(batch: dict) -> dict:
    """The batch with its previous frame in the current frame's place (the
    points, their mask and every host-voxelization key together), as the
    first step of a stream encodes it to start the cache; the
    previous-frame entries stay as they are."""
    out = dict(batch)
    out['points'], out['point_mask'] = (batch['points_prev'],
                                        batch['point_mask_prev'])
    for _, short in HOSTVOX_KEYS:
        if f'{short}_prv' in batch:
            out[f'{short}_cur'] = batch[f'{short}_prv']
    return out


def _backbone_2d(cfg2d, cin):
    """The 2D backbone that ``BACKBONE_2D`` names, as the JAX package picks
    it: none without the key (the head then takes the pyramid's width),
    ``SSTBEVBackbone`` or ``BaseBEVBackbone``, or a refusal of any other
    name at build time."""
    if cfg2d is None:
        return None
    classes = {'SSTBEVBackbone': SSTBEVBackbone,
               'BaseBEVBackbone': BaseBEVBackbone}
    if cfg2d['NAME'] not in classes:
        raise NotImplementedError(
            f'BACKBONE_2D {cfg2d["NAME"]} is not a 2D backbone of the port '
            f'(it has {list(classes)})')
    return classes[cfg2d['NAME']](cfg2d, cin)


class CenterPoint(nn.Module):
    """VFE → SiamWCA (two frames) or SPTBackbone (one) → BACKBONE_2D (when
    the config has one) → CenterHead. ``model.train()`` runs the training
    forward (batch statistics, the training kernels, remat as
    RUNTIME.VFE_REMAT / REMAT_STAGES say)."""

    def __init__(self, cfg):
        super().__init__()
        model_cfg = cfg['MODEL']
        self.spec = make_voxel_spec(cfg['DATA_CONFIG'], cfg['RUNTIME'])
        b3d = model_cfg['BACKBONE_3D']
        self.vfe, cls = _build_vfe(cfg, self.spec, {
            'SiamWCA': (SiamWCA, 'TemporalDynVFE'),
            'SPTBackbone': (SPTBackbone, 'DynVFE')})
        self.backbone_3d = cls(b3d, **_backbone_args(cfg))
        width = fuse_width(b3d)
        self.backbone_2d = _backbone_2d(model_cfg.get('BACKBONE_2D'), width)
        self.dense_head = CenterHead(
            model_cfg['DENSE_HEAD'], width if self.backbone_2d is None
            else self.backbone_2d.out_channels)

    def forward(self, batch: dict, cached_prev=None,
                return_hidden: bool = False):
        """Returns ``pred_dicts`` (NHWC head maps per group),
        ``spatial_features_2d`` and ``occ_overflow`` ([stages, B]: occupied
        windows over a bucket cap, SST stages then, with SiamWCA, WCA
        blocks).

        Streaming serving (SiamWCA): ``return_hidden=True`` adds
        ``hidden_cur``, the current frame's SST pyramid (a list of
        per-stage ``DenseGrid``); handed to the next frame's pass as
        ``cached_prev``, it stands for that pass's previous frame, whose VFE
        and SST stages are then skipped (the batch's previous-frame entries
        are not read and may be left out)."""
        vs_cur, vs_prv, _ = _run_vfe(self.vfe, self.spec, batch,
                                     prev_needed=cached_prev is None)
        hidden = []
        if isinstance(self.backbone_3d, SPTBackbone):
            if cached_prev is not None or return_hidden:
                raise ValueError('the streaming cache needs a two-frame '
                                 'backbone: the model is SPTBackbone')
            spatial, overflow = self.backbone_3d(vs_cur)
        else:
            spatial, overflow, *hidden = self.backbone_3d(
                vs_cur, vs_prv, cached_prev=cached_prev,
                return_hidden=return_hidden)
        spatial2d = (spatial if self.backbone_2d is None
                     else self.backbone_2d(spatial))
        out = {'pred_dicts': self.dense_head(spatial2d),
               'spatial_features_2d': spatial2d,
               'occ_overflow': torch.stack(overflow)}
        if return_hidden:
            out['hidden_cur'] = hidden[0]
        return out


class TMAE(nn.Module):
    """Pretraining shell: VFE → SiamWCA_MAE, or DynVFE → SPTBackboneMAE (the
    loss is :func:`tmae_loss`). The mask is drawn from the ``generator``
    handed to the forward, or taken as given (``mae_mask``)."""

    def __init__(self, cfg):
        super().__init__()
        self.spec = make_voxel_spec(cfg['DATA_CONFIG'], cfg['RUNTIME'])
        self.vfe, cls = _build_vfe(cfg, self.spec, {
            'SiamWCA_MAE': (SiamWCA_MAE, 'TemporalDynVFE'),
            'SPTBackboneMAE': (SPTBackboneMAE, 'DynVFE')})
        self.backbone_3d = cls(cfg['MODEL']['BACKBONE_3D'], spec=self.spec,
                               **_backbone_args(cfg))

    def forward(self, batch: dict, mae_mask=None, generator=None):
        """Returns the outputs of the MAE backbone (predicted and target
        points, loss weights, the mask, ``occ_overflow``)."""
        vs_cur, vs_prv, cur = _run_vfe(self.vfe, self.spec, batch)
        frames = (vs_cur,) if vs_prv is None else (vs_cur, vs_prv)
        return self.backbone_3d(*frames, batch['points'][..., :3],
                                cur['point_voxel'], cur['point_valid'],
                                mae_mask=mae_mask, generator=generator)


class GDMAE(TMAE):
    """The single-frame MAE shell (DynVFE → SPTBackboneMAE): the same
    surface as :class:`TMAE`."""


def _anchor_family(cls):
    def build(cfg):
        return cls(cfg, make_voxel_spec(cfg['DATA_CONFIG'], cfg['RUNTIME']),
                   num_point_features(cfg))
    return build


DETECTORS = {'CenterPoint': CenterPoint, 'TMAE': TMAE, 'GDMAE': GDMAE,
             'PointPillar': _anchor_family(PointPillar),
             'SECONDNet': _anchor_family(SECONDNet),
             'SSD3D': lambda cfg: SSD3D(cfg, num_point_features(cfg) - 3),
             'GraphRCNN': _anchor_family(GraphRCNN)}
ANCHOR_DETECTORS = ('PointPillar', 'SECONDNet')
MAE_DETECTORS = ('TMAE', 'GDMAE')


def build_detector(cfg, device=None) -> nn.Module:
    """The eval-mode detector that MODEL.NAME names, on ``device`` (the card
    when None; raises when there is none). A config with ``IMG_BACKBONE``
    turns TF32 off for the process (:func:`~..device.full_f32`): the camera
    branch computes in f32, as the JAX package does."""
    name = cfg['MODEL']['NAME']
    if name not in DETECTORS:
        raise NotImplementedError(f'detector {name} is not ported: an '
                                  f'unknown detector; have {list(DETECTORS)}')
    if cfg['MODEL'].get('IMG_BACKBONE'):
        full_f32()
    return DETECTORS[name](cfg).to(resolve_device(device)).eval()


def tmae_loss(cfg, outputs, batch):
    """Pretraining loss: the Chamfer distance over the masked voxels.
    Returns (loss, parts)."""
    loss = mae_loss(outputs)
    return loss, {'loss_rpn': loss}


def anchor_loss(cfg, head, outputs, batch):
    """Training loss of the anchor families: ``head``'s targets of the
    batch's boxes, then :func:`anchor_head_loss`. Returns (loss, parts)."""
    targets = head.assign_targets(batch['gt_boxes'], batch['gt_mask'])
    return anchor_head_loss(head, outputs['anchor_outputs'], targets,
                            cfg['MODEL']['DENSE_HEAD']['LOSS_CONFIG'])


def detector_loss(cfg, model):
    """``loss_fn(outputs, batch) -> (loss, parts)`` of the model's family:
    :func:`tmae_loss`, :func:`anchor_loss` or :func:`graph_rcnn_loss`
    (with the model's head), :func:`ssd3d_loss` or
    :func:`centerpoint_loss`."""
    name = cfg['MODEL']['NAME']
    if name in ANCHOR_DETECTORS:
        return lambda out, batch: anchor_loss(cfg, model.dense_head, out,
                                              batch)
    if name == 'GraphRCNN':
        return lambda out, batch: graph_rcnn_loss(cfg, model.dense_head, out,
                                                  batch)
    loss = (tmae_loss if name in MAE_DETECTORS
            else ssd3d_loss if name == 'SSD3D' else centerpoint_loss)
    return lambda out, batch: loss(cfg, out, batch)


def centerpoint_loss(cfg, outputs, batch):
    """Training loss of CenterPoint: CenterNet targets per head group
    (labels remapped to the group's classes), focal heatmap loss, masked
    L1 box loss and, when ``HEAD_DICT`` has an ``iou`` entry, the IoU-head
    loss. Returns (loss, parts)."""
    head_cfg = cfg['MODEL']['DENSE_HEAD']
    spec = make_voxel_spec(cfg['DATA_CONFIG'], cfg['RUNTIME'])
    hw = _grid_hw(spec)
    tac = head_cfg['TARGET_ASSIGNER_CONFIG']
    stride = int(tac.get('FEATURE_MAP_STRIDE', 1))
    fm = (hw[1] // stride, hw[0] // stride)  # (x, y) like the reference
    class_names = list(cfg['CLASS_NAMES'])
    gt = batch['gt_boxes'].float()
    labels = gt[..., 7].long().clamp(0, len(class_names))
    targets = []
    for names in head_cfg['CLASS_NAMES_EACH_HEAD']:
        gmap = torch.zeros(len(class_names) + 1, dtype=torch.long)
        for li, n in enumerate(names):
            gmap[class_names.index(n) + 1] = li + 1
        local = gmap.to(gt.device)[labels]
        boxes = torch.cat([gt[..., :7], local[..., None].float()], -1)
        targets.append(assign_center_targets(
            boxes, (local > 0) & batch['gt_mask'], len(names), fm,
            spec.pc_range, spec.voxel_size, stride,
            float(tac['GAUSSIAN_OVERLAP']), int(tac['MIN_RADIUS'])))
    iou_cfg = None
    if 'iou' in head_cfg['SEPARATE_HEAD_CFG']['HEAD_DICT']:
        iou_cfg = {'voxel_size': spec.voxel_size, 'pc_range': spec.pc_range,
                   'feature_map_stride': stride}
    return center_head_loss(
        outputs['pred_dicts'], targets,
        list(head_cfg['SEPARATE_HEAD_CFG']['HEAD_ORDER']),
        head_cfg['LOSS_CONFIG']['LOSS_WEIGHTS'], iou_cfg=iou_cfg)


def _fan_in(mod, p) -> int:
    """Inputs a weight's output unit reads: the input channels times the
    kernel window (a 3D sparse kernel is [k^3, Cin, Cout], a deconvolution's
    [Cin, Cout, k, k])."""
    if isinstance(mod, nn.ConvTranspose2d):
        return p[:, 0].numel()
    if p.dim() == 3:
        return p.shape[0] * p.shape[1]
    return p[0].numel()


@torch.no_grad()
def init_random_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights (no checkpoint is in the repository): weights
    at 1/sqrt(fan_in), biases and BN statistics near their identity values,
    tau 1. Drawn on the CPU from one ``torch.Generator``, so the same seed
    gives the same model on every device."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda t, s=1.0: (torch.randn(t.shape, generator=g) * s).to(t)
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if name == 'tau':
                p.fill_(1.0)
            elif p.dim() >= 2:
                fan_in = (p.shape[0] if isinstance(mod, nn.ConvTranspose2d)
                          else _fan_in(mod, p))
                p.copy_(rand(p, fan_in ** -0.5))
            elif name == 'weight':  # norm scales
                p.copy_(1.0 + rand(p, 0.1))
            else:
                p.copy_(rand(p, 0.1))
        for name, b in mod.named_buffers(recurse=False):
            if name == 'running_mean':
                b.copy_(rand(b, 0.1))
            elif name == 'running_var':
                b.copy_(0.5 + torch.rand(b.shape, generator=g).to(b))
    return model


@torch.no_grad()
def init_training_(model: nn.Module, seed: int) -> nn.Module:
    """The JAX package's initial values for training from scratch (flax's
    defaults as its modules set them): kernels LeCun normal (truncated at 2
    standard deviations, variance 1 / fan_in, fan_in over the input channels
    and the kernel window), biases 0 but the heatmap outputs' -2.19, norm
    scales 1, running means 0 and variances 1, tau 1. Drawn on the CPU from
    one ``torch.Generator`` seeded with ``seed``. The anchor head's class
    bias starts at -log(99) and its box kernel at N(0, 0.001^2), as the
    JAX package's ``AnchorHeadSingle`` sets them, and GraphRCNN's box
    output kernel ``reg_out`` at N(0, 0.001^2), as its ``GraphRCNNHead``
    does; a DCN block's ``conv_offset_mask`` at 0 and its kernel He normal
    (variance 2 / fan_in, truncated), as the JAX package's
    ``DeformConvBNReLU``."""
    g = torch.Generator().manual_seed(seed)
    std_of_trunc = 0.87962566103423978  # std of N(0, 1) cut at +-2
    for mname, mod in model.named_modules():
        leaf = mname.rsplit('.', 1)[-1]
        for name, p in mod.named_parameters(recurse=False):
            if name == 'tau' or (name == 'weight' and p.dim() == 1):
                p.fill_(1.0)
            elif leaf == 'conv_offset_mask':
                p.zero_()
            elif p.dim() >= 2 and leaf in ('conv_box', 'reg_out'):
                p.copy_(torch.randn(p.shape, generator=g) * 0.001)
            elif p.dim() >= 2:
                w = torch.empty(p.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
                std = _fan_in(mod, p) ** -0.5
                if isinstance(mod, DeformConvBNReLU):  # He: variance 2 / fan_in
                    std *= 2 ** 0.5
                p.copy_(w * (std / std_of_trunc))
            elif leaf == 'hm_out':
                p.fill_(-2.19)
            elif leaf == 'conv_cls':
                p.fill_(-math.log((1 - 0.01) / 0.01))
            else:
                p.zero_()
        for name, b in mod.named_buffers(recurse=False):
            if name == 'running_mean':
                b.zero_()
            elif name == 'running_var':
                b.fill_(1.0)
    return model


def batch_to_device(batch: dict, device) -> dict:
    """Numpy batch from the host pipeline → tensors on ``device``. A copy to
    the card goes through pinned memory and returns without waiting for
    the work already queued on the card."""
    pin = torch.device(device).type == 'cuda'

    def put(v):
        t = torch.from_numpy(np.ascontiguousarray(v))
        return (t.pin_memory() if pin else t).to(device, non_blocking=pin)

    return {k: put(v) for k, v in batch.items() if isinstance(v, np.ndarray)}


def centerpoint_predict(cfg, outputs, nms_on_device: bool = True,
                        exact_topk: bool = True):
    """Decode and rotated NMS → (boxes [B, K, 7], scores, labels 1-indexed,
    valid), score sorted. ``nms_on_device=False`` leaves the NMS to
    :func:`host_nms` (``valid`` is then the decode's). The top-K is exact
    either way: ``exact_topk=False`` asks the JAX package for the TPU's
    approximate top-K, which the card does not need."""
    head_cfg = cfg['MODEL']['DENSE_HEAD']
    spec = make_voxel_spec(cfg['DATA_CONFIG'], cfg['RUNTIME'])
    stride = int(head_cfg['TARGET_ASSIGNER_CONFIG'].get('FEATURE_MAP_STRIDE', 1))
    class_names = list(cfg['CLASS_NAMES'])
    id_maps = [np.asarray([class_names.index(n) for n in g], np.int64)
               for g in head_cfg['CLASS_NAMES_EACH_HEAD']]
    return decode(outputs['pred_dicts'], dict(head_cfg['POST_PROCESSING']),
                  spec.voxel_size, spec.pc_range, stride, id_maps,
                  nms_on_device=nms_on_device)


def anchor_predict(cfg, head, outputs):
    """The anchor families' candidates for the host NMS: the decoded boxes
    at the top K (``MODEL.POST_PROCESSING.MAX_OBJ``, 500 without it) of
    each anchor's best sigmoid class score, score sorted → (boxes [B, K,
    7], scores, labels 1-indexed, valid: all True)."""
    cls_preds, boxes = anchor_head_predict(head, outputs['anchor_outputs'])
    probs = torch.sigmoid(cls_preds)
    scores, labels = probs.max(-1)
    K = int(cfg['MODEL'].get('POST_PROCESSING', {}).get('MAX_OBJ', 500))
    top, idx = torch.topk(scores, min(K, scores.shape[1]), dim=1)
    boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 7))
    return (boxes, top, torch.gather(labels, 1, idx) + 1,
            torch.ones_like(top, dtype=torch.bool))


def nms_config(cfg) -> dict:
    """``NMS_CONFIG`` of the dense head's ``POST_PROCESSING``, or of the
    model's (the anchor families' configs keep it there, as the reference
    reads it; SSD3D's config has no dense head)."""
    head = cfg['MODEL'].get('DENSE_HEAD') or {}
    post = head.get('POST_PROCESSING') or cfg['MODEL']['POST_PROCESSING']
    return post['NMS_CONFIG']


def _host_nms_sorted(cand, scores, thresh, post, native):
    """Keep mask of score-sorted candidates [n, 7] (f64)."""
    if native:
        return host.nms_bev_sorted(cand, thresh, post)
    keep = np.zeros(len(cand), bool)
    keep[nms_bev(cand, scores, thresh, post_maxsize=post)] = True
    return keep


def host_nms(cfg, boxes, scores, labels, valid, native: bool = True):
    """Greedy rotated-BEV NMS per sample on score-sorted candidates (from
    ``centerpoint_predict(..., nms_on_device=False)``): the native host ops
    (``utils/native.nms_bev_sorted``), or the numpy ``nms_bev`` when asked
    (``native=False``); ``multi_class_nms`` runs per class on that class's
    candidates with its threshold and cap. Returns the updated valid
    mask."""
    nms_cfg = nms_config(cfg)
    to_np = lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)
    boxes, scores, valid = to_np(boxes), to_np(scores), to_np(valid).copy()
    if str(nms_cfg.get('NMS_TYPE', 'nms_gpu')) == 'multi_class_nms':
        threshs, posts = class_params(nms_cfg['NMS_THRESH'],
                                      nms_cfg['NMS_POST_MAXSIZE'], True)
        labels = to_np(labels)
        for b in range(boxes.shape[0]):
            for c, (th, po) in enumerate(zip(threshs, posts)):
                sel = np.nonzero(valid[b] & (labels[b] == c + 1))[0]
                if sel.size:
                    valid[b, sel] &= _host_nms_sorted(
                        boxes[b, sel, :7].astype(np.float64),
                        scores[b, sel], th, po, native)
        return valid
    thresh = float(nms_cfg['NMS_THRESH'])
    post = int(nms_cfg['NMS_POST_MAXSIZE'])
    for b in range(boxes.shape[0]):
        n = int(valid[b].sum())
        if n == 0:
            continue
        # candidates are sorted by score, the valid ones first
        valid[b, :n] &= _host_nms_sorted(boxes[b, :n, :7].astype(np.float64),
                                         scores[b, :n], thresh, post, native)
    return valid
