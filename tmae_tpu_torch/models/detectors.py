"""Detectors of the T-MAE configs (counterpart of
``tmae_tpu/models/detectors.py:45-297,341-417``):

* ``CenterPoint`` with the SiamWCA backbone (``t_mae.yaml``,
  ``t_mae_waymo.yaml``): voxelization (on the host, or on the device when the
  batch does not ship it) → TemporalDynVFE → SiamWCA → SSTBEVBackbone →
  CenterHead → decode → rotated NMS on the card (or the native host NMS
  after a decode without it) when serving (eval mode), and the CenterPoint
  loss (:func:`centerpoint_loss`, with the IoU head's term where the config
  has one) when training (train mode);
* ``TMAE``, the temporal masked-autoencoder pretraining shell
  (``t_mae_ssl.yaml``, ``t_mae_ssl_waymo.yaml``): VFE → SiamWCA_MAE, with
  the Chamfer loss :func:`tmae_loss`.

Batch layout (dict of tensors, as the JAX package's host pipeline ships it):
``points``/``points_prev`` [B, P, C] (C = :func:`num_point_features`: x, y,
z, intensity on ONCE, and elongation on Waymo), ``point_mask``/
``point_mask_prev`` [B, P], and, under RUNTIME.HOST_VOXELIZE, per frame
(``cur``/``prv``) the host voxelization ``pv_*``, ``pvalid_*``,
``vcoords_*``, ``vmask_*`` and the sorted extras ``vmean_*``, ``vends_*``.
Detection training adds
``gt_boxes`` [B, M, 8] (class 1-indexed in the last column) and
``gt_mask`` [B, M].
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.geometry import class_params
from ..ops.geometry_np import nms_bev
from ..ops.voxelize import VoxelSpec
from ..ops.centernet import assign_center_targets
from ..utils import native as host
from .bev import SSTBEVBackbone
from .center_head import CenterHead, center_head_loss, decode
from .siamwca import SiamWCA, SiamWCA_MAE, mae_loss, remat_stages, stage_caps
from .sst import VoxelSet
from .vfe import TemporalDynVFE

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


def _temporal_vfe(cfg, spec, backbone: str) -> TemporalDynVFE:
    model_cfg = cfg['MODEL']
    vfe_cfg = model_cfg['VFE']
    if (vfe_cfg['NAME'] != 'TemporalDynVFE'
            or model_cfg['BACKBONE_3D']['NAME'] != backbone):
        raise NotImplementedError(f'the port runs {model_cfg["NAME"]} with '
                                  f'TemporalDynVFE + {backbone}')
    return TemporalDynVFE(
        spec, [list(m) for m in vfe_cfg['MLPS']],
        num_point_features=num_point_features(cfg),
        remat=bool(cfg['RUNTIME'].get('VFE_REMAT', True)),
        use_absolute_xyz=vfe_cfg.get('USE_ABSLOTE_XYZ', True),
        use_cluster_xyz=vfe_cfg.get('USE_CLUSTER_XYZ', True),
        with_distance=vfe_cfg.get('WITH_DISTANCE', False),
        compute_dtype=str(cfg['RUNTIME'].get('VFE_COMPUTE', 'f32')))


def _backbone_args(cfg) -> dict:
    """Bucket caps, VFE output width and remat flags of the SiamWCA
    backbones."""
    b3d, runtime = cfg['MODEL']['BACKBONE_3D'], cfg['RUNTIME']
    n = len(b3d['SST_BLOCK_LIST'])
    return dict(caps=stage_caps(runtime, n),
                cin=cfg['MODEL']['VFE']['MLPS'][-1][-1],
                remat=remat_stages(runtime, n))


def _run_vfe(vfe, spec, batch, prev_needed: bool = True):
    """Both frames through the VFE (the current one only when not
    ``prev_needed``): (VoxelSet cur, VoxelSet prv or None, the current
    frame's VFE outputs)."""
    def hostvox(which):
        return {k: batch[f'{short}_{which}'] for k, short in HOSTVOX_KEYS
                if f'{short}_{which}' in batch}

    cur, prv = vfe(batch['points'], batch['point_mask'],
                   batch.get('points_prev'), batch.get('point_mask_prev'),
                   hostvox('cur'), hostvox('prv'), prev_needed=prev_needed)
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
    ``SSTBEVBackbone``, or a refusal of any other name at build time."""
    if cfg2d is None:
        return None
    if cfg2d['NAME'] != 'SSTBEVBackbone':
        raise NotImplementedError(
            f'BACKBONE_2D {cfg2d["NAME"]} is not ported yet (the port builds '
            'SSTBEVBackbone or none; BaseBEVBackbone comes with the other '
            'detector families, ROADMAP.md queue 1 item 4)')
    return SSTBEVBackbone(cfg2d, cin)


class CenterPoint(nn.Module):
    """VFE → SiamWCA → BACKBONE_2D (when the config has one) → CenterHead.
    ``model.train()`` runs the training forward (batch statistics, the
    training kernels, remat as RUNTIME.VFE_REMAT / REMAT_STAGES say)."""

    def __init__(self, cfg):
        super().__init__()
        model_cfg = cfg['MODEL']
        self.spec = make_voxel_spec(cfg['DATA_CONFIG'], cfg['RUNTIME'])
        b3d = model_cfg['BACKBONE_3D']
        self.vfe = _temporal_vfe(cfg, self.spec, 'SiamWCA')
        self.backbone_3d = SiamWCA(b3d, **_backbone_args(cfg))
        fuse_out = sum(int(b3d['FUSE_LAYER'][s]['NUM_UPSAMPLE_FILTER'])
                       for s in b3d['FEATURES_SOURCE'])
        fuse_out //= len(b3d['FEATURES_SOURCE'])
        self.backbone_2d = _backbone_2d(model_cfg.get('BACKBONE_2D'),
                                        fuse_out)
        self.dense_head = CenterHead(
            model_cfg['DENSE_HEAD'], fuse_out if self.backbone_2d is None
            else self.backbone_2d.out_channels)

    def forward(self, batch: dict, cached_prev=None,
                return_hidden: bool = False):
        """Returns ``pred_dicts`` (NHWC head maps per group),
        ``spatial_features_2d`` and ``occ_overflow`` ([stages*2, B]: occupied
        windows over a bucket cap, SST stages then WCA blocks).

        Streaming serving: ``return_hidden=True`` adds ``hidden_cur``, the
        current frame's SST pyramid (a list of per-stage ``DenseGrid``);
        handed to the next frame's pass as ``cached_prev``, it stands for
        that pass's previous frame, whose VFE and SST stages are then
        skipped (the batch's previous-frame entries are not read and may be
        left out)."""
        vs_cur, vs_prv, _ = _run_vfe(self.vfe, self.spec, batch,
                                     prev_needed=cached_prev is None)
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
    """Pretraining shell: VFE → SiamWCA_MAE (the loss is :func:`tmae_loss`).
    The mask is drawn from the ``generator`` handed to the forward, or taken
    as given (``mae_mask``)."""

    def __init__(self, cfg):
        super().__init__()
        self.spec = make_voxel_spec(cfg['DATA_CONFIG'], cfg['RUNTIME'])
        self.vfe = _temporal_vfe(cfg, self.spec, 'SiamWCA_MAE')
        self.backbone_3d = SiamWCA_MAE(cfg['MODEL']['BACKBONE_3D'],
                                       spec=self.spec, **_backbone_args(cfg))

    def forward(self, batch: dict, mae_mask=None, generator=None):
        """Returns the outputs of :class:`SiamWCA_MAE` (predicted and target
        points, loss weights, the mask, ``occ_overflow``)."""
        vs_cur, vs_prv, cur = _run_vfe(self.vfe, self.spec, batch)
        return self.backbone_3d(vs_cur, vs_prv, batch['points'][..., :3],
                                cur['point_voxel'], cur['point_valid'],
                                mae_mask=mae_mask, generator=generator)


DETECTORS = {'CenterPoint': CenterPoint, 'TMAE': TMAE}


def build_detector(cfg, device=None) -> nn.Module:
    """The eval-mode detector that MODEL.NAME names, on ``device`` (the card
    when None; raises when there is none)."""
    name = cfg['MODEL']['NAME']
    if name not in DETECTORS:
        raise NotImplementedError(f'detector {name} is not ported yet; have '
                                  f'{list(DETECTORS)}')
    return DETECTORS[name](cfg).to(resolve_device(device)).eval()


def tmae_loss(cfg, outputs, batch):
    """Pretraining loss: the Chamfer distance over the masked voxels.
    Returns (loss, parts)."""
    loss = mae_loss(outputs)
    return loss, {'loss_rpn': loss}


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
                          else p[0].numel())
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
    one ``torch.Generator`` seeded with ``seed``."""
    g = torch.Generator().manual_seed(seed)
    std_of_trunc = 0.87962566103423978  # std of N(0, 1) cut at +-2
    for mname, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            if name == 'tau' or (name == 'weight' and p.dim() == 1):
                p.fill_(1.0)
            elif p.dim() >= 2:
                deconv = isinstance(mod, nn.ConvTranspose2d)
                fan_in = p[:, 0].numel() if deconv else p[0].numel()
                w = torch.empty(p.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
                p.copy_(w * (fan_in ** -0.5 / std_of_trunc))
            elif mname.rsplit('.', 1)[-1] == 'hm_out':
                p.fill_(-2.19)
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
    nms_cfg = cfg['MODEL']['DENSE_HEAD']['POST_PROCESSING']['NMS_CONFIG']
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
