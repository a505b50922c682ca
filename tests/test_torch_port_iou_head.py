"""The IoU head and multi-class NMS of the port against the JAX package on
the CPU, on the tiny config with ``iou`` in ``HEAD_DICT``, ``iou_weight``
1 and ``multi_class_nms`` with IoU-rectified scores (as
``tests/test_center_head_iou.py`` builds it): the head maps of a forward
from the same weights (``params_from_jax``), the targets' ``iou_boxes``,
every loss term on equal head maps (``iou_loss_head_0`` included), one
training step's loss and gradients, and serving with device NMS against
the port's host NMS. The models are the tiny config cut to its first SST
stage (``one_stage``): JAX's compile of a training step of all three takes
about 100 s on the CPU, of one about 30 s, and what these tests hold acts
after the backbone or within each stage alike. The tolerances are stated
beside each comparison."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_model import random_variables
from tests.test_torch_port_train import (_cos, _encoder_rounded, _pre_bn_bias,
                                         _rel, _train_cfg_and_batch)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.models import detectors as jdet
from tmae_tpu.ops import centernet as jcn
from tmae_tpu_torch.models import detectors as tdet
from tmae_tpu_torch.ops import centernet as tcn
from tmae_tpu_torch.utils.from_jax import params_from_jax, tree_from_jax


def one_stage(cfg):
    """The config with its first SST stage only (its caps, its pyramid
    source): fewer layers for JAX to compile."""
    cfg = copy.deepcopy(cfg)
    b3d, rt = cfg.MODEL.BACKBONE_3D, cfg.RUNTIME
    b3d.SST_BLOCK_LIST = b3d.SST_BLOCK_LIST[:1]
    b3d.FEATURES_SOURCE = b3d.FEATURES_SOURCE[:1]
    for key in ('OCC_WINDOW_CAPS', 'OCC_SMALL_CAPS', 'OCC_MID_CAPS'):
        rt[key] = rt[key][:1]
    return cfg


def iou_cfg_and_batch():
    cfg, batch = _train_cfg_and_batch()
    cfg = one_stage(cfg)
    hd = cfg.MODEL.DENSE_HEAD
    hd.SEPARATE_HEAD_CFG.HEAD_DICT['iou'] = {'out_channels': 1, 'num_conv': 2}
    hd.LOSS_CONFIG.LOSS_WEIGHTS['iou_weight'] = 1.0
    hd.POST_PROCESSING.NMS_CONFIG = {
        'NMS_TYPE': 'multi_class_nms',
        'IOU_RECTIFIER': [0.68, 0.71, 0.65, 0.65, 0.68],
        'NMS_THRESH': [0.7, 0.6, 0.55, 0.55, 0.55],
        'NMS_PRE_MAXSIZE': [64] * 5,
        'NMS_POST_MAXSIZE': [16] * 5,
    }
    return cfg, batch


@pytest.fixture(scope='module')
def iou_model():
    """Both models from the same weights, JAX's jitted value_and_grad of
    the training loss, and the port in train mode."""
    cfg, batch = iou_cfg_and_batch()
    jmodel = jdet.build_detector(cfg)
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b,
                                                  train=False), batch)
    v = random_variables(shapes, 0)
    v['params']['dense_head']['head_0']['hm_out']['bias'][:] = -2.19

    def loss_fn(params, stats, b):
        out = jmodel.apply({'params': params, 'batch_stats': stats}, b,
                           train=True, mutable=['batch_stats'])[0]
        return jdet.centerpoint_loss(cfg, out, b)

    jgrad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (jloss, jparts), jg = jgrad(v['params'], v['batch_stats'], batch)
    ctrl = _encoder_rounded(v)
    _, jg_ctrl = jgrad(ctrl['params'], ctrl['batch_stats'], batch)
    jout = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(v, batch)

    tmodel = tdet.build_detector(cfg, 'cpu')
    tmodel.load_state_dict(params_from_jax(v), strict=True)
    tb = tdet.batch_to_device(batch, 'cpu')
    with torch.no_grad():
        tout = tmodel(tb)
    tmodel.train()
    tloss, tparts = tdet.centerpoint_loss(cfg, tmodel(tb), tb)
    tloss.backward()
    tg = {n: p.grad.clone() for n, p in tmodel.named_parameters()}
    return dict(cfg=cfg, jloss=float(jloss),
                jparts={k: float(x) for k, x in jparts.items()},
                jg=tree_from_jax(jax.device_get(jg)),
                jg_ctrl=tree_from_jax(jax.device_get(jg_ctrl)),
                jout=jout, tout=tout, tloss=float(tloss.detach()),
                tparts={k: float(x.detach()) for k, x in tparts.items()},
                tg=tg)


def test_iou_head_maps_match_jax(iou_model):
    """Eval-mode head maps, the ``iou`` map included: max |diff| <= 0.03,
    mean <= 3e-3 (the tiny slice's bounds: bf16 weight rounding)."""
    jp = iou_model['jout']['pred_dicts'][0]
    tp = iou_model['tout']['pred_dicts'][0]
    assert sorted(jp) == sorted(tp) and 'iou' in tp
    for name in jp:
        err = np.abs(tp[name].numpy() - np.asarray(jp[name], np.float32))
        assert err.max() <= 0.03 and err.mean() <= 3e-3, (name, err.max())


def test_iou_boxes_target_matches_jax():
    """``iou_boxes``: each valid slot's box, 0 on the others, exactly."""
    _, batch = iou_cfg_and_batch()
    kw = dict(num_classes=5, feature_map_size=(32, 32),
              point_cloud_range=(-5.12, -5.12, -5.0, 5.12, 5.12, 3.0),
              voxel_size=(0.32, 0.32, 8.0), feature_map_stride=1,
              gaussian_overlap=0.1, min_radius=2)
    want = jcn.assign_center_targets(jnp.asarray(batch['gt_boxes']),
                                     jnp.asarray(batch['gt_mask']), **kw)
    got = tcn.assign_center_targets(torch.from_numpy(batch['gt_boxes']),
                                    torch.from_numpy(batch['gt_mask']), **kw)
    np.testing.assert_array_equal(got['iou_boxes'].numpy(),
                                  np.asarray(want['iou_boxes']))
    assert got['mask'].sum() > 0


def test_iou_loss_terms_match_jax_on_equal_head_maps():
    """``centerpoint_loss`` with the IoU head on identical f32 head maps:
    the loss and each part, ``iou_loss_head_0`` included, within 1e-5
    relative (the IoU target's clip in f32 on both sides)."""
    cfg, batch = iou_cfg_and_batch()
    rng = np.random.RandomState(5)
    pred = {'hm': rng.normal(-2, 1, (2, 32, 32, 5))}
    for name, hc in cfg.MODEL.DENSE_HEAD.SEPARATE_HEAD_CFG.HEAD_DICT.items():
        pred[name] = rng.normal(0, 0.5, (2, 32, 32, int(hc['out_channels'])))
    pred = {k: a.astype(np.float32) for k, a in pred.items()}
    gt = {'gt_boxes': batch['gt_boxes'], 'gt_mask': batch['gt_mask']}
    jl, jparts = jdet.centerpoint_loss(
        cfg, {'pred_dicts': [{k: jnp.asarray(a) for k, a in pred.items()}]},
        {k: jnp.asarray(a) for k, a in gt.items()})
    tl, tparts = tdet.centerpoint_loss(
        cfg, {'pred_dicts': [{k: torch.from_numpy(a)
                              for k, a in pred.items()}]},
        {k: torch.from_numpy(a) for k, a in gt.items()})
    assert sorted(tparts) == sorted(jparts) and 'iou_loss_head_0' in tparts
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in jparts:
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(tparts['iou_loss_head_0']) > 0


def test_iou_head_training_step_matches_jax(iou_model):
    """One training step's loss and gradients from the same weights and
    batch. Loss parts within 1% (the encoder's bf16 roundings differ).
    Gradients, not the pre-BN conv biases (rounding noise): over all
    parameters relative L2 error at most 1.25 times the control's (JAX
    against itself with its encoder weights rounded once to bf16) and
    cosine at least the control's less 0.02; the IoU head's own tensors
    (``iou_conv0``, ``iou_out``) each with cosine >= 0.9 and norm ratio in
    [2/3, 3/2]; every gradient finite."""
    m = iou_model
    assert sorted(m['tparts']) == sorted(m['jparts'])
    for k, want in m['jparts'].items():
        assert abs(m['tparts'][k] - want) <= 0.01 * abs(want), k
    assert abs(m['tloss'] - m['jloss']) <= 0.01 * abs(m['jloss'])
    jg, tg, ctrl = m['jg'], m['tg'], m['jg_ctrl']
    assert sorted(jg) == sorted(tg)
    names = [n for n in jg if not _pre_bn_bias(n)]
    cat = lambda d: torch.cat([d[n].flatten() for n in names])
    rel, cos = _rel(cat(tg), cat(jg)), _cos(cat(tg), cat(jg))
    rel_c, cos_c = _rel(cat(ctrl), cat(jg)), _cos(cat(ctrl), cat(jg))
    print(f'gradient: port vs JAX relative L2 {rel:.4f}, cosine {cos:.5f}; '
          f'control {rel_c:.4f}, {cos_c:.5f}')
    assert rel <= 1.25 * rel_c and cos >= cos_c - 0.02
    iou_names = [n for n in names if '.iou_' in n and tg[n].numel() > 1]
    assert len(iou_names) >= 3
    for n in iou_names:
        ratio = float(tg[n].double().norm() / jg[n].double().norm())
        assert _cos(tg[n], jg[n]) >= 0.9 and 2 / 3 <= ratio <= 1.5, n
    assert all(torch.isfinite(g).all() for g in tg.values())


def test_iou_head_serving_device_nms_equals_host(iou_model):
    """Serving the tiny IoU-head model: multi-class NMS on the device keeps
    what the host's multi-class NMS keeps on the same candidates, and the
    scores are the rectified ones (JAX's decode on the same head maps,
    within 1e-5)."""
    cfg, tout = iou_model['cfg'], iou_model['tout']
    boxes, scores, labels, valid = tdet.centerpoint_predict(cfg, tout)
    cands = tdet.centerpoint_predict(cfg, tout, nms_on_device=False)
    np.testing.assert_array_equal(valid.numpy(), tdet.host_nms(cfg, *cands))
    maps = {'pred_dicts': [{k: jnp.asarray(v.numpy()) for k, v in
                            tout['pred_dicts'][0].items()}]}
    jb, js, jl, jv = jdet.centerpoint_predict(cfg, maps, nms_on_device=False)
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(
        valid.numpy(), jdet.host_nms(cfg, jb, js, jl, jv))
    assert valid.sum() > 0


def test_no_backbone_2d_head_maps_match_jax():
    """A config without ``BACKBONE_2D`` (the tiny config cut to one SST
    stage): the port builds no 2D backbone, as JAX's ``_backbone_2d``
    skips it, loads JAX's weights strictly and gives its head maps within
    the tiny slice's bounds (max |diff| <= 0.03, mean <= 3e-3: bf16 weight
    rounding, ``tests/test_torch_port_model.py``)."""
    cfg, batch = _train_cfg_and_batch()
    cfg = one_stage(cfg)
    del cfg.MODEL['BACKBONE_2D']
    jmodel = jdet.build_detector(cfg)
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b,
                                                  train=False), batch)
    v = random_variables(shapes, 0)
    assert 'backbone_2d' not in v['params']
    jout = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(v, batch)
    tmodel = tdet.build_detector(cfg, 'cpu')
    assert tmodel.backbone_2d is None
    tmodel.load_state_dict(params_from_jax(v), strict=True)
    with torch.no_grad():
        tout = tmodel(tdet.batch_to_device(batch, 'cpu'))
    jp, tp = jout['pred_dicts'][0], tout['pred_dicts'][0]
    assert sorted(jp) == sorted(tp)
    for name in jp:
        err = np.abs(tp[name].numpy() - np.asarray(jp[name], np.float32))
        assert err.max() <= 0.03 and err.mean() <= 3e-3, (name, err.max())
