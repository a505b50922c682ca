"""The port's anchor-head detectors against the JAX package on the CPU.

* f32 paths within 1e-5 relative and slot for slot: ``ResidualCoder``
  encode / decode, ``limit_period``, ``nearest_bev_iou``,
  ``generate_anchors``, ``assign_anchor_targets`` (argmax and force-match
  ties, a class without a box), the focal and smooth-L1 losses,
  ``anchor_head_loss`` with the direction classifier, ``anchor_head_predict``
  (one class; F10 below), ``PillarVFE``, ``MeanVFE``, every ``sparse3d``
  function and ``VoxelBackBone8x`` level by level.
* bf16 paths (``ConvBNReLU`` / ``DeconvBNReLU``, which JAX runs in bf16):
  ``BaseBEVBackbone``, and the whole ``PointPillar`` (``tests/
  test_pointpillar.py``'s config) and ``SECONDNet`` (``tests/
  test_second.py``'s): head maps, loss and one training step's gradients
  from the same weights (``params_from_jax``, strict).
* F10: JAX's ``all_anchors_flat`` orders anchors class-major while the
  maps are location-major; the port's decode equals JAX's with the
  anchors in the maps' order, and differs from JAX's own with two
  classes.
* F11: JAX's ``VoxelBackBone8x.conv_out`` (3^3, padding 0) takes two cells
  off y and x, so the head's maps no longer have the anchors' size; the
  JAX side here pads it (0, 1, 1), as the port does. JAX's
  ``build_detector`` cannot build either family (it passes ``vfe_remat``),
  so the tests build its modules directly.
* The training and evaluation CLIs on PointPillar: one epoch, then
  ``tools.test`` with the anchor branch of the evaluator.
"""

import copy
import json
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_pointpillar import _cfg as pointpillar_cfg
from tests.test_torch_port_model import random_variables
from tests.test_torch_port_train import _cos, _rel
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.config import Cfg
from tmae_tpu.datasets.dataset import build_dataloader as j_build
from tmae_tpu.models import anchor_head as jah
from tmae_tpu.models import backbone3d_voxel as jvb
from tmae_tpu.models.bev import BaseBEVBackbone as JBaseBEV
from tmae_tpu.models.detectors import make_voxel_spec
from tmae_tpu.models.pointpillar import PointPillar as JPointPillar
from tmae_tpu.models.second_net import SECONDNet as JSECONDNet
from tmae_tpu.models.vfe import MeanVFE as JMeanVFE
from tmae_tpu.models.vfe import PillarVFE as JPillarVFE
from tmae_tpu.ops import box_coder as jbc
from tmae_tpu.ops import sparse3d as js3
from tmae_tpu.train.evaluator import make_eval_step as j_eval_step
from tmae_tpu_torch.models import anchor_head as tah
from tmae_tpu_torch.models import backbone3d_voxel as tvb
from tmae_tpu_torch.models import detectors as tdet
from tmae_tpu_torch.models.bev import BaseBEVBackbone
from tmae_tpu_torch.models.vfe import MeanVFE, PillarVFE
from tmae_tpu_torch.ops import box_coder as tbc
from tmae_tpu_torch.ops import sparse3d as ts3
from tmae_tpu_torch.tools import test as test_cli
from tmae_tpu_torch.tools import train as train_cli
from tmae_tpu_torch.train.evaluator import make_eval_step
from tmae_tpu_torch.utils.from_jax import params_from_jax, tree_from_jax

RTOL = 1e-5


def close(got, want, rtol=RTOL, what=''):
    """|got - want| <= rtol * max |want| (and <= 1e-6 at 0)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= max(rtol * np.abs(want).max(), 1e-6), (what, err)


def t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# box coder, anchors, targets, losses, decode
# ---------------------------------------------------------------------------


def random_boxes(rng, n, spread=20.0):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-2, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 5, (n, 3))
    b[:, 6] = rng.uniform(-4, 4, n)
    return b


@pytest.mark.parametrize('sincos', [False, True], ids=['angle', 'sincos'])
def test_residual_coder_and_iou_equal_jax(sincos):
    """encode / decode of boxes with an extra channel, ``limit_period``,
    ``aligned_bev_boxes`` and ``nearest_bev_iou`` within 1e-5."""
    rng = np.random.RandomState(0)
    boxes = np.concatenate([random_boxes(rng, 64),
                            rng.normal(size=(64, 1)).astype(np.float32)], -1)
    anchors = np.concatenate([random_boxes(rng, 64),
                              rng.normal(size=(64, 1)).astype(np.float32)],
                             -1)
    jc, tc = jbc.ResidualCoder(7, sincos), tbc.ResidualCoder(7, sincos)
    assert tc.code_size == jc.code_size
    enc_j = jc.encode(jnp.asarray(boxes), jnp.asarray(anchors))
    enc_t = tc.encode(t(boxes), t(anchors))
    close(enc_t, enc_j, what='encode')
    close(tc.decode(enc_t, t(anchors)), jc.decode(enc_j, jnp.asarray(anchors)),
          what='decode')
    close(tbc.limit_period(t(boxes[:, 6])),
          jbc.limit_period(jnp.asarray(boxes[:, 6])), what='limit_period')
    close(tbc.aligned_bev_boxes(t(boxes)),
          jbc.aligned_bev_boxes(jnp.asarray(boxes)), what='aligned')
    close(tbc.nearest_bev_iou(t(boxes[:40]), t(anchors)),
          jbc.nearest_bev_iou(jnp.asarray(boxes[:40]), jnp.asarray(anchors)),
          what='iou')


def anchor_cfgs(names, stride=2, align=False):
    return [{'class_name': c, 'anchor_sizes': [[4.0 - i, 2.0, 1.6]],
             'anchor_rotations': [0, 1.57],
             'anchor_bottom_heights': [-1.78 + 0.5 * i],
             'align_center': align, 'feature_map_stride': stride,
             'matched_threshold': 0.5, 'unmatched_threshold': 0.35}
            for i, c in enumerate(names)]


@pytest.mark.parametrize('align', [False, True], ids=['corner', 'center'])
def test_generate_anchors_equal_jax(align):
    cfgs = anchor_cfgs(['Car', 'Bus'], align=align)
    pc = (-5.12, -5.12, -5.0, 5.12, 5.12, 3.0)
    for a, b in zip(tah.generate_anchors(cfgs, (32, 32), pc),
                    jah.generate_anchors(cfgs, (32, 32), pc)):
        np.testing.assert_array_equal(a, b)


def tie_case():
    """Anchors and boxes of one class with an argmax tie (anchor 0 overlaps
    boxes 0 and 1 equally), a force-match tie (anchors 2 and 3 both reach
    box 2's best IoU, under the match threshold), a box of another class
    and a padding slot; sample 1 has no box of the class."""
    anchors = np.array([[0, 0, 0, 2, 2, 1, 0],
                        [10, 10, 0, 2, 2, 1, 0],
                        [-9.5, 0, 0, 2, 2, 1, 0],
                        [-10.5, 0, 0, 2, 2, 1, 0],
                        [5, -5, 0, 2, 2, 1, 1.57]], np.float32)
    gt = np.zeros((2, 5, 8), np.float32)
    gt[0, 0] = [-1, 0, 0, 2, 2, 1, 0, 1]
    gt[0, 1] = [1, 0, 0, 2, 2, 1, 0, 1]
    gt[0, 2] = [-10, 0, 0, 4, 0.5, 1, 0, 1]
    gt[0, 3] = [5, -5, 0, 2, 2, 1, 0, 2]
    gt[1, 0] = [0, 0, 0, 2, 2, 1, 0, 2]
    mask = np.array([[1, 1, 1, 1, 0], [1, 0, 0, 0, 0]], bool)
    return anchors, gt, mask


def test_assign_anchor_targets_equal_jax():
    """Labels and weights exactly, regression targets within 1e-5, on the
    tie case (both ties resolved as JAX resolves them: the first box; every
    anchor at a box's best IoU) and on random boxes."""
    coder_j, coder_t = jbc.ResidualCoder(7), tah.ResidualCoder(7)
    anchors, gt, mask = tie_case()
    rng = np.random.RandomState(1)
    ra = random_boxes(rng, 200, 8)
    rg = np.concatenate([random_boxes(rng, 12, 8)[None].repeat(2, 0),
                         rng.randint(1, 3, (2, 12, 1)).astype(np.float32)], -1)
    rm = rng.rand(2, 12) < 0.8
    for anc, g, m in ((anchors, gt, mask), (ra, rg, rm)):
        labels = g[..., 7].astype(np.int32)
        for cls in (1, 2):
            want = [jah.assign_anchor_targets(
                jnp.asarray(anc), jnp.asarray(g[b]), jnp.asarray(m[b]),
                jnp.asarray(labels[b]), cls, 0.5, 0.35, coder_j)
                for b in range(2)]
            got = tah.assign_anchor_targets(t(anc), t(g), t(m),
                                            t(labels).long(), cls, 0.5, 0.35,
                                            coder_t)
            for i, what in enumerate(('labels', 'reg', 'weights')):
                w = np.stack([np.asarray(x[i]) for x in want])
                if what == 'reg':
                    close(got[i], w, what=what)
                else:
                    np.testing.assert_array_equal(got[i].numpy(), w,
                                                  err_msg=f'{what} {cls}')
    lab = tah.assign_anchor_targets(t(anchors), t(gt), t(mask),
                                    t(gt[..., 7]).long(), 1, 0.5, 0.35,
                                    coder_t)[0]
    assert lab[0].tolist()[:4] == [1, 0, 1, 1]  # the force-match tie
    assert not lab[1].any()  # no box of the class in sample 1


def test_losses_equal_jax():
    rng = np.random.RandomState(2)
    preds = rng.normal(size=(2, 50, 3)).astype(np.float32)
    oh = (rng.rand(2, 50, 3) < 0.2).astype(np.float32)
    w = rng.uniform(0, 1, (2, 50)).astype(np.float32)
    close(tah.sigmoid_focal_loss(t(preds), t(oh), t(w)),
          jah.sigmoid_focal_loss(jnp.asarray(preds), jnp.asarray(oh),
                                 jnp.asarray(w)), what='focal')
    close(tah.smooth_l1(t(preds)), jah.smooth_l1(jnp.asarray(preds)),
          what='smooth_l1')


def head_cfg(names, use_dir=True):
    return Cfg.from_dict({
        'NAME': 'AnchorHeadSingle',
        'ANCHOR_GENERATOR_CONFIG': anchor_cfgs(names),
        'TARGET_ASSIGNER_CONFIG': {'BOX_CODER_CONFIG': {}},
        'USE_DIRECTION_CLASSIFIER': use_dir, 'DIR_OFFSET': 0.78539,
        'DIR_LIMIT_OFFSET': 0.0, 'NUM_DIR_BINS': 2,
        'LOSS_CONFIG': {'LOSS_WEIGHTS': {
            'cls_weight': 1.0, 'loc_weight': 2.0, 'dir_weight': 0.2,
            'code_weights': [1.0] * 7}}})


def heads(names, use_dir=True):
    """JAX's head (bound, no parameters needed for targets / loss /
    decode) and the port's over a 32x32 grid at stride 2."""
    cfg = head_cfg(names, use_dir)
    pc = (-5.12, -5.12, -5.0, 5.12, 5.12, 3.0)
    jh = jah.AnchorHeadSingle(cfg, len(names), tuple(names), (32, 32),
                              pc).bind({})
    th = tah.AnchorHeadSingle(cfg, 8, names, (32, 32), pc)
    return cfg, jh, th


def head_maps(rng, n_cls, A, B=2):
    f = lambda c: rng.normal(0, 0.5, (B, 16, 16, A * c)).astype(np.float32)
    return {'cls_preds': f(n_cls), 'box_preds': f(7), 'dir_cls_preds': f(2)}


@pytest.mark.parametrize('names', [['Car'], ['Car', 'Bus']],
                         ids=['one-class', 'two-class'])
def test_targets_and_loss_equal_jax(names):
    """``assign_targets`` (labels and weights exactly, targets within 1e-5)
    and ``anchor_head_loss`` with the direction classifier on equal maps,
    each part within 1e-5: the loss reads only the anchors' rotation,
    which both classes share, so JAX's anchor order (F10) does not change
    it."""
    cfg, jh, th = heads(names)
    rng = np.random.RandomState(3)
    gt = np.zeros((2, 6, 8), np.float32)
    gt[:, :4, :7] = random_boxes(rng, 8, 4).reshape(2, 4, 7)
    gt[:, :4, 7] = rng.randint(1, len(names) + 1, (2, 4))
    gt[1, 2:, 7] = 0
    mask = gt[..., 7] > 0
    jt = jh.assign_targets(jnp.asarray(gt), jnp.asarray(mask))
    tt = th.assign_targets(t(gt), t(mask))
    for k in ('box_cls_labels', 'reg_weights'):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]),
                                      err_msg=k)
    close(tt['box_reg_targets'], jt['box_reg_targets'], what='reg')
    assert (tt['box_cls_labels'] > 0).sum() > 0
    maps = head_maps(rng, len(names), th.num_anchors_per_loc)
    jl, jparts = jah.anchor_head_loss(
        jh, {k: jnp.asarray(v) for k, v in maps.items()}, jt,
        cfg.LOSS_CONFIG)
    tl, tparts = tah.anchor_head_loss(th, {k: t(v) for k, v in maps.items()},
                                      tt, cfg.LOSS_CONFIG)
    assert sorted(tparts) == sorted(jparts) == [
        'rpn_loss_cls', 'rpn_loss_dir', 'rpn_loss_loc']
    for k in jparts:
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]),
                                   rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)


def located(head):
    """JAX's anchors in the maps' order: per location, each class's."""
    return jnp.concatenate(head.anchors, axis=2).reshape(-1, 7)


def test_predict_equals_jax_one_class_and_f10():
    """``anchor_head_predict`` with the direction classifier: with one
    class equal to JAX's (logits exactly, boxes within 1e-5); with two,
    equal to JAX's decode of the anchors in the maps' order and unlike
    JAX's own (F10: its anchors are class-major)."""
    rng = np.random.RandomState(4)
    for names in (['Car'], ['Car', 'Bus']):
        cfg, jh, th = heads(names)
        maps = head_maps(rng, len(names), th.num_anchors_per_loc)
        jm = {k: jnp.asarray(v) for k, v in maps.items()}
        jc, jb = jah.anchor_head_predict(jh, jm)
        tc, tb = tah.anchor_head_predict(th, {k: t(v)
                                              for k, v in maps.items()})
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        if len(names) == 1:
            close(tb, jb, what='boxes')
            continue
        assert np.abs(tb.numpy() - np.asarray(jb)).max() > 1.0
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jah.AnchorHeadSingle, 'all_anchors_flat', located)
            _, jb_loc = jah.anchor_head_predict(jh, jm)
        close(tb, jb_loc, what='boxes, anchors per location')


# ---------------------------------------------------------------------------
# VFEs, BaseBEVBackbone, the 3D sparse convolution
# ---------------------------------------------------------------------------


def pillar_inputs(rng, B=2, V=40, T=8, C=4):
    nvox = rng.randint(0, T + 1, (B, V))
    nvox[:, -5:] = 0
    coords = rng.randint(0, 32, (B, V, 2)).astype(np.int32)
    vox = np.zeros((B, V, T, C), np.float32)
    for b in range(B):
        for v in range(V):
            n = nvox[b, v]
            base = (coords[b, v, ::-1] + 0.5) * 0.32 - 5.12
            vox[b, v, :n, :2] = base + rng.uniform(-0.16, 0.16, (n, 2))
            vox[b, v, :n, 2:] = rng.uniform(-1, 1, (n, C - 2))
    return vox, nvox, coords


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_pillar_and_mean_vfe_equal_jax(train):
    """PillarVFE (two layers, with distance) within 1e-5, its running
    statistics in train mode too; MeanVFE within 1e-6."""
    rng = np.random.RandomState(5)
    vox, nvox, coords = pillar_inputs(rng)
    spec = make_voxel_spec(pointpillar_cfg().DATA_CONFIG,
                           pointpillar_cfg().RUNTIME)
    jm = JPillarVFE(spec, [16, 24], with_distance=True)
    args = (jnp.asarray(vox), jnp.asarray(nvox), jnp.asarray(coords))
    shapes = jax.eval_shape(lambda *a: jm.init(jax.random.PRNGKey(0), *a,
                                               False), *args)
    v = random_variables(shapes, 6)
    want, upd = jm.apply(v, *args, train, mutable=['batch_stats'])
    tm = PillarVFE(spec, [16, 24], with_distance=True)
    tm.load_state_dict(params_from_jax(v), strict=True)
    tm.train(train)
    with torch.no_grad():
        got = tm(t(vox), t(nvox), t(coords))
    close(got, want, what='PillarVFE')
    if train:
        for k, w in params_from_jax({'batch_stats': jax.device_get(
                upd['batch_stats'])}).items():
            close(tm.state_dict()[k], w.numpy(), what=k)
    close(MeanVFE()(t(vox), t(nvox)),
          JMeanVFE().apply({}, jnp.asarray(vox), jnp.asarray(nvox)),
          rtol=1e-6, what='MeanVFE')


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_base_bev_backbone_equal_jax(train):
    """Two levels at stride 2, ``up0`` at stride 1, ``up1`` at 2, a third
    level taken down by a strided conv (an upsample stride of 1/2): the
    output within the bf16 bound (|diff| <= 0.03 of a unit-scale map,
    mean <= 3e-3), its running statistics within 1e-2 relative."""
    cfg = Cfg.from_dict({'NAME': 'BaseBEVBackbone', 'LAYER_NUMS': [1, 1, 1],
                         'LAYER_STRIDES': [2, 2, 1],
                         'NUM_FILTERS': [16, 32, 32],
                         'UPSAMPLE_STRIDES': [1, 2, 0.5],
                         'NUM_UPSAMPLE_FILTERS': [16, 16, 16]})
    x = np.random.RandomState(7).normal(size=(2, 32, 32, 8)).astype(
        np.float32)
    # level 3 runs at 8x8: down2 takes it to 4x4, which the concat of
    # 16x16 maps refuses; so the third level is compared on its own
    jm = JBaseBEV(cfg)
    cfg2 = copy.deepcopy(cfg)
    for k in ('LAYER_NUMS', 'LAYER_STRIDES', 'NUM_FILTERS',
              'UPSAMPLE_STRIDES', 'NUM_UPSAMPLE_FILTERS'):
        cfg2[k] = cfg[k][:2]
    for c, want_ch in ((cfg2, 32), (Cfg.from_dict(dict(
            cfg, LAYER_NUMS=[1], LAYER_STRIDES=[1], NUM_FILTERS=[16],
            UPSAMPLE_STRIDES=[0.5], NUM_UPSAMPLE_FILTERS=[16])), 16)):
        jm = JBaseBEV(c)
        shapes = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a,
                                                  False), jnp.asarray(x))
        v = random_variables(shapes, 8)
        want, upd = jm.apply(v, jnp.asarray(x), train,
                             mutable=['batch_stats'])
        tm = BaseBEVBackbone(c, 8)
        assert tm.out_channels == want_ch == want.shape[-1]
        tm.load_state_dict(params_from_jax(v), strict=True)
        tm.train(train)
        with torch.no_grad():
            got = tm(t(x)).float().numpy()
        err = np.abs(got - np.asarray(want, np.float32))
        assert err.max() <= 0.03 and err.mean() <= 3e-3, err.max()
        if train:
            for k, w in params_from_jax({'batch_stats': jax.device_get(
                    upd['batch_stats'])}).items():
                close(tm.state_dict()[k], w.numpy(), rtol=1e-2, what=k)


def voxel_set(rng, dhw=(9, 12, 10), V=48, n=40, B=2):
    D, H, W = dhw
    coords = np.zeros((B, V, 3), np.int32)
    mask = np.zeros((B, V), bool)
    for b in range(B):
        cells = rng.permutation(D * H * W)[:n]
        coords[b, :n] = np.stack([cells // (H * W), (cells // W) % H,
                                  cells % W], -1)
        mask[b, :n] = True
    return coords, mask


def test_sparse3d_functions_equal_jax():
    """``build_index_grid`` (a duplicated cell keeps the later slot),
    ``gather_neighbors`` at stride 1 and 2, ``sparse_conv3d_apply`` (1e-5)
    and ``downsample_coords_3d`` (stride 2 / padding 1, stride 2 / padding
    (0, 1, 1), stride (2, 1, 1) / padding 0 and (0, 1, 1), a cap below the
    active set) slot for slot; ``tests/test_second.py``'s case."""
    rng = np.random.RandomState(9)
    dhw = (9, 12, 10)
    coords, mask = voxel_set(rng, dhw)
    coords[0, 5] = coords[0, 2]  # a cell claimed twice
    jc, jm = jnp.asarray(coords), jnp.asarray(mask)
    tc, tm = t(coords), t(mask)
    ig_j, ig_t = js3.build_index_grid(jc, jm, dhw), ts3.build_index_grid(
        tc, tm, dhw)
    np.testing.assert_array_equal(ig_t.numpy(), np.asarray(ig_j))
    assert int(ig_t[0].eq(5).sum()) == 1 and not ig_t[0].eq(2).any()
    for stride in (1, 2):
        nb_j = js3.gather_neighbors(ig_j, jc, jm, dhw, 3, stride)
        nb_t = ts3.gather_neighbors(ig_t, tc, tm, dhw, 3, stride)
        np.testing.assert_array_equal(nb_t.numpy(), np.asarray(nb_j))
    feat = rng.normal(size=(2, 48, 6)).astype(np.float32)
    w = rng.normal(size=(27, 6, 5)).astype(np.float32) * 0.2
    close(ts3.sparse_conv3d_apply(t(feat), nb_t, t(w)),
          js3.sparse_conv3d_apply(jnp.asarray(feat), nb_j, jnp.asarray(w)),
          what='conv')
    cases = [(2, 1, 64), (2, (0, 1, 1), 64), ((2, 1, 1), 0, 64),
             ((2, 1, 1), (0, 1, 1), 64), (2, 1, 30)]
    for stride, pad, cap in cases:
        want = js3.downsample_coords_3d(jc, jm, dhw, stride, pad, 3, cap)
        got = ts3.downsample_coords_3d(tc, tm, dhw, stride, pad, 3, cap)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[2] == want[2], (stride, pad)
    one = np.zeros((1, 4, 3), np.int32)
    one[0, 0] = [1, 5, 4]
    m1 = np.array([[True, False, False, False]])
    c1, k1, out = ts3.downsample_coords_3d(t(one), t(m1), (8, 8, 8), 2, 1,
                                           3, 8)
    assert out == (4, 4, 4)
    assert {tuple(c) for c, k in zip(c1[0].tolist(), k1[0].tolist())
            if k} == {(z, y, 2) for z in (0, 1) for y in (2, 3)}


@pytest.fixture
def padded_conv_out(monkeypatch):
    """F11: JAX's VoxelBackBone8x with conv_out padded (0, 1, 1), as the
    port pads it (a factory in place of the block class, which the
    backbone looks up when it runs)."""
    orig = jvb.SparseConv3dBlock

    def block(*args, **kw):
        if kw.get('name') == 'conv_out':
            kw['padding'] = tvb.CONV_OUT_PADDING
        return orig(*args, **kw)

    monkeypatch.setattr(jvb, 'SparseConv3dBlock', block)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_voxel_backbone_equal_jax(padded_conv_out, train):
    """VoxelBackBone8x on 60 random voxels of a 41x24x20 grid: each level's
    coords, mask and dhw exactly, its features within 1e-4 of the largest
    (f32 products over 27 taps), the output's too; in train mode the
    running statistics within 1e-4."""
    rng = np.random.RandomState(10)
    dhw = (41, 24, 20)
    coords, mask = voxel_set(rng, dhw, V=64, n=60)
    feat = np.where(mask[..., None], rng.normal(size=(2, 64, 4)),
                    0).astype(np.float32)
    caps = (64, 64, 64, 48, 48)
    jm = jvb.VoxelBackBone8x({}, dhw, caps)
    args = (jnp.asarray(feat), jnp.asarray(coords), jnp.asarray(mask))
    shapes = jax.eval_shape(lambda *a: jm.init(jax.random.PRNGKey(0), *a,
                                               False), *args)
    v = random_variables(shapes, 11)
    (jx, jc, jk, jdhw, jhid), upd = jm.apply(v, *args, train,
                                             mutable=['batch_stats'])
    tm = tvb.VoxelBackBone8x(dhw, caps, 4)
    tm.load_state_dict(params_from_jax(v), strict=True)
    tm.train(train)
    with torch.no_grad():
        tx, tc, tk, tdhw, thid = tm(t(feat), t(coords), t(mask))
    for name in jhid:
        (a, ac, am, ad), (b, bc, bm, bd) = thid[name], jhid[name]
        np.testing.assert_array_equal(ac.numpy(), np.asarray(bc),
                                      err_msg=name)
        np.testing.assert_array_equal(am.numpy(), np.asarray(bm),
                                      err_msg=name)
        assert tuple(ad) == tuple(bd)
        close(a, b, rtol=1e-4, what=name)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert tdhw == jdhw and tdhw[1:] == (3, 3)
    close(tx, jx, rtol=1e-4, what='conv_out')
    close(tvb.height_compression(tx, tc, tk, tdhw),
          jvb.height_compression(jx, jc, jk, jdhw), rtol=1e-4, what='bev')
    if train:
        for k, w in params_from_jax({'batch_stats': jax.device_get(
                upd['batch_stats'])}).items():
            close(tm.state_dict()[k], w.numpy(), rtol=1e-4, what=k)


# ---------------------------------------------------------------------------
# whole detectors
# ---------------------------------------------------------------------------


def second_cfg():
    """``tests/test_second.py::test_second_net_forward``'s config."""
    names = ['Car', 'Pedestrian']
    return Cfg.from_dict({
        'CLASS_NAMES': names,
        'DATA_CONFIG': {
            'DATASET': 'SyntheticONCEDataset',
            'POINT_CLOUD_RANGE': [-5.12, -5.12, -3.0, 5.12, 5.12, 1.0],
            'DATA_SPLIT': {'train': 'train', 'test': 'val'},
            'NUM_SYNTHETIC_SAMPLES': 2, 'SYNTHETIC_POINTS': 512,
            'SYNTHETIC_BOXES': 2,
            'DATA_PROCESSOR': [
                {'NAME': 'mask_points_and_boxes_outside_range',
                 'REMOVE_OUTSIDE_BOXES': True},
                {'NAME': 'transform_points_to_voxels',
                 'VOXEL_SIZE': [0.32, 0.32, 0.1],
                 'MAX_POINTS_PER_VOXEL': 5,
                 'MAX_NUMBER_OF_VOXELS': {'train': 256, 'test': 256}},
            ],
        },
        'MODEL': {
            'NAME': 'SECONDNet',
            'VFE': {'NAME': 'MeanVFE'},
            'BACKBONE_3D': {'NAME': 'VoxelBackBone8x'},
            'BACKBONE_2D': {
                'NAME': 'BaseBEVBackbone',
                'LAYER_NUMS': [2], 'LAYER_STRIDES': [1],
                'NUM_FILTERS': [32], 'UPSAMPLE_STRIDES': [1],
                'NUM_UPSAMPLE_FILTERS': [32],
            },
            'DENSE_HEAD': {
                'NAME': 'AnchorHeadSingle',
                'ANCHOR_GENERATOR_CONFIG': [
                    {'class_name': c, 'anchor_sizes': [[4.0, 2.0, 1.6]],
                     'anchor_rotations': [0, 1.57],
                     'anchor_bottom_heights': [-1.78],
                     'align_center': False, 'feature_map_stride': 8,
                     'matched_threshold': 0.5, 'unmatched_threshold': 0.35}
                    for c in names
                ],
                'TARGET_ASSIGNER_CONFIG': {'BOX_CODER_CONFIG': {}},
                'USE_DIRECTION_CLASSIFIER': False,
                'LOSS_CONFIG': {'LOSS_WEIGHTS': {
                    'cls_weight': 1.0, 'loc_weight': 2.0,
                    'code_weights': [1.0] * 7}},
            },
        },
        'RUNTIME': {'MAX_POINTS': 768, 'MAX_VOXELS': [256, 128, 64, 64, 64],
                    'MAX_GT': 8},
        'OPTIMIZATION': {'BATCH_SIZE_PER_GPU': 2, 'NUM_EPOCHS': 1,
                         'OPTIMIZER': 'adam', 'LR': 1e-3,
                         'WEIGHT_DECAY': 0.01, 'GRAD_NORM_CLIP': 10},
    })


def _bf16_rounded(v, part='backbone_2d'):
    """The variables with ``part``'s parameters rounded once to bf16."""
    out = copy.deepcopy(v)
    out['params'][part] = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
            jnp.float32)), v['params'][part])
    return out


@pytest.fixture(scope='module', params=['PointPillar', 'SECONDNet'])
def detector(request):
    """Both packages' detector from the same weights on a loader batch:
    eval-mode head maps, the training loss and its gradients, and the
    control's gradients (JAX's, with the bf16 BEV backbone's weights
    rounded once to bf16)."""
    name = request.param
    cfg = pointpillar_cfg() if name == 'PointPillar' else second_cfg()
    cls = JPointPillar if name == 'PointPillar' else JSECONDNet
    _, loader = j_build(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=2,
                        training=True, runtime_cfg=cfg.RUNTIME, seed=0)
    batch = next(iter(loader))
    spec = make_voxel_spec(cfg.DATA_CONFIG, cfg.RUNTIME)
    with pytest.MonkeyPatch.context() as mp:
        orig = jvb.SparseConv3dBlock
        mp.setattr(jvb, 'SparseConv3dBlock', lambda *a, **kw: orig(
            *a, **dict(kw, padding=tvb.CONV_OUT_PADDING)
            if kw.get('name') == 'conv_out' else kw))
        jm = cls(model_cfg=cfg.MODEL, class_names=tuple(cfg.CLASS_NAMES),
                 spec=spec, max_voxels_per_level=tuple(cfg.RUNTIME.MAX_VOXELS))
        jb = {k: jnp.asarray(v) for k, v in batch.items() if k != 'frame_id'}
        shapes = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b,
                                                  train=False), jb)
        v = random_variables(shapes, 0)
        nx, ny, _ = spec.grid_size
        jh = jah.AnchorHeadSingle(cfg.MODEL.DENSE_HEAD, len(cfg.CLASS_NAMES),
                                  tuple(cfg.CLASS_NAMES), (nx, ny),
                                  spec.pc_range).bind({})
        jout = jax.jit(lambda v, b: jm.apply(v, b, train=False))(v, jb)

        def loss_fn(params, stats, b):
            out = jm.apply({'params': params, 'batch_stats': stats}, b,
                           train=True, mutable=['batch_stats'])[0]
            targets = jh.assign_targets(b['gt_boxes'], b['gt_mask'])
            return jah.anchor_head_loss(jh, out['anchor_outputs'], targets,
                                        cfg.MODEL.DENSE_HEAD.LOSS_CONFIG)

        jgrad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (jloss, jparts), jg = jgrad(v['params'], v['batch_stats'], jb)
        ctrl = _bf16_rounded(v)
        _, jg_ctrl = jgrad(ctrl['params'], ctrl['batch_stats'], jb)
    tm = tdet.build_detector(cfg, 'cpu')
    tm.load_state_dict(params_from_jax(v), strict=True)
    tb = tdet.batch_to_device(batch, 'cpu')
    with torch.no_grad():
        tout = tm(tb)
    tm.train()
    tloss, tparts = tdet.detector_loss(cfg, tm)(tm(tb), tb)
    tloss.backward()
    return dict(cfg=cfg, jout=jout, tout=tout, jloss=float(jloss),
                jparts={k: float(x) for k, x in jparts.items()},
                tloss=float(tloss.detach()),
                tparts={k: float(x.detach()) for k, x in tparts.items()},
                jg=tree_from_jax(jax.device_get(jg)),
                jg_ctrl=tree_from_jax(jax.device_get(jg_ctrl)),
                tg={n: p.grad.clone() for n, p in tm.named_parameters()},
                model=tm, batch=batch)


def test_detector_head_maps_equal_jax(detector):
    """Eval-mode head maps from the same weights within the bf16 bound
    (max |diff| <= 0.03, mean <= 3e-3), the same shapes."""
    jo = detector['jout']['anchor_outputs']
    to = detector['tout']['anchor_outputs']
    assert sorted(jo) == sorted(to)
    for k in jo:
        err = np.abs(to[k].numpy() - np.asarray(jo[k]))
        assert err.max() <= 0.03 and err.mean() <= 3e-3, (k, err.max())


def test_detector_training_step_equals_jax(detector):
    """The training loss and its parts within 1% (the bf16 BEV maps'
    roundings differ); the gradients, over all parameters,
    relative L2 error at most 1.25 times the control's (or 1e-3) and
    cosine at least the control's less 0.02; every gradient finite."""
    m = detector
    assert sorted(m['tparts']) == sorted(m['jparts'])
    for k, want in m['jparts'].items():
        assert abs(m['tparts'][k] - want) <= 0.01 * abs(want), k
    jg, tg, ctrl = m['jg'], m['tg'], m['jg_ctrl']
    assert sorted(jg) == sorted(tg)
    names = sorted(jg)
    cat = lambda d: torch.cat([d[n].flatten() for n in names])
    rel, cos = _rel(cat(tg), cat(jg)), _cos(cat(tg), cat(jg))
    rel_c, cos_c = _rel(cat(ctrl), cat(jg)), _cos(cat(ctrl), cat(jg))
    print(f'gradient: port vs JAX relative L2 {rel:.5f}, cosine {cos:.6f}; '
          f'control {rel_c:.5f}, {cos_c:.6f}')
    assert rel <= max(1.25 * rel_c, 1e-3) and cos >= cos_c - 0.02
    assert all(torch.isfinite(g).all() for g in tg.values())


def test_evaluator_anchor_branch_equals_jax():
    """The evaluator's anchor branch on the one-class PointPillar with the
    direction classifier. On the port's head maps, the port's candidates
    equal those of JAX's evaluator code (``train/evaluator.py:60-77``: the
    top K of each anchor's best sigmoid score, JAX's decode): boxes within
    1e-5, scores within 1e-6, labels and order exactly, and the host NMS
    keeps the same of them. JAX's own ``make_eval_step`` from the same
    weights gives the same top-K scores within the bf16 bound (2e-3,
    sorted: near ties may swap)."""
    cfg = pointpillar_cfg()
    cfg.CLASS_NAMES = ['Car']
    hd = cfg.MODEL.DENSE_HEAD
    hd.ANCHOR_GENERATOR_CONFIG = hd.ANCHOR_GENERATOR_CONFIG[:1]
    hd.USE_DIRECTION_CLASSIFIER = True
    cfg.MODEL.POST_PROCESSING = {'NMS_CONFIG': {
        'NMS_TYPE': 'nms_gpu', 'NMS_THRESH': 0.1, 'NMS_PRE_MAXSIZE': 500,
        'NMS_POST_MAXSIZE': 83}}
    _, loader = j_build(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=2,
                        training=False, runtime_cfg=cfg.RUNTIME, seed=0)
    batch = next(iter(loader))
    spec = make_voxel_spec(cfg.DATA_CONFIG, cfg.RUNTIME)
    jm = JPointPillar(model_cfg=cfg.MODEL, class_names=('Car',), spec=spec,
                      max_voxels_per_level=(128,))
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != 'frame_id'}
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b,
                                              train=False), jb)
    v = random_variables(shapes, 2)
    tm = tdet.build_detector(cfg, 'cpu')
    tm.load_state_dict(params_from_jax(v), strict=True)
    tb = tdet.batch_to_device(batch, 'cpu')
    got = make_eval_step(tm, cfg)(tb)
    with torch.no_grad():
        maps = {k: jnp.asarray(a.numpy()) for k, a in
                tm(tb)['anchor_outputs'].items()}
    nx, ny, _ = spec.grid_size
    jh = jah.AnchorHeadSingle(hd, 1, ('Car',), (nx, ny),
                              spec.pc_range).bind({})
    cls_preds, boxes = jah.anchor_head_predict(jh, maps)
    probs = jax.nn.sigmoid(cls_preds)
    top, idx = jax.lax.top_k(jnp.max(probs, -1), 500)
    want = (jnp.take_along_axis(boxes, idx[..., None], axis=1), top,
            jnp.take_along_axis(jnp.argmax(probs, -1) + 1, idx, axis=1),
            jnp.ones_like(top, bool))
    close(got[0], want[0], what='boxes')
    np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=1e-6)
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    assert got[3].all() and got[4] == 0 and got[1].shape == (2, 500)
    keep = tdet.host_nms(cfg, *got[:4])
    assert 0 < keep.sum() < keep.size
    np.testing.assert_array_equal(keep, tdet.host_nms(cfg, *map(
        np.asarray, want)))
    j_scores = np.asarray(jax.device_get(j_eval_step(jm, cfg)(v, jb))[1])
    assert np.abs(np.sort(j_scores) - np.sort(got[1])).max() <= 2e-3


def test_chip_smoke_pointpillar_config_equals_the_test_config():
    """chip_smoke.py phase 19e runs tests/test_pointpillar.py's config from
    a copy (it loads none of the JAX package's tests): the copy must stay
    equal to it."""
    import chip_smoke

    assert chip_smoke.POINTPILLAR_CFG == json.loads(json.dumps(
        pointpillar_cfg()))


def test_build_and_refusals():
    """``build_detector`` builds PointPillar and SECONDNet (with
    graph_rcnn_once.yaml's first stage); GraphRCNN with a camera backbone,
    once refused, now builds on that first stage with DLASeg
    (``img_backbone``), and an image backbone other than DLASeg raises,
    naming it (GraphRCNN itself: tests/test_torch_port_graph_rcnn.py and
    tests/test_torch_port_camera.py; SSD3D:
    tests/test_torch_port_ssd3d.py)."""
    from tmae_tpu_torch.config import cfg_from_yaml_file

    assert type(tdet.build_detector(pointpillar_cfg(), 'cpu')).__name__ == (
        'PointPillar')
    for name in ('GraphRCNN',):
        cfg = second_cfg()
        cfg.MODEL.NAME = name
        cfg.MODEL.ROI_HEAD = cfg_from_yaml_file(
            'tools/cfgs/once_models/graph_rcnn_once.yaml').MODEL.ROI_HEAD
        cfg.MODEL.IMG_BACKBONE = {'NAME': 'DLASeg'}
        model = tdet.build_detector(cfg, 'cpu')
        assert type(model.img_backbone).__name__ == 'DLASeg'
        cfg.MODEL.IMG_BACKBONE = {'NAME': 'ResNet'}
        with pytest.raises(NotImplementedError, match='ResNet'):
            tdet.build_detector(cfg, 'cpu')


def test_cli_pointpillar_train_and_evaluate(tmp_path, monkeypatch):
    """``tools.train`` one epoch of PointPillar (its loss through the
    model's head, finite), then ``tools.test``: result.pkl with the
    synthetic frames in order, every AP finite."""
    monkeypatch.setattr(train_cli, 'OUTPUT_ROOT', tmp_path / 'output')
    monkeypatch.setattr(test_cli, 'OUTPUT_ROOT', tmp_path / 'output')
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    cfg = json.loads(json.dumps(pointpillar_cfg()))
    cfg['MODEL']['DENSE_HEAD']['USE_DIRECTION_CLASSIFIER'] = True
    cfg['MODEL']['DENSE_HEAD']['LOSS_CONFIG']['LOSS_WEIGHTS'][
        'dir_weight'] = 0.2
    cfg['MODEL']['POST_PROCESSING'] = {'NMS_CONFIG': {
        'NMS_TYPE': 'nms_gpu', 'NMS_THRESH': 0.1, 'NMS_PRE_MAXSIZE': 500,
        'NMS_POST_MAXSIZE': 50}}
    path = tmp_path / 'cfgs' / 'once_models' / 'pointpillar.yaml'
    path.parent.mkdir(parents=True)
    path.write_text(yaml.safe_dump(cfg))
    run = train_cli.main(['--cfg_file', str(path), '--device', 'cpu',
                          '--fix_random_seed', '--epochs', '1'])
    assert run['steps'] and all(np.isfinite(s['loss'])
                                for s in run['steps'])
    (rdir, ap), = test_cli.main(['--cfg_file', str(path), '--device', 'cpu',
                                 '--ckpt', str(run['checkpoints'][-1])]
                                ).items()
    annos = pickle.loads((rdir / 'result.pkl').read_bytes())
    assert [a['frame_id'] for a in annos] == ['synth_000000', 'synth_000001']
    aps = [v for k, v in ap.items() if k.startswith('AP_')]
    assert aps and all(np.isfinite(aps))
