"""The port's GraphRCNN without cameras against the JAX package on the CPU.

* The RoI pools (``ops/roi_pool.py``): ``roipoint_pool3d``,
  ``roiaware_pool3d`` and ``roilocal_dfvs_pool3d`` on overlapping, masked,
  empty and overfull boxes: which points each box takes and the empty
  flags exactly (every point carries a distinct feature, so the pooled
  features name the points), canonical coordinates within 1e-5.
* ``models/roi_head.py``: ``proposal_layer`` exactly (ties among the
  scores too); ``sample_rois_for_rcnn`` and ``assign_roi_targets`` with
  JAX's uniform draw handed over: the IoUs within 1e-5 and, where no IoU
  lies within 1e-5 of a threshold, every decision exactly (ties among the
  priorities too); ``decode_rcnn_boxes``, ``corner_loss`` and
  ``roi_head_loss`` with its gradients within 1e-5 relative.
* ``models/graph_rcnn.py`` at the tiny config of ``tests/
  test_graph_rcnn.py`` (its anchors at the backbone's stride 8, JAX's
  conv_out padded as in F11): ``AttnGNNLayer`` and ``GraphRCNNHead`` in
  eval and train mode (JAX's dropout keep masks handed over; the running
  statistics too) within 1e-4; the whole eval forward after a strict load
  (the first stage's maps within the bf16 bound of
  ``tests/test_torch_port_anchor.py``, the proposals exactly, the second
  stage on JAX's proposals within 1e-4) and ``graph_rcnn_predict``; one
  train-mode loss on JAX's proposals, draw and masks, its parts within 1%
  and its gradients held to the control (JAX's own gradients from the BEV
  backbone's weights rounded once to bf16), as the anchor families' step.
* A background RoI whose residuals overflow leaves the corner loss and
  its gradients finite, as JAX's.
* F15: JAX's ``build_detector`` cannot build GraphRCNN (``vfe_remat``), and
  JAX's evaluator cannot evaluate it (its host NMS reads the dense head's
  ``POST_PROCESSING``, which graph_rcnn_once.yaml does not have); the port
  builds the shipped config, with a camera branch too
  (``tests/test_torch_port_camera.py`` holds that branch), and evaluates
  it through ``tools.test`` on the candidates cut by score and sorted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_anchor import _bf16_rounded, close
from tests.test_torch_port_model import random_variables
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.models import roi_head as jrh
from tmae_tpu.ops import box_coder as jbc
from tmae_tpu.ops import losses as jlosses
from tmae_tpu.ops import roi_pool as jrp
from tmae_tpu_torch.models import roi_head as trh
from tmae_tpu_torch.ops import box_coder as tbc
from tmae_tpu_torch.ops import losses as tlosses
from tmae_tpu_torch.ops import roi_pool as trp

COORD_TOL = 1e-5   # f32 coordinates: another cos / sin and order
IOU_TOL = 1e-5     # an IoU; a decision is compared when this far from its
                   # threshold
SAMPLER_CFG = {    # graph_rcnn_once.yaml's, R = 56 of 64 RoIs (48 valid)
    'ROI_PER_IMAGE': 56, 'FG_RATIO': 0.5, 'REG_FG_THRESH': 0.55,
    'CLS_FG_THRESH': 0.75, 'CLS_BG_THRESH': 0.25, 'CLS_BG_THRESH_LO': 0.1,
    'HARD_BG_RATIO': 0.8, 'CLS_SCORE_TYPE': 'roi_iou',
    'SAMPLE_ROI_BY_EACH_CLASS': False}
LOSS_CFG = {'LOSS_WEIGHTS': {'rcnn_cls_weight': 1.0, 'rcnn_reg_weight': 1.0,
                             'rcnn_corner_weight': 1.0,
                             'code_weights': [1.0] * 7},
            'CORNER_LOSS_REGULARIZATION': True,
            'CLS_LOSS': 'BinaryCrossEntropy',
            'REG_LOSS': 'WeightedSmoothL1Loss'}


def J(*a):
    return [jnp.asarray(x) for x in a]


def T(*a):
    return [torch.from_numpy(np.asarray(x)) for x in a]


def np_(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


# ---------------------------------------------------------------------------
# RoI pools
# ---------------------------------------------------------------------------


def pool_inputs(seed=0, B=2, P=300, M=12):
    """Points [B, P, 5] whose channel 3 names each point (distinct), a
    tenth masked out; boxes [B, M, 7]: box 1 over box 0 (its points go to
    box 0), box 2 holding more than K points, box 3 empty, box M-2
    masked."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((B, P, 5), np.float32)
    pts[..., :2] = rng.uniform(-6, 6, (B, P, 2))
    pts[..., 2] = rng.uniform(-1.5, 1.5, (B, P))
    pts[..., 3] = np.arange(B * P).reshape(B, P) + 1.0
    pts[..., 4] = rng.uniform(0, 1, (B, P))
    pmask = rng.uniform(size=(B, P)) > 0.1
    boxes = np.zeros((B, M, 7), np.float32)
    boxes[..., :2] = rng.uniform(-5, 5, (B, M, 2))
    boxes[..., 2] = rng.uniform(-0.5, 0.5, (B, M))
    boxes[..., 3:6] = rng.uniform(0.8, 4.0, (B, M, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (B, M))
    boxes[:, 1] = boxes[:, 0]
    boxes[:, 1, 3:5] *= 1.5
    boxes[:, 2, 3:5] = 9.0
    boxes[:, 3, :2] = 40.0
    bmask = np.ones((B, M), bool)
    bmask[:, -2] = False
    return pts, pmask, boxes, bmask


def same_pool(got, want):
    """Pooled [..., 3 + C]: features exactly (the points and their order),
    canonical xyz within COORD_TOL."""
    got, want = np_(got), np_(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 3:], want[..., 3:])
    assert np.abs(got[..., :3] - want[..., :3]).max() <= COORD_TOL


@pytest.mark.parametrize('K', [8, 64])
def test_roipoint_pool3d_equals_jax(K):
    """Each box's first K points in list order, then repeated; a point
    goes to the first box that holds it (box 1 stays empty of box 0's
    points); the empty and masked boxes give zeros and the flag."""
    pts, pm, bx, bm = pool_inputs()
    jp, je = jrp.roipoint_pool3d(*J(pts, pm, bx, bm), K)
    tp, te = trp.roipoint_pool3d(*T(pts, pm, bx, bm), K)
    same_pool(tp, jp)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert te[:, 3].all() and te[:, -2].all() and not te[:, 2].any()
    # box 2 holds more than K points: all K slots distinct
    names = tp[0, 2, :, 3]
    assert len(set(names.tolist())) == K


def test_roiaware_pool3d_equals_jax():
    """The 4^3 grid of max-pooled features over each box's first 32
    points, exactly (cells without a point, empty and masked boxes 0)."""
    pts, pm, bx, bm = pool_inputs(1)
    args = (pts, pm, pts[..., 3:], bx, bm)
    want = np.asarray(jrp.roiaware_pool3d(*J(*args), out_size=4,
                                          num_sampled=32))
    got = trp.roiaware_pool3d(*T(*args), out_size=4, num_sampled=32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < (want != 0).mean() < 0.9


def test_roilocal_dfvs_pool3d_equals_jax():
    """The DFVS pool: 32 gathered points a box, then the 8 D-FPS picks
    (repeated points last), the same points in the same order."""
    pts, pm, bx, bm = pool_inputs(2)
    jo, je = jrp.roilocal_dfvs_pool3d(*J(pts, pm, bx, bm),
                                      num_dvs_points=32, num_fps_points=8)
    to, te = trp.roilocal_dfvs_pool3d(*T(pts, pm, bx, bm),
                                      num_dvs_points=32, num_fps_points=8)
    same_pool(to, jo)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert (np_(jo)[..., 3] > 0).sum() > 50


# ---------------------------------------------------------------------------
# proposals, sampler, targets, losses
# ---------------------------------------------------------------------------


def proposal_inputs(seed=0, B=2, N=40, C=3):
    """Anchor class probabilities with ties (equal best scores) and boxes
    in clusters, so that NMS removes some."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, N, 7), np.float32)
    centres = rng.uniform(-10, 10, (B, 8, 2))
    boxes[..., :2] = centres[:, rng.randint(0, 8, N)][
        np.arange(B)[:, None], np.arange(N)] + rng.normal(0, 0.4, (B, N, 2))
    boxes[..., 2] = rng.uniform(-1, 0, (B, N))
    boxes[..., 3:6] = [4.0, 2.0, 1.6]
    boxes[..., 6] = rng.uniform(-0.3, 0.3, (B, N))
    cls = rng.uniform(0, 1, (B, N, C)).astype(np.float32)
    cls[:, 5:9] = cls[:, 4:5]  # rows 4-8 tie
    valid = np.ones((B, N), bool)
    valid[1, -3:] = False
    return cls, boxes, valid


@pytest.mark.parametrize('pre,post', [(32, 12), (40, 40)])
def test_proposal_layer_equals_jax(pre, post):
    cls, boxes, valid = proposal_inputs()
    cfg = {'NMS_PRE_MAXSIZE': pre, 'NMS_THRESH': 0.3}
    want = jrh.proposal_layer(*J(cls, boxes, valid), cfg, post)
    got = trh.proposal_layer(*T(cls, boxes, valid), cfg, post)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_(g), np.asarray(w))
    assert 0 < int(got[3].sum()) < got[3].numel()


def sampler_inputs(seed=3, B=2, N=64, G=6):
    """RoIs [B, N, 7]: jittered copies of the ground truth (IoUs across
    every band), the rest apart, 16 masked; ground truth [B, G, 8] with
    two masked."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((B, G, 8), np.float32)
    gt[..., :2] = rng.uniform(-15, 15, (B, G, 2))
    gt[..., 2] = rng.uniform(-1, 0, (B, G))
    gt[..., 3:6] = rng.uniform(1.0, 4.5, (B, G, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (B, G))
    gt[..., 7] = rng.randint(1, 4, (B, G))
    gmask = np.ones((B, G), bool)
    gmask[:, -2:] = False
    src = rng.randint(0, G - 2, (B, N))
    rois = gt[np.arange(B)[:, None], src, :7] + rng.normal(
        0, 1, (B, N, 7)).astype(np.float32) * [0.5, 0.5, 0.3, 0.3, 0.3, 0.2,
                                               0.3]
    rois = rois.astype(np.float32)
    rois[..., 3:6] = np.abs(rois[..., 3:6]) + 0.3
    rois[:, 40:, :2] += 60.0
    rmask = np.ones((B, N), bool)
    rmask[:, 24:40] = False
    scores = rng.uniform(0, 1, (B, N)).astype(np.float32)
    labels = rng.randint(1, 4, (B, N)).astype(np.int32)
    u = np.array(jax.vmap(lambda k: jax.random.uniform(k, (N,)))(
        jax.random.split(jax.random.PRNGKey(seed), B)))
    return rois, scores, labels, rmask, gt, gmask, u


def sampler_thresholds(cfg):
    return [float(cfg[k]) for k in ('REG_FG_THRESH', 'CLS_FG_THRESH',
                                    'CLS_BG_THRESH', 'CLS_BG_THRESH_LO')]


@pytest.fixture(scope='module')
def sampled():
    """sampler_inputs, and JAX's and the port's ``assign_roi_targets`` of
    them on JAX's draw."""
    rois, scores, labels, rmask, gt, gmask, u = sampler_inputs()
    want = jax.jit(lambda *a: jrh.assign_roi_targets(
        jax.random.PRNGKey(3), *a, SAMPLER_CFG))(
        *J(rois, scores, labels, rmask, gt, gmask))
    got = trh.assign_roi_targets(*T(rois, scores, labels.astype(np.int64),
                                    rmask, gt, gmask), SAMPLER_CFG,
                                 uniform=torch.from_numpy(u))
    return {'inputs': (rois, scores, labels, rmask, gt, gmask),
            'want': want, 'got': got}


def test_sample_and_assign_targets_equal_jax(sampled):
    """JAX's draw handed over (``jax.random.uniform`` of each sample's
    split key, as ``sample_rois_for_rcnn`` draws it): the IoUs within
    IOU_TOL of JAX's; with no IoU within IOU_TOL of a threshold, every
    sampled RoI, mask, label, IoU and target exactly (canonical ground
    truth within COORD_TOL); the 16 masked RoIs tie at priority -1 and
    the first 8 fill the last slots in index order."""
    from tmae_tpu.ops.geometry import boxes_iou3d as j_iou3d
    from tmae_tpu_torch.ops.geometry import boxes_iou_pairs

    rois, scores, labels, rmask, gt, gmask = sampled['inputs']
    want_iou = np.asarray(jax.vmap(j_iou3d)(jnp.asarray(rois),
                                            jnp.asarray(gt[..., :7])))
    want_iou = np.where(gmask[:, None, :] & rmask[:, :, None], want_iou, 0)
    got_iou = boxes_iou_pairs(*T(rois, gt), '3d', *T(rmask, gmask)).numpy()
    assert np.abs(got_iou - want_iou).max() <= IOU_TOL
    ov = want_iou.max(-1)
    assert min(np.abs(ov - t).min() for t in sampler_thresholds(
        SAMPLER_CFG)) > IOU_TOL  # the premise of exact decisions
    bands = [(ov >= 0.55).sum(), ((ov > 0.1) & (ov < 0.55)).sum(),
             (ov < 0.1).sum()]
    assert min(bands) >= 5, bands
    want, got = sampled['want'], sampled['got']
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np_(got[k]), np.asarray(want[k])
        if k in ('gt_of_rois', 'gt_iou_of_rois', 'rcnn_cls_labels'):
            assert np.abs(g - w).max() <= COORD_TOL, k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    m = np_(got['roi_mask'])
    assert m.sum() == 2 * 48 and not m[:, -8:].any()
    np.testing.assert_array_equal(np_(got['rois'])[:, -8:], rois[:, 24:32])
    assert np_(got['reg_valid_mask']).sum() > 0


def rcnn_outputs(seed, B, R):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 1.5, (B, R, 1)).astype(np.float32),
            rng.normal(0, 0.3, (B, R, 7)).astype(np.float32))


def test_decode_corner_loss_and_roi_head_loss_equal_jax(sampled):
    """On the sampler's targets: ``decode_rcnn_boxes`` and the corner loss
    within COORD_TOL relative; ``roi_head_loss``'s parts within 1e-5
    relative and its gradients in the class and box outputs within 1e-5
    of the largest."""
    want_t, got_t = sampled['want'], sampled['got']
    cls, reg = rcnn_outputs(4, 2, SAMPLER_CFG['ROI_PER_IMAGE'])
    jc, tc = jbc.ResidualCoder(code_size=7), tbc.ResidualCoder(7)
    dec_w = np.asarray(jrh.decode_rcnn_boxes(jnp.asarray(reg),
                                             want_t['rois'], jc))
    dec_g = trh.decode_rcnn_boxes(torch.from_numpy(reg), got_t['rois'], tc)
    assert np.abs(np_(dec_g) - dec_w).max() <= COORD_TOL * np.abs(
        dec_w).max()
    cw = np.asarray(jlosses.corner_loss(jnp.asarray(dec_w[..., :7]),
                                        want_t['gt_of_rois_src'][..., :7]))
    cg = tlosses.corner_loss(dec_g[..., :7],
                             got_t['gt_of_rois_src'][..., :7])
    assert np.abs(np_(cg) - cw).max() <= COORD_TOL * np.abs(cw).max()

    def jloss(c, r):
        return jrh.roi_head_loss(c, r, want_t, jc, LOSS_CFG)

    (jl, jparts), (gc, gr) = jax.value_and_grad(jloss, argnums=(0, 1),
                                                has_aux=True)(
        jnp.asarray(cls), jnp.asarray(reg))
    tcls = torch.from_numpy(cls).requires_grad_()
    treg = torch.from_numpy(reg).requires_grad_()
    tl, tparts = trh.roi_head_loss(tcls, treg, got_t, tc, LOSS_CFG)
    tl.backward()
    assert sorted(tparts) == sorted(jparts)
    for k, w in jparts.items():
        assert abs(float(tparts[k].detach()) - float(w)) <= 1e-5 * abs(
            float(w)), k
    for g, w in ((tcls.grad, gc), (treg.grad, gr)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize('what', ['residual', 'roi'])
def test_a_background_roi_leaves_the_corner_loss_finite(sampled, what):
    """A background RoI whose residuals decode to a box of infinite size
    (exp overflows), or whose RoI is so large (1e20 m) that its corners'
    distances overflow: JAX's corner loss masks it out (its product with
    the foreground mask comes out as a select), and the port, which takes
    only the foreground's corner terms and decodes only their residuals,
    gives the same loss within 1e-5 and finite gradients (a product with a
    float mask gave NaN: 24c's loss on the card)."""
    want_t, got_t = dict(sampled['want']), dict(sampled['got'])
    fg = np_(got_t['reg_valid_mask'])
    b, r = np.argwhere(~fg & np_(got_t['roi_mask']))[0]
    cls, reg = rcnn_outputs(5, 2, SAMPLER_CFG['ROI_PER_IMAGE'])
    if what == 'residual':
        reg[b, r, 3] = 200.0  # exp(200) overflows f32
    else:
        rois = np_(got_t['rois']).copy()
        rois[b, r, 3:6] = 1e20
        want_t['rois'] = jnp.asarray(rois)
        got_t['rois'] = torch.from_numpy(rois)
    want, _ = jrh.roi_head_loss(jnp.asarray(cls), jnp.asarray(reg), want_t,
                                jbc.ResidualCoder(code_size=7), LOSS_CFG)
    treg = torch.from_numpy(reg).requires_grad_()
    got, parts = trh.roi_head_loss(torch.from_numpy(cls), treg, got_t,
                                   tbc.ResidualCoder(7), LOSS_CFG)
    got.backward()
    assert np.isfinite(float(want))
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
    assert torch.isfinite(treg.grad).all()
    assert float(parts['rcnn_loss_corner'].detach()) > 0


# ---------------------------------------------------------------------------
# the second stage and the whole detector
# ---------------------------------------------------------------------------

def tiny_cfg():
    """``tests/test_graph_rcnn.py::test_graph_rcnn_end_to_end``'s model
    (anchors at the backbone's stride 8: the map is 4 x 4 with F11's
    padding) on a 32 x 32 x 40 grid, as a full config for the port."""
    from tmae_tpu_torch.config import Cfg

    return Cfg.from_dict({
        'CLASS_NAMES': ['Car'],
        'DATA_CONFIG': {
            'DATASET': 'SyntheticONCEDataset',
            'POINT_CLOUD_RANGE': [-6.4, -6.4, -2.0, 6.4, 6.4, 2.0],
            'DATA_PROCESSOR': [{'NAME': 'transform_points_to_voxels',
                                'VOXEL_SIZE': [0.4, 0.4, 0.1],
                                'MAX_POINTS_PER_VOXEL': 5,
                                'MAX_NUMBER_OF_VOXELS': {'train': 64,
                                                         'test': 64}}]},
        'MODEL': {
            'NAME': 'GraphRCNN',
            'BACKBONE_3D': {'NAME': 'VoxelBackBone8x'},
            'BACKBONE_2D': {
                'NAME': 'BaseBEVBackbone', 'LAYER_NUMS': [2],
                'LAYER_STRIDES': [1], 'NUM_FILTERS': [32],
                'UPSAMPLE_STRIDES': [1], 'NUM_UPSAMPLE_FILTERS': [32]},
            'DENSE_HEAD': {
                'NAME': 'AnchorHeadSingle',
                'ANCHOR_GENERATOR_CONFIG': [
                    {'class_name': 'Car', 'anchor_sizes': [[1.6, 1.2, 1.2]],
                     'anchor_rotations': [0, 1.57],
                     'anchor_bottom_heights': [-1.0], 'align_center': False,
                     'feature_map_stride': 8, 'matched_threshold': 0.5,
                     'unmatched_threshold': 0.35}],
                'TARGET_ASSIGNER_CONFIG': {'BOX_CODER_CONFIG': {}},
                'LOSS_CONFIG': {'LOSS_WEIGHTS': {
                    'cls_weight': 1.0, 'loc_weight': 2.0,
                    'code_weights': [1.0] * 7}}},
            'ROI_HEAD': {
                'NAME': 'GraphRCNNHead',
                'NMS_CONFIG': {
                    'TRAIN': {'NMS_PRE_MAXSIZE': 32, 'NMS_THRESH': 0.8,
                              'NMS_POST_MAXSIZE': 16},
                    'TEST': {'NMS_PRE_MAXSIZE': 32, 'NMS_THRESH': 0.7,
                             'NMS_POST_MAXSIZE': 8}},
                'TARGET_CONFIG': {
                    'BOX_CODER': 'ResidualCoder', 'ROI_PER_IMAGE': 8,
                    'FG_RATIO': 0.5, 'REG_FG_THRESH': 0.55,
                    'CLS_FG_THRESH': 0.6, 'CLS_BG_THRESH': 0.45,
                    'CLS_BG_THRESH_LO': 0.1, 'HARD_BG_RATIO': 0.8,
                    'CLS_SCORE_TYPE': 'roi_iou',
                    'SAMPLE_ROI_BY_EACH_CLASS': False},
                'DFVS_CONFIG': {'NUM_DVS_POINTS': 16, 'NUM_FPS_POINTS': 8,
                                'POOL_EXTRA_WIDTH': 0.5},
                'ATTN_GNN_CONFIG': {'K': 4, 'MLPS': [16, 16],
                                    'CALIB_DIM': 16, 'EXP_MLPS': [32],
                                    'OUT_DIM': 32, 'USE_REDUCTION': True,
                                    'USE_SHORT_CUT': True,
                                    'USE_FEATS_DIS': False},
                'LOSS_CONFIG': LOSS_CFG},
            'POST_PROCESSING': {
                'RECALL_THRESH_LIST': [0.3, 0.5, 0.7], 'SCORE_THRESH': 0.1,
                'EVAL_METRIC': 'once',
                'NMS_CONFIG': {'NMS_TYPE': 'nms_gpu', 'NMS_THRESH': 0.7,
                               'NMS_PRE_MAXSIZE': 8,
                               'NMS_POST_MAXSIZE': 8}}},
        'RUNTIME': {'MAX_POINTS': 128, 'MAX_VOXELS': [64] * 5, 'MAX_GT': 2},
        'OPTIMIZATION': {'BATCH_SIZE_PER_GPU': 2, 'NUM_EPOCHS': 1,
                         'OPTIMIZER': 'adam', 'LR': 1e-3,
                         'WEIGHT_DECAY': 0.01, 'GRAD_NORM_CLIP': 10}})


def tiny_batch(gt=None, seed=0, B=2, V=64, P=128):
    """Random voxels (as ``tests/test_graph_rcnn.py``'s) and points inside
    the range, two ground-truth boxes a sample."""
    rng = np.random.RandomState(seed)
    nx = ny = 32
    nz = 40
    coords = np.stack([np.c_[rng.randint(0, nz, V), rng.randint(0, ny, V),
                             rng.randint(0, nx, V)] for _ in range(B)])
    pts = np.zeros((B, P, 4), np.float32)
    pts[..., :2] = rng.uniform(-4, 4, (B, P, 2))
    pts[..., 2] = rng.uniform(-1.5, 1.0, (B, P))
    pts[..., 3] = rng.uniform(0, 1, (B, P))
    if gt is None:
        gt = np.tile(np.array([[[0, 0, -0.4, 1.6, 1.2, 1.2, 0.1, 1],
                                [1.5, 1.5, -0.4, 1.6, 1.2, 1.2, -0.3, 1]]],
                              np.float32), (B, 1, 1))
    return {'voxels': rng.randn(B, V, 5, 4).astype(np.float32),
            'voxel_num_points': rng.randint(1, 5, (B, V)).astype(np.int32),
            'voxel_coords_zyx': coords.astype(np.int32),
            'voxel_mask': np.ones((B, V), bool),
            'points': pts, 'point_mask': rng.uniform(size=(B, P)) > 0.05,
            'gt_boxes': gt.astype(np.float32),
            'gt_mask': np.ones(gt.shape[:2], bool)}


@pytest.fixture
def padded_conv_out(monkeypatch):
    """F11: JAX's VoxelBackBone8x with conv_out padded as the port pads
    it."""
    from tmae_tpu.models import backbone3d_voxel as jvb
    from tmae_tpu_torch.models import backbone3d_voxel as tvb

    orig = jvb.SparseConv3dBlock
    monkeypatch.setattr(jvb, 'SparseConv3dBlock', lambda *a, **kw: orig(
        *a, **dict(kw, padding=tvb.CONV_OUT_PADDING)
        if kw.get('name') == 'conv_out' else kw))


class Recorder:
    """Records the outputs of the JAX package's dropout draws
    (``jax.random.bernoulli``, which flax's ``nn.Dropout`` calls) and of
    GraphRCNN's ``proposal_layer`` while the module runs (under ``jit``
    the traced values, which the compiled function then returns)."""

    def __init__(self, monkeypatch):
        from tmae_tpu.models import graph_rcnn as jgr

        self.keep, self.proposals = [], []
        bern, prop = jax.random.bernoulli, jgr.proposal_layer

        def bernoulli(*a, **kw):
            out = bern(*a, **kw)
            self.keep.append(out)
            return out

        def proposal_layer(*a, **kw):
            out = prop(*a, **kw)
            self.proposals.append(list(out))
            return out

        monkeypatch.setattr(jax.random, 'bernoulli', bernoulli)
        monkeypatch.setattr(jgr, 'proposal_layer', proposal_layer)


def keep_masks(keep):
    return [torch.from_numpy(np.array(k)) for k in keep]


def recorded_train_apply(jm, key, dkey):
    """The compiled train-mode apply with one proposal and one dropout
    key: (outputs, updated statistics, keep masks, proposals)."""
    def run(v, b):
        with pytest.MonkeyPatch.context() as rp:
            rec = Recorder(rp)
            out, upd = jm.apply(v, b, True, proposal_rng=key,
                                mutable=['batch_stats'],
                                rngs={'dropout': dkey})
        return out, upd, rec.keep, rec.proposals[0]
    return jax.jit(run)


def jax_stats(upd):
    from tmae_tpu_torch.utils.from_jax import params_from_jax

    return params_from_jax({'batch_stats': jax.device_get(
        upd['batch_stats'])})


def attn_inputs(seed=5, B=2, M=6, K=8, C=7):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-1, 1, (B, M, K, 3)).astype(np.float32)
    xyz[:, :, K // 2:] = xyz[:, :, :K // 2]  # repeated points: equal
    feats = rng.normal(size=(B, M, K, C)).astype(np.float32)
    mask = np.ones((B, M), bool)
    mask[0, -1] = mask[1, 2] = False
    return xyz, feats, mask


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_attn_gnn_layer_equals_jax(train, monkeypatch):
    """AttnGNNLayer (tiny config: k 4 of 8 points with distance ties among
    the repeated points, two edge layers, calibration, reduction,
    shortcut) from the same weights: the output within 1e-4 of the
    largest; in train mode on JAX's keep masks, the running statistics
    within 1e-4."""
    from tmae_tpu.models.graph_rcnn import AttnGNNLayer as JAttn
    from tmae_tpu_torch.models.graph_rcnn import AttnGNNLayer
    from tmae_tpu_torch.utils.from_jax import params_from_jax

    cfg = tiny_cfg().MODEL.ROI_HEAD.ATTN_GNN_CONFIG
    xyz, feats, mask = attn_inputs()
    jm = JAttn(cfg)
    args = J(xyz, feats, mask)
    shapes = jax.eval_shape(lambda *a: jm.init(jax.random.PRNGKey(0), *a,
                                               False), *args)
    v = random_variables(shapes, 6)
    rec = Recorder(monkeypatch)
    want, upd = jm.apply(v, *args, train, mutable=['batch_stats'],
                         rngs={'dropout': jax.random.PRNGKey(7)})
    assert len(rec.keep) == (3 if train else 0)
    tm = AttnGNNLayer(cfg, 3 + feats.shape[-1])
    tm.load_state_dict(params_from_jax(v), strict=True)
    tm.train(train)
    with torch.no_grad():
        got = tm(*T(xyz, feats, mask), keep=keep_masks(rec.keep) or None)
    close(got, want, rtol=1e-4, what='attn_gnn')
    if train:
        for k, w in jax_stats(upd).items():
            close(tm.state_dict()[k], w.numpy(), rtol=1e-4, what=k)


def head_inputs(seed=8, B=2, M=6, P=128):
    rng = np.random.RandomState(seed)
    pts = np.zeros((B, P, 4), np.float32)
    pts[..., :2] = rng.uniform(-4, 4, (B, P, 2))
    pts[..., 2] = rng.uniform(-1, 1, (B, P))
    pts[..., 3] = rng.uniform(0, 1, (B, P))
    pmask = np.ones((B, P), bool)
    rois = np.zeros((B, M, 7), np.float32)
    rois[..., :2] = rng.uniform(-3, 3, (B, M, 2))
    rois[..., 3:6] = rng.uniform(1.0, 2.5, (B, M, 3))
    rois[..., 6] = rng.uniform(-np.pi, np.pi, (B, M))
    rois[1, 1, :2] = 30.0  # empty
    rmask = np.ones((B, M), bool)
    rmask[0, -1] = False
    return pts, pmask, rois, rmask


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_graph_rcnn_head_equals_jax(train, monkeypatch):
    """GraphRCNNHead: the DFVS pool of the enlarged RoIs (an empty and a
    masked RoI among them), AttnGNN, shared_fc, the class and box outputs
    within 1e-4 of the largest; in train mode on JAX's keep masks, the
    running statistics within 1e-4."""
    from tmae_tpu.models.graph_rcnn import GraphRCNNHead as JHead
    from tmae_tpu_torch.models.graph_rcnn import GraphRCNNHead
    from tmae_tpu_torch.utils.from_jax import params_from_jax

    roi_cfg = tiny_cfg().MODEL.ROI_HEAD
    pts, pmask, rois, rmask = head_inputs()
    jm = JHead(roi_cfg, num_class=1)
    args = J(pts, pmask, rois, rmask)
    shapes = jax.eval_shape(lambda *a: jm.init(jax.random.PRNGKey(0), *a,
                                               False), *args)
    v = random_variables(shapes, 9)
    rec = Recorder(monkeypatch)
    (jc, jr), upd = jm.apply(v, *args, train, mutable=['batch_stats'],
                             rngs={'dropout': jax.random.PRNGKey(10)})
    tm = GraphRCNNHead(roi_cfg, 4)
    tm.load_state_dict(params_from_jax(v), strict=True)
    tm.train(train)
    with torch.no_grad():
        tc, tr = tm(*T(pts, pmask, rois, rmask),
                    keep=keep_masks(rec.keep) or None)
    close(tc, jc, rtol=1e-4, what='rcnn_cls')
    close(tr, jr, rtol=1e-4, what='rcnn_reg')
    if train:
        for k, w in jax_stats(upd).items():
            close(tm.state_dict()[k], w.numpy(), rtol=1e-4, what=k)


def jax_graph_rcnn(cfg):
    from tmae_tpu.models.detectors import make_voxel_spec
    from tmae_tpu.models.graph_rcnn import GraphRCNN as JGraphRCNN

    return JGraphRCNN(model_cfg=cfg.MODEL, class_names=tuple(cfg.CLASS_NAMES),
                      spec=make_voxel_spec(cfg.DATA_CONFIG, cfg.RUNTIME),
                      max_voxels_per_level=tuple(cfg.RUNTIME.MAX_VOXELS))


def jax_dense_head(cfg, params):
    from tmae_tpu.models.anchor_head import AnchorHeadSingle
    from tmae_tpu.models.detectors import make_voxel_spec

    spec = make_voxel_spec(cfg.DATA_CONFIG, cfg.RUNTIME)
    nx, ny, _ = spec.grid_size
    return AnchorHeadSingle(cfg.MODEL.DENSE_HEAD, 1, ('Car',), (nx, ny),
                            spec.pc_range).bind(
        {'params': params['dense_head']})


@pytest.fixture(scope='module')
def graph():
    """Both packages' GraphRCNN from the same weights (strict load): eval
    outputs on a batch of two frames; then, in train mode with one
    proposal key and one dropout key, JAX's proposals (before the
    sampler), keep masks, uniform draw, outputs, running statistics, loss
    and gradients, and the control's gradients, the ground truth planted on
    two of the proposals so that the sampler finds foreground; and the
    port's train-mode outputs, loss and gradients on JAX's proposals, draw
    and masks (JAX's compiled loss too)."""
    from tmae_tpu.models import backbone3d_voxel as jvb
    from tmae_tpu.models.graph_rcnn import graph_rcnn_loss as j_loss
    from tmae_tpu_torch.models import backbone3d_voxel as tvb
    from tmae_tpu_torch.models import detectors as tdet
    from tmae_tpu_torch.utils.from_jax import params_from_jax, tree_from_jax

    cfg = tiny_cfg()
    batch = tiny_batch()
    key, dkey = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    N = int(cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE)
    u = np.array(jax.vmap(lambda k: jax.random.uniform(k, (N,)))(
        jax.random.split(key, 2)))
    out = {'cfg': cfg, 'u': u}
    with pytest.MonkeyPatch.context() as mp:
        orig = jvb.SparseConv3dBlock
        mp.setattr(jvb, 'SparseConv3dBlock', lambda *a, **kw: orig(
            *a, **dict(kw, padding=tvb.CONV_OUT_PADDING)
            if kw.get('name') == 'conv_out' else kw))
        jm = jax_graph_rcnn(cfg)
        jb = {k: jnp.asarray(x) for k, x in batch.items()}
        shapes = jax.eval_shape(lambda b: jm.init(
            {'params': jax.random.PRNGKey(0)}, b, False), jb)
        v = random_variables(shapes, 0)
        out['jeval'] = jax.jit(lambda v, b: jm.apply(v, b, False))(v, jb)
        train_apply = recorded_train_apply(jm, key, dkey)
        rois, _, _, rmask = map(np.asarray, train_apply(v, jb)[3])
        # the ground truth on two proposals of each sample, moved a little
        gt = np.zeros((2, 2, 8), np.float32)
        for b in range(2):
            idx = np.nonzero(rmask[b])[0][[0, 2]]
            gt[b, :, :7] = rois[b, idx, :7] + [0.1, -0.05, 0.02, 0.05, 0.0,
                                               0.0, 0.05]
            gt[b, :, 7] = 1
        batch = tiny_batch(gt)
        jb = {k: jnp.asarray(x) for k, x in batch.items()}
        jtrain, upd, keep, proposals = train_apply(v, jb)
        out.update(batch=batch, jtrain=jtrain, jstats=jax_stats(upd),
                   proposals=[np.asarray(x) for x in proposals],
                   keep=keep_masks(keep))

        def loss_fn(params, stats, b):
            o, _ = jm.apply({'params': params, 'batch_stats': stats}, b, True,
                            proposal_rng=key, mutable=['batch_stats'],
                            rngs={'dropout': dkey})
            return j_loss(cfg, o, b, jax_dense_head(cfg, params))

        # the compiled step rounds the bf16 first stage otherwise than the
        # eager pass, which can reorder the proposals: it takes the eager
        # pass's
        from tmae_tpu.models import graph_rcnn as jgr

        mp.setattr(jgr, 'proposal_layer', lambda *a, **kw: tuple(
            jnp.asarray(x) for x in out['proposals']))
        grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (jl, jparts), jg = grad(v['params'], v['batch_stats'], jb)
        ctrl = _bf16_rounded(v)
        _, jg_ctrl = grad(ctrl['params'], ctrl['batch_stats'], jb)
    out.update(jloss=float(jl), jparts={k: float(x) for k, x in
                                        jparts.items()},
               jg=tree_from_jax(jax.device_get(jg)),
               jg_ctrl=tree_from_jax(jax.device_get(jg_ctrl)))

    tm = tdet.build_detector(cfg, 'cpu')
    tm.load_state_dict(params_from_jax(v), strict=True)
    tb = tdet.batch_to_device(tiny_batch(), 'cpu')
    hand = [torch.from_numpy(np.array(x)) for x in out['proposals']]
    hand[2] = hand[2].long()
    with torch.no_grad():
        out['teval'] = tm(tb)
        jp = [torch.from_numpy(np.array(out['jeval'][k])) for k in
              ('rois', 'roi_scores', 'roi_labels', 'roi_mask')]
        jp[2] = jp[2].long()
        out['teval_handed'] = tm(tb, proposals=jp)
    tm.train()
    tb = tdet.batch_to_device(batch, 'cpu')
    tout = tm(tb, proposals=hand, roi_uniform=torch.from_numpy(u),
              dropout_keep=out['keep'])
    tl, tparts = tdet.detector_loss(cfg, tm)(tout, tb)
    tl.backward()
    out.update(model=tm, ttrain=tout, tloss=float(tl.detach()),
               tparts={k: float(x.detach()) for k, x in tparts.items()},
               tg={n: p.grad.clone() for n, p in tm.named_parameters()})
    return out


PROPOSAL_KEYS = ('rois', 'roi_scores', 'roi_labels', 'roi_mask')


def same_proposals(got, want, box_tol=1e-3, score_tol=2e-3):
    """The same kept proposals in each sample: as many, and each of one
    side's RoIs within ``box_tol`` (relative to the largest) of one of the
    other's, one to one, with the same label and a score within
    ``score_tol``; the bf16 first stage may swap two proposals whose
    scores lie that close, also across the cap, so a RoI whose score lies
    within ``score_tol`` of the sample's lowest kept one may go
    unmatched."""
    rois, scores, labels, mask = got
    w_rois, w_scores, w_labels, w_mask = want
    np.testing.assert_array_equal(mask.sum(1), w_mask.sum(1))
    assert mask.sum() >= 8
    tol = box_tol * np.abs(w_rois).max()
    for b in range(mask.shape[0]):
        gi, wi = np.nonzero(mask[b])[0], np.nonzero(w_mask[b])[0]
        d = np.abs(rois[b][gi][:, None] - w_rois[b][wi][None]).max(-1)
        hit = d.min(1) <= tol
        edge = scores[b, gi] <= w_scores[b, wi].min() + score_tol
        assert (hit | edge).all() and hit.sum() >= len(gi) - 1
        match = d.argmin(1)[hit]
        assert len(set(match)) == len(match)
        np.testing.assert_array_equal(labels[b, gi[hit]],
                                      w_labels[b, wi[match]])
        assert np.abs(scores[b, gi[hit]]
                      - w_scores[b, wi[match]]).max() <= score_tol


def test_graph_rcnn_eval_forward_and_predict_equal_jax(graph):
    """Eval mode: the first stage's maps within the bf16 bound (max |diff|
    <= 0.03, mean <= 3e-3); the proposals (32 anchors, NMS 0.7, 8 kept)
    the same (:func:`same_proposals`); on JAX's proposals
    the second stage's outputs within 1e-4 of the largest and
    ``graph_rcnn_predict``'s boxes within 1e-4, scores within 1e-5, labels
    and validity exactly."""
    from tmae_tpu.config import Cfg as JCfg
    from tmae_tpu.models.graph_rcnn import graph_rcnn_predict as j_predict
    from tmae_tpu_torch.models.graph_rcnn import graph_rcnn_predict

    jo, to, th = graph['jeval'], graph['teval'], graph['teval_handed']
    for k, w in jo['anchor_outputs'].items():
        err = np.abs(np_(to['anchor_outputs'][k]) - np.asarray(w))
        assert err.max() <= 0.03 and err.mean() <= 3e-3, (k, err.max())
    same_proposals([np_(to[k]) for k in PROPOSAL_KEYS],
                   [np.asarray(jo[k]) for k in PROPOSAL_KEYS])
    close(th['rcnn_cls'], jo['rcnn_cls'], rtol=1e-4, what='rcnn_cls')
    close(th['rcnn_reg'], jo['rcnn_reg'], rtol=1e-4, what='rcnn_reg')
    cfg = graph['cfg']
    want = j_predict(JCfg.from_dict(dict(cfg)), jo)
    got = graph_rcnn_predict(cfg, th)
    close(got['pred_boxes'], want['pred_boxes'], rtol=1e-4, what='boxes')
    assert np.abs(np_(got['pred_scores'])
                  - np.asarray(want['pred_scores'])).max() <= 1e-5
    for k in ('pred_labels', 'pred_valid'):
        np.testing.assert_array_equal(np_(got[k]), np.asarray(want[k]))


def test_graph_rcnn_train_targets_and_statistics_equal_jax(graph):
    """Train mode on JAX's proposals, draw and keep masks: the sampled
    RoIs and every target exactly (canonical ground truth and IoU within
    1e-5; the planted ground truth gives foreground), the outputs within
    1e-4 of the largest, the running statistics within 1e-4."""
    jt, tt = graph['jtrain'], graph['ttrain']
    jtg, ttg = jt['roi_targets'], tt['roi_targets']
    assert np_(ttg['reg_valid_mask']).sum() >= 2
    for k in jtg:
        g, w = np_(ttg[k]), np.asarray(jtg[k])
        if k in ('gt_of_rois', 'gt_iou_of_rois', 'rcnn_cls_labels'):
            assert np.abs(g - w).max() <= COORD_TOL, k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    close(tt['rcnn_cls'], jt['rcnn_cls'], rtol=1e-4, what='rcnn_cls')
    close(tt['rcnn_reg'], jt['rcnn_reg'], rtol=1e-4, what='rcnn_reg')
    sd = graph['model'].state_dict()
    for k, w in graph['jstats'].items():
        if k.startswith('roi_head'):
            close(sd[k], w.numpy(), rtol=1e-4, what=k)


def test_graph_rcnn_train_loss_and_gradients_equal_jax(graph):
    """One train-mode loss (rpn and rcnn parts) within 1% of JAX's; the
    gradients over all parameters at relative L2 error at most 1.25 times
    the control's (or 1e-3) and cosine at least the control's less 0.02,
    the second stage's alone within 1e-3 relative L2; every gradient
    finite."""
    from tests.test_torch_port_train import _cos, _rel

    m = graph
    assert sorted(m['tparts']) == sorted(m['jparts'])
    for k, want in m['jparts'].items():
        assert abs(m['tparts'][k] - want) <= 0.01 * abs(want) + 1e-6, k
    assert m['tparts']['rcnn_loss_reg'] > 0
    jg, tg, ctrl = m['jg'], m['tg'], m['jg_ctrl']
    assert sorted(jg) == sorted(tg)
    names = sorted(jg)
    cat = lambda d, ns=names: torch.cat([d[n].flatten() for n in ns])
    rel, cos = _rel(cat(tg), cat(jg)), _cos(cat(tg), cat(jg))
    rel_c, cos_c = _rel(cat(ctrl), cat(jg)), _cos(cat(ctrl), cat(jg))
    print(f'gradient: port vs JAX relative L2 {rel:.5f}, cosine {cos:.6f}; '
          f'control {rel_c:.5f}, {cos_c:.6f}')
    assert rel <= max(1.25 * rel_c, 1e-3) and cos >= cos_c - 0.02
    second = [n for n in names if n.startswith('roi_head')]
    assert _rel(cat(tg, second), cat(jg, second)) <= 1e-3
    assert all(torch.isfinite(g).all() for g in tg.values())


# ---------------------------------------------------------------------------
# F15, the build and the CLIs
# ---------------------------------------------------------------------------

YAML = 'tools/cfgs/once_models/graph_rcnn_once.yaml'


def test_f15_jax_cannot_build_or_evaluate_graph_rcnn_the_port_can():
    """JAX's build_detector passes ``vfe_remat``, which GraphRCNN does not
    declare, and JAX's host NMS reads ``MODEL.DENSE_HEAD.POST_PROCESSING``,
    which graph_rcnn_once.yaml does not have; the port builds the shipped
    config at its full widths and reads the NMS config from
    ``MODEL.POST_PROCESSING``; a camera branch builds as the JAX package
    builds it: ``IMG_BACKBONE`` gives ``img_backbone`` (DLASeg) and, with
    ``ROI_HEAD.IMG_CONFIG``, the head's image branch (AttnGNN's input
    grows by DLASeg's 64 channels); ``IMG_CONFIG`` alone gives no image
    branch; and a batch's ``images`` before a model without one are
    left unread, the outputs the same."""
    from tmae_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml
    from tmae_tpu.models import detectors as jdet
    from tmae_tpu_torch.config import cfg_from_yaml_file
    from tmae_tpu_torch.models import detectors as tdet

    with pytest.raises(TypeError, match='vfe_remat'):
        jdet.build_detector(j_cfg_from_yaml(YAML))
    boxes = np.zeros((1, 2, 7), np.float32)
    boxes[..., 3:6] = 1.0
    with pytest.raises(KeyError, match='POST_PROCESSING'):
        jdet.host_nms(j_cfg_from_yaml(YAML), boxes, np.ones((1, 2)),
                      np.ones((1, 2), np.int32), np.ones((1, 2), bool))
    cfg = cfg_from_yaml_file(YAML)
    assert tdet.host_nms(cfg, boxes, np.ones((1, 2)), np.ones((1, 2)),
                         np.ones((1, 2), bool)).tolist() == [[True, False]]
    model = tdet.build_detector(cfg, 'cpu')
    assert type(model).__name__ == 'GraphRCNN'
    gnn = model.roi_head.attn_gnn
    assert gnn.edge0.linear.in_features == 2 * (4 + 6)
    assert gnn.exp0.linear.out_features == 512
    assert model.roi_head.reg_out.out_features == 7
    widths = {}
    for keys in (('IMG_BACKBONE',), ('ROI_HEAD.IMG_CONFIG',),
                 ('IMG_BACKBONE', 'ROI_HEAD.IMG_CONFIG')):
        cam = cfg_from_yaml_file(YAML)
        for key in keys:
            d = cam.MODEL
            for k in key.split('.')[:-1]:
                d = d[k]
            d[key.split('.')[-1]] = ({'NAME': 'DLASeg'} if key ==
                                     'IMG_BACKBONE' else {'FEAT_STRIDE': 4})
        m = tdet.build_detector(cam, 'cpu')
        assert (m.img_backbone is not None) == ('IMG_BACKBONE' in keys)
        widths[keys] = m.roi_head.attn_gnn.edge0.linear.in_features
    assert list(widths.values()) == [2 * (4 + 6), 2 * (4 + 6),
                                     2 * (4 + 64 + 6)]
    tiny = tdet.build_detector(tiny_cfg(), 'cpu')
    batch = tdet.batch_to_device(tiny_batch(), 'cpu')
    with torch.no_grad():
        want = tiny(batch)
        got = tiny(dict(batch, images=torch.zeros(2, 8, 8, 3)))
    assert torch.equal(got['rcnn_reg'], want['rcnn_reg'])


def test_cli_graph_rcnn_train_and_test(tmp_path, monkeypatch):
    """``tools.train`` one epoch of the tiny GraphRCNN on synthetic frames
    (its loss finite, its draws from the step's generators, twice the same
    losses bit for bit with ``--fix_random_seed``), then ``tools.test``
    (the evaluator's GraphRCNN branch: result.pkl with the frames in
    order, every AP finite)."""
    import pickle
    import sys

    import yaml

    from tmae_tpu_torch.tools import test as test_cli
    from tmae_tpu_torch.tools import train as train_cli

    monkeypatch.setattr(train_cli, 'OUTPUT_ROOT', tmp_path / 'output')
    monkeypatch.setattr(test_cli, 'OUTPUT_ROOT', tmp_path / 'output')
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    import json

    cfg = json.loads(json.dumps(tiny_cfg()))
    cfg['DATA_CONFIG'].update(
        DATA_SPLIT={'train': 'train', 'test': 'val'},
        NUM_SYNTHETIC_SAMPLES=2, SYNTHETIC_POINTS=512, SYNTHETIC_BOXES=2)
    cfg['DATA_CONFIG']['DATA_PROCESSOR'][0]['MAX_NUMBER_OF_VOXELS'] = {
        'train': 256, 'test': 256}
    cfg['RUNTIME'].update(MAX_POINTS=768, MAX_VOXELS=[256, 128, 64, 64, 64],
                          MAX_GT=8)
    # ONCE's evaluation asks for these three classes
    cfg['CLASS_NAMES'] = ['Car', 'Bus', 'Truck']
    car, = cfg['MODEL']['DENSE_HEAD']['ANCHOR_GENERATOR_CONFIG']
    cfg['MODEL']['DENSE_HEAD']['ANCHOR_GENERATOR_CONFIG'] = [
        dict(car, class_name=c) for c in cfg['CLASS_NAMES']]
    path = tmp_path / 'cfgs' / 'once_models' / 'graph_rcnn_tiny.yaml'
    path.parent.mkdir(parents=True)
    path.write_text(yaml.safe_dump(cfg))
    runs = [train_cli.main(['--cfg_file', str(path), '--device', 'cpu',
                            '--fix_random_seed', '--epochs', '1',
                            '--extra_tag', tag]) for tag in ('a', 'b')]
    losses = [[s['loss'] for s in r['steps']] for r in runs]
    assert losses[0] and all(np.isfinite(losses[0]))
    assert losses[0] == losses[1]
    (rdir, ap), = test_cli.main(['--cfg_file', str(path), '--device', 'cpu',
                                 '--ckpt', str(runs[0]['checkpoints'][-1])]
                                ).items()
    annos = pickle.loads((rdir / 'result.pkl').read_bytes())
    assert [a['frame_id'] for a in annos] == ['synth_000000', 'synth_000001']
    aps = [v for k, v in ap.items() if k.startswith('AP_')]
    assert aps and all(np.isfinite(aps))
