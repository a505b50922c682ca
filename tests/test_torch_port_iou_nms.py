"""The port's device geometry (``tmae_tpu_torch/ops/geometry.py``: the plain
versions of kernels IOU_PAIRS, IOU_ALIGNED, NMS_MASK and NMS_SCAN) against
the JAX package's ``ops/geometry.py`` on the CPU, on the same f32 boxes:
corners, the Sutherland–Hodgman intersection, BEV / 3D / aligned IoU (to
1e-5: f32 with another cos / sin and summation order) on random boxes and
on touching, nested, identical and rotated-by-pi/2 pairs; ``nms_bev_mask``
exactly on crowded clusters; the multi-class mask and scan against the
greedy loop per class; ``decode(nms_on_device=True)`` against JAX's
``decode_and_nms(nms_on_device=True)`` for ``nms_gpu`` and
``multi_class_nms`` (equal keep masks, boxes within 1e-5); and the port's
device NMS equal to its ``host_nms`` on the same candidates."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.config import Cfg
from tmae_tpu.models import center_head as jch
from tmae_tpu.models import detectors as jdet
from tmae_tpu.ops import geometry as jgeo
from tmae_tpu_torch.models import center_head as tch
from tmae_tpu_torch.models import detectors as tdet
from tmae_tpu_torch.ops import geometry as tgeo

IOU_TOL = 1e-5


def rand_boxes(n, seed, spread=6.0):
    rng = np.random.RandomState(seed)
    return np.c_[
        rng.uniform(-spread, spread, (n, 2)), rng.uniform(-1, 1, (n, 1)),
        rng.uniform(0.5, 4, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1)),
    ].astype(np.float32)


def special_pairs():
    """Row-aligned (a, b): touching edge to edge, nested, identical,
    rotated by pi/2 about the same centre, touching at a corner, apart."""
    a = np.array([[0, 0, 0, 2, 1, 1, 0],
                  [0, 0, 0, 4, 4, 2, 0.3],
                  [1, 2, 0, 3, 1.5, 1, 0.7],
                  [0, 0, 0, 4, 2, 1, 0],
                  [0, 0, 0, 2, 2, 2, 0],
                  [0, 0, 0, 1, 1, 1, 0]], np.float32)
    b = np.array([[2, 0, 0, 2, 1, 1, 0],
                  [0.2, -0.1, 0.5, 1, 1, 1, 0.3],
                  [1, 2, 0, 3, 1.5, 1, 0.7],
                  [0, 0, 0, 4, 2, 1, np.pi / 2],
                  [2, 2, 0, 2, 2, 2, 0],
                  [5, 5, 0, 1, 1, 1, 1.0]], np.float32)
    return a, b


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_corners_match_jax():
    b = rand_boxes(50, 0)
    got = tgeo.boxes_to_corners_bev(_t(b)).numpy()
    want = np.asarray(jgeo.boxes_to_corners_bev(jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=IOU_TOL, rtol=0)


@pytest.mark.parametrize('which', ['random', 'special'])
def test_intersection_and_aligned_iou_match_jax(which):
    """The flat clip and the aligned 3D IoU, pair by pair."""
    if which == 'random':
        a, b = rand_boxes(400, 1, 2.0), rand_boxes(400, 2, 2.0)
    else:
        a, b = special_pairs()
    got = tgeo.sh_intersection_area_flat(_t(a), _t(b)).numpy()
    want = np.asarray(jgeo._sh_intersection_area_flat(jnp.asarray(a),
                                                      jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=IOU_TOL * 10, rtol=IOU_TOL)
    got = tgeo.boxes_iou3d_aligned(_t(a), _t(b)).numpy()
    want = np.asarray(jgeo.boxes_iou3d_aligned(jnp.asarray(a),
                                               jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=IOU_TOL, rtol=0)
    if which == 'random':
        assert (want > 0).sum() > 100
    else:
        # touching 0, nested 1/16 of A's area in BEV, identical 1, the cross
        # of a 4x2 and a 2x4 box 4/12, a corner 0, apart 0
        inter = tgeo.sh_intersection_area_flat(_t(a), _t(b)).numpy()
        np.testing.assert_allclose(inter, [0, 1, 4.5, 4, 0, 0], atol=1e-5)
        np.testing.assert_allclose(tgeo.boxes_iou_bev(_t(a), _t(b)).numpy()
                                   .diagonal(), [0, 1 / 16, 1, 4 / 12, 0, 0],
                                   atol=1e-5)


@pytest.mark.parametrize('fn', ['boxes_iou_bev', 'boxes_iou3d',
                                'intersection_area_bev'])
def test_pair_matrices_match_jax(fn):
    a, b = rand_boxes(60, 3), rand_boxes(45, 4)
    sa, sb = special_pairs()
    a, b = np.r_[a, sa], np.r_[b, sb]
    got = getattr(tgeo, fn)(_t(a), _t(b)).numpy()
    want = np.asarray(getattr(jgeo, fn)(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (66, 51)
    tol = IOU_TOL * (10 if fn == 'intersection_area_bev' else 1)
    np.testing.assert_allclose(got, want, atol=tol, rtol=IOU_TOL)
    assert (want > 0).sum() > 50


def crowded(n, seed, clusters=6, labels=5):
    """Boxes in clusters of heavy overlap, all headings, distinct scores
    (descending), the valid ones first; labels 1..``labels``."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(-20, 20, (clusters, 2))
    c = rng.randint(0, clusters, n)
    b = np.c_[centres[c] + rng.normal(0, 0.6, (n, 2)),
              rng.uniform(-1, 1, (n, 1)), rng.uniform(1.0, 4.5, (n, 3)),
              rng.uniform(-np.pi, np.pi, (n, 1))].astype(np.float32)
    return b, rng.randint(1, labels + 1, n)


@pytest.mark.parametrize('thresh,post', [(0.5, 500), (0.1, 500), (0.5, 7)])
def test_nms_bev_mask_matches_jax(thresh, post):
    """Greedy rotated NMS of one sample, valid first: the same keep mask as
    JAX's ``nms_bev_mask`` (whose IoU rows come from the same clip), also
    with a cap that cuts; the plain greedy loop agrees."""
    K = 120
    b, _ = crowded(K, 5)
    valid = np.arange(K) < 100
    scores = np.linspace(1, 0.01, K).astype(np.float32)
    want = np.asarray(jgeo.nms_bev_mask(jnp.asarray(b), jnp.asarray(scores),
                                        jnp.asarray(valid), thresh, post))
    got = tgeo.nms_bev_mask(_t(b), _t(scores), torch.from_numpy(valid),
                            thresh, post).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tgeo.nms_bev_mask_plain(
        _t(b), torch.from_numpy(valid), thresh, post).numpy(), want)
    assert 5 < want.sum() < 100 and not want[100:].any()


def test_multi_class_mask_and_scan_equal_the_loop_over_classes():
    """One mask and one scan over every class (B = 2) keep what the greedy
    NMS of each class's own candidates keeps (the plain loop and JAX's
    ``nms_bev_mask`` on the class's compacted, still sorted candidates),
    with each class's threshold and cap; invalid boxes take no part."""
    B, K = 2, 150
    threshs, posts = [0.7, 0.6, 0.55, 0.55, 0.3], [40, 40, 3, 40, 40]
    boxes, labels, valid = [], [], []
    for s in range(B):
        b, lab = crowded(K, 10 + s)
        boxes.append(b)
        labels.append(lab)
        valid.append(np.random.RandomState(s).rand(K) < 0.9)
    boxes, labels, valid = map(np.stack, (boxes, labels, valid))
    keep = tgeo.nms_keep(_t(boxes), torch.from_numpy(valid), threshs, posts,
                         labels=torch.from_numpy(labels)).numpy()
    for s in range(B):
        want = np.zeros(K, bool)
        for c in range(5):
            sel = np.nonzero(valid[s] & (labels[s] == c + 1))[0]
            sub = tgeo.nms_bev_mask_plain(
                _t(boxes[s, sel]), torch.ones(len(sel), dtype=torch.bool),
                threshs[c], posts[c]).numpy()
            jsub = np.asarray(jgeo.nms_bev_mask(
                jnp.asarray(boxes[s, sel]), jnp.zeros(len(sel)),
                jnp.ones(len(sel), bool), threshs[c], posts[c]))
            np.testing.assert_array_equal(sub, jsub)
            want[sel] = sub
        np.testing.assert_array_equal(keep[s], want)
        assert (keep[s] & ~valid[s]).sum() == 0
        assert (keep[s] & (labels[s] == 3)).sum() == 3  # the cap of class 3


CLASSES = ['Car', 'Bus', 'Truck', 'Pedestrian', 'Cyclist']


def decode_cfg(multi_class: bool):
    nms = ({'NMS_TYPE': 'multi_class_nms',
            'IOU_RECTIFIER': [0.68, 0.71, 0.65, 0.65, 0.68],
            'NMS_THRESH': [0.7, 0.6, 0.55, 0.55, 0.55],
            'NMS_PRE_MAXSIZE': [64] * 5, 'NMS_POST_MAXSIZE': [16] * 5}
           if multi_class else
           {'NMS_TYPE': 'nms_gpu', 'NMS_THRESH': 0.2,
            'NMS_PRE_MAXSIZE': 64, 'NMS_POST_MAXSIZE': 24})
    return Cfg.from_dict({
        'CLASS_NAMES': CLASSES,
        'DATA_CONFIG': {
            'POINT_CLOUD_RANGE': [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0],
            'DATA_PROCESSOR': [
                {'NAME': 'calculate_grid_size', 'VOXEL_SIZE': [0.5, 0.5, 8.0]},
            ],
        },
        'RUNTIME': {'MAX_POINTS': 64, 'MAX_VOXELS': [64], 'MAX_GT': 8},
        'MODEL': {'DENSE_HEAD': {
            'CLASS_NAMES_EACH_HEAD': [CLASSES],
            'TARGET_ASSIGNER_CONFIG': {'FEATURE_MAP_STRIDE': 1},
            'POST_PROCESSING': {
                'SCORE_THRESH': 0.1,
                'POST_CENTER_LIMIT_RANGE': [-10, -10, -10, 10, 10, 10],
                'MAX_OBJ_PER_SAMPLE': 80,
                'NMS_CONFIG': nms,
            },
        }},
    })


def head_maps(seed, iou: bool):
    """Sharply peaked heatmaps (distinct scores) and large boxes on a 32x32
    grid of 0.5 m cells: crowded candidates."""
    rng = np.random.RandomState(seed)
    B, C, H, W = 2, 5, 32, 32
    pd = {'hm': rng.randn(B, H, W, C) * 3.0,
          'center': rng.rand(B, H, W, 2),
          'center_z': rng.randn(B, H, W, 1),
          'dim': rng.uniform(0.0, 1.2, (B, H, W, 3)),
          'rot': rng.randn(B, H, W, 2)}
    if iou:
        pd['iou'] = rng.uniform(-1.2, 1.2, (B, H, W, 1))
    return {k: v.astype(np.float32) for k, v in pd.items()}


def both_decodes(multi_class: bool, nms_on_device: bool):
    cfg = decode_cfg(multi_class)
    pd = head_maps(7 + multi_class, multi_class)
    jout = jdet.centerpoint_predict(
        cfg, {'pred_dicts': [{k: jnp.asarray(v) for k, v in pd.items()}]},
        nms_on_device=nms_on_device)
    tout = tdet.centerpoint_predict(
        cfg, {'pred_dicts': [{k: _t(v) for k, v in pd.items()}]},
        nms_on_device=nms_on_device)
    return cfg, [np.asarray(a) for a in jout], [a.numpy() for a in tout]


@pytest.mark.parametrize('nms_type', ['nms_gpu', 'multi_class_nms'])
def test_decode_with_device_nms_matches_jax(nms_type):
    """``decode(nms_on_device=True)``: candidates in JAX's order with equal
    labels, boxes within 1e-5, (rectified) scores within 1e-5.

    ``nms_gpu``: the keep mask equals JAX's. ``multi_class_nms``: JAX runs
    ``nms_bev_mask`` per class on the class's mask over all K candidates,
    and that loop stops after the block of 16 rows that holds its n-th row
    (n: the class's candidate count), so it keeps no candidate of the class
    beyond that block. The port's keep mask equals JAX's on every row that
    loop reaches, equals JAX's ``host_nms`` (per class on the class's own
    candidates) everywhere, and JAX's device mask misses kept boxes here."""
    multi = nms_type == 'multi_class_nms'
    cfg, (jb, js, jl, jv), (tb, ts, tl, tv) = both_decodes(multi, True)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tb, jb, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
    if not multi:
        np.testing.assert_array_equal(tv, jv)
        assert 5 < tv.sum(1).min() and tv.sum(1).max() <= 24
        return
    _, (hb, hs, hl, hv), _ = both_decodes(True, False)
    host = jdet.host_nms(cfg, hb, hs, hl, hv)
    np.testing.assert_array_equal(tv, host)
    reached = np.zeros_like(tv)
    for b in range(tv.shape[0]):
        for c in range(1, 6):
            n = int((hv[b] & (hl[b] == c)).sum())
            reached[b] |= (hl[b] == c) & (np.arange(tv.shape[1])
                                          < -(-n // 16) * 16)
    np.testing.assert_array_equal(tv & reached, jv & reached)
    assert not (jv & ~reached).any() and (tv & ~reached).any()


@pytest.mark.parametrize('nms_type', ['nms_gpu', 'multi_class_nms'])
def test_device_nms_equals_host_nms(nms_type):
    """The port's device NMS keeps what its ``host_nms`` (native host ops)
    keeps on the candidates of ``nms_on_device=False``, as
    ``tests/test_nms_device_host.py`` holds JAX's."""
    multi = nms_type == 'multi_class_nms'
    cfg = decode_cfg(multi)
    pd = {k: _t(v) for k, v in head_maps(11, multi).items()}
    _, _, _, dev_valid = tdet.centerpoint_predict(cfg, {'pred_dicts': [pd]})
    cands = tdet.centerpoint_predict(cfg, {'pred_dicts': [pd]},
                                     nms_on_device=False)
    host = tdet.host_nms(cfg, *cands)
    np.testing.assert_array_equal(dev_valid.numpy(), host)
    assert 0 < host.sum() < cands[3].numpy().sum()
    if multi:
        np.testing.assert_array_equal(
            tdet.host_nms(cfg, *cands, native=False), host)


def test_decode_refuses_other_nms_types():
    cfg = copy.deepcopy(decode_cfg(False))
    post = cfg.MODEL.DENSE_HEAD.POST_PROCESSING
    post.NMS_CONFIG.NMS_TYPE = 'class_specific_nms'
    pd = {k: _t(v) for k, v in head_maps(0, False).items()}
    with pytest.raises(NotImplementedError, match='class_specific_nms'):
        tch.decode([pd], dict(post), (0.5, 0.5, 8.0), (-8, -8, -5, 8, 8, 3),
                   1, [np.arange(5)])
