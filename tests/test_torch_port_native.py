"""The port's native host ops (``tmae_tpu_torch/utils/native.py`` over its
copy of ``csrc/host_ops.cpp``) against the JAX package's library on the CPU:
intersection, 3D IoU with and without heading, NMS, points in boxes and both
ONCE AP accumulators bit for bit on seeded boxes; the port's ``host_nms``
kept mask equal to JAX's ``host_nms``; the plain numpy paths
(``native=False``) equal to the native ones (IoU to 1e-12, on boxes whose
IoUs keep 1e-6 away from the NMS threshold, where the two orders of
operations cannot disagree); and a build that fails raises instead of
falling back to numpy."""

import numpy as np
import pytest

from tests.tiny_cfg import tiny_cfg
from tmae_tpu.models import detectors as jdet
from tmae_tpu.utils import native as jnative
from tmae_tpu_torch.datasets import once_eval
from tmae_tpu_torch.models import detectors as tdet
from tmae_tpu_torch.ops import geometry_np as gnp
from tmae_tpu_torch.utils import native


@pytest.fixture(scope='module', autouse=True)
def jax_lib():
    assert jnative.get_lib() is not None, 'the JAX package could not build'


def rand_boxes(n, seed, spread=10.0):
    rng = np.random.RandomState(seed)
    return np.c_[
        rng.uniform(-spread, spread, (n, 2)), rng.uniform(-2, 1, (n, 1)),
        rng.uniform(0.5, 5, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1)),
    ]


def test_library_built_from_the_port_source():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith('host_ops-') and path.suffix == '.so'
    assert native.SRC == native.PKG_DIR / 'csrc' / 'host_ops.cpp'


@pytest.mark.parametrize('what', ['intersection', 'iou3d', 'iou3d_heading',
                                  'nms', 'points_in_boxes'])
def test_geometry_bit_equal_to_jax(what):
    a, b = rand_boxes(60, 0), rand_boxes(45, 1)
    if what == 'intersection':
        got = native.intersection_area_bev(a, b)
        want = jnative.intersection_area_bev(a, b)
        assert (got > 0).sum() > 20
    elif what.startswith('iou3d'):
        heading = what.endswith('heading')
        got = native.iou3d(a, b, with_heading=heading)
        want = jnative.iou3d(a, b, with_heading=heading)
        assert (got > 0).sum() > 10
    elif what == 'nms':
        boxes = rand_boxes(300, 2)
        got = native.nms_bev_sorted(boxes, 0.3, 200)
        want = jnative.nms_bev_sorted(boxes, 0.3, 200)
        assert 10 < got.sum() < 300
    else:
        rng = np.random.RandomState(3)
        pts = np.c_[rng.uniform(-10, 10, (2000, 2)),
                    rng.uniform(-2, 2, (2000, 1))].astype(np.float32)
        got = native.points_in_boxes(pts, a, margin=0.1)
        want = jnative.points_in_boxes(pts, a, margin=0.1)
        assert (got >= 0).sum() > 100
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def eval_case(seed):
    rng = np.random.RandomState(seed)
    iou = rng.uniform(0, 1, (12, 20)) * (rng.rand(12, 20) < 0.5)
    scores = rng.uniform(0, 1, 20)
    gflag = rng.choice([-1, 0, 0, 0, 1], 12).astype(np.int64)
    pflag = rng.choice([-1, 0, 0, 0, 1], 20).astype(np.int64)
    return iou, scores, gflag, pflag


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_accumulators_bit_equal_to_jax_and_numpy(seed):
    iou, scores, gflag, pflag = eval_case(seed)
    acc = native.accumulate_scores(iou, scores, gflag, pflag, 0.5)
    np.testing.assert_array_equal(
        acc, jnative.accumulate_scores(iou, scores, gflag, pflag, 0.5))
    np.testing.assert_array_equal(
        acc, once_eval.accumulate_scores(iou, scores, gflag, pflag, 0.5))
    assert len(acc) > 0
    ths = np.sort(scores)[::-3]
    st = native.compute_statistics_all(iou, scores, gflag, pflag, ths, 0.5)
    np.testing.assert_array_equal(st, jnative.compute_statistics_all(
        iou, scores, gflag, pflag, ths, 0.5))
    for ti, th in enumerate(ths):
        assert tuple(st[ti]) == once_eval.compute_statistics(
            iou, scores, gflag, pflag, th, 0.5)


def test_iou_numpy_path_equals_native():
    a, b = rand_boxes(40, 4), rand_boxes(30, 5)
    for fn in (gnp.intersection_area_bev, gnp.boxes_iou_bev, gnp.boxes_iou3d,
               gnp.boxes_iou3d_with_heading):
        got, want = fn(a, b), fn(a, b, native=False)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert (want > 0).sum() > 10


def candidates(seed, B=2, K=400):
    """Score-sorted candidates as decode gives them: boxes [B, K, 7] f32,
    scores, labels, the first n_b valid."""
    rng = np.random.RandomState(seed)
    boxes = np.stack([rand_boxes(K, seed * 10 + b, spread=15.0)
                      for b in range(B)]).astype(np.float32)
    scores = -np.sort(-rng.uniform(0.1, 1, (B, K)), axis=1).astype(np.float32)
    labels = rng.randint(1, 6, (B, K)).astype(np.int32)
    valid = np.arange(K)[None] < np.array([[K - 37], [K - 120]])[:B]
    return boxes, scores, labels, valid


@pytest.mark.parametrize('thresh', [0.1, 0.5])
def test_host_nms_equals_jax_and_numpy_path(thresh):
    cfg = tiny_cfg()
    nms_cfg = cfg.MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG
    nms_cfg.NMS_THRESH = thresh
    nms_cfg.NMS_POST_MAXSIZE = 300
    boxes, scores, labels, valid = candidates(int(thresh * 10))
    got = tdet.host_nms(cfg, boxes, scores, labels, valid)
    want = jdet.host_nms(cfg, boxes, scores, labels, valid)
    np.testing.assert_array_equal(got, want)
    assert 10 < got.sum() < valid.sum()
    # the numpy NMS keeps the same set where no IoU sits at the threshold
    for b in range(boxes.shape[0]):
        n = int(valid[b].sum())
        cand = boxes[b, :n].astype(np.float64)
        iou = gnp.boxes_iou_bev(cand, cand)
        assert np.abs(iou - thresh).min() > 1e-6
    np.testing.assert_array_equal(
        tdet.host_nms(cfg, boxes, scores, labels, valid, native=False), got)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ cannot compile: both builds fail, and the call raises
    with g++'s error, whichever caller asked (no numpy fallback)."""
    bad = tmp_path / 'host_ops.cpp'
    bad.write_text('this is not C++\n')
    monkeypatch.setattr(native, 'SRC', bad)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / '_build')
    monkeypatch.setattr(native, '_lib', None)
    with pytest.raises(RuntimeError, match='could not be built') as e:
        native.get_lib()
    assert 'error' in str(e.value) and str(bad) in str(e.value)
    with pytest.raises(RuntimeError, match='could not be built'):
        gnp.boxes_iou3d(rand_boxes(3, 0), rand_boxes(3, 1))
    cfg = tiny_cfg()
    with pytest.raises(RuntimeError, match='could not be built'):
        tdet.host_nms(cfg, *candidates(0, B=1, K=60))
    assert not list((tmp_path / '_build').glob('*.so'))
