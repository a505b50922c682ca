"""GraphRCNN's camera path in the port against the JAX package on the CPU.

* ``datasets/image_ops.py`` and ``photo_metric_distortion`` bit for bit
  (the same ``RandomState`` draws the same values in the same order).
* The camera loader on ``tests/once_fixture.py``'s JPGs
  (``make_raw_once(with_camera=True)``): the batches of
  ``graph_rcnn_once_cam_mini.yaml``'s data config equal JAX's key by key
  (``assert_same_batches``), in evaluation and in training (with
  ``photo_metric_distortion``), and the port's F16 keys
  (``image_scale`` 0.5, ``image_shape`` 32 x 48) beside them.
* ``ops/dcn.py``'s plain versions: ``deform_conv2d`` and its gradients
  (x, offset, mask, weight, bias) against ``jax.vjp`` of the JAX
  package's, with offsets that push samples off every edge and onto
  integer coordinates, at three placements, within 1e-5 of the largest
  value (f32, another order of the tap sums); the im2col bit for bit;
  the bilinear gradient against ``jax.vjp`` of ``_bilinear_sample``.
* ``DeformConvBNReLU``, the bilinear upsampling at factors 2, 4 and 8
  (borders included) and ``DLASeg`` at a 32 x 64 image, in eval and train
  mode (the running statistics too), after a strict load of JAX's
  variables, within 1e-4 of the largest value (f32 through some 40
  convolutions and batch norms).
* ``point_sample`` with ``aug_inverse``, scale 1 and the padded shape (the
  JAX package's reading), and ``GraphRCNNHead`` with ``IMG_CONFIG.MLPS``
  [4] in eval and train mode (JAX's dropout masks), within 1e-4, in train
  mode its gradients (the image branch's and the image features') too.
* ``graph_rcnn_once_cam_mini.yaml``'s detector after a strict load on a
  batch of 32 x 64 images (scale 1, no padding, so F16 does not enter):
  eval outputs on JAX's proposals within 1e-4, and one train-mode loss and
  its gradients on JAX's proposals, draw and masks, held as
  ``tests/test_torch_port_graph_rcnn.py`` holds the lidar-only step
  (against an f32 control: JAX with the images moved by a rounding), the
  second stage's alone as well.
* F16: on the fixture's JPGs, JAX samples a point at twice its feature
  position or drops it; the port samples the right one.
* ``tools.train`` then ``tools.test`` of the mini camera config on the
  fixture with ``--device cpu``.
"""

import copy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.once_fixture import CLASSES, make_raw_once
from tests.test_torch_port_anchor import close
from tests.test_torch_port_graph_rcnn import (J, T, Recorder, jax_stats,
                                              keep_masks)
from tests.test_torch_port_model import random_variables
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.datasets import image_ops as jio
from tmae_tpu.ops import dcn as jdcn
from tmae_tpu_torch.datasets import image_ops as tio
from tmae_tpu_torch.ops import dcn as tdcn
from tmae_tpu_torch.utils.from_jax import params_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / 'tools'))

MINI = 'tools/cfgs/once_models/graph_rcnn_once_cam_mini.yaml'
DCN_TOL = 1e-5     # f32, the tap sums in another order
DLA_TOL = 1e-4     # f32 through some 40 convolutions and batch norms
# train mode: level 5's batch statistics at a 32 x 64 image are over 4
# values a channel (1 x 2 cells, batch 2); the variance E[x^2] - E[x]^2 in
# f32 keeps few digits there, and the norm divides by it (the trunk's
# levels 0-4 agree within 4e-5)
DLA_TRAIN_TOL = 2e-3
HEAD_TOL = 1e-4    # as the lidar-only head (tests/test_torch_port_graph_rcnn)


# ---------------------------------------------------------------------------
# image ops and the loader
# ---------------------------------------------------------------------------

PMD = {'BRIGHTNESS_DELTA': 32, 'CONTRAST_RANGE': [0.5, 1.5],
       'SATURATION_RANGE': [0.5, 1.5], 'HUE_DELTA': 18}


def image_op_cases(img):
    return {
        'resize_down': lambda m: m.imresize_bilinear(img, 17, 11),
        'resize_up': lambda m: m.imresize_bilinear(img, 61, 40),
        'resize_uint8': lambda m: m.imresize_bilinear(
            img.astype(np.uint8), 23, 9),
        'rescale_keep_ratio': lambda m: m.imrescale(
            img, [(30, 20)], True, np.random.RandomState(1)),
        'rescale_jitter': lambda m: m.imrescale(
            img, [(40, 20), (60, 34)], True, np.random.RandomState(2)),
        'rescale_fixed': lambda m: m.imrescale(
            img, [(48, 32)], False, np.random.RandomState(3)),
        'flip': lambda m: m.imflip(img),
        'normalize_bgr': lambda m: m.imnormalize(
            img, [103.53, 116.28, 123.675], [57.375, 57.12, 58.395], False),
        'normalize_rgb': lambda m: m.imnormalize(
            img, [1.0, 2.0, 3.0], [4.0, 5.0, 6.0], True),
        'pad': lambda m: m.impad(img, 32),
        'hsv': lambda m: m.hsv_to_bgr(m.bgr_to_hsv(img)),
        **{f'photo_metric_{seed}': (
            lambda m, seed=seed: m.photo_metric_distortion(
                img, PMD, np.random.RandomState(seed))) for seed in range(4)},
    }


@pytest.mark.parametrize('case', list(image_op_cases(np.zeros((1, 1, 3)))))
def test_image_ops_equal_jax(case):
    """Each image op (and photo_metric_distortion under four seeds) gives
    the JAX package's array bit for bit, with its dtype."""
    img = np.random.RandomState(0).uniform(0, 255, (27, 45, 3)).astype(
        np.float32)
    img[3, 4] = img[3, 4, 0]  # a grey pixel: saturation and hue 0
    want = image_op_cases(img)[case](jio)
    got = image_op_cases(img)[case](tio)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w), case


@pytest.fixture(scope='module')
def cam_once(tmp_path_factory):
    """The raw-ONCE fixture with cam03 JPGs (64 x 96) and its infos."""
    import create_once_infos as coi

    root = make_raw_once(tmp_path_factory.mktemp('once_cam'),
                         with_camera=True)
    for split in ('train', 'val'):
        coi.create_infos(root, split)
    return root


def mini_cfg():
    from tmae_tpu_torch.config import cfg_from_yaml_file

    return cfg_from_yaml_file(MINI)


F16_KEYS = ('image_scale', 'image_shape', 'image_flip')


class WithoutF16Keys:
    """A loader whose batches leave out the port's F16 keys (the JAX
    package's batches have none), which it keeps in ``seen``."""

    def __init__(self, loader):
        self.loader, self.seen = loader, []

    def __iter__(self):
        for b in self.loader:
            self.seen.append({k: b.pop(k) for k in F16_KEYS if k in b})
            yield b


@pytest.mark.parametrize('training', [False, True], ids=['eval', 'train'])
def test_camera_loader_equal_jax(cam_once, training):
    """graph_rcnn_once_cam_mini.yaml's data config over the fixture's
    JPGs (imrescale 96 x 64 → 48 x 32, imnormalize, impad to 64 x 32; in
    training photo_metric_distortion and an imflip of ratio 0.5 after the
    rescale): every batch equal to JAX's key by key, bit for bit; beside
    them the port's image_scale (0.5, 0.5) and image_shape (32, 48) of
    every sample and, in training, its image_flip, which flips some
    samples and not others."""
    from tests.test_torch_port_once_data import assert_same_batches
    from tmae_tpu.config import Cfg as JCfg
    from tmae_tpu.datasets.dataset import build_dataloader as j_build
    from tmae_tpu_torch.datasets.dataset import build_dataloader as t_build

    cfg = mini_cfg()
    if training:
        cfg.DATA_CONFIG.DATA_PROCESSOR.insert(2, {
            'NAME': 'imflip', 'FLIP_RATIO': {'train': 0.5, 'test': 0.0}})
    loaders = [build(JCfg.from_dict(copy.deepcopy(dict(cfg.DATA_CONFIG))),
                     CLASSES, 2, training, runtime_cfg=dict(cfg.RUNTIME),
                     root_path=str(cam_once), seed=0)[1]
               for build in (j_build, t_build)]
    port = WithoutF16Keys(loaders[1])
    batches = assert_same_batches(loaders[0], port)
    assert batches[0]['images'].shape == (2, 32, 64, 3)
    assert 'aug_inverse' not in batches[0]
    if training:  # photo_metric_distortion moved the pixels
        ev = list(t_build(copy.deepcopy(cfg.DATA_CONFIG), CLASSES, 2, False,
                          runtime_cfg=dict(cfg.RUNTIME),
                          root_path=str(cam_once), seed=0)[1])
        assert not np.array_equal(ev[0]['images'], batches[0]['images'])
    for seen in port.seen:
        assert seen['image_scale'].dtype == np.float32
        np.testing.assert_array_equal(seen['image_scale'], [[0.5, 0.5]] * 2)
        np.testing.assert_array_equal(seen['image_shape'], [[32, 48]] * 2)
    flips = np.concatenate([seen['image_flip'] for seen in port.seen]
                           if training else [[False]])
    assert flips.dtype == bool and (flips.any() or not training)
    assert not flips.all()


def test_f17_jax_collates_no_aug_inverse_for_a_batch_flipped_in_part(
        cam_once):
    """graph_rcnn_once_cam.yaml's random_world_flip (probability 0.5)
    composes aug_matrix only into the samples it flips. The JAX package's
    collation reads the first sample: flipped first, an unflipped sample
    after it raises KeyError (in its loader's thread, so iteration
    hangs); unflipped first, the batch has no aug_inverse and PointSample
    projects the flipped samples' points mirrored. The port's collation
    gives every sample its inverse, the identity where nothing was
    flipped."""
    from tmae_tpu.datasets.processor import collate_static as j_collate
    from tmae_tpu_torch.datasets.dataset import build_dataloader as t_build

    cfg = mini_cfg()
    cfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST.append(
        {'NAME': 'random_world_flip', 'PROBABILITY': 0.5,
         'ALONG_AXIS_LIST': ['x']})
    ds, _ = t_build(cfg.DATA_CONFIG, CLASSES, 2, True,
                    runtime_cfg=dict(cfg.RUNTIME), root_path=str(cam_once),
                    seed=0)
    samples = [ds[i] for i in range(len(ds))]
    flipped = [s for s in samples if s.get('aug_matrix') is not None]
    plain = [s for s in samples if s.get('aug_matrix') is None]
    assert flipped and plain
    args = (int(cfg.RUNTIME.MAX_POINTS), int(cfg.RUNTIME.MAX_GT),
            int(cfg.RUNTIME.MAX_VOXELS[0]))
    with pytest.raises(KeyError, match='aug_matrix'):
        j_collate([flipped[0], plain[0]], *args)
    assert 'aug_inverse' not in j_collate([plain[0], flipped[0]], *args)
    got = ds.collate_batch([plain[0], flipped[0]])['aug_inverse']
    flip = np.diag([1.0, -1.0, 1.0, 1.0]).astype(np.float32)
    np.testing.assert_array_equal(got, [np.eye(4, dtype=np.float32), flip])


# ---------------------------------------------------------------------------
# DCN
# ---------------------------------------------------------------------------

def dcn_inputs(seed, B=2, H=7, W=9, cin=5, cout=6, k=3, stride=1,
               padding=1, dilation=1):
    """Random x, offsets of a few pixels with planted ones: whole taps
    pushed off each edge, and integer offsets (samples on pixel
    centres), a mask in (0, 1), weight and bias."""
    rng = np.random.RandomState(seed)
    Ho = (H + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    Wo = (W + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    K = k * k
    x = rng.normal(size=(B, H, W, cin)).astype(np.float32)
    off = rng.normal(scale=2.0, size=(B, Ho, Wo, K, 2)).astype(np.float32)
    off[0, 0, :, :, 0] = -H - 1.5          # off the top
    off[0, -1, :, :, 0] = H + 0.5          # off the bottom
    off[1, :, 0, :, 1] = -W - 0.25         # off the left
    off[1, :, -1, :, 1] = W + 2.0          # off the right
    off[0, 1:3] = np.round(off[0, 1:3])    # integer coordinates
    off[1, 2, 2:4, :, 1] = -0.5            # half a pixel past an edge
    mask = rng.uniform(0.05, 1.0, (B, Ho, Wo, K)).astype(np.float32)
    w = (rng.normal(size=(k, k, cin, cout)) / np.sqrt(K * cin)).astype(
        np.float32)
    b = rng.normal(scale=0.1, size=cout).astype(np.float32)
    return x, off.reshape(B, Ho, Wo, 2 * K), mask, w, b


PLACEMENTS = {'s1': (1, 1, 1), 's2': (2, 1, 1), 'dilated': (1, 2, 2)}


@pytest.mark.parametrize('where', list(PLACEMENTS))
def test_deform_conv2d_and_gradients_equal_jax(where):
    """deform_conv2d (plain versions under the autograd Function) against
    the JAX package's at stride 1, stride 2 and dilation 2 with bias: the
    output and the gradients of x, offset, mask, weight and bias for a
    random cotangent (jax.vjp), each within DCN_TOL of its largest
    value; some taps off every edge, some on pixel centres."""
    stride, padding, dilation = PLACEMENTS[where]
    x, off, mask, w, b = dcn_inputs(1, stride=stride, padding=padding,
                                    dilation=dilation)
    kw = dict(stride=stride, padding=padding, dilation=dilation)
    want, vjp = jax.vjp(lambda *a: jdcn.deform_conv2d(*a, **kw),
                        *J(x, off, mask, w, b))
    cot = np.random.RandomState(2).normal(size=want.shape).astype(np.float32)
    wgrads = vjp(jnp.asarray(cot))
    args = [t.requires_grad_() for t in T(x, off, mask, w, b)]
    got = tdcn.deform_conv2d(*args, **kw)
    (got * torch.from_numpy(cot)).sum().backward()
    close(got, want, rtol=DCN_TOL, what='out')
    for name, a, wg in zip(('x', 'offset', 'mask', 'weight', 'bias'), args,
                           wgrads):
        close(a.grad, wg, rtol=DCN_TOL, what=name)


def test_dcn_cols_and_bilinear_grad_equal_jax():
    """The im2col (DCN_COLS' plain version) and ``bilinear_sample`` equal
    JAX's sampled and modulated taps and ``_bilinear_sample`` bit for
    bit; the plain BILINEAR_GRAD equals jax.vjp of
    ``_bilinear_sample`` with respect to the map within DCN_TOL, with a
    scale per sample and some samples left out; the plain POINT_SAMPLE
    equals JAX's gather bit for bit, 0 where not valid."""
    x, off, mask, w, _ = dcn_inputs(3)
    B, Ho, Wo, K = mask.shape
    ys = jnp.arange(Ho)[:, None, None] - 1 + (jnp.arange(K) // 3)[None, None]
    xs = jnp.arange(Wo)[None, :, None] - 1 + (jnp.arange(K) % 3)[None, None]
    o = off.reshape(B, Ho, Wo, K, 2)
    jys, jxs = ys[None] + o[..., 0], xs[None] + o[..., 1]
    want = np.asarray(jax.vmap(jdcn._bilinear_sample)(
        jnp.asarray(x), jys, jxs)) * mask[..., None]
    got = tdcn.dcn_cols_plain(*T(x, off, mask), tdcn.Taps(3, 3))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tdcn.bilinear_sample(*T(x[0], jys[0], jxs[0])).numpy(),
        np.asarray(jdcn._bilinear_sample(jnp.asarray(x[0]), jys[0], jxs[0])))

    pys = np.asarray(jys).reshape(B, -1)
    pxs = np.asarray(jxs).reshape(B, -1)
    n = pys.shape[1]
    rng = np.random.RandomState(4)
    g = rng.normal(size=(B, n, x.shape[-1])).astype(np.float32)
    scale = rng.uniform(size=(B, n)).astype(np.float32)
    valid = rng.uniform(size=(B, n)) > 0.2

    def sampled(img):
        s = jax.vmap(jdcn._bilinear_sample)(img, jnp.asarray(pys),
                                            jnp.asarray(pxs))
        return jnp.where(jnp.asarray(valid)[..., None], s, 0.0)

    _, vjp = jax.vjp(sampled, jnp.asarray(x))
    want_g, = vjp(jnp.asarray(g * scale[..., None]))
    got_g = tdcn.bilinear_grad_plain(*T(g, scale, pys, pxs, valid),
                                     *x.shape[1:3])
    close(got_g, want_g, rtol=DCN_TOL, what='bilinear_grad')
    got_p = tdcn.point_sample_plain(*T(x, pys, pxs, valid))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(sampled(x)))


# ---------------------------------------------------------------------------
# DeformConvBNReLU, the upsampling, DLASeg
# ---------------------------------------------------------------------------

def load(module, variables):
    module.load_state_dict(params_from_jax(variables), strict=True)
    return module


def jax_module_run(jm, inputs, seed, train):
    """Seeded variables of ``jm`` and its output (and updated statistics)
    in eval or train mode."""
    shapes = jax.eval_shape(lambda *a: jm.init(jax.random.PRNGKey(0), *a,
                                               False), *inputs)
    v = random_variables(shapes, seed)
    out, upd = jax.jit(lambda v, *a: jm.apply(
        v, *a, train, mutable=['batch_stats']))(v, *inputs)
    return v, out, upd


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_deform_conv_bn_relu_equals_jax(train):
    """DeformConvBNReLU(8 → 6) at 9 x 11 from the same weights (the
    offset-and-mask conv random, not zero, so that the taps move): the
    output within DCN_TOL of the largest; in train mode the running
    statistics too."""
    from tmae_tpu.models.layers import DeformConvBNReLU as JDCN
    from tmae_tpu_torch.models.layers import DeformConvBNReLU

    x = np.random.RandomState(5).normal(size=(2, 9, 11, 8)).astype(
        np.float32)
    v, want, upd = jax_module_run(JDCN(6), J(x), 6, train)
    tm = load(DeformConvBNReLU(8, 6), v).train(train)
    with torch.no_grad():
        got = tm(*T(x))
    close(got, want, rtol=DCN_TOL, what='dcn block')
    if train:
        for k, w in jax_stats(upd).items():
            close(tm.state_dict()[k], w.numpy(), rtol=DCN_TOL, what=k)


@pytest.mark.parametrize('factor', [2, 4, 8])
def test_resize_up_equals_jax_image_resize(factor):
    """resize_up (a product with a fixed matrix a side) equals
    jax.image.resize's bilinear upsampling at integer factors, the border
    rows and columns included, and F.interpolate(align_corners=False),
    within 1e-6 of the largest value."""
    from tmae_tpu.models.dla import _resize_up
    from tmae_tpu_torch.models.dla import resize_up

    x = np.random.RandomState(factor).normal(size=(2, 5, 7, 3)).astype(
        np.float32)
    want = np.asarray(_resize_up(jnp.asarray(x), factor))
    got = resize_up(torch.from_numpy(x), factor)
    close(got, want, rtol=1e-6, what='resize')
    interp = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=factor,
        mode='bilinear', align_corners=False).permute(0, 2, 3, 1)
    close(interp, want, rtol=1e-6, what='interpolate')


@pytest.fixture(scope='module')
def dlaseg():
    """JAX's DLASeg (DOWN_RATIO 4, LAST_LEVEL 5) on a 32 x 64 image pair
    from seeded variables: the eval output, the train-mode output and
    statistics."""
    from tmae_tpu.models.dla import DLASeg as JDLASeg

    img = np.random.RandomState(7).normal(size=(2, 32, 64, 3)).astype(
        np.float32)
    jm = JDLASeg({'DOWN_RATIO': 4, 'LAST_LEVEL': 5})
    shapes = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a,
                                              False), jnp.asarray(img))
    v = random_variables(shapes, 8)
    run = jax.jit(lambda v, a, train: jm.apply(v, a, train,
                                               mutable=['batch_stats']),
                  static_argnums=2)
    out = {'img': img, 'v': v,
           **{mode: run(v, jnp.asarray(img), mode == 'train')
              for mode in ('eval', 'train')}}
    cot = np.random.RandomState(9).normal(
        size=out['eval'][0].shape).astype(np.float32)

    @jax.jit
    def grads(params, a):
        _, vjp = jax.vjp(lambda p, a: jm.apply(
            {'params': p, 'batch_stats': v['batch_stats']}, a, False),
            params, a)
        return vjp(jnp.asarray(cot))

    out.update(cot=cot, grads=grads(v['params'], jnp.asarray(img)))
    return out


@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_dlaseg_equals_jax(dlaseg, mode):
    """DLASeg after a strict load (16 DCN blocks: DLAUp 2 + 4 + 6, the
    final IDAUp 4): the stride-4 map [2, 8, 16, 64] within DLA_TOL of the
    largest value in eval mode, DLA_TRAIN_TOL in train mode, where every
    running statistic is held to DLA_TRAIN_TOL too."""
    from tmae_tpu_torch.models.dla import DLASeg
    from tmae_tpu_torch.models.layers import DeformConvBNReLU

    want, upd = dlaseg[mode]
    tm = load(DLASeg({'DOWN_RATIO': 4, 'LAST_LEVEL': 5}), dlaseg['v'])
    assert sum(isinstance(m, DeformConvBNReLU) for m in tm.modules()) == 16
    tm.train(mode == 'train')
    with torch.no_grad():
        got = tm(torch.from_numpy(dlaseg['img']))
    assert got.shape == (2, 8, 16, 64)
    tol = DLA_TOL if mode == 'eval' else DLA_TRAIN_TOL
    close(got, want, rtol=tol, what='dlaseg')
    if mode == 'train':
        for k, w in jax_stats(upd).items():
            close(tm.state_dict()[k], w.numpy(), rtol=tol, what=k)


# ---------------------------------------------------------------------------
# PointSample and the head
# ---------------------------------------------------------------------------

def forward_camera(h, w, f, back=10.0):
    """A camera looking along +x of the lidar frame from ``back`` m behind
    the origin (``tests/once_fixture.py``'s axes): lidar→camera [4, 4] and
    the intrinsics [3, 4] of an h x w image of focal length f."""
    c2v = np.eye(4)
    c2v[:3, :3] = [[0, 0, 1], [-1, 0, 0], [0, -1, 0]]
    c2v[0, 3] = -back
    K = np.array([[f, 0, w / 2, 0], [0, f, h / 2, 0], [0, 0, 1, 0]])
    return (np.linalg.inv(c2v).astype(np.float32), K.astype(np.float32))


def rotation_z(a):
    m = np.eye(4, dtype=np.float32)
    m[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    return m


def test_point_sample_and_its_gradient_equal_jax():
    """PointSample with aug_inverse (a rotation of each sample), scale 1
    and the image's own shape: the in-image mask exactly (points behind
    the camera and beside the image among them), the features within
    DCN_TOL of the largest, and their gradient to the feature map
    (BILINEAR_GRAD's plain version) against jax.vjp within DCN_TOL."""
    from tmae_tpu.models.point_sample import point_sample as j_ps
    from tmae_tpu_torch.models.point_sample import point_sample as t_ps

    rng = np.random.RandomState(9)
    B, N, H, W, C, stride = 2, 300, 40, 56, 6, 4
    l2c, K = forward_camera(H, W, 30.0)
    pts = rng.uniform([-14, -12, -3], [14, 12, 3], (B, N, 3)).astype(
        np.float32)
    inv = np.stack([rotation_z(0.3), rotation_z(-1.1)])
    aug = np.einsum('bij,bnj->bni', np.linalg.inv(inv)[:, :3, :3], pts)
    feats = rng.normal(size=(B, H // stride, W // stride, C)).astype(
        np.float32)
    l2cs, Ks = np.stack([l2c] * B), np.stack([K] * B)

    def jax_side(f):
        return j_ps(jnp.asarray(aug.astype(np.float32)), f,
                    jnp.asarray(l2cs), jnp.asarray(Ks), (H, W),
                    feat_stride=stride, aug_inverse=jnp.asarray(inv))

    (want, wvalid), vjp = jax.vjp(jax_side, jnp.asarray(feats))
    cot = rng.normal(size=want.shape).astype(np.float32)
    want_g, = vjp((jnp.asarray(cot), np.zeros(wvalid.shape, jax.dtypes.float0)))
    tf = torch.from_numpy(feats).requires_grad_()
    got, valid = t_ps(torch.from_numpy(aug.astype(np.float32)), tf,
                      *T(l2cs, Ks), torch.tensor([[H, W]] * B),
                      torch.ones(B, 2), feat_stride=stride,
                      aug_inverse=torch.from_numpy(inv))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))
    assert 0.2 < valid.float().mean() < 0.9
    close(got, want, rtol=DCN_TOL, what='point_sample')
    close(tf.grad, want_g, rtol=DCN_TOL, what='d image features')


def head_cfg():
    from tests.test_torch_port_graph_rcnn import tiny_cfg

    roi_cfg = copy.deepcopy(tiny_cfg().MODEL.ROI_HEAD)
    roi_cfg.IMG_CONFIG = {'MLPS': [4], 'FEAT_STRIDE': 4}
    return roi_cfg


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_graph_rcnn_head_with_image_branch_equals_jax(train, monkeypatch):
    """GraphRCNNHead with IMG_CONFIG (MLPS [4]: img_conv0, 8 → 4; FEAT_STRIDE
    4) on 8-channel image features of a 100 x 100 image seen by a forward
    camera, the pooled points' world positions sampled there (some in the
    image): rcnn_cls and rcnn_reg within HEAD_TOL of the largest; in train
    mode on JAX's keep masks, the running statistics too, and the
    gradients of a seeded cotangent of both outputs against ``jax.vjp``:
    every parameter's (img_conv0 and AttnGNN's input layer among them) and
    the image features' (through PointSample's backward) within HEAD_TOL
    relative L2 each."""
    from tests.test_torch_port_graph_rcnn import head_inputs
    from tests.test_torch_port_train import _rel
    from tmae_tpu.models.graph_rcnn import GraphRCNNHead as JHead
    from tmae_tpu_torch.models.graph_rcnn import GraphRCNNHead
    from tmae_tpu_torch.utils.from_jax import tree_from_jax

    roi_cfg = head_cfg()
    pts, pmask, rois, rmask = head_inputs()
    B = pts.shape[0]
    l2c, K = forward_camera(100, 100, 60.0)
    feats = np.random.RandomState(10).normal(size=(B, 25, 25, 8)).astype(
        np.float32)
    j_img = {'image_features': jnp.asarray(feats),
             'trans_lidar_to_cam': jnp.asarray(np.stack([l2c] * B)),
             'trans_cam_to_img': jnp.asarray(np.stack([K] * B)),
             'image_shape': (100, 100), 'aug_inverse': None}
    jm = JHead(roi_cfg, num_class=1)
    args = J(pts, pmask, rois, rmask)
    shapes = jax.eval_shape(lambda *a: jm.init(
        jax.random.PRNGKey(0), *a, False, image_inputs=j_img), *args)
    v = random_variables(shapes, 11)
    assert 'img_conv0' in v['params']
    rec = Recorder(monkeypatch)
    (jc, jr), upd = jm.apply(v, *args, train, image_inputs=j_img,
                             mutable=['batch_stats'],
                             rngs={'dropout': jax.random.PRNGKey(12)})
    keep = keep_masks(rec.keep) or None
    tm = GraphRCNNHead(roi_cfg, 4, image_channels=8)
    tm.load_state_dict(params_from_jax(v), strict=True)
    tm.train(train)
    t_img = {'image_features': torch.from_numpy(feats),
             'trans_lidar_to_cam': torch.from_numpy(np.stack([l2c] * B)),
             'trans_cam_to_img': torch.from_numpy(np.stack([K] * B)),
             'image_shape': torch.tensor([[100, 100]] * B),
             'image_scale': torch.ones(B, 2)}
    with torch.no_grad():
        out = tm(*T(pts, pmask, rois, rmask), keep=keep,
                 image_inputs=t_img)
    close(out[0], jc, rtol=HEAD_TOL, what='rcnn_cls')
    close(out[1], jr, rtol=HEAD_TOL, what='rcnn_reg')
    if not train:  # the image features reach the outputs
        with torch.no_grad():
            blind = tm(*T(pts, pmask, rois, rmask), image_inputs=dict(
                t_img, image_features=torch.zeros_like(
                    t_img['image_features'])))
        assert not torch.equal(blind[1], out[1])
    if not train:
        return
    for k, w in jax_stats(upd).items():
        close(tm.state_dict()[k], w.numpy(), rtol=HEAD_TOL, what=k)

    def head(params, img_feats):
        (c, r), _ = jm.apply(dict(v, params=params), *args, True,
                             image_inputs=dict(j_img,
                                               image_features=img_feats),
                             mutable=['batch_stats'],
                             rngs={'dropout': jax.random.PRNGKey(12)})
        return c, r

    (jc2, jr2), vjp = jax.vjp(head, v['params'], j_img['image_features'])
    np.testing.assert_array_equal(jc2, jc)  # the same dropout masks
    rng = np.random.RandomState(13)
    cot = [rng.normal(size=x.shape).astype(np.float32) for x in (jc, jr)]
    jg, jg_feats = vjp(tuple(jnp.asarray(c) for c in cot))
    want = tree_from_jax(jax.device_get(jg))
    tf = torch.from_numpy(feats).requires_grad_()
    c, r = tm(*T(pts, pmask, rois, rmask), keep=keep,
              image_inputs=dict(t_img, image_features=tf))
    ((c * torch.from_numpy(cot[0])).sum()
     + (r * torch.from_numpy(cot[1])).sum()).backward()
    got = {n: torch.zeros_like(p) if p.grad is None else p.grad
           for n, p in tm.named_parameters()}
    assert sorted(got) == sorted(want)
    assert got['img_conv0.weight'].abs().max() > 0
    for n in want:
        if want[n].abs().max() > 0:
            assert _rel(got[n], want[n]) <= HEAD_TOL, n
        else:
            assert got[n].abs().max() == 0, n
    want_feats = torch.from_numpy(np.array(jg_feats))
    assert want_feats.abs().max() > 0
    assert _rel(tf.grad, want_feats) <= HEAD_TOL


# ---------------------------------------------------------------------------
# the detector of graph_rcnn_once_cam_mini.yaml
# ---------------------------------------------------------------------------

def camera_batch(gt=None, seed=0):
    """``tests/test_torch_port_graph_rcnn.tiny_batch``'s voxels, 512 points
    spread over the whole range, and a 32 x 64 image a sample seen by a
    forward camera 32 m behind the origin, which sees most of them (scale
    1, no padding: F16 does not enter)."""
    from tests.test_torch_port_graph_rcnn import tiny_batch

    batch = tiny_batch(gt, seed, P=512)
    B = batch['points'].shape[0]
    batch['points'][..., :2] = np.random.RandomState(seed + 2).uniform(
        -30, 30, (B, 512, 2))
    l2c, K = forward_camera(32, 64, 20.0, back=32.0)
    batch.update(
        images=np.random.RandomState(seed + 1).normal(
            size=(B, 32, 64, 3)).astype(np.float32),
        trans_lidar_to_cam=np.stack([l2c] * B),
        trans_cam_to_img=np.stack([K] * B))
    return batch


def port_batch(batch):
    from tmae_tpu_torch.models.detectors import batch_to_device

    B = batch['images'].shape[0]
    return batch_to_device(dict(
        batch, image_shape=np.array([[32, 64]] * B, np.int32),
        image_scale=np.ones((B, 2), np.float32)), 'cpu')


@pytest.fixture(scope='module')
def cam_graph():
    """Both packages' GraphRCNN of graph_rcnn_once_cam_mini.yaml (anchors
    at the backbone's stride 8, JAX's conv_out padded as in F11) from the
    same weights: eval outputs on a camera batch; JAX's train-mode
    proposals, keep masks and draw with ground truth planted on two
    proposals a sample, its loss and gradients and the control's (the BEV
    backbone's weights rounded once to bf16); the port's eval outputs on
    JAX's proposals and its train-mode loss and gradients on JAX's
    proposals, draw and masks."""
    from tests.test_torch_port_anchor import _bf16_rounded
    from tests.test_torch_port_graph_rcnn import (jax_dense_head,
                                                  jax_graph_rcnn,
                                                  recorded_train_apply)
    from tmae_tpu.config import Cfg as JCfg
    from tmae_tpu.models import backbone3d_voxel as jvb
    from tmae_tpu.models import graph_rcnn as jgr
    from tmae_tpu_torch.models import backbone3d_voxel as tvb
    from tmae_tpu_torch.models import detectors as tdet
    from tmae_tpu_torch.utils.from_jax import tree_from_jax

    cfg = mini_cfg()
    cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG[0].feature_map_stride = 8
    cfg.RUNTIME.MAX_VOXELS = [64] * 5
    cfg.CLASS_NAMES = ['Car']
    jcfg = JCfg.from_dict(copy.deepcopy(dict(cfg)))
    key, dkey = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    N = int(cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE)
    u = np.array(jax.vmap(lambda k: jax.random.uniform(k, (N,)))(
        jax.random.split(key, 2)))
    out = {'cfg': cfg}
    with pytest.MonkeyPatch.context() as mp:
        orig = jvb.SparseConv3dBlock
        mp.setattr(jvb, 'SparseConv3dBlock', lambda *a, **kw: orig(
            *a, **dict(kw, padding=tvb.CONV_OUT_PADDING)
            if kw.get('name') == 'conv_out' else kw))
        jm = jax_graph_rcnn(jcfg)
        batch = camera_batch()
        jb = {k: jnp.asarray(x) for k, x in batch.items()}
        shapes = jax.eval_shape(lambda b: jm.init(
            {'params': jax.random.PRNGKey(0)}, b, False), jb)
        v = random_variables(shapes, 0)
        assert 'img_backbone' in v['params']
        out['jeval'] = jax.jit(lambda v, b: jm.apply(v, b, False))(v, jb)
        train_apply = recorded_train_apply(jm, key, dkey)
        rois, _, _, rmask = map(np.asarray, train_apply(v, jb)[3])
        gt = np.zeros((2, 2, 8), np.float32)
        for b in range(2):
            idx = np.nonzero(rmask[b])[0][[0, 2]]
            gt[b, :, :7] = rois[b, idx, :7] + [0.1, -0.05, 0.02, 0.05, 0.0,
                                               0.0, 0.05]
            gt[b, :, 7] = 1
        batch = camera_batch(gt)
        jb = {k: jnp.asarray(x) for k, x in batch.items()}
        _, _, keep, proposals = train_apply(v, jb)
        out.update(batch=batch, keep=keep_masks(keep),
                   proposals=[np.asarray(x) for x in proposals])

        def loss_fn(params, stats, b):
            o, _ = jm.apply({'params': params, 'batch_stats': stats}, b, True,
                            proposal_rng=key, mutable=['batch_stats'],
                            rngs={'dropout': dkey})
            return jgr.graph_rcnn_loss(jcfg, o, b,
                                       jax_dense_head(jcfg, params))

        mp.setattr(jgr, 'proposal_layer', lambda *a, **kw: tuple(
            jnp.asarray(x) for x in out['proposals']))
        grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (_, jparts), jg = grad(v['params'], v['batch_stats'], jb)
        ctrl = _bf16_rounded(v)
        (_, ctrl_parts), jg_ctrl = grad(ctrl['params'], ctrl['batch_stats'],
                                        jb)
        # the f32 control: the images moved by a rounding (2^-22 relative)
        jb_img = dict(jb, images=jb['images'] * (1 + 2.0 ** -22))
        _, jg_img = grad(v['params'], v['batch_stats'], jb_img)
    out.update(jparts={k: float(x) for k, x in jparts.items()},
               ctrl_parts={k: float(x) for k, x in ctrl_parts.items()},
               jg=tree_from_jax(jax.device_get(jg)),
               jg_ctrl=tree_from_jax(jax.device_get(jg_ctrl)),
               jg_img=tree_from_jax(jax.device_get(jg_img)))

    tm = tdet.build_detector(cfg, 'cpu')
    tm.load_state_dict(params_from_jax(v), strict=True)
    jp = [torch.from_numpy(np.array(out['jeval'][k])) for k in
          ('rois', 'roi_scores', 'roi_labels', 'roi_mask')]
    jp[2] = jp[2].long()
    with torch.no_grad():
        out['teval'] = tm(port_batch(camera_batch()), proposals=jp)
    hand = [torch.from_numpy(np.array(x)) for x in out['proposals']]
    hand[2] = hand[2].long()
    tm.train()
    tb = port_batch(batch)
    tout = tm(tb, proposals=hand, roi_uniform=torch.from_numpy(u),
              dropout_keep=out['keep'])
    tl, tparts = tdet.detector_loss(cfg, tm)(tout, tb)
    tl.backward()
    out.update(tparts={k: float(x.detach()) for k, x in tparts.items()},
               tg={n: torch.zeros_like(p) if p.grad is None else p.grad
                   for n, p in tm.named_parameters()})
    return out


def test_graph_rcnn_cam_mini_eval_equals_jax(cam_graph):
    """Eval mode on JAX's proposals: rcnn_cls and rcnn_reg within HEAD_TOL
    of the largest (DLASeg's features reach them through PointSample)."""
    jo, to = cam_graph['jeval'], cam_graph['teval']
    close(to['rcnn_cls'], jo['rcnn_cls'], rtol=HEAD_TOL, what='rcnn_cls')
    close(to['rcnn_reg'], jo['rcnn_reg'], rtol=HEAD_TOL, what='rcnn_reg')


def test_graph_rcnn_cam_mini_loss_and_gradients_equal_jax(cam_graph):
    """One train-mode loss on JAX's proposals, draw and masks: each part
    within 1% of JAX's or within twice the bf16 control's distance from
    JAX's (the first stage's anchor losses: the port's BEV backbone runs
    in bf16; the control is JAX with the BEV backbone's weights rounded
    once to bf16). The gradients of the second stage and DLASeg (the
    first stage's are the lidar-only path's, held in
    tests/test_torch_port_graph_rcnn.py) at relative L2 at most
    twice the f32 control's (JAX with the images moved by 2^-22 relative,
    a rounding), cosine at least its less 0.02, together and the second
    stage's alone: in train mode at 32 x 64 DLASeg's deep batch norms see
    4 values a channel, and a rounding of the input moves these gradients
    by some 15% in JAX itself, the second stage's by some 14% through the
    image features (test_dlaseg_gradients_equal_jax holds DLASeg's
    tightly in eval mode, test_graph_rcnn_head_with_image_branch_equals_jax
    the head's image branch in train mode).
    DLASeg's gradient not all 0; every gradient finite."""
    from tests.test_torch_port_train import _cos, _rel

    m = cam_graph
    assert sorted(m['tparts']) == sorted(m['jparts'])
    for k, want in m['jparts'].items():
        ctrl_err = abs(m['ctrl_parts'][k] - want)
        assert abs(m['tparts'][k] - want) <= max(
            0.01 * abs(want) + 1e-6, 2 * ctrl_err), k
    jg, tg = m['jg'], m['tg']
    assert sorted(jg) == sorted(tg)
    names = sorted(jg)
    ns = [n for n in names if n.startswith(('roi_head', 'img_backbone'))]
    cat = lambda d, ns: torch.cat([d[n].flatten() for n in ns])
    rel, cos = _rel(cat(tg, ns), cat(jg, ns)), _cos(cat(tg, ns), cat(jg, ns))
    ctrl = m['jg_img']
    rel_c, cos_c = _rel(cat(ctrl, ns), cat(jg, ns)), _cos(cat(ctrl, ns),
                                                          cat(jg, ns))
    print(f'second stage and DLASeg: port vs JAX relative L2 {rel:.5f}, '
          f'cosine {cos:.6f}; the f32 control {rel_c:.5f}, {cos_c:.6f}')
    assert rel <= max(2 * rel_c, 1e-3) and cos >= cos_c - 0.02
    head = [n for n in names if n.startswith('roi_head')]
    rel_h, cos_h = _rel(cat(tg, head), cat(jg, head)), _cos(cat(tg, head),
                                                            cat(jg, head))
    rel_hc, cos_hc = (_rel(cat(ctrl, head), cat(jg, head)),
                      _cos(cat(ctrl, head), cat(jg, head)))
    print(f'second stage alone: port vs JAX relative L2 {rel_h:.5f}, cosine '
          f'{cos_h:.6f}; the f32 control {rel_hc:.5f}, {cos_hc:.6f}')
    assert rel_h <= max(2 * rel_hc, 1e-3) and cos_h >= cos_hc - 0.02
    img = cat(tg, [n for n in names if n.startswith('img_backbone')])
    assert img.abs().max() > 0
    assert all(torch.isfinite(g).all() for g in tg.values())


def test_dlaseg_gradients_equal_jax(dlaseg):
    """Eval mode, a random cotangent of the stride-4 map: the gradients of
    the image and of every parameter (through the 16 DCN blocks'
    backward: d x, d offset, d mask, d weight) against jax.vjp, within
    DLA_TOL relative L2 each, the image's also within DLA_TOL of its
    largest value."""
    from tests.test_torch_port_train import _rel
    from tmae_tpu_torch.models.dla import DLASeg
    from tmae_tpu_torch.utils.from_jax import tree_from_jax

    tm = load(DLASeg({'DOWN_RATIO': 4, 'LAST_LEVEL': 5}), dlaseg['v']).eval()
    img = torch.from_numpy(dlaseg['img']).requires_grad_()
    (tm(img) * torch.from_numpy(dlaseg['cot'])).sum().backward()
    want_p, want_img = dlaseg['grads']
    close(img.grad, want_img, rtol=DLA_TOL, what='d image')
    assert _rel(img.grad, torch.from_numpy(np.asarray(want_img))) <= DLA_TOL
    want = tree_from_jax(jax.device_get(want_p))
    got = {n: torch.zeros_like(p) if p.grad is None else p.grad
           for n, p in tm.named_parameters()}
    assert sorted(got) == sorted(want)
    for n in want:
        if want[n].abs().max() > 0:
            assert _rel(got[n], want[n]) <= DLA_TOL, n
        else:
            assert got[n].abs().max() == 0, n


# ---------------------------------------------------------------------------
# F16 and the CLIs
# ---------------------------------------------------------------------------

def test_f16_jax_samples_the_raw_pixel_the_port_the_processed_one(cam_once):
    """On the fixture's JPGs (96 x 64, imrescale 0.5 → 48 x 32, impad to 64
    x 32), over a stride-4 map whose features are their own (y, x): a
    point that projects to raw pixel (40, 24) lies at processed pixel
    (20, 12), feature (5, 3); JAX samples feature (10, 6), twice its
    position. A point at raw pixel (80, 50), processed (40, 25), feature
    (10, 6.25): JAX tests the raw pixel against the padded 64 x 32 and
    drops it. The port samples both at their feature positions, and with
    ``image_flip`` at the mirrored ones."""
    from tmae_tpu.models.point_sample import point_sample as j_ps
    from tmae_tpu_torch.datasets.dataset import build_dataloader as t_build
    from tmae_tpu_torch.models.point_sample import point_sample as t_ps

    cfg = mini_cfg()
    _, loader = t_build(cfg.DATA_CONFIG, CLASSES, 1, False,
                        runtime_cfg=dict(cfg.RUNTIME),
                        root_path=str(cam_once), seed=0)
    b = next(iter(loader))
    l2c, K = b['trans_lidar_to_cam'][0], b['trans_cam_to_img'][0]
    depth = 12.0
    pix = np.array([[40.0, 24.0], [80.0, 50.0]])
    cam = np.linalg.inv(K[:, :3]) @ np.c_[pix * depth, [depth] * 2].T
    pts = (np.linalg.inv(l2c) @ np.r_[cam, np.ones((1, 2))])[:3].T
    pts = pts[None].astype(np.float32)
    Hf, Wf = b['images'].shape[1] // 4, b['images'].shape[2] // 4
    yy, xx = np.meshgrid(np.arange(Hf), np.arange(Wf), indexing='ij')
    feats = np.stack([yy, xx], -1).astype(np.float32)[None]
    jf, jv = j_ps(jnp.asarray(pts), jnp.asarray(feats),
                  jnp.asarray(b['trans_lidar_to_cam']),
                  jnp.asarray(b['trans_cam_to_img']),
                  tuple(b['images'].shape[1:3]), feat_stride=4)
    tf, tv = t_ps(*T(pts, feats, b['trans_lidar_to_cam'],
                     b['trans_cam_to_img'], b['image_shape'],
                     b['image_scale']), feat_stride=4)
    np.testing.assert_allclose(np.asarray(jf)[0, 0], [6.0, 10.0], atol=1e-4)
    assert np.asarray(jv).tolist() == [[True, False]]
    np.testing.assert_array_equal(np.asarray(jf)[0, 1], [0.0, 0.0])
    assert tv.tolist() == [[True, True]]
    np.testing.assert_allclose(tf[0].numpy(), [[3.0, 5.0], [6.25, 10.0]],
                               atol=1e-4)
    # imflip: the processed pixel u mirrored to 48 - 1 - u
    tf, tv = t_ps(*T(pts, feats, b['trans_lidar_to_cam'],
                     b['trans_cam_to_img'], b['image_shape'],
                     b['image_scale']), feat_stride=4,
                  image_flip=torch.tensor([True]))
    assert tv.tolist() == [[True, True]]
    np.testing.assert_allclose(tf[0].numpy(), [[3.0, 6.75], [6.25, 1.75]],
                               atol=1e-4)


def runnable_mini_yaml(path):
    """graph_rcnn_once_cam_mini.yaml with its anchors at the port's map
    stride 8 (its 16 fits the JAX package's conv_out, which shrinks the
    map: F11), an anchor a class, and its POST_PROCESSING under MODEL (at
    the top level no evaluator reads it), written to ``path``."""
    import json

    import yaml

    cfg = json.loads(json.dumps(mini_cfg()))
    car, = cfg['MODEL']['DENSE_HEAD']['ANCHOR_GENERATOR_CONFIG']
    cfg['MODEL']['DENSE_HEAD']['ANCHOR_GENERATOR_CONFIG'] = [
        dict(car, class_name=c, feature_map_stride=8)
        for c in cfg['CLASS_NAMES']]
    cfg['MODEL']['POST_PROCESSING'] = dict(cfg.pop('POST_PROCESSING'),
                                           EVAL_METRIC='once')
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_f11_the_mini_camera_config_fits_jaxs_shrunk_map():
    """graph_rcnn_once_cam_mini.yaml places its anchors at
    feature_map_stride 16: on its 32 x 32 grid that fits the JAX
    package's conv_out, which shrinks VoxelBackBone8x's 4 x 4 map to 2 x 2
    (F11), and JAX builds and runs it; the port pads conv_out as the
    reference does, its map is 4 x 4 (32 predictions against 8 anchors)
    and the forward raises; at stride 8 the port runs it
    (test_cli_graph_rcnn_cam_mini_train_and_test)."""
    from tests.test_torch_port_graph_rcnn import jax_graph_rcnn
    from tmae_tpu.config import Cfg as JCfg
    from tmae_tpu_torch.models.detectors import build_detector

    cfg = mini_cfg()
    cfg.RUNTIME.MAX_VOXELS = [64] * 5
    batch = camera_batch()
    jm = jax_graph_rcnn(JCfg.from_dict(copy.deepcopy(dict(cfg))))
    shapes = jax.eval_shape(lambda b: jm.init(
        {'params': jax.random.PRNGKey(0)}, b, False),
        {k: jnp.asarray(x) for k, x in batch.items()})
    assert shapes['params']['dense_head']['conv_cls']['kernel'].shape[-1] \
        == 2 * len(cfg.CLASS_NAMES)
    model = build_detector(cfg, 'cpu')
    assert model.dense_head.anchors_flat().shape[0] == 8
    with pytest.raises(RuntimeError, match='size of tensor'):
        with torch.no_grad():
            model(port_batch(batch))


def test_cli_graph_rcnn_cam_mini_train_and_test(cam_once, tmp_path,
                                                monkeypatch):
    """``tools.train`` one epoch of the mini camera config (anchors at
    stride 8: F11) over the fixture's JPGs with ``--device cpu`` (the
    loader's images, calibration and F16 keys to the model; losses
    finite, the same bits twice with ``--fix_random_seed``), then
    ``tools.test`` on its checkpoint: result.pkl with the val frames in
    order, every AP finite."""
    import pickle

    from tmae_tpu_torch.tools import test as test_cli
    from tmae_tpu_torch.tools import train as train_cli

    monkeypatch.setattr(train_cli, 'OUTPUT_ROOT', tmp_path / 'output')
    monkeypatch.setattr(test_cli, 'OUTPUT_ROOT', tmp_path / 'output')
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    path = runnable_mini_yaml(tmp_path / 'cfgs' / 'once_models' /
                              'graph_rcnn_cam_mini.yaml')
    data = ['--set', 'DATA_CONFIG.DATA_PATH', str(cam_once)]
    runs = [train_cli.main(['--cfg_file', str(path), '--device', 'cpu',
                            '--fix_random_seed', '--epochs', '1',
                            '--extra_tag', tag] + data) for tag in 'ab']
    losses = [[s['loss'] for s in r['steps']] for r in runs]
    assert len(losses[0]) == 2 and all(np.isfinite(losses[0]))
    assert losses[0] == losses[1]
    (rdir, ap), = test_cli.main(['--cfg_file', str(path), '--device', 'cpu',
                                 '--ckpt', str(runs[0]['checkpoints'][-1])]
                                + data).items()
    annos = pickle.loads((rdir / 'result.pkl').read_bytes())
    assert [a['frame_id'] for a in annos] == ['1000', '1001', '1002', '1003']
    aps = [v for k, v in ap.items() if k.startswith('AP_')]
    assert aps and all(np.isfinite(aps))


@pytest.mark.parametrize('name', ['graph_rcnn_once_cam',
                                  'graph_rcnn_once_cam_mini'])
def test_strict_load_of_the_shipped_camera_configs(name, monkeypatch):
    """Both shipped camera configs: the JAX package's variables (their
    shapes traced on a small batch; the full config's range cut to 12.8 m
    square, which changes no parameter) load strictly into the port's
    detector, whose parameters and buffers are those of the config as
    shipped, name for name and shape for shape."""
    from tests.test_torch_port_graph_rcnn import jax_graph_rcnn
    from tmae_tpu.config import Cfg as JCfg
    from tmae_tpu.models import backbone3d_voxel as jvb
    from tmae_tpu_torch.config import cfg_from_yaml_file
    from tmae_tpu_torch.models import backbone3d_voxel as tvb
    from tmae_tpu_torch.models.detectors import build_detector

    cfg = cfg_from_yaml_file(f'tools/cfgs/once_models/{name}.yaml')
    shipped = {k: tuple(v.shape)
               for k, v in build_detector(cfg, 'cpu').state_dict().items()}
    if name == 'graph_rcnn_once_cam':  # F11's padding keeps JAX's map
        orig = jvb.SparseConv3dBlock
        monkeypatch.setattr(jvb, 'SparseConv3dBlock', lambda *a, **kw: orig(
            *a, **dict(kw, padding=tvb.CONV_OUT_PADDING)
            if kw.get('name') == 'conv_out' else kw))
        cfg.DATA_CONFIG.POINT_CLOUD_RANGE = [-6.4, -6.4, -5.0, 6.4, 6.4, 3.0]
    cfg.RUNTIME.MAX_VOXELS = [64] * 5
    jm = jax_graph_rcnn(JCfg.from_dict(copy.deepcopy(dict(cfg))))
    batch = {k: jnp.asarray(x) for k, x in camera_batch().items()}
    shapes = jax.eval_shape(lambda b: jm.init(
        {'params': jax.random.PRNGKey(0)}, b, False), batch)
    model = build_detector(cfg, 'cpu')
    model.load_state_dict(params_from_jax(random_variables(shapes, 1)),
                          strict=True)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == shipped
    assert any(k.startswith('img_backbone.') for k in got)
