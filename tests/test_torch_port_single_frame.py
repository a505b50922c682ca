"""The port's single-frame path against the JAX package on the CPU.

* ``ONCEDataset`` over ``tests/once_fixture.py``'s tree and ``WaymoDataset``
  over the synthetic Waymo records: samples and batches bit for bit, and
  their evaluation equal to JAX's.
* ``DynVFE`` (f32, 1e-5), and the tiny config with ``DynVFE`` and
  ``SPTBackbone`` / ``SPTBackboneMAE`` (``GDMAE``) from the same weights
  (``params_from_jax``, strict): head maps at the tiny model's bf16 bounds,
  GD-MAE's outputs and Chamfer loss on JAX's mask, and one training step's
  loss and gradients of each, held to the bf16 control (JAX's step with
  its encoder weights rounded once to bf16) as
  ``tests/test_torch_port_iou_head.py`` holds them, on the config cut to
  one SST stage.
* F9: JAX's ``SPTBackbone`` drops ``OCC_MID_CAPS``; on one input with a
  tight full cap JAX's ``occ_overflow`` is above 0 where the port's, which
  runs the mid bucket, is 0.
* The list path (``ops/windows.py``, ``CosineWindowAttention``,
  ``EncoderLayer``, ``BasicShiftBlock``, ``make_partitions``,
  ``downsample_coords``) against JAX on ``tests/test_windows.py``'s cases
  and on random voxel lists with ``max_tokens`` below 64.
* The training and evaluation CLIs: GD-MAE pretraining, single-frame
  CenterPoint finetuning from its checkpoint, ``tools.test``.
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

from tests.once_fixture import CLASSES
from tests.test_torch_port_iou_head import one_stage
from tests.test_torch_port_model import random_variables
from tests.test_torch_port_once_data import (assert_same_batches, raw_cfg,
                                             raw_once, runtime)  # noqa: F401
from tests.test_torch_port_train import (_cos, _pre_bn_bias, _rel,
                                         _train_cfg_and_batch)
from tests.test_torch_port_train_cli import cli_cfg
from tests.test_torch_port_waymo import CLASSES as WAYMO_CLASSES
from tests.test_torch_port_waymo import RUNTIME as WAYMO_RUNTIME
from tests.test_torch_port_waymo import assert_same, data_cfg, make_processed
from tests.tiny_cfg import synth_batch, tiny_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.datasets.dataset import build_dataloader as j_build
from tmae_tpu.models import detectors as jdet
from tmae_tpu.models import sst as jsst
from tmae_tpu.models.vfe import DynVFE as JDynVFE
from tmae_tpu.ops import voxelize as jvox
from tmae_tpu.ops import windows as jwin
from tmae_tpu.train.trainer import collect_occ_overflow
from tmae_tpu_torch.datasets.dataset import build_dataloader as t_build
from tmae_tpu_torch.models import detectors as tdet
from tmae_tpu_torch.models import sst as tsst
from tmae_tpu_torch.models.vfe import DynVFE
from tmae_tpu_torch.ops import voxelize as tvox
from tmae_tpu_torch.ops import windows as twin
from tmae_tpu_torch.tools import test as test_cli
from tmae_tpu_torch.tools import train as train_cli
from tmae_tpu_torch.utils.from_jax import params_from_jax, tree_from_jax

# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('training', [True, False], ids=['train', 'eval'])
def test_once_single_frame_batches_equal_jax(raw_once, training):
    """One sample a frame (gt_sampling and the augmentations in training):
    every batch equal to JAX's key by key, no previous frame."""
    cfg = raw_cfg()
    cfg.DATASET = 'ONCEDataset'
    loaders = [build(copy.deepcopy(cfg), CLASSES, 2, training,
                     runtime_cfg=runtime(False, 1024),
                     root_path=str(raw_once), seed=5)[1]
               for build in (j_build, t_build)]
    batches = assert_same_batches(*loaders)
    ds = loaders[1].dataset
    assert type(ds).__name__ == 'ONCEDataset'
    assert len(ds) == len(ds.once_infos) == 6
    assert 'points_prev' not in batches[0]
    assert len(batches) == 3


@pytest.mark.parametrize('native', [True, False], ids=['native', 'numpy'])
def test_once_single_frame_evaluation_equal_jax(raw_once, native):
    """``evaluation`` of noisy detections of every frame's boxes equal to
    JAX's."""
    cfg = raw_cfg()
    cfg.DATASET = 'ONCEDataset'
    dsets = [build(copy.deepcopy(cfg), CLASSES, 1, False,
                   runtime_cfg=runtime(False, 1024),
                   root_path=str(raw_once), seed=0)[0]
             for build in (j_build, t_build)]
    rng = np.random.RandomState(2)
    det = []
    for info in dsets[1].once_infos:
        boxes = np.asarray(info['annos']['boxes_3d'], np.float64).copy()
        boxes[:, :3] += rng.normal(0, 0.15, (len(boxes), 3))
        det.append({'frame_id': info['frame_id'],
                    'name': np.asarray(info['annos']['name']),
                    'score': rng.uniform(0.2, 1, len(boxes)),
                    'boxes_3d': boxes})
    want = dsets[0].evaluation(copy.deepcopy(det), CLASSES)
    got = dsets[1].evaluation(det, CLASSES, native=native)
    assert got[0] == want[0] and got[1] == want[1]
    assert 0 < got[1]['AP_mean/overall'] <= 100


@pytest.fixture(scope='module')
def processed(tmp_path_factory):
    return make_processed(tmp_path_factory.mktemp('waymo_single'))


@pytest.mark.parametrize('training', [True, False], ids=['train', 'eval'])
def test_waymo_single_frame_items_equal_jax(processed, training):
    """Every frame one item (no previous frame, no ``dt``), equal to
    JAX's after the augmentations and processors; then its evaluation."""
    cfg = data_cfg(processed, DATASET='WaymoDataset')
    items, dsets = {}, {}
    for side, build in (('jax', j_build), ('port', t_build)):
        ds, _ = build(copy.deepcopy(cfg), WAYMO_CLASSES, 1, training,
                      runtime_cfg=WAYMO_RUNTIME, seed=3)
        dsets[side] = ds
        items[side] = [ds[i] for i in range(len(ds))]
    assert len(items['port']) == len(dsets['port'].infos) == 14
    assert_same(items['port'], items['jax'])
    assert all('points_prev' not in it and 'dt' not in it
               for it in items['port'])
    if not training:
        rng = np.random.RandomState(1)
        det = []
        for info in dsets['port'].infos:
            annos = info['annos']
            keep = annos['name'] != 'unknown'
            boxes = annos['gt_boxes_lidar'][keep].astype(np.float64)
            boxes[:, :3] += rng.normal(0, 0.1, (len(boxes), 3))
            det.append({'name': annos['name'][keep],
                        'score': rng.uniform(0.2, 1, len(boxes)),
                        'boxes_3d': boxes})
        want = dsets['jax'].evaluation(copy.deepcopy(det), WAYMO_CLASSES)
        got = dsets['port'].evaluation(det, WAYMO_CLASSES)
        assert got[0] == want[0] and got[1] == want[1]


# ---------------------------------------------------------------------------
# DynVFE, SPTBackbone, GD-MAE
# ---------------------------------------------------------------------------


def single_frame_cfg(mae: bool, stages: int = 3):
    """The tiny config with DynVFE and SPTBackbone (GDMAE with
    SPTBackboneMAE), caps that hold every window on both sides (JAX
    without its mid bucket, F9) and a mid bucket the port runs."""
    cfg = copy.deepcopy(tiny_cfg(mae))
    cfg.MODEL.VFE.NAME = 'DynVFE'
    cfg.MODEL.BACKBONE_3D.NAME = 'SPTBackboneMAE' if mae else 'SPTBackbone'
    if mae:
        cfg.MODEL.NAME = 'GDMAE'
    cfg.RUNTIME.OCC_WINDOW_CAPS = [32, 32, 32]
    cfg.RUNTIME.OCC_MID_CAPS = [16, 16, 16]
    return one_stage(cfg) if stages == 1 else cfg


def single_frame_batch(seed=0, **kw):
    b = synth_batch(np.random.RandomState(seed), **kw)
    return {k: v for k, v in b.items() if not k.endswith('_prev')}


def jax_variables(jmodel, batch, seed=0):
    rngs = {'params': jax.random.PRNGKey(0),
            'mae_mask': jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(
        lambda b: jmodel.init(rngs, b, train=False), batch)
    return random_variables(shapes, seed)


def port_model(cfg, v):
    model = tdet.build_detector(cfg, 'cpu')
    model.load_state_dict(params_from_jax(v), strict=True)
    return model


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_dynvfe_matches_jax(train):
    """DynVFE on one frame, voxelized on the device on both sides: voxel
    features within 1e-5 (relative to the largest), coords, mask and the
    point map exactly; in train mode the batch norms' running statistics
    too."""
    cfg = single_frame_cfg(False)
    spec = jdet.make_voxel_spec(cfg.DATA_CONFIG, cfg.RUNTIME)
    mlps = [[8, 16], [32]]
    b = single_frame_batch()
    jm = JDynVFE(spec, mlps)
    pts, pm = jnp.asarray(b['points']), jnp.asarray(b['point_mask'])
    shapes = jax.eval_shape(lambda p, m: jm.init(jax.random.PRNGKey(0), p,
                                                 m, False), pts, pm)
    v = random_variables(shapes, 3)
    jout, upd = jm.apply(v, pts, pm, train, mutable=['batch_stats'])
    tm = DynVFE(spec, mlps)
    tm.load_state_dict(params_from_jax(v), strict=True)
    tm.train(train)
    with torch.no_grad():
        tout = tm(torch.from_numpy(b['points']),
                  torch.from_numpy(b['point_mask']))
    want = np.asarray(jout['voxel_features'])
    err = np.abs(tout['voxel_features'].numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err
    for k in ('voxel_coords', 'voxel_mask', 'point_voxel', 'point_valid'):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    if train:
        stats = params_from_jax({'batch_stats': jax.device_get(
            upd['batch_stats'])})
        for k, want in stats.items():
            np.testing.assert_allclose(tm.state_dict()[k].numpy(),
                                       want.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_spt_centerpoint_head_maps_match_jax():
    """Eval-mode head maps of the three-stage SPTBackbone CenterPoint from
    the same weights: max |diff| <= 0.03, mean <= 3e-3 (the tiny model's
    bounds: bf16 weight rounding); occ_overflow 0 on both sides."""
    cfg = single_frame_cfg(False)
    b = single_frame_batch()
    jmodel = jdet.build_detector(cfg)
    v = jax_variables(jmodel, b)
    assert set(v['params']['backbone_3d']) == {'encoder', 'fuse'}
    jout, mut = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False, mutable=['intermediates']))(v, b)
    tmodel = port_model(cfg, v)
    with torch.no_grad():
        tout = tmodel(tdet.batch_to_device(b, 'cpu'))
    jp, tp = jout['pred_dicts'][0], tout['pred_dicts'][0]
    assert sorted(jp) == sorted(tp)
    for name in jp:
        err = np.abs(tp[name].numpy() - np.asarray(jp[name], np.float32))
        assert err.max() <= 0.03 and err.mean() <= 3e-3, (name, err.max())
    assert int(collect_occ_overflow(mut['intermediates'])) == 0
    assert tout['occ_overflow'].shape == (3, 2)
    assert int(tout['occ_overflow'].sum()) == 0


def test_gdmae_outputs_and_chamfer_match_jax():
    """GDMAE from the same weights on JAX's mask: the loss weights exactly,
    the targets within 1e-6, the predicted points within 0.02 (bf16
    encoder), the Chamfer loss within 1e-3 relative."""
    cfg = single_frame_cfg(True)
    b = single_frame_batch()
    jmodel = jdet.build_detector(cfg)
    v = jax_variables(jmodel, b)
    assert set(v['params']['backbone_3d']) == {
        'encoder', 'decoder_fuse', 'decoder_pred'}
    jout = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False, mask_rng=jax.random.PRNGKey(3)))(v, b)
    tmodel = port_model(cfg, v)
    tb = tdet.batch_to_device(b, 'cpu')
    mask = torch.from_numpy(np.array(jout['mae_mask']))
    with torch.no_grad():
        tout = tmodel(tb, mae_mask=mask)
    for k in ('loss_weights', 'mae_mask'):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    # the voxel centres' f32 roundings (XLA fuses their multiply-add)
    np.testing.assert_allclose(tout['gt_points'].numpy(),
                               np.asarray(jout['gt_points']), atol=1e-6)
    err = np.abs(tout['pred_points'].numpy() - np.asarray(jout['pred_points']))
    assert err.max() <= 0.02, err.max()
    jl = float(jdet.tmae_loss(cfg, jout, b)[0])
    tl = float(tdet.tmae_loss(cfg, tout, tb)[0])
    assert abs(tl - jl) <= 1e-3 * abs(jl), (tl, jl)


@pytest.fixture(scope='module', params=[False, True],
                ids=['centerpoint', 'gdmae'])
def one_step(request):
    """One training step's loss and gradients of the one-stage
    single-frame CenterPoint (or GDMAE, on JAX's mask) from the same
    weights in both packages, and the control's gradients."""
    mae = request.param
    cfg = single_frame_cfg(mae, stages=1)
    b = single_frame_batch()
    if not mae:
        _, tb2 = _train_cfg_and_batch()
        b.update(gt_boxes=tb2['gt_boxes'], gt_mask=tb2['gt_mask'])
    jmodel = jdet.build_detector(cfg)
    v = jax_variables(jmodel, b)
    if not mae:
        v['params']['dense_head']['head_0']['hm_out']['bias'][:] = -2.19
    mask_rng = jax.random.PRNGKey(5)
    loss = jdet.tmae_loss if mae else jdet.centerpoint_loss

    def loss_fn(params, stats, batch):
        kw = {'mask_rng': mask_rng} if mae else {}
        out = jmodel.apply({'params': params, 'batch_stats': stats}, batch,
                           train=True, mutable=['batch_stats'], **kw)[0]
        return loss(cfg, out, batch)

    jgrad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (jloss, _), jg = jgrad(v['params'], v['batch_stats'], b)
    enc = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                             .astype(jnp.float32)),
        v['params']['backbone_3d']['encoder'])
    ctrl = copy.deepcopy(v['params'])
    ctrl['backbone_3d']['encoder'] = enc
    _, jg_ctrl = jgrad(ctrl, v['batch_stats'], b)
    tmodel = port_model(cfg, v)
    tmodel.train()
    tb = tdet.batch_to_device(b, 'cpu')
    kw = {}
    if mae:
        jmask = jmodel.apply(v, b, train=True, mask_rng=mask_rng,
                             mutable=['batch_stats'])[0]['mae_mask']
        kw['mae_mask'] = torch.from_numpy(np.array(jmask))
    tloss, _ = tdet.detector_loss(cfg, tmodel)(tmodel(tb, **kw), tb)
    tloss.backward()
    return dict(jloss=float(jloss), tloss=float(tloss.detach()),
                jg=tree_from_jax(jax.device_get(jg)),
                jg_ctrl=tree_from_jax(jax.device_get(jg_ctrl)),
                tg={n: p.grad.clone() for n, p in tmodel.named_parameters()})


def test_training_step_matches_jax(one_step):
    """The loss within 1% (the encoder's bf16 roundings differ); over all
    gradients but the pre-BN conv biases, the relative L2 error at most
    1.25 times the control's and the cosine at least the control's less
    0.02; every gradient finite."""
    m = one_step
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
    assert all(torch.isfinite(g).all() for g in tg.values())


def test_f9_jax_drops_the_mid_bucket():
    """F9: a dense frame on a 64x64 grid (3000 points: most windows hold
    17-48 pillars) with the full cap at 4 (16 once rounded) and small and
    mid caps that hold the rest. JAX's SPTBackbone gets no mid bucket, so
    those windows go to the full bucket and overflow (run as identity);
    the port runs them in the mid bucket and overflows none."""
    cfg = single_frame_cfg(False, stages=1)
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = [-10.24, -10.24, -5.0, 10.24, 10.24,
                                         3.0]
    cfg.RUNTIME.update(OCC_WINDOW_CAPS=[4], OCC_SMALL_CAPS=[96],
                       OCC_MID_CAPS=[96], MAX_POINTS=3072,
                       MAX_VOXELS=[3072, 96, 64])
    rng = np.random.RandomState(9)
    pts = np.concatenate([rng.uniform(-10, 10, (2, 3072, 2)),
                          rng.uniform(-1, 1, (2, 3072, 2))], -1)
    b = {'points': pts.astype(np.float32),
         'point_mask': np.arange(3072)[None].repeat(2, 0) < 3000}
    jmodel = jdet.build_detector(cfg)
    v = jax_variables(jmodel, b)
    _, mut = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False, mutable=['intermediates']))(v, b)
    j_over = int(collect_occ_overflow(mut['intermediates']))
    with torch.no_grad():
        t_over = int(port_model(cfg, v)(tdet.batch_to_device(b, 'cpu'))[
            'occ_overflow'].sum())
    print(f'occ_overflow: JAX {j_over}, port {t_over}')
    assert j_over > 0 and t_over == 0


# ---------------------------------------------------------------------------
# the list path
# ---------------------------------------------------------------------------


WINDOW_CASES = {
    'unshifted': ([(0, 0), (7, 7), (8, 0)], False, 64),
    'shifted': ([(3, 3), (4, 4)], True, 64),
    'slots': ([(0, 0), (0, 1), (1, 0), (8, 8)], False, 64),
    'capped-ranks': ([(0, 0), (0, 1), (1, 0), (8, 8)], False, 4),
    'drop': ([(0, i % 8) for i in range(6)], False, 4),
    'roundtrip': ([(0, 0), (0, 5), (20, 20), (31, 31)], True, 64),
}


def _voxels(coords, V=8):
    c = np.zeros((1, V, 2), np.int32)
    m = np.zeros((1, V), bool)
    for i, yx in enumerate(coords):
        c[0, i], m[0, i] = yx, True
    return c, m


def _same_partition(t, j):
    for k in ('win_slot', 'inner_rank', 'keep', 'pos_yx'):
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)), err_msg=k)
    assert (t.nw, t.max_tokens) == (j.nw, j.max_tokens)


@pytest.mark.parametrize('case', list(WINDOW_CASES))
def test_window_partition_equals_jax(case):
    """``tests/test_windows.py``'s cases: the partition, the window buffer,
    the key mask and the gather back exactly."""
    coords, shift, T = WINDOW_CASES[case]
    c, m = _voxels(coords)
    wj = jwin.window_partition(jnp.asarray(c), jnp.asarray(m), (32, 32),
                               window=8, shift=shift, max_tokens=T)
    wt = twin.window_partition(torch.from_numpy(c), torch.from_numpy(m),
                               (32, 32), window=8, shift=shift, max_tokens=T)
    _same_partition(wt, wj)
    feat = (np.arange(8, dtype=np.float32)[None, :, None] + 1.0) * np.ones(
        (1, 8, 3), np.float32)
    win_j = jwin.scatter_to_windows(jnp.asarray(feat), wj)
    win_t = twin.scatter_to_windows(torch.from_numpy(feat), wt)
    np.testing.assert_array_equal(win_t.numpy(), np.asarray(win_j))
    np.testing.assert_array_equal(twin.window_key_mask(wt).numpy(),
                                  np.asarray(jwin.window_key_mask(wj)))
    np.testing.assert_array_equal(
        twin.gather_from_windows(win_t, wt).numpy(),
        np.asarray(jwin.gather_from_windows(win_j, wj)))
    assert twin.num_windows((468, 468), 8) == jwin.num_windows((468, 468), 8)


def test_couple_partitions_equals_jax():
    """Windows empty in either frame dropped from both, as JAX drops
    them."""
    parts = []
    for coords in ([(0, 0), (16, 16)], [(0, 1)]):
        c, m = _voxels(coords)
        parts.append((
            jwin.window_partition(jnp.asarray(c), jnp.asarray(m), (32, 32)),
            twin.window_partition(torch.from_numpy(c), torch.from_numpy(m),
                                  (32, 32))))
    jc, jp = jwin.couple_partitions(parts[0][0], parts[1][0])
    tc, tp = twin.couple_partitions(parts[0][1], parts[1][1])
    _same_partition(tc, jc)
    _same_partition(tp, jp)
    assert tc.keep[0, 0] and not tc.keep[0, 1]


def _random_voxels(rng, B=2, V=96, C=16, hw=(32, 32)):
    cells = np.stack([rng.permutation(hw[0] * hw[1])[:V] for _ in range(B)])
    coords = np.stack([cells // hw[1], cells % hw[1]], -1).astype(np.int32)
    mask = rng.rand(B, V) < 0.85
    feat = rng.normal(size=(B, V, C)).astype(np.float32)
    return coords, mask, feat


@pytest.mark.parametrize('max_tokens', [16, 32, 64])
def test_basic_shift_block_equals_jax(max_tokens):
    """``make_partitions`` and ``BasicShiftBlock`` (C = 16, 4 heads, FFN 32)
    on random voxel lists of a 32x32 grid: the partitions (after the
    second ranking below 64 tokens) and embeddings exactly, the block's
    output within 1e-4 relative (f32 products) from the same weights
    (``params_from_jax``, strict)."""
    rng = np.random.RandomState(max_tokens)
    coords, mask, feat = _random_voxels(rng)
    vj = jsst.VoxelSet(jnp.asarray(feat), jnp.asarray(coords),
                       jnp.asarray(mask), (32, 32))
    vt = tsst.VoxelSet(torch.from_numpy(feat), torch.from_numpy(coords),
                       torch.from_numpy(mask), (32, 32))
    wpj, posj = jsst.make_partitions(vj, 8, max_tokens)
    wpt, post = tsst.make_partitions(vt, 8, max_tokens)
    for a, b in zip(wpt, wpj):
        _same_partition(a, b)
    for a, b in zip(post, posj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    if max_tokens < 64:
        assert not bool(wpt[0].keep.all())
    jblk = jsst.BasicShiftBlock(16, 4, 32)
    shapes = jax.eval_shape(lambda f: jblk.init(
        jax.random.PRNGKey(0), f, posj, wpj), vj.feat)
    v = random_variables(shapes, 1)
    want = np.asarray(jblk.apply(v, vj.feat, posj, wpj))
    tblk = tsst.BasicShiftBlock(16, 4, 32)
    tblk.load_state_dict(params_from_jax(v), strict=True)
    with torch.no_grad():
        got = tblk(vt.feat, post, wpt).numpy()
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err


@pytest.mark.parametrize('case', ['spconv-rule', 'random', 'capped'])
def test_downsample_coords_equals_jax(case):
    """Output coords and mask slot for slot: ``tests/test_voxelize.py``'s
    case (y 5 → rows 2 and 3, x 4 → 2), random voxel lists, and a cap
    below the active set."""
    if case == 'spconv-rule':
        coords = np.array([[[5, 4], [0, 0]]], np.int32)
        mask = np.array([[True, False]])
        cap = 8
    else:
        coords, mask, _ = _random_voxels(np.random.RandomState(4),
                                         hw=(33, 31))
        cap = 64 if case == 'random' else 20
    hw = (32, 32) if case == 'spconv-rule' else (33, 31)
    jc, jm = jvox.downsample_coords(jnp.asarray(coords), jnp.asarray(mask),
                                    hw, cap)
    tc, tm = tvox.downsample_coords(torch.from_numpy(coords),
                                    torch.from_numpy(mask), hw, cap)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    if case == 'spconv-rule':
        got = {tuple(c) for c, m in zip(tc[0].tolist(), tm[0].tolist()) if m}
        assert got == {(2, 2), (3, 2)}


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def single_frame_cli_cfg(root, mae, tmp):
    """``tests/test_torch_port_train_cli.cli_cfg``'s tiny config over the
    fixture, single frame: ONCEDataset, DynVFE, SPTBackbone(MAE)."""
    path = cli_cfg(root, mae, tmp)
    import yaml
    cfg = yaml.safe_load(path.read_text())
    cfg['DATA_CONFIG']['DATASET'] = 'ONCEDataset'
    cfg['MODEL']['VFE']['NAME'] = 'DynVFE'
    cfg['MODEL']['BACKBONE_3D']['NAME'] = ('SPTBackboneMAE' if mae
                                           else 'SPTBackbone')
    if mae:
        cfg['MODEL']['NAME'] = 'GDMAE'
    cfg['RUNTIME'].update(OCC_WINDOW_CAPS=[32, 32, 32],
                          OCC_MID_CAPS=[16, 16, 16])
    path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    return path


def test_cli_gdmae_pretrain_finetune_evaluate(raw_once, tmp_path,
                                              monkeypatch):
    """GDMAE pretraining (1 epoch), single-frame CenterPoint finetuning
    from its checkpoint (the encoder carried across, the head at its
    initial values), then ``tools.test``: finite losses, no overflow,
    result.pkl with the val split's frame ids in order, every AP
    finite."""
    monkeypatch.setattr(train_cli, 'OUTPUT_ROOT', tmp_path / 'output')
    monkeypatch.setattr(test_cli, 'OUTPUT_ROOT', tmp_path / 'output')
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    common = ['--device', 'cpu', '--fix_random_seed', '--epochs', '1']
    pre = train_cli.main(['--cfg_file', str(single_frame_cli_cfg(
        raw_once, True, tmp_path))] + common)
    ft_file = single_frame_cli_cfg(raw_once, False, tmp_path)
    ft = train_cli.main(['--cfg_file', str(ft_file), '--pretrained_model',
                         str(pre['checkpoints'][-1])] + common)
    copied, kept = ft['pretrained']
    assert any(k.startswith('backbone_3d.encoder.sst_block_0') for k in copied)
    assert any(k.startswith('dense_head') for k in kept)
    for run in (pre, ft):
        assert all(np.isfinite(s['loss']) and s['occ_overflow'] == 0
                   for s in run['steps'])
    (rdir, ap), = test_cli.main(['--cfg_file', str(ft_file), '--device',
                                 'cpu', '--ckpt',
                                 str(ft['checkpoints'][-1])]).items()
    annos = pickle.loads((rdir / 'result.pkl').read_bytes())
    want = [i['frame_id'] for i in pickle.loads(
        (raw_once / 'once_infos_val.pkl').read_bytes())]
    assert [a['frame_id'] for a in annos] == want
    aps = [v for k, v in ap.items() if k.startswith('AP_')]
    assert aps and all(np.isfinite(aps))
