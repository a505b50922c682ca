"""The pretraining slice of the PyTorch port against the JAX package on the
CPU: the tiny-config TMAE (SiamWCA_MAE) with and without the OCC bucket
caps (without them every encoder layer is the grid-native layer, K10's plain
version, as in ``t_mae_ssl_waymo.yaml``; with them the bucketed path of
``t_mae_ssl.yaml``), on device-voxelized points and on JAX's own mask, with
the weights carried across by ``params_from_jax`` (strict load); one
``adam_onecycle`` step of the capless config with Waymo's five point
features against JAX's ``make_train_step(..., rng_names=('mae_mask',))``,
held to the control (JAX's own step from the encoder's weights rounded once
to bf16, as ``tests/test_torch_port_train.py`` does); and the tiny capless
CenterPoint with Waymo's five point features and three classes (the
``t_mae_waymo.yaml`` serving shape), its head maps and loss. The Waymo
cases give the config Waymo's ``POINT_FEATURE_ENCODING`` (x, y, z,
intensity, elongation), so the port's VFE reads 5 columns, and the batch an
elongation column. The JAX model runs its jnp reference layers (f32
weights), the port the plain versions of its kernels (bf16 weights), so
tolerances cover bf16 rounding; each is stated beside its comparison."""

import copy

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_port_model import random_variables
from tests.test_torch_port_train import _adam_state, _cos, _encoder_rounded, \
    _pre_bn_bias, _rel
from tests.tiny_cfg import synth_batch, tiny_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.models import detectors as jdet
from tmae_tpu.train import optimization as jopt
from tmae_tpu.train import trainer as jtr
from tmae_tpu_torch.models import detectors as tdet
from tmae_tpu_torch.train.optimization import build_optimizer
from tmae_tpu_torch.train.trainer import make_train_step
from tmae_tpu_torch.utils.from_jax import params_from_jax, tree_from_jax

STEPS_PER_EPOCH = 10
OCC_KEYS = ('OCC_WINDOW_CAPS', 'OCC_SMALL_CAPS', 'OCC_SMALL_TOKENS')
WAYMO_FEATURES = ['x', 'y', 'z', 'intensity', 'elongation']
WAYMO_CLASSES = ['Vehicle', 'Pedestrian', 'Cyclist']


def _cfg(mae: bool, caps: bool, waymo: bool = False):
    """The tiny config, with its OCC caps or without them (the grid
    path); ``waymo``: Waymo's point features and, for CenterPoint, its
    three classes in one head."""
    cfg = copy.deepcopy(tiny_cfg(mae=mae))
    if not caps:
        for k in OCC_KEYS:
            del cfg.RUNTIME[k]
    if waymo:
        cfg.DATA_CONFIG.POINT_FEATURE_ENCODING = {
            'encoding_type': 'absolute_coordinates_encoding',
            'used_feature_list': WAYMO_FEATURES,
            'src_feature_list': WAYMO_FEATURES}
        if not mae:
            cfg.CLASS_NAMES = WAYMO_CLASSES
            cfg.MODEL.DENSE_HEAD.CLASS_NAMES_EACH_HEAD = [WAYMO_CLASSES]
    return cfg


def _batch(seed: int, waymo: bool = False):
    """``synth_batch``; ``waymo``: an elongation column after the
    intensity (U(0, 1.5) on real points, 0 on padding) and labels in 1..3."""
    rng = np.random.RandomState(seed)
    batch = synth_batch(rng)
    if waymo:
        for pts, mask in (('points', 'point_mask'),
                          ('points_prev', 'point_mask_prev')):
            elong = rng.uniform(0, 1.5, batch[mask].shape) * batch[mask]
            batch[pts] = np.concatenate(
                [batch[pts], elong[..., None].astype(np.float32)], -1)
        labels = batch['gt_boxes'][..., 7]
        batch['gt_boxes'][..., 7] = np.where(labels > 0,
                                             (labels - 1) % 3 + 1, 0)
    return batch


def _jax_model(cfg, batch):
    jmodel = jdet.build_detector(cfg)
    keys = {'params': jax.random.PRNGKey(0),
            'mae_mask': jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda b: jmodel.init(keys, b, train=False),
                            batch)
    return jmodel, random_variables(shapes, 0)


def _vfe_width(tmodel):
    """Input width of the VFE's first Linear: 3 + the point features + 3
    (the cluster offsets)."""
    return next(m for m in tmodel.vfe.modules()
                if isinstance(m, torch.nn.Linear)).in_features


def _port_model(cfg, v):
    tmodel = tdet.build_detector(cfg, 'cpu')
    tmodel.load_state_dict(params_from_jax(v), strict=True)
    return tmodel


@pytest.mark.parametrize('caps,waymo', [(False, False), (True, False),
                                        (False, True)],
                         ids=['grid', 'bucketed', 'grid-waymo'])
def test_tmae_forward_and_loss_match_jax(caps, waymo):
    """The eval-mode TMAE forward on JAX's mask: the mask, loss weights and
    point targets equal (targets to 1e-6: XLA may fuse the voxel centre's
    multiply-add), predicted points within 0.03 (bf16 carriers, max value
    ~0.6) and 2e-3 in the mean, the Chamfer loss within 1e-3 relative;
    ``occ_overflow`` is [stages*2, B] and 0 without caps. ``grid-waymo``:
    five point features, the VFE's first layer 5 + 3 wide."""
    cfg = _cfg(True, caps, waymo)
    batch = _batch(0, waymo)
    jmodel, v = _jax_model(cfg, batch)
    jout = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False, rngs={'mae_mask': jax.random.PRNGKey(3)}))(
        v, batch)
    jloss, _ = jdet.tmae_loss(cfg, jout, batch)
    tmodel = _port_model(cfg, v)
    jmask = torch.from_numpy(np.array(jout['mae_mask']))
    with torch.no_grad():
        tout = tmodel(tdet.batch_to_device(batch, 'cpu'), mae_mask=jmask)
    tloss, parts = tdet.tmae_loss(cfg, tout, batch)
    np.testing.assert_array_equal(tout['mae_mask'].numpy(), jmask.numpy())
    np.testing.assert_array_equal(tout['loss_weights'].numpy(),
                                  np.asarray(jout['loss_weights']))
    assert 0 < tout['loss_weights'].sum() < tout['mae_mask'].numel()
    np.testing.assert_allclose(tout['gt_points'].numpy(),
                               np.asarray(jout['gt_points']), atol=1e-6,
                               rtol=0)
    err = np.abs(tout['pred_points'].numpy() - np.asarray(jout['pred_points']))
    assert err.max() <= 0.03 and err.mean() <= 2e-3, (err.max(), err.mean())
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-3)
    assert float(parts['loss_rpn']) == float(tloss)
    assert tout['occ_overflow'].shape == (6, 2)
    if not caps:
        assert not tout['occ_overflow'].any()
    assert _vfe_width(tmodel) == 3 + (5 if waymo else 4) + 3


@pytest.fixture(scope='module')
def capless_step():
    """One pretraining step of the capless tiny TMAE with Waymo's five point
    features (the ``t_mae_ssl_waymo.yaml`` shape) in both packages from the
    same weights and on JAX's mask for the step's key, and the control:
    JAX's step from the encoder's weights rounded once to bf16."""
    cfg = _cfg(True, False, waymo=True)
    batch = _batch(1, waymo=True)
    jmodel, v = _jax_model(cfg, batch)
    tx, _ = jopt.build_optimizer(cfg.OPTIMIZATION, STEPS_PER_EPOCH)

    def loss_and_mask(o, b):  # the step's metrics carry the mask out
        loss, parts = jdet.tmae_loss(cfg, o, b)
        return loss, {**parts, 'mae_mask': o['mae_mask']}

    jstep = jax.jit(jtr.make_train_step(jmodel, loss_and_mask, tx,
                                        rng_names=('mae_mask',)))
    key = jax.random.PRNGKey(5)
    state, jm = jstep(jtr.create_train_state(v, tx), batch, key)
    ctrl, _ = jstep(jtr.create_train_state(_encoder_rounded(v), tx), batch,
                    key)
    jm = jax.device_get(jm)
    mask = np.array(jm.pop('mae_mask'))
    tmodel = _port_model(cfg, v)
    opt, sched = build_optimizer(tmodel.parameters(), cfg.OPTIMIZATION,
                                 STEPS_PER_EPOCH)
    tstep = make_train_step(tmodel, lambda o, b: tdet.tmae_loss(cfg, o, b),
                            opt, sched)
    tm = tstep(tdet.batch_to_device(batch, 'cpu'),
               mae_mask=torch.from_numpy(mask))
    moments = {n: opt.state[p]['exp_avg'].clone()
               for n, p in tmodel.named_parameters()}
    return dict(jm={k: float(x) for k, x in jm.items()},
                tm={k: float(x) for k, x in tm.items()},
                mu=tree_from_jax(_adam_state(jax.device_get(
                    state).opt_state).mu),
                ctrl=tree_from_jax(_adam_state(jax.device_get(
                    ctrl).opt_state).mu),
                moments=moments)


def test_pretrain_step_metrics_match_jax(capless_step):
    """Loss and pre-clip grad_norm of the step: within 1% and 5%; the metric
    keys match JAX's (loss, grad_norm, loss_rpn, occ_overflow = 0)."""
    jm, tm = capless_step['jm'], capless_step['tm']
    assert sorted(jm) == sorted(tm)
    assert abs(tm['loss'] - jm['loss']) <= 0.01 * abs(jm['loss'])
    assert abs(tm['grad_norm'] - jm['grad_norm']) <= 0.05 * jm['grad_norm']
    assert tm['occ_overflow'] == jm['occ_overflow'] == 0


def test_pretrain_step_gradients_match_jax_within_control(capless_step):
    """The clipped gradient, read from the first Adam moment on both sides,
    over all parameters but the pre-BN conv biases: relative L2 error at
    most 1.25 times the control's and cosine at least the control's less
    0.02; per tensor (matrices and vectors with a nonzero gradient)
    relative L2 error <= 0.75 and norm ratio within [2/3, 3/2], which a
    zero, foreign or doubled gradient breaks."""
    mu, ctrl = capless_step['mu'], capless_step['ctrl']
    got = capless_step['moments']
    names = [n for n in mu if not _pre_bn_bias(n)]
    assert sorted(names) == sorted(n for n in got if not _pre_bn_bias(n))
    cat = lambda d: torch.cat([d[n].flatten() for n in names])
    rel, cos = _rel(cat(got), cat(mu)), _cos(cat(got), cat(mu))
    rel_c, cos_c = _rel(cat(ctrl), cat(mu)), _cos(cat(ctrl), cat(mu))
    print(f'pretraining gradient: port vs JAX relative L2 error {rel:.4f}, '
          f'cosine {cos:.5f}; control {rel_c:.4f}, {cos_c:.5f}')
    assert rel <= 1.25 * rel_c and cos >= cos_c - 0.02, (rel, cos, rel_c,
                                                          cos_c)
    live = [n for n in names if mu[n].numel() > 1 and mu[n].any()]
    assert len(live) > 0.8 * len(names)
    for n in live:
        ratio = float(got[n].double().norm() / mu[n].double().norm())
        assert _rel(got[n], mu[n]) <= 0.75, (n, _rel(got[n], mu[n]))
        assert 2 / 3 <= ratio <= 1.5, (n, ratio)


def test_capless_centerpoint_forward_matches_jax():
    """The tiny CenterPoint without caps and without host voxelization, with
    Waymo's five point features and three classes (the ``t_mae_waymo.yaml``
    serving shape: device voxelization, the scatter VFE, grid-native
    layers) in eval mode: head maps within 0.03 and 3e-3 in the mean, as
    the bucketed tiny slice is held; no overflow; ``centerpoint_loss`` on
    each side's head maps and the batch's boxes, and its per-head parts,
    within 1%, as the first training step's are held."""
    cfg = _cfg(False, False, waymo=True)
    batch = _batch(2, waymo=True)
    jmodel, v = _jax_model(cfg, batch)
    jout = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(v, batch)
    tmodel = _port_model(cfg, v)
    assert _vfe_width(tmodel) == 3 + 5 + 3
    with torch.no_grad():
        tout = tmodel(tdet.batch_to_device(batch, 'cpu'))
    assert jout['pred_dicts'][0]['hm'].shape[-1] == 3
    for name, a in jout['pred_dicts'][0].items():
        err = np.abs(tout['pred_dicts'][0][name].numpy()
                     - np.asarray(a, np.float32))
        assert err.max() <= 0.03 and err.mean() <= 3e-3, (name, err.max())
    assert not tout['occ_overflow'].any()
    jl, jparts = jdet.centerpoint_loss(
        cfg, jout, {k: jax.numpy.asarray(a) for k, a in batch.items()})
    tl, tparts = tdet.centerpoint_loss(
        cfg, tout, tdet.batch_to_device(batch, 'cpu'))
    for k in ('hm_loss_head_0', 'loc_loss_head_0'):
        assert abs(float(tparts[k]) - float(jparts[k])) <= \
            0.01 * abs(float(jparts[k])), k
    assert abs(float(tl) - float(jl)) <= 0.01 * abs(float(jl))
