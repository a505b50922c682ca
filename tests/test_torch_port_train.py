"""The training slice of the PyTorch port against the JAX package on the
CPU: two ``adam_onecycle`` steps of the tiny-config CenterPoint (OCC caps
set, so the bucketed training path runs) from the same weights, carried
across by ``params_from_jax``, against JAX's ``make_train_step``; the loss
functions and target assignment on equal inputs; the optimizer on equal
gradients; the schedules, checkpoints and the synthetic frame pairs' boxes.

The JAX model runs on the CPU through its jnp reference layers, the port
through the plain versions of its kernels. Both round activations to bf16
at the same places, but not bit for bit the same values, and at random
initialisation the gradient of a bf16 network this deep is sensitive to one
rounding. The fixture measures how much: the control is JAX's own step
from the same weights with the encoder's rounded once to bf16, and it moves
JAX's gradient by about 0.3 in relative L2 error, some single tensors' by
up to 0.7. So the whole-model gradient comparison is held to the control's
level and each tensor to a bound that a wrong gradient exceeds; the
comparisons of single functions on equal inputs are tight. Each tolerance
is stated beside its comparison."""

import copy

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_model import HOSTVOX, random_variables
from tests.tiny_cfg import synth_batch, tiny_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.models import detectors as jdet
from tmae_tpu.ops import centernet as jcn
from tmae_tpu.ops.voxelize import voxelize_host as j_voxelize_host
from tmae_tpu.train import optimization as jopt
from tmae_tpu.train import trainer as jtr
from tmae_tpu_torch.models import detectors as tdet
from tmae_tpu_torch.ops import centernet as tcn
from tmae_tpu_torch.train.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
from tmae_tpu_torch.train.optimization import (build_optimizer,
                                               one_cycle_schedules)
from tmae_tpu_torch.train.trainer import make_train_step
from tmae_tpu_torch.utils.from_jax import params_from_jax, tree_from_jax

STEPS_PER_EPOCH = 10


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` inside the optax chain."""
    if hasattr(opt_state, 'mu'):
        return opt_state
    if hasattr(opt_state, 'inner_state'):
        return _adam_state(opt_state.inner_state)
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def _rel(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float((a - b).norm() / (b.norm() + 1e-30))


def _encoder_rounded(v):
    """The variables with the SiamWCA encoder's parameters rounded once to
    bf16 (kept in f32)."""
    flat = tu.flatten_dict(v['params'])
    flat = {k: (np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32)) if k[:2] == ('backbone_3d', 'encoder') else a)
        for k, a in flat.items()}
    return {**v, 'params': tu.unflatten_dict(flat)}


def _pre_bn_bias(name):
    """Biases of convolutions followed by a batch norm: their gradient is 0
    in exact arithmetic and rounding noise in bf16."""
    return name.endswith('conv.bias') or name == 'dense_head.shared_conv.bias'


def _train_cfg_and_batch():
    cfg = copy.deepcopy(tiny_cfg())
    cfg.RUNTIME.OCC_MID_CAPS = [16, 16, 16]
    batch = synth_batch(np.random.RandomState(0))
    spec = jdet.make_voxel_spec(cfg.DATA_CONFIG, cfg.RUNTIME)
    for which, pk, mk in (('cur', 'points', 'point_mask'),
                          ('prv', 'points_prev', 'point_mask_prev')):
        hv = j_voxelize_host(batch[pk], batch[mk], spec, sort_points=True)
        batch[pk], batch[mk] = hv['points'], hv['point_mask']
        for key, short in HOSTVOX:
            batch[f'{short}_{which}'] = hv[key]
    return cfg, batch


@pytest.fixture(scope='module')
def two_steps():
    """Two training steps on the same batch in both packages, from the same
    weights (the heatmap bias at CenterPoint's -2.19 prior), and the
    control: JAX's first step from those weights with the encoder's rounded
    once to bf16."""
    cfg, batch = _train_cfg_and_batch()
    jmodel = jdet.build_detector(cfg)
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b,
                                                  train=False), batch)
    v = random_variables(shapes, 0)
    v['params']['dense_head']['head_0']['hm_out']['bias'][:] = -2.19
    tx, _ = jopt.build_optimizer(cfg.OPTIMIZATION, STEPS_PER_EPOCH)
    state = jtr.create_train_state(v, tx)
    jstep = jax.jit(jtr.make_train_step(
        jmodel, lambda o, b: jdet.centerpoint_loss(cfg, o, b), tx))
    jm, jstates = [], []
    for _ in range(2):
        state, m = jstep(state, batch, jax.random.PRNGKey(0))
        jm.append({k: float(x) for k, x in jax.device_get(m).items()})
        jstates.append(jax.device_get(state))
    ctrl, _ = jstep(jtr.create_train_state(_encoder_rounded(v), tx), batch,
                    jax.random.PRNGKey(0))
    jctrl = jax.device_get(ctrl)

    tmodel = tdet.build_detector(cfg, 'cpu')
    tmodel.load_state_dict(params_from_jax(v), strict=True)
    opt, sched = build_optimizer(tmodel.parameters(), cfg.OPTIMIZATION,
                                 STEPS_PER_EPOCH)
    tstep = make_train_step(tmodel, lambda o, b: tdet.centerpoint_loss(
        cfg, o, b), opt, sched)
    tb = tdet.batch_to_device(batch, 'cpu')
    start = {k: t.clone() for k, t in tmodel.state_dict().items()}
    tm, moments, tstates = [], [], []
    for _ in range(2):
        tm.append({k: float(x) for k, x in tstep(tb).items()})
        moments.append({n: {k: t.clone() for k, t in opt.state[p].items()}
                        for n, p in tmodel.named_parameters()})
        tstates.append({k: t.clone() for k, t in
                        tmodel.state_dict().items()})
    return dict(cfg=cfg, v=v, jm=jm, jstates=jstates, jctrl=jctrl, tm=tm,
                moments=moments, tstates=tstates, start=start,
                model=tmodel, opt=opt, step=tstep, tb=tb)


def test_train_step_metrics_match_jax(two_steps):
    """Loss, its per-head parts and the pre-clip grad_norm of both steps:
    within 1% (step 0) and 3% (step 1, after one update that each side
    derived from its own bf16 gradient) for the losses, 5% for grad_norm;
    occ_overflow is 0 on both sides."""
    jm, tm = two_steps['jm'], two_steps['tm']
    for i, tol in ((0, 0.01), (1, 0.03)):
        assert sorted(jm[i]) == sorted(tm[i])
        for k in ('loss', 'hm_loss_head_0', 'loc_loss_head_0'):
            assert abs(tm[i][k] - jm[i][k]) <= tol * abs(jm[i][k]), (i, k)
        assert abs(tm[i]['grad_norm'] - jm[i]['grad_norm']) <= \
            0.05 * jm[i]['grad_norm'], i
        assert tm[i]['occ_overflow'] == jm[i]['occ_overflow'] == 0
    assert tm[1]['loss'] < tm[0]['loss'] and jm[1]['loss'] < jm[0]['loss']


def test_train_step_gradients_and_moments_match_jax(two_steps):
    """The clipped step-0 gradient, read from the first Adam moment
    (``(1 - beta1) * g`` on both sides after one step), and both moments
    after two steps, carried across by ``tree_from_jax``; not the pre-BN
    conv biases, whose gradient is rounding noise. After step 0, over all
    parameters: relative L2 error at most 1.25 times the control's (JAX
    against itself with its encoder weights rounded once to bf16) and
    cosine at least the control's less 0.02; cosine >= 0.93 for the second
    moment. Per tensor after step 0 (matrices and vectors, not the scalar
    taus): relative L2 error <= 0.75 and norm ratio within [2/3, 3/2] (a
    zero, foreign or doubled gradient reads 1 or more, a halved one has
    its ratio outside; the control's worst tensor reads about 0.7),
    cosine >= 0.75, and where JAX's gradient is exactly 0 (the
    center-offset bias, which the loss does not reach) the port's is 0
    too. After step 1, whose gradient each side took at weights it updated
    from its own gradient: relative L2 error <= 0.6, cosine >= 0.8 and
    >= 0.9 for the second moment."""
    moments = two_steps['moments']
    jstates = two_steps['jstates']
    ctrl = tree_from_jax(_adam_state(two_steps['jctrl'].opt_state).mu)
    for step in (0, 1):
        adam = _adam_state(jstates[step].opt_state)
        mu, nu = tree_from_jax(adam.mu), tree_from_jax(adam.nu)
        names = [n for n in mu if not _pre_bn_bias(n)]
        cat = lambda d: torch.cat([d[n].flatten() for n in names])
        got = cat({n: moments[step][n]['exp_avg'] for n in names})
        want = cat(mu)
        got_v = cat({n: moments[step][n]['exp_avg_sq'] for n in names})
        want_v = cat(nu)
        rel, cos = _rel(got, want), _cos(got, want)
        assert _cos(got_v, want_v) >= (0.93, 0.9)[step], step
        if step == 1:
            assert rel <= 0.6 and cos >= 0.8
            continue
        rel_c, cos_c = _rel(cat(ctrl), want), _cos(cat(ctrl), want)
        print(f'step-0 gradient: port vs JAX relative L2 error {rel:.4f}, '
              f'cosine {cos:.5f}; control {rel_c:.4f}, {cos_c:.5f}')
        assert rel <= 1.25 * rel_c and cos >= cos_c - 0.02, (rel, cos, rel_c,
                                                              cos_c)
        live = [n for n in names if mu[n].numel() > 1 and mu[n].any()]
        for n in live:
            g = moments[0][n]['exp_avg']
            ratio = float(g.double().norm() / mu[n].double().norm())
            assert _rel(g, mu[n]) <= 0.75, (n, _rel(g, mu[n]))
            assert 2 / 3 <= ratio <= 1.5, (n, ratio)
            assert _cos(g, mu[n]) >= 0.75, (n, _cos(g, mu[n]))
        for n in set(names) - set(live):
            if mu[n].numel() > 1:
                assert not moments[0][n]['exp_avg'].any(), n


def test_train_step_updates_and_bn_statistics_match_jax(two_steps):
    """What the steps changed. Parameters: the update (after - before)
    agrees in cosine >= 0.8 over all parameters after each step (Adam's
    first updates are close to lr * sign(g), so they carry the gradients'
    noise). Batch-norm running statistics: the VFE's, computed in f32 on
    equal points and updated twice per step (current then previous frame)
    with momentum 0.1, change by the same amounts to 1e-4 of the change in
    step 0 (equal weights) and to 1e-3 over both steps (the second runs on
    weights each side updated from its own gradient); every other
    statistic's change agrees in cosine >= 0.9."""
    start, model = two_steps['start'], two_steps['model']
    names = [n for n, _ in model.named_parameters()]
    stats = [n for n in start if 'running' in n]
    assert len(stats) == 2 * sum(1 for m in model.modules()
                                 if hasattr(m, 'running_mean'))
    assert sum(n.startswith('vfe.') for n in stats) == 4
    for step, vfe_tol in ((0, 1e-4), (1, 1e-3)):
        st = two_steps['jstates'][step]
        want = params_from_jax({'params': st.params,
                                'batch_stats': st.batch_stats})
        got = two_steps['tstates'][step]
        du = torch.cat([(got[n] - start[n]).flatten() for n in names])
        dw = torch.cat([(want[n] - start[n]).flatten() for n in names])
        assert _cos(du, dw) >= 0.8, step
        for n in stats:
            d_got, d_want = got[n] - start[n], want[n] - start[n]
            if n.startswith('vfe.'):
                scale = d_want.abs().max()
                assert scale > 0 and (d_got - d_want).abs().max() <= \
                    vfe_tol * scale, (step, n)
            else:
                assert _cos(d_got, d_want) >= 0.9, (step, n)


def test_optimizer_matches_optax_on_equal_gradients():
    """``build_optimizer`` (AdamW with lr and beta1 set per step, global-norm
    clipping first) against the JAX package's optax chain on the same
    parameters and gradients, over steps 0..4 of a 10-step one-cycle run
    with the clip active on some steps: f32, within 1e-6 of the parameter
    scale."""
    cfg = tiny_cfg().OPTIMIZATION
    rng = np.random.RandomState(3)
    shapes = {'a': (5, 3), 'b': (7,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * (0.5 + 4 * (i % 2))).astype(
        np.float32) for k, s in shapes.items()} for i in range(5)]
    tx, _ = jopt.build_optimizer(cfg, 5)
    jp = {k: jnp.asarray(a) for k, a in params.items()}
    js = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(a.copy()))
          for k, a in params.items()}
    opt, sched = build_optimizer(list(tp.values()), cfg, 5)
    for i, g in enumerate(grads):
        up, js = tx.update({k: jnp.asarray(a) for k, a in g.items()}, js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, up)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        torch.nn.utils.clip_grad_norm_(list(tp.values()), sched.grad_clip)
        for group in opt.param_groups:
            group['lr'] = sched.lr(i)
            group['betas'] = (sched.beta1(i), group['betas'][1])
        opt.step()
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), atol=1e-6, rtol=0)


def test_one_cycle_schedules_match_jax():
    """Learning rate and beta1 at step 0, at ``PCT_START`` of the run, at
    its end and between, against the JAX package's schedules, which run in
    f32: within f32 rounding of the largest value of each (1e-7
    relative)."""
    total, lr_max, moms, div, pct = 100, 0.003, (0.95, 0.85), 10.0, 0.4
    lr, mom = one_cycle_schedules(total, lr_max, moms, div, pct)
    jlr, jmom = jopt.one_cycle_schedules(total, lr_max, moms, div, pct)
    a1 = int(total * pct)
    for step in (0, 7, a1 - 1, a1, a1 + 1, 77, total - 1, total):
        np.testing.assert_allclose(lr(step), float(jlr(step)), rtol=0,
                                   atol=1e-7 * lr_max)
        np.testing.assert_allclose(mom(step), float(jmom(step)), rtol=0,
                                   atol=1e-7)
    assert lr(0) == pytest.approx(lr_max / div)
    assert lr(a1) == pytest.approx(lr_max)
    assert lr(total) == pytest.approx(lr_max / div / 1e4)
    assert mom(0) == pytest.approx(moms[0]) and mom(a1) == pytest.approx(
        moms[1])


def test_checkpoint_round_trip(two_steps, tmp_path):
    """Model, optimizer and step saved after two steps restore into a fresh
    model and optimizer bit for bit, and the next step from each gives the
    same loss."""
    cfg, model, opt = two_steps['cfg'], two_steps['model'], two_steps['opt']
    path = save_checkpoint(tmp_path / 'ckpt' / 'last.pt', model, opt, 2)
    fresh = tdet.build_detector(cfg, 'cpu')
    fopt, fsched = build_optimizer(fresh.parameters(), cfg.OPTIMIZATION,
                                   STEPS_PER_EPOCH)
    assert restore_checkpoint(path, fresh, fopt) == 2
    for k, t in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], t), k
    for p, q in zip(model.parameters(), fresh.parameters()):
        for k, t in opt.state[p].items():
            assert torch.equal(fopt.state[q][k], t), k
    tb = two_steps['tb']
    fstep = make_train_step(fresh, lambda o, b: tdet.centerpoint_loss(
        cfg, o, b), fopt, fsched)
    fstep.step = two_steps['step'].step
    assert float(fstep(tb)['loss']) == float(two_steps['step'](tb)['loss'])


def test_centerpoint_loss_matches_jax_on_equal_head_maps():
    """``centerpoint_loss`` (targets, clamped sigmoid, focal and masked L1)
    on identical f32 head maps and boxes: the loss and each part within
    1e-5 relative."""
    cfg, batch = _train_cfg_and_batch()
    head = cfg.MODEL.DENSE_HEAD
    rng = np.random.RandomState(5)
    B, Hm, Wm = 2, 32, 32
    pred = {'hm': rng.normal(-2, 1, (B, Hm, Wm, len(cfg.CLASS_NAMES)))}
    for name, hc in head.SEPARATE_HEAD_CFG.HEAD_DICT.items():
        pred[name] = rng.normal(0, 1, (B, Hm, Wm, int(hc['out_channels'])))
    pred = {k: a.astype(np.float32) for k, a in pred.items()}
    gt = {'gt_boxes': batch['gt_boxes'], 'gt_mask': batch['gt_mask']}
    jl, jparts = jdet.centerpoint_loss(
        cfg, {'pred_dicts': [{k: jnp.asarray(a) for k, a in pred.items()}]},
        {k: jnp.asarray(a) for k, a in gt.items()})
    tl, tparts = tdet.centerpoint_loss(
        cfg, {'pred_dicts': [{k: torch.from_numpy(a)
                              for k, a in pred.items()}]},
        {k: torch.from_numpy(a) for k, a in gt.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert sorted(tparts) == sorted(jparts)
    for k in jparts:
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]),
                                   rtol=1e-5)


def test_assign_center_targets_matches_jax():
    """Batched CenterNet targets against the JAX function: boxes on and off
    the map, a box with no footprint, boxes whose radius reaches the fixed
    patch, padding slots and overlapping gaussians (max-splat). Heatmaps to
    1e-6 (exp of equal f32 arguments), indices and masks equal, target
    boxes to 1e-5."""
    rng = np.random.RandomState(8)
    B, M, ncls = 2, 12, 3
    pc = (-10.24, -10.24, -5.0, 10.24, 10.24, 3.0)
    vs = (0.32, 0.32, 8.0)
    boxes = np.zeros((B, M, 8), np.float32)
    boxes[..., :2] = rng.uniform(-11, 11, (B, M, 2))
    boxes[..., 2] = rng.uniform(-1, 1, (B, M))
    boxes[..., 3:6] = rng.uniform(0.5, 5.0, (B, M, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (B, M))
    boxes[..., 7] = rng.randint(1, ncls + 1, (B, M))
    boxes[0, 0, 3:5] = [24.0, 20.0]          # radius at the patch edge
    boxes[0, 1, 3] = 0.0                     # no footprint
    boxes[1, 2, :2] = boxes[1, 3, :2] + 0.2  # overlapping gaussians
    mask = np.ones((B, M), bool)
    mask[:, -3:] = False
    kw = dict(num_classes=ncls, feature_map_size=(64, 64),
              point_cloud_range=pc, voxel_size=vs, feature_map_stride=1,
              gaussian_overlap=0.1, min_radius=2)
    want = jcn.assign_center_targets(jnp.asarray(boxes), jnp.asarray(mask),
                                     **kw)
    got = tcn.assign_center_targets(torch.from_numpy(boxes),
                                    torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(got['heatmap'].numpy(),
                               np.asarray(want['heatmap']), atol=1e-6)
    np.testing.assert_array_equal(got['inds'].numpy(), np.asarray(
        want['inds']))
    np.testing.assert_array_equal(got['mask'].numpy(), np.asarray(
        want['mask']))
    np.testing.assert_allclose(got['target_boxes'].numpy(),
                               np.asarray(want['target_boxes']), atol=1e-5)
    assert (np.asarray(want['heatmap']) == 1.0).sum() >= 10


def test_synthetic_frame_pairs_ship_scene_boxes():
    """``frame_pair_batch`` ships each scene's boxes as training takes them:
    the scene generator equals the JAX package's synthetic dataset's (to
    one f32 rounding: the JAX dataset holds the range in f32), and
    ``gt_boxes`` / ``gt_mask`` are its boxes of the configured classes with
    the label 1-indexed in class order, padded to ``max_gt``, as the JAX
    dataset's ``prepare_data`` hands them on."""
    from tmae_tpu.config import Cfg
    from tmae_tpu.datasets.once_temporal import SyntheticONCEDataset
    from tmae_tpu_torch.datasets.synthetic import (frame_pair_batch,
                                                   gt_from_scene, make_scene)
    from tmae_tpu_torch.ops.voxelize import VoxelSpec

    names = ['Car', 'Bus', 'Truck', 'Pedestrian', 'Cyclist']
    pc = [-20.48, -20.48, -5.0, 20.48, 20.48, 3.0]
    jds = SyntheticONCEDataset(Cfg.from_dict({
        'DATASET': 'SyntheticONCEDataset', 'POINT_CLOUD_RANGE': pc,
        'DATA_SPLIT': {'train': 'train', 'test': 'val'},
        'NUM_SYNTHETIC_SAMPLES': 4, 'SYNTHETIC_BOXES': 12,
        'DATA_PROCESSOR': [{'NAME': 'calculate_grid_size',
                            'VOXEL_SIZE': [0.32, 0.32, 8.0]}]}),
        names, training=False)
    spec = VoxelSpec(tuple(pc), (0.32, 0.32, 8.0), 16384, 4096)
    batch = frame_pair_batch(spec, names, indices=(0, 1),
                             points_per_frame=8000, n_box=12, max_gt=16)
    assert batch['gt_boxes'].shape == (2, 16, 8)
    assert batch['gt_mask'].shape == (2, 16)
    for b, index in enumerate((0, 1)):
        scene = make_scene(index, pc, names, 12)
        jscene = jds._scene(index)
        np.testing.assert_allclose(scene['boxes'], jscene['boxes'],
                                   rtol=0, atol=2e-6)
        np.testing.assert_array_equal(scene['names'], jscene['names'])
        n = len(scene['boxes'])
        assert batch['gt_mask'][b].sum() == n
        np.testing.assert_array_equal(batch['gt_boxes'][b, :n, :7],
                                      scene['boxes'])
        np.testing.assert_array_equal(
            batch['gt_boxes'][b, :n, 7],
            [names.index(x) + 1 for x in scene['names']])
        assert not batch['gt_boxes'][b, n:].any()
    # the class filter: only Car and Cyclist kept, relabelled 1 and 2
    sub = ['Car', 'Cyclist']
    gt, mask = gt_from_scene(make_scene(0, pc, names, 12), sub, 16)
    keep = np.isin(make_scene(0, pc, names, 12)['names'], sub)
    assert mask.sum() == keep.sum() > 0
    np.testing.assert_array_equal(
        gt[:mask.sum(), 7],
        [sub.index(x) + 1 for x in make_scene(0, pc, names, 12)['names'][
            keep]])
