"""The asymmetric SiamWCA encoder, ``eval_asym`` and conv–BN folding of the
port against the JAX package on the CPU.

* ``ASYMMETRIC.ENABLED`` (two passes through the shared SST stages, the
  previous frame's first) and ``SimSiam`` (the previous frame's pyramid
  detached) on the tiny config cut to its first SST stage (the modes act
  per stage; ``tests/test_torch_port_iou_head.one_stage``), from the same
  weights
  (``params_from_jax``): eval-mode head maps, one training step's loss
  parts and gradients, held as ``tests/test_torch_port_train.py`` holds
  the shared-weight step (to the control: JAX against itself with its
  encoder weights rounded once to bf16); ``SimSiam``'s previous branch
  carries no gradient; the streaming cache refuses an asymmetric model.
* ``python -m tmae_tpu_torch.tools.eval_asym`` gives what ``tools.test``
  gives with ``ASYMMETRIC.ENABLED`` false.
* ``utils/fuse.fuse_conv_bn`` against JAX's ``utils/fuse.fuse_conv_bn`` on
  the same parameters, given each batch norm's own epsilon: the same
  folded tensors (the conv biases aside: JAX keeps a folded conv's bias,
  the port zeroes it after folding it into the BN's), and the folded
  model's head maps within bf16 rounding of the unfused model's.
"""

import copy
import pickle

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_port_eval import eval_cfg, write_cfg
from tests.test_torch_port_iou_head import one_stage
from tests.test_torch_port_model import random_variables
from tests.test_torch_port_train import (_cos, _encoder_rounded, _pre_bn_bias,
                                         _rel, _train_cfg_and_batch)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.models import detectors as jdet
from tmae_tpu.utils import fuse as jfuse
from tmae_tpu_torch.models import detectors as tdet
from tmae_tpu_torch.models.sst import DenseGrid
from tmae_tpu_torch.tools import eval_asym
from tmae_tpu_torch.tools import test as cli
from tmae_tpu_torch.train.checkpoint import save_checkpoint
from tmae_tpu_torch.utils.from_jax import params_from_jax, tree_from_jax
from tmae_tpu_torch.utils.fuse import fuse_conv_bn

MODES = {'enabled': {'ENABLED': True},
         'simsiam': {'ENABLED': True, 'SimSiam': True}}


def asym_cfg_and_batch(mode):
    cfg, batch = _train_cfg_and_batch()
    cfg = one_stage(cfg)
    cfg.MODEL.BACKBONE_3D['ASYMMETRIC'] = dict(MODES[mode])
    return cfg, batch


@pytest.fixture(scope='module', params=list(MODES))
def asym(request):
    """Both packages from the same weights: eval-mode outputs, and the
    training loss with its gradient (JAX: jitted value_and_grad, also at
    the control's weights; the port: one backward in train mode)."""
    cfg, batch = asym_cfg_and_batch(request.param)
    jmodel = jdet.build_detector(cfg)
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b,
                                                  train=False), batch)
    v = random_variables(shapes, 1)
    v['params']['dense_head']['head_0']['hm_out']['bias'][:] = -2.19

    def loss_fn(params, stats, b):
        out = jmodel.apply({'params': params, 'batch_stats': stats}, b,
                           train=True, mutable=['batch_stats'])[0]
        return jdet.centerpoint_loss(cfg, out, b)

    jgrad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, jparts), jg = jgrad(v['params'], v['batch_stats'], batch)
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
    return dict(mode=request.param, jout=jout, tout=tout,
                jparts={k: float(x) for k, x in jparts.items()},
                tparts={k: float(x.detach()) for k, x in tparts.items()},
                jg=tree_from_jax(jax.device_get(jg)),
                jg_ctrl=tree_from_jax(jax.device_get(jg_ctrl)),
                tg={n: p.grad.clone() for n, p in tmodel.named_parameters()})


def test_asymmetric_head_maps_match_jax(asym):
    """Eval-mode head maps: max |diff| <= 0.03, mean <= 3e-3 (the tiny
    slice's bounds: bf16 weight rounding); the overflow counts of both
    frames' passes are summed per stage as JAX sums its sown counts."""
    jp, tp = asym['jout']['pred_dicts'][0], asym['tout']['pred_dicts'][0]
    assert sorted(jp) == sorted(tp)
    for name in jp:
        err = np.abs(tp[name].numpy() - np.asarray(jp[name], np.float32))
        assert err.max() <= 0.03 and err.mean() <= 3e-3, (name, err.max())
    assert asym['tout']['occ_overflow'].shape == (2, 2)


def test_asymmetric_training_step_matches_jax(asym):
    """Loss parts within 1%; the gradient over all parameters (not the
    pre-BN conv biases, rounding noise) with relative L2 error at most 1.25
    times the control's and cosine at least the control's less 0.02; each
    encoder matrix with cosine >= 0.75; every gradient finite."""
    assert sorted(asym['tparts']) == sorted(asym['jparts'])
    for k, want in asym['jparts'].items():
        assert abs(asym['tparts'][k] - want) <= 0.01 * abs(want), k
    jg, tg, ctrl = asym['jg'], asym['tg'], asym['jg_ctrl']
    names = [n for n in jg if not _pre_bn_bias(n)]
    cat = lambda d: torch.cat([d[n].flatten() for n in names])
    rel, cos = _rel(cat(tg), cat(jg)), _cos(cat(tg), cat(jg))
    rel_c, cos_c = _rel(cat(ctrl), cat(jg)), _cos(cat(ctrl), cat(jg))
    print(f'{asym["mode"]}: port vs JAX relative L2 {rel:.4f}, cosine '
          f'{cos:.5f}; control {rel_c:.4f}, {cos_c:.5f}')
    assert rel <= 1.25 * rel_c and cos >= cos_c - 0.02
    for n in names:
        if n.startswith('backbone_3d.encoder') and jg[n].dim() == 2:
            assert _cos(tg[n], jg[n]) >= 0.75, n
    assert all(torch.isfinite(g).all() for g in tg.values())


def _encoder_and_grids(mode, seed=0):
    cfg, _ = asym_cfg_and_batch(mode)
    enc = tdet.build_detector(cfg, 'cpu').backbone_3d.encoder.train()
    rng = np.random.RandomState(seed)
    grids = []
    for _ in range(2):
        occ = torch.from_numpy(rng.rand(1, 32, 32) < 0.3)
        x = torch.from_numpy(rng.normal(size=(1, 32, 32, 16)).astype(
            np.float32)) * occ[..., None]
        grids.append(DenseGrid(x.to(torch.bfloat16).requires_grad_(True),
                               occ))
    return enc, grids


@pytest.mark.parametrize('mode', list(MODES))
def test_simsiam_previous_branch_carries_no_gradient(mode):
    """The fused outputs' gradient reaches the previous frame's grid with
    ``ENABLED`` and stops at its pyramid with ``SimSiam``; the current
    frame's grid gets a gradient in both modes."""
    enc, (cur, prv) = _encoder_and_grids(mode)
    fused, _, _ = enc(cur, prv)
    sum(f.x.float().sum() for f in fused).backward()
    assert cur.x.grad is not None and cur.x.grad.abs().sum() > 0
    if mode == 'simsiam':
        assert prv.x.grad is None
    else:
        assert prv.x.grad is not None and prv.x.grad.abs().sum() > 0


def test_asymmetric_model_refuses_the_streaming_cache():
    enc, (cur, prv) = _encoder_and_grids('enabled')
    with pytest.raises(ValueError, match='ASYMMETRIC'):
        enc(cur, None, hid_prv=[prv])


def test_eval_asym_evaluates_with_the_branch_off(tmp_path, monkeypatch):
    """``eval_asym`` on a config with ``ASYMMETRIC.ENABLED`` builds the
    shared-weight model and writes what ``tools.test`` writes with
    ``--set MODEL.BACKBONE_3D.ASYMMETRIC.ENABLED False``."""
    monkeypatch.setattr(cli, 'OUTPUT_ROOT', tmp_path / 'output')
    cfg = eval_cfg()
    cfg.MODEL.BACKBONE_3D['ASYMMETRIC'] = {'ENABLED': True, 'SimSiam': True}
    cfg_file = write_cfg(cfg, tmp_path / 'once_models' / 'tiny_asym.yaml')
    model = tdet.init_random_(tdet.build_detector(cfg, 'cpu'), seed=5)
    ckpt = save_checkpoint(tmp_path / 'weights.pth', model, None, 3)
    seen = []
    run = cli.run
    monkeypatch.setattr(cli, 'run', lambda args, c: seen.append(
        c.MODEL.BACKBONE_3D.ASYMMETRIC.ENABLED) or run(args, c))
    # eval_asym calls tools.test's run once, with the branch off
    base = ['--cfg_file', str(cfg_file), '--device', 'cpu', '--ckpt',
            str(ckpt), '--set', 'DATA_CONFIG.NUM_SYNTHETIC_SAMPLES', '2']
    got = eval_asym.main(base + ['--extra_tag', 'asym'])
    assert seen == [False]
    want = cli.main(base + ['MODEL.BACKBONE_3D.ASYMMETRIC.ENABLED', 'False',
                            '--extra_tag', 'sym'])
    (gdir, gap), = got.items()
    (wdir, wap), = want.items()
    ga = pickle.loads((gdir / 'result.pkl').read_bytes())
    wa = pickle.loads((wdir / 'result.pkl').read_bytes())
    assert [a['frame_id'] for a in ga] == [a['frame_id'] for a in wa]
    for g, w in zip(ga, wa):
        for k in ('name', 'score', 'boxes_3d'):
            np.testing.assert_array_equal(g[k], w[k])
    assert {k: v for k, v in gap.items() if k.startswith('AP')} == \
        {k: v for k, v in wap.items() if k.startswith('AP')}


def _true_eps(path, bn_key, conv_key):
    """Each batch norm's own epsilon: 1e-5 for the VFE's Dense + masked BN
    and the head's convolutions (torch's default there), 1e-3 for the
    sparse-conv and BEV stacks."""
    if path[:1] == ('dense_head',):
        return 1e-5
    if bn_key.startswith('MaskedBatchNorm_') and conv_key.startswith('Dense_'):
        return 1e-5
    return 1e-3


@pytest.fixture(scope='module')
def fused():
    cfg, batch = _train_cfg_and_batch()
    jmodel = jdet.build_detector(cfg)
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b,
                                                  train=False), batch)
    v = random_variables(shapes, 2)
    model = tdet.build_detector(cfg, 'cpu')
    model.load_state_dict(params_from_jax(v), strict=True)
    tb = tdet.batch_to_device(batch, 'cpu')
    with torch.no_grad():
        before = model(tb)['pred_dicts'][0]
    n = fuse_conv_bn(model)
    with torch.no_grad():
        after = model(tb)['pred_dicts'][0]
    return dict(v=v, model=model, n=n, before=before, after=after)


def test_fuse_conv_bn_matches_jax(fused):
    """Every folded tensor equal to JAX's fold of the same parameters to
    f32 rounding (1e-6 relative); the conv biases 0 on the port's side; the
    BNs the identity plus bias. JAX's default epsilon (1e-3 for every
    BatchNorm2d) differs from the head's own (1e-5)."""
    v, model = fused['v'], fused['model']
    p, s = jfuse.fuse_conv_bn(v['params'], v['batch_stats'], eps_fn=_true_eps)
    want = params_from_jax({'params': p, 'batch_stats': s})
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    folded_biases = [k for k in got if k.endswith('.conv.bias')]
    assert folded_biases and all(not got[k].any() for k in folded_biases)
    for k in want:
        if k in folded_biases:
            continue
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    # every `bn` beside a conv, linear or deconv is folded; shared_conv /
    # shared_bn are left alone, as in JAX
    assert fused['n'] == sum(k.endswith('.bn.running_mean') for k in got)
    assert got['dense_head.shared_bn.running_var'].ne(
        1 - model.dense_head.shared_bn.eps).any()
    dp, _ = jfuse.fuse_conv_bn(v['params'], v['batch_stats'])
    head = 'dense_head.head_0.hm_conv0.bn.bias'
    assert not np.allclose(params_from_jax({'params': dp})[head].numpy(),
                           want[head].numpy(), rtol=1e-6, atol=1e-7)


def test_fused_model_head_maps_match_unfused(fused):
    """The folded model's head maps against the unfused model's: the port's
    convolutions round the scaled weights to bf16, so max |diff| <= 0.03
    and mean <= 3e-3 (the tiny slice's bf16 bounds)."""
    for name, want in fused['before'].items():
        err = (fused['after'][name] - want).abs()
        assert err.max() <= 0.03 and err.mean() <= 3e-3, (name, err.max())
