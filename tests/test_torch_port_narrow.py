"""The encoder layer at the narrow widths (C = 32 / 64 with 4 or 8 heads:
the mini configs and ``ASYMMETRIC.HALF_CHANNELS``), the half-width SST
stage, the ``HALF_CHANNELS`` detector and the single-bucket plan of the
PyTorch port against the JAX package on the CPU.

* The width dispatch: every encoder width of every shipped T-MAE config
  (the half-width stages of ``HALF_CHANNELS`` among them) has a kernel
  family (``layer_family``).
* The plain versions of NARROW_FWD / NARROW_BWD at (64, 8), (64, 4) and
  (32, 4) in the full (T = 64), packed (S = 16, 48) and grid forms, self
  and cross, against the computations JAX runs at these widths (its Pallas
  kernels need C % 128 == 0): ``reference_encoder_layer``,
  ``fused_encoder_layer_sel`` (its forward and chunked backward fall to
  ``reference_encoder_layer_sel`` / ``_bwd_sel_recompute``) and
  ``reference_encoder_layer_grid``, forward and gradients (``jax.vjp``).
* ``SSTBlock(half_channels)`` against JAX's ``SSTBlock(half_channels=True)``
  (stride 1 through ``conv_down_1x1`` and its masked BN, stride 2 through
  ``conv_down``), in eval and train mode, and the single-bucket plan
  (``OCC_WINDOW_CAPS`` without ``OCC_SMALL_CAPS``) with its
  ``occ_overflow``, after a strict ``params_from_jax`` load.
* The tiny ``HALF_CHANNELS`` CenterPoint and TMAE cut to one SST stage
  (``tests/test_torch_port_iou_head.one_stage``): forward and loss against
  JAX's from the same weights.
* NARROW_BWD's workspace (``_narrow_bwd_layout``): its regions and their
  alignment, and the weight-gradient chunks over the tiles' rows.

The JAX references keep their intermediates in f32 while the port rounds
to bf16 where the kernels do, so each tolerance covers bf16 rounding and is
the one the C = 128 cases hold (stated beside each comparison).
"""

import copy
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_iou_head import one_stage
from tests.test_torch_port_model import _occ_grid, random_variables
from tests.test_torch_port_train import _train_cfg_and_batch
from tests.tiny_cfg import synth_batch, tiny_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.models import detectors as jdet
from tmae_tpu.models.sst import DenseGrid as JDenseGrid
from tmae_tpu.models.sst import SSTBlock as JSSTBlock
from tmae_tpu.ops import pallas_encoder as jpe
from tmae_tpu.ops.dense_windows import slot_pos_embed as j_slot_pos_embed
from tmae_tpu_torch.config import cfg_from_yaml_file
from tmae_tpu_torch.models import detectors as tdet
from tmae_tpu_torch.models.sst import DenseGrid, OccCaps, SSTBlock
from tmae_tpu_torch.ops import encoder_layer as tel
from tmae_tpu_torch.ops.encoder_layer import (LayerParams, layer_family,
                                              reference_encoder_layer,
                                              reference_encoder_layer_bwd,
                                              reference_encoder_layer_grid)
from tmae_tpu_torch.utils.from_jax import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
FIELDS = LayerParams._fields
MATRICES = ('wq', 'wk', 'wv', 'wo', 'f1w', 'f2w')
WIDTHS = [(64, 8), (64, 4), (32, 4)]
TAU_MIN = 0.01
HALF = {'ENABLED': True, 'HALF_CHANNELS': True}


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_np(a):
    return torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16).float().numpy()


@pytest.mark.parametrize('name', sorted(
    p.name for p in (ROOT / 'tools/cfgs').glob('*/t_mae*.yaml')))
def test_every_config_width_has_a_kernel_family(name):
    """Each SST stage of a shipped T-MAE config, at its width and, as the
    previous frame's ``HALF_CHANNELS`` stage, at half of it, is a width one
    kernel family takes (the mini configs' 32 / 64 with 4 heads and stage 1
    of the others at 64 with 8 heads on NARROW_FWD / NARROW_BWD)."""
    path = next((ROOT / 'tools/cfgs').glob(f'*/{name}'))
    cfg = cfg_from_yaml_file(path)
    for blk in cfg.MODEL.BACKBONE_3D.SST_BLOCK_LIST:
        e = blk['ENCODER']
        C, H, Fd = int(e['D_MODEL']), int(e['NHEAD']), int(
            e['DIM_FEEDFORWARD'])
        want = 'narrow' if C < 128 else 'tiled'
        assert layer_family(C, H, Fd) == want, (name, C, H)
        if C == 128:  # the half-width previous-frame stage
            assert layer_family(C // 2, H, Fd // 2) == 'narrow'


def _layer_case(seed, C, H, N, S, cross):
    """N windows (zeros at unoccupied cells, every fifth window without a
    query cell, every fourth without a key in cross mode), occupied-first
    selections of S cells, a cotangent, and one layer's weights in the JAX
    layout [in, out] with bf16 matrices (the kernels' operands)."""
    F = 2 * C
    rng = np.random.RandomState(seed)
    occ = rng.rand(N, 64) < rng.uniform(0.05, 0.6, (N, 1))
    occ[::5] = False
    kocc = rng.rand(N, 64) < 0.3
    kocc[1::4] = False
    xw = _bf16_np(np.where(occ[..., None], rng.normal(0, 1, (N, 64, C)), 0))
    kv = _bf16_np(np.where(kocc[..., None], rng.normal(0, 1, (N, 64, C)), 0))
    if not cross:
        kv, kocc = xw, occ
    g = _bf16_np(rng.normal(0, 1, (N, 64, C)))
    lin = lambda i, o: _bf16_np(rng.normal(0, 1, (i, o)) / np.sqrt(i))
    vec = lambda n, m=0.0: (m + 0.1 * rng.normal(size=(n,))).astype(
        np.float32)
    p = dict(wq=lin(C, C), bq=vec(C), wk=lin(C, C), bk=vec(C), wv=lin(C, C),
             bv=vec(C), wo=lin(C, C), bo=vec(C),
             tau=np.asarray([0.7], np.float32), ln1s=vec(C, 1.0),
             ln1b=vec(C), f1w=lin(C, F), f1b=vec(F), f2w=lin(F, C),
             f2b=vec(C), ln2s=vec(C, 1.0), ln2b=vec(C))
    sel = None
    if S is not None:
        def select(o):
            key = o * (64 - np.arange(64))
            s = np.argsort(-key, axis=-1, kind='stable')[..., :S]
            return s.astype(np.int32), np.take_along_axis(o, s, -1)

        (sq, qm), (sk, km) = select(occ), select(kocc)
        sel = (sq, sk)
    else:
        qm, km = occ, kocc
    pos = _bf16_np(np.asarray(j_slot_pos_embed(8, C)))
    return (xw, kv, sel, qm.astype(np.float32), km.astype(np.float32), pos,
            p, g)


def _port_weights(p):
    """JAX layout → the port's: Linear matrices [out, in], f32."""
    return [_t(p[k].T.copy()) if k in MATRICES else _t(p[k]) for k in FIELDS]


def _close_grads(names, got, want):
    """Each gradient within the C = 128 cases' limits against JAX's f32
    VJP (the port's plain backward is autograd through bf16 roundings):
    max |diff| <= 3e-2 of its scale, mean <= 3e-3; dtau, one sum over
    every window and head, within 5e-2 of its value."""
    for name, a, b in zip(names, got, want):
        if name == 'tau':
            assert abs(a[0] - b[0]) <= 5e-2 * abs(b[0]), (name, a, b)
            continue
        scale = max(np.abs(b).max(), 1e-6)
        e = np.abs(a - b)
        assert e.max() <= 3e-2 * scale and e.mean() <= 3e-3 * scale, (
            name, e.max() / scale, e.mean() / scale)


def _jax_vjp(fn, args, g):
    """JAX's output of ``fn(*args)`` and its VJP for cotangent ``g``, in
    one jitted function (f32 numpy)."""
    def both(args, g):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(g)

    out, grads = jax.jit(both)(args, jnp.asarray(g, jnp.bfloat16))
    return out, [np.asarray(a, np.float32) for a in grads]


MODES = ['full-self', 'full-cross', 'sel16-self', 'sel48-cross', 'grid-self',
         'grid-cross']
# every mode at HALF_CHANNELS' (64, 8), whose capped stages run the
# packed and full buckets; the mini configs' widths in each form
CASES = ([((64, 8), m) for m in MODES]
         + [(w, m) for w in WIDTHS[1:] for m in ('full-cross', 'sel16-self',
                                                 'grid-self', 'grid-cross')])


@pytest.mark.parametrize('width,mode', CASES,
                         ids=[f'C{w[0]}-H{w[1]}-{m}' for w, m in CASES])
def test_narrow_layer_matches_jax(width, mode):
    """The plain narrow layer (NARROW_FWD's and NARROW_BWD's plain
    versions) against JAX at the same width: the output within max 0.1 and
    mean 4e-3 of JAX's f32 reference (as K10's plain version is held to
    ``reference_encoder_layer_grid`` at C = 128), unselected cells passed
    through exactly, unoccupied grid cells 0; dx, dkv and the 17 parameter
    gradients by :func:`_close_grads`. In self mode JAX's kv is x, so its
    x gradient folds both paths, as the port's does."""
    C, H = width
    form, side = mode.split('-')
    cross = side == 'cross'
    kw = dict(nhead=H, tau_min=TAU_MIN, cross=cross)
    seed = 7 * C + H + 3 * MODES.index(mode)
    if form == 'grid':
        _grid_case_matches_jax(seed, C, H, cross, kw)
        return
    S = {'full': None, 'sel16': 16, 'sel48': 48}[form]
    xw, kv, sel, qm, km, pos, p, g = _layer_case(seed, C, H, 10, S, cross)
    jparams = [jnp.asarray(p[k]) for k in FIELDS]
    jx, jkv = jnp.asarray(xw, jnp.bfloat16), jnp.asarray(kv, jnp.bfloat16)
    jpos = jnp.asarray(pos, jnp.bfloat16)
    if S is None:
        fn = lambda x, k, *w: jpe.reference_encoder_layer(
            x, k, jnp.asarray(qm), jnp.asarray(km), jpos, *w, **kw)
    else:
        fn = lambda x, k, *w: jpe.fused_encoder_layer_sel(
            x, k, jnp.asarray(sel[0]), jnp.asarray(sel[1]), jnp.asarray(qm),
            jnp.asarray(km), jpos, *w, H, TAU_MIN, cross)
    want, jgrads = _jax_vjp(fn, (jx, jkv, *jparams), g)
    sq, sk = (None, None) if S is None else map(_t, sel)
    args = (_t(xw).bfloat16(), _t(kv).bfloat16() if cross else None, sq, sk,
            _t(qm), _t(km), _t(pos).bfloat16())
    got = reference_encoder_layer(*args, LayerParams(*_port_weights(p)), H,
                                  TAU_MIN, cross).float().numpy()
    want = np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert err.max() <= 0.1 and err.mean() <= 4e-3, (err.max(), err.mean())
    if S is not None:
        kept = np.ones((10, 64), bool)
        np.put_along_axis(kept, sel[0], False, -1)
        np.testing.assert_array_equal(got[kept], xw[kept])
    dx, dkv, grads, _ = reference_encoder_layer_bwd(
        *args, _port_weights(p), _t(g).bfloat16(), **kw)
    names = ['dx'] + (['dkv'] if cross else []) + list(FIELDS)
    ours = ([dx.numpy()] + ([dkv.numpy()] if cross else [])
            + [w.numpy().T if n in MATRICES else w.numpy()
               for n, w in zip(FIELDS, grads)])
    theirs = [jgrads[0]] + ([jgrads[1]] if cross else []) + [
        a.reshape(o.shape) for a, o in zip(jgrads[2:], ours[-17:])]
    _close_grads(names, ours, theirs)


def _grid_case_matches_jax(seed, C, H, cross, kw):
    """The grid form on a 2 x 20 x 20 grid (shift 1 in cross mode): a dense
    patch, scattered cells and an empty band (windows without a query)."""
    rng = np.random.RandomState(seed)
    B, Hg, Wg = 2, 20, 20
    occ = rng.rand(B, Hg, Wg) < 0.25
    occ[:, 2:9, 3:11] |= rng.rand(B, 7, 8) < 0.8
    occ[:, 12:, :] = False
    kocc = rng.rand(B, Hg, Wg) < 0.3 if cross else occ
    x = _bf16_np(np.where(occ[..., None], rng.normal(0, 1, (B, Hg, Wg, C)),
                          0))
    kv = _bf16_np(np.where(kocc[..., None], rng.normal(0, 1, (B, Hg, Wg, C)),
                           0)) if cross else x
    g = _bf16_np(rng.normal(0, 1, (B, Hg, Wg, C)))
    _, _, _, _, _, pos, p, _ = _layer_case(seed, C, H, 1, None, False)
    shift = cross
    gkw = dict(kw, window=8, shift=shift)
    fn = lambda a, b, *w: jpe.reference_encoder_layer_grid(
        a, b, jnp.asarray(occ), jnp.asarray(kocc), jnp.asarray(pos,
                                                              jnp.bfloat16),
        *w, **gkw)
    want, jgrads = _jax_vjp(fn, (jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(kv, jnp.bfloat16),
                                 *[jnp.asarray(p[k]) for k in FIELDS]), g)
    ws = [w.requires_grad_() for w in _port_weights(p)]
    xt = _t(x).bfloat16().requires_grad_()
    kt = _t(kv).bfloat16().requires_grad_() if cross else None
    out = reference_encoder_layer_grid(
        xt, kt, _t(occ), _t(kocc) if cross else None, _t(pos).bfloat16(),
        LayerParams(*ws), H, TAU_MIN, cross, 8, shift)
    got = out.detach().float().numpy()
    want = np.where(occ[..., None], np.asarray(want, np.float32), 0.0)
    err = np.abs(got - want)
    assert err.max() <= 0.1 and err.mean() <= 4e-3, (err.max(), err.mean())
    assert not got[~occ].any() and np.abs(got[occ]).mean() > 0.3
    out.float().backward(_t(g))
    names = ['dx'] + (['dkv'] if cross else []) + list(FIELDS)
    ours = ([xt.grad.float().numpy()]
            + ([kt.grad.float().numpy()] if cross else [])
            + [w.grad.numpy().T if n in MATRICES else w.grad.numpy()
               for n, w in zip(FIELDS, ws)])
    theirs = [jgrads[0]] + ([jgrads[1]] if cross else []) + [
        a.reshape(o.shape) for a, o in zip(jgrads[2:], ours[-17:])]
    _close_grads(names, ours, theirs)


T_MAE = cfg_from_yaml_file(ROOT / 'tools/cfgs/once_models/t_mae.yaml')
# (stage of t_mae.yaml, half width, caps: None (grid), 'single' or
# 'buckets')
STAGES = {'half-stride1-single': (0, True, 'single'),
          'half-stride2-buckets': (1, True, 'buckets'),
          'full-stride1-single': (0, False, 'single')}


@pytest.mark.parametrize('case', list(STAGES))
def test_sst_stage_matches_jax(case):
    """One SST stage of t_mae.yaml (two shifted blocks) on a 32x32 grid
    with a dense region that overflows the full cap, against JAX's
    ``SSTBlock`` from the same weights (strict load): at half width (the
    previous frame's stage of ``HALF_CHANNELS``: C = 64 at stride 1 through
    ``conv_down_1x1`` and ``conv_down_bn``, 128 at stride 2), and at full
    width; with the single-bucket plan (``occ_window_cap`` only) or the
    token buckets. Eval mode and, at stride 1, train mode (the masked BN
    on batch statistics, its running statistics updated as JAX updates
    them): bf16 carriers within max 0.1 and mean 4e-3 (the C = 128 stage
    test's limits); ``occ_overflow`` equal."""
    stage, half, kind = STAGES[case]
    rng = np.random.RandomState(30 + stage)
    ecfg = dict(T_MAE.MODEL.BACKBONE_3D.SST_BLOCK_LIST[stage]['ENCODER'])
    cin, (B, H, W) = 128, (2, 32, 32)
    occ = _occ_grid(rng, B, H, W)
    x = np.where(occ[..., None], rng.normal(size=(B, H, W, cin)), 0)
    x = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    jgrid = JDenseGrid(x=jnp.asarray(x.float().numpy(), jnp.bfloat16),
                       occ=jnp.asarray(occ))
    caps = dict(occ_window_cap=16)
    tcaps = OccCaps(16, 0)
    if kind == 'buckets':
        caps.update(occ_small_cap=16, occ_small_tokens=16, occ_mid_cap=16,
                    occ_mid_tokens=48)
        tcaps = OccCaps(16, 16, 16, 16, 48)
    jblock = JSSTBlock(encoder_cfg=ecfg, half_channels=half, **caps)
    shapes = jax.eval_shape(lambda g: jblock.init(jax.random.PRNGKey(0), g,
                                                  False), jgrid)
    v = random_variables(shapes, 40 + stage)
    tblock = SSTBlock(cin, ecfg, tcaps, half_channels=half)
    tblock.load_state_dict(params_from_jax(v), strict=True)
    C = int(ecfg['D_MODEL']) // (2 if half else 1)
    assert tblock.blocks[0].EncoderLayer_0.q.weight.shape == (C, C)
    assert tblock.conv_out.conv.weight.shape[0] == int(ecfg['D_MODEL'])
    modes = (False, True) if stage == 0 else (False,)
    for train in modes:
        jout, state = jax.jit(lambda v, g: jblock.apply(
            v, g, train, mutable=['intermediates', 'batch_stats']))(v, jgrid)
        tblock.train(train)
        with torch.no_grad():
            tout, overflow = tblock(DenseGrid(x, torch.from_numpy(occ)))
        err = np.abs(tout.x.float().numpy() - np.asarray(jout.x, np.float32))
        assert err.max() <= 0.1 and err.mean() <= 4e-3, (train, err.max(),
                                                         err.mean())
        want_ov = np.asarray(state['intermediates']['occ_overflow'][0])
        np.testing.assert_array_equal(overflow.numpy(), want_ov)
        if stage == 0:  # the dense region overflows the full cap
            assert want_ov.sum() > 0
        if train and half:
            # the masked BN's running statistics after one update, as JAX's
            stats = state['batch_stats']['conv_down_bn']
            bn = tblock.conv_down_bn
            np.testing.assert_allclose(bn.running_mean.numpy(),
                                       np.asarray(stats['mean']), rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(bn.running_var.numpy(),
                                       np.asarray(stats['var']), rtol=1e-4,
                                       atol=1e-5)
    assert ('conv_down_1x1.weight' in tblock.state_dict()) == (half and
                                                            stage == 0)


def _half_cfg(mae):
    cfg = copy.deepcopy(tiny_cfg(mae=mae))
    cfg.RUNTIME.OCC_MID_CAPS = [16, 16, 16]
    cfg = one_stage(cfg)
    cfg.MODEL.BACKBONE_3D['ASYMMETRIC'] = dict(HALF)
    return cfg


def _jax_and_port(cfg, batch):
    jmodel = jdet.build_detector(cfg)
    keys = {'params': jax.random.PRNGKey(0),
            'mae_mask': jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda b: jmodel.init(keys, b, train=False),
                            batch)
    v = random_variables(shapes, 2)
    tmodel = tdet.build_detector(cfg, 'cpu')
    tmodel.load_state_dict(params_from_jax(v), strict=True)
    return jmodel, v, tmodel


def test_half_channels_centerpoint_matches_jax():
    """The tiny CenterPoint with ASYMMETRIC {ENABLED, HALF_CHANNELS} cut to
    one stage, from the same weights (strict load: ``sst_block_prev_0``
    with ``conv_down_1x1`` and ``conv_down_bn``): eval-mode head maps
    within max 0.03 and mean 3e-3 (the tiny slice's limits), one overflow
    count per stage and sample (both passes summed), and the train-mode
    loss parts within 1% of JAX's."""
    cfg, batch = _train_cfg_and_batch()
    cfg = one_stage(cfg)
    cfg.MODEL.BACKBONE_3D['ASYMMETRIC'] = dict(HALF)
    jmodel, v, tmodel = _jax_and_port(cfg, batch)
    assert 'sst_block_prev_0' in v['params']['backbone_3d']['encoder']
    enc = tmodel.backbone_3d.encoder
    assert enc.half and not enc.simsiam and len(enc.prev_blocks) == 1
    jout = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(v, batch)
    tb = tdet.batch_to_device(batch, 'cpu')
    with torch.no_grad():
        tout = tmodel(tb)
    for name, want in jout['pred_dicts'][0].items():
        err = np.abs(tout['pred_dicts'][0][name].numpy()
                     - np.asarray(want, np.float32))
        assert err.max() <= 0.03 and err.mean() <= 3e-3, (name, err.max())
    assert tout['occ_overflow'].shape == (2, 2)

    def loss_fn(v, b):
        out = jmodel.apply(v, b, train=True, mutable=['batch_stats'])[0]
        return jdet.centerpoint_loss(cfg, out, b)[1]

    jparts = jax.jit(loss_fn)(v, batch)
    tmodel.train()
    with torch.no_grad():
        _, tparts = tdet.centerpoint_loss(cfg, tmodel(tb), tb)
    assert sorted(tparts) == sorted(jparts)
    for k, want in jparts.items():
        assert abs(float(tparts[k]) - float(want)) <= 0.01 * abs(float(want)), k


def test_half_channels_tmae_matches_jax():
    """The tiny TMAE (SiamWCA_MAE) with ASYMMETRIC {ENABLED, HALF_CHANNELS}
    cut to one stage, eval mode on JAX's mask, from the same weights
    (strict load): the predicted points within 0.03 and 2e-3 in the mean,
    the Chamfer loss within 1e-3 relative (the pretraining slice's
    limits)."""
    cfg = _half_cfg(True)
    batch = synth_batch(np.random.RandomState(4))
    jmodel, v, tmodel = _jax_and_port(cfg, batch)
    jout = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False, rngs={'mae_mask': jax.random.PRNGKey(3)}))(
        v, batch)
    jloss, _ = jdet.tmae_loss(cfg, jout, batch)
    jmask = torch.from_numpy(np.array(jout['mae_mask']))
    with torch.no_grad():
        tout = tmodel(tdet.batch_to_device(batch, 'cpu'), mae_mask=jmask)
    tloss, _ = tdet.tmae_loss(cfg, tout, batch)
    err = np.abs(tout['pred_points'].numpy() - np.asarray(jout['pred_points']))
    assert err.max() <= 0.03 and err.mean() <= 2e-3, (err.max(), err.mean())
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-3)


@pytest.mark.parametrize('N,T,C,cross,dpos', [
    (256, 64, 64, False, True), (875, 64, 64, False, False),
    (1280, 16, 64, True, False), (383, 48, 64, True, False),
    (76, 64, 32, False, True), (1, 16, 32, False, False),
    (4 * 64 * 260 + 3, 16, 32, False, False)])
def test_narrow_bwd_workspace_layout(N, T, C, cross, dpos):
    """NARROW_BWD's workspace in one buffer (``_narrow_bwd_layout``): the
    16 regions in the launcher's order, shaped as csrc/encoder_layer_
    narrow.cu reads them (KP only in cross mode, dpos only when wanted),
    each 256 bytes aligned, none overlapping and all inside the buffer; the
    weight-gradient chunks (a multiple of 64 rows, at least 256 rows, at
    most 64 chunks) cover every tile's rows."""
    F = 2 * C
    layout, nbytes, nchunks, chunk = tel._narrow_bwd_layout(N, T, C, F,
                                                            cross, dpos)
    tiles = -(-N // (4 if T == 16 else 1))
    rows = 64 * tiles
    widths = [C, C, C, C, C, F, C, C, C, C, F, C]
    want = [((rows, w), torch.bfloat16) for w in widths]
    want[1] = want[1] if cross else None
    want += [((2 * N + 2,), torch.int32), ((tiles, 9 * C + F + 1),
                                           torch.float32),
             ((tiles, 64 * C), torch.float32) if dpos else None,
             ((nchunks, 8 * C * C), torch.float32)]
    assert len(layout) == 16
    spans = []
    for got, w in zip(layout, want):
        assert (got is None) == (w is None)
        if got is None:
            continue
        off, shape, dtype = got
        assert (shape, dtype) == w
        assert off % 256 == 0
        spans.append((off, off + math.prod(shape) * dtype.itemsize))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[0][0] == 0 and spans[-1][1] <= nbytes
    assert chunk % 64 == 0 and chunk >= 256 and nchunks <= 64
    assert nchunks * chunk >= rows and (nchunks - 1) * chunk < rows


@pytest.mark.parametrize('C,nhead', WIDTHS, ids=lambda v: str(v))
def test_narrow_serving_weights_round_as_kernel_params(C, nhead):
    """A served narrow layer's bf16 copy of its six f32 matrices
    (``narrow_mats``, what ``TiledWeights`` hands NARROW_FWD on the card)
    equals ``kernel_params``' rounding bit for bit, halfway values among
    them (nearest even), each matrix a contiguous view of its shape at a
    16-byte aligned address (the kernel copies 16 bytes at a time)."""
    rng = np.random.RandomState(C + nhead)
    F = 2 * C
    shapes = dict(wq=(C, C), wk=(C, C), wv=(C, C), wo=(C, C), f1w=(F, C),
                  f2w=(C, F), f1b=(F,), tau=(1,))
    weights = [torch.tensor(rng.normal(size=shapes.get(n, (C,))).astype(
        np.float32)) for n in FIELDS]
    # values halfway between two bf16 values: the low 16 bits 0x8000
    w0 = weights[0].view(torch.int32)
    w0[:4] = (w0[:4] & ~0xffff) | 0x8000
    mats = [weights[FIELDS.index(n)] for n in MATRICES]
    got = tel.narrow_mats(mats)
    want = tel.kernel_params(weights)
    for name, g in zip(MATRICES, got):
        w = getattr(want, name)
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        assert g.is_contiguous() and g.data_ptr() % 16 == 0, name
        assert torch.equal(g.view(torch.int16), w.view(torch.int16)), name
    assert (got[0][:4].float() != weights[0][:4]).all()  # they did round


def test_parent_fwd_runs_its_own_host_path():
    """``fwd_phases.ParentFwd``, the parent's NARROW_FWD in a comparison:
    for a parent whose kernel takes ``w_f32``, inside its host path a
    served layer's f32 matrices are kept as they are (no ``narrow_mats``
    copy) and their launches pass w_f32 = 1, other matrices' 0; outside
    it ``narrow_mats`` rounds again; a parent without ``w_f32`` gets this
    version's arguments unchanged."""
    import ctypes

    from tmae_tpu_torch.utils import fwd_phases

    seen = []
    parent = object.__new__(fwd_phases.ParentFwd)
    parent.f32, parent.kept = True, {}
    parent.kernel = lambda *a: seen.append(a)
    mats = [torch.ones(8, 8) for _ in MATRICES]
    bf16 = [m.to(torch.bfloat16) for m in mats]
    ptrs = lambda ms: (ctypes.c_void_p * 17)(
        *[m.data_ptr() for m in ms], *range(1, 12))
    with fwd_phases.narrow_fwd_using(parent):
        assert tel.NARROW_FWD is parent
        kept = tel.narrow_mats(mats)
        assert all(k is m for k, m in zip(kept, mats))
        tel.NARROW_FWD(1, 'io', ptrs(kept), 'work', 'dims', 0.5, 'stream')
        tel.NARROW_FWD(2, 'io', ptrs(bf16), 'work', 'dims', 0.5, 'stream')
    assert tel.NARROW_FWD is not parent
    assert tel.narrow_mats(mats)[0].dtype == torch.bfloat16
    assert [a[3] for a in seen] == [1, 0]
    assert seen[0][4:] == ('work', 'dims', 0.5, 'stream')
    parent.f32 = False
    with fwd_phases.narrow_fwd_using(parent):
        assert tel.narrow_mats(mats)[0].dtype == torch.bfloat16
        tel.NARROW_FWD(1, 'io', ptrs(kept), 'work', 'dims', 0.5, 'stream')
    assert seen[-1] == (1, 'io', seen[-1][2], 'work', 'dims', 0.5, 'stream')
