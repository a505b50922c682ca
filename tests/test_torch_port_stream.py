"""Streaming serving and the fused in-place serving layer of the PyTorch
port (tmae_tpu_torch) against the JAX package on the CPU: the plain version
of K12 (``encoder_layer_fused_pipelined``) against the JAX Pallas kernels
K12 and K11 (``encoder_layer_fused_inplace``) in interpret mode; the plain
K1 / K2 against the other gather / scatter schedules K13a, K13d, K14a and
K14b in interpret mode; the fused path of the SST and WCA layers against
the combined path; the streaming entry point (``cached_prev`` /
``return_hidden``) against the stateless pass and against JAX's streaming
pass on the same weights. Tolerances are stated beside each comparison."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_kernels import (_bf16_np, _layer_params,
                                           _port_params, _t)
from tests.test_torch_port_model import HOSTVOX, T_MAE, random_variables
from tests.tiny_cfg import synth_batch, tiny_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.models import detectors as jdet
from tmae_tpu.ops import occ_compact as joc
from tmae_tpu.ops import pallas_encoder as jpe
from tmae_tpu.ops.dense_windows import slot_pos_embed as j_slot_pos_embed
from tmae_tpu.ops.voxelize import voxelize_host as j_voxelize_host
from tmae_tpu_torch.models import detectors as tdet
from tmae_tpu_torch.models import sst as tsst
from tmae_tpu_torch.models.sst import DenseGrid, OccCaps, SSTBlock
from tmae_tpu_torch.models.vfe import TemporalDynVFE
from tmae_tpu_torch.models.wca import WCABlock
from tmae_tpu_torch.ops import occ_compact as toc
from tmae_tpu_torch.ops.encoder_layer import (LayerParams,
                                              encoder_layer_fused_inplace,
                                              encoder_layer_fused_pipelined)
from tmae_tpu_torch.ops.voxelize import VoxelSpec
from tmae_tpu_torch.utils.from_jax import params_from_jax

H, W, B = 32, 40, 2
CAPS = dict(small_cap=16, full_cap=16, mid_cap=16)


def _stream_occ(rng):
    """Occupancy of a 32x40 grid with sparse, medium and dense windows, so
    that each bucket of caps 16 holds real and padding slots."""
    occ = rng.rand(B, H, W) < 0.03
    occ[:, 2:9, 3:10] |= rng.rand(B, 7, 7) < 0.8
    occ[:, 10:32, 12:40] = True
    occ[:, 22:30, 1:9] |= rng.rand(B, 8, 8) < 0.5
    return occ


def _plans(occ, kocc, shift):
    kw = dict(small_tokens=16, mid_tokens=48, **CAPS)
    jb = joc.build_bucketed_compact_info(
        jnp.asarray(occ), 8, shift, kw['small_cap'], kw['full_cap'], (H, W),
        kv_occ=None if kocc is None else jnp.asarray(kocc),
        small_tokens=16, mid_cap=kw['mid_cap'], mid_tokens=48)
    tb = toc.build_bucketed_compact_info(
        _t(occ), 8, shift, kw['small_cap'], kw['full_cap'], (H, W),
        kv_occ=None if kocc is None else _t(kocc), small_tokens=16,
        mid_cap=kw['mid_cap'], mid_tokens=48)
    return jb, tb


def _plan_cells(idx, valid, shape):
    """Carrier cells [B, Hp2, Wp] inside the plan's real windows."""
    m = np.zeros(shape, bool)
    for b, s in zip(*np.nonzero(valid)):
        wy, wx = idx[b, s]
        m[b, 8 * wy:8 * wy + 8, 8 * wx:8 * wx + 8] = True
    return m


FUSED_CASES = [(128, 'full', False), (128, 'small', False),
               (128, 'mid', False), (128, 'full', True),
               (128, 'small', True), (128, 'mid', True),
               (256, 'full', False)]


@pytest.mark.parametrize('jax_kernel', ['K12', 'K11'])
@pytest.mark.parametrize('C,bucket,cross', FUSED_CASES)
def test_fused_layer_plain_matches_pallas_interpret(C, bucket, cross,
                                                    jax_kernel):
    """K12's plain version against JAX's K12 (``encoder_layer_fused_
    pipelined``) and K11 (``encoder_layer_fused_inplace``) in interpret
    mode, on one bucket plan (full T=64, small S=16, mid S=48) of a 32x40
    grid, self and cross, C=128 (head width 16) and C=256 (32). The
    carrier holds random values in every cell, so a write outside the
    plan's windows would show. On the windows of the plan: max |diff| <=
    0.06 and mean <= 2e-3 (K3/K4's CPU limit: bf16 outputs, a rounding flip
    of an intermediate bf16 cast). Every other real carrier cell is
    bit-equal on both sides and to the input; the port leaves the dummy
    window row as it was (the JAX kernels write padding slots there)."""
    rng = np.random.RandomState(C + len(bucket) + 2 * int(cross))
    occ = _stream_occ(rng)
    kocc = _stream_occ(rng) if cross else None
    jb, tb = _plans(occ, kocc, shift=False)
    jci, tci = getattr(jb, bucket), getattr(tb, bucket)
    valid = np.asarray(jci.valid)
    assert valid.any() and (~valid).any(), 'need real and dummy slots'
    sel = bucket != 'full'
    Fd = 2 * C
    p = _layer_params(rng, C, Fd)
    jparams = [jnp.asarray(p[k]) for k in LayerParams._fields]
    pos = _bf16_np(np.asarray(j_slot_pos_embed(8, C)))
    shape = (B, 48, 48, C)  # the padded carrier of a 32x40 grid
    assert toc.pad_grid(torch.zeros(B, H, W, 1), 8, False).shape[:3] == \
        shape[:3]
    xp = _bf16_np(rng.normal(0, 1, shape).astype(np.float32))
    kvp = _bf16_np(rng.normal(0, 1, shape).astype(np.float32))
    fn = (jpe.encoder_layer_fused_pipelined if jax_kernel == 'K12'
          else jpe.encoder_layer_fused_inplace)
    kw = dict(nhead=8, tau_min=0.01, cross=cross, window=8, sel=sel)
    try:
        jpe.set_interpret(True)
        want = fn(jnp.asarray(xp, jnp.bfloat16),
                  jnp.asarray(kvp, jnp.bfloat16) if cross else None, jci,
                  jnp.asarray(pos, jnp.bfloat16), *jparams, **kw)
        want = np.asarray(want, np.float32)
    finally:
        jpe.set_interpret(False)
    port = (encoder_layer_fused_pipelined if jax_kernel == 'K12'
            else encoder_layer_fused_inplace)
    tx = _t(xp).to(torch.bfloat16)
    got = port(tx, _t(kvp).to(torch.bfloat16) if cross else None, tci,
               _t(pos).to(torch.bfloat16), _port_params(p), **kw)
    assert got is tx  # updated in place
    got = got.float().numpy()
    real = shape[1] - 8
    inside = _plan_cells(np.asarray(jci.idx), valid, shape[:3])
    inside = inside[:, :real]
    err = np.abs(got[:, :real] - want[:, :real])[inside]
    assert err.max() <= 0.06 and err.mean() <= 2e-3, (err.max(), err.mean())
    outside = ~inside
    np.testing.assert_array_equal(got[:, :real][outside],
                                  want[:, :real][outside])
    np.testing.assert_array_equal(got[:, :real][outside],
                                  xp[:, :real][outside])
    np.testing.assert_array_equal(got[:, real:], xp[:, real:])


def test_fused_layer_refuses_aliased_kv_and_gradients():
    """The in-place layer has no backward and reads kv from another
    carrier: it refuses a kvp that shares memory with xp, and inputs that
    require a gradient under grad mode."""
    rng = np.random.RandomState(1)
    occ = _stream_occ(rng)
    _, tb = _plans(occ, occ, shift=False)
    p = _port_params(_layer_params(rng, 128, 256))
    xp = torch.zeros(B, 48, 48, 128, dtype=torch.bfloat16)
    pos = torch.zeros(64, 128, dtype=torch.bfloat16)
    kw = dict(nhead=8, tau_min=0.01, window=8, sel=False)
    with pytest.raises(ValueError, match='shares memory'):
        encoder_layer_fused_pipelined(xp, xp[:], tb.full, pos, p, cross=True,
                                      **kw)
    with pytest.raises(ValueError, match='no backward'):
        encoder_layer_fused_pipelined(xp.float().requires_grad_(), None,
                                      tb.full, pos, p, cross=False, **kw)


# ---------------------------------------------------------------------------
# K13a / K13d / K14a / K14b: the other gather / scatter schedules, closed by
# K1 / K2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('schedule', ['K13a', 'K13d', 'K14a', 'K14b'])
def test_k1_k2_close_the_other_window_schedules(schedule):
    """K1's (gather) and K2's (scatter-overwrite) plain versions against
    the JAX package's other schedules of the same functions, each run in
    interpret mode on a bucketed ``cat_idx`` plan (both shifts): K13a
    ``_gather_pallas`` (one window per step), K13d the BlockSpec branch of
    ``scatter_windows_into_padded``, K14a ``_gather_pallas_run`` and K14b
    ``_scatter_into_pallas_run`` (run-merged strips). The carrier holds
    random values but for its dummy window row, which is zero as
    ``pad_grid`` leaves it (the JAX gathers read padding slots from it, K1
    gives zeros for them). Gathers bit-equal on every slot; scatters
    bit-equal on the real carrier rows (the JAX scatters write padding
    slots into the dummy window row; K2 does not, and leaves it as it
    was)."""
    rng = np.random.RandomState(40 + len(schedule))
    occ = _stream_occ(rng)
    C = 16
    for shift in (False, True):
        _, tb = _plans(occ, None, shift)
        idx = tb.cat_idx.numpy()
        assert idx.shape[1] % 16 == 0 and (idx[..., 0] == 5).any()
        x = _bf16_np(rng.normal(0, 1, (B, 48, 48, C)).astype(np.float32))
        x[:, 40:] = 0  # the dummy window row, as pad_grid leaves it
        jx, jidx = jnp.asarray(x, jnp.bfloat16), jnp.asarray(idx)
        xw = _bf16_np(rng.normal(0, 1, (B, idx.shape[1], 64, C)).astype(
            np.float32))
        jxw = jnp.asarray(xw, jnp.bfloat16)
        try:
            joc.set_interpret(True)
            if schedule == 'K13a':
                want = joc._gather_pallas(jx, jidx, 8)
            elif schedule == 'K14a':
                want = joc._gather_pallas_run(
                    jx, jidx, joc._run_widths(jidx, joc._MULTI), 8)
            elif schedule == 'K13d':
                assert joc._INTERPRET  # interpret mode takes this branch
                want = joc.scatter_windows_into_padded(jxw, jidx, jx, 8)
            else:
                want = joc._scatter_into_pallas_run(
                    jxw, jidx, joc._run_widths(jidx, joc._MULTI), jx, 8)
            want = np.asarray(want, np.float32)
        finally:
            joc.set_interpret(False)
        if schedule in ('K13a', 'K14a'):
            got = toc.gather_windows_padded_plain(
                _t(x).to(torch.bfloat16), _t(idx), 8)
            np.testing.assert_array_equal(
                got.float().numpy(), want.reshape(got.shape))
        else:
            tx = _t(x).to(torch.bfloat16)
            got = toc.scatter_windows_into_padded_plain(
                _t(xw).to(torch.bfloat16), _t(idx), tx, 8).float().numpy()
            real = x.shape[1] - 8
            np.testing.assert_array_equal(got[:, :real], want[:, :real])
            np.testing.assert_array_equal(got[:, real:], x[:, real:])


# ---------------------------------------------------------------------------
# The fused path in the model: equal to the combined path
# ---------------------------------------------------------------------------


def _fused_vs_combined(monkeypatch, run):
    with torch.no_grad():
        monkeypatch.setattr(tsst, '_FUSED_INPLACE', False)
        a = run()
        monkeypatch.setattr(tsst, '_FUSED_INPLACE', True)
        b = run()
    return a, b


@pytest.mark.parametrize('stage', [0, 1])
def test_fused_inplace_path_equals_combined_path(monkeypatch, stage):
    """An SST stage and the WCA block of t_mae.yaml (full width, stage 0
    C=128 and stage 1 C=256) in eval mode with the fused in-place path
    (small, then mid, then full bucket, each in place) and with the
    combined gather / rows / scatter path (every window gathered before any
    is updated): the same carrier, since each window reads only itself.
    Plain versions on the CPU, same weights and inputs: bit-equal, overflow
    counts equal."""
    rng = np.random.RandomState(30 + stage)
    ecfg = dict(T_MAE.MODEL.BACKBONE_3D.SST_BLOCK_LIST[stage]['ENCODER'])
    caps = OccCaps(16, 16, 16, 16, 48)
    torch.manual_seed(stage)
    block = SSTBlock(128, ecfg, caps).eval()
    wca = WCABlock(ecfg, caps).eval()
    occ = torch.from_numpy(_stream_occ(rng))
    x = torch.from_numpy(np.where(occ[..., None].numpy(), rng.normal(
        size=(B, H, W, 128)), 0).astype(np.float32)).to(torch.bfloat16)
    grid = DenseGrid(x, occ)
    (ya, ova), (yb, ovb) = _fused_vs_combined(monkeypatch,
                                              lambda: block(grid))
    assert torch.equal(ya.x, yb.x) and torch.equal(ova, ovb)
    cur, prv = DenseGrid(ya.x[:1], ya.occ[:1]), DenseGrid(ya.x[1:],
                                                          ya.occ[1:])
    (wa, oa), (wb, ob) = _fused_vs_combined(monkeypatch,
                                            lambda: wca(cur, prv))
    assert torch.equal(wa.x, wb.x) and torch.equal(oa, ob)


def test_fused_inplace_switch_reads_the_environment():
    """``_FUSED_INPLACE`` is read once at import: TMAE_FUSED_INPLACE turns
    the fused path on, TMAE_NO_FUSED_INPLACE wins over it."""
    import os
    import subprocess
    import sys

    code = ('import tmae_tpu_torch.models.sst as s; '
            'print(int(s._FUSED_INPLACE))')
    seen = []
    for env in ({}, {'TMAE_FUSED_INPLACE': '1'},
                {'TMAE_FUSED_INPLACE': '1', 'TMAE_NO_FUSED_INPLACE': '1'}):
        full = {k: v for k, v in os.environ.items()
                if k not in ('TMAE_FUSED_INPLACE', 'TMAE_NO_FUSED_INPLACE')}
        out = subprocess.run([sys.executable, '-c', code], env={**full, **env},
                             capture_output=True, text=True, check=True)
        seen.append(out.stdout.strip())
    assert seen == ['0', '1', '0']


# ---------------------------------------------------------------------------
# Streaming serving
# ---------------------------------------------------------------------------


def test_vfe_skips_the_previous_frame_when_not_needed():
    """``TemporalDynVFE(prev_needed=False)`` runs the current frame only:
    its outputs equal those of the two-frame call, the previous frame's
    slot is None."""
    spec = VoxelSpec((-5.12, -5.12, -5.0, 5.12, 5.12, 3.0),
                     (0.32, 0.32, 8.0), 256, 128)
    torch.manual_seed(0)
    vfe = TemporalDynVFE(spec, [[8, 16]]).eval()
    rng = np.random.RandomState(2)
    b = {k: torch.from_numpy(v) for k, v in synth_batch(rng, B=1).items()}
    with torch.no_grad():
        both = vfe(b['points'], b['point_mask'], b['points_prev'],
                   b['point_mask_prev'], {}, {})
        cur, prv = vfe(b['points'], b['point_mask'], b['points_prev'],
                       b['point_mask_prev'], {}, {}, prev_needed=False)
    assert prv is None and both[1] is not None
    assert torch.equal(cur['voxel_features'], both[0]['voxel_features'])


@pytest.fixture(scope='module')
def stream_slice():
    """The tiny-config CenterPoint (with a mid bucket) on host-voxelized,
    sorted inputs of two frame pairs, with the same weights in JAX and in
    the port: for each, the stateless pass, the previous frame encoded
    alone (``return_hidden``) and the streaming pass on its pyramid."""
    cfg = copy.deepcopy(tiny_cfg(mae=False))
    cfg.RUNTIME.OCC_MID_CAPS = [16, 16, 16]
    batch = synth_batch(np.random.RandomState(5))
    spec = jdet.make_voxel_spec(cfg.DATA_CONFIG, cfg.RUNTIME)
    for which, pk, mk in (('cur', 'points', 'point_mask'),
                          ('prv', 'points_prev', 'point_mask_prev')):
        hv = j_voxelize_host(batch[pk], batch[mk], spec, sort_points=True)
        batch[pk], batch[mk] = hv['points'], hv['point_mask']
        for key, short in HOSTVOX:
            batch[f'{short}_{which}'] = hv[key]
    first = tdet.previous_frame_batch(batch)
    jmodel = jdet.build_detector(cfg)
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b,
                                                  train=False), batch)
    v = random_variables(shapes, 3)
    japply = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))
    jhid = jax.jit(lambda v, b: jmodel.apply(v, b, train=False,
                                             return_hidden=True))
    jstream = jax.jit(lambda v, b, h: jmodel.apply(v, b, train=False,
                                                   cached_prev=h))
    jout = japply(v, batch)
    jstr = jstream(v, batch, jhid(v, first)['hidden_cur'])
    tmodel = tdet.build_detector(cfg, 'cpu')
    tmodel.load_state_dict(params_from_jax(v), strict=True)
    tb = tdet.batch_to_device(batch, 'cpu')
    with torch.no_grad():
        tout = tmodel(tb)
        hid = tmodel(tdet.batch_to_device(first, 'cpu'),
                     return_hidden=True)['hidden_cur']
        tstr = tmodel(tb, cached_prev=hid, return_hidden=True)
    return jout, jstr, tout, tstr, hid


def test_streaming_matches_stateless(stream_slice):
    """The port's streaming pass (previous frame's pyramid from the cache,
    current frame alone through the VFE and SST stages) against its
    stateless pass on the same frames: eval batch norms and plans are per
    sample, so every head map agrees to f32 rounding (1e-5, the JAX
    package's test_streaming limit); the pyramid it returns is the current
    frame's (batch 2, three stages); JAX's streaming pass agrees with its
    stateless one the same way."""
    jout, jstr, tout, tstr, hid = stream_slice
    for name, a in tout['pred_dicts'][0].items():
        np.testing.assert_allclose(tstr['pred_dicts'][0][name].numpy(),
                                   a.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(np.asarray(jstr['pred_dicts'][0][name]),
                                   np.asarray(jout['pred_dicts'][0][name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    assert len(hid) == 3 and all(h.x.shape[0] == 2 for h in hid)
    assert len(tstr['hidden_cur']) == 3
    assert tstr['occ_overflow'].shape == (6, 2)


def test_streaming_matches_jax_streaming(stream_slice):
    """The port's streaming pass against JAX's streaming pass on the same
    weights (``params_from_jax``) and frames: head maps within the tiny
    slice's limits of test_torch_port_model (max |diff| <= 0.03 on values
    of magnitude ~1, mean <= 3e-3: the port rounds the encoder's weights to
    bf16 as its kernels do, the JAX CPU path keeps them in f32)."""
    _, jstr, _, tstr, _ = stream_slice
    for name, a in tstr['pred_dicts'][0].items():
        err = np.abs(a.numpy() - np.asarray(jstr['pred_dicts'][0][name],
                                            np.float32))
        assert err.max() <= 0.03 and err.mean() <= 3e-3, (name, err.max())


def test_previous_frame_batch_swaps_every_frame_key():
    """The first step of a stream encodes the previous frame as the current
    one: the points, the mask and every host-voxelization key move
    together."""
    keys = ['points', 'point_mask'] + [f'{s}_cur' for _, s in HOSTVOX]
    batch = {k: k for k in keys}
    batch.update({k.replace('_cur', '_prv') if k.endswith('_cur') else
                  k + '_prev': 'prev ' + k for k in keys})
    first = tdet.previous_frame_batch(batch)
    assert first['points'] == 'prev points'
    assert first['point_mask'] == 'prev point_mask'
    for _, s in HOSTVOX:
        assert first[f'{s}_cur'] == f'prev {s}_cur'
        assert first[f'{s}_prv'] == f'prev {s}_cur'
