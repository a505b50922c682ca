"""RUNTIME.VFE_COMPUTE in the PyTorch port (tmae_tpu_torch) against the JAX
package on the CPU. With ``bf16`` the JAX VFE casts the point features to
bf16 before its MLPs, and flax's Dense promotes the product with its f32
kernel back to f32: one rounding of the features, everything after it in
f32. The port rounds the same features once (``x.to(bfloat16).float()``).
Any other value runs in f32 on both sides. The tiny-config CenterPoint on
host-voxelized sorted inputs, the same weights on both sides."""

import copy

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_port_model import HOSTVOX, _np, random_variables
from tests.tiny_cfg import synth_batch, tiny_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.models import detectors as jdet
from tmae_tpu.ops.voxelize import voxelize_host as j_voxelize_host
from tmae_tpu_torch.models import detectors as tdet
from tmae_tpu_torch.utils.from_jax import params_from_jax


def _cfg(knob):
    cfg = copy.deepcopy(tiny_cfg())
    if knob is not None:
        cfg.RUNTIME.VFE_COMPUTE = knob
    return cfg


def _port(cfg, state, batch):
    """The port's outputs and its VFE's voxel features (current, previous
    frame) on ``batch``."""
    model = tdet.build_detector(cfg, 'cpu')
    model.load_state_dict(state, strict=True)
    seen = []
    hook = model.vfe.register_forward_hook(lambda m, a, out: seen.append(
        [o['voxel_features'] for o in out]))
    try:
        with torch.no_grad():
            out = model(tdet.batch_to_device(batch, 'cpu'))
    finally:
        hook.remove()
    return out, seen[0]


@pytest.fixture(scope='module')
def bf16_slice():
    """JAX apply(train=False) with ``VFE_COMPUTE: bf16`` (its outputs and
    its VFE's) and the port's state dict of the same weights."""
    cfg = _cfg('bf16')
    batch = synth_batch(np.random.RandomState(0))
    spec = jdet.make_voxel_spec(cfg.DATA_CONFIG, cfg.RUNTIME)
    for which, pk, mk in (('cur', 'points', 'point_mask'),
                          ('prv', 'points_prev', 'point_mask_prev')):
        hv = j_voxelize_host(batch[pk], batch[mk], spec, sort_points=True)
        batch[pk], batch[mk] = hv['points'], hv['point_mask']
        for key, short in HOSTVOX:
            batch[f'{short}_{which}'] = hv[key]
    jmodel = jdet.build_detector(cfg)
    assert jmodel.vfe_compute == 'bf16'
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b,
                                                  train=False), batch)
    v = random_variables(shapes, 0)
    jout, inter = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False, capture_intermediates=True,
        mutable=['intermediates']))(v, batch)
    jvfe = [_np(d['voxel_features'])
            for d in inter['intermediates']['vfe']['__call__'][0]]
    return batch, jout, jvfe, params_from_jax(v)


def test_bf16_vfe_matches_jax(bf16_slice):
    """``VFE_COMPUTE: bf16``: the VFE's voxel features of both frames equal
    JAX's to f32 rounding (the same single bf16 rounding of the inputs,
    then f32 on both sides: max |diff| <= 1e-4 of their scale, the pillars'
    batch-norm sums running in another order), and every head map agrees
    as in tests/test_torch_port_model.py (max 0.03, mean 3e-3)."""
    batch, jout, jvfe, state = bf16_slice
    tout, tvfe = _port(_cfg('bf16'), state, batch)
    for want, got in zip(jvfe, tvfe):
        scale = max(np.abs(want).max(), 1.0)
        err = np.abs(got.numpy() - want)
        assert err.max() <= 1e-4 * scale, (err.max(), scale)
    jp, tp = jout['pred_dicts'][0], tout['pred_dicts'][0]
    assert sorted(jp) == sorted(tp)
    for name in jp:
        err = np.abs(tp[name].numpy() - _np(jp[name]))
        assert err.max() <= 0.03 and err.mean() <= 3e-3, (name, err.max())


def test_vfe_compute_knob_acts_and_f32_is_unchanged(bf16_slice):
    """The knob acts: ``bf16`` changes the VFE's features against ``f32``
    on the same weights and inputs. ``f32``, an absent knob and any other
    value (JAX tests for ``'bf16'`` alone) give the same outputs bit for
    bit, and only ``bf16`` makes the encoder round."""
    batch, _, _, state = bf16_slice
    runs = {k: _port(_cfg(k), state, batch)
            for k in ('bf16', 'f32', None, 'f16')}
    assert any(not torch.equal(a, b)
               for a, b in zip(runs['bf16'][1], runs['f32'][1]))
    for knob in (None, 'f16'):
        for a, b in zip(runs[knob][1], runs['f32'][1]):
            assert torch.equal(a, b), knob
        for name, t in runs['f32'][0]['pred_dicts'][0].items():
            assert torch.equal(runs[knob][0]['pred_dicts'][0][name], t)
    for knob, rounds in (('bf16', True), ('f32', False), (None, False),
                         ('f16', False)):
        enc = tdet.build_detector(_cfg(knob), 'cpu').vfe.encoder
        assert enc.round_bf16 is rounds, knob
