"""The PyTorch port (tmae_tpu_torch) against the JAX package on the CPU, at
module and slice level: one full-width SST stage and one full-width WCA
block of t_mae.yaml, the whole tiny-config CenterPoint with its weights
carried across by ``params_from_jax`` (and with reference-named weights
through each side's converter), and decode + host NMS on identical head
maps. The JAX modules run on the CPU through their jnp reference
layers (f32 weights), the port through the plain versions of its kernels
(bf16 weights, as the kernels take them), so tolerances cover bf16 weight
rounding; each is stated beside its comparison."""

import copy
from pathlib import Path

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.tiny_cfg import synth_batch, tiny_cfg
from tmae_tpu.config import cfg_from_yaml_file
from tmae_tpu.models import detectors as jdet
from tmae_tpu.models.sst import DenseGrid as JDenseGrid
from tmae_tpu.models.sst import SSTBlock as JSSTBlock
from tmae_tpu.models.wca import WCABlock as JWCABlock
from tmae_tpu.ops.voxelize import voxelize_host as j_voxelize_host
from tmae_tpu_torch.models import detectors as tdet
from tmae_tpu_torch.models.sst import DenseGrid, OccCaps, SSTBlock
from tmae_tpu_torch.models.wca import WCABlock
from tmae_tpu_torch.utils.from_jax import params_from_jax

HOSTVOX = (('point_voxel', 'pv'), ('point_valid', 'pvalid'),
           ('voxel_coords', 'vcoords'), ('voxel_mask', 'vmask'),
           ('voxel_mean_xyz', 'vmean'), ('seg_ends', 'vends'))


def random_variables(shapes, seed):
    """Seeded numpy values for every leaf of a flax variable tree: weights
    at 1/sqrt(fan_in), BN statistics and LayerNorm scales off their
    identity values so the conversion of each is exercised."""
    rng = np.random.RandomState(seed)
    out = {}
    for col, tree in shapes.items():
        flat = {}
        for k, s in tu.flatten_dict(tree).items():
            leaf = k[-1]
            if leaf == 'var':
                a = rng.uniform(0.5, 1.5, s.shape)
            elif leaf in ('scale', 'ln1_scale', 'ln2_scale'):
                a = 1.0 + 0.1 * rng.normal(size=s.shape)
            elif leaf == 'tau':
                a = rng.uniform(0.5, 1.5, s.shape)
            elif leaf.endswith('kernel'):
                a = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
            else:
                a = 0.1 * rng.normal(size=s.shape)
            flat[k] = a.astype(np.float32)
        out[col] = tu.unflatten_dict(flat)
    return out


def _np(x):
    return np.array(x, np.float32)


def _occ_grid(rng, B, H, W):
    """Sparse, medium and dense regions: all three buckets populated."""
    occ = rng.rand(B, H, W) < 0.04
    occ[:, 3:9, 2:9] |= rng.rand(B, 6, 7) < 0.8
    occ[:, 12:30, 12:30] = True
    occ[:, 22:30, 1:9] |= rng.rand(B, 8, 8) < 0.5
    return occ


T_MAE = cfg_from_yaml_file(Path(__file__).resolve().parent.parent
                           / 'tools/cfgs/once_models/t_mae.yaml')


@pytest.mark.parametrize('stage', [0, 1])
def test_full_width_sst_stage_and_wca_block(stage):
    """Stage 0 (C=128, stride 1) and stage 1 (C=256, stride 2) of t_mae.yaml,
    two shifted blocks each, plus the stage's WCA block, on a 32x32 grid
    with caps small enough that every bucket is used and some overflow.
    bf16 carriers after a LayerNorm-scale stack: max |diff| <= 0.1, mean
    <= 4e-3; overflow counts are equal."""
    rng = np.random.RandomState(20 + stage)
    blk = T_MAE.MODEL.BACKBONE_3D.SST_BLOCK_LIST[stage]
    ecfg = dict(blk['ENCODER'])
    C = int(ecfg['D_MODEL'])
    cin = 128
    B, H, W = 2, 32, 32
    caps = dict(occ_window_cap=16, occ_small_cap=16, occ_small_tokens=16,
                occ_mid_cap=16, occ_mid_tokens=48)
    occ = _occ_grid(rng, B, H, W)
    x = np.where(occ[..., None], rng.normal(size=(B, H, W, cin)), 0)
    x = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    jgrid = JDenseGrid(x=jnp.asarray(x.float().numpy(), jnp.bfloat16),
                       occ=jnp.asarray(occ))
    jblock = JSSTBlock(encoder_cfg=ecfg, **caps)
    shapes = jax.eval_shape(lambda g: jblock.init(jax.random.PRNGKey(0), g,
                                                  False), jgrid)
    v = random_variables(shapes, stage)
    jout, state = jax.jit(lambda v, g: jblock.apply(
        v, g, False, mutable=['intermediates']))(v, jgrid)

    tcaps = OccCaps(16, 16, 16, 16, 48)
    tblock = SSTBlock(cin, ecfg, tcaps).eval()
    tblock.load_state_dict(params_from_jax(v), strict=True)
    with torch.no_grad():
        tout, overflow = tblock(DenseGrid(x, torch.from_numpy(occ)))
    err = np.abs(tout.x.float().numpy() - _np(jout.x))
    assert err.max() <= 0.1 and err.mean() <= 4e-3, (err.max(), err.mean())
    np.testing.assert_array_equal(tout.occ.numpy(), np.asarray(jout.occ))
    want_ov = np.asarray(state['intermediates']['occ_overflow'][0])
    np.testing.assert_array_equal(overflow.numpy(), want_ov)
    if stage == 0:  # the dense region overflows the full cap at stride 1
        assert want_ov.sum() > 0

    # the WCA block of the same stage: current frame = sample 0, previous
    # frame = sample 1 of the stage output
    g = (jout.x, jout.occ)
    jcur = JDenseGrid(x=g[0][:1], occ=g[1][:1])
    jprv = JDenseGrid(x=g[0][1:], occ=g[1][1:])
    jwca = JWCABlock(encoder_cfg=ecfg, **caps)
    shapes = jax.eval_shape(lambda a, b: jwca.init(jax.random.PRNGKey(0), a,
                                                   b, False), jcur, jprv)
    vw = random_variables(shapes, 10 + stage)
    jw = jax.jit(lambda v, a, b: jwca.apply(v, a, b, False))(vw, jcur, jprv)
    twca = WCABlock(ecfg, tcaps).eval()
    twca.load_state_dict(params_from_jax(vw), strict=True)
    tx = torch.from_numpy(_np(g[0])).to(torch.bfloat16)
    tocc = torch.from_numpy(np.array(g[1]))
    with torch.no_grad():
        tw, _ = twca(DenseGrid(tx[:1], tocc[:1]), DenseGrid(tx[1:], tocc[1:]))
    err = np.abs(tw.x.float().numpy() - _np(jw.x))
    assert err.max() <= 0.1 and err.mean() <= 4e-3, (err.max(), err.mean())


@pytest.fixture(scope='module')
def tiny_forward():
    """The tiny-config CenterPoint with a mid bucket, its host-voxelized
    sorted inputs and JAX's compiled apply(train=False), shared by the
    tests that hand it weights."""
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
    jmodel = jdet.build_detector(cfg)
    return cfg, batch, jmodel, jax.jit(
        lambda v, b: jmodel.apply(v, b, train=False))


@pytest.fixture(scope='module')
def tiny_slice(tiny_forward):
    """JAX's tiny slice and the port with the same random weights, on the
    CPU."""
    cfg, batch, jmodel, jfwd = tiny_forward
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b,
                                                  train=False), batch)
    v = random_variables(shapes, 0)
    jout = jfwd(v, batch)
    tmodel = tdet.build_detector(cfg, 'cpu')
    tmodel.load_state_dict(params_from_jax(v), strict=True)
    with torch.no_grad():
        tout = tmodel(tdet.batch_to_device(batch, 'cpu'))
    return cfg, jout, tout


def test_tiny_slice_head_maps_and_features(tiny_slice):
    """Every head map (f32) and spatial_features_2d (bf16) of the whole
    slice: head maps max |diff| <= 0.03 on values of magnitude ~1, mean
    <= 3e-3; features within 2 bf16 steps at their scale (0.04), mean
    <= 3e-3."""
    cfg, jout, tout = tiny_slice
    jp, tp = jout['pred_dicts'][0], tout['pred_dicts'][0]
    assert sorted(jp) == sorted(tp)
    for name in jp:
        err = np.abs(tp[name].numpy() - _np(jp[name]))
        assert err.max() <= 0.03 and err.mean() <= 3e-3, (name, err.max())
    err = np.abs(tout['spatial_features_2d'].float().numpy()
                 - _np(jout['spatial_features_2d']))
    assert err.max() <= 0.04 and err.mean() <= 3e-3, err.max()
    assert tout['occ_overflow'].shape == (6, 2)


def test_converted_reference_weights_head_maps(tiny_forward):
    """A reference-named state dict of the tiny model
    (``tests/test_convert_mapping.py``, its values brought to the ranges of
    :func:`random_variables`: weights at 1 / sqrt(fan_in), norm scales
    1 + 0.1 N, biases and means 0.1 N) through JAX's ``convert_state_dict``
    into JAX's forward, and through the port's converter into the port (a
    strict load): the head maps agree within the tiny slice's
    tolerances."""
    from tests.test_convert_mapping import make_reference_state_dict
    from tmae_tpu.utils.torch_convert import convert_state_dict as j_convert
    from tmae_tpu_torch.utils.torch_convert import convert_state_dict

    def ranged(k, v):
        if v.ndim >= 2:
            return v / np.sqrt(np.prod(v.shape[1:]))
        if k.endswith(('running_var', '.tau')):
            return v
        return 1 + 0.1 * v if k.endswith('.weight') else 0.1 * v

    cfg, batch, _, jfwd = tiny_forward
    sd = {k: ranged(k, v).astype(np.float32) for k, v in
          make_reference_state_dict(np.random.RandomState(4)).items()}
    params, stats, _ = j_convert(sd)
    jp = jfwd({'params': params, 'batch_stats': stats}, batch)[
        'pred_dicts'][0]
    tmodel = tdet.build_detector(cfg, 'cpu')
    tmodel.load_state_dict(convert_state_dict(sd)[0], strict=True)
    with torch.no_grad():
        tp = tmodel(tdet.batch_to_device(batch, 'cpu'))['pred_dicts'][0]
    assert sorted(jp) == sorted(tp)
    for name in jp:
        err = np.abs(tp[name].numpy() - _np(jp[name]))
        assert err.max() <= 0.03 and err.mean() <= 3e-3, (name, err.max())


def test_tiny_slice_decode_and_host_nms(tiny_slice):
    """Decode + host NMS on identical head maps (the JAX model's): equal
    candidate order, labels, validity and kept set; boxes and scores to f32
    rounding (1e-5)."""
    cfg, jout, _ = tiny_slice
    jb, js, jl, jv = jdet.centerpoint_predict(cfg, jout, nms_on_device=False)
    jkeep = jdet.host_nms(cfg, jb, js, jl, jv)
    maps = {'pred_dicts': [{k: torch.from_numpy(_np(a)) for k, a in
                            jout['pred_dicts'][0].items()}]}
    tb, ts, tl, tv = tdet.centerpoint_predict(cfg, maps)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    tkeep = tdet.host_nms(cfg, tb, ts, tl, tv)
    np.testing.assert_array_equal(tkeep, np.asarray(jkeep))
    assert 0 < tkeep.sum() < tv.numpy().sum()


@pytest.mark.parametrize('thresh', [0.1, 0.5])
def test_host_nms_matches_jax_on_crowded_boxes(thresh):
    """The port's NMS computes intersections only for pairs whose
    circumscribed circles meet; on crowded boxes (many overlapping pairs,
    some far apart) it keeps exactly the JAX package's numpy NMS set."""
    from tmae_tpu.ops.geometry_np import nms_bev as j_nms_bev
    from tmae_tpu_torch.ops.geometry_np import nms_bev

    rng = np.random.RandomState(int(thresh * 10))
    n = 300
    boxes = np.zeros((n, 7))
    boxes[:, :2] = rng.uniform(-12, 12, (n, 2))
    boxes[:n // 3, :2] = rng.uniform(40, 41, (n // 3, 2))  # a tight cluster
    boxes[:, 2] = rng.normal(size=n)
    boxes[:, 3:6] = np.exp(rng.normal(0.5, 0.5, (n, 3)))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    scores = rng.rand(n)
    want = j_nms_bev(boxes, scores, thresh, post_maxsize=200)
    got = nms_bev(boxes, scores, thresh, post_maxsize=200)
    np.testing.assert_array_equal(got, want)
    assert 10 < len(got) < n
