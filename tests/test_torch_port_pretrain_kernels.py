"""Pretraining kernels and functions of the PyTorch port against the JAX
package on the CPU: the plain version of K10 (the grid-native encoder layer)
against ``_grid_forward`` in interpret mode and against
``reference_encoder_layer_grid``; the K10 autograd Function's gradients
against ``jax.vjp`` of ``fused_encoder_layer_grid`` in interpret mode (whose
backward runs the K7 Pallas kernel on the windows) and against the
backward over all windows; the device voxelizer, the scatter segment max's
tie rule, the MAE targets, the Chamfer loss and the random voxel mask.
Inputs are made from a seed with numpy; each tolerance is stated beside its
comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.models import siamwca as jsw
from tmae_tpu.ops import chamfer as jch
from tmae_tpu.ops import pallas_encoder as jpe
from tmae_tpu.ops import voxelize as jvox
from tmae_tpu.ops.dense_windows import slot_pos_embed as j_slot_pos_embed
from tmae_tpu_torch.models import siamwca as tsw
from tmae_tpu_torch.ops import voxelize as tvox
from tmae_tpu_torch.ops.chamfer import chamfer_distance
from tmae_tpu_torch.ops.encoder_layer import (LayerParams,
                                              fused_encoder_layer_grid,
                                              kernel_params,
                                              reference_encoder_layer_grid)

C, F, H = 128, 256, 8
TAU_MIN = 0.01
FIELDS = LayerParams._fields
MATRICES = ('wq', 'wk', 'wv', 'wo', 'f1w', 'f2w')


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_np(a):
    return torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _grid_case(seed, cross, B=2, Hg=20, Wg=20):
    """A 20x20 grid pair: scattered occupancy with a dense patch and an
    empty band (windows with no query cell), a key frame with other
    occupancy and an empty corner (windows with no key), bf16 features that
    are zero off the occupancy, a gradient g, and one layer's weights in the
    JAX layout [in, out] with bf16 matrices (the kernels' operands on both
    sides)."""
    rng = np.random.RandomState(seed)
    occ = rng.rand(B, Hg, Wg) < 0.25
    occ[:, 2:9, 3:11] |= rng.rand(B, 7, 8) < 0.8
    occ[:, 12:, :] = False
    kocc = rng.rand(B, Hg, Wg) < 0.3
    kocc[:, :6, 12:] = False
    x = _bf16_np(np.where(occ[..., None], rng.normal(0, 1, (B, Hg, Wg, C)),
                          0))
    kv = _bf16_np(np.where(kocc[..., None],
                           rng.normal(0, 1, (B, Hg, Wg, C)), 0))
    if not cross:
        kv, kocc = x, occ
    g = _bf16_np(rng.normal(0, 1, (B, Hg, Wg, C)))

    def lin(i, o):
        return _bf16_np(rng.normal(0, 1, (i, o)) / np.sqrt(i))

    def vec(n, s=0.1, m=0.0):
        return (m + s * rng.normal(size=(n,))).astype(np.float32)

    p = dict(wq=lin(C, C), bq=vec(C), wk=lin(C, C), bk=vec(C), wv=lin(C, C),
             bv=vec(C), wo=lin(C, C), bo=vec(C),
             tau=np.asarray([0.7], np.float32), ln1s=vec(C, m=1.0),
             ln1b=vec(C), f1w=lin(C, F), f1b=vec(F), f2w=lin(F, C),
             f2b=vec(C), ln2s=vec(C, m=1.0), ln2b=vec(C))
    pos = _bf16_np(np.asarray(j_slot_pos_embed(8, C)))
    return x, kv, occ, kocc, pos, p, g


def _port_weights(p):
    """JAX layout → the port's: Linear matrices [out, in], f32."""
    return [_t(p[k].T.copy()) if k in MATRICES else _t(p[k]) for k in FIELDS]


def _jax_args(x, kv, occ, kocc, pos, p):
    return ((jnp.asarray(x, jnp.bfloat16), jnp.asarray(kv, jnp.bfloat16),
             jnp.asarray(occ), jnp.asarray(kocc),
             jnp.asarray(pos, jnp.bfloat16)),
            [jnp.asarray(p[k]) for k in FIELDS])


GRID_CASES = [(False, False), (False, True), (True, False), (True, True)]


def _gid(case):
    cross, shift = case
    return f'{"cross" if cross else "self"}-shift{int(shift)}'


@pytest.mark.parametrize('case', GRID_CASES, ids=_gid)
def test_grid_layer_plain_matches_pallas_interpret_and_reference(case):
    """Plain K10 vs ``_grid_forward`` in interpret mode and vs
    ``reference_encoder_layer_grid``, on a 20x20 grid at t_mae.yaml's
    stage-1 width (C=128, 8 heads, FFN 256) with 4x4 windows per frame of
    the shift's partition. Against the Pallas kernel (bf16 operands, f32
    accumulation on both sides; a summation order can flip one bf16
    rounding of an intermediate): max |diff| <= 0.06 on LayerNorm-scale
    values, mean <= 2e-3. Against the jnp reference, which keeps its
    intermediates in f32: max <= 0.1, mean <= 4e-3. Unoccupied cells are 0
    on every side."""
    cross, shift = case
    x, kv, occ, kocc, pos, p, _ = _grid_case(40 + 2 * cross + shift, cross)
    jargs, jparams = _jax_args(x, kv, occ, kocc, pos, p)
    kw = dict(nhead=H, tau_min=TAU_MIN, cross=cross, window=8, shift=shift)
    try:
        jpe.set_interpret(True)
        want = np.asarray(jpe._grid_forward(*jargs, *jparams, **kw),
                          np.float32)
    finally:
        jpe.set_interpret(False)
    ref = np.asarray(jpe.reference_encoder_layer_grid(*jargs, *jparams, **kw),
                     np.float32)
    got = reference_encoder_layer_grid(
        _t(x).bfloat16(), _t(kv).bfloat16() if cross else None, _t(occ),
        _t(kocc) if cross else None, _t(pos).bfloat16(),
        LayerParams(*_port_weights(p)), H, TAU_MIN, cross, 8,
        shift).float().numpy()
    assert got.shape == x.shape
    for other, tol_max, tol_mean in ((want, 0.06, 2e-3), (ref, 0.1, 4e-3)):
        err = np.abs(got - other)
        assert err.max() <= tol_max and err.mean() <= tol_mean, (
            err.max(), err.mean())
    assert not got[~occ].any() and not want[~occ].any()
    assert np.abs(got[occ]).mean() > 0.3


def _function_grads(x, kv, occ, kocc, pos, p, g, cross, shift):
    """The K10 autograd Function on CPU tensors: output and (dx, dkv, 17
    weight gradients)."""
    ws = [w.requires_grad_() for w in _port_weights(p)]
    xt = _t(x).bfloat16().requires_grad_()
    kt = _t(kv).bfloat16().requires_grad_() if cross else None
    out = fused_encoder_layer_grid(
        xt, kt, _t(occ), _t(kocc) if cross else None, _t(pos).bfloat16(), ws,
        kernel_params(ws), nhead=H, tau_min=TAU_MIN, cross=cross, window=8,
        shift=shift)
    out.backward(_t(g).bfloat16())
    return out, xt.grad, (kt.grad if cross else None), [w.grad for w in ws]


@pytest.mark.parametrize('case', [(False, True), (True, False)], ids=_gid)
def test_grid_layer_function_grads_match_jax_vjp(case):
    """The K10 Function's backward (the window views, the plain K7 on the
    windows with an occupied query cell, the inverse views) against
    ``jax.vjp`` of ``fused_encoder_layer_grid`` with the Pallas kernels in
    interpret mode (``_grid_bwd`` → ``_pallas_backward`` on every window):
    dx, dkv and the 17 parameter gradients. The Pallas backward rounds every
    matmul operand to bf16, the plain one keeps f32 gradients, so each
    output is held to 3e-2 of its scale in the max and 3e-3 in the mean;
    dtau, one sum over every window and head, to 5e-2 of its value. In self
    mode the key path folds into dx and JAX's dkv is 0."""
    cross, shift = case
    x, kv, occ, kocc, pos, p, g = _grid_case(60 + int(cross), cross)
    jargs, jparams = _jax_args(x, kv, occ, kocc, pos, p)
    try:
        jpe.set_interpret(True)
        fn = lambda a, b, *ws: jpe.fused_encoder_layer_grid(
            a, b, jargs[2], jargs[3], jargs[4], *ws, H, TAU_MIN, cross, 8,
            shift)
        jout, vjp = jax.vjp(fn, jargs[0], jargs[1], *jparams)
        want = [np.asarray(a, np.float32)
                for a in vjp(jnp.asarray(g, jnp.bfloat16))]
    finally:
        jpe.set_interpret(False)
    out, dx, dkv, grads = _function_grads(x, kv, occ, kocc, pos, p, g, cross,
                                          shift)
    err = np.abs(out.detach().float().numpy() - np.asarray(jout, np.float32))
    assert err.max() <= 0.06 and err.mean() <= 2e-3

    def close(name, got, ref):
        scale = max(np.abs(ref).max(), 1e-6)
        e = np.abs(got - ref)
        assert e.max() <= 3e-2 * scale and e.mean() <= 3e-3 * scale, (
            name, e.max() / scale, e.mean() / scale)

    close('dx', dx.float().numpy(), want[0])
    if cross:
        close('dkv', dkv.float().numpy(), want[1])
    else:
        assert not want[1].any()
    for name, got, ref in zip(FIELDS, grads, want[2:]):
        got = got.numpy()
        if name in MATRICES:
            got = got.T
        ref = ref.reshape(got.shape)
        if name == 'tau':
            assert abs(got[0] - ref[0]) <= 5e-2 * abs(ref[0]), (got, ref)
        else:
            close(name, got, ref)


def test_grid_backward_on_occupied_windows_equals_all_windows():
    """The Function's backward takes only the windows with an occupied
    query cell; autograd through the plain grid layer takes every window.
    The other windows' outputs are zero whatever their inputs, so the
    gradients are the same sums with zero terms left out: the weight
    gradients equal to f32 rounding (1e-5 of their scale); dx and dkv come
    back in the grid's dtype (bf16), as JAX's ``_grid_bwd`` returns them,
    so they are held to one bf16 step (2^-8) of their scale. The case has
    windows of both kinds."""
    cross, shift = True, True
    x, kv, occ, kocc, pos, p, g = _grid_case(70, cross)
    _, dx, dkv, grads = _function_grads(x, kv, occ, kocc, pos, p, g, cross,
                                        shift)
    ws = [w.requires_grad_() for w in _port_weights(p)]
    xt = _t(x).float().requires_grad_()
    kt = _t(kv).float().requires_grad_()
    ref = reference_encoder_layer_grid(xt, kt, _t(occ), _t(kocc),
                                       _t(pos).bfloat16(), LayerParams(*ws),
                                       H, TAU_MIN, cross, 8, shift)
    ref.backward(_t(g))
    wv = torch.nn.functional.pad(_t(occ), (4, 8, 4, 8))  # shift-1 windows
    per_window = wv.reshape(2, 4, 8, 4, 8).any(4).any(2)
    assert not per_window.all() and per_window.any()
    for name, got, want in [('dx', dx, xt.grad), ('dkv', dkv, kt.grad)] + \
            list(zip(FIELDS, grads, [w.grad for w in ws])):
        got, want = got.float(), want.float()
        scale = max(want.abs().max().item(), 1e-6)
        tol = 2.0 ** -8 if name in ('dx', 'dkv') else 1e-5
        assert (got - want).abs().max().item() <= tol * scale, name


def _points(rng, B, P, n_real):
    """Points inside and outside the tiny range, padded slots masked."""
    pts = np.zeros((B, P, 4), np.float32)
    mask = np.zeros((B, P), bool)
    for b in range(B):
        xy = rng.uniform(-5.6, 5.6, (n_real, 2))       # some out of range
        z = rng.uniform(-5.5, 3.5, (n_real, 1))        # some out of range
        pts[b, :n_real] = np.concatenate(
            [xy, z, rng.uniform(0, 1, (n_real, 1))], -1)
        mask[b, :n_real] = True
        pts[b, n_real:n_real + 5, :2] = 1.0            # masked padding
    return pts, mask


@pytest.mark.parametrize('max_voxels', [1024, 40])
def test_device_voxelize_bit_equal_to_jax_and_host(max_voxels):
    """The port's device ``voxelize`` against the JAX package's
    ``voxelize`` and the port's ``voxelize_host``, on a 32x32 grid with
    points out of range and masked: every output equal, bit for bit. With
    MAX_VOXELS 40 the occupied cells overflow the slots, and the points of
    the cells past the cap become invalid on every side."""
    rng = np.random.RandomState(9)
    spec_j = jvox.VoxelSpec((-5.12, -5.12, -5.0, 5.12, 5.12, 3.0),
                            (0.32, 0.32, 8.0), 512, max_voxels)
    spec_t = tvox.VoxelSpec(spec_j.pc_range, spec_j.voxel_size, 512,
                            max_voxels)
    pts, mask = _points(rng, 2, 512, 300)
    want = jax.device_get(jvox.voxelize(jnp.asarray(pts), jnp.asarray(mask),
                                        spec_j))
    host = tvox.voxelize_host(pts, mask, spec_t)
    got = tvox.voxelize(_t(pts), _t(mask), spec_t)
    for k in ('voxel_coords', 'voxel_mask', 'point_voxel', 'point_valid',
              'num_voxels'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), host[k], err_msg=k)
    assert (host['num_voxels'] == max_voxels).all() == (max_voxels == 40)
    assert not host['point_valid'][mask].all()


def test_scatter_segment_max_grad_splits_ties_as_jax():
    """The scatter-path ``segment_max`` (the VFE without host sorting)
    against ``jax.vjp`` of the JAX package's ``segment_max``: a two-way and
    a three-way tie, a tie at 0 (ReLU outputs), ``-inf`` rows (invalid
    points) and rows of the dropped segment. Values are equal; the gradient
    splits g evenly among tied rows on both sides (f32 rounding, 1e-6)."""
    rng = np.random.RandomState(3)
    B, P, V, Cs = 2, 64, 10, 4
    seg = rng.randint(0, V + 1, (B, P)).astype(np.int32)
    feat = np.round(rng.normal(0, 1, (B, P, Cs)), 1).astype(np.float32)
    rows = [np.flatnonzero(seg[0] == v) for v in range(V)]
    two, three = rows[1][:2], rows[2][:3]
    feat[0, two] = 5.0
    feat[0, three] = 6.0
    feat[1, seg[1] == 4] = 0.0
    feat[1, rng.rand(P) < 0.2] = -np.inf
    g = rng.normal(0, 1, (B, V, Cs)).astype(np.float32)
    out, vjp = jax.vjp(lambda a: jvox.segment_max(a, jnp.asarray(seg), V),
                       jnp.asarray(feat))
    (want,) = vjp(jnp.asarray(g))
    x = _t(feat).requires_grad_()
    got = tvox.segment_max(x, _t(seg), V)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(_t(g))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(x.grad[0, three].numpy(),
                               np.broadcast_to(g[0, 2] / 3, (3, Cs)),
                               atol=1e-6, rtol=0)


def test_gather_gt_points_equal_to_jax():
    """MAE targets (the first K points of each voxel in point order,
    wrap-repeated to K) against the JAX function, exactly: voxels with more
    than K points, with fewer, with one, and with none; invalid points are
    never taken."""
    rng = np.random.RandomState(4)
    B, P, V, K = 2, 200, 12, 8
    pv = rng.randint(0, V - 2, (B, P)).astype(np.int32)
    pv[0, :20] = 3            # more than K points
    pv[0, pv[0] == 5] = 6     # voxel 5 empty
    pv[1, pv[1] == 7] = 0
    pv[1, 50] = 7             # one point
    valid = rng.rand(B, P) < 0.9
    pv = np.where(valid, pv, V)
    xyz = rng.normal(0, 1, (B, P, 3)).astype(np.float32)
    want = np.asarray(jsw.gather_gt_points(jnp.asarray(xyz), jnp.asarray(pv),
                                           jnp.asarray(valid), V, K))
    got = tsw.gather_gt_points(_t(xyz), _t(pv), _t(valid), V, K).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[0, 5].any() and not got[0, V - 1].any()
    np.testing.assert_array_equal(got[1, 7], np.repeat(xyz[1, 50:51], K, 0))


def test_chamfer_distance_matches_jax():
    """Weighted bidirectional Chamfer distance against the JAX function on
    the MAE's cloud sizes (16 predicted, 64 target points), with zero
    weights among the clouds, unweighted, and with every weight zero (the
    1e-6 floor): within 1e-5 relative (f32 sums in another order)."""
    rng = np.random.RandomState(5)
    pred = rng.normal(0, 1, (50, 16, 3)).astype(np.float32)
    gt = rng.normal(0, 1, (50, 64, 3)).astype(np.float32)
    w = (rng.rand(50) < 0.3).astype(np.float32)
    for weights in (w, None, np.zeros(50, np.float32)):
        want = float(jch.chamfer_distance(
            jnp.asarray(pred), jnp.asarray(gt),
            weights=None if weights is None else jnp.asarray(weights)))
        got = float(chamfer_distance(
            _t(pred), _t(gt), None if weights is None else _t(weights)))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_random_voxel_mask_keeps_len_keep_valid_voxels():
    """The port's mask: per sample exactly int(num_valid * 0.25) valid
    voxels kept and the other valid ones masked, invalid voxels never
    masked; the same generator seed gives the same mask, another seed
    another; and the JAX mask on the same voxel set obeys the same counts
    (its noise differs, so its choice does)."""
    rng = np.random.RandomState(6)
    vmask = rng.rand(3, 200) < np.array([[0.9], [0.3], [0.0]])
    vmask[1, :7] = True
    num = vmask.sum(1)
    masks = [tsw.random_voxel_mask(_t(vmask), _t(num), 0.75,
                                   torch.Generator().manual_seed(s))
             for s in (1, 1, 2)]
    for m in masks:
        m = m.numpy()
        assert set(np.unique(m)) <= {0.0, 1.0}
        assert not m[~vmask].any()
        kept = (vmask & (m == 0)).sum(1)
        np.testing.assert_array_equal(kept, (num * 0.25).astype(int))
    assert torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[0], masks[2])
    jm = np.asarray(jsw.random_voxel_mask(jax.random.PRNGKey(0),
                                          jnp.asarray(vmask),
                                          jnp.asarray(num), 0.75))
    np.testing.assert_array_equal((vmask & (jm == 0)).sum(1),
                                  (num * 0.25).astype(int))
