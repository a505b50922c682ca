"""The windowed SubM conv (K15), the attention-only window layer (K16) and
the unpadded window API (K13b / K13c, served by K2) of the PyTorch port
(tmae_tpu_torch) against the JAX package on the CPU. The same seeded numpy
inputs go through both sides; the JAX side runs its Pallas kernels in
interpret mode (``_gather_pallas``, ``_scatter_pallas``,
``_scatter_into_pallas``, ``_subm_conv_pallas``, ``pallas_attn._kernel``)
and its jnp references. Tolerances are stated beside each comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_kernels import _bf16_np, _t
from tests.test_torch_port_model import random_variables
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.models.layers import SubMConvBlock as JSubMConvBlock
from tmae_tpu.models.sst import DenseGrid as JDenseGrid
from tmae_tpu.models.sst import DenseWindowAttention as JDenseWindowAttention
from tmae_tpu.ops import occ_compact as joc
from tmae_tpu.ops import pallas_attn as jpa
from tmae_tpu.ops import sparse_conv as jsc
from tmae_tpu.ops.dense_windows import slot_pos_embed as j_slot_pos_embed
from tmae_tpu_torch.models.layers import SubMConvBlock
from tmae_tpu_torch.models.sst import DenseGrid, DenseWindowAttention
from tmae_tpu_torch.ops import occ_compact as toc
from tmae_tpu_torch.ops import sparse_conv as tsc
from tmae_tpu_torch.ops import window_attention as twa
from tmae_tpu_torch.utils.from_jax import params_from_jax

B, H, W = 2, 20, 24
CAP = 16   # the 20x24 partitions have 16 windows; fewer are occupied


@pytest.fixture
def interpret():
    """The JAX package's Pallas kernels in interpret mode, reset after."""
    for m in (joc, jsc, jpa):
        m.set_interpret(True)
    yield
    for m in (joc, jsc, jpa):
        m.set_interpret(False)


def _occ(rng):
    """A dense block, a sparse region and a few lone cells: 6-10 of the 16
    windows of either shift occupied, so each plan of cap 16 holds dummy
    slots."""
    occ = np.zeros((B, H, W), bool)
    occ[:, 2:9, 3:12] = rng.rand(B, 7, 9) < 0.6
    occ[:, 10:20, 14:24] = rng.rand(B, 10, 10) < 0.15
    occ[0, 17, 2] = occ[1, 1, 22] = True
    return occ


def _plans(occ, shift, cap=CAP, kocc=None):
    jp = joc.build_compact_info(
        jnp.asarray(occ), 8, shift, cap, (H, W),
        kv_occ=None if kocc is None else jnp.asarray(kocc))
    tp = toc.build_compact_info(
        _t(occ), 8, shift, cap, (H, W),
        kv_occ=None if kocc is None else _t(kocc))
    return jp, tp


def _bf16(rng, *shape, scale=1.0):
    return _bf16_np(scale * rng.normal(size=shape).astype(np.float32))


def _tb(a):
    return _t(a).to(torch.bfloat16)


def _f(a):
    return np.asarray(a, np.float32) if not torch.is_tensor(a) else \
        a.detach().float().numpy()


# ---------------------------------------------------------------------------
# (b) the plan: build_compact_info and gather_window_occ
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('shift', [False, True])
@pytest.mark.parametrize('cap', [CAP, 4])
def test_build_compact_info_matches_jax(shift, cap):
    """Bit-equal plans (window coordinates, slot validity, query and key
    masks, occupied count) with dummy slots (cap 16) and with occupied
    windows beyond the cap (cap 4: the overflow)."""
    rng = np.random.RandomState(1 + int(shift))
    occ, kocc = _occ(rng), _occ(rng)
    jp, tp = _plans(occ, shift, cap, kocc)
    np.testing.assert_array_equal(tp.idx.numpy(), np.asarray(jp.idx))
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    np.testing.assert_array_equal(tp.qmask.numpy(), np.asarray(jp.qmask))
    np.testing.assert_array_equal(tp.kmask.numpy(), np.asarray(jp.kmask))
    np.testing.assert_array_equal(tp.n_occupied.numpy(),
                                  np.asarray(jp.n_occupied))
    np.testing.assert_array_equal(tp.overflow().numpy(),
                                  np.asarray(jp.overflow()))
    if cap == CAP:
        assert not tp.valid.all() and tp.valid.any()
    else:
        assert (tp.overflow() > 0).all()
    got = toc.gather_window_occ(_t(kocc), tp.idx, (H, W), 8, shift)
    want = joc.gather_window_occ(jnp.asarray(kocc), jp.idx, (H, W), 8, shift)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# (a) the unpadded window API: K1, K13b and K13c (K2) against JAX's K13a,
# K13b and K13c in interpret mode and its references, forward and VJP
# ---------------------------------------------------------------------------


def _plan_window_cells(idx, valid, shift):
    """[B, H, W] bool: grid cells inside the plan's real windows."""
    off = 4 if shift else 8
    m = np.zeros((B, 8 * 6, 8 * 6), bool)
    for b, s in zip(*np.nonzero(valid)):
        wy, wx = idx[b, s]
        m[b, 8 * wy:8 * wy + 8, 8 * wx:8 * wx + 8] = True
    return m[:, off:off + H, off:off + W]


@pytest.mark.parametrize('shift', [False, True])
@pytest.mark.parametrize('op', ['gather', 'scatter', 'scatter_zero_fill',
                                'scatter_into'])
def test_window_api_matches_jax(interpret, op, shift):
    """Forward and VJP of the unpadded gather, scatter and scatter-into on a
    plan with dummy slots, bit-equal to the JAX package's interpret-mode
    kernels (K13a gather, K13b scatter, K13c scatter-into; the VJPs run the
    same kernels) and to its references (``_gather_ref``, ``_scatter_ref``,
    ``_scatter_into_ref``): every value is a copy. Without ``zero_fill``
    the JAX scatter leaves unvisited windows undefined, so those cells are
    compared with the reference's zeros, which the port gives."""
    rng = np.random.RandomState(10 + 2 * ['gather', 'scatter',
                                          'scatter_zero_fill',
                                          'scatter_into'].index(op)
                                + int(shift))
    C = 16
    occ = _occ(rng)
    jp, tp = _plans(occ, shift)
    jidx, tidx = jp.idx, tp.idx
    geo = ((H, W), 8, shift)
    x = _bf16(rng, B, H, W, C)
    xw = _bf16(rng, B, CAP, 64, C)
    init = _bf16(rng, B, H, W, C)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    if op == 'gather':
        args, targs = (jb(x),), (_tb(x),)
        jfn = lambda a: joc.gather_windows(a, jidx, *geo)
        ref = joc._gather_ref(jb(x), jidx, *geo)
        tfn = lambda a: toc.gather_windows(a, tidx, *geo)
        g = _bf16(rng, B, CAP, 64, C)
    elif op == 'scatter_into':
        args, targs = (jb(xw), jb(init)), (_tb(xw), _tb(init))
        jfn = lambda a, i: joc.scatter_windows_into(a, jidx, i, *geo)
        ref = joc._scatter_into_ref(jb(xw), jidx, jb(init), *geo)
        tfn = lambda a, i: toc.scatter_windows_into(a, tidx, i, *geo)
        g = _bf16(rng, B, H, W, C)
    else:
        zf = op == 'scatter_zero_fill'
        args, targs = (jb(xw),), (_tb(xw),)
        jfn = lambda a: joc.scatter_windows(a, jidx, *geo, zero_fill=zf)
        ref = joc._scatter_ref(jb(xw), jidx, *geo)
        tfn = lambda a: toc.scatter_windows(a, tidx, *geo, zero_fill=zf)
        g = _bf16(rng, B, H, W, C)
    want, vjp = jax.vjp(jfn, *args)
    wgrads = vjp(jb(g))
    targs = [a.requires_grad_() for a in targs]
    got = tfn(*targs)
    got.backward(_tb(g))
    got, want, ref = _f(got), _f(want), _f(ref)
    np.testing.assert_array_equal(got, ref)
    if op == 'scatter':
        inside = _plan_window_cells(np.asarray(jidx), np.asarray(jp.valid),
                                    shift)
        assert inside.any() and not inside.all()
        np.testing.assert_array_equal(got[inside], want[inside])
        assert not got[~inside].any()
    else:
        np.testing.assert_array_equal(got, want)
    for t, w in zip(targs, wgrads):
        np.testing.assert_array_equal(_f(t.grad), _f(w))


# ---------------------------------------------------------------------------
# (c) subm_conv3x3: K15 and the zero-fill scatter, forward and VJP
# ---------------------------------------------------------------------------


def _conv_inputs(rng, cin, cout):
    occ = _occ(rng)
    x = np.where(occ[..., None], _bf16(rng, B, H, W, cin), 0.0)
    wmat = _bf16_np(rng.normal(size=(3, 3, cin, cout)).astype(np.float32)
                    / np.sqrt(9 * cin))
    bias = (0.1 * rng.normal(size=cout)).astype(np.float32)
    return occ, x.astype(np.float32), wmat, bias


def test_subm_conv3x3_matches_jax(interpret):
    """The port's subm_conv3x3 (plain windows + plain scatter) and its
    dense plain version against the JAX package's K15 in interpret mode and
    ``_subm_conv_ref``, Cin=16, Cout=32, bf16 inputs, on an unshifted plan
    with dummy slots. Forward: every side sums the same 9*Cin f32 products
    in its own order and rounds once to bf16, so values agree to one bf16
    rounding step (rtol 2^-7, atol 1e-3). Gradients (dx, dw, db) against
    ``jax.vjp`` of subm_conv3x3, whose backward is dense f32 convs: dx and
    dw are rounded to bf16 (same bound), db is f32 (rtol 1e-5)."""
    rng = np.random.RandomState(3)
    occ, x, wmat, bias = _conv_inputs(rng, 16, 32)
    jp, tp = _plans(occ, False)
    assert not tp.valid.all()
    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(wmat, jnp.bfloat16),
             jnp.asarray(bias))
    jfn = lambda a, w_, b_: jsc.subm_conv3x3(a, jp.idx, jp.qmask, w_, b_,
                                             (H, W), 8)
    want, vjp = jax.vjp(jfn, *jargs)
    ref = jsc._subm_conv_ref(*jargs[:1], jp.idx, jp.qmask, *jargs[1:],
                             (H, W), 8)
    g = _bf16(rng, B, H, W, 32)
    jdx, jdw, jdb = vjp(jnp.asarray(g, jnp.bfloat16))

    tx, tw, tbias = _tb(x).requires_grad_(), _tb(wmat).requires_grad_(), \
        _t(bias).requires_grad_()
    got = tsc.subm_conv3x3(tx, tp.idx, tp.qmask, tw, tbias, (H, W), 8)
    got.backward(_tb(g))
    plain = tsc.subm_conv3x3_plain(_tb(x), tp.idx, tp.qmask, _tb(wmat),
                                   _t(bias), (H, W), 8)
    tol = dict(rtol=2 ** -7, atol=1e-3)
    for a in (got, plain):
        for b in (want, ref):
            np.testing.assert_allclose(_f(a), _f(b), **tol)
    assert _f(got).any() and not _f(got)[~occ].any()
    np.testing.assert_allclose(_f(tx.grad), _f(jdx), **tol)
    np.testing.assert_allclose(_f(tw.grad), _f(jdw), **tol)
    np.testing.assert_allclose(_f(tbias.grad), _f(jdb), rtol=1e-5, atol=1e-5)
    assert tx.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.bfloat16

    # the compact kernel output alone against JAX's K15 kernel
    jw = jsc._subm_conv_pallas(*jargs[:1], jp.idx, jp.qmask, *jargs[1:],
                               (H, W), 8)
    tw_ = tsc.subm_conv_windows(_tb(x), tp.idx, tp.qmask, _tb(wmat),
                                _t(bias), 8)
    np.testing.assert_allclose(_f(tw_), _f(jw), **tol)


# ---------------------------------------------------------------------------
# (d) SubMConvBlock with a plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('train', [False, True])
def test_subm_conv_block_plan_matches_jax(interpret, train):
    """SubMConvBlock(plan) against the JAX package's (K15 in interpret
    mode) after a strict ``params_from_jax`` load, eval and train mode
    (batch statistics; the running statistics it updates compared too),
    Cin=Cout=32: bf16 outputs within one bf16 rounding step of the
    pre-BN value, amplified by the batch norm's scale (atol 3e-2, mean
    below 2e-3). Then, on the port alone, a plan that covers every
    occupied window gives the plan-less block's output within the same
    bound (the dense path rounds its bf16 conv once, as the plan does) and
    the same gradients of the input and the weight (train mode)."""
    rng = np.random.RandomState(5 + int(train))
    C = 32
    occ, x, _, _ = _conv_inputs(rng, C, C)
    jp, tp = _plans(occ, False)
    jx = jnp.asarray(x, jnp.bfloat16)
    jocc = jnp.asarray(occ)
    jblock = JSubMConvBlock(C)
    jplan = (jp.idx, jp.qmask, 8)
    shapes = jax.eval_shape(lambda a: jblock.init(jax.random.PRNGKey(0), a,
                                                  jocc, False, jplan), jx)
    v = random_variables(shapes, 7)
    if train:
        want, upd = jblock.apply(v, jx, jocc, True, jplan,
                                 mutable=['batch_stats'])
    else:
        want = jblock.apply(v, jx, jocc, False, jplan)
    tblock = SubMConvBlock(C, C).train(train)
    tblock.load_state_dict(params_from_jax(v), strict=True)
    tplan = (tp.idx, tp.qmask, 8)
    tx = _tb(x)
    with torch.no_grad():
        got = tblock(tx, _t(occ), tplan)
    err = np.abs(_f(got) - _f(want))
    assert err.max() <= 3e-2 and err.mean() <= 2e-3, (err.max(), err.mean())
    if train:
        bs = upd['batch_stats']['MaskedBatchNorm_0']
        np.testing.assert_allclose(tblock.bn.running_mean.numpy(),
                                   _f(bs['mean']), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tblock.bn.running_var.numpy(),
                                   _f(bs['var']), rtol=1e-4, atol=1e-5)

    # a plan covering every occupied window is the plan-less block
    tblock.load_state_dict(params_from_jax(v), strict=True)
    outs, grads = [], []
    for plan in (tplan, None):
        a = tx.clone().requires_grad_()
        tblock.zero_grad()
        out = tblock(a, _t(occ), plan)
        out.float().square().sum().backward()
        outs.append(_f(out))
        grads.append((_f(a.grad), tblock.conv.weight.grad.numpy().copy()))
    err = np.abs(outs[0] - outs[1])
    assert err.max() <= 3e-2 and err.mean() <= 2e-3, (err.max(), err.mean())
    for a, b in zip(*grads):
        scale = np.abs(b).max()
        d = np.abs(a - b)
        assert d.max() <= 5e-2 * scale and d.mean() <= 5e-3 * scale, \
            (d.max(), d.mean(), scale)


# ---------------------------------------------------------------------------
# (e) the attention-only window layer: K16's plain version
# ---------------------------------------------------------------------------


def _attn_inputs(rng, N, C):
    xw = _bf16(rng, N, 64, C)
    kvw = _bf16(rng, N, 64, C)
    kmask = (rng.rand(N, 64) < rng.uniform(0.1, 0.8, (N, 1))).astype(
        np.float32)
    kmask[2] = 0.0                  # a window with no key
    pos = _bf16_np(np.asarray(j_slot_pos_embed(8, C)))

    def lin():
        return (rng.normal(size=(C, C)) / np.sqrt(C)).astype(np.float32)

    def vec():
        return (0.1 * rng.normal(size=C)).astype(np.float32)

    weights = [lin(), vec(), lin(), vec(), lin(), vec(), lin(), vec(),
               np.asarray([0.7], np.float32)]
    return xw, kvw, kmask, pos, weights


@pytest.mark.parametrize('cross', [False, True])
def test_window_attention_matches_jax(interpret, cross):
    """The port's fused_window_attention on the CPU (its plain version,
    ``reference_forward``) against the JAX package's ``_reference_forward``
    and its K16 (``_pallas_forward``) in interpret mode, C=128 with 8
    heads, 6 windows of which one has no key (its output is bo on every
    token). Against the reference: the same f32 math, bf16 output, equal
    to one bf16 rounding step (rtol 2^-7, atol 2e-3). Against the kernel,
    which runs its projections with bf16 weights and rounds the attention
    output to bf16 before Wo: max |diff| 0.06, mean 5e-3. Gradients of
    every input (windows, pos, weights, biases, tau) against ``jax.vjp`` of
    ``fused_window_attention`` (whose backward is the reference's VJP),
    each on its tensor's scale: f32 gradients within 1e-3; the windows'
    bf16 gradients within one bf16 rounding step (rtol 2^-7, atol 2e-3);
    pos's bf16 gradient, a sum over the windows of bf16 contributions (two
    paths in cross mode, each rounded before the add, in another order in
    each framework), within a few bf16 steps (max 3e-2, mean 1e-3)."""
    rng = np.random.RandomState(20 + int(cross))
    N, C, nh = 6, 128, 8
    xw, kvw, kmask, pos, weights = _attn_inputs(rng, N, C)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    jargs = [jb(xw), jb(kvw), jnp.asarray(kmask), jb(pos)] + \
        [jnp.asarray(w) for w in weights]
    cfg = (nh, 0.01, cross)
    g = _bf16(rng, N, 64, C)
    want, vjp = jax.vjp(lambda *a: jpa.fused_window_attention(*a, *cfg),
                        *jargs)
    jgrads = vjp(jb(g))
    ref = jpa._reference_forward(*jargs, *cfg)

    targs = [_tb(xw), _tb(kvw), _t(kmask), _tb(pos)] + [_t(w) for w in
                                                        weights]
    diff = [0, 1, 3] + list(range(4, 13))
    for i in diff:
        targs[i].requires_grad_()
    got = twa.fused_window_attention(*targs, *cfg)
    got.backward(_tb(g))

    np.testing.assert_allclose(_f(got), _f(ref), rtol=2 ** -7, atol=2e-3)
    d = np.abs(_f(got) - _f(want))
    assert d.max() <= 0.06 and d.mean() <= 5e-3, (d.max(), d.mean())
    bo = _bf16_np(weights[7])
    np.testing.assert_array_equal(_f(got)[2], np.broadcast_to(bo, (64, C)))
    for i in diff:
        if i == 1 and not cross:
            assert targs[1].grad is None or not targs[1].grad.any()
            continue
        a, b = _f(targs[i].grad), _f(jgrads[i])
        scale = max(np.abs(b).max(), 1e-6)
        if i == 3:
            d = np.abs(a - b) / scale
            assert d.max() <= 3e-2 and d.mean() <= 1e-3, (d.max(), d.mean())
            continue
        bf = targs[i].dtype == torch.bfloat16
        np.testing.assert_allclose(a / scale, b / scale,
                                   rtol=2 ** -7 if bf else 0,
                                   atol=2e-3 if bf else 1e-3,
                                   err_msg=f'gradient of input {i}')


# ---------------------------------------------------------------------------
# (f) DenseWindowAttention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('shift', [False, True])
@pytest.mark.parametrize('cross', [False, True])
def test_dense_window_attention_matches_jax(shift, cross):
    """DenseWindowAttention against the JAX package's module (its jnp path,
    as it runs on the CPU) after a strict ``params_from_jax`` load, C=32
    with 2 heads on a 20x24 grid, self and cross (keys from the other
    frame, with windows empty there), both shifts: f32 outputs of the same
    math rounded once to bf16 (rtol 2^-7, atol 2e-3), zero at unoccupied
    query cells."""
    rng = np.random.RandomState(30 + 2 * int(shift) + int(cross))
    C = 32
    occ, kocc = _occ(rng), _occ(rng)
    x = np.where(occ[..., None], rng.normal(size=(B, H, W, C)), 0).astype(
        np.float32)
    kx = np.where(kocc[..., None], rng.normal(size=(B, H, W, C)),
                  0).astype(np.float32)
    jgrid = JDenseGrid(x=jnp.asarray(x), occ=jnp.asarray(occ))
    jkv = JDenseGrid(x=jnp.asarray(kx), occ=jnp.asarray(kocc)) if cross \
        else None
    jmod = JDenseWindowAttention(d_model=C, nhead=2, window=8, shift=shift)
    shapes = jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), jgrid, jkv))
    v = random_variables(shapes, 40)
    want = jmod.apply(v, jgrid, jkv)
    tmod = DenseWindowAttention(C, 2, 8, shift, cross=cross)
    tmod.load_state_dict(params_from_jax(v), strict=True)
    tkv = DenseGrid(_t(kx), _t(kocc)) if cross else None
    with torch.no_grad():
        got = tmod(DenseGrid(_t(x), _t(occ)), tkv)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_f(got), _f(want), rtol=2 ** -7, atol=2e-3)
    assert not _f(got)[~occ].any() and _f(got)[occ].any()


def test_window_attention_refuses_mixed_placement():
    """The K16 wrapper checks the placement of every tensor it is given:
    windows on one device and a weight on another raise, where a launch
    would read a host pointer."""
    rng = np.random.RandomState(50)
    xw, kvw, kmask, pos, weights = _attn_inputs(rng, 3, 32)
    args = [_tb(xw), _tb(kvw), _t(kmask), _tb(pos)] + [_t(w) for w in weights]
    meta = lambda t: torch.empty_like(t, device='meta')
    for i in (0, 3, 10, 12):
        moved = list(args)
        moved[i] = meta(moved[i])
        with pytest.raises(ValueError, match='mixed'):
            twa.window_attention_fwd(*moved, 2, 0.01, False)
    moved = list(args)
    moved[1] = meta(moved[1])
    with pytest.raises(ValueError, match='mixed'):
        twa.window_attention_fwd(*moved, 2, 0.01, True)
