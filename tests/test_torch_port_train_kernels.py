"""Training kernels of the PyTorch port against the JAX package on the CPU:
the plain versions of K6/K8 (training forward of the encoder layer) and
K7/K9 (its fused backward) against the JAX Pallas kernels in interpret mode,
the autograd Functions around K1/K2 against ``jax.vjp`` of the JAX window
gather and scatter, and the K5 Function's gradient against ``_ssm_bwd``.
Inputs are made from a seed with numpy; tolerances are stated beside each
comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.ops import occ_compact as joc
from tmae_tpu.ops import pallas_encoder as jpe
from tmae_tpu.ops import sorted_segments as jss
from tmae_tpu.ops.dense_windows import slot_pos_embed as j_slot_pos_embed
from tmae_tpu_torch.ops import occ_compact as toc
from tmae_tpu_torch.ops.encoder_layer import (LayerParams, fused_encoder_layer,
                                              kernel_params,
                                              reference_encoder_layer,
                                              reference_encoder_layer_bwd)
from tmae_tpu_torch.ops.sorted_segments import sorted_segment_max_train

C, F, H = 128, 256, 8
FIELDS = LayerParams._fields
MATRICES = ('wq', 'wk', 'wv', 'wo', 'f1w', 'f2w')


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_np(a):
    return torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _case(seed, N, S, cross, tau):
    """Windows with zeros at unoccupied cells, every fifth window with no
    occupied query cell and (cross) every fourth with no key, occupied-first
    cell selections, and a layer whose tau is ``tau``. Weights are in the
    JAX layout ``[in, out]``."""
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

    def lin(i, o):
        return (rng.normal(0, 1, (i, o)) / np.sqrt(i)).astype(np.float32)

    def vec(n, s=0.1, m=0.0):
        return (m + s * rng.normal(size=(n,))).astype(np.float32)

    p = dict(wq=lin(C, C), bq=vec(C), wk=lin(C, C), bk=vec(C), wv=lin(C, C),
             bv=vec(C), wo=lin(C, C), bo=vec(C),
             tau=np.asarray([tau], np.float32), ln1s=vec(C, m=1.0),
             ln1b=vec(C), f1w=lin(C, F), f1b=vec(F), f2w=lin(F, C),
             f2b=vec(C), ln2s=vec(C, m=1.0), ln2b=vec(C))
    for k in MATRICES:  # the kernels take bf16 matrices on both sides
        p[k] = _bf16_np(p[k])
    sel = None
    if S is not None:
        def select(o):
            key = o * (64 - np.arange(64))
            s = np.argsort(-key, axis=-1, kind='stable')[..., :S]
            return s.astype(np.int32), np.take_along_axis(o, s, -1)

        sq, qm = select(occ)
        sk, km = select(kocc)
        sel = (sq, sk)
    else:
        qm, km = occ, kocc
    pos = _bf16_np(np.asarray(j_slot_pos_embed(8, C)))
    return xw, kv, sel, qm.astype(np.float32), km.astype(np.float32), pos, \
        p, g


def _port_weights(p):
    """JAX layout → the port's: Linear matrices [out, in], f32."""
    return [_t(p[k].T.copy()) if k in MATRICES else _t(p[k]) for k in FIELDS]


# (N, S, cross, tau): S None is the full-window pair K6/K7, S 16 / 48 the
# selected-cell pair K8/K9; tau below TAU_MIN clamps the scale and zeroes
# dtau. TAU_MIN is 0.05 here, not t_mae.yaml's 0.01: the JAX packed (S)
# kernels shift every head's logits by one row max over all heads, which is
# per-head softmax only while no head lies ~87 below that max, and at a
# scale of 1 / 0.01 logits span +-100. The port's kernels take the max per
# head.
TAU_MIN = 0.05
CASES = [
    (16, None, False, 0.7), (32, None, True, 0.03), (32, 16, False, 0.03),
    (16, 16, True, 0.7), (16, 48, False, 0.7), (32, 48, True, 0.03),
]


def _ids(case):
    N, S, cross, tau = case
    return f'N{N}-S{S or 64}-{"cross" if cross else "self"}-tau{tau}'


def _jax_inputs(xw, kv, qm, km, pos, p):
    return (jnp.asarray(xw, jnp.bfloat16), jnp.asarray(kv, jnp.bfloat16),
            jnp.asarray(qm), jnp.asarray(km), jnp.asarray(pos, jnp.bfloat16),
            [jnp.asarray(p[k]) for k in FIELDS])


@pytest.mark.parametrize('case', CASES, ids=_ids)
def test_training_forward_plain_matches_pallas_interpret(case):
    """Plain K6 / K8 vs ``_pallas_forward`` / ``_pallas_forward_sel`` in
    interpret mode. Both take bf16 matmul operands with f32 accumulation and
    return bf16; a summation order can flip one bf16 rounding of an
    intermediate, so the bound is 0.06 absolute on LayerNorm-scale values
    and 2e-3 in the mean. K8's unselected cells pass through exactly."""
    N, S, cross, tau = case
    xw, kv, sel, qm, km, pos, p, _ = _case(N + (S or 0), N, S, cross, tau)
    jx, jkv, jqm, jkm, jpos, jparams = _jax_inputs(xw, kv, qm, km, pos, p)
    kw = dict(nhead=H, tau_min=TAU_MIN, cross=cross)
    try:
        jpe.set_interpret(True)
        if S is None:
            want = jpe._pallas_forward(jx, jkv, jqm, jkm, jpos, *jparams, **kw)
        else:
            want = jpe._pallas_forward_sel(
                jx, jkv, jnp.asarray(sel[0]), jnp.asarray(sel[1]), jqm, jkm,
                jpos, *jparams, **kw)
    finally:
        jpe.set_interpret(False)
    want = np.asarray(want, np.float32)
    sq, sk = (None, None) if S is None else map(_t, sel)
    got = reference_encoder_layer(
        _t(xw).bfloat16(), _t(kv).bfloat16() if cross else None, sq, sk,
        _t(qm), _t(km), _t(pos).bfloat16(), LayerParams(*_port_weights(p)),
        H, TAU_MIN, cross).float().numpy()
    err = np.abs(got - want)
    assert err.max() <= 0.06 and err.mean() <= 2e-3, (err.max(), err.mean())
    if S is not None:
        untouched = np.ones((N, 64), bool)
        np.put_along_axis(untouched, sel[0], False, -1)
        np.testing.assert_array_equal(got[untouched], xw[untouched])


@pytest.mark.parametrize('case', CASES, ids=_ids)
def test_training_backward_plain_matches_pallas_interpret(case):
    """Plain K7 / K9 (autograd through the plain forward) vs
    ``_pallas_backward`` / ``_pallas_backward_sel`` in interpret mode, all
    19 outputs (dx, dkv and the 17 parameter gradients) and, for K7, dpos.
    The TPU kernel rounds every backward matmul operand to bf16; the plain
    version keeps its gradients in f32, so each output may differ at bf16
    resolution of the values feeding it: max |diff| <= 3e-2 of the output's
    scale and mean <= 3e-3 of it. dtau is one sum over every window and
    head, so it is held to 5e-2 of its value; below tau_min both give 0.
    In self mode the key and value paths fold into dx: JAX's dkv is 0."""
    N, S, cross, tau = case
    xw, kv, sel, qm, km, pos, p, g = _case(100 + N + (S or 0), N, S, cross,
                                           tau)
    jx, jkv, jqm, jkm, jpos, jparams = _jax_inputs(xw, kv, qm, km, pos, p)
    jg = jnp.asarray(g, jnp.bfloat16)
    kw = dict(nhead=H, tau_min=TAU_MIN, cross=cross)
    try:
        jpe.set_interpret(True)
        if S is None:
            want = jpe._pallas_backward(jx, jkv, jqm, jkm, jpos,
                                        tuple(jparams), jg, **kw)
        else:
            want = jpe._pallas_backward_sel(
                jx, jkv, jnp.asarray(sel[0]), jnp.asarray(sel[1]), jqm, jkm,
                jpos, tuple(jparams), jg, **kw)
    finally:
        jpe.set_interpret(False)
    want = [np.asarray(a, np.float32) for a in want]
    sq, sk = (None, None) if S is None else map(_t, sel)
    dx, dkv, grads, dpos = reference_encoder_layer_bwd(
        _t(xw).bfloat16(), _t(kv).bfloat16() if cross else None, sq, sk,
        _t(qm), _t(km), _t(pos).bfloat16(), _port_weights(p),
        _t(g).bfloat16(), want_dpos=S is None, **kw)

    def close(name, got, ref):
        scale = max(np.abs(ref).max(), 1e-6)
        err = np.abs(got - ref)
        assert err.max() <= 3e-2 * scale and err.mean() <= 3e-3 * scale, (
            name, err.max() / scale, err.mean() / scale)

    close('dx', dx.numpy(), want[0])
    if cross:
        close('dkv', dkv.numpy(), want[1])
    else:
        assert dkv is None and not want[1].any()
    for name, got, ref in zip(FIELDS, grads, want[2:19]):
        got = got.numpy()
        if name in MATRICES:
            got = got.T
        ref = ref.reshape(got.shape)
        if name == 'tau':
            if tau < TAU_MIN:
                assert got[0] == 0.0 and ref[0] == 0.0
            else:
                assert abs(got[0] - ref[0]) <= 5e-2 * abs(ref[0]), (got, ref)
            continue
        close(name, got, ref)
    if S is None:
        close('dpos', dpos.numpy(), want[19])


def test_fused_encoder_layer_function_uses_the_plain_pair():
    """The autograd Function on CPU tensors: its forward is the plain K6
    and its backward the plain K7, bit for bit."""
    N, S, cross = 16, None, True
    xw, kv, _, qm, km, pos, p, g = _case(5, N, S, cross, 0.7)
    ws = [w.requires_grad_() for w in _port_weights(p)]
    x = _t(xw).bfloat16().requires_grad_()
    k = _t(kv).bfloat16().requires_grad_()
    out = fused_encoder_layer(x, k, None, None, _t(qm), _t(km),
                              _t(pos).bfloat16(), ws, kernel_params(ws),
                              nhead=H, tau_min=0.01, cross=cross)
    ref = reference_encoder_layer(x.detach(), k.detach(), None, None, _t(qm),
                                  _t(km), _t(pos).bfloat16(),
                                  LayerParams(*[w.detach() for w in ws]), H,
                                  0.01, cross)
    assert torch.equal(out, ref)
    out.backward(_t(g).bfloat16())
    dx, dkv, grads, _ = reference_encoder_layer_bwd(
        x.detach(), k.detach(), None, None, _t(qm), _t(km),
        _t(pos).bfloat16(), [w.detach() for w in ws], _t(g).bfloat16(),
        nhead=H, tau_min=0.01, cross=cross)
    assert torch.equal(x.grad, dx.bfloat16())
    assert torch.equal(k.grad, dkv.bfloat16())
    for w, gw in zip(ws, grads):
        assert torch.equal(w.grad, gw)


@pytest.mark.parametrize('shift', [False, True])
def test_window_gather_scatter_functions_match_jax_vjp(shift):
    """The K1 / K2 autograd Functions against ``jax.vjp`` of the JAX
    package's ``gather_windows_padded`` and ``scatter_windows_into_padded``
    (their custom VJPs) on a plan with dummy slots: forward values and both
    cotangents are copies and sums of bf16 values, so they are equal."""
    rng = np.random.RandomState(30 + int(shift))
    B, Hg, Wg, Cg, cap = 2, 20, 27, 16, 16
    occ = rng.rand(B, Hg, Wg) < 0.08
    idx, valid, _ = joc.occupied_window_indices(jnp.asarray(occ), 8, shift,
                                                cap)
    assert not np.asarray(valid).all()
    x = _bf16_np(np.where(occ[..., None], rng.normal(0, 1, (B, Hg, Wg, Cg)),
                          0))
    jxp = joc.pad_grid(jnp.asarray(x, jnp.bfloat16), 8, shift)
    txp = toc.pad_grid(_t(x).bfloat16(), 8, shift)
    tidx = _t(idx)

    out, vjp = jax.vjp(lambda a: joc.gather_windows_padded(a, idx, 8), jxp)
    gw = _bf16_np(rng.normal(0, 1, out.shape))
    (want_dxp,) = vjp(jnp.asarray(gw, jnp.bfloat16))
    xp = txp.clone().requires_grad_()
    got = toc.gather_windows_train(xp, tidx, 8)
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(out, np.float32))
    got.backward(_t(gw).bfloat16())
    np.testing.assert_array_equal(xp.grad.float().numpy(),
                                  np.asarray(want_dxp, np.float32))

    xw = _bf16_np(rng.normal(0, 1, out.shape))
    gp = _bf16_np(rng.normal(0, 1, txp.shape))
    out_s, vjp_s = jax.vjp(
        lambda a, b: joc.scatter_windows_into_padded(a, idx, b, 8),
        jnp.asarray(xw, jnp.bfloat16), jxp)
    want_dxw, want_dinit = vjp_s(jnp.asarray(gp, jnp.bfloat16))
    txw = _t(xw).bfloat16().requires_grad_()
    init = txp.clone().requires_grad_()
    got_s = toc.scatter_windows_train(txw, tidx, init, 8)
    np.testing.assert_array_equal(got_s.detach().float().numpy(),
                                  np.asarray(out_s, np.float32))
    np.testing.assert_array_equal(init.detach().float().numpy(),
                                  txp.float().numpy())  # out of place
    got_s.backward(_t(gp).bfloat16())
    np.testing.assert_array_equal(txw.grad.float().numpy(),
                                  np.asarray(want_dxw, np.float32))
    np.testing.assert_array_equal(init.grad.float().numpy(),
                                  np.asarray(want_dinit, np.float32))


def test_sorted_segment_max_function_grad_matches_ssm_bwd():
    """The K5 autograd Function's gradient against the JAX package's
    ``_ssm_bwd`` (through ``jax.vjp`` of ``sorted_segment_max``), with
    maxima tied three ways and by chance, a pillar that is masked out and
    out-of-range rows: the split is g / count on f32 values, so the results
    agree to f32 rounding (1e-6)."""
    rng = np.random.RandomState(12)
    B, Pn, V, Cs = 2, 256, 24, 8
    feats, segs, ends, masks, tied = [], [], [], [], []
    for b in range(B):
        counts = rng.randint(1, 12, V - 2)
        counts[5] = 3
        nv = int(counts.sum())
        seg = np.full(Pn, V, np.int32)
        seg[:nv] = np.repeat(np.arange(V - 2), counts)
        end = np.zeros(V, np.int32)
        end[:V - 2] = np.cumsum(counts) - 1
        m = np.zeros(V, bool)
        m[:V - 2] = True
        m[3] = False                                   # masked pillar
        f = np.round(rng.normal(0, 1, (Pn, Cs)), 1).astype(np.float32)
        f[end[5] - 2:end[5] + 1] = f[end[5]]           # a three-way tie
        tied.append(slice(end[5] - 2, end[5] + 1))
        feats.append(f)
        segs.append(seg)
        ends.append(end)
        masks.append(m)
    feat, seg, end, msk = map(np.stack, (feats, segs, ends, masks))
    g = rng.normal(0, 1, (B, V, Cs)).astype(np.float32)
    out, vjp = jax.vjp(lambda a: jss.sorted_segment_max(
        a, jnp.asarray(seg), jnp.asarray(end), jnp.asarray(msk), V),
        jnp.asarray(feat))
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want)
    x = _t(feat).requires_grad_()
    got = sorted_segment_max_train(x, _t(seg), _t(end), _t(msk), V)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(_t(g))
    np.testing.assert_allclose(x.grad.numpy(), want, atol=1e-6, rtol=0)
    for b in range(B):  # the tie splits g three ways
        np.testing.assert_allclose(x.grad[b, tied[b]].numpy(),
                                   np.broadcast_to(g[b, 5] / 3, (3, Cs)),
                                   atol=1e-6, rtol=0)
