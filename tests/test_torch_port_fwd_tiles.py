"""The window plan of the persistent forward kernel K8 / K10
(``csrc/encoder_layer_tiled.cu``) and its premises, on the CPU.

The kernel runs the layer only on windows with an occupied query cell, in
tiles of 64 rows (four windows at S = 16, one at S = 48 or T = 64), after a
pre-pass that gives every other window its output without the layer: x
passed through (K8) or zeros (K10). Here:

* the premises on the JAX side, with the Pallas kernels in interpret mode:
  ``_pallas_forward_sel`` returns x bit for bit on a slot whose query mask
  is all zero, and ``_grid_forward`` returns zeros on every cell of a window
  without an occupied query cell;
* the plain window plan (``live_windows_plain``, ``tile_plan_plain``): every
  live window lands in exactly one tile, in window order, with a partial
  last tile, at S = 16, 48 and 64;
* the plain K8 and K10 on inputs that mix live and empty windows against
  the JAX kernels at the existing tolerances, and the plan itself: the
  plain layer run tile by tile over the live windows, after the pre-pass,
  gives the plain layer over all windows bit for bit.

Inputs are made from a seed with numpy.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.ops import pallas_encoder as jpe
from tmae_tpu.ops.dense_windows import slot_pos_embed as j_slot_pos_embed
from tmae_tpu_torch.ops.encoder_layer import (LayerParams, _flat_windows,
                                              _unflat_windows,
                                              live_windows_plain,
                                              reference_encoder_layer,
                                              reference_encoder_layer_grid,
                                              tile_plan_plain)

C, F, H = 128, 256, 8
FIELDS = LayerParams._fields
MATRICES = ('wq', 'wk', 'wv', 'wo', 'f1w', 'f2w')


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_np(a):
    return torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _weights(rng):
    """One layer in the JAX layout [in, out], bf16 matrices."""
    def lin(i, o):
        return _bf16_np(rng.normal(0, 1, (i, o)) / np.sqrt(i))

    def vec(n, s=0.1, m=0.0):
        return (m + s * rng.normal(size=(n,))).astype(np.float32)

    return dict(wq=lin(C, C), bq=vec(C), wk=lin(C, C), bk=vec(C),
                wv=lin(C, C), bv=vec(C), wo=lin(C, C), bo=vec(C),
                tau=np.asarray([0.3], np.float32), ln1s=vec(C, m=1.0),
                ln1b=vec(C), f1w=lin(C, F), f1b=vec(F), f2w=lin(F, C),
                f2b=vec(C), ln2s=vec(C, m=1.0), ln2b=vec(C))


def _port(p):
    """JAX layout → the port's LayerParams (Linear [out, in], f32)."""
    return LayerParams(*[_t(p[k].T.copy()) if k in MATRICES else _t(p[k])
                         for k in FIELDS])


# ---------------------------------------------------------------------------
# K8: flat windows, S selected cells
# ---------------------------------------------------------------------------

TAU_MIN_SEL = 0.05  # see tests/test_torch_port_train_kernels.py: TAU_MIN
SEL_CASES = [(21, 16, False), (13, 48, True)]


def _sid(case):
    N, S, cross = case
    return f'N{N}-S{S}-{"cross" if cross else "self"}'


@functools.lru_cache(maxsize=None)
def _sel_case(N, S, cross):
    """N windows of a bucket: every third window and the last four (the
    padding slots of a bucket) have no occupied query cell, so the live
    windows are interleaved with empty ones and their count leaves a
    partial last tile at S = 16; occupied-first selections. Returns the
    numpy inputs and JAX's ``_pallas_forward_sel`` output (interpret)."""
    rng = np.random.RandomState(7 * N + S + cross)
    occ = rng.rand(N, 64) < rng.uniform(0.1, 0.6, (N, 1))
    occ[::3] = False
    occ[-4:] = False
    kocc = rng.rand(N, 64) < 0.3
    kocc[1::5] = False
    xw = _bf16_np(rng.normal(0, 1, (N, 64, C)))  # nonzero on every cell
    kv = _bf16_np(np.where(kocc[..., None], rng.normal(0, 1, (N, 64, C)),
                           0)) if cross else xw

    def select(o):
        key = o * (64 - np.arange(64))
        s = np.argsort(-key, axis=-1, kind='stable')[..., :S]
        return s.astype(np.int32), np.take_along_axis(o, s, -1)

    sq, qm = select(occ)
    sk, km = select(kocc) if cross else (sq, qm)
    qm, km = qm.astype(np.float32), km.astype(np.float32)
    p = _weights(rng)
    pos = _bf16_np(np.asarray(j_slot_pos_embed(8, C)))
    try:
        jpe.set_interpret(True)
        want = jpe._pallas_forward_sel(
            jnp.asarray(xw, jnp.bfloat16), jnp.asarray(kv, jnp.bfloat16),
            jnp.asarray(sq), jnp.asarray(sk), jnp.asarray(qm),
            jnp.asarray(km), jnp.asarray(pos, jnp.bfloat16),
            *[jnp.asarray(p[k]) for k in FIELDS], nhead=H,
            tau_min=TAU_MIN_SEL, cross=cross)
    finally:
        jpe.set_interpret(False)
    want = np.asarray(want.astype(jnp.float32))
    return xw, kv, sq, sk, qm, km, pos, p, want


def _sel_plain(xw, kv, sq, sk, qm, km, pos, p, cross):
    return reference_encoder_layer(
        _t(xw).bfloat16(), _t(kv).bfloat16() if cross else None, _t(sq),
        _t(sk) if cross else None, _t(qm), _t(km) if cross else None,
        _t(pos).bfloat16(), _port(p), H, TAU_MIN_SEL, cross)


@pytest.mark.parametrize('case', SEL_CASES, ids=_sid)
def test_pallas_sel_forward_passes_slots_without_query_through(case):
    """The premise of K8's skip: a slot with no occupied query cell leaves
    the layer as x, bit for bit, in JAX's packed forward."""
    N, S, cross = case
    xw, _, _, _, qm, _, _, _, want = _sel_case(*case)
    dead = ~(qm > 0).any(-1)
    assert dead.sum() >= N // 3 and (~dead).sum() > 0
    np.testing.assert_array_equal(want[dead], xw[dead])


@pytest.mark.parametrize('case', SEL_CASES, ids=_sid)
def test_plain_sel_on_mixed_windows_matches_pallas(case):
    """Plain K8 against ``_pallas_forward_sel`` (interpret) on live windows
    interleaved with empty ones: max |diff| <= 0.06 and mean <= 2e-3 (the
    bound of test_training_forward_plain_matches_pallas_interpret: a
    summation order can flip one bf16 rounding of an intermediate), and the
    empty windows equal to x on both sides."""
    N, S, cross = case
    xw, kv, sq, sk, qm, km, pos, p, want = _sel_case(*case)
    got = _sel_plain(xw, kv, sq, sk, qm, km, pos, p, cross).float().numpy()
    err = np.abs(got - want)
    assert err.max() <= 0.06 and err.mean() <= 2e-3, (err.max(), err.mean())
    dead = ~(qm > 0).any(-1)
    np.testing.assert_array_equal(got[dead], xw[dead])


@pytest.mark.parametrize('case', SEL_CASES, ids=_sid)
def test_plain_sel_over_live_tiles_equals_all_windows(case):
    """The plan, on the plain version: the output is x, then the layer on
    each tile of live windows written over its windows; this equals the
    plain layer over all windows bit for bit."""
    N, S, cross = case
    xw, kv, sq, sk, qm, km, pos, p, _ = _sel_case(*case)
    full = _sel_plain(xw, kv, sq, sk, qm, km, pos, p, cross)
    out = _t(xw).bfloat16().clone()
    tiles = tile_plan_plain(live_windows_plain(_t(qm)), S)
    for tile in tiles:
        i = np.asarray(tile)
        out[i] = _sel_plain(xw[i], kv[i], sq[i], sk[i], qm[i], km[i], pos, p,
                            cross)
    if S == 16:
        assert len(tiles[-1]) < 4  # a partial last tile
    assert torch.equal(out, full)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('T,N,n_live', [(16, 40, 13), (16, 40, 16),
                                        (48, 30, 7), (64, 50, 11),
                                        (16, 9, 0)])
def test_tile_plan_covers_each_live_window_once_in_order(T, N, n_live):
    """Every live window lands in exactly one tile, the tiles read the live
    windows in window order, each tile but the last is full (4 windows at
    S = 16, else 1) and the last holds the rest."""
    rng = np.random.RandomState(T + N + n_live)
    live = np.sort(rng.choice(N, n_live, replace=False))
    qmask = np.zeros((N, T), np.float32)
    for w in live:
        qmask[w, rng.choice(T, rng.randint(1, T), replace=False)] = 1.0
    got = live_windows_plain(_t(qmask))
    np.testing.assert_array_equal(got.numpy(), live)
    tiles = tile_plan_plain(got, T)
    per = 4 if T == 16 else 1
    flat = [w for tile in tiles for w in tile]
    assert flat == list(live)
    assert all(len(t) == per for t in tiles[:-1])
    assert not tiles or 1 <= len(tiles[-1]) <= per
    assert len(tiles) == -(-n_live // per)


# ---------------------------------------------------------------------------
# K10: the dense grid
# ---------------------------------------------------------------------------

TAU_MIN_GRID = 0.01
GRID_CASES = [(False, False), (True, True)]


def _gid(case):
    cross, shift = case
    return f'{"cross" if cross else "self"}-shift{int(shift)}'


@functools.lru_cache(maxsize=None)
def _grid_case(cross, shift, B=2, Hg=20, Wg=28):
    """A grid pair whose occupancy leaves whole windows of the partition
    empty (a band and a block of windows), with features on every cell (so
    an empty window's zeros come from the layer's mask, not the input).
    Returns the numpy inputs and JAX's ``_grid_forward`` (interpret)."""
    rng = np.random.RandomState(50 + 2 * cross + shift)
    occ = rng.rand(B, Hg, Wg) < 0.3
    occ[:, 10:, :] = False
    occ[:, :, 16:] = False
    occ[1] = False
    occ[1, 2:6, 3:7] = rng.rand(4, 4) < 0.7
    kocc = rng.rand(B, Hg, Wg) < 0.3
    x = _bf16_np(rng.normal(0, 1, (B, Hg, Wg, C)))
    kv = _bf16_np(rng.normal(0, 1, (B, Hg, Wg, C))) if cross else x
    if not cross:
        kocc = occ
    p = _weights(rng)
    pos = _bf16_np(np.asarray(j_slot_pos_embed(8, C)))
    try:
        jpe.set_interpret(True)
        want = jpe._grid_forward(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(kv, jnp.bfloat16),
            jnp.asarray(occ), jnp.asarray(kocc),
            jnp.asarray(pos, jnp.bfloat16),
            *[jnp.asarray(p[k]) for k in FIELDS], nhead=H,
            tau_min=TAU_MIN_GRID, cross=cross, window=8, shift=shift)
    finally:
        jpe.set_interpret(False)
    want = np.asarray(want.astype(jnp.float32))
    return x, kv, occ, kocc, pos, p, want


def _grid_plain(x, kv, occ, kocc, pos, p, cross, shift):
    return reference_encoder_layer_grid(
        _t(x).bfloat16(), _t(kv).bfloat16() if cross else None, _t(occ),
        _t(kocc) if cross else None, _t(pos).bfloat16(), _port(p), H,
        TAU_MIN_GRID, cross, 8, shift)


def _empty_windows(occ, shift):
    """The window view of the grid's cells, and which windows of the
    shift's partition have no occupied query cell."""
    cells = _flat_windows(_t(occ).float(), 8, shift)
    return cells, ~(cells > 0).any(-1)


@pytest.mark.parametrize('case', GRID_CASES, ids=_gid)
def test_pallas_grid_forward_zero_on_windows_without_query(case):
    """The premise of K10's skip: JAX's grid forward writes exactly 0 on
    every in-grid cell of a window without an occupied query cell."""
    cross, shift = case
    _, _, occ, _, _, _, want = _grid_case(*case)
    _, empty = _empty_windows(occ, shift)
    in_grid = _flat_windows(torch.ones(occ.shape), 8, shift) > 0
    wv = _flat_windows(_t(want), 8, shift)
    assert empty.sum() >= 4 and (~empty).sum() >= 2
    assert (wv[empty][in_grid[empty]] == 0).all()


@pytest.mark.parametrize('case', GRID_CASES, ids=_gid)
def test_plain_grid_on_mixed_windows_matches_pallas(case):
    """Plain K10 against ``_grid_forward`` (interpret) on a grid of live
    and empty windows: max |diff| <= 0.06 and mean <= 2e-3 (the bound of
    test_grid_layer_plain_matches_pallas_interpret_and_reference), and
    every unoccupied cell 0 on both sides."""
    cross, shift = case
    x, kv, occ, kocc, pos, p, want = _grid_case(*case)
    got = _grid_plain(x, kv, occ, kocc, pos, p, cross, shift).float().numpy()
    err = np.abs(got - want)
    assert err.max() <= 0.06 and err.mean() <= 2e-3, (err.max(), err.mean())
    assert not got[~occ].any() and not want[~occ].any()


@pytest.mark.parametrize('case', GRID_CASES, ids=_gid)
def test_plain_grid_over_live_tiles_equals_all_windows(case):
    """The plan, on the plain version: zeros, then the layer on each live
    window (a tile of one) written over its cells; this equals the plain
    layer over all windows bit for bit."""
    cross, shift = case
    x, kv, occ, kocc, pos, p, _ = _grid_case(*case)
    full = _grid_plain(x, kv, occ, kocc, pos, p, cross, shift)
    cells, _ = _empty_windows(occ, shift)
    view = lambda a: _flat_windows(_t(a).bfloat16() if a.ndim == 4
                                   else _t(a).float(), 8, shift)
    xw, kvw, qm, km = view(x), view(kv), cells, view(kocc)
    out = torch.zeros_like(xw)
    tiles = tile_plan_plain(live_windows_plain(qm), 64)
    for tile in tiles:
        i = torch.tensor(tile)
        out[i] = reference_encoder_layer(
            xw[i], kvw[i] if cross else None, None, None, qm[i],
            km[i] if cross else None, _t(pos).bfloat16(), _port(p), H,
            TAU_MIN_GRID, cross)
    got = _unflat_windows(out, x.shape[0], x.shape[1:3], 8, shift)
    assert len(tiles) == int((~_empty_windows(occ, shift)[1]).sum())
    assert torch.equal(got, full)
