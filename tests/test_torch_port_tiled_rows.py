"""The full-window training forward K6 and the serving packed layer K4 on
the persistent tiled kernel (``csrc/encoder_layer_tiled.cu``), on the CPU.

On the card both run the layer only on windows with an occupied query cell,
in tiles of 64 rows (one window at T = 64 or S = 48, four at S = 16), after
a pre-pass that gives every other window its output without the layer: K6
writes zeros there, K4 nothing (it updates rows [row_lo, row_lo + cap) of
``xw_all [B, total, 64, C]`` in place, and such a window keeps its row).
Here:

* the premises on the JAX side, with the Pallas kernels in interpret mode:
  ``_pallas_forward`` returns zeros on every cell of a window without an
  occupied query cell; ``encoder_layer_rows_sel`` leaves, bit for bit, the
  rows outside its range, the windows without an occupied query cell and
  the unselected cells;
* the plain K6 and K4 on inputs that mix live and empty windows against
  those JAX kernels, at the existing tolerances;
* the plan on the plain versions: the pre-pass, then the layer tile by tile
  over the live windows only (K4's windows found through the plain row
  addressing ``window_rows_plain``), gives the plain layer over all windows
  bit for bit, with a partial last tile at S = 16;
* K4's row addressing, and the widths the tiled kernel is compiled for.

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
from tmae_tpu_torch.ops.encoder_layer import (LayerParams,
                                              _check_tiled_widths,
                                              encoder_layer_fwd,
                                              encoder_layer_rows_sel,
                                              live_windows_plain,
                                              reference_encoder_layer,
                                              tile_plan_plain,
                                              window_rows_plain)

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


def _jparams(p):
    return [jnp.asarray(p[k]) for k in FIELDS]


def _pos():
    return _bf16_np(np.asarray(j_slot_pos_embed(8, C)))


def _select(o, S):
    """Occupied-first selections of S cells and their masks."""
    key = o * (64 - np.arange(64))
    s = np.argsort(-key, axis=-1, kind='stable')[..., :S]
    return s.astype(np.int32), np.take_along_axis(o, s, -1).astype(
        np.float32)


# ---------------------------------------------------------------------------
# K6: flat windows [N, 64, C], all 64 cells
# ---------------------------------------------------------------------------

TAU_MIN_FULL = 0.01  # t_mae.yaml's; the full-window kernels soft-max per head
FULL_CASES = [(21, False), (18, True)]


def _fid(case):
    N, cross = case
    return f'N{N}-{"cross" if cross else "self"}'


@functools.lru_cache(maxsize=None)
def _full_case(N, cross):
    """N windows of a training bucket: every third window and the last four
    (a bucket's padding slots) have no occupied query cell; features on
    every cell, so an empty window's zeros come from the layer's mask.
    Returns the numpy inputs and JAX's ``_pallas_forward`` (interpret)."""
    rng = np.random.RandomState(11 * N + cross)
    occ = rng.rand(N, 64) < rng.uniform(0.1, 0.6, (N, 1))
    occ[::3] = False
    occ[-4:] = False
    kocc = rng.rand(N, 64) < 0.3
    kocc[1::5] = False
    xw = _bf16_np(rng.normal(0, 1, (N, 64, C)))
    kv = _bf16_np(rng.normal(0, 1, (N, 64, C))) if cross else xw
    qm = occ.astype(np.float32)
    km = kocc.astype(np.float32) if cross else qm
    p = _weights(rng)
    pos = _pos()
    try:
        jpe.set_interpret(True)
        want = jpe._pallas_forward(
            jnp.asarray(xw, jnp.bfloat16), jnp.asarray(kv, jnp.bfloat16),
            jnp.asarray(qm), jnp.asarray(km), jnp.asarray(pos, jnp.bfloat16),
            *_jparams(p), nhead=H, tau_min=TAU_MIN_FULL, cross=cross)
    finally:
        jpe.set_interpret(False)
    want = np.asarray(want.astype(jnp.float32))
    return xw, kv, qm, km, pos, p, want


def _full_plain(xw, kv, qm, km, pos, p, cross):
    """The K6 wrapper on CPU tensors, i.e. its plain version."""
    return encoder_layer_fwd(
        _t(xw).bfloat16(), _t(kv).bfloat16() if cross else None, None, None,
        _t(qm), _t(km) if cross else None, _t(pos).bfloat16(), _port(p),
        nhead=H, tau_min=TAU_MIN_FULL, cross=cross)


@pytest.mark.parametrize('case', FULL_CASES, ids=_fid)
def test_pallas_forward_zero_on_windows_without_query(case):
    """The premise of K6's pre-pass: JAX's full-window forward writes
    exactly 0 on every cell of a window without an occupied query cell,
    whatever its tokens."""
    N, _ = case
    xw, _, qm, _, _, _, want = _full_case(*case)
    dead = ~(qm > 0).any(-1)
    assert dead.sum() >= N // 3 and (~dead).sum() >= 4
    assert (xw[dead] != 0).all()
    assert not want[dead].any()


@pytest.mark.parametrize('case', FULL_CASES, ids=_fid)
def test_plain_full_on_mixed_windows_matches_pallas(case):
    """Plain K6 against ``_pallas_forward`` (interpret) on live windows
    interleaved with empty ones: max |diff| <= 0.06 and mean <= 2e-3 (the
    bound of test_training_forward_plain_matches_pallas_interpret: a
    summation order can flip one bf16 rounding of an intermediate), and the
    empty windows 0 on both sides."""
    N, cross = case
    xw, kv, qm, km, pos, p, want = _full_case(*case)
    got = _full_plain(xw, kv, qm, km, pos, p, cross).float().numpy()
    err = np.abs(got - want)
    assert err.max() <= 0.06 and err.mean() <= 2e-3, (err.max(), err.mean())
    dead = ~(qm > 0).any(-1)
    assert not got[dead].any()
    assert not got[qm == 0].any()  # unoccupied cells of live windows too


@pytest.mark.parametrize('case', FULL_CASES, ids=_fid)
def test_plain_full_over_live_tiles_equals_all_windows(case):
    """The plan, on the plain version: zeros (the pre-pass), then the layer
    on each tile of one live window written over it; this equals the plain
    layer over all windows bit for bit."""
    N, cross = case
    xw, kv, qm, km, pos, p, _ = _full_case(*case)
    full = _full_plain(xw, kv, qm, km, pos, p, cross)
    out = torch.zeros_like(full)
    tiles = tile_plan_plain(live_windows_plain(_t(qm)), 64)
    for tile in tiles:
        i = np.asarray(tile)
        out[i] = _full_plain(xw[i], kv[i], qm[i], km[i], pos, p, cross)
    assert len(tiles) == int((qm > 0).any(-1).sum()) < N
    assert torch.equal(out, full)


# ---------------------------------------------------------------------------
# K4: S selected cells, in place on rows [row_lo, row_lo + cap)
# ---------------------------------------------------------------------------

TAU_MIN_SEL = 0.05  # see tests/test_torch_port_train_kernels.py: TAU_MIN
# (S, cross); B = 2 samples, rows [16, 32) of 48 (the JAX kernel takes
# row_lo and cap in multiples of 16)
ROWS_CASES = [(16, False), (16, True), (48, True)]
B, TOTAL, CAP, ROW_LO = 2, 48, 16, 16


def _rid(case):
    S, cross = case
    return f'S{S}-{"cross" if cross else "self"}'


@functools.lru_cache(maxsize=None)
def _rows_case(S, cross):
    """A gathered window tensor [B, 48, 64, C] with features on every cell,
    and a bucket on rows [16, 32): in each sample every third window and the
    last three (padding slots) have no occupied query cell, and window 1 of
    sample 1 neither, so 15 windows are live and S = 16 leaves a partial
    last tile. Returns the numpy inputs and JAX's ``encoder_layer_rows_sel``
    (interpret), which updates the rows in place (aliased)."""
    rng = np.random.RandomState(31 * S + cross)
    occ = rng.rand(B, CAP, 64) < rng.uniform(0.1, 0.6, (B, CAP, 1))
    occ[:, ::3] = False
    occ[:, -3:] = False
    occ[1, 1] = False
    kocc = rng.rand(B, CAP, 64) < 0.3
    kocc[:, 1::5] = False
    xw = _bf16_np(rng.normal(0, 1, (B, TOTAL, 64, C)))
    kv = _bf16_np(rng.normal(0, 1, (B, TOTAL, 64, C)))
    sq, qm = _select(occ, S)
    sk, km = _select(kocc, S) if cross else (sq, qm)
    p = _weights(rng)
    pos = _pos()
    try:
        jpe.set_interpret(True)
        want = jpe.encoder_layer_rows_sel(
            jnp.asarray(xw, jnp.bfloat16),
            jnp.asarray(kv, jnp.bfloat16) if cross else None,
            jnp.asarray(sq), jnp.asarray(sk), jnp.asarray(qm),
            jnp.asarray(km), jnp.asarray(pos, jnp.bfloat16), *_jparams(p),
            nhead=H, tau_min=TAU_MIN_SEL, cross=cross, row_lo=ROW_LO)
    finally:
        jpe.set_interpret(False)
    want = np.asarray(want.astype(jnp.float32))
    return xw, kv, sq, sk, qm, km, pos, p, want


def _rows_plain(xw, kv, sq, sk, qm, km, pos, p, cross):
    """The K4 wrapper on CPU tensors, i.e. its plain version, on a copy."""
    return encoder_layer_rows_sel(
        _t(xw).bfloat16(), _t(kv).bfloat16() if cross else None, _t(sq),
        _t(sk) if cross else None, _t(qm), _t(km) if cross else None,
        _t(pos).bfloat16(), _port(p), nhead=H, tau_min=TAU_MIN_SEL,
        cross=cross, row_lo=ROW_LO)


def _kept(xw, sq, qm):
    """Cells K4 must leave as they are: every row outside [row_lo, row_lo +
    cap), every cell of a window in range without an occupied query cell,
    and every cell that is not an occupied selected one."""
    kept = np.ones(xw.shape[:3], bool)
    written = np.zeros((B, CAP, 64), bool)
    b, j, i = np.nonzero(qm > 0)
    written[b, j, sq[b, j, i]] = True
    kept[:, ROW_LO:ROW_LO + CAP] = ~written
    return kept


@pytest.mark.parametrize('case', ROWS_CASES, ids=_rid)
def test_pallas_rows_sel_keeps_rows_empty_windows_and_unselected_cells(case):
    """The premise of K4's flags-only pre-pass and its in-place write: JAX's
    ``encoder_layer_rows_sel`` leaves bit for bit the rows outside [row_lo,
    row_lo + cap), the windows without an occupied query cell and the cells
    that are not occupied selected ones; the occupied selected cells
    change."""
    xw, _, sq, _, qm, _, _, _, want = _rows_case(*case)
    kept = _kept(xw, sq, qm)
    np.testing.assert_array_equal(want[kept], xw[kept])
    dead = ~(qm > 0).any(-1)
    rows = want[:, ROW_LO:ROW_LO + CAP]
    np.testing.assert_array_equal(rows[dead], xw[:, ROW_LO:ROW_LO + CAP][dead])
    assert dead.sum() >= 2 * 5 and (~kept).sum() > 0
    assert (want[~kept] != xw[~kept]).mean() > 0.9


@pytest.mark.parametrize('case', ROWS_CASES, ids=_rid)
def test_plain_rows_sel_on_mixed_windows_matches_pallas(case):
    """Plain K4 against ``encoder_layer_rows_sel`` (interpret), B = 2 and
    row_lo = 16, on live windows interleaved with empty ones: max |diff| <=
    0.06 and mean <= 2e-3 (the bound of
    test_encoder_rows_plain_matches_pallas_interpret), and every cell K4
    must keep equal to the input on both sides."""
    S, cross = case
    xw, kv, sq, sk, qm, km, pos, p, want = _rows_case(*case)
    got = _rows_plain(xw, kv, sq, sk, qm, km, pos, p, cross).float().numpy()
    err = np.abs(got - want)
    assert err.max() <= 0.06 and err.mean() <= 2e-3, (err.max(), err.mean())
    kept = _kept(xw, sq, qm)
    np.testing.assert_array_equal(got[kept], xw[kept])


@pytest.mark.parametrize('case', ROWS_CASES, ids=_rid)
def test_plain_rows_sel_over_live_tiles_equals_all_windows(case):
    """The plan, on the plain version: nothing for the pre-pass, then the
    layer on each tile of live windows (four at S = 16, one at S = 48), each
    window w = b cap + j found at row ``window_rows_plain(w, ...)`` of the
    [B total, 64, C] view and written back there; this equals the plain
    layer over all windows bit for bit."""
    S, cross = case
    xw, kv, sq, sk, qm, km, pos, p, _ = _rows_case(*case)
    full = _rows_plain(xw, kv, sq, sk, qm, km, pos, p, cross)
    out = _t(xw).bfloat16().reshape(B * TOTAL, 64, C)
    kvf = _t(kv).bfloat16().reshape(B * TOTAL, 64, C)
    flat = lambda a: _t(a).reshape(B * CAP, S)
    tiles = tile_plan_plain(live_windows_plain(flat(qm)), S)
    for tile in tiles:
        w = torch.tensor(tile)
        r = window_rows_plain(w, CAP, TOTAL, ROW_LO)
        out[r] = reference_encoder_layer(
            out[r], kvf[r] if cross else None, flat(sq)[w],
            flat(sk)[w] if cross else None, flat(qm)[w],
            flat(km)[w] if cross else None, _t(pos).bfloat16(), _port(p), H,
            TAU_MIN_SEL, cross)
    if S == 16:
        assert 0 < len(tiles[-1]) < 4  # a partial last tile
    assert sum(map(len, tiles)) == int((qm > 0).any(-1).sum()) == 15
    assert torch.equal(out.reshape(full.shape), full)


# ---------------------------------------------------------------------------
# K4's row addressing and the compiled widths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('b,total,cap,row_lo', [(2, 48, 16, 16),
                                                (3, 20, 7, 5), (1, 9, 9, 0)])
def test_window_rows_plain_addresses_each_window_row(b, total, cap, row_lo):
    """Window w = b cap + j of a call on rows [row_lo, row_lo + cap) is the
    row of ``xw_all[b, row_lo + j]`` in the [B total, ...] view, in window
    order; with cap = total and row_lo = 0 (K6, K8) window w is row w."""
    rows = window_rows_plain(torch.arange(b * cap), cap, total, row_lo)
    ids = torch.arange(b * total).reshape(b, total)
    assert torch.equal(rows, ids[:, row_lo:row_lo + cap].reshape(-1))
    assert [window_rows_plain(w, cap, total, row_lo)
            for w in range(b * cap)] == rows.tolist()
    n = b * total
    assert torch.equal(window_rows_plain(torch.arange(n), n, n, 0),
                       torch.arange(n))


@pytest.mark.parametrize('width,nhead,ffn,ok', [
    (128, 8, 256, True), (256, 8, 512, True), (64, 8, 128, False),
    (32, 4, 64, False), (128, 4, 256, False), (256, 16, 512, False),
    (128, 8, 512, False)])
def test_tiled_width_check(width, nhead, ffn, ok):
    """The tiled kernel (K4, K6, K8, K10) is compiled for C = 128 or 256
    with 8 heads and an FFN width of 2C, the widths of every full-width
    T-MAE config; its wrappers refuse every other width on the card."""
    p = LayerParams(*[torch.zeros(1)] * len(FIELDS))._replace(
        f1w=torch.zeros(ffn, width))
    if ok:
        _check_tiled_widths(width, nhead, p)
    else:
        with pytest.raises(ValueError, match='compiled for C = 128 or 256'):
            _check_tiled_widths(width, nhead, p)
