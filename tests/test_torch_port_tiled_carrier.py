"""The serving layers K3 and K12 on the persistent tiled kernel
(``csrc/encoder_layer_tiled.cu``), and a served layer's weights prepared
once per forward, on the CPU.

On the card K3 runs the full-window layer in place on rows [row_lo, row_lo
+ cap) of ``xw_all [B, total, 64, C]`` (K4's rows), and K12 runs the full
(T = 64) or packed (S = 16, 48) layer on the windows of one bucket plan
straight in the padded carrier ``[B, Hp + 8, Wp, C]``. Both run the layer
only on live windows, in tiles of 64 rows, after a pre-pass that gives every
other window its output without the layer: K3 writes zeros on a window
without an occupied query cell; K12 never treats a dummy slot (the plan's
padding, which names the window row below the grid) as a window, and at
T = 64 writes zeros on the carrier cells of a real slot without a query
(at S = 16, 48 nothing). Here:

* the premises on the JAX side, with the Pallas kernels in interpret mode:
  ``encoder_layer_rows_full`` writes zeros on windows without a query and
  leaves rows outside its range bit for bit;
  ``encoder_layer_fused_pipelined`` at T = 64 zeros a real plan window
  without a query, and at S = 16, 48 leaves unselected cells and non-live
  windows bit for bit, and touches no cell outside the plan's windows
  above the dummy row;
* the plain K3 and K12 on inputs that mix live, non-live and dummy slots
  against those JAX kernels, self and cross, at the existing tolerances;
* K12's carrier addressing (``plan_cells_plain``) against the plain gather;
* the plan on the plain versions: the pre-pass, then the layer tile by tile
  over the live windows only (through ``window_rows_plain`` /
  ``plan_cells_plain``), gives the plain layer over all slots bit for bit,
  with a partial last tile at S = 16;
* the prepared weights: ``TiledWeights`` on the CPU holds today's
  ``LayerParams``, the plain layout of the packed panels, and a served
  layer's eval forward through it equal to today's, default and fused path.

Inputs are made from a seed with numpy.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_tiled_rows import (_bf16_np, _jparams, _port,
                                              _pos, _t, _weights)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.ops import pallas_encoder as jpe
from tmae_tpu_torch.models.sst import DenseEncoderLayer, OccCaps, build_plans
from tmae_tpu_torch.ops import occ_compact as toc
from tmae_tpu_torch.ops.encoder_layer import (
    MATRICES, LayerParams, TiledWeights, encoder_layer_fused_pipelined,
    encoder_layer_rows_full, encoder_layer_rows_sel, kernel_params,
    live_windows_plain, pack_panels_plain, plan_cells_plain, plan_real_plain,
    reference_encoder_layer, tile_plan_plain, window_rows_plain)

C, F, H = 128, 256, 8
TAU_MIN_FULL = 0.01  # t_mae.yaml's; the full-window kernels soft-max per head
TAU_MIN_SEL = 0.05   # see tests/test_torch_port_train_kernels.py: TAU_MIN


def _tau_min(T):
    return TAU_MIN_FULL if T == 64 else TAU_MIN_SEL


# ---------------------------------------------------------------------------
# K3: all 64 cells, in place on rows [row_lo, row_lo + cap)
# ---------------------------------------------------------------------------

# B = 2 samples, rows [16, 32) of 48 (the JAX kernel takes row_lo and cap in
# multiples of 16)
B, TOTAL, CAP, ROW_LO = 2, 48, 16, 16


def _mode(cross):
    return 'cross' if cross else 'self'


@functools.lru_cache(maxsize=None)
def _rows_full_case(cross):
    """A gathered window tensor [B, 48, 64, C] with features on every cell,
    and a full bucket on rows [16, 32): in each sample every third window
    and the last three (padding slots) have no occupied query cell. Returns
    the numpy inputs and JAX's ``encoder_layer_rows_full`` (interpret),
    which updates the rows in place (aliased)."""
    rng = np.random.RandomState(71 + cross)
    occ = rng.rand(B, CAP, 64) < rng.uniform(0.1, 0.6, (B, CAP, 1))
    occ[:, ::3] = False
    occ[:, -3:] = False
    kocc = rng.rand(B, CAP, 64) < 0.3
    kocc[:, 1::5] = False
    xw = _bf16_np(rng.normal(0, 1, (B, TOTAL, 64, C)))
    kv = _bf16_np(rng.normal(0, 1, (B, TOTAL, 64, C)))
    qm = occ.astype(np.float32)
    km = kocc.astype(np.float32) if cross else qm
    p = _weights(rng)
    pos = _pos()
    try:
        jpe.set_interpret(True)
        want = jpe.encoder_layer_rows_full(
            jnp.asarray(xw, jnp.bfloat16),
            jnp.asarray(kv, jnp.bfloat16) if cross else None,
            jnp.asarray(qm), jnp.asarray(km), jnp.asarray(pos, jnp.bfloat16),
            *_jparams(p), nhead=H, tau_min=TAU_MIN_FULL, cross=cross,
            row_lo=ROW_LO)
    finally:
        jpe.set_interpret(False)
    want = np.asarray(want.astype(jnp.float32))
    return xw, kv, qm, km, pos, p, want


def _rows_full_plain(xw, kv, qm, km, pos, p, cross):
    """The K3 wrapper on CPU tensors, i.e. its plain version, on a copy,
    with the weights prepared as a served layer prepares them."""
    return encoder_layer_rows_full(
        _t(xw).bfloat16(), _t(kv).bfloat16() if cross else None, _t(qm),
        _t(km) if cross else None, _t(pos).bfloat16(),
        TiledWeights(_port(p), H), nhead=H, tau_min=TAU_MIN_FULL,
        cross=cross, row_lo=ROW_LO)


@pytest.mark.parametrize('cross', [False, True], ids=_mode)
def test_pallas_rows_full_zeros_empty_windows_and_keeps_other_rows(cross):
    """The premise of K3's pre-pass and its in-place write: JAX's
    ``encoder_layer_rows_full`` writes exactly 0 on all 64 cells of a window
    without an occupied query cell, whatever its tokens, and leaves every
    row outside [row_lo, row_lo + cap) bit for bit."""
    xw, _, qm, _, _, _, want = _rows_full_case(cross)
    dead = ~(qm > 0).any(-1)
    rows = want[:, ROW_LO:ROW_LO + CAP]
    assert dead.sum() >= 2 * 5 and (~dead).sum() >= 8
    assert (xw[:, ROW_LO:ROW_LO + CAP][dead] != 0).all()
    assert not rows[dead].any()
    assert not rows[qm == 0].any()  # unoccupied cells of live windows too
    outside = np.ones(TOTAL, bool)
    outside[ROW_LO:ROW_LO + CAP] = False
    np.testing.assert_array_equal(want[:, outside], xw[:, outside])


@pytest.mark.parametrize('cross', [False, True], ids=_mode)
def test_plain_rows_full_on_mixed_windows_matches_pallas(cross):
    """Plain K3 against ``encoder_layer_rows_full`` (interpret), B = 2 and
    row_lo = 16, on live windows interleaved with empty ones: max |diff| <=
    0.06 and mean <= 2e-3 (the bound of
    test_encoder_rows_plain_matches_pallas_interpret: a summation order can
    flip one bf16 rounding of an intermediate); the rows outside the range
    equal to the input, and the empty windows 0, on both sides."""
    xw, kv, qm, km, pos, p, want = _rows_full_case(cross)
    got = _rows_full_plain(xw, kv, qm, km, pos, p, cross).float().numpy()
    err = np.abs(got - want)
    assert err.max() <= 0.06 and err.mean() <= 2e-3, (err.max(), err.mean())
    outside = np.ones(TOTAL, bool)
    outside[ROW_LO:ROW_LO + CAP] = False
    np.testing.assert_array_equal(got[:, outside], xw[:, outside])
    dead = ~(qm > 0).any(-1)
    assert not got[:, ROW_LO:ROW_LO + CAP][dead].any()


@pytest.mark.parametrize('cross', [False, True], ids=_mode)
def test_plain_rows_full_over_live_tiles_equals_all_windows(cross):
    """The plan, on the plain version: zeros on the row of each window
    without a query (the pre-pass), then the layer on each tile of one live
    window w = b cap + j, found at row ``window_rows_plain(w, ...)`` of the
    [B total, 64, C] view and written back there; this equals the plain K3
    over all windows bit for bit."""
    xw, kv, qm, km, pos, p, _ = _rows_full_case(cross)
    full = _rows_full_plain(xw, kv, qm, km, pos, p, cross)
    out = _t(xw).bfloat16().reshape(B * TOTAL, 64, C)
    kvf = _t(kv).bfloat16().reshape(B * TOTAL, 64, C)
    flat = lambda a: _t(a).reshape(B * CAP, 64)
    dead = (~(flat(qm) > 0).any(-1)).nonzero()[:, 0]
    out[window_rows_plain(dead, CAP, TOTAL, ROW_LO)] = 0
    tiles = tile_plan_plain(live_windows_plain(flat(qm)), 64)
    for tile in tiles:
        w = torch.tensor(tile)
        r = window_rows_plain(w, CAP, TOTAL, ROW_LO)
        out[r] = reference_encoder_layer(
            out[r], kvf[r] if cross else None, None, None, flat(qm)[w],
            flat(km)[w] if cross else None, _t(pos).bfloat16(), _port(p), H,
            TAU_MIN_FULL, cross)
    assert len(tiles) == int((qm > 0).any(-1).sum()) < B * CAP
    assert torch.equal(out.reshape(full.shape), full)


# ---------------------------------------------------------------------------
# K12: one bucket plan straight in the padded carrier
# ---------------------------------------------------------------------------

GH, GW = 32, 40        # the grid; its padded carrier is [B, 48, 48, C]
HP2, WP = 48, 48
K12_CASES = [('full', False), ('full', True), ('small', False),
             ('small', True), ('mid', False), ('mid', True)]


def _kid(case):
    bucket, cross = case
    return f'{bucket}-{_mode(cross)}'


def _grid_occ(rng):
    """Occupancy of a 32x40 grid with sparse, medium and dense windows, so
    that each bucket of caps 16 holds real and dummy slots."""
    occ = rng.rand(B, GH, GW) < 0.03
    occ[:, 2:9, 3:10] |= rng.rand(B, 7, 7) < 0.8
    occ[:, 10:32, 12:40] = True
    occ[:, 22:30, 1:9] |= rng.rand(B, 8, 8) < 0.5
    return occ


def _mixed_plan(bucket, cross, rng):
    """The torch plan of one bucket of a 32x40 grid (caps 16), with every
    third real slot made non-live (its query mask zeroed) and, at S = 16,
    one more where that is needed for a partial last tile of live windows.
    Returns (torch plan, the same plan as numpy arrays for JAX)."""
    occ = _grid_occ(rng)
    kocc = _grid_occ(rng) if cross else None
    tb = toc.build_bucketed_compact_info(
        _t(occ), 8, False, 16, 16, (GH, GW),
        kv_occ=None if kocc is None else _t(kocc), small_tokens=16,
        mid_cap=16, mid_tokens=48)
    ci = getattr(tb, bucket)
    qmask = ci.qmask.clone()
    real = ci.valid.nonzero()
    qmask[real[1::3, 0], real[1::3, 1]] = 0
    live = (qmask > 0).any(-1)
    if bucket == 'small' and int(live.sum()) % 4 == 0:
        b, j = (int(v) for v in live.nonzero()[-1])
        qmask[b, j] = 0
    ci = type(ci)(**{**vars(ci), 'qmask': qmask})
    return ci


def _jax_plan(ci):
    """The plan's arrays as the JAX kernels read them."""
    arr = lambda a: None if a is None else jnp.asarray(a.numpy())
    return types.SimpleNamespace(**{k: arr(v) for k, v in vars(ci).items()})


@functools.lru_cache(maxsize=None)
def _fused_case(bucket, cross):
    """A padded carrier with random values in every cell (the dummy window
    row too, so a write there would show), the other frame's carrier, a
    mixed plan (live, non-live and dummy slots) and JAX's
    ``encoder_layer_fused_pipelined`` (interpret) on them."""
    rng = np.random.RandomState(90 + 2 * len(bucket) + cross)
    ci = _mixed_plan(bucket, cross, rng)
    sel = bucket != 'full'
    T = ci.sel.shape[-1] if sel else 64
    p = _weights(rng)
    pos = _pos()
    xp = _bf16_np(rng.normal(0, 1, (B, HP2, WP, C)))
    kvp = _bf16_np(rng.normal(0, 1, (B, HP2, WP, C)))
    try:
        jpe.set_interpret(True)
        want = jpe.encoder_layer_fused_pipelined(
            jnp.asarray(xp, jnp.bfloat16),
            jnp.asarray(kvp, jnp.bfloat16) if cross else None, _jax_plan(ci),
            jnp.asarray(pos, jnp.bfloat16), *_jparams(p), nhead=H,
            tau_min=_tau_min(T), cross=cross, window=8, sel=sel)
    finally:
        jpe.set_interpret(False)
    return ci, T, xp, kvp, pos, p, np.asarray(want.astype(jnp.float32))


def _fused_plain(case, ci=None, xp=None, params=None):
    """The K12 wrapper on CPU tensors, i.e. its plain version, on a copy of
    the carrier (``xp``: another carrier), with prepared weights."""
    bucket, cross = case
    ci0, T, xp0, kvp, pos, p, _ = _fused_case(*case)
    return encoder_layer_fused_pipelined(
        _t(xp0 if xp is None else xp).bfloat16(),
        _t(kvp).bfloat16() if cross else None, ci0 if ci is None else ci,
        _t(pos).bfloat16(),
        TiledWeights(_port(p), H) if params is None else params, nhead=H,
        tau_min=_tau_min(T), cross=cross, window=8, sel=bucket != 'full')


def _cells(ci, T):
    """The cells each slot's layer reads: cell i at T = 64, else sel."""
    return (ci.sel if T != 64 else
            torch.arange(64).expand(*ci.idx.shape[:2], 64))


def _inside(ci, mask=None):
    """Carrier cells [B, Hp2, Wp] of the plan's real windows (``mask``
    [B, cap]: of those slots only)."""
    real = plan_real_plain(ci.idx, HP2, WP)
    if mask is not None:
        real = real & mask
    rows = plan_cells_plain(ci.idx, torch.arange(64).expand(
        *ci.idx.shape[:2], 64), HP2, WP)[real]
    m = torch.zeros(B * HP2 * WP, dtype=torch.bool)
    m[rows.reshape(-1)] = True
    return m.reshape(B, HP2, WP).numpy()


@pytest.mark.parametrize('bucket', ['full', 'small', 'mid'])
def test_pallas_fused_on_non_live_and_outside_cells(bucket):
    """The premises of K12's pre-pass and its in-place write: JAX's
    ``encoder_layer_fused_pipelined`` at T = 64 writes exactly 0 on all 64
    cells of a real plan window without an occupied query cell; at S = 16,
    48 it leaves such a window, and every cell of a live window that is not
    an occupied selected one, bit for bit; and it leaves every cell outside
    the plan's real windows above the dummy row bit for bit."""
    for cross in (False, True):
        ci, T, xp, _, _, _, want = _fused_case(bucket, cross)
        real = plan_real_plain(ci.idx, HP2, WP)
        live = (ci.qmask > 0).any(-1)
        dead = (real & ~live).numpy()
        assert dead.sum() >= 2 and (~real).any() and live.any()
        cells_dead = _inside(ci, torch.from_numpy(dead))
        if T == 64:
            assert (xp[cells_dead] != 0).all()
            assert not want[cells_dead].any()
        else:
            np.testing.assert_array_equal(want[cells_dead], xp[cells_dead])
            written = np.zeros((B, HP2, WP), bool)
            rows = plan_cells_plain(ci.idx, ci.sel, HP2, WP)[ci.qmask > 0]
            written.reshape(-1)[rows.numpy()] = True
            keep = _inside(ci) & ~written
            assert keep.any() and written.any()
            np.testing.assert_array_equal(want[keep], xp[keep])
        above = ~_inside(ci)
        above[:, HP2 - 8:] = False
        np.testing.assert_array_equal(want[above], xp[above])


@pytest.mark.parametrize('case', K12_CASES, ids=_kid)
def test_plain_fused_on_mixed_plan_matches_pallas(case):
    """Plain K12 against ``encoder_layer_fused_pipelined`` (interpret) on a
    plan of live, non-live and dummy slots: on the cells of the plan's real
    windows max |diff| <= 0.06 and mean <= 2e-3 (K3/K4's CPU limit); every
    other cell above the dummy row bit-equal on both sides and to the input;
    the port leaves the dummy window row as it was (the JAX kernel writes
    dummy slots there)."""
    ci, T, xp, kvp, pos, p, want = _fused_case(*case)
    got = _fused_plain(case).float().numpy()
    inside = _inside(ci)
    err = np.abs(got - want)[inside]
    assert err.max() <= 0.06 and err.mean() <= 2e-3, (err.max(), err.mean())
    real_rows = HP2 - 8
    outside = ~inside[:, :real_rows]
    np.testing.assert_array_equal(got[:, :real_rows][outside],
                                  want[:, :real_rows][outside])
    np.testing.assert_array_equal(got[:, :real_rows][outside],
                                  xp[:, :real_rows][outside])
    np.testing.assert_array_equal(got[:, real_rows:], xp[:, real_rows:])


@pytest.mark.parametrize('bucket', ['full', 'small', 'mid'])
def test_plan_cells_plain_addresses_as_the_gather(bucket):
    """K12's carrier addressing: the cells ``plan_cells_plain`` names for
    each real slot are the window the plain gather reads for it, cell by
    cell (all 64, and the selected ones at S = 16, 48); a dummy slot names
    no cell (-1 throughout), where the gather gives zeros."""
    ci, T, xp, _, _, _, _ = _fused_case(bucket, False)
    x = _t(xp).bfloat16()
    win = toc.gather_windows_padded_plain(x, ci.idx, 8)
    real = plan_real_plain(ci.idx, HP2, WP)
    assert torch.equal(real, ci.valid)
    cells = plan_cells_plain(ci.idx, torch.arange(64).expand(
        *ci.idx.shape[:2], 64), HP2, WP)
    flat = x.reshape(-1, C)
    assert torch.equal(flat[cells[real]], win[real])
    assert (cells[~real] == -1).all() and not win[~real].any()
    if T != 64:
        sc = plan_cells_plain(ci.idx, ci.sel, HP2, WP)
        picked = torch.gather(win, 2, ci.sel.long()[..., None].expand(
            *ci.sel.shape, C))
        assert torch.equal(flat[sc[real]], picked[real])


@pytest.mark.parametrize('case', K12_CASES, ids=_kid)
def test_plain_fused_over_live_tiles_equals_all_slots(case):
    """The plan, on the plain version: the pre-pass (at T = 64 zeros on the
    carrier cells of each real slot without a query; at S = 16, 48 nothing;
    never a dummy slot), then the layer on each tile of live windows (four
    at S = 16, one at S = 48 and T = 64), each window's cells found through
    ``plan_cells_plain`` and written back there; this equals the plain K12
    over all slots bit for bit, with a partial last tile at S = 16."""
    bucket, cross = case
    ci, T, xp, kvp, pos, p, _ = _fused_case(*case)
    full = _fused_plain(case)
    out = _t(xp).bfloat16().reshape(-1, C)
    kvf = _t(kvp).bfloat16().reshape(-1, C)
    cap = ci.idx.shape[1]
    real = plan_real_plain(ci.idx, HP2, WP).reshape(-1)
    qm = ci.qmask.reshape(B * cap, T)
    cells = plan_cells_plain(ci.idx, torch.arange(64).expand(B, cap, 64),
                             HP2, WP).reshape(B * cap, 64)
    dead = real & ~(qm > 0).any(-1)
    if T == 64:
        out[cells[dead].reshape(-1)] = 0
    flat = lambda a: None if a is None else a.reshape(B * cap, -1)
    sel = bucket != 'full'
    sq, sk = flat(ci.sel if sel else None), flat(ci.ksel if sel else None)
    km = flat(ci.kmask) if cross else None
    tiles = tile_plan_plain(live_windows_plain(qm * real[:, None]), T)
    for tile in tiles:
        w = torch.tensor(tile)
        r = cells[w]
        out[r] = reference_encoder_layer(
            out[r], kvf[r] if cross else None,
            None if sq is None else sq[w],
            None if sk is None or not cross else sk[w], qm[w],
            None if km is None else km[w], _t(pos).bfloat16(), _port(p), H,
            _tau_min(T), cross)
    if T == 16:
        assert 0 < len(tiles[-1]) < 4  # a partial last tile
    assert sum(map(len, tiles)) == int(((qm > 0).any(-1) & real).sum())
    assert sum(map(len, tiles)) < int(real.sum())  # non-live slots skipped
    assert torch.equal(out.reshape(full.shape), full)


# ---------------------------------------------------------------------------
# A served layer's weights, prepared once per forward
# ---------------------------------------------------------------------------


def _master_weights(seed, width=C):
    """17 f32 layer tensors in LayerParams order (Linear [out, in])."""
    rng = np.random.RandomState(seed)
    f = 2 * width
    shapes = dict(wq=(width, width), wk=(width, width), wv=(width, width),
                  wo=(width, width), f1w=(f, width), f2w=(width, f),
                  f1b=(f,), tau=(1,))
    return [torch.from_numpy(rng.normal(
        0, 1, shapes.get(k, (width,))).astype(np.float32))
            for k in LayerParams._fields]


@pytest.mark.parametrize('width', [128, 256, 32])
def test_tiled_weights_on_cpu_hold_todays_params(width):
    """On the CPU the prepared weights hold what the plain versions took
    before (``kernel_params`` of the 17 f32 tensors: bf16 matrices, f32
    vectors), bit for bit, at any width (the mini configs' too)."""
    ws = _master_weights(width, width)
    tw = TiledWeights(ws, 8)
    want = kernel_params(ws)
    assert tw.width == width and tw.ffn == 2 * width and tw.ptrs is None
    for name, a, b in zip(LayerParams._fields, tw.params, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize('width', [128, 256])
def test_pack_panels_plain_layout(width):
    """The plain panels: the six matrices rounded to bf16 (as ``.to(torch.
    bfloat16)`` rounds, to nearest even), 16 KiB panels of 128 output rows
    by 64 input columns in stream order (q, k, v, o, FFN 1, FFN 2; pass by
    pass, panels along the input), element (n, k) of a panel at ((n // 8) *
    8 + k // 8) * 64 + (n % 8) * 8 + k % 8: 8 C^2 values."""
    p = LayerParams(*_master_weights(5, width))
    panels = pack_panels_plain(p)
    assert panels.dtype == torch.bfloat16 and panels.numel() == 8 * width ** 2
    n = torch.arange(128)[:, None]
    k = torch.arange(64)[None, :]
    at = ((n // 8) * 8 + k // 8) * 64 + (n % 8) * 8 + k % 8
    q = 0
    for name in MATRICES:
        w = getattr(p, name).to(torch.bfloat16)
        out, inp = w.shape
        for ps in range(out // 128):
            for kq in range(inp // 64):
                panel = panels[q * 8192:(q + 1) * 8192]
                block = w[128 * ps:128 * ps + 128, 64 * kq:64 * kq + 64]
                assert torch.equal(panel[at], block), (name, ps, kq)
                q += 1
    assert q * 8192 == panels.numel()


def _todays_forward(layer, xp, kvp, plan, fused):
    """A served layer's eval forward as it ran before its weights were
    prepared once per forward: ``kernel_params`` handed to each bucket
    call."""
    p = kernel_params(layer.layer_weights())
    cross = layer.cross
    kw = dict(nhead=layer.nhead, tau_min=layer.tau_min, cross=cross)
    if fused:
        for si in (plan.small, plan.mid):
            if si.idx.shape[1]:
                xp = encoder_layer_fused_pipelined(
                    xp, kvp, si, layer.pos, p, sel=True, window=8, **kw)
        return encoder_layer_fused_pipelined(
            xp, kvp, plan.full, layer.pos, p, sel=False, window=8, **kw)
    xw = toc.gather_windows_padded(xp, plan.cat_idx, 8)
    kv = toc.gather_windows_padded(kvp, plan.cat_idx, 8) if cross else None
    lo = 0
    for si in (plan.small, plan.mid):
        xw = encoder_layer_rows_sel(
            xw, kv, si.sel, si.ksel if cross else si.sel, si.qmask,
            si.kmask if cross else si.qmask, layer.pos, p, row_lo=lo, **kw)
        lo += si.idx.shape[1]
    ci = plan.full
    xw = encoder_layer_rows_full(xw, kv, ci.qmask,
                                 ci.kmask if cross else ci.qmask, layer.pos,
                                 p, row_lo=lo, **kw)
    return toc.scatter_windows_into_padded(xw, plan.cat_idx, xp, 8)


@pytest.mark.parametrize('fused', [False, True], ids=['default', 'fused'])
@pytest.mark.parametrize('cross', [False, True], ids=_mode)
def test_served_layer_prepared_weights_equal_todays(monkeypatch, fused,
                                                    cross):
    """A served layer (C = 128, 8 heads, FFN 256) in eval mode, through
    the weights it prepares once per forward, on the default (gather, K4,
    K3, scatter) and the fused (K12 per bucket) path, self and cross: the
    same carrier bit for bit as with ``kernel_params`` handed to each bucket
    call (plain versions on the CPU)."""
    from tmae_tpu_torch.models import sst

    monkeypatch.setattr(sst, '_FUSED_INPLACE', fused)
    torch.manual_seed(3)
    layer = DenseEncoderLayer(C, H, F, 8, 0.01, cross).eval()
    rng = np.random.RandomState(7)
    occ = torch.from_numpy(_grid_occ(rng))
    kocc = torch.from_numpy(_grid_occ(rng))
    plan = build_plans(occ, 8, OccCaps(16, 16, 16, 16, 48),
                       kv_occ=kocc if cross else None)[0]
    x = torch.from_numpy(np.where(occ[..., None].numpy(), rng.normal(
        size=(B, GH, GW, C)), 0).astype(np.float32)).bfloat16()
    kvx = torch.from_numpy(rng.normal(size=(B, GH, GW, C)).astype(
        np.float32)).bfloat16()
    xp = toc.pad_grid(x, 8, False)
    kvp = toc.pad_grid(kvx, 8, False) if cross else None
    with torch.no_grad():
        got = layer(xp.clone(), kvp, plan)
        want = _todays_forward(layer, xp.clone(), kvp, plan, fused)
    assert torch.equal(got, want)
    assert not torch.equal(got, xp)
