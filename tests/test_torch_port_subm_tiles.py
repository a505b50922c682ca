"""The windowed SubM conv K15 and the unpadded scatter-into K13c as the
card runs them (``csrc/subm_conv.cu``, ``csrc/windows.cu``), on the CPU.

On the card K15 packs its weights into wgmma panels, flags the live slots
(a window of the partition with a query cell; every other slot gets
zeros), and runs tiles of two live windows whose 3x3 taps are read straight
out of each window's 10x10 halo, held in core-matrix order
[Cin / 8][100 cells][8]. K13c builds a map of the plan's slots over the
windows of the shift's partition and writes the unpadded grid in one pass,
each window's cells from its slot or from ``init``. Here:

* (a) the torch emulation of K15's addressing (``subm_conv_tiles_plain``)
  equals the JAX package's ``_subm_conv_pallas`` in interpret mode and
  ``_subm_conv_ref`` at Cin = Cout = 128, on a small grid whose windows all
  touch an edge, with dummy slots and query-less real slots;
* (b) the panel layout (``subm_panels_plain``) of a ``wmat`` unpacks back
  to it, element by element from the layout's formula;
* (c) the torch emulation of K13c's map and pass (``slot_map_plain``,
  ``scatter_into_grid_plain``) equals ``_scatter_into_pallas`` in
  interpret mode and ``_scatter_into_ref`` bit for bit, shifted and not,
  with dummy slots and occupied windows the plan leaves out;
* (d) the premises: a plan names each window at most once (so K13c's map
  is well defined), and a dummy slot's qmask is 0.

Inputs are made from a seed with numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_kernels import _bf16_np, _t
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.ops import occ_compact as joc
from tmae_tpu.ops import sparse_conv as jsc
from tmae_tpu_torch.ops import occ_compact as toc
from tmae_tpu_torch.ops import sparse_conv as tsc

B, H, W = 2, 20, 24  # 3 x 3 windows on the grid: each touches an edge


@pytest.fixture
def interpret():
    """The JAX package's Pallas kernels in interpret mode, reset after."""
    for m in (joc, jsc):
        m.set_interpret(True)
    yield
    for m in (joc, jsc):
        m.set_interpret(False)


def _occ(rng, density=0.3):
    occ = rng.rand(B, H, W) < density
    occ[0, 0, 0] = occ[1, H - 1, W - 1] = True  # corner windows occupied
    return occ


def _tb(a):
    return _t(a).to(torch.bfloat16)


def _f(a):
    return (a.detach().float().numpy() if torch.is_tensor(a)
            else np.asarray(a, np.float32))


def _bits(a):
    return a.view(torch.int16).numpy() if torch.is_tensor(a) else \
        np.asarray(a).view(np.int16)


# ---------------------------------------------------------------------------
# (a) K15's addressing
# ---------------------------------------------------------------------------


def test_subm_conv_tiles_matches_jax(interpret):
    """``subm_conv_tiles_plain`` (halo in core-matrix order, each tap's A
    read at cell offset ky 10 + kx with strides 10 and 100 cells, panels
    unpacked, f32 sums) against JAX's K15 in interpret mode (compact
    windows) and its dense reference (after the plain scatter), Cin = Cout
    = 128, bf16 inputs; a plan of cap 16 (dummy slots) with two real slots'
    qmask zeroed (query-less). Every side sums the same 9 Cin f32 products
    in its own order and rounds once to bf16: one bf16 rounding step (rtol
    2^-7, atol 1e-3). Slots that are not live are exactly 0; the live
    windows agree with the port's plain version to the same bound."""
    rng = np.random.RandomState(0)
    C = 128
    occ = _occ(rng)
    x = np.where(occ[..., None], _bf16_np(rng.normal(size=(B, H, W, C))),
                 0.0).astype(np.float32)
    wmat = _bf16_np(rng.normal(size=(3, 3, C, C)) / np.sqrt(9 * C))
    bias = (0.1 * rng.normal(size=C)).astype(np.float32)
    jp = joc.build_compact_info(jnp.asarray(occ), 8, False, 16, (H, W))
    idx = np.asarray(jp.idx)
    qm = np.array(jp.qmask)
    valid = np.asarray(jp.valid)
    assert not valid.all() and valid.sum() >= 6
    real = np.argwhere(valid)
    for b, j in real[[1, -2]]:
        qm[b, j] = 0.0                       # query-less real slots
    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(idx),
             jnp.asarray(qm), jnp.asarray(wmat, jnp.bfloat16),
             jnp.asarray(bias))
    want_w = jsc._subm_conv_pallas(*jargs, (H, W), 8)
    want_d = jsc._subm_conv_ref(*jargs, (H, W), 8)
    targs = (_tb(x), _t(idx), _t(qm), _tb(wmat), _t(bias), 8)
    got = tsc.subm_conv_tiles_plain(*targs)
    tol = dict(rtol=2 ** -7, atol=1e-3)
    live = valid & (qm != 0).any(-1)
    assert live.sum() >= 4 and (valid & ~live).sum() == 2
    assert not _f(got)[~live].any()
    np.testing.assert_allclose(_f(got), _f(want_w), **tol)
    np.testing.assert_allclose(_f(got), _f(tsc.subm_conv_windows_plain(
        *targs)), **tol)
    dense = toc.scatter_windows_plain(got, _t(idx), (H, W), 8, False)
    np.testing.assert_allclose(_f(dense), _f(want_d), **tol)
    assert _f(dense).any()


def test_subm_conv_tiles_schedule():
    """The emulation's live slots are the kernel's: a window of the
    partition (0 <= wy < nwy, 0 <= wx < nwx) with a query cell; a slot
    naming the dummy row or a window off the partition gives zeros even
    with a query, and the result does not depend on the slots' order."""
    rng = np.random.RandomState(1)
    C = 128
    x = _tb(rng.normal(size=(1, 16, 16, C)).astype(np.float32))
    wmat = _tb(rng.normal(size=(3, 3, C, C)).astype(np.float32) / 30)
    bias = _t((0.1 * rng.normal(size=C)).astype(np.float32))
    # 16 x 16: nwy = nwx = 3; (3, 0) is the dummy row, (2, 3) off the
    # partition
    idx = _t(np.array([[[1, 1], [3, 0], [2, 2], [1, 2], [2, 3]]], np.int32))
    qm = torch.ones(1, 5, 64)
    got = tsc.subm_conv_tiles_plain(x, idx, qm, wmat, bias, 8)
    assert all(got[0, j].all(-1).any() for j in (0, 2, 3))
    assert not got[0, 1].any() and not got[0, 4].any()
    perm = torch.tensor([3, 0, 4, 2, 1])
    again = tsc.subm_conv_tiles_plain(x, idx[:, perm], qm, wmat, bias, 8)
    np.testing.assert_array_equal(_bits(again), _bits(got[:, perm]))


# ---------------------------------------------------------------------------
# (b) K15's panel layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('C', [128, 256])
def test_subm_panels_unpack(C):
    """Panel q = (pass 9 + tap) (C / 64) + kq holds element (n, k) =
    wmat[tap, 64 kq + k, 128 pass + n] at ((n // 8) * 8 + k // 8) * 64 +
    (n % 8) * 8 + k % 8: reading every element back by that formula gives
    ``wmat`` bit for bit, and the panels hold each weight once."""
    rng = np.random.RandomState(C)
    wmat = _tb(rng.normal(size=(3, 3, C, C)).astype(np.float32))
    panels = tsc.subm_panels_plain(wmat)
    assert panels.shape == (9 * C * C,) and panels.dtype == torch.bfloat16
    KQ = C // 64
    ps, tap, kq, n, k = np.meshgrid(np.arange(C // 128), np.arange(9),
                                    np.arange(KQ), np.arange(128),
                                    np.arange(64), indexing='ij')
    q = (ps * 9 + tap) * KQ + kq
    at = q * 8192 + ((n // 8) * 8 + k // 8) * 64 + (n % 8) * 8 + k % 8
    assert len(np.unique(at)) == at.size == 9 * C * C
    back = torch.empty(9, C, C, dtype=torch.bfloat16)
    back[tap.ravel(), (64 * kq + k).ravel(), (128 * ps + n).ravel()] = \
        panels[torch.from_numpy(at.ravel())]
    np.testing.assert_array_equal(_bits(back.reshape(3, 3, C, C)),
                                  _bits(wmat))


# ---------------------------------------------------------------------------
# (c) K13c's map and pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('shift', [False, True])
def test_scatter_into_grid_matches_jax(interpret, shift):
    """``scatter_into_grid_plain`` (each cell from its window's slot in the
    map, else from init) against JAX's K13c in interpret mode and
    ``_scatter_into_ref``, bit for bit, and against the port's plain
    version, on a plan of cap 16 (dummy slots) from which every third real
    slot is dropped to the dummy row (occupied windows the plan leaves out
    keep init). The map names every real slot once and nothing else."""
    rng = np.random.RandomState(10 + int(shift))
    C = 16
    occ = _occ(rng, 0.15)
    jp = joc.build_compact_info(jnp.asarray(occ), 8, shift, 16, (H, W))
    idx = np.array(jp.idx)
    valid = np.array(jp.valid)
    nwy, nwx = (H + 7) // 8 + 1, (W + 7) // 8 + 1
    drop = valid & (np.arange(16) % 3 == 0)
    idx[drop] = (nwy, 0)
    valid &= ~drop
    assert drop.any() and valid.any() and (~valid).any()
    xw = _bf16_np(rng.normal(size=(B, 16, 64, C)))
    init = _bf16_np(rng.normal(size=(B, H, W, C)))
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = joc._scatter_into_pallas(jb(xw), jnp.asarray(idx), jb(init), 8,
                                    shift, (H, W))
    ref = joc._scatter_into_ref(jb(xw), jnp.asarray(idx), jb(init), (H, W),
                                8, shift)
    got = toc.scatter_into_grid_plain(_tb(xw), _t(idx), _tb(init), (H, W),
                                      8, shift)
    assert got.is_contiguous() and got.dtype == torch.bfloat16
    for other in (want, ref):
        np.testing.assert_array_equal(_bits(got),
                                      np.asarray(other).view(np.int16))
    np.testing.assert_array_equal(_bits(got), _bits(
        toc.scatter_windows_into_plain(_tb(xw), _t(idx), _tb(init), (H, W),
                                       8, shift)))
    m = toc.slot_map_plain(_t(idx), (H, W), 8).numpy()
    assert m.shape == (B, nwy, nwx)
    named = np.sort(m[m >= 0])
    np.testing.assert_array_equal(named, np.flatnonzero(valid.ravel()))
    for b, j in np.argwhere(valid):
        assert m[b, idx[b, j, 0], idx[b, j, 1]] == b * 16 + j
    # an occupied window left out of the plan keeps init on its cells
    off = 4 if shift else 8
    b, j = np.argwhere(drop)[0]
    wy, wx = np.array(jp.idx)[b, j]
    ys = slice(max(8 * wy - off, 0), min(8 * wy - off + 8, H))
    xs = slice(max(8 * wx - off, 0), min(8 * wx - off + 8, W))
    assert occ[b, ys, xs].any()
    np.testing.assert_array_equal(_f(got)[b, ys, xs], init[b, ys, xs])


# ---------------------------------------------------------------------------
# (d) the premises
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('shift', [False, True])
def test_plans_name_distinct_windows(shift):
    """Every plan the port builds names each window of a sample at most
    once, JAX's and the port's alike (``build_compact_info``, and the
    small, mid and full buckets of ``build_bucketed_compact_info`` taken
    together), and a dummy slot's query mask is 0 (so K15 gives it zeros)."""
    rng = np.random.RandomState(20 + int(shift))
    occ = _occ(rng, 0.2)
    plans = [
        toc.build_compact_info(_t(occ), 8, shift, 16, (H, W)),
        joc.build_compact_info(jnp.asarray(occ), 8, shift, 16, (H, W))]
    bucketed = toc.build_bucketed_compact_info(
        _t(occ), 8, shift, 16, 16, (H, W), small_tokens=8, mid_cap=16,
        mid_tokens=24)
    nwy = (H + 7) // 8 + 1
    for idx, qm in [(np.asarray(p.idx), np.asarray(p.qmask)) for p in plans]\
            + [(bucketed.cat_idx.numpy(), None)]:
        real = idx[..., 0] < nwy
        assert real.any() and (~real).any()
        for b in range(B):
            wins = [tuple(w) for w in idx[b][real[b]]]
            assert len(wins) == len(set(wins))
        if qm is not None:
            assert not qm[~real].any()
