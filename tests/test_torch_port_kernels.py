"""Kernel modules of the PyTorch port (tmae_tpu_torch) against the JAX
package on the CPU: the plain versions of K1-K5, the window plans, the host
voxelizer and the positional embedding, on the same numpy inputs. The JAX
side runs its Pallas kernels in interpret mode where it has one, or its jnp
reference. Tolerances are stated beside each comparison."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.ops import occ_compact as joc
from tmae_tpu.ops import pallas_encoder as jpe
from tmae_tpu.ops import sorted_segments as jss
from tmae_tpu.ops.dense_windows import slot_pos_embed as j_slot_pos_embed
from tmae_tpu.ops.voxelize import VoxelSpec as JVoxelSpec
from tmae_tpu.ops.voxelize import segment_max as j_segment_max
from tmae_tpu.ops.voxelize import voxelize_host as j_voxelize_host
from tmae_tpu_torch.ops import occ_compact as toc
from tmae_tpu_torch.ops.dense_windows import slot_pos_embed
from tmae_tpu_torch.ops.encoder_layer import (LayerParams,
                                              encoder_layer_rows_full,
                                              encoder_layer_rows_sel)
from tmae_tpu_torch.ops.sorted_segments import sorted_segment_max
from tmae_tpu_torch.ops.voxelize import VoxelSpec, segment_max, voxelize_host

REPO = Path(__file__).resolve().parent.parent


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_np(a):
    """Round f32 values to bf16 (as numpy f32) so both sides see equal
    inputs."""
    return torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16).float().numpy()


# ---------------------------------------------------------------------------
# K3 / K4: encoder layer on window rows
# ---------------------------------------------------------------------------


def _layer_params(rng, C, F):
    def lin(i, o):
        return (rng.normal(0, 1, (i, o)) / np.sqrt(i)).astype(np.float32)

    def vec(n, s=0.1, m=0.0):
        return (m + s * rng.normal(size=(n,))).astype(np.float32)

    return dict(wq=lin(C, C), bq=vec(C), wk=lin(C, C), bk=vec(C),
                wv=lin(C, C), bv=vec(C), wo=lin(C, C), bo=vec(C),
                tau=np.asarray([0.7], np.float32), ln1s=vec(C, m=1.0),
                ln1b=vec(C), f1w=lin(C, F), f1b=vec(F), f2w=lin(F, C),
                f2b=vec(C), ln2s=vec(C, m=1.0), ln2b=vec(C))


def _port_params(p):
    w = lambda k: _t(p[k].T.copy()).to(torch.bfloat16)
    f = lambda k: _t(p[k])
    return LayerParams(w('wq'), f('bq'), w('wk'), f('bk'), w('wv'), f('bv'),
                       w('wo'), f('bo'), f('tau'), f('ln1s'), f('ln1b'),
                       w('f1w'), f('f1b'), w('f2w'), f('f2b'), f('ln2s'),
                       f('ln2b'))


def _rows_inputs(rng, B, total, cap, C, S):
    """Window rows with zeros at unoccupied cells, masks with some windows
    that have no key at all, and occupied-first cell selections."""
    occ = rng.rand(B, cap, 64) < rng.uniform(0.05, 0.6, (B, cap, 1))
    occ[:, ::5] = False           # windows with no occupied cell (no key)
    kocc = rng.rand(B, cap, 64) < 0.3
    kocc[:, 1::4] = False         # cross: windows empty in the other frame
    xw = _bf16_np(rng.normal(0, 1, (B, total, 64, C)).astype(np.float32))
    kv = _bf16_np(rng.normal(0, 1, (B, total, 64, C)).astype(np.float32))
    if S is None:
        return xw, kv, None, None, occ.astype(np.float32), \
            kocc.astype(np.float32)

    def select(o):
        key = o * (64 - np.arange(64))
        sel = np.argsort(-key, axis=-1, kind='stable')[..., :S]
        return sel.astype(np.int32), np.take_along_axis(o, sel, -1)

    sel_q, qm = select(occ[..., :])
    sel_k, km = select(kocc)
    return xw, kv, sel_q, sel_k, qm.astype(np.float32), km.astype(np.float32)


ROW_CASES = [
    (128, None, False), (128, None, True), (128, 16, False), (128, 16, True),
    (128, 48, True), (256, None, True), (256, 16, False), (256, 48, False),
    (256, 48, True),
]


@pytest.mark.parametrize('C,S,cross', ROW_CASES)
def test_encoder_rows_plain_matches_pallas_interpret(C, S, cross):
    """K3 (S None) / K4 plain version vs the JAX row kernels in interpret
    mode: C=128 (head width 16) and C=256 (head width 32), self and cross,
    row_lo=16. Both run bf16 matmul inputs with f32 accumulation; outputs
    are bf16 and may differ by a rounding flip of an intermediate bf16 cast,
    so the bound is 0.06 absolute on LayerNorm-scale values with a mean
    below 2e-3."""
    rng = np.random.RandomState(C + (S or 64) + int(cross))
    B, cap, row_lo, H = 1, 16, 16, 8
    total = row_lo + cap + 16
    F = 2 * C
    xw, kv, sel_q, sel_k, qm, km = _rows_inputs(rng, B, total, cap, C, S)
    p = _layer_params(rng, C, F)
    pos = _bf16_np(np.asarray(j_slot_pos_embed(8, C)))
    jparams = [jnp.asarray(p[k]) for k in LayerParams._fields]
    jx = jnp.asarray(xw, jnp.bfloat16)
    jkv = jnp.asarray(kv, jnp.bfloat16) if cross else None
    kw = dict(nhead=H, tau_min=0.01, cross=cross, row_lo=row_lo)
    try:
        jpe.set_interpret(True)
        if S is None:
            ref = jpe.encoder_layer_rows_full(
                jx, jkv, jnp.asarray(qm), jnp.asarray(km),
                jnp.asarray(pos, jnp.bfloat16), *jparams, **kw)
        else:
            ref = jpe.encoder_layer_rows_sel(
                jx, jkv, jnp.asarray(sel_q), jnp.asarray(sel_k),
                jnp.asarray(qm), jnp.asarray(km),
                jnp.asarray(pos, jnp.bfloat16), *jparams, **kw)
    finally:
        jpe.set_interpret(False)
    ref = np.asarray(ref, np.float32)

    tx = _t(xw).to(torch.bfloat16)
    tkv = _t(kv).to(torch.bfloat16) if cross else None
    tpos = _t(pos).to(torch.bfloat16)
    pp = _port_params(p)
    if S is None:
        got = encoder_layer_rows_full(tx, tkv, _t(qm), _t(km), tpos, pp, **kw)
    else:
        got = encoder_layer_rows_sel(tx, tkv, _t(sel_q), _t(sel_k), _t(qm),
                                     _t(km), tpos, pp, **kw)
    got = got.float().numpy()
    # rows outside [row_lo, row_lo + cap) are untouched on both sides
    np.testing.assert_array_equal(got[:, :row_lo], xw[:, :row_lo])
    np.testing.assert_array_equal(got[:, row_lo + cap:], xw[:, row_lo + cap:])
    err = np.abs(got - ref)
    assert err.max() <= 0.06, err.max()
    assert err.mean() <= 2e-3, err.mean()


# ---------------------------------------------------------------------------
# K1 / K2: window gather and scatter against the padded carrier
# ---------------------------------------------------------------------------


def _plan(rng, B, H, W, shift, cap):
    occ = rng.rand(B, H, W) < 0.08
    idx, valid, n = joc.occupied_window_indices(jnp.asarray(occ), 8, shift,
                                                cap)
    idx = np.asarray(idx)
    assert (~np.asarray(valid)).any(), 'the plan must hold dummy slots'
    return occ, idx


@pytest.mark.parametrize('shift', [False, True])
def test_window_gather_scatter_plain_matches_jax(shift):
    """K1/K2 plain versions vs the JAX jnp references (exact) and vs the
    BlockSpec Pallas kernels in interpret mode (the multi-DMA kernels have
    no interpret mode). Dummy slots: the gather gives zeros; the scatter
    leaves the dummy window row alone, as the jnp reference does, while the
    interpret-mode BlockSpec scatter writes it, so that comparison covers
    the real rows only."""
    rng = np.random.RandomState(7 + int(shift))
    B, H, W, C, cap = 2, 20, 27, 16, 16
    occ, idx = _plan(rng, B, H, W, shift, cap)
    x = np.where(occ[..., None], rng.normal(0, 1, (B, H, W, C)), 0.0)
    x = _bf16_np(x.astype(np.float32))
    jxp = joc.pad_grid(jnp.asarray(x, jnp.bfloat16), 8, shift)
    txp = toc.pad_grid(_t(x).to(torch.bfloat16), 8, shift)
    np.testing.assert_array_equal(txp.float().numpy(),
                                  np.asarray(jxp, np.float32))
    tidx = _t(idx)

    got = toc.gather_windows_padded(txp, tidx, 8).float().numpy()
    want = np.asarray(joc._gather_ref_padded(jxp, jnp.asarray(idx), 8),
                      np.float32)
    np.testing.assert_array_equal(got, want)
    try:
        joc.set_interpret(True)
        want_k = np.asarray(joc.gather_windows_padded(jxp, jnp.asarray(idx),
                                                      8), np.float32)
    finally:
        joc.set_interpret(False)
    np.testing.assert_array_equal(got, want_k)

    xw = _bf16_np(rng.normal(0, 1, got.shape).astype(np.float32))
    init = _bf16_np(rng.normal(0, 1, txp.shape).astype(np.float32))
    got_s = toc.scatter_windows_into_padded(
        _t(xw).to(torch.bfloat16), tidx, _t(init).to(torch.bfloat16).clone(),
        8).float().numpy()
    want_s = np.asarray(joc._scatter_into_ref_padded(
        jnp.asarray(xw, jnp.bfloat16), jnp.asarray(idx),
        jnp.asarray(init, jnp.bfloat16), 8), np.float32)
    np.testing.assert_array_equal(got_s, want_s)
    try:
        joc.set_interpret(True)
        want_sk = np.asarray(joc.scatter_windows_into_padded(
            jnp.asarray(xw, jnp.bfloat16), jnp.asarray(idx),
            jnp.asarray(init, jnp.bfloat16), 8), np.float32)
    finally:
        joc.set_interpret(False)
    real = init.shape[1] - 8
    np.testing.assert_array_equal(got_s[:, :real], want_sk[:, :real])


def test_repad_grid_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.normal(0, 1, (2, 20, 27, 4)).astype(np.float32)
    for fs, ts in ((False, True), (True, False)):
        jp = joc.repad_grid(joc.pad_grid(jnp.asarray(x), 8, fs), 8, fs, ts)
        tp = toc.repad_grid(toc.pad_grid(_t(x), 8, fs), 8, fs, ts)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(
            toc.unpad_grid(tp, (20, 27), 8, ts).numpy(),
            np.asarray(joc.unpad_grid(jp, (20, 27), 8, ts)))


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


def _clustered_occ(rng, B, H, W):
    """Occupancy with sparse, medium and dense windows, so the small, mid
    and full buckets are all populated."""
    occ = rng.rand(B, H, W) < 0.03
    occ[:, 2:8, 3:9] |= rng.rand(B, 6, 6) < 0.9     # ~32 cells
    occ[:, 9:27, 14:32] = True                      # full windows
    occ[:, 20:27, 2:10] |= rng.rand(B, 7, 8) < 0.5  # mid windows
    return occ


@pytest.mark.parametrize('cross', [False, True])
def test_bucketed_plans_match_jax(cross):
    """``build_bucketed_compact_info``: equal idx, cell selections, masks,
    cat_idx (small, mid, full order) and overflow counts, both shifts. The
    caps are small enough that some buckets overflow."""
    rng = np.random.RandomState(11 + int(cross))
    B, H, W = 2, 30, 36
    occ = _clustered_occ(rng, B, H, W)
    kocc = _clustered_occ(rng, B, H, W) if cross else None
    for shift in (False, True):
        jb = joc.build_bucketed_compact_info(
            jnp.asarray(occ), 8, shift, 16, 16, (H, W),
            kv_occ=None if kocc is None else jnp.asarray(kocc),
            small_tokens=16, mid_cap=16, mid_tokens=48)
        tb = toc.build_bucketed_compact_info(
            _t(occ), 8, shift, 16, 16, (H, W),
            kv_occ=None if kocc is None else _t(kocc),
            small_tokens=16, mid_cap=16, mid_tokens=48)
        np.testing.assert_array_equal(tb.cat_idx.numpy(),
                                      np.asarray(jb.cat_idx))
        for name in ('small', 'mid'):
            jp, tp = getattr(jb, name), getattr(tb, name)
            assert int(np.asarray(jp.n_windows).sum()) > 0
            for f in ('idx', 'valid', 'sel', 'qmask', 'n_windows') + (
                    ('ksel', 'kmask') if cross else ()):
                np.testing.assert_array_equal(
                    getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                    err_msg=f'{name}.{f}')
        assert int(np.asarray(jb.full.n_occupied).sum()) > 0
        for f in ('idx', 'valid', 'qmask', 'n_occupied') + (
                ('kmask',) if cross else ()):
            np.testing.assert_array_equal(getattr(tb.full, f).numpy(),
                                          np.asarray(getattr(jb.full, f)))
        np.testing.assert_array_equal(tb.overflow().numpy(),
                                      np.asarray(jb.overflow()))
        ji, jv, jn = joc.occupied_window_indices(jnp.asarray(occ), 8, shift,
                                                 32)
        ti, tv, tn = toc.occupied_window_indices(_t(occ), 8, shift, 32)
        for t_, j_ in ((ti, ji), (tv, jv), (tn, jn)):
            np.testing.assert_array_equal(t_.numpy(), np.asarray(j_))


def test_voxelize_host_byte_identical():
    """The port's numpy voxelizer gives byte-identical arrays, including
    points out of range, padding and a voxel cap below the pillar count."""
    rng = np.random.RandomState(5)
    B, Pn = 2, 600
    pts = rng.uniform(-6.0, 6.0, (B, Pn, 4)).astype(np.float32)
    mask = rng.rand(B, Pn) < 0.9
    kw = dict(pc_range=(-5.12, -5.12, -5.0, 5.12, 5.12, 3.0),
              voxel_size=(0.32, 0.32, 8.0), max_points=Pn, max_voxels=200)
    for sort in (False, True):
        want = j_voxelize_host(pts, mask, JVoxelSpec(**kw), sort_points=sort)
        got = voxelize_host(pts, mask, VoxelSpec(**kw), sort_points=sort)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), k


def test_slot_pos_embed_matches_jax():
    """f32 sin/cos of two libraries: within 1e-6."""
    for C in (16, 128, 256):
        np.testing.assert_allclose(slot_pos_embed(8, C).numpy(),
                                   np.asarray(j_slot_pos_embed(8, C)),
                                   atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# K5: sorted segment max
# ---------------------------------------------------------------------------


def test_sorted_segment_max_plain_matches_pallas_interpret():
    """K5 plain version vs the JAX scan kernel in interpret mode (block 1024,
    so segments span blocks), with empty pillars and out-of-range rows;
    a max is exact, so the results are equal. The scatter path
    (``segment_max`` on unsorted rows) agrees as well."""
    rng = np.random.RandomState(9)
    B, Pn, V, C = 2, 2048, 96, 8
    feats, segs, ends, masks = [], [], [], []
    for _ in range(B):
        n = 80                               # present pillars 0..n-1
        counts = rng.randint(1, 40, n)
        counts[5] = 1500                     # one pillar spans a block edge
        counts = counts[np.cumsum(counts) <= Pn - 7]
        nseg = len(counts)
        nv = int(counts.sum())
        seg = np.full(Pn, V, np.int32)       # out-of-range rows at the end
        seg[:nv] = np.repeat(np.arange(nseg), counts)
        end = np.zeros(V, np.int32)
        end[:nseg] = np.cumsum(counts) - 1
        m = np.zeros(V, bool)
        m[:nseg] = True
        feats.append(rng.normal(0, 1, (Pn, C)).astype(np.float32))
        segs.append(seg)
        ends.append(end)
        masks.append(m)
    feat, seg, end, msk = map(np.stack, (feats, segs, ends, masks))
    try:
        jss.set_interpret(True)
        want = np.asarray(jss.sorted_segment_max(
            jnp.asarray(feat), jnp.asarray(seg), jnp.asarray(end),
            jnp.asarray(msk), V))
    finally:
        jss.set_interpret(False)
    got = sorted_segment_max(_t(feat), _t(seg), _t(end), _t(msk), V).numpy()
    np.testing.assert_array_equal(got, want)

    perm = rng.permutation(Pn)
    want_sc = np.asarray(j_segment_max(jnp.asarray(feat[:, perm]),
                                       jnp.asarray(seg[:, perm]), V))
    got_sc = segment_max(_t(feat[:, perm]), _t(seg[:, perm]), V).numpy()
    np.testing.assert_array_equal(got_sc, want_sc)


# ---------------------------------------------------------------------------
# Package rules
# ---------------------------------------------------------------------------


def test_port_imports_no_jax():
    """Static scan (this image imports jax at interpreter start, so a
    sys.modules check could not tell): no module of the port imports jax,
    flax or the JAX package, nor do chip_smoke.py and the two test modules
    it loads, which import no other module of the tests."""
    banned = ('jax', 'flax', 'tmae_tpu')
    offenders = []
    # chip_smoke.py also loads the overfit oracle's port test and its
    # fixture, and of the tests nothing else
    smoke_tests = [REPO / 'tests/test_torch_port_overfit_ap.py',
                   REPO / 'tests/once_fixture.py']
    files = sorted((REPO / 'tmae_tpu_torch').rglob('*.py')) + [
        REPO / 'chip_smoke.py'] + smoke_tests
    for path in files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            for name in names:
                if name.split('.')[0] in banned or (
                        name.split('.')[0] == 'tests' and name not in (
                            'tests', 'tests.once_fixture',
                            'tests.test_torch_port_overfit_ap')):
                    offenders.append(f'{path.relative_to(REPO)}: {name}')
    assert not offenders, offenders
    assert len(files) > 20
    scanned = {str(f.relative_to(REPO)) for f in files}
    for module in ('optimization', 'trainer', 'checkpoint', 'evaluator'):
        assert f'tmae_tpu_torch/train/{module}.py' in scanned, module
    for module in ('tools/test', 'utils/native', 'datasets/dataset',
                   'datasets/once_temporal', 'datasets/once_eval',
                   'tools/train', 'tools/create_once_infos',
                   'tools/convert_torch_ckpt', 'utils/metrics',
                   'utils/torch_convert', 'datasets/waymo_pb',
                   'datasets/waymo_decode', 'datasets/waymo_temporal',
                   'datasets/waymo_eval', 'tools/create_waymo_infos',
                   'models/graph_rcnn', 'models/roi_head', 'ops/roi_pool',
                   'ops/dcn', 'models/dla', 'models/point_sample',
                   'datasets/image_ops'):
        assert f'tmae_tpu_torch/{module}.py' in scanned, module


def test_build_detector_needs_a_card_by_default(monkeypatch):
    from tmae_tpu_torch.config import cfg_from_yaml_file
    from tmae_tpu_torch.models.detectors import build_detector

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = cfg_from_yaml_file(REPO / 'tools/cfgs/once_models/t_mae.yaml')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        build_detector(cfg)


def test_grid_ops_and_vfe_scatter_path():
    """scatter_to_grid / gather_from_grid / occupancy_grid equal the JAX
    functions exactly; the VFE's scatter path (unsorted points, no
    seg_ends) equals its sorted K5 path on the same pillars (f32, 1e-6)."""
    from tmae_tpu.ops import voxelize as jv
    from tmae_tpu_torch.models.vfe import DynPillarEncoder
    from tmae_tpu_torch.ops import voxelize as tv

    rng = np.random.RandomState(4)
    B, V, C, hw = 2, 40, 5, (12, 9)
    coords = np.stack([rng.randint(0, hw[0], (B, V)),
                       rng.randint(0, hw[1], (B, V))], -1).astype(np.int32)
    coords[:, :, 0] = np.arange(V)[None] % hw[0]          # unique cells
    coords[:, :, 1] = (np.arange(V)[None] // hw[0]) % hw[1]
    mask = rng.rand(B, V) < 0.7
    feat = rng.normal(size=(B, V, C)).astype(np.float32)
    grid = tv.scatter_to_grid(_t(feat), _t(coords), _t(mask), hw)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(
        jv.scatter_to_grid(jnp.asarray(feat), jnp.asarray(coords),
                           jnp.asarray(mask), hw)))
    np.testing.assert_array_equal(
        tv.gather_from_grid(grid, _t(coords), _t(mask)).numpy(),
        np.asarray(jv.gather_from_grid(jnp.asarray(grid.numpy()),
                                       jnp.asarray(coords),
                                       jnp.asarray(mask))))
    np.testing.assert_array_equal(
        tv.occupancy_grid(_t(coords), _t(mask), hw).numpy(),
        np.asarray(jv.occupancy_grid(jnp.asarray(coords), jnp.asarray(mask),
                                     hw)))

    spec = VoxelSpec((-5.12, -5.12, -5.0, 5.12, 5.12, 3.0), (0.32, 0.32, 8.0),
                     512, 128)
    pts = rng.uniform(-5.5, 5.5, (1, 512, 4)).astype(np.float32)
    pmask = rng.rand(1, 512) < 0.9
    hv = voxelize_host(pts, pmask, spec, sort_points=True)
    vox = {k: _t(hv[k]) for k in ('point_voxel', 'point_valid',
                                  'voxel_coords', 'voxel_mask',
                                  'voxel_mean_xyz', 'seg_ends')}
    torch.manual_seed(0)
    enc = DynPillarEncoder(spec, [[8, 16]]).eval()
    with torch.no_grad():
        sorted_out = enc(_t(hv['points']), _t(hv['point_mask']), vox)
        scatter_vox = {k: v for k, v in vox.items()
                       if k not in ('voxel_mean_xyz', 'seg_ends')}
        scatter_out = enc(_t(hv['points']), _t(hv['point_mask']),
                          scatter_vox)
    np.testing.assert_allclose(scatter_out['voxel_features'].numpy(),
                               sorted_out['voxel_features'].numpy(),
                               atol=1e-6, rtol=0)
    assert sorted_out['voxel_mask'].sum() > 20
