"""BALL_QUERY's one launch for every radius of a grouping against the JAX
package on the CPU.

* ``ball_query_multi`` (on CPU tensors, the plain version of each radius)
  equals JAX's ``ball_query`` radius by radius on the shapes of
  ``test_torch_port_ssd3d``'s ``BQ_CASES``, for nested and for dilated
  radius lists: idx and cnt exactly.
* ``bq_kernel_model``, a numpy model of ``csrc/pointnet2.cu``'s
  ``ball_query_kernel`` (the points padded to a multiple of 16, S
  index-ordered slices of a cluster, each in tiles and chunks of 32
  lanes; CW centres a warp, the chunk skipped unless a lane's point lies
  in some centre's largest ball; a ballot a shell ranking the in-ball
  lanes, the first K indices of a slice in its buffer and every in-ball
  point counted; then the slices' counts summed in rank order, each
  slice's entries placed after the earlier slices' and the wrap-repeat),
  equals ``ball_query_plain`` bit for bit under several plans, with a
  slice boundary inside a run of in-ball points.
* ``ball_query_plan`` stays inside the kernel's limits.
* ``SetAbstractionFSMSG`` on given centres (the tiny SSD3D's dilated level
  and its vote SA) equals JAX's after a strict load, with one
  ``ball_query_multi`` call a forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_model import random_variables
from tests.test_torch_port_ssd3d import BQ_CASES
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.models.pointnet2_backbone import \
    SetAbstractionFSMSG as JSetAbstractionFSMSG
from tmae_tpu.ops import pointnet2 as jpn
from tmae_tpu_torch.models import pointnet2_backbone as tbb
from tmae_tpu_torch.ops import pointnet2 as tpn
from tmae_tpu_torch.utils.from_jax import params_from_jax

RADII = {False: (0.8, 1.5, 3.0), True: (0.5, 1.0, 2.0)}
KS = (8, 16, 32)


def t(a):
    return torch.from_numpy(np.array(a))


def bq_case(name, rng):
    """test_ball_query_equals_jax's inputs: (xyz, xm, centers, cm, ks)."""
    B, N, M = 2, 300, 40
    xyz = (rng.randn(B, N, 3) * 2.0).astype(np.float32)
    centers = xyz[:, :M] + rng.randn(B, M, 3).astype(np.float32) * 0.3
    centers[:, -3:] += 50.0  # empty balls
    xm, cm = np.ones((B, N), bool), np.ones((B, M), bool)
    ks = KS
    if name == 'invalid':
        xm = rng.rand(B, N) > 0.25
        cm = rng.rand(B, M) > 0.2
    elif name == 'more_slots':
        ks = (8, 16, 512)  # more slots than points
    return xyz, xm, centers, cm, ks


@pytest.mark.parametrize('dilated', [False, True], ids=['nested', 'dilated'])
@pytest.mark.parametrize('name', BQ_CASES)
def test_ball_query_multi_equals_jax(name, dilated, monkeypatch):
    """One (idx, cnt) a radius, each JAX's ball_query with min_radius the
    previous radius (dilated) or 0, exactly."""
    rng = np.random.RandomState(BQ_CASES.index(name))
    xyz, xm, centers, cm, ks = bq_case(name, rng)
    if name == 'chunked':
        monkeypatch.setattr(tpn, 'QUERY_CHUNK_PAIRS', 7 * xyz.shape[1] * 2)
    radii = RADII[dilated]
    got = tpn.ball_query_multi(radii, ks, t(xyz), t(xm), t(centers), t(cm),
                               dilated)
    assert len(got) == len(radii)
    former = 0.0
    for (gi, gc), r, k in zip(got, radii, ks):
        want = jpn.ball_query(r, k, jnp.asarray(xyz), jnp.asarray(xm),
                              jnp.asarray(centers), jnp.asarray(cm),
                              min_radius=former if dilated else 0.0)
        former = r
        for g, w in zip((gi, gc), want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert any((c > 0).any() for _, c in got)


def sq_dist(c, p):
    """f32 squared distances [..., M, N] in the plain order (x, y, z)."""
    d = c[:, None, 0] - p[None, :, 0]
    acc = d * d
    for k in (1, 2):
        d = c[:, None, k] - p[None, :, k]
        acc = acc + d * d
    return acc


def bq_kernel_model(radii, mins, ks, xyz, xm, ctr, cm, cw, S, tile):
    """ball_query_kernel's schedule in numpy: [(idx [B, M, K], cnt [B, M])]
    a radius; ``tile``: the points a staged tile (kBqTileN)."""
    f32 = np.float32
    B, N, _ = xyz.shape
    M = ctr.shape[1]
    R = len(radii)
    Np = max(16, -(-N // 16) * 16)  # the wrapper pads with invalid points
    pts = np.zeros((B, Np, 3), f32)
    pts[:, :N] = xyz
    pm = np.zeros((B, Np), bool)
    pm[:, :N] = xm
    r2 = [f32(r * r) for r in radii]
    min2 = [f32(m * m) if m > 0 else f32(-1.0) for m in mins]
    rmax2 = max(r2)
    per = -(-(-(-Np // S)) // 16) * 16  # a slice: a multiple of 16 points
    idx = [np.zeros((B, M, k), np.int32) for k in ks]
    cnt = [np.zeros((B, M), np.int32) for _ in ks]
    warps, lanes = 8, np.arange(32)
    for b in range(B):
        for m0 in range(0, M, warps * cw):
            counts = np.zeros((S, warps * cw, R), np.int64)
            bufs = [[[[] for _ in range(R)] for _ in range(warps * cw)]
                    for _ in range(S)]
            for rank in range(S):
                lo = min(Np, rank * per)
                hi = min(Np, lo + per)
                for w in range(warps):
                    cs = m0 + w * cw + np.arange(cw)
                    c = np.full((cw, 3), np.nan, f32)
                    c[cs < M] = ctr[b, cs[cs < M]]
                    for n0 in range(lo, hi, tile):
                        nn = min(tile, hi - n0)
                        for c0 in range(0, nn, 32):
                            j = c0 + lanes
                            jc = np.minimum(j, nn - 1) + n0
                            valid = (j < nn) & pm[b, jc]
                            with np.errstate(invalid='ignore'):
                                d2 = sq_dist(c, pts[b, jc])  # [cw, 32]
                                hit = valid & (d2 <= rmax2)
                            if not hit.any():  # the redux over the lanes
                                continue
                            for ci in range(cw):
                                if not hit[ci].any():
                                    continue
                                for r in range(R):
                                    with np.errstate(invalid='ignore'):
                                        inb = (hit[ci] & (d2[ci] <= r2[r])
                                               & (d2[ci] > min2[r]))
                                    row = w * cw + ci
                                    for lane in np.flatnonzero(inb):
                                        k = counts[rank, row, r]
                                        k += int(inb[:lane].sum())
                                        if k < ks[r]:
                                            bufs[rank][row][r].append(
                                                n0 + c0 + lane)
                                    counts[rank, row, r] += int(inb.sum())
            # the merge: each slice's entries after the earlier slices'
            for row in range(warps * cw):
                m = m0 + row
                if m >= M:
                    continue
                for r in range(R):
                    total = int(counts[:, row, r].sum())
                    cnt[r][b, m] = total
                    if total == 0 or not cm[b, m]:
                        continue  # rank 0 wrote zeros
                    n = min(total, ks[r])
                    for rank in range(S):
                        pre = int(counts[:rank, row, r].sum())
                        own = (min(int(counts[rank, row, r]), ks[r] - pre)
                               if pre < ks[r] else 0)
                        for s in range(ks[r]):
                            e = s % n - pre
                            if 0 <= e < own:
                                idx[r][b, m, s] = bufs[rank][row][r][e]
    return list(zip(idx, cnt))


def model_case():
    """A cloud whose points 70..95 sit in centre 0's smallest ball: with 4
    slices of 80 points, a run of in-ball points across a slice boundary;
    invalid points and centres, empty balls, 40 centres (partial blocks)."""
    rng = np.random.RandomState(7)
    B, N, M = 2, 300, 40
    xyz = (rng.randn(B, N, 3) * 2.0).astype(np.float32)
    centers = xyz[:, :M] + rng.randn(B, M, 3).astype(np.float32) * 0.3
    xyz[:, 70:96] = (centers[:, :1]
                     + rng.randn(B, 26, 3).astype(np.float32) * 0.05)
    centers[:, -3:] += 50.0
    xm = rng.rand(B, N) > 0.1
    xm[:, 70:96] = True
    cm = rng.rand(B, M) > 0.1
    cm[:, 0] = True
    return xyz, xm, centers, cm


@pytest.mark.parametrize('plan', [(1, 1, 1024), (2, 4, 64), (4, 8, 32),
                                  (8, 2, 48)],
                         ids=lambda p: f'cw{p[0]}-S{p[1]}-tile{p[2]}')
def test_ball_query_kernel_model_equals_plain(plan):
    """The kernel's schedule gives the plain version's idx and cnt bit for
    bit under the plan (CW centres a warp, S slices, tile points), dilated
    (the run across the boundary truncated at K = 8 and merged at K = 16)
    and nested."""
    cw, S, tile = plan
    xyz, xm, centers, cm = model_case()
    args = (t(xyz), t(xm), t(centers), t(cm))
    for radii, mins, ks in (((0.2, 0.6, 2.0), (0.0, 0.2, 0.6), (8, 16, 32)),
                            ((0.6, 2.0), (0.0, 0.0), (16, 24))):
        got = bq_kernel_model(radii, mins, ks, xyz, xm, centers, cm, cw, S,
                              tile)
        for (gi, gc), r, lo, k in zip(got, radii, mins, ks):
            wi, wc = tpn.ball_query_plain(r, k, *args, lo)
            np.testing.assert_array_equal(gi, wi.numpy())
            np.testing.assert_array_equal(gc, wc.numpy())
    # centre 0's smallest ball holds the run 70..95, across slices of 80
    idx, cnt = tpn.ball_query_plain(0.2, 16, *args)
    assert (cnt[:, 0] >= 20).all() and (idx[:, 0, :10] < 80).all()
    assert (idx[:, 0, 10:] >= 80).all()


def test_ball_query_plan_fits_the_kernel():
    """(CW, S) within the kernel's templates and cluster sizes; SSD3D's
    groupings as the sweep on the H100 picked them (batch 1, then 2)."""
    for B in (1, 2, 8):
        for M in (1, 7, 256, 512, 1024, 4096, 16384):
            for N in (1, 16, 100, 512, 4096, 16384, 65536):
                cw, S = tpn.ball_query_plan(B, M, N)
                assert cw in (1, 2, 4, 8) and S in (1, 2, 4, 8)
    for (M, N), plans in {(4096, 16384): ((4, 2), (8, 2)),
                          (1024, 4096): ((1, 2), (2, 2)),
                          (512, 1024): ((1, 1), (1, 1)),
                          (256, 512): ((1, 1), (1, 1))}.items():
        assert tuple(tpn.ball_query_plan(B, M, N) for B in (1, 2)) == plans


def sa_inputs(seed=0, B=2, N=64, M=16, C=16):
    rng = np.random.RandomState(seed)
    xyz = (rng.randn(B, N, 3) * 1.5).astype(np.float32)
    mask = rng.rand(B, N) > 0.15
    feats = rng.randn(B, N, C).astype(np.float32)
    new_xyz = xyz[:, :M] + rng.randn(B, M, 3).astype(np.float32) * 0.2
    new_xyz[:, -2:] += 40.0  # empty balls
    new_mask = rng.rand(B, M) > 0.2
    return xyz, mask, feats, new_xyz, new_mask


@pytest.mark.parametrize('dilated', [True, False], ids=['level', 'vote_sa'])
def test_sa_grouping_through_one_multi_call_equals_jax(dilated,
                                                       monkeypatch):
    """The tiny SSD3D's (tests/test_ssd3d.py) grouping on given centres:
    level 1's dilated radii with its aggregation MLP, and the vote SA's
    nested radii; the port's features within 1e-5 of JAX's (eval mode,
    after a strict load), from one ball_query_multi call."""
    radii, ks = (1.0, 2.0), (8, 8)
    mlps = ((16, 16), (16, 16))
    agg = (32,) if dilated else ()
    xyz, mask, feats, new_xyz, new_mask = sa_inputs()
    jm = JSetAbstractionFSMSG(radii=radii, nsamples=ks, mlps=mlps,
                              dilated_radius_group=dilated,
                              aggregation_mlp=agg)
    jargs = tuple(jnp.asarray(a) for a in (xyz, mask, feats))
    jnew = dict(new_xyz=jnp.asarray(new_xyz), new_mask=jnp.asarray(new_mask))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *jargs,
                                            False, **jnew))
    v = random_variables(shapes, 3)
    _, _, want = jm.apply(v, *jargs, False, **jnew)

    calls = []
    real = tbb.ball_query_multi

    def counting(*a, **k):
        calls.append(a[:2])
        return real(*a, **k)

    monkeypatch.setattr(tbb, 'ball_query_multi', counting)
    tm = tbb.SetAbstractionFSMSG(feats.shape[-1], radii, ks, mlps,
                                 dilated=dilated, aggregation_mlp=agg)
    tm.load_state_dict(params_from_jax(v), strict=True)
    tm.eval()
    with torch.no_grad():
        _, _, got, _ = tm(t(xyz), t(mask), t(feats), new_xyz=t(new_xyz),
                          new_mask=t(new_mask))
    assert calls == [(list(radii), list(ks))] or calls == [(radii, ks)]
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * max(1.0, np.abs(want).max()), err
    assert (np.abs(want) > 0).any()
