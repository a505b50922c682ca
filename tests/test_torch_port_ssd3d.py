"""The port's SSD3D against the JAX package on the CPU.

* The samplers and ball query (``ops/pointnet2.py``'s plain versions, the
  functions of the kernels DFPS, FFPS and BALL_QUERY) give JAX's indices
  and counts exactly: random clouds, invalid points, fewer valid points
  than samples, no valid point, integer grids of exact ties, the dilated
  ball, invalid centres, more slots than points, the plain query's chunks.
* The gathers, ``query_and_group``, ``three_nn`` and ``three_interpolate``
  within 1e-6; both point coders' encode and decode within 1e-5 (the
  heading bins' floor moduli exactly); ``points_in_boxes`` exactly.
* ``PointHeadVote``'s targets exactly and its loss parts within 1e-5 of
  JAX's on planted votes, their gradients within 1e-5.
* The tiny SSD3D of ``tests/test_ssd3d.py`` after a strict
  ``params_from_jax`` load: its own centres equal JAX's; on JAX's centres
  (recovered from ``backbone_out['sa_xyz']`` by their coordinates) the
  eval-mode head within 1e-5, the training loss and its parts within 1e-5
  relative, the gradient within 1e-4 relative L2 and the running
  statistics within 1e-5 after the step.
* F12: JAX's ``build_detector`` raises on ``ssd3d_once.yaml``
  (``vfe_remat``); the port's builds it. F13: JAX raises on the yaml's
  sampler structure (two counts, one range, one method); the port reads it
  as fusion sampling, F-FPS then D-FPS. F14: JAX's ``host_nms`` raises on
  SSD3D's config (no ``DENSE_HEAD``); the port's candidates are cut by
  score, sorted and kept by the NMS in score order.
* The evaluator's SSD3D branch and the CLIs on a tiny SSD3D.
"""

import copy
import json
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_ssd3d import make_batch, make_cfg
from tests.test_torch_port_model import random_variables
from tests.test_torch_port_train import _rel
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml
from tmae_tpu.models import detectors as jdet
from tmae_tpu.models import point_head_vote as jphv
from tmae_tpu.models.ssd3d import SSD3D as JSSD3D
from tmae_tpu.models.ssd3d import ssd3d_loss as j_ssd3d_loss
from tmae_tpu.models.ssd3d import ssd3d_predict as j_ssd3d_predict
from tmae_tpu.ops import box_coder as jbc
from tmae_tpu.ops import losses as jlosses
from tmae_tpu.ops import pointnet2 as jpn
from tmae_tpu.ops import roi_pool as jroi
from tmae_tpu_torch.config import Cfg, cfg_from_yaml_file
from tmae_tpu_torch.models import detectors as tdet
from tmae_tpu_torch.models import point_head_vote as tphv
from tmae_tpu_torch.models.pointnet2_backbone import sampler_plan
from tmae_tpu_torch.models.ssd3d import (ssd3d_candidates, ssd3d_loss,
                                         ssd3d_predict)
from tmae_tpu_torch.ops import box_coder as tbc
from tmae_tpu_torch.ops import losses as tlosses
from tmae_tpu_torch.ops import pointnet2 as tpn
from tmae_tpu_torch.ops import roi_pool as troi
from tmae_tpu_torch.ops.geometry_np import nms_bev
from tmae_tpu_torch.tools import test as test_cli
from tmae_tpu_torch.tools import train as train_cli
from tmae_tpu_torch.train.evaluator import make_eval_step
from tmae_tpu_torch.utils.from_jax import params_from_jax, tree_from_jax

REPO = Path(__file__).resolve().parent.parent
YAML = REPO / 'tools/cfgs/once_models/ssd3d_once.yaml'


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol, what=''):
    """|got - want| <= tol * max(1, max |want|)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


def exact(got, want, what=''):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


def cloud(rng, B, N, scale=5.0):
    return (rng.randn(B, N, 3) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# samplers and ball query
# ---------------------------------------------------------------------------


def fps_case(name):
    """(xyz [B, N, 3], features [B, N, C] or None, mask, S)."""
    rng = np.random.RandomState(FPS_CASES.index(name))
    B, N = 2, 200
    xyz, mask = cloud(rng, B, N), np.ones((B, N), bool)
    feats = rng.rand(B, N, 16).astype(np.float32)
    S = 64
    if name == 'invalid':
        mask = rng.rand(B, N) > 0.3
    elif name == 'fewer_valid':
        mask[:] = False
        mask[0, rng.choice(N, 20, replace=False)] = True
        mask[1, rng.choice(N, 7, replace=False)] = True
        S = 50
    elif name == 'none_valid':
        mask[1] = False
    elif name == 'ties':
        xyz = rng.randint(0, 5, (B, N, 3)).astype(np.float32)
        feats = rng.randint(0, 3, (B, N, 16)).astype(np.float32)
    return xyz, feats, mask, S


FPS_CASES = ['random', 'invalid', 'fewer_valid', 'none_valid', 'ties']


@pytest.mark.parametrize('name', FPS_CASES)
def test_dfps_equals_jax(name):
    """D-FPS: the plain version's indices equal JAX's exactly."""
    xyz, _, mask, S = fps_case(name)
    want = jpn.farthest_point_sample(jnp.asarray(xyz), jnp.asarray(mask), S)
    got = tpn.farthest_point_sample(t(xyz), t(mask), S)
    assert got.dtype == torch.int32
    exact(got, want, name)


def test_dfps_plan_covers_every_size(monkeypatch):
    """``dfps_plan``, DFPS's launch on the card: for every N from 1 to
    DFPS_MAX_POINTS a cluster of 1-16 CTAs (a power of 2), threads a
    multiple of 32 up to 256 and 1-16 points a thread (a power of 2) that
    cover N, with no smaller count of points a thread that would; the
    ssd3d_once.yaml levels get the plans timed fastest on the card; above
    the limit the plan and the card wrapper refuse (checked before any
    launch)."""
    for N in range(1, tpn.DFPS_MAX_POINTS + 1):
        R, threads, per = tpn.dfps_plan(N)
        assert R in (1, 2, 4, 8, 16) and R <= tpn.DFPS_MAX_CLUSTER, N
        assert threads % 32 == 0 and 32 <= threads <= 256, N
        assert per in (1, 2, 4, 8, 16) and per <= tpn.DFPS_MAX_PER, N
        assert R * threads * per >= N, N
        assert per == 1 or R * threads * (per // 2) < N, N
    assert tpn.dfps_plan(16384) == (8, 256, 8)
    assert tpn.dfps_plan(4096) == (4, 256, 4)
    assert tpn.dfps_plan(512) == (2, 128, 2)
    too_many = tpn.DFPS_MAX_POINTS + 1
    for bad in (0, too_many):
        with pytest.raises(ValueError, match='D-FPS on the card takes 1 to'):
            tpn.dfps_plan(bad)
    monkeypatch.setattr(tpn, 'on_card', lambda *a: True)
    with pytest.raises(ValueError, match='FPS on the card takes at most '
                       f'{tpn.DFPS_MAX_POINTS} points a sample'):
        tpn.farthest_point_sample(torch.zeros(1, too_many, 3),
                                  torch.ones(1, too_many, dtype=torch.bool),
                                  4)


def dfps_cluster_model(xyz, mask, S, plan):
    """A numpy model of DFPS's cluster walk under ``plan`` (R, threads,
    per), one sample: point j in thread j % G's register j // G (G = R
    threads), each thread's argmax, each warp's record (value, index,
    coordinates) in slot rank * W + warp (W warps a CTA), the records'
    argmax, and the coordinates read from the slot that the winner's index
    names (asserted to be the winner's)."""
    R, threads, per = plan
    N, G, W = len(mask), R * threads, threads // 32
    beats = lambda r: (r[0], -r[1])  # greater value, then smaller index
    j = np.arange(G * per).reshape(per, G)
    ok = j < N
    valid = ok & mask[np.minimum(j, N - 1)]

    def argmax(vals):
        recs = []
        for w in range(G // 32):
            lanes = [(-np.inf, N)]  # a thread's start: below every point
            for tt in range(32 * w, 32 * w + 32):
                lanes += [(vals[k, tt], j[k, tt]) for k in range(per)
                          if ok[k, tt]]
            v, i = max(lanes, key=beats)
            recs.append((v, i, xyz[i] if i < N else None))
        v, i, _ = max(recs, key=beats)
        g = i % G
        slot = recs[(g // threads) * W + (g % threads) // 32]
        assert slot[1] == i
        return i, slot[2]

    last, lxyz = argmax(np.where(ok, np.where(valid, 1.0, 0.0), -np.inf))
    dist = np.where(valid, np.float32(1e10), np.float32(-1e10))
    pts = xyz[np.minimum(j, N - 1)]
    out = [last]
    for _ in range(1, S):
        d = pts - lxyz
        sq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[
            ..., 2]
        dist = np.where(dist >= 0, np.minimum(dist, sq), dist).astype(
            np.float32)
        last, lxyz = argmax(dist)
        out.append(last)
    return np.array(out, np.int32)


@pytest.mark.parametrize('plan', [(2, 32, 4), (4, 64, 1), (1, 64, 8)],
                         ids=lambda p: 'R{}-t{}-per{}'.format(*p))
def test_dfps_cluster_model_equals_plain(plan):
    """The cluster walk's decomposition (point j in thread j % G, register
    j // G; a record a warp; the winner's record found from its index)
    gives the plain D-FPS's indices on planted exact ties across CTAs
    (duplicated points), N not a multiple of the cluster's threads,
    invalid points and a sample with one valid point."""
    R, threads, per = plan
    rng = np.random.RandomState(R * threads + per)
    N = R * threads * per - 37
    xyz = rng.randint(0, 4, (N, 3)).astype(np.float32)
    xyz[N // 2:N // 2 + 40] = xyz[:40]  # the same points in other CTAs
    mask = rng.rand(N) > 0.2
    one = np.zeros(N, bool)
    one[N - 5] = True
    for m in (mask, one):
        want = tpn.farthest_point_sample_plain(
            t(xyz[None]), t(m[None]), 24)[0].numpy()
        np.testing.assert_array_equal(dfps_cluster_model(xyz, m, 24, plan),
                                      want)


FFPS_PLAN_CHANNELS = (1, 3, 16, 32, 48, 64, 100, 128, 256)


def test_ffps_plan_covers_every_size(monkeypatch):
    """``ffps_plan``, FFPS's launch on the card: for every N from 1 to
    FPS_MAX_POINTS and channel counts from 1 to 256, either a cluster
    of 1-16 CTAs (a power of 2) of threads a multiple of 32 up to 512 (256
    when a thread holds 128 channels in registers), 1-16 points a thread
    (a power of 2) that cover N, a register share of 0, 32, 64 or 128
    channels within the features, 128 values and C % 4 == 0, and shared
    memory within FFPS_SMEM_MAX; or the matrix route, taken up to
    FFPS_MATRIX_MAX_POINTS points and above them only where no cluster
    fits (none of 16 CTAs of 512 threads at any points a thread). SSD3D's levels: 4096 x 64 on the cluster,
    512 x 128 on the matrix, as 16384 x 64; above the limit the plan and
    the card wrapper refuse (checked before any launch), and the plan
    refuses no features (the wrapper takes DFPS then)."""
    for C in FFPS_PLAN_CHANNELS:
        for N in range(1, tpn.FPS_MAX_POINTS + 1):
            plan = tpn.ffps_plan(N, C)
            if plan.route == 'matrix':
                assert (N <= tpn.FFPS_MATRIX_MAX_POINTS or all(
                    tpn.ffps_smem(C, 32 * -(-N // (512 * per)), per)
                    > tpn.FFPS_SMEM_MAX for per in (1, 2, 4, 8, 16)
                    if 16 * 512 * per >= N)), (N, C)
                continue
            assert plan.route == 'cluster', (N, C)
            assert N > tpn.FFPS_MATRIX_MAX_POINTS, (N, C)
            R, threads, per, creg = plan[1:]
            assert R in (1, 2, 4, 8, 16), (N, C)
            most = 256 if per * creg >= 128 else tpn.FFPS_MAX_THREADS
            assert threads % 32 == 0 and 32 <= threads <= most, (N, C)
            assert per in (1, 2, 4, 8, 16), (N, C)
            assert R * threads * per >= N, (N, C)
            assert creg in (0, 32, 64, 128) and creg <= C, (N, C)
            assert creg == 0 or C % 4 == 0, (N, C)
            assert per * creg <= 128, (N, C)
            assert tpn.ffps_smem(C, threads, per) <= tpn.FFPS_SMEM_MAX
    assert tpn.ffps_plan(4096, 64) == ('cluster', 16, 256, 1, 64)
    assert tpn.ffps_plan(512, 128).route == 'matrix'
    assert tpn.ffps_plan(16384, 64).route == 'matrix'
    too_many = tpn.FPS_MAX_POINTS + 1
    for bad in (0, too_many):
        with pytest.raises(ValueError, match='F-FPS on the card takes 1 to'):
            tpn.ffps_plan(bad, 64)
    with pytest.raises(ValueError, match='FFPS takes 1 or more feature'):
        tpn.ffps_plan(4096, 0)
    monkeypatch.setattr(tpn, 'on_card', lambda *a: True)
    with pytest.raises(ValueError, match='FPS on the card takes at most '
                       f'{tpn.FPS_MAX_POINTS} points a sample'):
        tpn.farthest_point_sample_ffps(
            torch.zeros(1, too_many, 3), torch.zeros(1, too_many, 4),
            torch.ones(1, too_many, dtype=torch.bool), 4)


@pytest.mark.parametrize('name', FPS_CASES)
def test_ffps_without_features_takes_dfps(name, monkeypatch):
    """Without features F-FPS's distance is D-FPS's, summed in the same
    order, so the plain F-FPS and the plain D-FPS give the same indices bit
    for bit; on the card the F-FPS wrapper hands such a call to
    ``farthest_point_sample`` (kernel DFPS) and launches no FFPS."""
    xyz, _, mask, S = fps_case(name)
    want = tpn.farthest_point_sample_plain(t(xyz), t(mask), S)
    got = tpn.farthest_point_sample_ffps_plain(t(xyz), None, t(mask), S)
    assert torch.equal(got, want)
    calls = []
    monkeypatch.setattr(tpn, 'on_card', lambda *a: True)
    monkeypatch.setattr(tpn, 'farthest_point_sample',
                        lambda *a: calls.append(a) or want)
    monkeypatch.setattr(tpn, 'FFPS', None)  # a launch would raise
    assert tpn.farthest_point_sample_ffps(t(xyz), None, t(mask), S) is want
    assert len(calls) == 1 and calls[0][2] == S


def ffps_cluster_model(xyz, feat, mask, S, gamma, plan, dm=None):
    """A numpy model of FFPS's cluster walk under ``plan`` (R, threads,
    per), one sample: point j in thread j % G's register j // G (G = R
    threads) as DFPS's, each thread's argmax, each warp's winner, each
    CTA's winner over its W warps (its record: value, index, coordinates
    and the features read from the CTA's copy of its points' features),
    the argmax of the R records, and the next step's distances computed
    afresh from the winner's record in the kernel's order (x, y, z; the
    channels from a 0 start; then xyz + gamma feat), asserting that the
    record holds the winner's coordinates and features. With ``dm`` (the
    plain [N, N] distance matrix) it asserts that every fresh distance is
    the matrix entry of the winner's row bit for bit, which the plain walk
    reads."""
    R, threads, per = plan
    N, G, W = len(mask), R * threads, threads // 32
    C = 0 if feat is None else feat.shape[1]
    beats = lambda r: (r[0], -r[1])  # greater value, then smaller index
    j = np.arange(G * per).reshape(per, G)
    ok = j < N
    valid = ok & mask[np.minimum(j, N - 1)]
    # each CTA's copy of its points' features: [C][local point]
    local = [np.concatenate([j[k, r * threads:(r + 1) * threads]
                             for k in range(per)]) for r in range(R)]
    copies = [np.where((lj < N)[None], (feat[np.minimum(lj, N - 1)].T
                                        if C else np.zeros((0, len(lj)))),
                       0).astype(np.float32) for lj in local]

    def argmax(vals):
        recs = []
        for r in range(R):
            warps = []
            for w in range(W):
                lanes = [(-np.inf, N)]
                for tt in range(r * threads + 32 * w,
                                r * threads + 32 * w + 32):
                    lanes += [(vals[k, tt], j[k, tt]) for k in range(per)
                              if ok[k, tt]]
                warps.append(max(lanes, key=beats))
            v, i = max(warps, key=beats)
            f = None
            if i < N:
                li = int(np.nonzero(local[r] == i)[0][0])
                f = copies[r][:, li]
            recs.append((v, i, xyz[i] if i < N else None, f))
        v, i, c, f = max(recs, key=beats)
        assert (c == xyz[i]).all() and (C == 0 or (f == feat[i]).all())
        return i, c, f

    last, lxyz, lf = argmax(np.where(ok, np.where(valid, 1.0, 0.0),
                                     -np.inf))
    dist = np.where(valid, np.float32(1e10), np.float32(-1e10))
    pts = xyz[np.minimum(j, N - 1)]
    pf = feat[np.minimum(j, N - 1)] if C else None
    g = np.float32(gamma)
    out = [last]
    for _ in range(1, S):
        d = pts - lxyz
        sq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[
            ..., 2]
        if C:
            acc = np.zeros(sq.shape, np.float32)
            for c in range(C):
                e = lf[c] - pf[..., c]
                acc = acc + e * e
            sq = sq + acc * g
        if dm is not None:
            assert np.array_equal(sq[ok], dm[last][j[ok]])
        dist = np.where(dist >= 0, np.minimum(dist, sq), dist).astype(
            np.float32)
        last, lxyz, lf = argmax(dist)
        out.append(last)
    return np.array(out, np.int32)


@pytest.mark.parametrize('plan', [(2, 32, 4), (4, 64, 1), (1, 64, 8)],
                         ids=lambda p: 'R{}-t{}-per{}'.format(*p))
def test_ffps_cluster_model_equals_plain(plan):
    """The F-FPS cluster walk's decomposition (point j in thread j % G,
    register j // G; a winner a warp, then a record a CTA carrying the
    winner's features from the CTA's copy; the distances afresh each step)
    gives the plain F-FPS's indices bit for bit, each fresh distance equal
    to the plain matrix's entry: exact ties across CTAs (duplicated points
    and features), invalid points, one valid point, no features (C = 0:
    D-FPS's walk, which the card takes then),
    gamma 1 and 0.37, N not a multiple of the cluster's threads."""
    R, threads, per = plan
    rng = np.random.RandomState(R * threads + per)
    N = R * threads * per - 37
    xyz = rng.randint(0, 4, (N, 3)).astype(np.float32)
    feat = rng.randint(0, 3, (N, 5)).astype(np.float32)
    xyz[N // 2:N // 2 + 40] = xyz[:40]  # the same points in other CTAs
    feat[N // 2:N // 2 + 40] = feat[:40]
    soft = (feat + rng.rand(N, 5).astype(np.float32) * 0.1).astype(
        np.float32)
    mask = rng.rand(N) > 0.2
    one = np.zeros(N, bool)
    one[N - 5] = True
    for f, gamma in ((feat, 1.0), (soft, 0.37), (None, 1.0)):
        for m in (mask, one):
            want = tpn.farthest_point_sample_ffps_plain(
                t(xyz[None]), None if f is None else t(f[None]), t(m[None]),
                24, gamma)[0].numpy()
            dm = tpn.calc_dist_matrix_for_sampling(
                t(xyz[None]), None if f is None else t(f[None]),
                gamma)[0].numpy()
            np.testing.assert_array_equal(
                ffps_cluster_model(xyz, f, m, 24, gamma, plan, dm), want)


@pytest.mark.parametrize('features', [True, False], ids=['feat', 'xyz'])
@pytest.mark.parametrize('name', FPS_CASES)
def test_ffps_equals_jax(name, features):
    """F-FPS (distance matrix, then the walk over its rows): the plain
    version's indices equal JAX's exactly, at gamma 1 and 0.5; the matrix
    within 1e-6 relative."""
    xyz, feats, mask, S = fps_case(name)
    f = feats if features else None
    for gamma in (1.0, 0.5):
        dm = jpn.calc_dist_matrix_for_sampling(
            jnp.asarray(xyz), None if f is None else jnp.asarray(f), gamma)
        want = jpn.farthest_point_sample_matrix(dm, jnp.asarray(mask), S)
        got = tpn.farthest_point_sample_ffps(
            t(xyz), None if f is None else t(f), t(mask), S, gamma)
        exact(got, want, f'{name} gamma {gamma}')
        close(tpn.calc_dist_matrix_for_sampling(
            t(xyz), None if f is None else t(f), gamma), dm, 1e-6)


BQ_CASES = ['plain', 'dilated', 'invalid', 'more_slots', 'chunked']


@pytest.mark.parametrize('name', BQ_CASES)
def test_ball_query_equals_jax(name, monkeypatch):
    """Ball query: the first nsample in-ball indices wrap-repeated and
    the count of every in-ball point equal JAX's exactly (int32)."""
    rng = np.random.RandomState(BQ_CASES.index(name))
    B, N, M = 2, 300, 40
    xyz = cloud(rng, B, N, 2.0)
    centers = xyz[:, :M] + rng.randn(B, M, 3).astype(np.float32) * 0.3
    centers[:, -3:] += 50.0  # empty balls
    xm, cm = np.ones((B, N), bool), np.ones((B, M), bool)
    radius, nsample, min_r = 1.5, 16, 0.0
    if name == 'dilated':
        min_r = 0.8
    elif name == 'invalid':
        xm = rng.rand(B, N) > 0.25
        cm = rng.rand(B, M) > 0.2
        min_r = 0.5
    elif name == 'more_slots':
        radius, nsample = 3.0, 512  # more slots than points
    elif name == 'chunked':
        monkeypatch.setattr(tpn, 'QUERY_CHUNK_PAIRS', 7 * N * B)
    want = jpn.ball_query(radius, nsample, jnp.asarray(xyz), jnp.asarray(xm),
                          jnp.asarray(centers), jnp.asarray(cm),
                          min_radius=min_r)
    got = tpn.ball_query(radius, nsample, t(xyz), t(xm), t(centers), t(cm),
                         min_radius=min_r)
    for g, w, what in zip(got, want, ('idx', 'cnt')):
        assert g.dtype == torch.int32
        exact(g, w, f'{name} {what}')
    assert (np.asarray(want[1]) > 0).any() and (np.asarray(want[1]) == 0).any()


def test_grouping_and_interpolation_equal_jax():
    """gather_points, group_points, query_and_group (with and without
    features, use_xyz off, dilated, invalid centres), three_nn and
    three_interpolate within 1e-6."""
    rng = np.random.RandomState(3)
    B, N, M, C = 2, 120, 30, 5
    xyz = cloud(rng, B, N, 2.0)
    feats = rng.randn(B, N, C).astype(np.float32)
    centers = xyz[:, :M] + 0.1
    xm = rng.rand(B, N) > 0.1
    cm = rng.rand(B, M) > 0.2
    idx = rng.randint(0, N, (B, M)).astype(np.int32)
    close(tpn.gather_points(t(feats), t(idx)),
          jpn.gather_points(jnp.asarray(feats), jnp.asarray(idx)), 0)
    gidx = rng.randint(0, N, (B, M, 7)).astype(np.int32)
    close(tpn.group_points(t(feats), t(gidx)),
          jpn.group_points(jnp.asarray(feats), jnp.asarray(gidx)), 0)
    for f, use_xyz, min_r in ((None, True, 0.0), (feats, True, 0.0),
                              (feats, False, 0.7), (feats, True, 0.7)):
        got = tpn.query_and_group(1.5, 8, t(xyz), t(xm), t(centers), t(cm),
                                  None if f is None else t(f), use_xyz, min_r)
        want = jpn.query_and_group(1.5, 8, jnp.asarray(xyz), jnp.asarray(xm),
                                   jnp.asarray(centers), jnp.asarray(cm),
                                   None if f is None else jnp.asarray(f),
                                   use_xyz, min_r)
        close(got[0], want[0], 1e-6)
        exact(got[1], want[1])
        exact(got[2], want[2])
    unknown = cloud(rng, B, 50, 2.0)
    dist, nn = tpn.three_nn(t(unknown), t(xyz), t(xm))
    jd, jn = jpn.three_nn(jnp.asarray(unknown), jnp.asarray(xyz),
                          jnp.asarray(xm))
    exact(nn, jn)
    close(dist, jd, 1e-6)
    close(tpn.three_interpolate(t(feats), nn, dist),
          jpn.three_interpolate(jnp.asarray(feats), jn, jd), 1e-6)


# ---------------------------------------------------------------------------
# box coders, points in boxes, the vote head's targets and loss
# ---------------------------------------------------------------------------


MEAN = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]


def boxes_and_points(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-20, 20, (n, 2))
    b[:, 2] = rng.uniform(-2, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 5, (n, 3))
    b[:, 6] = rng.uniform(-7, 7, n)
    # the bin edges and a full turn, where the floor moduli matter
    per = np.float32(2 * np.pi / 12)
    b[:6, 6] = [per / 2, -per / 2, 0.0, np.float32(2 * np.pi), -3 * per / 2,
                np.float32(-np.pi)]
    pts = b[:, :3] + rng.randn(n, 3).astype(np.float32)
    cls = rng.randint(1, 4, n).astype(np.int32)
    return b, pts, cls


@pytest.mark.parametrize('use_mean', [True, False], ids=['mean', 'plain'])
@pytest.mark.parametrize('coder', ['PointResidualCoder',
                                   'PointBinResidualCoder'])
def test_point_coders_equal_jax(coder, use_mean):
    """Encode (the bins one-hot exactly) and decode (of the encodings and
    of random codes, whose bin is an argmax) within 1e-5."""
    rng = np.random.RandomState(4)
    kw = dict(use_mean_size=use_mean, mean_size=MEAN)
    if coder == 'PointBinResidualCoder':
        kw['angle_bin_num'] = 12
    tc, jc = getattr(tbc, coder)(**kw), getattr(jbc, coder)(**kw)
    assert tc.code_size == jc.code_size
    b, pts, cls = boxes_and_points(rng, 64)
    extra = np.c_[b, cls.astype(np.float32)]
    for boxes in (b, extra):
        enc = tc.encode(t(boxes), t(pts), t(cls))
        jenc = jc.encode(jnp.asarray(boxes), jnp.asarray(pts),
                         jnp.asarray(cls))
        close(enc, jenc, 1e-5, 'encode')
        if coder == 'PointBinResidualCoder':
            exact(enc[:, 6:18], jenc[:, 6:18], 'bins')
    codes = rng.randn(64, tc.code_size).astype(np.float32)
    for e in (enc.numpy()[:, :tc.code_size], codes):
        close(tc.decode(t(e), t(pts), t(cls)),
              jc.decode(jnp.asarray(e), jnp.asarray(pts), jnp.asarray(cls)),
              1e-5, 'decode')


@pytest.mark.parametrize('margin', [0.0, 0.3])
def test_points_in_boxes_equals_jax(margin):
    """The first holding box (a box mask among them) or -1, exactly."""
    rng = np.random.RandomState(5)
    boxes = np.stack([boxes_and_points(rng, 6)[0] for _ in range(2)])
    boxes[:, :, :2] = rng.uniform(-3, 3, (2, 6, 2))
    pts = rng.uniform(-5, 5, (2, 400, 3)).astype(np.float32)
    pts[..., 2] *= 0.3
    bm = np.array([[1, 1, 1, 0, 1, 1], [1, 0, 1, 1, 1, 1]], bool)
    got = troi.points_in_boxes(t(pts), t(boxes), t(bm), margin)
    want = jroi.points_in_boxes(jnp.asarray(pts), jnp.asarray(boxes),
                                jnp.asarray(bm), margin)
    exact(got, want)
    assert (got >= 0).sum() > 20 and (got == -1).any()
    exact(troi.points_in_boxes(t(pts), t(boxes)),
          jroi.points_in_boxes(jnp.asarray(pts), jnp.asarray(boxes)))


def test_losses_equal_jax():
    rng = np.random.RandomState(6)
    a, b = rng.randn(2, 9, 7).astype(np.float32) * 0.3
    w = rng.rand(2, 9).astype(np.float32)
    cw = rng.rand(7).astype(np.float32)
    close(tlosses.weighted_smooth_l1(t(a), t(b), t(w), code_weights=cw),
          jlosses.weighted_smooth_l1(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(w), code_weights=cw), 1e-6)
    boxes = boxes_and_points(rng, 20)[0]
    close(tlosses.boxes_to_corners_3d(t(boxes)),
          jlosses.boxes_to_corners_3d(jnp.asarray(boxes)), 1e-6)


def head_cfg():
    return make_cfg()['MODEL']['POINT_HEAD']


def planted_head_out(rng, B=2, K=24, n_cls=3):
    """Seeds and votes around two gt boxes a sample (some inside, some
    beyond GT_CENTRAL_RADIUS in a large box, some outside), a mask, random
    predictions; and the gt."""
    gt = np.zeros((B, 4, 8), np.float32)
    gt[:, 0] = [0, 0, 0, 3.9, 1.6, 1.56, 0.3, 1]
    gt[:, 1] = [14, 4, 0, 30.0, 3.0, 2.0, 0.0, 2]
    gt[:, 2] = [-6, 5, 0, 0.8, 0.6, 1.73, 2.0, 3]
    gm = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    seeds = rng.uniform(-8, 8, (B, K, 3)).astype(np.float32)
    seeds[..., 2] *= 0.1
    votes = seeds + rng.randn(B, K, 3).astype(np.float32) * 0.5
    votes[:, :4, :3] = gt[:, :1, :3] + rng.randn(B, 4, 3) * 0.3
    votes[:, 4:7] = [[25, 4, 0], [3, 4, 0.1], [14, 4.5, 0]]
    seeds[:, 8:10] = gt[:, 2:3, :3] + rng.randn(B, 2, 3) * 0.2
    vmask = rng.rand(B, K) > 0.15
    code = tbc.PointBinResidualCoder(**head_cfg()['TARGET_CONFIG'][
        'BOX_CODER_CONFIG']).code_size
    out = {'seeds': seeds, 'votes': votes, 'vote_mask': vmask,
           'vote_cls_preds': rng.randn(B, K, n_cls).astype(np.float32),
           'vote_box_preds': rng.randn(B, K, code).astype(np.float32) * 0.5}
    return out, gt, gm


def test_vote_targets_and_loss_equal_jax():
    """Targets exactly (labels, foreground, boxes) and within 1e-6 (box
    labels); the four loss parts and the total within 1e-5 relative; the
    gradients of the loss with respect to the votes and the predictions
    within 1e-5 (the votes detached only in the centerness)."""
    rng = np.random.RandomState(7)
    out, gt, gm = planted_head_out(rng)
    cfg = head_cfg()
    tc = tbc.PointBinResidualCoder(**cfg['TARGET_CONFIG']['BOX_CODER_CONFIG'])
    jc = jbc.PointBinResidualCoder(**cfg['TARGET_CONFIG']['BOX_CODER_CONFIG'])
    jout = {k: jnp.asarray(v) for k, v in out.items()}
    tout = {k: t(v).requires_grad_(v.dtype == np.float32)
            for k, v in out.items()}
    jt = jphv.point_head_vote_targets(jout, jnp.asarray(gt), jnp.asarray(gm),
                                      jc, cfg, 3)
    tt = tphv.point_head_vote_targets(tout, t(gt), t(gm), tc, cfg, 3)
    for k in ('vote_cls_labels', 'vote_fg', 'seed_fg', 'gt_box_of_fg_votes',
              'gt_box_of_fg_seeds'):
        exact(tt[k].detach(), jt[k], k)
    close(tt['vote_box_labels'], jt['vote_box_labels'], 1e-6)
    labels = np.asarray(jt['vote_cls_labels'])
    assert (labels > 0).any() and (labels == -1).any() and (labels == 0).any()
    assert np.asarray(jt['seed_fg']).any()

    floats = ('seeds', 'votes', 'vote_cls_preds', 'vote_box_preds')

    def jloss(fl):
        return jphv.point_head_vote_loss({**jout, **fl}, jnp.asarray(gt),
                                         jnp.asarray(gm), jc, cfg, 3)

    (jtotal, jparts), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jout[k] for k in floats})
    total, parts = tphv.point_head_vote_loss(tout, t(gt), t(gm), tc, cfg, 3)
    total.backward()
    assert sorted(parts) == sorted(jparts)
    for k, v in list(parts.items()) + [('total', total)]:
        want = float(jparts[k] if k != 'total' else jtotal)
        assert abs(float(v) - want) <= 1e-5 * max(1.0, abs(want)), k
        assert want != 0.0, k
    for k in ('votes', 'vote_cls_preds', 'vote_box_preds'):
        close(tout[k].grad, jg[k], 1e-5, k)


def test_vote_predict_equals_jax():
    rng = np.random.RandomState(8)
    out, _, _ = planted_head_out(rng)
    cfg = head_cfg()
    kw = cfg['TARGET_CONFIG']['BOX_CODER_CONFIG']
    s, b = tphv.point_head_vote_predict({k: t(v) for k, v in out.items()},
                                        tbc.PointBinResidualCoder(**kw))
    js, jb = jphv.point_head_vote_predict(
        {k: jnp.asarray(v) for k, v in out.items()},
        jbc.PointBinResidualCoder(**kw))
    close(s, js, 1e-6)
    close(b, jb, 1e-5)


# ---------------------------------------------------------------------------
# the tiny SSD3D of tests/test_ssd3d.py
# ---------------------------------------------------------------------------


def tiny_cfg():
    """tests/test_ssd3d.py's config with what the port's build reads: the
    point channels (x, y, z, intensity)."""
    cfg = make_cfg()
    cfg['DATA_CONFIG'] = {'POINT_FEATURE_ENCODING': {
        'used_feature_list': ['x', 'y', 'z', 'intensity']}}
    return Cfg.from_dict(json.loads(json.dumps(cfg)))


def centres_of(sa_xyz):
    """Each level's centre indices into the level below, recovered from
    the coordinates (the first point with a centre's coordinates)."""
    out = []
    for prev, cur in zip(sa_xyz[:-1], sa_xyz[1:]):
        prev, cur = np.asarray(prev), np.asarray(cur)
        out.append(torch.from_numpy(np.stack([
            [np.flatnonzero((prev[b] == c).all(-1))[0] for c in cur[b]]
            for b in range(prev.shape[0])]).astype(np.int32)))
    return out


@pytest.fixture(scope='module')
def tiny():
    """Both packages' tiny SSD3D from the same random weights on
    tests/test_ssd3d.py's batch: JAX's eval outputs, and its training loss,
    parts, gradients and updated statistics with the centres of its
    train-mode forward; the port after a strict load."""
    cfg = tiny_cfg()
    batch = make_batch(np.random.RandomState(0))
    jm = JSSD3D(model_cfg=cfg['MODEL'], class_names=tuple(cfg.CLASS_NAMES))
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b,
                                              False), batch)
    v = random_variables(shapes, 0)
    jout = jax.jit(lambda v, b: jm.apply(v, b, False))(v, batch)

    def loss_fn(params, stats, b):
        out, upd = jm.apply({'params': params, 'batch_stats': stats}, b,
                            True, mutable=['batch_stats'])
        total, parts = j_ssd3d_loss(cfg, out, b)
        return total, (parts, out['backbone_out']['sa_xyz'],
                       upd['batch_stats'])

    (jtotal, (jparts, train_xyz, jstats)), jg = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(v['params'],
                                                   v['batch_stats'], batch)
    tm = tdet.build_detector(cfg, 'cpu')
    tm.load_state_dict(params_from_jax(v), strict=True)
    tb = {k: t(x) for k, x in batch.items()}
    return dict(cfg=cfg, v=v, jm=jm, jout=jout, batch=batch, tm=tm, tb=tb,
                jtotal=float(jtotal),
                jparts={k: float(x) for k, x in jparts.items()},
                train_idx=centres_of(train_xyz),
                jg=tree_from_jax(jax.device_get(jg)),
                jstats=params_from_jax({'batch_stats':
                                        jax.device_get(jstats)}))


def test_tiny_ssd3d_forward_equals_jax(tiny):
    """Eval mode: the port's own centres are JAX's (D-FPS, then F-FPS and
    D-FPS on its features); on JAX's centres the votes, class and box
    predictions within 1e-5, and the predictions' decode too."""
    m, jo = tiny, tiny['jout']
    idx = centres_of(jo['backbone_out']['sa_xyz'])
    with torch.no_grad():
        own = m['tm'](m['tb'])
        out = m['tm'](m['tb'], sample_idx=idx)
    for a, b in zip(own['backbone_out']['sample_idx'], idx):
        exact(a, b)
    for k in ('seeds', 'votes', 'vote_cls_preds', 'vote_box_preds'):
        close(out['head_out'][k], jo['head_out'][k], 1e-5, k)
    close(out['backbone_out']['point_features'],
          jo['backbone_out']['point_features'], 1e-5)
    got, want = ssd3d_predict(m['cfg'], out), j_ssd3d_predict(m['cfg'], jo)
    for k in ('pred_scores', 'pred_boxes'):
        close(got[k], want[k], 1e-5, k)
    for k in ('pred_labels', 'pred_valid'):
        exact(got[k], want[k], k)


def test_tiny_ssd3d_training_step_equals_jax(tiny):
    """Train mode on JAX's train-mode centres: the loss and its parts
    within 1e-5 relative, the gradient over all parameters within 1e-4
    relative L2 (each tensor's within 1e-5 of the largest gradient entry),
    the running statistics after the step within 1e-5."""
    m = copy.deepcopy(tiny)
    tm = m['tm'].train()
    out = tm(m['tb'], sample_idx=m['train_idx'])
    loss, parts = tdet.detector_loss(m['cfg'], tm)(out, m['tb'])
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - m['jtotal']) <= 1e-5 * abs(m['jtotal'])
    assert sorted(parts) == sorted(m['jparts'])
    for k, want in m['jparts'].items():
        assert abs(float(parts[k]) - want) <= 1e-5 * max(abs(want), 1e-3), k
    tg = {n: p.grad for n, p in tm.named_parameters()}
    assert sorted(tg) == sorted(m['jg'])
    names = sorted(tg)
    cat = lambda d: torch.cat([d[n].flatten() for n in names])
    rel = _rel(cat(tg), cat(m['jg']))
    print(f'gradient: port vs JAX relative L2 {rel:.3g}')
    assert rel <= 1e-4
    scale = max(float(g.abs().max()) for g in m['jg'].values())
    for n in names:
        assert float((tg[n] - m['jg'][n]).abs().max()) <= 1e-5 * scale, n
    sd = tm.state_dict()
    for k, want in m['jstats'].items():
        close(sd[k], want.numpy(), 1e-5, k)


def test_tiny_ssd3d_loss_fn_matches_ssd3d_loss(tiny):
    """``detector_loss`` dispatches SSD3D's loss."""
    m = tiny
    with torch.no_grad():
        out = m['tm'].eval()(m['tb'])
    a = tdet.detector_loss(m['cfg'], m['tm'])(out, m['tb'])
    b = ssd3d_loss(m['cfg'], out, m['tb'])
    assert float(a[0]) == float(b[0]) and sorted(a[1]) == sorted(b[1])


# ---------------------------------------------------------------------------
# F12-F14 and the entry points
# ---------------------------------------------------------------------------


def test_f12_jax_build_detector_cannot_build_ssd3d_the_port_can():
    """JAX's build_detector passes vfe_remat, which SSD3D does not declare;
    the port builds ssd3d_once.yaml at its full widths, and refuses a
    detector it does not have, naming it (GraphRCNN's camera branch, once
    refused here, builds since: tests/test_torch_port_camera.py)."""
    with pytest.raises(TypeError, match='vfe_remat'):
        jdet.build_detector(j_cfg_from_yaml(str(YAML)))
    cfg = cfg_from_yaml_file(YAML)
    model = tdet.build_detector(cfg, 'cpu')
    assert type(model).__name__ == 'SSD3D'
    bb = model.backbone_3d
    assert bb.out_channels == 256 and bb.sa_0.out_channels == 64
    assert [len(getattr(bb, f'sa_{i}').samplers) for i in range(3)] == [1, 2,
                                                                        2]
    assert model.point_head.vote_sa.out_channels == 512 + 1024
    assert model.point_head.box_out.out_features == 6 + 2 * 12
    cfg.MODEL.NAME = 'PointRCNN'
    with pytest.raises(NotImplementedError, match='PointRCNN'):
        tdet.build_detector(cfg, 'cpu')


def yaml_sampler_cfg():
    """The tiny config with ssd3d_once.yaml's sampler structure: level 1
    lists two counts, one range and one method."""
    cfg = tiny_cfg()
    sa = cfg.MODEL.BACKBONE_3D.SA_CONFIG
    sa.NPOINTS = [[32], [8, 8], [4, 4]]
    sa.SAMPLE_RANGE = [[[0, -1]], [[0, 32]], [[0, 8], [8, 16]]]
    sa.SAMPLE_METHOD = [['d-fps'], ['f-fps'], ['f-fps', 'd-fps']]
    sa.RADIUS = [[0.5, 1.0], [1.0, 2.0], [2.0, 3.0]]
    sa.NSAMPLE = [[8, 8], [8, 8], [8, 8]]
    sa.MLPS = [[[8, 8], [8, 8]], [[16, 16], [16, 16]], [[16], [16]]]
    sa.AGGREGATION_MLPS = [[16], [32], [32]]
    cfg.MODEL.POINT_HEAD.VOTE_CONFIG.SAMPLE_RANGE = [0, 4]
    return cfg


def test_f13_yaml_sampler_structure_is_fusion_sampling():
    """JAX zips the level's lists, drops level 1's second count, and level 2
    then samples D-FPS from an empty range: ValueError. The port reads it
    as F-FPS for the first count and D-FPS for the second over the same
    range: level 1 holds 16 points, the first 8 F-FPS's and the next 8
    D-FPS's; other mismatches are refused naming the level."""
    cfg = yaml_sampler_cfg()
    batch = make_batch(np.random.RandomState(0))
    jm = JSSD3D(model_cfg=cfg['MODEL'], class_names=tuple(cfg.CLASS_NAMES))
    with pytest.raises(ValueError, match='empty'):
        jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b, False),
                       batch)
    tm = tdet.init_random_(tdet.build_detector(cfg, 'cpu'), seed=1)
    tb = {k: t(x) for k, x in batch.items()}
    with torch.no_grad():
        out = tm(tb)
    bb = out['backbone_out']
    assert [x.shape[1] for x in bb['sa_xyz']] == [64, 32, 16, 8]
    # level 1's centres from level 0's output, by the two samplers
    sa0 = tm.backbone_3d.sa_0
    with torch.no_grad():
        _, m0, f0, _ = sa0(tb['points'][..., :3], tb['point_mask'],
                           tb['points'][..., 3:])
    x0 = bb['sa_xyz'][1]
    want = torch.cat([tpn.farthest_point_sample_ffps(x0, f0, m0, 8),
                      tpn.farthest_point_sample(x0, m0, 8)], 1)
    exact(bb['sample_idx'][1], want)
    assert sampler_plan(1, [8, 8], [[0, 32]], ['f-fps']) == [
        (8, (0, 32), 'f-fps'), (8, (0, 32), 'd-fps')]
    for bad in (([8, 8], [[0, 32]], ['d-fps']),
                ([8], [[0, 32], [0, 8]], ['f-fps']),
                ([8, 8, 8], [[0, 32]], ['f-fps'])):
        with pytest.raises(ValueError, match='SA level 1'):
            sampler_plan(1, *bad)
    with pytest.raises(NotImplementedError, match='SA level 2'):
        sampler_plan(2, [8], [[0, 8]], ['s-fps'])


def ssd3d_post(thresh=0.3, pre=6, post=500, nms=0.01):
    return {'SCORE_THRESH': thresh, 'NMS_CONFIG': {
        'NMS_TYPE': 'nms_gpu', 'NMS_THRESH': nms, 'NMS_PRE_MAXSIZE': pre,
        'NMS_POST_MAXSIZE': post}}


def test_f14_candidates_cut_sorted_and_kept_in_score_order():
    """JAX's host_nms reads MODEL.DENSE_HEAD, which SSD3D's config lacks:
    KeyError. The port's candidates: the valid votes of score >=
    SCORE_THRESH, sorted by score (the valid first), the top
    NMS_PRE_MAXSIZE; host NMS keeps what the numpy NMS keeps of them in
    score order."""
    cfg = tiny_cfg()
    cfg.MODEL.POST_PROCESSING = ssd3d_post(nms=0.1)
    rng = np.random.RandomState(9)
    out, _, _ = planted_head_out(rng, B=2, K=24)
    # five valid votes of the first sample above the cut, two overlapping
    # pairs among them: the NMS drops one of each pair
    out['votes'][0, :5] = [[0, 0, 0], [0.2, 0, 0], [5, 5, 0], [5.1, 5, 0],
                           [9, -3, 0]]
    out['vote_mask'][0, :5] = True
    out['vote_cls_preds'][0, :5] = [[3.0], [2.5], [2.0], [1.5], [1.0]]
    out['vote_box_preds'][0, :5] = out['vote_box_preds'][0, :1]
    tout = {'head_out': {k: t(v) for k, v in out.items()}}
    boxes, scores, labels, valid = ssd3d_candidates(cfg, tout)
    with pytest.raises(KeyError, match='DENSE_HEAD'):
        jdet.host_nms(cfg, boxes.numpy(), scores.numpy(), labels.numpy(),
                      valid.numpy())
    p = ssd3d_predict(cfg, tout)
    assert boxes.shape == (2, 6, 7)
    for b in range(2):
        ok = (p['pred_valid'][b] & (p['pred_scores'][b] >= 0.3)).numpy()
        n = min(int(ok.sum()), 6)
        s = p['pred_scores'][b].numpy()
        want = np.sort(s[ok])[::-1][:n]
        exact(scores[b, :n], want)
        assert valid[b, :n].all() and not valid[b, n:].any()
        order = [int(np.flatnonzero((p['pred_boxes'][b].numpy() == x).all(
            -1))[0]) for x in boxes[b, :n].numpy()]
        exact(labels[b, :n], p['pred_labels'][b].numpy()[order])
    keep = tdet.host_nms(cfg, boxes, scores, labels, valid)
    for b in range(2):
        n = int(valid[b].sum())
        kept = nms_bev(boxes[b, :n].double().numpy(), scores[b, :n].numpy(),
                       0.1, post_maxsize=500)
        want = np.zeros(6, bool)
        want[kept] = True
        exact(keep[b], want)
    assert keep.sum() < valid.sum()


def test_nms_config_reads_dense_head_only_where_it_exists():
    """MODEL.POST_PROCESSING without a DENSE_HEAD (SSD3D), or with one that
    has no POST_PROCESSING (the anchor families); the dense head's when it
    has one (CenterPoint)."""
    post = ssd3d_post()
    cfg = {'MODEL': {'POST_PROCESSING': post}}
    assert tdet.nms_config(cfg) == post['NMS_CONFIG']
    cfg['MODEL']['DENSE_HEAD'] = {'NAME': 'AnchorHeadSingle'}
    assert tdet.nms_config(cfg) == post['NMS_CONFIG']
    other = ssd3d_post(nms=0.7)
    cfg['MODEL']['DENSE_HEAD']['POST_PROCESSING'] = other
    assert tdet.nms_config(cfg) == other['NMS_CONFIG']


def test_evaluator_ssd3d_branch(tiny):
    """The evaluator's SSD3D step gives ssd3d_candidates of the model's
    eval outputs."""
    cfg = copy.deepcopy(tiny['cfg'])
    tm = tiny['tm'].eval()
    with torch.no_grad():
        scores = ssd3d_predict(cfg, tm(tiny['tb']))['pred_scores']
    # a cut that keeps about half of the votes
    cfg.MODEL.POST_PROCESSING = ssd3d_post(thresh=float(scores.median()),
                                           pre=12)
    boxes, scores, labels, valid, overflow = make_eval_step(tm, cfg)(
        tiny['tb'])
    with torch.no_grad():
        want = ssd3d_candidates(cfg, tm(tiny['tb']))
    close(boxes, want[0].numpy(), 1e-6)
    exact(scores, want[1])
    exact(labels, want[2])
    exact(valid, want[3])
    assert overflow == 0 and boxes.shape == (2, 12, 7)
    assert 0 < valid.sum() < valid.size


def cli_cfg():
    """The tiny SSD3D on a synthetic dataset (64 points a frame)."""
    cfg = json.loads(json.dumps(make_cfg()))
    # ONCE's classes: its evaluation reads them
    cfg['CLASS_NAMES'] = ['Car', 'Bus', 'Truck', 'Pedestrian', 'Cyclist']
    cfg['MODEL']['POINT_HEAD']['TARGET_CONFIG']['BOX_CODER_CONFIG'][
        'mean_size'] = [[4.38, 1.87, 1.59], [11.11, 2.88, 3.41],
                        [7.52, 2.50, 2.62], [0.75, 0.76, 1.69],
                        [2.18, 0.79, 1.43]]
    cfg['DATA_CONFIG'] = {
        'DATASET': 'SyntheticONCEDataset',
        'POINT_CLOUD_RANGE': [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0],
        'DATA_SPLIT': {'train': 'train', 'test': 'val'},
        'NUM_SYNTHETIC_SAMPLES': 2, 'SYNTHETIC_POINTS': 256,
        'SYNTHETIC_BOXES': 3,
        'DATA_PROCESSOR': [{'NAME': 'mask_points_and_boxes_outside_range',
                            'REMOVE_OUTSIDE_BOXES': True}]}
    cfg['MODEL']['POST_PROCESSING'] = ssd3d_post(thresh=0.1, pre=4096)
    cfg['RUNTIME'] = {'MAX_POINTS': 64, 'MAX_VOXELS': [1], 'MAX_GT': 8}
    cfg['OPTIMIZATION'] = {'BATCH_SIZE_PER_GPU': 2, 'NUM_EPOCHS': 1,
                           'OPTIMIZER': 'adam', 'LR': 1e-3,
                           'WEIGHT_DECAY': 0.01, 'GRAD_NORM_CLIP': 10}
    return cfg


def test_cli_ssd3d_train_and_evaluate(tmp_path, monkeypatch):
    """``tools.train`` one epoch of the tiny SSD3D (finite loss), then
    ``tools.test`` on its checkpoint: result.pkl with the frames in order,
    every AP finite."""
    monkeypatch.setattr(train_cli, 'OUTPUT_ROOT', tmp_path / 'output')
    monkeypatch.setattr(test_cli, 'OUTPUT_ROOT', tmp_path / 'output')
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    path = tmp_path / 'cfgs' / 'once_models' / 'ssd3d_tiny.yaml'
    path.parent.mkdir(parents=True)
    path.write_text(yaml.safe_dump(cli_cfg()))
    run = train_cli.main(['--cfg_file', str(path), '--device', 'cpu',
                          '--fix_random_seed', '--epochs', '1'])
    assert run['steps'] and all(np.isfinite(s['loss'])
                                for s in run['steps'])
    (rdir, ap), = test_cli.main(['--cfg_file', str(path), '--device', 'cpu',
                                 '--ckpt', str(run['checkpoints'][-1])]
                                ).items()
    annos = pickle.loads((rdir / 'result.pkl').read_bytes())
    assert [a['frame_id'] for a in annos] == ['synth_000000', 'synth_000001']
    aps = [v for k, v in ap.items() if k.startswith('AP_')]
    assert aps and all(np.isfinite(aps))
