"""D-FPS's and F-FPS's time a step, and ball query's time a grouping, on
the card (kernels ``DFPS``, ``FFPS`` and ``BALL_QUERY``,
``csrc/pointnet2.cu``).

    python3 -m tmae_tpu_torch.utils.pn2_phases [--parent PATH] [--sweep]
        [--cycles] [--ball] [--json FILE]

Runs D-FPS at ssd3d_once.yaml's three levels (16384 -> 4096, 4096 -> 512
and 512 -> 256) and F-FPS at its two (4096 -> 512 with 64 feature
channels, 512 -> 256 with 128), at batch 1 and 2, on seeded points spread
as a frame's (x and y within 70 m, z within 3 m; the second sample other
points, a tenth of them invalid) and features as a ReLU's (|N(0, 1)| or
0), and prints for each the ms of a call (CUDA events over 10 calls after
a warm one), the us a step (ms / S) and, for F-FPS, the device memory a
call allocates beyond what is held (the matrix routes' [B, N, N] scratch)
and each launch's device ms (``torch.profiler``).
Every call's indices must equal the plain version's bit for bit.

``--parent PATH`` builds another ``pointnet2.cu`` (a parent checkout's)
beside this one with the same flags and runs both in the order parent,
this, this, parent; their indices must agree. ``--sweep`` also times this
version's kernels under every cluster plan (R CTAs of a sample, threads a
CTA, points a thread; for F-FPS also the channels in registers) that
covers each level, at batch 1. ``--cycles`` builds the source again with
``-DTMAE_DFPS_PROFILE`` and prints, for each D-FPS level at batch 1 under
the plan, the cycles a step of thread 0 of CTA 0 by part: its points and
argmax, the warp's argmax, the records' stores and the cluster barrier,
the records' argmax; then builds it with ``-DTMAE_FFPS_PROFILE`` and
prints for each F-FPS level under its 'cluster' plan the cycles a step by
part (distances and the thread's argmax, the warp's argmax, the CTA's
argmax and the record's stores, the wait for the records, the records'
argmax).

``--ball`` runs BALL_QUERY alone (:func:`ball_phase`): each grouping of
ssd3d_once.yaml's frame (levels 0-2 and the vote head's SA) in one call
over frame-like points, batch 1 and 2, and level 0's last radius alone;
device ms by launch, host enqueue and events ms, the bound; with
``--parent`` the parent's calls beside it (one a radius where its
launcher takes one radius), with ``--sweep`` every plan (CW, S) by device
time.

Prints one line a reading and the readings as JSON on the last line (and
into ``--json``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

from . import build

LEVELS = ((16384, 4096), (4096, 512), (512, 256))
# F-FPS: (N, S, feature channels)
FFPS_LEVELS = ((4096, 512, 64), (512, 256, 128))
CALLS = 10


def points(torch, B, N, seed):
    """[B, N, 3] coordinates and a [B, N] mask on the card: sample 0 all
    valid, sample 1 (other points) with a tenth invalid."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    xy = (torch.rand(B, N, 2, generator=g, device='cuda') - 0.5) * 140.0
    z = (torch.rand(B, N, 1, generator=g, device='cuda') - 0.5) * 6.0
    mask = torch.ones(B, N, dtype=torch.bool, device='cuda')
    if B > 1:
        mask[1:] = torch.rand(B - 1, N, generator=g, device='cuda') > 0.1
    return torch.cat([xy, z], -1), mask


def features(torch, B, N, C, seed):
    """[B, N, C] features as a ReLU's output, on the card."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    return torch.relu(torch.randn(B, N, C, generator=g, device='cuda'))


def parent_dfps(path):
    """A function (points, mask, S) -> indices that runs another
    ``pointnet2.cu``'s DFPS: its ``launch_dfps_cluster`` with this
    version's plan when it has one, else its one-block
    ``launch_dfps(xyz, mask, B, N, S, out, stream)``."""
    import ctypes

    import torch

    from ..ops import pointnet2 as pn2

    lib = build.build_file(path, 'pointnet2.cu', 'parent')
    P, I = build.P, build.I
    names = ctypes.CDLL(str(lib))
    cluster = hasattr(names, 'launch_dfps_cluster')
    kernel = (build.CudaKernel('pointnet2.cu', 'launch_dfps_cluster',
                               pn2.DFPS.argtypes, path=lib) if cluster
              else build.CudaKernel('pointnet2.cu', 'launch_dfps',
                                    [P, P, I, I, I, P, P], path=lib))

    def run(pts, mask, S):
        B, N = mask.shape
        out = torch.empty(B, S, dtype=torch.int32, device=pts.device)
        if cluster:
            kernel(pts.data_ptr(), mask.data_ptr(), B, N, S,
                   *pn2.dfps_plan(N), out.data_ptr(), build.stream_handle())
        else:
            kernel(pts.data_ptr(), mask.data_ptr(), B, N, S, out.data_ptr(),
                   build.stream_handle())
        return out

    return run


def parent_ffps(path):
    """A function (xyz, feat, mask, S, gamma=1) -> indices that runs another
    ``pointnet2.cu``'s FFPS: its ``launch_ffps`` under this version's plan
    when it takes one (``int route``), else with the distance matrix
    ``launch_ffps(xyz, feat, mask, B, N, C, S, gamma, dm, out, stream)``."""
    from pathlib import Path

    import torch

    from ..ops import pointnet2 as pn2

    src = Path(path)
    planned = 'int route' in src.read_text()
    lib = build.build_file(src, 'pointnet2.cu', 'parent')
    P, I, F = build.P, build.I, build.F
    kernel = build.CudaKernel(
        'pointnet2.cu', 'launch_ffps',
        pn2.FFPS.argtypes if planned else [P, P, P, I, I, I, I, F, P, P, P],
        path=lib)

    def run(xyz, feat, mask, S, gamma=1.0):
        B, N = mask.shape
        C = 0 if feat is None else feat.shape[-1]
        fp = 0 if feat is None else feat.data_ptr()
        out = torch.empty(B, S, dtype=torch.int32, device=xyz.device)
        plan = pn2.ffps_plan(N, C) if planned else None
        dm = (torch.empty(B, N, N, dtype=torch.float32, device=xyz.device)
              if not planned or plan.route != 'cluster' else None)
        ptr = 0 if dm is None else dm.data_ptr()
        if planned:
            kernel(xyz.data_ptr(), fp, mask.data_ptr(), B, N, C, S,
                   float(gamma), pn2.FFPS_ROUTES[plan.route], *plan[1:],
                   ptr, out.data_ptr(), build.stream_handle())
        else:
            kernel(xyz.data_ptr(), fp, mask.data_ptr(), B, N, C, S,
                   float(gamma), ptr, out.data_ptr(), build.stream_handle())
        return out

    return run


def ffps_plan_run(plan, kernel=None):
    """This version's FFPS (or ``kernel``, another build of it) under a
    given plan (route, R, threads, per, creg)."""
    import torch

    from ..ops import pointnet2 as pn2

    kernel = kernel or pn2.FFPS

    def run(xyz, feat, mask, S):
        B, N = mask.shape
        out = torch.empty(B, S, dtype=torch.int32, device=xyz.device)
        dm = (None if plan[0] == 'cluster' else
              torch.empty(B, N, N, dtype=torch.float32, device=xyz.device))
        kernel(xyz.data_ptr(), feat.data_ptr(), mask.data_ptr(), B, N,
               feat.shape[-1], S, 1.0, pn2.FFPS_ROUTES[plan[0]], *plan[1:],
               0 if dm is None else dm.data_ptr(), out.data_ptr(),
               build.stream_handle())
        return out

    return run


def ffps_sweep_plans(N, C):
    """The matrix route, and every cluster plan ('cluster', R, threads,
    per, creg) with R in 2..16 and threads 64..512 (powers of 2), the
    fewest points a thread that cover N, and the most channels in
    registers the kernel takes there (and none), whose shared memory
    fits."""
    from ..ops import pointnet2 as pn2

    out = [('matrix', 0, 0, 0, 0)]
    for R in (2, 4, 8, 16):
        for threads in (64, 128, 256, 512):
            per = 1
            while R * threads * per < N and per < pn2.DFPS_MAX_PER:
                per *= 2
            if R * threads * per < N or (per > 1 and
                                         R * threads * per >= 2 * N):
                continue
            if pn2.ffps_smem(C, threads, per) > pn2.FFPS_SMEM_MAX:
                continue
            for creg in pn2.FFPS_REG_CHANNELS:
                if creg > C or per * creg > 128 or (
                        threads > 256 and per * creg >= 128):
                    continue
                out.append(('cluster', R, threads, per, creg))
                if creg:
                    out.append(('cluster', R, threads, per, 0))
                break
    return out


def plan_run(plan):
    """This version's DFPS under a given plan (R, threads, points)."""
    import torch

    from ..ops import pointnet2 as pn2

    def run(pts, mask, S):
        B, N = mask.shape
        out = torch.empty(B, S, dtype=torch.int32, device=pts.device)
        pn2.DFPS(pts.data_ptr(), mask.data_ptr(), B, N, S, *plan,
                 out.data_ptr(), build.stream_handle())
        return out

    return run


def sweep_plans(N):
    """Every (R, threads, points) with R in 1..16 and threads 64..256
    (powers of 2) and the fewest points a thread (at most DFPS_MAX_PER)
    that cover N."""
    from ..ops import pointnet2 as pn2

    out = []
    for R in (1, 2, 4, 8, 16):
        for threads in (64, 128, 256):
            per = 1
            while R * threads * per < N and per < pn2.DFPS_MAX_PER:
                per *= 2
            if R * threads * per >= N and (R == 1 or
                                           R * threads * per < 2 * N
                                           or per == 1):
                out.append((R, threads, per))
    return out


CYCLE_PARTS = ('points and thread argmax', 'warp argmax',
               'record stores and cluster barrier', 'records argmax')


def step_cycles(torch, log=print):
    """DFPS built with -DTMAE_DFPS_PROFILE, each level at batch 1 under the
    plan, one call after a warm one: {level: {part: cycles a step}}."""
    import ctypes

    from ..ops import pointnet2 as pn2

    lib = build.build_file(build.CSRC / 'pointnet2.cu', 'pointnet2.cu',
                           'profile', extra=('-DTMAE_DFPS_PROFILE',))
    read = ctypes.CDLL(str(lib)).tmae_dfps_profile
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    read.restype = ctypes.c_int
    kernel = build.CudaKernel('pointnet2.cu', 'launch_dfps_cluster',
                              pn2.DFPS.argtypes, path=lib)
    cyc = (ctypes.c_ulonglong * 4)()
    out = {}
    for N, S in LEVELS:
        pts, m = points(torch, 1, N, seed=N + 1)
        o = torch.empty(1, S, dtype=torch.int32, device='cuda')
        for _ in range(2):
            if read(cyc):
                raise RuntimeError('tmae_dfps_profile failed')
            kernel(pts.data_ptr(), m.data_ptr(), 1, N, S, *pn2.dfps_plan(N),
                   o.data_ptr(), build.stream_handle())
            torch.cuda.synchronize()
        if read(cyc):
            raise RuntimeError('tmae_dfps_profile failed')
        out[f'{N}->{S}'] = {p: cyc[i] / S for i, p in enumerate(CYCLE_PARTS)}
        log(f'DFPS {N} -> {S} plan {pn2.dfps_plan(N)}: cycles a step '
            + ', '.join(f'{p} {c:.0f}' for p, c in out[f'{N}->{S}'].items())
            + f'; total {sum(out[f"{N}->{S}"].values()):.0f}')
    return out


FFPS_PARTS = ('distances and thread argmax', 'warp argmax',
              'CTA argmax and record stores', 'wait for the records',
              'records argmax')


def ffps_cycles(torch, log=print):
    """F-FPS built with -DTMAE_FFPS_PROFILE, each level at batch 1 under
    the 'cluster' plan (``ffps_cluster_plan``: the route that computes the
    distances afresh), one call after a warm one: {level: {part: cycles a
    step}}."""
    import ctypes

    from ..ops import pointnet2 as pn2

    lib = build.build_file(build.CSRC / 'pointnet2.cu', 'pointnet2.cu',
                           'ffps-profile', extra=('-DTMAE_FFPS_PROFILE',))
    read = ctypes.CDLL(str(lib)).tmae_ffps_profile
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    read.restype = ctypes.c_int
    run_with = build.CudaKernel('pointnet2.cu', 'launch_ffps',
                                pn2.FFPS.argtypes, path=lib)
    cyc = (ctypes.c_ulonglong * len(FFPS_PARTS))()
    out = {}
    for N, S, C in FFPS_LEVELS:
        pts, m = points(torch, 1, N, seed=N + 1)
        f = features(torch, 1, N, C, seed=N + 1)
        plan = pn2.ffps_cluster_plan(N, C)
        run = ffps_plan_run(plan, run_with)
        for _ in range(2):
            if read(cyc):
                raise RuntimeError('tmae_ffps_profile failed')
            got = run(pts, f, m, S)
            torch.cuda.synchronize()
        if read(cyc):
            raise RuntimeError('tmae_ffps_profile failed')
        key = f'{N}->{S} C={C}'
        if not torch.equal(got, pn2.farthest_point_sample_ffps_plain(
                pts, f, m, S)):
            raise AssertionError(f'FFPS profile {key}: indices differ')
        out[key] = {p: cyc[i] / S for i, p in enumerate(FFPS_PARTS)}
        log(f'FFPS {key} plan {tuple(plan)}: cycles a step '
            + ', '.join(f'{p} {c:.0f}' for p, c in out[key].items())
            + f'; total {sum(out[key].values()):.0f}')
    return out


# BALL_QUERY at ssd3d_once.yaml's groupings: (label, points, centres,
# radii, slots, dilated)
BALL_LEVELS = (('level 0', 16384, 4096, (0.2, 0.4, 0.8), (32, 32, 64), True),
               ('level 1', 4096, 1024, (0.8, 1.6, 3.2), (32, 32, 64), True),
               ('level 2', 1024, 512, (1.6, 3.2, 4.8), (32, 32, 32), True),
               ('vote SA', 512, 256, (4.8, 6.4), (48, 64), False))
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def frame_points(torch, B, N, seed):
    """[B, N, 3] points spread as a LiDAR frame's (range 1-70 m uniform, so
    denser near the sensor; 60% on the ground near z = -1.6, the rest up to
    2 m) and a [B, N] mask (a tenth of sample 1's invalid), on the card."""
    import math

    g = torch.Generator(device='cuda').manual_seed(seed)
    u = lambda *shape: torch.rand(*shape, generator=g, device='cuda')
    r = 1.0 + 69.0 * u(B, N)
    th = 2 * math.pi * u(B, N)
    ground = u(B, N) < 0.6
    z = torch.where(ground, -1.6 + 0.1 * torch.randn(
        B, N, generator=g, device='cuda'), -1.5 + 3.5 * u(B, N))
    mask = torch.ones(B, N, dtype=torch.bool, device='cuda')
    if B > 1:
        mask[1:] = u(B - 1, N) > 0.1
    return torch.stack([r * torch.cos(th), r * torch.sin(th), z], -1), mask


def ball_inputs(torch, B, seed=0):
    """Each BALL_LEVELS grouping's (points, mask, centres, centre mask): the
    frame's points, then each level's D-FPS centres as the next level's
    points; the vote SA's centres are level 2's first 256 moved by up to
    (3, 3, 2) m."""
    from ..ops import pointnet2 as pn2

    pts, m = frame_points(torch, B, BALL_LEVELS[0][1], seed)
    out = []
    for label, N, M, *_ in BALL_LEVELS:
        if label == 'vote SA':
            g = torch.Generator(device='cuda').manual_seed(seed + 1)
            jitter = (torch.rand(B, M, 3, generator=g, device='cuda') - 0.5)
            ctr = pts[:, :M] + jitter * torch.tensor([6.0, 6.0, 4.0],
                                                     device='cuda')
            out.append((pts, m, ctr, m[:, :M].clone()))
            break
        idx = pn2.farthest_point_sample(pts, m, M)
        ctr, cm = pn2.gather_points(pts, idx), m.gather(1, idx.long())
        out.append((pts, m, ctr, cm))
        pts, m = ctr, cm
    return out


def parent_ball(path):
    """A function (radii, mins, ks, pts, mask, ctr, cmask) -> [(idx, cnt)]
    that runs another ``pointnet2.cu``'s BALL_QUERY: one multi-radius
    launch where its launcher takes the radii (``int R``), else one
    single-radius ``launch_ball_query(xyz, mask, centers, center_mask, B,
    N, M, K, r2, min_r2, dilated, idx, cnt, stream)`` a radius."""
    from pathlib import Path

    import torch

    from ..ops import pointnet2 as pn2

    src = Path(path)
    launcher = src.read_text().split('int launch_ball_query(')[1]
    multi = 'int R,' in launcher.split(')')[0]
    lib = build.build_file(src, 'pointnet2.cu', 'parent')
    P, I, F = build.P, build.I, build.F
    kernel = build.CudaKernel(
        'pointnet2.cu', 'launch_ball_query',
        pn2.BALL_QUERY.argtypes if multi else
        [P, P, P, P, I, I, I, I, F, F, I, P, P, P], path=lib)

    def run(radii, mins, ks, pts, mask, ctr, cmask):
        if multi:
            return pn2._ball_query_card(radii, mins, ks, pts, mask, ctr,
                                        cmask, kernel=kernel)
        B, N, _ = pts.shape
        M = ctr.shape[1]
        out = []
        for r, lo, k in zip(radii, mins, ks):
            idx = torch.empty(B, M, k, dtype=torch.int32, device='cuda')
            cnt = torch.empty(B, M, dtype=torch.int32, device='cuda')
            kernel(pts.data_ptr(), mask.data_ptr(), ctr.data_ptr(),
                   cmask.data_ptr(), B, N, M, k, pn2._f32(r * r),
                   pn2._f32(lo * lo), int(lo > 0.0), idx.data_ptr(),
                   cnt.data_ptr(), build.stream_handle())
            out.append((idx, cnt))
        return out

    return run


def ball_work(pts_mask, M, radii, ks):
    """(bytes, f32 operations) of one BALL_QUERY call over every radius:
    the points (13 bytes) and centres (13 a row) read once, each idx and
    count written once; 8 operations a (centre, valid point) pair for its
    squared distance and 2 a radius for its shell's test."""
    B, N = pts_mask.shape
    nv = int(pts_mask.sum())
    return (B * (N * 13 + M * 13 + M * 4 * (sum(ks) + len(radii))),
            M * nv * (8 + 2 * len(radii)))


def ball_bound_ms(pts_mask, M, radii, ks):
    """BALL_QUERY's least time for one call: :func:`ball_work`'s bytes
    over the memory rate or its operations over the f32 rate."""
    nbytes, ops = ball_work(pts_mask, M, radii, ks)
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def ball_phase(torch, parent=None, sweep=False, log=print):
    """BALL_QUERY at BALL_LEVELS, batch 1 and 2, each grouping's radii in
    one call (and the parent's, in the order parent, this, this, parent;
    a parent without the multi-radius launcher takes one call a radius),
    then the one-radius call of level 0's last radius (4096 x 16384, r
    0.8, K 64); each version's idx and cnt bit-equal to the plain
    version's. Readings: device ms by launch, host enqueue ms, events ms;
    the frame's sum over the groupings. ``sweep``: every plan (CW in 1, 2,
    4, 8; S in 1, 2, 4, 8) at batch 1 and 2, device ms by launch."""
    from ..ops import pointnet2 as pn2
    from .fwd_phases import by_launch
    from .nms_phases import readings

    runs = {'change': lambda radii, mins, ks, *a: pn2._ball_query_card(
        list(radii), list(mins), list(ks), *a)}
    versions = ['change']
    if parent:
        runs['parent'] = parent_ball(parent)
        versions = ['parent', 'change', 'change', 'parent']
    res = {}
    for B in (1, 2):
        inputs = ball_inputs(torch, B, seed=B)
        cases = []
        for (label, N, M, radii, ks, dil), args in zip(BALL_LEVELS, inputs):
            mins = pn2._min_radii(radii, dil)
            cases.append((label, radii, mins, ks, args))
        label, radii, mins, ks, args = cases[0]
        cases.append(('level 0, r 0.8 K 64 alone', radii[2:], mins[2:],
                      ks[2:], args))
        frame = {v: 0.0 for v in versions}
        for label, radii, mins, ks, args in cases:
            want = [pn2.ball_query_plain(r, k, *args, lo)
                    for r, lo, k in zip(radii, mins, ks)]
            per = {v: [] for v in versions}
            for v in versions:
                got = runs[v](radii, mins, ks, *args)
                torch.cuda.synchronize()
                for (gi, gc), (wi, wc), r in zip(got, want, radii):
                    if not (torch.equal(gi, wi) and torch.equal(gc, wc)):
                        raise AssertionError(
                            f'BALL_QUERY {v} {label} r {r} B={B}: idx or '
                            'cnt differ from the plain version\'s')
                per[v].append(readings(torch, lambda: runs[v](
                    radii, mins, ks, *args)))
            key = f'{label} B={B}'
            pts, m, ctr, cm = args
            mean_cnt = [float(c.float().mean()) for _, c in want]
            res[key] = {'points': pts.shape[1], 'centres': ctr.shape[1],
                        'radii': list(radii), 'mean_count': mean_cnt,
                        'bound_ms': ball_bound_ms(m, ctr.shape[1], radii, ks),
                        'plan': list(pn2.ball_query_plan(
                            B, ctr.shape[1], pts.shape[1]))}
            for v in dict.fromkeys(versions):
                rs = per[v]
                rd = {k: statistics.fmean(r[k] for r in rs)
                      for k in ('host_ms', 'ms')}
                rd['device_ms'] = (statistics.fmean(r['device_ms'] for r in rs)
                                   if all(r['device_ms'] for r in rs)
                                   else None)
                rd['by_launch'] = [r['by_launch'] for r in rs]
                rd['runs_device_ms'] = [r['device_ms'] for r in rs]
                res[key][v] = rd
                if 'alone' not in label and rd['device_ms']:
                    frame[v] += rd['device_ms']
                log(f'BALL_QUERY {key} {v}: device {rd["device_ms"]} ms a '
                    f'call (runs {rd["runs_device_ms"]}), host enqueue '
                    f'{rd["host_ms"]:.4f} ms, events {rd["ms"]:.4f} ms; '
                    f'bound {res[key]["bound_ms"]:.5f} ms; plan '
                    f'{res[key]["plan"]}; mean count '
                    + ', '.join(f'{c:.1f}' for c in mean_cnt))
        res[f'frame B={B}'] = frame
        log(f'BALL_QUERY a frame\'s groupings B={B}: device ms '
            + ', '.join(f'{v} {ms:.4f}' for v, ms in frame.items()))
    if sweep:
        res['sweep'] = {}
        for B in (1, 2):
            for (label, N, M, radii, ks, dil), args in zip(
                    BALL_LEVELS, ball_inputs(torch, B, seed=B)):
                mins = pn2._min_radii(radii, dil)
                want = [pn2.ball_query_plain(r, k, *args, lo)
                        for r, lo, k in zip(radii, mins, ks)]
                for cw in (1, 2, 4, 8):
                    for S in (1, 2, 4, 8):
                        call = lambda: pn2._ball_query_card(
                            list(radii), mins, list(ks), *args,
                            plan=(cw, S))
                        got = call()
                        torch.cuda.synchronize()
                        if not all(torch.equal(g[0], w[0]) and torch.equal(
                                g[1], w[1]) for g, w in zip(got, want)):
                            raise AssertionError(f'BALL_QUERY {label} plan '
                                                 f'{(cw, S)}: bits differ')
                        ms = sum(t for _, t in by_launch(torch, call,
                                                         calls=5))
                        res['sweep'][f'{label} B={B} CW={cw} S={S}'] = ms
                        log(f'BALL_QUERY {label} B={B} plan CW={cw} S={S}: '
                            f'device {ms:.4f} ms')
    return res


def peak_gib(torch, fn):
    """Device memory (GiB) one call of ``fn`` allocates beyond what is
    held before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--parent', help='another pointnet2.cu to build and run '
                    'beside this one')
    ap.add_argument('--sweep', action='store_true',
                    help='time every cluster plan of each level')
    ap.add_argument('--cycles', action='store_true',
                    help='cycles a step by part (a profile build)')
    ap.add_argument('--ball', action='store_true',
                    help='BALL_QUERY only: each grouping of a frame')
    ap.add_argument('--json', help='write the readings here too')
    args = ap.parse_args(argv)

    import torch

    from ..ops import pointnet2 as pn2
    from .fwd_phases import by_launch
    from .nms_phases import events_ms

    if not torch.cuda.is_available():
        print('pn2_phases: no CUDA device', file=sys.stderr)
        return 1
    build.build_all(('pointnet2.cu',))
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    if args.ball:
        res = {'card': card, 'ball': ball_phase(
            torch, args.parent, args.sweep,
            log=lambda x: print(x, flush=True))}
        if args.json:
            with open(args.json, 'w') as f:
                json.dump(res, f)
        print(json.dumps(res), flush=True)
        return 0
    runs = {'change': lambda pts, m, S: pn2.farthest_point_sample(pts, m, S)}
    versions = ['change']
    if args.parent:
        runs['parent'] = parent_dfps(args.parent)
        versions = ['parent', 'change', 'change', 'parent']
    res = {'card': card}
    for N, S in LEVELS:
        for B in (1, 2):
            pts, m = points(torch, B, N, seed=N + B)
            want = pn2.farthest_point_sample_plain(pts, m, S)
            times = {v: [] for v in versions}
            for v in versions:
                got = runs[v](pts, m, S)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f'DFPS {v} {N} -> {S} B={B}: '
                                         'indices differ from the plain '
                                         'version\'s')
                times[v].append(events_ms(torch, lambda: runs[v](pts, m, S),
                                          iters=CALLS, warmup=1))
            key = f'{N}->{S} B={B}'
            res[key] = {}
            for v in dict.fromkeys(versions):
                ms = statistics.fmean(times[v])
                res[key][v] = {'ms': ms, 'us_a_step': 1e3 * ms / S,
                               'runs_ms': times[v]}
                print(f'DFPS {key} {v}: {ms:.4f} ms a call, '
                      f'{1e3 * ms / S:.3f} us a step (runs '
                      + ', '.join(f'{t:.4f}' for t in times[v]) + ')',
                      flush=True)
    fruns = {'change': lambda x, f, m, S: pn2.farthest_point_sample_ffps(
        x, f, m, S)}
    if args.parent:
        fruns['parent'] = parent_ffps(args.parent)
    for N, S, C in FFPS_LEVELS:
        for B in (1, 2):
            pts, m = points(torch, B, N, seed=N + B)
            f = features(torch, B, N, C, seed=N + B)
            want = pn2.farthest_point_sample_ffps_plain(pts, f, m, S)
            times = {v: [] for v in versions}
            for v in versions:
                got = fruns[v](pts, f, m, S)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f'FFPS {v} {N} -> {S} C={C} B={B}: '
                                         'indices differ from the plain '
                                         'version\'s')
                times[v].append(events_ms(
                    torch, lambda: fruns[v](pts, f, m, S), iters=CALLS,
                    warmup=1))
            key = f'FFPS {N}->{S} C={C} B={B}'
            res[key] = {'plan': list(pn2.ffps_plan(N, C))}
            for v in dict.fromkeys(versions):
                ms = statistics.fmean(times[v])
                gib = peak_gib(torch, lambda: fruns[v](pts, f, m, S))
                launches = dict(by_launch(
                    torch, lambda: fruns[v](pts, f, m, S), calls=3))
                res[key][v] = {'ms': ms, 'us_a_step': 1e3 * ms / S,
                               'runs_ms': times[v], 'peak_gib': gib,
                               'by_launch': launches}
                print(f'{key} {v}: {ms:.4f} ms a call, {1e3 * ms / S:.3f} '
                      f'us a step, {gib:.4f} GiB allocated; device by '
                      'launch ' + ', '.join(f'{n} {t:.4f}' for n, t in
                                            launches.items())
                      + ' (runs ' + ', '.join(f'{t:.4f}' for t in times[v])
                      + ')', flush=True)
    if args.sweep:
        res['sweep'] = {}
        for N, S in LEVELS:
            pts, m = points(torch, 1, N, seed=N + 1)
            want = pn2.farthest_point_sample_plain(pts, m, S)
            for plan in sweep_plans(N):
                run = plan_run(plan)
                try:
                    got = run(pts, m, S)
                    torch.cuda.synchronize()
                except RuntimeError as e:  # a plan the card refuses
                    print(f'DFPS {N} -> {S} plan {plan}: refused ({e})',
                          flush=True)
                    continue
                if not torch.equal(got, want):
                    raise AssertionError(f'DFPS {N} -> {S} plan {plan}: '
                                         'indices differ')
                ms = events_ms(torch, lambda: run(pts, m, S), iters=CALLS,
                               warmup=1)
                res['sweep'][f'{N}->{S} {plan}'] = ms
                print(f'DFPS {N} -> {S} plan R={plan[0]} threads={plan[1]} '
                      f'points={plan[2]}: {ms:.4f} ms, '
                      f'{1e3 * ms / S:.3f} us a step', flush=True)
    if args.sweep:
        for N, S, C in FFPS_LEVELS:
            pts, m = points(torch, 1, N, seed=N + 1)
            f = features(torch, 1, N, C, seed=N + 1)
            want = pn2.farthest_point_sample_ffps_plain(pts, f, m, S)
            for plan in ffps_sweep_plans(N, C):
                run = ffps_plan_run(plan)
                try:
                    got = run(pts, f, m, S)
                    torch.cuda.synchronize()
                except RuntimeError as e:  # a plan the card refuses
                    print(f'FFPS {N} -> {S} plan {plan}: refused ({e})',
                          flush=True)
                    continue
                if not torch.equal(got, want):
                    raise AssertionError(f'FFPS {N} -> {S} plan {plan}: '
                                         'indices differ')
                ms = events_ms(torch, lambda: run(pts, f, m, S), iters=CALLS,
                               warmup=1)
                res['sweep'][f'FFPS {N}->{S} C={C} {plan}'] = ms
                print(f'FFPS {N} -> {S} C={C} plan {plan[0]} R={plan[1]} '
                      f'threads={plan[2]} points={plan[3]} '
                      f'registers={plan[4]}: {ms:.4f} ms, '
                      f'{1e3 * ms / S:.3f} us a step', flush=True)
    if args.cycles:
        res['cycles'] = step_cycles(torch, log=lambda x: print(x, flush=True))
        res['ffps_cycles'] = ffps_cycles(torch,
                                         log=lambda x: print(x, flush=True))
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(res, f)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
