"""D-FPS's time a step on the card (kernel ``DFPS``, ``csrc/pointnet2.cu``).

    python3 -m tmae_tpu_torch.utils.pn2_phases [--parent PATH] [--sweep]
        [--cycles] [--json FILE]

Runs D-FPS at ssd3d_once.yaml's three levels (16384 -> 4096, 4096 -> 512
and 512 -> 256) at batch 1 and 2, on seeded points spread as a frame's (x
and y within 70 m, z within 3 m; the second sample other points, a tenth
of them invalid), and prints for each the ms of a call (CUDA events over
10 calls after a warm one) and the us a step (ms / S). Every call's
indices must equal the plain version's bit for bit.

``--parent PATH`` builds another ``pointnet2.cu`` (a parent checkout's)
beside this one with the same flags and runs both in the order parent,
this, this, parent; their indices must agree. ``--sweep`` also times this
version's kernel under every cluster plan (R CTAs of a sample, threads a
CTA, points a thread) that covers each level, at batch 1. ``--cycles``
builds the source again with ``-DTMAE_DFPS_PROFILE`` and prints, for each
level at batch 1 under the plan, the cycles a step of thread 0 of CTA 0 by
part: its points and argmax, the warp's argmax, the records' stores and
the cluster barrier, the records' argmax.

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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--parent', help='another pointnet2.cu to build and run '
                    'beside this one')
    ap.add_argument('--sweep', action='store_true',
                    help='time every cluster plan of each level')
    ap.add_argument('--cycles', action='store_true',
                    help='cycles a step by part (a profile build)')
    ap.add_argument('--json', help='write the readings here too')
    args = ap.parse_args(argv)

    import torch

    from ..ops import pointnet2 as pn2
    from .nms_phases import events_ms

    if not torch.cuda.is_available():
        print('pn2_phases: no CUDA device', file=sys.stderr)
        return 1
    build.build_all(('pointnet2.cu',))
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
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
    if args.cycles:
        res['cycles'] = step_cycles(torch, log=lambda x: print(x, flush=True))
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(res, f)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
