"""Where the fused training backward (K7 / K9, ``csrc/encoder_layer_bwd.cu``)
spends its time, phase by phase, on the card; with ``--narrow``, where
NARROW_BWD (``csrc/encoder_layer_narrow.cu``) spends it, launch by launch.

    python3 -m tmae_tpu_torch.utils.bwd_phases [--live 0.56]
    python3 -m tmae_tpu_torch.utils.bwd_phases --narrow [--parent PATH]
        [--cycles] [--json FILE]

Builds the library a second time with ``-DTMAE_BWD_PROFILE`` (each block
of the window pass then adds the clock cycles of every phase of its tiles
into a device array), runs K9 (S=16) and K7 on seeded random inputs at the
C=128 self shapes of the t_mae.yaml training batch (2560 and 512 bucket
slots, the last quarter of them padding, and a fraction ``--live`` of the
windows with a nonzero cotangent), and prints each call's time (CUDA
events, the normal build) and each phase's share of the window pass's
cycles (the profiling build).

``--narrow`` runs NARROW_BWD (the T = 64 self backward, with dpos, as the
full bucket's and the grid's training calls run it) at (C, heads) = (64,
8), (64, 4) and (32, 4) on seeded random windows in three regimes, each
named by the path it stands for: (a) phase 4's stage-1 full bucket, 256
slots of which 109 have a nonzero cotangent on a query cell (fewer tiles
than SMs); (b) the stage-1 grid of a t_mae_mini.yaml step, 76 windows
with a query, all live; (c) chip_smoke 18a's stage-1 grid backward on the
2x468x468 grid, 875 windows, all live (more tiles than SMs). For each it
prints the device ms of each launch (``torch.profiler``), the host ms to
enqueue a call and the CUDA-event ms of a call. ``--parent PATH`` builds
another ``encoder_layer_narrow.cu`` (a parent checkout's) beside this one,
runs both in the order parent, this, this, parent, and prints the largest
difference of their outputs; each version must give the same bits twice.
``--cycles`` builds the source again with ``-DTMAE_NARROW_PROFILE`` and
prints, for regime (a) at each width, the window pass's cycles a tile and
their shares by phase (thread 0 of each block, summed over the blocks).
The readings go to the last line as JSON (and to ``--json``). Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import statistics
import subprocess
import sys
import threading

import numpy as np

from . import build

PHASES = ('P0 live test', 'P1 gather', 'P2 v, q, k', 'P3 attention',
          'P4 o, LN1', 'P5 FFN', 'P6 LN2 fwd+bwd', 'P7 FFN bwd',
          'P8 LN1 bwd', 'P9 da', 'P10 gather again', 'P11 attention bwd',
          'P12 dx, dkv', 'P13 expand (K9)', 'dead tiles', '-')


def profiled_library() -> ctypes.CDLL:
    """encoder_layer_bwd.cu built with -DTMAE_BWD_PROFILE (into _build)."""
    src = build.CSRC / 'encoder_layer_bwd.cu'
    out = build._target('encoder_layer_bwd.cu').with_suffix('.profile.so')
    if not out.exists():
        flags = [f for f in build.NVCC_FLAGS if f not in ('-Xptxas', '-v')]
        subprocess.run([build._nvcc(), *flags, '-DTMAE_BWD_PROFILE', '-o',
                        str(out), str(src)], check=True)
    return ctypes.CDLL(str(out))


def random_case(torch, N, T, C, live, seed=0):
    """Layer inputs as the bucket plans give them: windows with zeros at
    unoccupied cells, the last quarter padding (no query cell),
    occupied-first selections for T < 64, and a cotangent that is 0 on all
    but a fraction ``live`` of the windows."""
    rng = np.random.RandomState(seed)
    dev = 'cuda'
    bf = lambda a: torch.tensor(np.asarray(a, np.float32),
                                device=dev).to(torch.bfloat16)
    F = 2 * C
    occ = rng.rand(N, 64) < rng.uniform(0.05, 0.6, (N, 1))
    occ[N - N // 4:] = False
    xw = bf(np.where(occ[..., None], rng.normal(0, 1, (N, 64, C)), 0))
    lin = lambda o, i: (rng.normal(0, 1, (o, i)) / np.sqrt(i)).astype(
        np.float32)
    vec = lambda n, m=0.0: (m + 0.1 * rng.normal(size=(n,))).astype(
        np.float32)
    w = [lin(C, C), vec(C), lin(C, C), vec(C), lin(C, C), vec(C), lin(C, C),
         vec(C), np.asarray([0.3], np.float32), vec(C, 1.0), vec(C),
         lin(F, C), vec(F), lin(C, F), vec(C), vec(C, 1.0), vec(C)]
    weights = [torch.tensor(a, device=dev) for a in w]
    pos = bf(rng.normal(0, 0.5, (64, C)))
    sq, qm = None, occ
    if T < 64:
        s = np.argsort(-(occ * (64 - np.arange(64))), -1, kind='stable')
        s = s[:, :T].astype(np.int32)
        sq, qm = torch.tensor(s, device=dev), np.take_along_axis(occ, s, -1)
    qm = torch.tensor(qm.astype(np.float32), device=dev)
    g = rng.normal(0, 1, (N, 64, C))
    g[rng.rand(N) >= live] = 0
    return (xw, None, sq, None, qm, None, pos), weights, bf(g)


NARROW_WIDTHS = ((64, 8), (64, 4), (32, 4))
# regime: (slots, windows with a query, windows with a nonzero cotangent)
NARROW_REGIMES = {'(a) full bucket': (256, 192, 109),
                  '(b) mini grid': (76, 76, 76),
                  '(c) 18a grid': (875, 875, 875)}


def narrow_case(torch, N, with_query, live, C, seed=0):
    """A T = 64 self call of NARROW_BWD: N window slots, the first
    ``with_query`` of them with occupied cells (the first cell and 5-60% of
    the others), the rest padding, and a cotangent that is nonzero on
    ``live`` of the windows with a query. Returns (args, weights, g) as
    :func:`random_case` does."""
    args, weights, g = random_case(torch, N, 64, C, 1.0, seed)
    rng = np.random.RandomState(seed + 1)
    occ = rng.rand(N, 64) < rng.uniform(0.05, 0.6, (N, 1))
    occ[:, 0] = True
    occ[with_query:] = False
    hot = np.zeros(N, bool)
    hot[rng.permutation(with_query)[:live]] = True
    dev = g.device
    occ_t = torch.tensor(occ, device=dev)
    xw = torch.tensor(np.where(occ[..., None], rng.normal(0, 1, (N, 64, C)),
                               0).astype(np.float32),
                      device=dev).to(torch.bfloat16)
    g = g * torch.tensor(hot, device=dev)[:, None, None].to(g.dtype)
    qm = occ_t.float()
    return (xw, None, None, None, qm, None, args[-1]), weights, g


def parent_narrow(path):
    """NARROW_BWD of another ``encoder_layer_narrow.cu``, built with this
    one's flags."""
    from ..ops import encoder_layer as el

    lib = build.build_file(path, 'encoder_layer_narrow.cu', 'parent')
    k = el.NARROW_BWD
    return build.CudaKernel(k.source, k.symbol, k.argtypes, path=lib)


@contextlib.contextmanager
def narrow_using(kernel):
    """``encoder_layer_bwd`` launches ``kernel`` as NARROW_BWD inside the
    block (None: the repo's own)."""
    from ..ops import encoder_layer as el

    saved = el.NARROW_BWD
    if kernel is not None:
        el.NARROW_BWD = kernel
    try:
        yield
    finally:
        el.NARROW_BWD = saved


NARROW_PHASES = ('weights', 'tile and rows meta', 'rows in', 'q, k, v',
                 'attention', 'o, LN1', 'FFN', 'LN2 fwd+bwd', 'FFN bwd',
                 'LN1 bwd, do', 'datt', 'attention bwd', 'dx, dkv, dpos',
                 'fill, sums', '-', '-')


def narrow_cycles(torch, log=print):
    """NARROW_BWD's window pass built with -DTMAE_NARROW_PROFILE, regime (a)
    at each width, one call after a warm one: {width: {phase: share}} of
    thread 0's cycles summed over the blocks, and the cycles a tile."""
    from ..ops import encoder_layer as el

    lib = build.build_file(build.CSRC / 'encoder_layer_narrow.cu',
                           'encoder_layer_narrow.cu', 'profile',
                           extra=('-DTMAE_NARROW_PROFILE',))
    read = ctypes.CDLL(str(lib)).tmae_narrow_profile
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    read.restype = ctypes.c_int
    k = el.NARROW_BWD
    kernel = build.CudaKernel(k.source, k.symbol, k.argtypes, path=lib)
    cyc = (ctypes.c_ulonglong * 16)()
    N, nq, live = NARROW_REGIMES['(a) full bucket']
    out = {}
    for C, H in NARROW_WIDTHS:
        a, weights, g = narrow_case(torch, N, nq, live, C)
        p = el.kernel_params(weights)
        with narrow_using(kernel):
            for _ in range(2):
                if read(cyc):
                    raise RuntimeError('tmae_narrow_profile failed')
                el.encoder_layer_bwd(*a, p, g, nhead=H, tau_min=0.05,
                                     cross=False, want_dpos=True)
                torch.cuda.synchronize()
        if read(cyc):
            raise RuntimeError('tmae_narrow_profile failed')
        total = sum(cyc)
        per_tile = total / live
        out[f'C={C} H={H}'] = {'cycles_a_tile': per_tile, **{
            NARROW_PHASES[i]: cyc[i] / total for i in range(16) if cyc[i]}}
        log(f'C={C} H={H} (a): window pass {per_tile:.0f} cycles a tile '
            '(thread 0 of each block, summed over blocks): ' + ', '.join(
                f'{NARROW_PHASES[i]} {100 * cyc[i] / total:.1f}%'
                for i in range(16) if cyc[i]))
    return out


def narrow_outputs(out):
    dx, _, grads, dpos = out
    return [dx, dpos, *grads]


def narrow_main(args):
    import torch

    from ..ops import encoder_layer as el
    from .fwd_phases import by_launch, host_ms
    from .nms_phases import events_ms

    if not torch.cuda.is_available():
        print('bwd_phases: no CUDA device', file=sys.stderr)
        return 1
    parent = {}
    if args.parent:  # the two builds side by side
        t = threading.Thread(target=lambda: parent.setdefault(
            'k', parent_narrow(args.parent)))
        t.start()
    build.build_all(('encoder_layer_narrow.cu',))
    if args.parent:
        t.join()
        if 'k' not in parent:
            raise RuntimeError('the parent\'s build failed')
    versions = ['parent', 'change', 'change', 'parent'] if parent else \
        ['change']
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    res = {'card': card}
    for (C, H) in NARROW_WIDTHS:
        for regime, (N, nq, live) in NARROW_REGIMES.items():
            a, weights, g = narrow_case(torch, N, nq, live, C)
            p = el.kernel_params(weights)
            call = lambda: el.encoder_layer_bwd(*a, p, g, nhead=H,
                                                tau_min=0.05, cross=False,
                                                want_dpos=True)
            runs = {v: [] for v in versions}
            outs = {}
            for v in versions:
                with narrow_using(parent.get('k') if v == 'parent' else None):
                    first = narrow_outputs(call())
                    again = narrow_outputs(call())
                    torch.cuda.synchronize()
                    if not all(torch.equal(x, y)
                               for x, y in zip(first, again)):
                        raise AssertionError(f'{v} C={C} H={H} {regime}: '
                                             'two calls differ')
                    outs.setdefault(v, first)
                    launches = by_launch(torch, call, calls=5)
                    runs[v].append({
                        'by_launch': dict(launches),
                        'device_ms': sum(ms for _, ms in launches),
                        'host_ms': host_ms(torch, call),
                        'ms': events_ms(torch, call)})
            key = f'C={C} H={H} {regime}'
            res[key] = {'slots': N, 'live': live}
            for v in dict.fromkeys(versions):
                rs = runs[v]
                names = sorted({n for r in rs for n in r['by_launch']})
                rd = {k: statistics.fmean(r[k] for r in rs)
                      for k in ('device_ms', 'host_ms', 'ms')}
                rd['by_launch'] = {n: statistics.fmean(
                    r['by_launch'].get(n, 0.0) for r in rs) for n in names}
                rd['runs_ms'] = [r['ms'] for r in rs]
                res[key][v] = rd
                print(f'{key} {v}: events {rd["ms"]:.4f} ms a call, device '
                      f'{rd["device_ms"]:.4f} (' + ', '.join(
                          f'{n} {ms:.4f}' for n, ms in
                          rd['by_launch'].items())
                      + f'), host enqueue {rd["host_ms"]:.4f}', flush=True)
            if parent:
                diff = max((x.float() - y.float()).abs().max().item()
                           for x, y in zip(outs['parent'], outs['change']))
                res[key]['max_diff_vs_parent'] = diff
                print(f'{key}: largest |diff| of the outputs, parent against '
                      f'this version: {diff:.4g}', flush=True)
    if args.cycles:
        res['cycles'] = narrow_cycles(torch, log=lambda x: print(x,
                                                                 flush=True))
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(res, f)
    print(json.dumps(res), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--live', type=float, default=0.56,
                    help='fraction of the windows with a nonzero cotangent')
    ap.add_argument('--narrow', action='store_true',
                    help='NARROW_BWD by launch in three regimes')
    ap.add_argument('--parent', help='(--narrow) another '
                    'encoder_layer_narrow.cu to build and run beside this one')
    ap.add_argument('--cycles', action='store_true',
                    help='(--narrow) the window pass\'s cycles by phase (a '
                    'profile build)')
    ap.add_argument('--json', help='(--narrow) write the readings here too')
    args = ap.parse_args(argv)
    if args.narrow:
        return narrow_main(args)

    import torch

    from ..ops import encoder_layer as el

    if not torch.cuda.is_available():
        raise SystemExit('bwd_phases: no CUDA device')
    build.build_all(('encoder_layer_bwd.cu',))
    lib = profiled_library()
    prof = lib.tmae_bwd_profile
    prof.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    prof.restype = ctypes.c_int
    cycles = (ctypes.c_ulonglong * 16)()
    for name, kern, N, T in (('K9', el.K9, 2560, 16), ('K7', el.K7, 512, 64)):
        args_, weights, g = random_case(torch, N, T, 128, args.live)
        p = el.kernel_params(weights)
        call = lambda: el.encoder_layer_bwd(*args_, p, g, nhead=8,
                                            tau_min=0.05, cross=False,
                                            want_dpos=T == 64)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(10):
            call()
        t1.record()
        torch.cuda.synchronize()
        ms = t0.elapsed_time(t1) / 10
        normal = kern._fn
        fn = getattr(lib, normal.__name__)
        fn.argtypes, fn.restype = normal.argtypes, normal.restype
        kern._fn = fn
        try:
            call()
            torch.cuda.synchronize()
            prof(cycles)  # drop the warm-up call's cycles
            call()
            torch.cuda.synchronize()
            prof(cycles)
        finally:
            kern._fn = normal
        total = sum(cycles)
        print(f'{name} C=128 self T={T}, {N} slots, live {args.live}: '
              f'{ms:.4f} ms a call; window pass by phase: '
              + ', '.join(f'{PHASES[k]} {100 * c / total:.1f}%'
                          for k, c in enumerate(cycles) if c), flush=True)


if __name__ == '__main__':
    sys.exit(main())
