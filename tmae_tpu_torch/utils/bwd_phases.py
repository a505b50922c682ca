"""Where the fused training backward (K7 / K9, ``csrc/encoder_layer_bwd.cu``)
spends its time, phase by phase, on the card.

    python3 -m tmae_tpu_torch.utils.bwd_phases [--live 0.56]

Builds the library a second time with ``-DTMAE_BWD_PROFILE`` (each block
of the window pass then adds the clock cycles of every phase of its tiles
into a device array), runs K9 (S=16) and K7 on seeded random inputs at the
C=128 self shapes of the t_mae.yaml training batch (2560 and 512 bucket
slots, the last quarter of them padding, and a fraction ``--live`` of the
windows with a nonzero cotangent), and prints each call's time (CUDA
events, the normal build) and each phase's share of the window pass's
cycles (the profiling build). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--live', type=float, default=0.56,
                    help='fraction of the windows with a nonzero cotangent')
    args = ap.parse_args(argv)

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
    main()
