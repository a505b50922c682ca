"""Where the persistent forward kernel (K8 / K10,
``csrc/encoder_layer_tiled.cu``) spends its time, phase by phase, on the
card.

    python3 -m tmae_tpu_torch.utils.fwd_phases

Builds the library a second time with ``-DTMAE_FWD_PROFILE`` (consumer
thread 0 of each block then adds the clock cycles of every phase of its
tiles, and its tile count, into a device array), runs K8 (S = 16, C = 128
self, 2560 slots as the t_mae.yaml training batch's stage-1 bucket hands
them, 56% of them live) and K10 (C = 128 self on a 4 x 468 x 468 grid and
C = 256 self on 4 x 234 x 234, about 10% and 17% of the windows live, as
the t_mae_ssl_waymo.yaml pretraining batch's) on seeded random inputs, and
prints each call's time (CUDA events, the normal build), each phase's
cycles per tile and share, and beside each product phase the cycles its
tensor work would take at the card's dense bf16 peak (4096 FLOP a cycle
an SM). Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np

from . import build

PHASES = ('tile handoff', 'rows', 'q', 'k', 'v', 'attention', 'o, LN1',
          'FFN 1', 'FFN 2, LN2', 'output')
FLOP_PER_CYCLE = 4096  # dense bf16 tensor-core peak of one SM


def profiled_library() -> ctypes.CDLL:
    """encoder_layer_tiled.cu built with -DTMAE_FWD_PROFILE (into _build)."""
    src = build.CSRC / 'encoder_layer_tiled.cu'
    out = build._target('encoder_layer_tiled.cu').with_suffix('.profile.so')
    if not out.exists():
        flags = [f for f in build.NVCC_FLAGS if f not in ('-Xptxas', '-v')]
        subprocess.run([build._nvcc(), *flags, '-DTMAE_FWD_PROFILE', '-o',
                        str(out), str(src)], check=True)
    return ctypes.CDLL(str(out))


def _weights(torch, rng, C):
    F = 2 * C
    lin = lambda o, i: (rng.normal(0, 1, (o, i)) / np.sqrt(i)).astype(
        np.float32)
    vec = lambda n, m=0.0: (m + 0.1 * rng.normal(size=(n,))).astype(
        np.float32)
    w = [lin(C, C), vec(C), lin(C, C), vec(C), lin(C, C), vec(C), lin(C, C),
         vec(C), np.asarray([0.3], np.float32), vec(C, 1.0), vec(C),
         lin(F, C), vec(F), lin(C, F), vec(C), vec(C, 1.0), vec(C)]
    return [torch.tensor(a, device='cuda') for a in w]


def sel_case(torch, N, S, C, live, seed=0):
    """A bucket of N slots: windows with zeros at unoccupied cells, a
    fraction ``live`` of them with an occupied cell, occupied-first
    selections of S cells."""
    rng = np.random.RandomState(seed)
    bf = lambda a: torch.tensor(np.asarray(a, np.float32),
                                device='cuda').to(torch.bfloat16)
    occ = rng.rand(N, 64) < rng.uniform(0.05, 0.6, (N, 1))
    occ[rng.rand(N) >= live] = False
    xw = bf(np.where(occ[..., None], rng.normal(0, 1, (N, 64, C)), 0))
    s = np.argsort(-(occ * (64 - np.arange(64))), -1, kind='stable')
    s = s[:, :S].astype(np.int32)
    qm = np.take_along_axis(occ, s, -1).astype(np.float32)
    pos = bf(rng.normal(0, 0.5, (64, C)))
    return ((xw, None, torch.tensor(s, device='cuda'), None,
             torch.tensor(qm, device='cuda'), None, pos),
            _weights(torch, rng, C))


def grid_case(torch, B, H, W, C, live, seed=0):
    """A [B, H, W, C] grid whose occupied cells fill 8x8 blocks (offset by
    4 cells from the shift-0 windows, so a block touches four windows),
    a fraction ``live`` / 4 of the blocks occupied at 40%."""
    rng = np.random.RandomState(seed)
    bf = lambda a: torch.tensor(np.asarray(a, np.float32),
                                device='cuda').to(torch.bfloat16)
    blocks = rng.rand(B, H // 8 + 2, W // 8 + 2) < live / 4
    occ = np.repeat(np.repeat(blocks, 8, 1), 8, 2)[:, 4:4 + H, 4:4 + W]
    occ &= rng.rand(B, H, W) < 0.4
    x = bf(np.where(occ[..., None], rng.normal(0, 1, (B, H, W, C)), 0))
    pos = bf(rng.normal(0, 0.5, (64, C)))
    return ((x, None, torch.tensor(occ, device='cuda'), None, pos),
            _weights(torch, rng, C))


def main(argv=None):
    import torch

    from ..ops import encoder_layer as el

    if not torch.cuda.is_available():
        raise SystemExit('fwd_phases: no CUDA device')
    build.build_all(('encoder_layer_tiled.cu',))
    lib = profiled_library()
    prof = lib.tmae_fwd_profile
    prof.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    prof.restype = ctypes.c_int
    cycles = (ctypes.c_ulonglong * 16)()
    cases = (('K8 S=16 C=128 self, 2560 slots', el.K8, 16, 128,
              sel_case(torch, 2560, 16, 128, 0.56)),
             ('K10 C=128 self, 4x468x468', el.K10, 64, 128,
              grid_case(torch, 4, 468, 468, 128, 0.1)),
             ('K10 C=256 self, 4x234x234', el.K10, 64, 256,
              grid_case(torch, 4, 234, 234, 256, 0.17)))
    for name, kern, T, C, (args, weights) in cases:
        p = el.kernel_params(weights)
        if T == 64:
            live = int(el._flat_windows(args[2].float(), 8, False).any(-1)
                       .sum())
            call = lambda: el.encoder_layer_grid(
                *args, p, nhead=8, tau_min=0.05, cross=False, window=8,
                shift=False)
        else:
            live = int((args[4] > 0).any(-1).sum())
            call = lambda: el.encoder_layer_fwd(*args, p, nhead=8,
                                                tau_min=0.05, cross=False)
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
        tiles = max(cycles[10], 1)
        per = [cycles[k] / tiles for k in range(len(PHASES))]
        total = sum(per)
        flops = {'q': 2 * 64 * C * C, 'k': 2 * 64 * C * C,
                 'v': 2 * 64 * C * C, 'o, LN1': 2 * 64 * C * C,
                 'FFN 1': 4 * 64 * C * C, 'FFN 2, LN2': 4 * 64 * C * C}
        print(f'{name}: {live} live windows, {cycles[10]} tiles; {ms:.4f} '
              f'ms a call; {total:.0f} cycles a tile (thread 0 of a block): '
              + ', '.join(
                  f'{ph} {c:.0f} ({100 * c / total:.1f}%'
                  + (f'; tensor work {flops[ph] / FLOP_PER_CYCLE:.0f})'
                     if ph in flops else ')')
                  for ph, c in zip(PHASES, per)), flush=True)


if __name__ == '__main__':
    main()
