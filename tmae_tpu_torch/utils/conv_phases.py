"""Where the windowed SubM conv K15 (``csrc/subm_conv.cu``) and the unpadded
scatter-into K13c (``csrc/windows.cu``) spend their time on the card.

    python3 -m tmae_tpu_torch.utils.conv_phases             # times
    python3 -m tmae_tpu_torch.utils.conv_phases --selftest  # checks only

The default run builds ``subm_conv.cu`` a second time with
``-DTMAE_CONV_PROFILE`` (consumer thread 0 of each block then adds the
clock cycles of each phase of its tiles, and its tile count, into a device
array) and times, on seeded random inputs sized as the t_mae.yaml served
pair's conv_out inputs: K15 at stage 1 (C = 128 on 2 x 468 x 468, 440
occupied windows a sample) and stage 2 (C = 256 on 2 x 234 x 234, 200 a
sample), and K13c on the stage-1 grid with the unshifted plan of every
occupied window. For each call it prints its time (CUDA events over
back-to-back calls), the host time to enqueue it (the wrapper's Python and
its launches, the median of 7 rounds of 20 calls), each launch's device
time (torch.profiler, the mean over 5 calls) and the time of the library
call that computes the same function in the same run (cuDNN's dense
``conv2d``, ``torch.index_put``);
for K15 also the cycles a tile by phase, the dynamic shared memory of the
main kernel and the ptxas registers and spills of the normal build.

``--selftest`` holds K15 at C = 128 and 256 on a small grid whose plan has
windows on all four edges and dummy slots against its plain version, one
tap at a time (the weights zero but for that tap: each tap's shifted halo
descriptor on its own) and with all nine, and K13c, shifted and not, bit
for bit against its plain version; it exits non-zero on a mismatch. Needs
a CUDA device."""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys

import numpy as np

from . import build
from .fwd_phases import by_launch, host_ms

PHASES = ('tile handoff', 'halo', 'products', 'epilogue')
FLOP_PER_CYCLE = 4096  # dense bf16 tensor-core peak of one SM


def profiled_library() -> ctypes.CDLL:
    """subm_conv.cu built with -DTMAE_CONV_PROFILE (into _build)."""
    src = build.CSRC / 'subm_conv.cu'
    out = build._target('subm_conv.cu').with_suffix('.profile.so')
    if not out.exists():
        flags = [f for f in build.NVCC_FLAGS if f not in ('-Xptxas', '-v')]
        subprocess.run([build._nvcc(), *flags, '-DTMAE_CONV_PROFILE', '-o',
                        str(out), str(src)], check=True)
    return ctypes.CDLL(str(out))


def conv_case(torch, B, H, W, C, per_sample, seed=0, edges=False):
    """A [B, H, W, C] bf16 grid, zero at unoccupied cells, whose occupancy
    fills ``per_sample`` random windows of the unshifted partition at 5-60%
    (with ``edges``, also every window on the grid's four edges), the plan
    of every occupied window (cap rounded up to 16, so it holds dummy
    slots), bf16 weights [3, 3, C, C] and an f32 bias. Returns (xg, plan,
    wmat, bias, occ)."""
    from ..ops import occ_compact as oc
    from ..ops.dense_windows import window_geometry

    rng = np.random.RandomState(seed)
    nwy, nwx, _, _ = window_geometry((H, W), 8)
    occ = np.zeros((B, H + 16, W + 16), bool)  # 8 cells of slack each side
    for b in range(B):
        wins = rng.choice((nwy - 1) * (nwx - 1), per_sample, replace=False)
        picked = [(w // (nwx - 1) + 1, w % (nwx - 1) + 1) for w in wins]
        if edges:
            picked += [(wy, wx) for wy in range(1, nwy) for wx in range(1, nwx)
                       if wy in (1, nwy - 1) or wx in (1, nwx - 1)]
        for wy, wx in picked:
            cells = rng.rand(8, 8) < rng.uniform(0.05, 0.6)
            cells[rng.randint(8), rng.randint(8)] = True
            occ[b, 8 * wy:8 * wy + 8, 8 * wx:8 * wx + 8] |= cells
    occ = torch.tensor(occ[:, 8:8 + H, 8:8 + W], device='cuda')
    x = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    xg = torch.tensor(x, device='cuda').to(torch.bfloat16) * occ[..., None]
    n = int((oc.window_cell_counts(occ, 8, False) > 0).sum((1, 2)).max())
    plan = oc.build_compact_info(occ, 8, False, oc.round_cap(n + 1), (H, W))
    wmat = torch.tensor(rng.normal(0, 1, (3, 3, C, C)).astype(np.float32)
                        / np.sqrt(9 * C), device='cuda').to(torch.bfloat16)
    bias = torch.tensor(0.1 * rng.normal(size=C).astype(np.float32),
                        device='cuda')
    return xg, plan, wmat, bias, occ


def _rel(torch, got, want):
    d = (got.float() - want.float()).abs()
    scale = max(1.0, want.float().abs().max().item())
    return d.max().item() / scale, d.mean().item() / scale


def selftest(torch) -> bool:
    """K15 per tap and whole, K13c bit for bit, on small grids; True when
    every check passed."""
    from ..ops import occ_compact as oc
    from ..ops import sparse_conv as sc

    ok = True
    for C in sc.WIDTHS:
        xg, plan, wmat, bias, _ = conv_case(torch, 2, 40, 52, C, 6, seed=C,
                                            edges=True)
        args = (xg, plan.idx, plan.qmask)
        dummy = ~plan.valid
        for tap in list(range(9)) + ['all']:
            w = wmat
            if tap != 'all':
                w = torch.zeros_like(wmat)
                w[tap // 3, tap % 3] = wmat[tap // 3, tap % 3]
            got = sc.subm_conv_windows(*args, w, bias, 8)
            want = sc.subm_conv_windows_plain(*args, w, bias, 8)
            torch.cuda.synchronize()
            mx, mean = _rel(torch, got, want)
            zeros = not got[dummy].any()
            good = mx <= 1e-2 and mean <= 1e-3 and zeros
            ok &= good
            print(f'K15 selftest C={C} tap {tap}: max {mx:.3g} mean '
                  f'{mean:.3g} of the scale, dummy slots zero {zeros}: '
                  f'{"ok" if good else "FAILED"}', flush=True)
    xg, _, _, _, occ = conv_case(torch, 2, 40, 52, 32, 6, seed=1, edges=True)
    hw = (40, 52)
    for shift in (False, True):
        plan = oc.build_compact_info(occ, 8, shift, 48, hw)
        xw = torch.randn(2, 48, 64, 32, device='cuda').to(torch.bfloat16)
        init = torch.randn(2, 40, 52, 32, device='cuda').to(torch.bfloat16)
        got = oc.scatter_windows_into(xw, plan.idx, init, hw, 8, shift)
        want = oc.scatter_windows_into_plain(xw, plan.idx, init, hw, 8, shift)
        good = torch.equal(got.view(torch.int16), want.view(torch.int16))
        ok &= good
        print(f'K13c selftest shift {shift}: bit-equal {good}', flush=True)
    return ok


def ptxas_lines(log: str) -> list[str]:
    """The registers / spill lines of a ptxas -v log, one per kernel."""
    keep = []
    for ln in log.splitlines():
        if re.search(r'Compiling entry function|registers|spill', ln):
            keep.append(ln.strip())
    return keep


def main(argv=None):
    import torch

    from ..ops import occ_compact as oc
    from ..ops import sparse_conv as sc

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--selftest', action='store_true')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('conv_phases: no CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    built = build.build_all(('subm_conv.cu', 'windows.cu'))
    for name, info in built.items():
        print(f'built {name} in {info["seconds"]:.1f} s', flush=True)
        for ln in ptxas_lines(info['log']):
            print(f'  {ln}', flush=True)
    lib = build.library('subm_conv.cu')
    lib.subm_conv_smem.argtypes = [ctypes.c_int]
    lib.subm_conv_smem.restype = ctypes.c_int
    print('K15 main kernel dynamic shared memory: ' + ', '.join(
        f'C={C} {lib.subm_conv_smem(C)} bytes' for C in sc.WIDTHS),
        flush=True)
    if args.selftest:
        return 0 if selftest(torch) else 1

    plib = profiled_library()
    prof = plib.tmae_conv_profile
    prof.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    prof.restype = ctypes.c_int
    cycles = (ctypes.c_ulonglong * 8)()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def ms(call, n=20):
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        t0.record()
        for _ in range(n):
            call()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / n

    for name, shape, per in (('K15 stage 1', (2, 468, 468, 128), 440),
                             ('K15 stage 2', (2, 234, 234, 256), 200)):
        xg, plan, wmat, bias, _ = conv_case(torch, *shape, per)
        C = shape[3]
        live = int(((plan.qmask > 0).any(-1) & plan.valid).sum())
        call = lambda: sc.subm_conv_windows(xg, plan.idx, plan.qmask, wmat,
                                            bias, 8)
        xn = xg.permute(0, 3, 1, 2)
        wo = wmat.permute(3, 2, 0, 1).contiguous()
        lib_ms = ms(lambda: torch.nn.functional.conv2d(xn, wo, padding=1))
        k_ms = ms(call)
        host = host_ms(torch, call)
        launches = by_launch(torch, call, calls=5)
        normal = sc.K15._fn
        fn = getattr(plib, normal.__name__)
        fn.argtypes, fn.restype = normal.argtypes, normal.restype
        sc.K15._fn = fn
        try:
            call()
            torch.cuda.synchronize()
            prof(cycles)  # drop the warm-up call's cycles
            call()
            torch.cuda.synchronize()
            prof(cycles)
        finally:
            sc.K15._fn = normal
        tiles = max(cycles[4], 1)
        per_tile = [cycles[k] / tiles for k in range(len(PHASES))]
        total = sum(per_tile)
        work = 2 * 2 * 64 * 9 * C * C / FLOP_PER_CYCLE
        print(f'{name} (C={C}, {tuple(xg.shape)}, cap {plan.idx.shape[1]}, '
              f'{live} live windows, {cycles[4]} tiles on thread 0 of the '
              f'blocks): {k_ms:.4f} ms a call, {host:.4f} ms of host time '
              f'to enqueue it; cuDNN dense conv2d {lib_ms:.4f} ms; by '
              'launch ' + ', '.join(f'{k} {v:.4f} ms' for k, v in launches)
              + f'; {total:.0f} cycles a tile: ' + ', '.join(
                  f'{ph} {c:.0f} ({100 * c / total:.1f}%)'
                  for ph, c in zip(PHASES, per_tile))
              + f'; tensor work of a tile (2 windows) {work:.0f} cycles',
              flush=True)

    xg, _, _, _, occ = conv_case(torch, 2, 468, 468, 128, 440)
    hw = (468, 468)
    n = int((oc.window_cell_counts(occ, 8, False) > 0).sum((1, 2)).max())
    plan = oc.build_compact_info(occ, 8, False, oc.round_cap(n), hw)
    xw = oc.gather_windows(xg, plan.idx, hw, 8, False)
    init = torch.randn(xg.shape, device='cuda').to(torch.bfloat16)
    call = lambda: oc.scatter_windows_into(xw, plan.idx, init, hw, 8, False)
    B, cap = plan.idx.shape[:2]
    iy = torch.arange(8, device='cuda')
    r = (plan.idx[..., 0].long()[..., None, None] * 8 - 8
         + iy[:, None]).expand(B, cap, 8, 8)
    c = (plan.idx[..., 1].long()[..., None, None] * 8 - 8
         + iy[None, :]).expand(B, cap, 8, 8)
    keep = plan.valid[..., None, None] & (r >= 0) & (r < 468) & (c >= 0) \
        & (c < 468)
    bi = torch.arange(B, device='cuda')[:, None, None, None].expand_as(r)
    ind = (bi[keep], r[keep], c[keep])
    sv = xw.reshape(B, cap, 8, 8, 128)[keep]
    lib_ms = ms(lambda: torch.index_put(init, ind, sv))
    k_ms = ms(call)
    host = host_ms(torch, call)
    launches = by_launch(torch, call, calls=5)
    print(f'K13c stage 1 unshifted (C=128, {tuple(xg.shape)}, cap {cap}, '
          f'{int(plan.valid.sum())} real windows): {k_ms:.4f} ms a call, '
          f'{host:.4f} ms of host time to enqueue it; torch.index_put '
          f'{lib_ms:.4f} ms; by launch ' + ', '.join(
              f'{k} {v:.4f} ms' for k, v in launches), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
