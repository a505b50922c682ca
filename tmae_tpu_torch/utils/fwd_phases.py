"""Where the persistent tiled kernel (K3 / K4 / K6 / K8 / K10 / K12 / K16,
``csrc/encoder_layer_tiled.cu``) spends its time, phase by phase and
launch by launch, on the card; and K5 (``csrc/segment_max.cu``) launch
by launch.

    python3 -m tmae_tpu_torch.utils.fwd_phases

Builds the library a second time with ``-DTMAE_FWD_PROFILE`` (consumer
thread 0 of each block then adds the clock cycles of every phase of its
tiles, and its tile count, into a device array), and runs on seeded
random inputs: K8 (S = 16, C = 128 self, 2560 slots as the t_mae.yaml
training batch's stage-1 bucket hands them, 56% of them live); K10 (C =
128 self on a 4 x 468 x 468 grid and C = 256 self on 4 x 234 x 234,
about 10% and 17% of the windows live, as the t_mae_ssl_waymo.yaml
pretraining batch's); K6 (T = 64, C = 128 self, 512 slots, 46% live, as
the training batch's stage-1 full bucket); K4 in place (S = 16 on rows
[0, 640) of a [2, 960, 64, C] window tensor at C = 128, 48% live, as a
served pair's stage-1 small bucket, and on rows [0, 256) of [2, 512, 64,
C] at C = 256, 40% live); K3 in place (T = 64 on rows [0, 128) of [2,
960, 64, C] at C = 128, 43% live, as a served pair's stage-1 full
bucket: 109 real windows in 2 x 128 slots); K12 straight in the padded
carrier of a 2 x 468 x 468 grid at C = 128 (T=64: a full plan of 128
slots a sample, 55 of them real windows, the rest dummy slots; S=16: a
small plan of 640 slots a sample, 314 real); K16 (C = 128 self, shift 0,
the 7200 flat windows of a served pair's stage-1 partition, 880 of them
with a key; C = 256 self, the 1922 windows of its stage-2 partition, 398
with a key; its launcher packs its four weights). For each call it prints its
time (CUDA events, the normal build; and the host time to enqueue it:
the wrapper's Python and its launches, the median of 7 rounds of 20
calls; for the serving calls K3, K4 and K12 with the weights prepared
once, as a served forward prepares them, and with ``LayerParams``,
prepared in the call), each launch's device time (torch.profiler: the
pack where the call packs, the pre-pass, the compaction, the tiled
kernel), each phase's cycles per tile and share, and beside each product
phase the cycles its tensor work would take at the card's dense bf16
peak (4096 FLOP a cycle an SM); then the device time of a served layer's
pack of its panels from f32 weights, at C = 128 and 256; and K5's time,
host enqueue time and device time by launch on a served frame's sizes
(131072 rows, 32768 slots, C = 128; 6852 pillars of skewed sizes, median
3 rows, up to 551). Needs a CUDA device."""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import time

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
    selections of S cells (S = 64: every cell in cell order)."""
    rng = np.random.RandomState(seed)
    bf = lambda a: torch.tensor(np.asarray(a, np.float32),
                                device='cuda').to(torch.bfloat16)
    occ = rng.rand(N, 64) < rng.uniform(0.05, 0.6, (N, 1))
    occ[rng.rand(N) >= live] = False
    xw = bf(np.where(occ[..., None], rng.normal(0, 1, (N, 64, C)), 0))
    s = np.argsort(-(occ * (64 - np.arange(64))), -1, kind='stable')
    if S == 64:
        s = np.broadcast_to(np.arange(64), (N, 64))
    s = np.ascontiguousarray(s[:, :S], np.int32)
    qm = np.take_along_axis(occ, s, -1).astype(np.float32)
    pos = bf(rng.normal(0, 0.5, (64, C)))
    return ((xw, None, torch.tensor(s, device='cuda'), None,
             torch.tensor(qm, device='cuda'), None, pos),
            _weights(torch, rng, C))


def rows_case(torch, B, total, cap, S, C, live, seed=0):
    """A gathered window tensor [B, total, 64, C] and a bucket of ``cap``
    windows a sample on rows [0, cap), as :func:`sel_case` makes them."""
    (xw, _, s, _, qm, _, pos), w = sel_case(torch, B * total, S, C, live,
                                            seed)
    xw = xw.reshape(B, total, 64, C)
    rows = lambda a: a.reshape(B, total, -1)[:, :cap].contiguous()
    return (xw, None, rows(s), None, rows(qm), None, pos), w


def plan_case(torch, B, H, W, cap, n_real, T, C, seed=0):
    """The padded carrier [B, Hp + 8, Wp, C] of a H x W grid and a bucket
    plan of ``cap`` slots a sample: ``n_real`` distinct windows in raster
    order, each with occupied cells, then dummy slots (nwy, 0); at T = 16
    occupied-first selections. Returns ((carrier, plan, pos), weights)."""
    import types

    from ..ops.dense_windows import window_geometry

    rng = np.random.RandomState(seed)
    nwy, nwx, Hp, Wp = window_geometry((H, W), 8)
    xp = torch.tensor(rng.normal(0, 1, (B, Hp + 8, Wp, C)).astype(
        np.float32), device='cuda').to(torch.bfloat16)
    idx = np.zeros((B, cap, 2), np.int32)
    idx[..., 0] = nwy
    occ = rng.rand(B, cap, 64) < rng.uniform(0.3, 0.9, (B, cap, 1))
    occ[:, :, 0] = True
    occ[:, n_real:] = False
    for b in range(B):
        w = np.sort(rng.choice(nwy * nwx, n_real, replace=False))
        idx[b, :n_real, 0], idx[b, :n_real, 1] = w // nwx, w % nwx
    s = np.argsort(-(occ * (64 - np.arange(64))), -1, kind='stable')
    s = np.ascontiguousarray(s[..., :T], np.int32)
    qm = (np.take_along_axis(occ, s, -1) if T != 64 else occ).astype(
        np.float32)
    dev = lambda a: torch.tensor(a, device='cuda')
    ci = types.SimpleNamespace(idx=dev(idx), sel=dev(s), ksel=None,
                               qmask=dev(qm), kmask=None)
    pos = torch.tensor(rng.normal(0, 0.5, (64, C)).astype(np.float32),
                       device='cuda').to(torch.bfloat16)
    return (xp, ci, pos), _weights(torch, rng, C)


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


def attn_case(torch, N, C, n_key, seed=0):
    """K16's flat windows [N, 64, C] of a grid's partition: ``n_key`` of
    them (spread over the N) with 10-90% of their cells occupied, keys
    where occupied, zeros elsewhere; weights [C_in, C_out] as
    DenseWindowAttention passes them, transposes of Linear weights."""
    rng = np.random.RandomState(seed)
    occ = np.zeros((N, 64), bool)
    keyed = rng.choice(N, n_key, replace=False)
    occ[keyed] = rng.rand(n_key, 64) < rng.uniform(0.1, 0.9, (n_key, 1))
    occ[keyed, 0] = True
    dev = lambda a: torch.tensor(np.asarray(a, np.float32), device='cuda')
    xw = dev(np.where(occ[..., None], rng.normal(0, 1, (N, 64, C)), 0)).to(
        torch.bfloat16)
    pos = dev(rng.normal(0, 0.5, (64, C))).to(torch.bfloat16)
    lin = lambda: dev(rng.normal(0, 1, (C, C)) / np.sqrt(C)).t()
    vec = lambda: dev(0.1 * rng.normal(size=(C,)))
    return (xw, xw, dev(occ), pos, lin(), vec(), lin(), vec(), lin(), vec(),
            lin(), vec(), dev([0.3]))


def segmax_case(torch, Pn=131072, V=32768, C=128, n_pillars=6852, seed=0):
    """K5's inputs at a served frame's sizes: ``n_pillars`` pillars of
    log-normal sizes (median 3 rows, clipped at 551) sorted by slot, the
    out-of-range slot V on the rows after them."""
    rng = np.random.RandomState(seed)
    sizes = np.clip(np.round(3 * np.exp(1.73 * rng.normal(size=n_pillars))),
                    1, 551).astype(np.int64)
    sizes = sizes[np.cumsum(sizes) <= Pn]
    n = len(sizes)
    seg = np.full((1, Pn), V, np.int32)
    seg[0, :sizes.sum()] = np.repeat(np.arange(n), sizes)
    ends = np.zeros((1, V), np.int32)
    ends[0, :n] = np.cumsum(sizes) - 1
    mask = np.zeros((1, V), bool)
    mask[0, :n] = True
    dev = lambda a: torch.tensor(a, device='cuda')
    feat = dev(rng.normal(size=(1, Pn, C)).astype(np.float32))
    return (feat, dev(seg), dev(ends), dev(mask), V), sizes


def host_ms(torch, call, rounds=7, n=20):
    """The host ms to enqueue one call: the median over ``rounds`` of ``n``
    calls back to back (each round after a synchronisation), which the
    host's other work spreads less than one round."""
    per = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        per.append((time.perf_counter() - t0) * 1e3 / n)
    torch.cuda.synchronize()
    return statistics.median(per)


def by_launch(torch, call, calls=1):
    """Device ms of each launch of one call (torch.profiler over ``calls``
    calls after a warm one), by kernel name: the mean of the kernel's
    events times its launches a call (events / calls, rounded), so that an
    event the profiler drops does not count as zero time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    short = lambda k: k.replace('void ', '').replace(
        '(anonymous namespace)::', '').split('<')[0].split('(')[0]
    return [(short(e.key), e.self_device_time_total / 1e3 / e.count
             * max(1, round(e.count / calls)))
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def main(argv=None):
    import torch

    from ..ops import encoder_layer as el
    from ..ops import window_attention as wa

    if not torch.cuda.is_available():
        raise SystemExit('fwd_phases: no CUDA device')
    build.build_all(('encoder_layer_tiled.cu',))
    lib = profiled_library()
    prof = lib.tmae_fwd_profile
    prof.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    prof.restype = ctypes.c_int
    cycles = (ctypes.c_ulonglong * 16)()
    kw = dict(nhead=8, tau_min=0.05, cross=False)
    cases = (('K8 S=16 C=128 self, 2560 slots', el.K8, 'sel', 128,
              sel_case(torch, 2560, 16, 128, 0.56)),
             ('K10 C=128 self, 4x468x468', el.K10, 'grid', 128,
              grid_case(torch, 4, 468, 468, 128, 0.1)),
             ('K10 C=256 self, 4x234x234', el.K10, 'grid', 256,
              grid_case(torch, 4, 234, 234, 256, 0.17)),
             ('K6 T=64 C=128 self, 512 slots', el.K6, 'flat', 128,
              sel_case(torch, 512, 64, 128, 0.46)),
             ('K4 S=16 C=128 self, rows [0, 640) of 2x960', el.K4, 'rows',
              128, rows_case(torch, 2, 960, 640, 16, 128, 0.48)),
             ('K4 S=16 C=256 self, rows [0, 256) of 2x512', el.K4, 'rows',
              256, rows_case(torch, 2, 512, 256, 16, 256, 0.4)),
             ('K3 T=64 C=128 self, rows [0, 128) of 2x960', el.K3,
              'rows_full', 128, rows_case(torch, 2, 960, 128, 64, 128, 0.43)),
             ('K12 T=64 C=128 self, 128 slots (55 real) of 2x468x468',
              el.K12, 'plan', 128,
              plan_case(torch, 2, 468, 468, 128, 55, 64, 128)),
             ('K12 S=16 C=128 self, 640 slots (314 real) of 2x468x468',
              el.K12, 'plan', 128,
              plan_case(torch, 2, 468, 468, 640, 314, 16, 128)),
             ('K16 C=128 self shift 0, 7200 windows (880 with a key)',
              wa.K16, 'attn', 128, (attn_case(torch, 7200, 128, 880), None)),
             ('K16 C=256 self, 1922 windows (398 with a key)', wa.K16,
              'attn', 256, (attn_case(torch, 1922, 256, 398), None)))
    for name, kern, mode, C, (args, weights) in cases:
        call_unprep = None
        if weights is not None:
            p = el.kernel_params(weights)
            tw = el.TiledWeights(weights, 8)
        if mode == 'attn':
            live = int((args[2] > 0).any(-1).sum())
            call = lambda: wa.window_attention_fwd(*args, 8, 0.05, False)
        elif mode == 'grid':
            live = int(el._flat_windows(args[2].float(), 8, False).any(-1)
                       .sum())
            call = lambda: el.encoder_layer_grid(
                *args, p, window=8, shift=False, **kw)
        elif mode == 'rows':
            live = int((args[4] > 0).any(-1).sum())
            call = lambda w=tw: el.encoder_layer_rows_sel(
                *args, w, row_lo=0, **kw)
            call_unprep = lambda: call(p)
        elif mode == 'rows_full':
            live = int((args[4] > 0).any(-1).sum())
            call = lambda w=tw: el.encoder_layer_rows_full(
                args[0], None, args[4], None, args[6], w, row_lo=0, **kw)
            call_unprep = lambda: call(p)
        elif mode == 'plan':
            xp, ci, pos = args
            live = int((ci.qmask > 0).any(-1).sum())
            T = ci.qmask.shape[-1]
            call = lambda w=tw: el.encoder_layer_fused_pipelined(
                xp, None, ci, pos, w, window=8, sel=T != 64, **kw)
            call_unprep = lambda: call(p)
        else:
            live = int((args[4] > 0).any(-1).sum())
            if mode == 'flat':  # all 64 cells: no selection
                args = (args[0], None, None, None, args[4], None, args[6])
            call = lambda: el.encoder_layer_fwd(*args, p, **kw)
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
        host_note = (f'{host_ms(torch, call):.4f} ms of host time to enqueue '
                     'it')
        if call_unprep is not None:
            host_note += (' with the weights prepared once, '
                          f'{host_ms(torch, call_unprep):.4f} ms with '
                          'LayerParams')
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
                 'v': 2 * 64 * C * C, 'o, LN1': 2 * 64 * C * C}
        if mode != 'attn':  # K16 stops after the output projection
            flops.update({'FFN 1': 4 * 64 * C * C,
                          'FFN 2, LN2': 4 * 64 * C * C})
        launches = by_launch(torch, call)
        print(f'{name}: {live} live windows, {cycles[10]} tiles; {ms:.4f} '
              f'ms a call ({host_note}); by '
              'launch ' + ', '.join(
                  f'{k} {v:.4f} ms' for k, v in launches)
              + f'; {total:.0f} cycles a tile (thread 0 of a block): '
              + ', '.join(
                  f'{ph} {c:.0f} ({100 * c / total:.1f}%'
                  + (f'; tensor work {flops[ph] / FLOP_PER_CYCLE:.0f})'
                     if ph in flops else ')')
                  for ph, c in zip(PHASES, per)), flush=True)
    for C in (128, 256):
        weights = _weights(torch, np.random.RandomState(C), C)
        launches = by_launch(torch, lambda: el.TiledWeights(weights, 8))
        print(f'a served layer\'s weights prepared at C={C} (f32 to bf16 '
              'panels): by launch ' + ', '.join(
                  f'{k} {v:.4f} ms' for k, v in launches), flush=True)
    segmax_phases(torch)


def segmax_phases(torch):
    """K5 on :func:`segmax_case`: time (CUDA events), host enqueue time and
    device time by launch, checked once against its plain version."""
    from ..ops import sorted_segments as ss

    build.build_all(('segment_max.cu',))
    args, sizes = segmax_case(torch)
    call = lambda: ss.sorted_segment_max(*args)
    if not torch.equal(call(), ss.sorted_segment_max_plain(*args)):
        raise SystemExit('fwd_phases: K5 differs from its plain version')
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(20):
        call()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / 20
    launches = by_launch(torch, call, calls=5)
    print(f'K5 C=128, {len(sizes)} pillars of {int(sizes.sum())} rows '
          f'(median {int(np.median(sizes))}, max {int(sizes.max())}): '
          f'{ms:.4f} ms a call ({host_ms(torch, call):.4f} ms of host time '
          'to enqueue it); by launch ' + ', '.join(
              f'{k} {v:.4f} ms' for k, v in launches), flush=True)


if __name__ == '__main__':
    main()
