"""Where the persistent tiled kernel (K3 / K4 / K6 / K8 / K10 / K12 / K16,
``csrc/encoder_layer_tiled.cu``) spends its time, phase by phase and
launch by launch, on the card; and K5 (``csrc/segment_max.cu``) launch
by launch.

    python3 -m tmae_tpu_torch.utils.fwd_phases
    python3 -m tmae_tpu_torch.utils.fwd_phases --narrow [--parent PATH]
        [--cycles] [--json FILE]

``--narrow`` runs NARROW_FWD (``csrc/encoder_layer_narrow.cu``) instead,
at (C, heads) = (64, 8), (64, 4) and (32, 4) on seeded random windows:
(a) a served pair's stage-1 full bucket in place, rows [0, 128) of [2,
128, 64, C], 109 of the 256 slots with an occupied query cell (fewer
tiles than SMs); (b) 76 flat windows out of place, every one with a
query (as a t_mae_mini.yaml step's stage-1 grid hands them); and at (64,
8) also an S = 16 bucket in place (rows [0, 640) of [2, 960, 64, C], 48%
live) and a 2 x 32 x 32 grid at shift 0 (a t_mae_mini.yaml step's
stage-1 grid). For each it prints the device ms of each launch
(``torch.profiler``), the host ms to enqueue a call (prepared weights
where the call takes them) and the CUDA-event ms of a call (an in-place
call runs again on its own output: the same windows, the same work), for
a served call also the host ms to prepare its weights (``TiledWeights``
from f32 masters), and checks that a call on the case's inputs gives the
same bits twice. ``--parent PATH`` builds another
``encoder_layer_narrow.cu`` (a parent checkout's) beside this one, runs
both in the order parent, this, this, parent, each with its own host
path (a parent whose kernel takes f32 matrices gets a served layer's f32
masters, as its wrapper handed them), and prints the largest difference
of their outputs. ``--cycles`` builds the source again with
``-DTMAE_NARROW_PROFILE`` and prints, for each case, the tile kernel's
cycles a tile and their shares by phase (thread 0 of each block, summed
over the blocks). The readings go to the last line as JSON (and to
``--json``).

Without ``--narrow``, it builds the library a second time with ``-DTMAE_FWD_PROFILE`` (consumer
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

import argparse
import contextlib
import ctypes
import json
import statistics
import subprocess
import sys
import threading
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


def by_launch(torch, call, calls=1, stats=None):
    """Device ms of each launch of one call (torch.profiler over ``calls``
    calls after a warm one), by kernel name: the mean of the kernel's
    events times its launches a call (events / calls, rounded), so that an
    event the profiler drops does not count as zero time. A session that
    records no device activity at all (after a session of ~10^5 device
    records, later ones in the process lose records: PERF.md section 7) is
    run again, up to 3 sessions; ``stats['empty']`` counts those."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    short = lambda k: k.replace('void ', '').replace(
        '(anonymous namespace)::', '').split('<')[0].split('(')[0]
    call()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        out = [(short(e.key), e.self_device_time_total / 1e3 / e.count
                * max(1, round(e.count / calls)))
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
        if out:
            return out
        if stats is not None:
            stats['empty'] = stats.get('empty', 0) + 1
    return []


NARROW_WIDTHS = ((64, 8), (64, 4), (32, 4))
NARROW_PHASES = ('weights wait', 'tile and rows meta', 'rows in', 'q, k, v',
                 'attention', 'o, LN1', 'FFN 1', 'FFN 2, LN2', 'output',
                 'prefetch', '-', '-', '-', '-', '-', '-')


def narrow_cases(torch, C):
    """NARROW_FWD's cases at width C: {label: (kind, args, weights)}, kind
    'rows_full', 'flat', 'rows' or 'grid' (see the module's doc)."""
    rng = np.random.RandomState(C)
    out = {}
    (xw, _, _, _, qm, _, pos), w = rows_case(torch, 2, 128, 128, 64, C, 1.0,
                                             seed=C)
    dead = torch.tensor(rng.permutation(256)[:256 - 109], device='cuda')
    qm = qm.reshape(256, 64)
    qm[:, 0] = 1.0  # a query in every window, then 147 windows without
    qm[dead] = 0
    xw.reshape(256, 64, C)[dead] = 0
    out['(a) full bucket in place, 109 of 256 slots live'] = (
        'rows_full', (xw, None, None, None, qm.reshape(2, 128, 64), None,
                      pos), w)
    (xw, _, _, _, qm, _, pos), w = sel_case(torch, 76, 64, C, 1.0, seed=C)
    qm[:, 0] = 1.0  # every window with a query
    out['(b) 76 windows out of place, all live'] = (
        'flat', (xw, None, None, None, qm, None, pos), w)
    if C == 64:
        out['S=16 in place, rows [0, 640) of 2x960, 48% live'] = (
            'rows', *rows_case(torch, 2, 960, 640, 16, C, 0.48, seed=C))
        out['grid 2x32x32 shift 0'] = ('grid',
                                       *grid_case(torch, 2, 32, 32, C, 1.0,
                                                  seed=C))
    return out


def narrow_call(el, kind, args, weights, nhead):
    """One NARROW_FWD call of ``kind`` as its path makes it (serving calls
    with the weights prepared once, training calls with kernel_params)."""
    kw = dict(nhead=nhead, tau_min=0.05, cross=False)
    if kind in ('rows_full', 'rows'):
        tw = el.TiledWeights(weights, nhead)
        if kind == 'rows_full':
            return lambda: el.encoder_layer_rows_full(
                args[0], None, args[4], None, args[6], tw, row_lo=0, **kw)
        return lambda: el.encoder_layer_rows_sel(*args, tw, row_lo=0, **kw)
    p = el.kernel_params(weights)
    if kind == 'grid':
        return lambda: el.encoder_layer_grid(*args, p, window=8,
                                             shift=False, **kw)
    return lambda: el.encoder_layer_fwd(*args, p, **kw)


def narrow_live(el, kind, args):
    if kind == 'grid':
        return int(el._flat_windows(args[2].float(), 8, False).any(-1).sum())
    return int((args[4] > 0).any(-1).sum())


class ParentFwd:
    """Another build's NARROW_FWD called with this version's arguments. A
    parent that takes ``w_f32`` (its kernel rounds f32 matrices to bf16
    as it loads them) also runs its own host path inside
    :meth:`host_path`: a served layer's ``TiledWeights`` keeps its f32
    matrices (no ``narrow_mats`` copy) and their launches pass w_f32 = 1;
    the bf16 matrices of training pass 0."""

    def __init__(self, path):
        from ..ops import encoder_layer as el

        lib = build.build_file(path, 'encoder_layer_narrow.cu', 'parent')
        k = el.NARROW_FWD
        self.f32 = 'int w_f32' in path.read_text().split(
            'launch_narrow_fwd(')[1].split(')')[0]
        types = list(k.argtypes)
        if self.f32:
            types.insert(3, build.I)
        self.kernel = build.CudaKernel(k.source, k.symbol, types, path=lib)
        # wq's address -> the f32 matrices kept (held, so that no other
        # tensor takes the address)
        self.kept = {}

    def __call__(self, mode, io, ptrs, *rest):
        if self.f32:
            self.kernel(mode, io, ptrs, int(ptrs[0] in self.kept), *rest)
        else:
            self.kernel(mode, io, ptrs, *rest)

    @contextlib.contextmanager
    def host_path(self):
        from ..ops import encoder_layer as el

        def keep(mats):
            self.kept[mats[0].data_ptr()] = mats
            return mats

        saved = el.narrow_mats
        if self.f32:
            el.narrow_mats = keep
        try:
            yield
        finally:
            el.narrow_mats = saved


@contextlib.contextmanager
def narrow_fwd_using(kernel):
    """The wrappers launch ``kernel`` as NARROW_FWD inside the block (None:
    the repo's own; a :class:`ParentFwd` with its host path)."""
    from ..ops import encoder_layer as el

    saved = el.NARROW_FWD
    if kernel is not None:
        el.NARROW_FWD = kernel
    try:
        if isinstance(kernel, ParentFwd):
            with kernel.host_path():
                yield
        else:
            yield
    finally:
        el.NARROW_FWD = saved


def narrow_fresh(kind, args, call):
    """A function that runs ``call`` on the case's inputs as they were made
    (an in-place call first gets its window tensor back) and returns what
    it wrote."""
    if kind not in ('rows_full', 'rows'):
        return call
    orig = args[0].clone()

    def run():
        args[0].copy_(orig)
        call()
        return args[0]

    return run


def narrow_cycles(torch, el, cases, log=print):
    """The tile kernel built with -DTMAE_NARROW_PROFILE, each case one call
    after a warm one: {case: {'cycles_a_tile': n, phase: share}}."""
    lib = build.build_file(build.CSRC / 'encoder_layer_narrow.cu',
                           'encoder_layer_narrow.cu', 'profile',
                           extra=('-DTMAE_NARROW_PROFILE',))
    read = ctypes.CDLL(str(lib)).tmae_narrow_profile
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    read.restype = ctypes.c_int
    k = el.NARROW_FWD
    kernel = build.CudaKernel(k.source, k.symbol, k.argtypes, path=lib)
    cyc = (ctypes.c_ulonglong * 16)()
    out = {}
    for key, (kind, args, weights, H) in cases.items():
        call = narrow_call(el, kind, args, weights, H)
        with narrow_fwd_using(kernel):
            for _ in range(2):
                if read(cyc):
                    raise RuntimeError('tmae_narrow_profile failed')
                call()
                torch.cuda.synchronize()
        if read(cyc):
            raise RuntimeError('tmae_narrow_profile failed')
        total = max(sum(cyc), 1)
        live = narrow_live(el, kind, args)
        tiles = -(-live // 4) if kind == 'rows' else live
        out[key] = {'cycles_a_tile': total / tiles, **{
            NARROW_PHASES[i]: cyc[i] / total for i in range(16) if cyc[i]}}
        log(f'{key}: tile kernel {total / tiles:.0f} cycles a tile (thread '
            '0 of each block, summed over blocks): ' + ', '.join(
                f'{NARROW_PHASES[i]} {100 * cyc[i] / total:.1f}%'
                for i in range(16) if cyc[i]))
    return out


def narrow_main(args):
    import torch

    from ..ops import encoder_layer as el
    from .nms_phases import events_ms

    if not torch.cuda.is_available():
        print('fwd_phases: no CUDA device', file=sys.stderr)
        return 1
    parent = {}
    if args.parent:  # the two builds side by side
        from pathlib import Path

        t = threading.Thread(target=lambda: parent.setdefault(
            'k', ParentFwd(Path(args.parent))))
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
    cases = {}
    for C, H in NARROW_WIDTHS:
        for label, (kind, a, w) in narrow_cases(torch, C).items():
            if C == 64 and H == 4 and kind in ('rows', 'grid'):
                continue
            cases[f'C={C} H={H} {label}'] = (kind, a, w, H)
    using = lambda v: narrow_fwd_using(parent.get('k') if v == 'parent'
                                       else None)
    for key, (kind, a, w, H) in cases.items():
        calls, fresh = {}, {}
        for v in dict.fromkeys(versions):  # each with its own host path
            with using(v):
                calls[v] = narrow_call(el, kind, a, w, H)
            fresh[v] = narrow_fresh(kind, a, calls[v])
        served = kind in ('rows_full', 'rows')
        runs = {v: [] for v in versions}
        outs = {}
        for v in versions:
            with using(v):
                first = fresh[v]().clone()
                again = fresh[v]()
                torch.cuda.synchronize()
                if not torch.equal(first, again):
                    raise AssertionError(f'{v} {key}: two calls differ')
                outs.setdefault(v, first)
                launches = by_launch(torch, calls[v], calls=5)
                runs[v].append({
                    'by_launch': dict(launches),
                    'device_ms': sum(ms for _, ms in launches),
                    'host_ms': host_ms(torch, calls[v]),
                    'ms': events_ms(torch, calls[v]),
                    'prepare_ms': host_ms(
                        torch, lambda: el.TiledWeights(w, H), n=5)
                    if served else 0.0})
        res[key] = {'live': narrow_live(el, kind, a)}
        for v in dict.fromkeys(versions):
            rs = runs[v]
            names = sorted({n for r in rs for n in r['by_launch']})
            rd = {k: statistics.fmean(r[k] for r in rs)
                  for k in ('device_ms', 'host_ms', 'ms', 'prepare_ms')}
            rd['by_launch'] = {n: statistics.fmean(
                r['by_launch'].get(n, 0.0) for r in rs) for n in names}
            rd['runs_ms'] = [r['ms'] for r in rs]
            res[key][v] = rd
            print(f'{key} {v}: events {rd["ms"]:.4f} ms a call, device '
                  f'{rd["device_ms"]:.4f} (' + ', '.join(
                      f'{n} {ms:.4f}' for n, ms in rd['by_launch'].items())
                  + f'), host enqueue {rd["host_ms"]:.4f}' + (
                      f', weights prepared {rd["prepare_ms"]:.4f} (host)'
                      if served else ''), flush=True)
        if parent:
            diff = (outs['parent'].float() - outs['change'].float()).abs()
            res[key]['max_diff_vs_parent'] = diff.max().item()
            print(f'{key}: largest |diff| of the outputs, parent against '
                  f'this version: {diff.max().item():.4g}', flush=True)
    if args.cycles:
        res['cycles'] = narrow_cycles(torch, el, cases,
                                      log=lambda x: print(x, flush=True))
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(res, f)
    print(json.dumps(res), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--narrow', action='store_true',
                    help='NARROW_FWD by launch, host enqueue and events')
    ap.add_argument('--parent', help='(--narrow) another '
                    'encoder_layer_narrow.cu to build and run beside this one')
    ap.add_argument('--cycles', action='store_true',
                    help='(--narrow) the tile kernel\'s cycles by phase (a '
                    'profile build)')
    ap.add_argument('--json', help='(--narrow) write the readings here too')
    args = ap.parse_args(argv)
    if args.narrow:
        return narrow_main(args)
    return tiled_main()


def tiled_main():
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
    sys.exit(main())
