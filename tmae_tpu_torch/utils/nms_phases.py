"""Device time of the NMS kernels by launch, in a process of their own.

``NMS_MASK`` and ``NMS_SCAN`` (``csrc/iou_nms.cu``) on a few candidate sets:
the served pair's candidates when a file of them is given (``--candidates``,
as ``chip_smoke.py`` phase 16 writes it), 500 crowded boxes with one class
and with five, K = 1, 77 and 2100 with B = 2, with one class and with five
and per-class caps. For each
set and kernel: the device ms of one call by launch (``torch.profiler``,
CUDA activity only), the host ms to enqueue it and the ms of one call by
CUDA events over 20 back to back.

``--parent PATH`` builds another version of ``iou_nms.cu`` (a parent
checkout's) beside this one with the same flags, runs both on every set in
the order parent, this, this, parent, and fails unless both give the same
mask words and keep masks bit for bit. ``--cycles`` also builds the source
with ``-DTMAE_NMS_PROFILE`` and prints NMS_SCAN's cycles a 64-row block by
part on each set.

    python3 -m tmae_tpu_torch.utils.nms_phases [--candidates FILE]
        [--parent PATH] [--cycles] [--json FILE]

Prints one line a set and kernel, and the readings as JSON on the last
line (and into ``--json``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import sys

from . import build

MULTI_THRESH = [0.7, 0.6, 0.55, 0.55, 0.55]  # multi_class_nms (PR 15's 16a)
CAPS = [120, 40, 10, 3, 0]     # per-class caps, most of which bind


def crowded_boxes(torch, K=500, clusters=25, seed=0, B=1):
    """K boxes a sample in clusters of heavy overlap over a t_mae.yaml scene,
    all headings, labels 1..5, the last 20 invalid (score-sorted order is
    the index order); sample b from seed + b. On the card."""
    out = []
    for b in range(B):
        g = torch.Generator().manual_seed(seed + b)
        centres = (torch.rand(clusters, 2, generator=g) - 0.5) * 120
        c = torch.randint(0, clusters, (K,), generator=g)
        boxes = torch.cat([
            centres[c] + torch.randn(K, 2, generator=g) * 0.7,
            torch.rand(K, 1, generator=g) * 2 - 1,
            torch.rand(K, 1, generator=g) * 4 + 1,
            torch.rand(K, 1, generator=g) * 2 + 1,
            torch.rand(K, 1, generator=g) * 2 + 1,
            (torch.rand(K, 1, generator=g) * 2 - 1) * math.pi], 1)
        labels = torch.randint(1, 6, (K,), generator=g)
        valid = torch.arange(K) < K - min(20, K // 4)
        out.append((boxes, labels, valid))
    return [torch.stack(t).cuda() for t in zip(*out)]


def cases(torch, served=None):
    """{name: (boxes [B, K, 7], labels or None, valid, threshs, posts)}."""
    sets = {}
    if served is not None:
        sets['served K=500'] = (served['boxes'].cuda(), None,
                                served['valid'].cuda(), [served['thresh']],
                                [served['post']])
    boxes, labels, valid = crowded_boxes(torch)
    sets['crowded K=500'] = (boxes, None, valid, [0.5], [500])
    sets['crowded K=500 multi'] = (boxes, labels, valid, MULTI_THRESH,
                                   [500] * 5)
    for K, clusters in ((1, 1), (77, 4), (2100, 80)):
        boxes, labels, valid = crowded_boxes(torch, K, clusters, K, B=2)
        sets[f'K={K} B=2'] = (boxes, None, valid, [0.5], [500])
        sets[f'K={K} B=2 multi caps'] = (boxes, labels, valid, MULTI_THRESH,
                                         CAPS)
    return sets


def parent_kernels(path):
    """NMS_MASK and NMS_SCAN of another ``iou_nms.cu``, built beside this
    one's library with the same flags."""
    from ..ops import geometry as geo

    lib = build.build_file(path, 'iou_nms.cu', 'parent')
    return {name: build.CudaKernel(k.source, k.symbol, k.argtypes, path=lib)
            for name, k in (('NMS_MASK', geo.NMS_MASK),
                            ('NMS_SCAN', geo.NMS_SCAN))}


@contextlib.contextmanager
def using(kernels):
    """The geometry wrappers launch ``kernels`` ({'NMS_MASK': ...,
    'NMS_SCAN': ...}) inside the block (none: the repo's own)."""
    from ..ops import geometry as geo

    saved = geo.NMS_MASK, geo.NMS_SCAN
    if kernels:
        geo.NMS_MASK, geo.NMS_SCAN = kernels['NMS_MASK'], kernels['NMS_SCAN']
    try:
        yield
    finally:
        geo.NMS_MASK, geo.NMS_SCAN = saved


def events_ms(torch, call, iters=20, warmup=3):
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def readings(torch, call):
    """One call's device ms by launch and summed, host enqueue ms and
    events ms; ``empty_sessions``: the profiler sessions that saw no device
    activity and were run again."""
    from .fwd_phases import by_launch, host_ms

    stats = {}
    launches = by_launch(torch, call, calls=5, stats=stats)
    return {'device_ms': sum(ms for _, ms in launches) or None,
            'by_launch': dict(launches), 'host_ms': host_ms(torch, call),
            'ms': events_ms(torch, call),
            'empty_sessions': stats.get('empty', 0)}


def run_case(torch, boxes, labels, valid, threshs, posts):
    """The mask words and keep mask, and the readings of each kernel."""
    from ..ops import geometry as geo

    mask = geo.nms_mask_bits(boxes, valid, threshs, labels)
    keep = geo.nms_scan_bits(mask, valid, posts, labels)
    torch.cuda.synchronize()
    return mask, keep, {
        'NMS_MASK': readings(torch, lambda: geo.nms_mask_bits(
            boxes, valid, threshs, labels)),
        'NMS_SCAN': readings(torch, lambda: geo.nms_scan_bits(
            mask, valid, posts, labels))}


def mean_readings(runs):
    """The mean of each number over a version's runs (by launch: of each
    launch's ms)."""
    out = {}
    for kernel in runs[0]:
        rs = [r[kernel] for r in runs]
        mean = lambda key: (statistics.fmean(r[key] for r in rs)
                            if all(r[key] is not None for r in rs) else None)
        names = sorted({n for r in rs for n in r['by_launch']})
        out[kernel] = {
            'device_ms': mean('device_ms'), 'host_ms': mean('host_ms'),
            'ms': mean('ms'),
            'by_launch': {n: statistics.fmean(r['by_launch'].get(n, 0.0)
                                              for r in rs) for n in names},
            'runs_device_ms': [r['device_ms'] for r in rs],
            'empty_sessions': sum(r['empty_sessions'] for r in rs)}
    return out


def measure(torch, served=None, parent=None, log=print):
    """Every set through this version (and the parent's, in the order
    parent, this, this, parent): {set: {'K', 'B', 'kept', version:
    readings}}. Raises if the parent's bits differ."""
    versions = ['parent', 'change', 'change', 'parent'] if parent else \
        ['change']
    kernels = {'change': None, 'parent': parent}
    out = {}
    for name, (boxes, labels, valid, threshs, posts) in cases(
            torch, served).items():
        runs = {v: [] for v in versions}
        bits = {}
        for v in versions:
            with using(kernels[v]):
                mask, keep, r = run_case(torch, boxes, labels, valid,
                                         threshs, posts)
            runs[v].append(r)
            bits.setdefault(v, (mask, keep))
        if parent and not (torch.equal(bits['parent'][0], bits['change'][0])
                           and torch.equal(bits['parent'][1],
                                           bits['change'][1])):
            raise AssertionError(f'{name}: the parent\'s mask or keep '
                                 'differs from this version\'s')
        B, K = valid.shape
        out[name] = {'K': K, 'B': B, 'kept': int(bits['change'][1].sum()),
                     'valid': int(valid.sum())}
        for v in dict.fromkeys(versions):
            out[name][v] = mean_readings(runs[v])
            for kernel, rd in out[name][v].items():
                log(f'  {name} {v} {kernel}: device {rd["device_ms"]} ms '
                    f'a call (' + ', '.join(f'{k} {x:.5f}' for k, x in
                                           rd['by_launch'].items())
                    + f'), host enqueue {rd["host_ms"]:.4f} ms, events '
                    f'{rd["ms"]:.4f} ms')
        if parent:
            log(f'  {name}: parent and this version give the same mask '
                f'and keep bits ({out[name]["kept"]} of '
                f'{out[name]["valid"]} kept)')
    return out


SCAN_PARTS = ('classes', 'slab copy and wait', 'removed word, ballots, rooms',
              'walk and caps', 'keep bytes', 'ORs')


def scan_cycles(torch, served=None, log=print):
    """NMS_SCAN built with -DTMAE_NMS_PROFILE on every set, one call after a
    warm one: lane 0's cycles by part (SCAN_PARTS), summed over the
    samples and divided by their 64-row blocks. {set: {part: cycles}}."""
    import ctypes

    from ..ops import geometry as geo

    lib = build.build_file(build.CSRC / 'iou_nms.cu', 'iou_nms.cu', 'profile',
                           extra=('-DTMAE_NMS_PROFILE',))
    read = ctypes.CDLL(str(lib)).tmae_nms_profile
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    read.restype = ctypes.c_int
    kernels = {name: build.CudaKernel(k.source, k.symbol, k.argtypes,
                                      path=lib)
               for name, k in (('NMS_MASK', geo.NMS_MASK),
                               ('NMS_SCAN', geo.NMS_SCAN))}
    cyc = (ctypes.c_ulonglong * 8)()
    out = {}
    with using(kernels):
        for name, (boxes, labels, valid, threshs, posts) in cases(
                torch, served).items():
            mask = geo.nms_mask_bits(boxes, valid, threshs, labels)
            geo.nms_scan_bits(mask, valid, posts, labels)
            torch.cuda.synchronize()
            if read(cyc):
                raise RuntimeError('tmae_nms_profile failed')
            geo.nms_scan_bits(mask, valid, posts, labels)
            torch.cuda.synchronize()
            if read(cyc):
                raise RuntimeError('tmae_nms_profile failed')
            B, K = valid.shape
            blocks = B * -(-K // 64)
            out[name] = {p: cyc[i] / blocks for i, p in enumerate(SCAN_PARTS)}
            log(f'  {name} NMS_SCAN cycles a block: ' + ', '.join(
                f'{p} {c:.0f}' for p, c in out[name].items())
                + f'; total {sum(out[name].values()):.0f}')
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--candidates', help='a torch.save file of the served '
                    'candidates: boxes [1, K, 7], valid [1, K], thresh, post')
    ap.add_argument('--parent', help='another iou_nms.cu to build and run '
                    'beside this one')
    ap.add_argument('--cycles', action='store_true',
                    help="also NMS_SCAN's cycles by part (a profile build)")
    ap.add_argument('--json', help='write the readings here too')
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print('nms_phases: no CUDA device', file=sys.stderr)
        return 1
    build.build_all(('iou_nms.cu',))
    served = (torch.load(args.candidates, map_location='cpu')
              if args.candidates else None)
    parent = parent_kernels(args.parent) if args.parent else None
    out = measure(torch, served, parent)
    if args.cycles:
        out['scan_cycles'] = scan_cycles(torch, served)
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(out, f)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
