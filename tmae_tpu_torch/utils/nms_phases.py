"""Device time of the NMS kernels and IOU_ALIGNED by launch, in a process
of their own.

``NMS_MASK`` and ``NMS_SCAN`` (``csrc/iou_nms.cu``) on a few candidate sets:
the served pair's candidates when a file of them is given (``--candidates``,
as ``chip_smoke.py`` phase 16 writes it), 500 crowded boxes with one class
and with five, K = 1, 77 and 2100 with B = 2, with one class and with five
and per-class caps. For each
set and kernel: the device ms of one call by launch (``torch.profiler``,
CUDA activity only), the host ms to enqueue it and the ms of one call by
CUDA events over 20 back to back.

``IOU_ALIGNED`` (:func:`measure_aligned`) on the crowded set of 500 boxes
against the same boxes moved, and on degenerate pairs
(:func:`degenerate_pairs`): the same readings, and its largest |diff|
against the plain version.

``IOU_PAIRS`` (:func:`measure_pairs`) on :func:`pair_cases`: the served
candidates (or the crowded set) 500 x 500 in BEV, the crowded set in BEV
and 3D, the degenerate pairs, the pairs planted at the cull's margin
(:func:`margin_pairs`) and a made-up scene at GraphRCNN's RoI sampler's
[2, 512, 64] with its masks (:func:`roi_gt_boxes`; far fewer of its pairs
need a clip than of a training step's own, which ``chip_smoke.py`` 24c
times with :func:`time_pairs`): the IoUs bit for bit against the plain
version, the readings, the kernel's own device ms, the pairs clipped.

``--parent PATH`` builds another version of ``iou_nms.cu`` (a parent
checkout's) beside this one with the same flags, runs both on every set in
the order parent, this, this, parent, and fails unless both give the same
mask words and keep masks and IoUs bit for bit; IOU_ALIGNED's largest
|diff| against the parent's is logged. A parent whose IOU_PAIRS takes one
sample a launch (no masks) runs once a sample, the masks applied after it,
as the sampler used it. ``--cycles`` also builds the source
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


def degenerate_pairs(torch):
    """Aligned box pairs [n, 7] x [n, 7] (CPU) where the clip meets its
    edge cases: equal boxes at five headings, one box inside the other,
    touching and edge-sharing boxes, micrometre boxes whose nearly
    parallel edges give crossings with a denominator under the 1e-12
    guard, and a zero-height and a disjoint z overlap."""
    a, b = [], []
    for ang in (0.0, 0.3, -1.2, math.pi / 2, math.pi):
        box = [3.0, -2.0, 0.5, 4.0, 2.0, 1.5, ang]
        a.append(box)
        b.append(box)
    for ang in (0.0, 0.7):
        a += [[1.0, 1.0, 0.0, 4.0, 3.0, 2.0, ang],
              [1.0, 1.0, 0.0, 1.0, 1.0, 1.0, ang]]
        b += [[1.0, 1.0, 0.0, 2.0, 1.0, 1.0, ang + 0.2],
              [1.0, 1.0, 0.0, 5.0, 4.0, 2.0, -ang]]
    unit = [0.0, 0.0, 0.0, 2.0, 2.0, 1.0, 0.0]
    for other in ([2.0, 0.0, 0.0, 2.0, 2.0, 1.0, 0.0],
                  [1.0, 0.0, 0.0, 2.0, 2.0, 1.0, 0.0],
                  [1.0, 1.0, 0.0, 2.0, 2.0, 1.0, 0.0],
                  [0.0, 2.0, 0.0, 2.0, 2.0, 1.0, math.pi]):
        a.append(unit)
        b.append(other)
    for k, ang in enumerate((1e-7, -1e-7, 3e-8, 2e-7, -4e-8, 1e-6)):
        for off in (0.0, 1e-13, -1e-13):
            a.append([0.5e-6 + 1e-7 * k, off, 0.0, 2e-6, 2e-6, 1.0, ang])
            b.append([0.0, 0.0, 0.0, 2e-6, 2e-6, 1.0, 0.0])
    a += [[0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.1]] * 2
    b += [[0.5, 0.0, 2.0, 2.0, 2.0, 2.0, 0.1], [0.5, 0.0, 3.0, 2.0, 2.0, 1.0,
                                                0.1]]
    return torch.tensor(a), torch.tensor(b)


def aligned_cases(torch):
    """IOU_ALIGNED's sets on the card: {name: (a [n, 7], b [n, 7])}: the
    crowded K = 500 set against itself moved as phase 16a moves it, and
    the degenerate pairs."""
    boxes = crowded_boxes(torch)[0][0]
    shift = torch.tensor([0.4, -0.3, 0.2, 0.3, -0.2, 0.1, 0.5],
                         device='cuda')
    a, b = degenerate_pairs(torch)
    return {'crowded 500 pairs': (boxes, boxes + shift),
            'degenerate pairs': (a.cuda(), b.cuda())}


def margin_pairs(torch):
    """Pairs planted at IOU_PAIRS' cull margin (:func:`geometry.
    iou_pairs_cull`), CPU: a [n, 1, 7] against b [n, 3, 7], sample by
    sample. Box B sits on A's +x side, at the last x of its centre that
    the cull keeps (a clip), then one and two floats further (culled).
    Sizes from 0.2 x 0.1 to 30 x 30 m, A's centre from 0.5 to 900 m out,
    the headings that turn a corner of each box towards the other (the
    closest the rectangles come for their circles' distance), 0 and one
    drawn at random; and, in z, B over A in BEV, its bottom face at A's top
    (an overlap of 0: clipped) and one and two floats above it (culled in
    3D)."""
    import numpy as np

    from ..ops import geometry as geo

    rng = np.random.RandomState(24)
    rows, cols = [], []
    for xa in (0.5, 30.0, 120.0, 900.0):
        for (dxa, dya), (dxb, dyb) in (((0.2, 0.1), (0.3, 0.2)),
                                       ((4.0, 2.0), (4.5, 1.9)),
                                       ((12.0, 3.0), (0.8, 0.8)),
                                       ((30.0, 30.0), (5.0, 2.0))):
            for turn in ('corner', 'zero', 'random'):
                if turn == 'corner':
                    ha = -math.atan2(dya, dxa)
                    hb = math.pi - math.atan2(dyb, dxb)
                elif turn == 'zero':
                    ha = hb = 0.0
                else:
                    ha, hb = rng.uniform(-math.pi, math.pi, 2)
                a = np.array([xa, -3.0, 0.2, dxa, dya, 1.5, ha], np.float32)
                b = np.array([xa, -3.0, 0.2, dxb, dyb, 1.5, hb], np.float32)
                lo = np.float32(xa)
                hi = np.float32(xa + 2 * (dxa + dya + dxb + dyb) + 1)

                def culled(x):
                    bb = b.copy()
                    bb[0] = x
                    return bool(geo.iou_pairs_cull(
                        torch.from_numpy(a)[None, None],
                        torch.from_numpy(bb)[None, None], 'bev')[0, 0, 0])

                while np.nextafter(lo, hi) != hi:  # culled(hi), not lo
                    mid = np.float32(lo + (hi - lo) / 2)
                    if mid in (lo, hi):
                        mid = np.nextafter(lo, hi)
                    if culled(mid):
                        hi = mid
                    else:
                        lo = mid
                xs = (lo, hi, np.nextafter(hi, np.float32(np.inf)))
                rows.append(a)
                cols.append([np.r_[np.float32(x), b[1:]] for x in xs])
    for top in (1.0, 7.5):
        a = np.array([5.0, 5.0, top - 1.0, 3.0, 2.0, 2.0, 0.4], np.float32)
        zs = [np.float32(top + 0.5)]
        for _ in range(2):
            zs.append(np.nextafter(zs[-1], np.float32(np.inf)))
        rows.append(a)
        cols.append([np.array([5.0, 5.0, z, 3.0, 2.0, 1.0, 0.4], np.float32)
                     for z in zs])
    return (torch.from_numpy(np.stack(rows))[:, None],
            torch.from_numpy(np.array(cols, np.float32)))


def roi_gt_boxes(torch, B=2, R=512, G=64, seed=24):
    """A made-up scene at the shape of GraphRCNN's RoI sampler, on the
    card (2% of its pairs need a clip; of a step's own, ~15%): RoIs [B, R,
    7] (the proposal layer's NMS_POST_MAXSIZE 512, the last 40 invalid) against
    ground truth [B, G, 7] (RUNTIME.MAX_GT 64, 30 and 45 valid) over a
    150 m ONCE scene: half the RoIs jittered copies of a valid box, the
    rest anywhere. Returns (rois, gts, roi_mask, gt_mask)."""
    g = torch.Generator().manual_seed(seed)
    rois, gts, rms, gms = [], [], [], []
    for b in range(B):
        n_gt = (30, 45)[b % 2]
        gt = torch.cat([
            (torch.rand(G, 2, generator=g) - 0.5) * 140,
            torch.rand(G, 1, generator=g) * 2 - 2,
            torch.rand(G, 1, generator=g) * 8 + 0.6,
            torch.rand(G, 1, generator=g) * 2 + 0.6,
            torch.rand(G, 1, generator=g) * 2 + 1.2,
            (torch.rand(G, 1, generator=g) * 2 - 1) * math.pi], 1)
        src = torch.randint(0, n_gt, (R,), generator=g)
        jitter = torch.randn(R, 7, generator=g) * torch.tensor(
            [0.6, 0.6, 0.3, 0.4, 0.2, 0.2, 0.3])
        near = gt[src] + jitter
        near[:, 3:6] = near[:, 3:6].abs() + 0.1
        far = torch.cat([
            (torch.rand(R, 2, generator=g) - 0.5) * 140,
            torch.rand(R, 1, generator=g) * 2 - 2,
            torch.rand(R, 3, generator=g) * 4 + 0.5,
            (torch.rand(R, 1, generator=g) * 2 - 1) * math.pi], 1)
        pick = torch.rand(R, 1, generator=g) < 0.5
        rois.append(torch.where(pick, near, far))
        gts.append(gt)
        rms.append(torch.arange(R) < R - 40)
        gms.append(torch.arange(G) < n_gt)
    return [torch.stack(t).cuda() for t in (rois, gts, rms, gms)]


def pair_cases(torch, served=None):
    """IOU_PAIRS' sets on the card: {name: (a [B, N, 7], b [B, M, 7], mode,
    row mask, column mask)}."""
    crowded = crowded_boxes(torch)[0][:, :, :7].contiguous()
    first = (served['boxes'][:, :, :7].cuda().contiguous()
             if served is not None else crowded)
    da, db = degenerate_pairs(torch)
    ma, mb = margin_pairs(torch)
    rois, gts, rm, gm = roi_gt_boxes(torch)
    return {
        f'{"served" if served is not None else "crowded"} 500x500 bev':
            (first, first, 'bev', None, None),
        'crowded 500x500 3d': (crowded, crowded, '3d', None, None),
        'degenerate 3d': (da[None].cuda(), db[None].cuda(), '3d', None,
                          None),
        'margin bev': (ma.cuda(), mb.cuda(), 'bev', None, None),
        'margin 3d': (ma.cuda(), mb.cuda(), '3d', None, None),
        'synthetic roi x gt [2, 512, 64] 3d': (rois, gts, '3d', rm, gm)}


KERNELS = ('IOU_PAIRS', 'IOU_ALIGNED', 'NMS_MASK', 'NMS_SCAN')


# IOU_PAIRS before its batched launch: (a, b, N, M, mode, out, stream)
IOU_PAIRS_PER_SAMPLE_ARGS = [build.P, build.P, build.I, build.I, build.I,
                             build.P, build.P]


def batched_pairs(path) -> bool:
    """Whether the ``iou_nms.cu`` at ``path`` launches IOU_PAIRS batched
    and masked (this version's signature)."""
    from pathlib import Path

    src = Path(path).read_text()
    at = src.index('launch_iou_pairs(')
    return 'mask' in src[at:src.index(')', at)]


def parent_kernels(path):
    """The geometry kernels of another ``iou_nms.cu``, built beside this
    one's library with the same flags. A parent whose IOU_PAIRS takes one
    sample a launch has it under ``IOU_PAIRS_PER_SAMPLE`` instead (never
    swapped in by :func:`using`)."""
    from ..ops import geometry as geo

    lib = build.build_file(path, 'iou_nms.cu', 'parent')
    out = {name: build.CudaKernel(k.source, k.symbol, k.argtypes, path=lib)
           for name, k in ((n, getattr(geo, n)) for n in KERNELS)}
    if not batched_pairs(path):
        k = out.pop('IOU_PAIRS')
        out['IOU_PAIRS_PER_SAMPLE'] = build.CudaKernel(
            k.source, k.symbol, IOU_PAIRS_PER_SAMPLE_ARGS, path=lib)
    return out


def pairs_call(kernels):
    """``iou(a, b, mode, row_mask, col_mask) -> [B, N, M]`` through
    ``kernels`` ({name: kernel}, none: this version's): the batched
    ``boxes_iou_pairs``, or a per-sample parent's IOU_PAIRS launched once a
    sample with the masks applied after it."""
    import torch

    from ..ops import geometry as geo

    per_sample = (kernels or {}).get('IOU_PAIRS_PER_SAMPLE')
    if per_sample is None:
        def call(a, b, mode, rm=None, cm=None):
            with using(kernels):
                return geo.boxes_iou_pairs(a, b, mode, rm, cm)
        return call

    def call(a, b, mode, rm=None, cm=None):
        B, N, M = a.shape[0], a.shape[1], b.shape[1]
        a7 = a[..., :7].float().contiguous()
        b7 = b[..., :7].float().contiguous()
        out = torch.empty(B, N, M, dtype=torch.float32, device=a.device)
        for s in range(B):
            per_sample(a7[s].data_ptr(), b7[s].data_ptr(), N, M,
                       geo.IOU_MODES[mode], out[s].data_ptr(),
                       geo.stream_handle())
        if rm is None and cm is None:
            return out
        return torch.where(geo._pair_mask(rm, cm, B, N, M, a.device), out,
                           0.0)
    return call


@contextlib.contextmanager
def using(kernels):
    """The geometry wrappers launch ``kernels`` ({name: kernel} of KERNELS)
    inside the block (none: the repo's own)."""
    from ..ops import geometry as geo

    saved = {n: getattr(geo, n) for n in KERNELS}
    for n, k in (kernels or {}).items():
        setattr(geo, n, k)
    try:
        yield
    finally:
        for n, k in saved.items():
            setattr(geo, n, k)


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


def measure_aligned(torch, parent=None, log=print):
    """IOU_ALIGNED on aligned_cases (and the parent's, in the order parent,
    this, this, parent): its largest |diff| against the plain version and
    against the parent's, whether each is bit-equal, and the readings.
    {set: {...}}."""
    from ..ops import geometry as geo

    versions = ['parent', 'change', 'change', 'parent'] if parent else \
        ['change']
    kernels = {'change': None, 'parent': parent}
    out = {}
    for name, (a, b) in aligned_cases(torch).items():
        runs = {v: [] for v in versions}
        got = {}
        for v in versions:
            with using(kernels[v]):
                got.setdefault(v, geo.boxes_iou3d_aligned(a, b))
                runs[v].append({'IOU_ALIGNED': readings(
                    torch, lambda: geo.boxes_iou3d_aligned(a, b))})
        plain = geo.boxes_iou3d_aligned_plain(a, b)
        rec = {'pairs': a.shape[0],
               'max_abs_plain': float((got['change'] - plain).abs().max()),
               'bits_plain': bool(torch.equal(got['change'], plain))}
        if parent:
            rec['max_abs_parent'] = float(
                (got['change'] - got['parent']).abs().max())
            rec['bits_parent'] = bool(torch.equal(got['change'],
                                                  got['parent']))
        for v in dict.fromkeys(versions):
            rec[v] = mean_readings(runs[v])['IOU_ALIGNED']
            rd = rec[v]
            log(f'  {name} {v} IOU_ALIGNED: device {rd["device_ms"]} ms a '
                f'call (' + ', '.join(f'{k} {x:.5f}' for k, x in
                                       rd['by_launch'].items())
                + f'), host enqueue {rd["host_ms"]:.4f} ms, events '
                f'{rd["ms"]:.4f} ms')
        log(f'  {name}: IOU_ALIGNED max |kernel - plain| '
            f'{rec["max_abs_plain"]:.3g} (bit-equal {rec["bits_plain"]})'
            + (f', max |this - parent| {rec["max_abs_parent"]:.3g} '
               f'(bit-equal {rec["bits_parent"]})' if parent else ''))
        out[name] = rec
    return out


def kernel_device_ms(by_launch, name='iou_pairs_kernel'):
    """The device ms of the launches of kernel ``name`` in a by-launch
    reading (a parent's per-sample call also launches the masks' where)."""
    ms = [v for k, v in by_launch.items() if name in k]
    return sum(ms) if ms else None


def time_pairs(torch, a, b, mode, rm=None, cm=None, parent=None,
               log=print, name=''):
    """IOU_PAIRS on one set, and ``parent``'s in the order parent, this,
    this, parent: the IoUs bit for bit against the plain version and the
    parent's (raises otherwise), each version's mean readings with the
    kernel's own device ms (``kernel_device_ms``), and the pairs that need
    a clip (in the masks, not culled)."""
    from ..ops import geometry as geo

    versions = ['parent', 'change', 'change', 'parent'] if parent else \
        ['change']
    calls = {'change': pairs_call(None),
             'parent': pairs_call(parent) if parent else None}
    runs = {v: [] for v in versions}
    got = {}
    for v in versions:
        call = lambda: calls[v](a, b, mode, rm, cm)  # noqa: E731
        got.setdefault(v, call())
        runs[v].append({'IOU_PAIRS': readings(torch, call)})
    plain = geo.boxes_iou_pairs_plain(a, b, mode, rm, cm)
    B, N, M = plain.shape
    live = geo._pair_mask(rm, cm, B, N, M, a.device)
    clips = int((live & ~geo.iou_pairs_cull(a, b, mode)).sum())
    rec = {'shape': [B, N, M], 'mode': mode, 'clips': clips,
           'pairs': int(live.sum()),
           'bits_plain': bool(torch.equal(got['change'], plain)),
           'max_abs_plain': float((got['change'] - plain).abs().max())}
    if not rec['bits_plain']:
        raise AssertionError(f'{name}: IOU_PAIRS differs from its plain '
                             f'version (max {rec["max_abs_plain"]:.3g})')
    if parent and not torch.equal(got['change'], got['parent']):
        raise AssertionError(f"{name}: IOU_PAIRS differs from the parent's")
    for v in dict.fromkeys(versions):
        rd = rec[v] = mean_readings(runs[v])['IOU_PAIRS']
        rd['kernel_device_ms'] = kernel_device_ms(rd['by_launch'])
        log(f'  {name} {v} IOU_PAIRS: kernel device '
            f'{rd["kernel_device_ms"]} ms (' + ', '.join(
                f'{k} {x:.5f}' for k, x in rd['by_launch'].items())
            + f'), host enqueue {rd["host_ms"]:.4f} ms, events '
            f'{rd["ms"]:.4f} ms')
    log(f'  {name}: IOU_PAIRS {B}x{N}x{M} {mode}, {clips} of '
        f'{rec["pairs"]} pairs clipped; bit-equal to the plain version'
        + (" and the parent's" if parent else ''))
    return rec


def measure_pairs(torch, served=None, parent=None, log=print):
    """:func:`time_pairs` on every set of :func:`pair_cases`. {set:
    {...}}."""
    return {name: time_pairs(torch, *case, parent=parent, log=log,
                             name=name)
            for name, case in pair_cases(torch, served).items()}


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
    out['IOU_ALIGNED'] = measure_aligned(torch, parent)
    out['IOU_PAIRS'] = measure_pairs(torch, served, parent)
    if args.cycles:
        out['scan_cycles'] = scan_cycles(torch, served)
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(out, f)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
