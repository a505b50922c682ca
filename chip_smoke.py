#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA H100 and check it.

    python3 chip_smoke.py            # what the chip check runs
    python3 chip_smoke.py --profile  # also writes a per-kernel time table

Phases (any failure exits non-zero and prints no result line):
  1. card: fail without CUDA; print ``nvidia-smi`` name and power limit.
  2. build: compile every CUDA source of ``tmae_tpu_torch/csrc`` (one nvcc
     per source, all at once).
  3. kernels: each kernel against its plain PyTorch version at the shapes of
     the t_mae.yaml main path (stage-1 plans of a synthetic frame pair,
     131072 points), with its time, the plain version's time, one PyTorch
     library call's time where one computes the same function, and the
     least time the card could take (bytes / 3.35 TB/s or FLOPs / 989
     TFLOP/s bf16, counting the windows and points this run's data needs).
  4. serving: the full-width t_mae.yaml detector with seeded random weights
     on a synthetic LiDAR frame pair (density 1.5, ~100k points per frame):
     launch counters set to 0, one pass (forward, decode, host NMS), the
     counts checked per frame pair; then warm timed passes.
  5. reference: the same detector run on the card (kernels) and on the CPU
     (plain versions) with the same weights and frames, head maps compared:
     at full size, and at full width on a 64x64 grid.
Prints the kernels line, the card line and, last, the result line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / 'chiprun_out' / 'chip_smoke'
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # dense bf16 tensor cores
F32_FLOPS = 67e12              # f32 outside the tensor cores
EXPECTED_LAUNCHES = {'K1': 24, 'K2': 18, 'K3': 18, 'K4': 36, 'K5': 2}
REPS = 20                      # timed serving passes


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean ms per call over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops, peak_flops=BF16_FLOPS):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / peak_flops * 1e3
    return (tb, 'bytes') if tb >= tf else (tf, 'operations')


def layer_flops(T, C, F):
    """FLOPs of one encoder layer on one window of T tokens."""
    return 2 * T * C * C * 4 + 2 * T * C * F * 2 + 2 * T * T * C * 2


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at main-path shapes
# ---------------------------------------------------------------------------


def check_kernels(torch, model, batch, dev):
    from tmae_tpu_torch.models.sst import build_plans
    from tmae_tpu_torch.ops import encoder_layer as el
    from tmae_tpu_torch.ops import occ_compact as oc
    from tmae_tpu_torch.ops import sorted_segments as ss
    from tmae_tpu_torch.ops.voxelize import occupancy_grid

    g = torch.Generator(device=dev).manual_seed(1)
    enc = model.backbone_3d.encoder
    H, W = 468, 468
    occ = torch.cat([occupancy_grid(batch[f'vcoords_{w}'], batch[f'vmask_{w}'],
                                    (H, W)) for w in ('cur', 'prv')])
    caps = enc.sst_block_0.caps
    plan = build_plans(occ, 8, caps)[0]
    C = 128
    x = torch.randn(2, H, W, C, generator=g, device=dev)
    x = torch.where(occ[..., None], x, 0.0).to(torch.bfloat16)
    xp = oc.pad_grid(x, 8, False).contiguous()
    idx = plan.cat_idx.contiguous()
    B, Ncat = idx.shape[:2]
    n_real = int(torch.cat([plan.small.valid, plan.mid.valid,
                            plan.full.valid], 1).sum())
    win = 64 * C * 2
    rows = []

    def entry(name, kernel, source, replaces, err, ms, plain_ms, nbytes,
              flops, library_ms, peak=BF16_FLOPS):
        b, by = bound_ms(nbytes, flops, peak)
        rows.append({'name': name, 'route': 'cuda', 'source': source,
                     'replaces': replaces, 'kernel': kernel,
                     'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                     'bound_ms': b, 'bound_by': by, 'library_ms': library_ms})
        log(f'  {name}: max_abs_err {err:.3g}  kernel {ms:.4f} ms  plain '
            f'{plain_ms:.4f} ms  bound {b:.4f} ms ({by})  library '
            f'{library_ms if library_ms is None else round(library_ms, 4)}')

    # K1: gather
    got = oc.gather_windows_padded(xp, idx, 8)
    want = oc.gather_windows_padded_plain(xp, idx, 8)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if err != 0:
        raise AssertionError(f'K1 differs from its plain version: {err}')
    # library: one advanced-indexing call on prebuilt cell indices
    iy = torch.arange(8, device=dev)
    cells = (B, Ncat, 8, 8)
    rows_i = (idx[..., 0].long()[..., None, None] * 8
              + iy[:, None]).expand(cells)
    cols_i = (idx[..., 1].long()[..., None, None] * 8
              + iy[None, :]).expand(cells)
    bidx = torch.arange(B, device=dev)[:, None, None, None].expand(cells)
    lib = lambda: xp[bidx, rows_i, cols_i]
    if not torch.equal(lib().reshape(B, Ncat, 64, C), want):
        raise AssertionError('K1 library yardstick computes another function')
    entry('window_gather', 'K1', 'tmae_tpu_torch/csrc/windows.cu',
          'tmae_tpu/ops/occ_compact.py:717',
          err, time_ms(torch, lambda: oc.gather_windows_padded(xp, idx, 8)),
          time_ms(torch, lambda: oc.gather_windows_padded_plain(xp, idx, 8)),
          n_real * win + B * Ncat * win + idx.numel() * 4, 0,
          time_ms(torch, lib))

    # K2: scatter in place
    xw = torch.randn(got.shape, generator=g, device=dev).to(torch.bfloat16)
    a = oc.scatter_windows_into_padded(xw, idx, xp.clone(), 8)
    b = oc.scatter_windows_into_padded_plain(xw, idx, xp.clone(), 8)
    torch.cuda.synchronize()
    err = (a.float() - b.float()).abs().max().item()
    if err != 0:
        raise AssertionError(f'K2 differs from its plain version: {err}')
    valid = torch.cat([plan.small.valid, plan.mid.valid, plan.full.valid], 1)
    keep = valid[..., None, None].expand_as(rows_i)
    sb = bidx[keep]
    sr, sc = rows_i[keep], cols_i[keep]
    sv = xw.reshape(B, Ncat, 8, 8, C)[keep]
    xp_lib = xp.clone()
    lib = lambda: xp_lib.index_put_((sb, sr, sc), sv)
    if not torch.equal(lib(), b):
        raise AssertionError('K2 library yardstick computes another function')
    xp_k = xp.clone()
    entry('window_scatter', 'K2', 'tmae_tpu_torch/csrc/windows.cu',
          'tmae_tpu/ops/occ_compact.py:759', err,
          time_ms(torch, lambda: oc.scatter_windows_into_padded(xw, idx, xp_k,
                                                                8)),
          time_ms(torch, lambda: oc.scatter_windows_into_padded_plain(
              xw, idx, xp_k, 8)),
          2 * n_real * win + idx.numel() * 4, 0, time_ms(torch, lib))

    # K3 / K4: every bucket of a stage-1 self layer (timed into the kernels
    # line), a stage-1 cross (WCA) layer and a stage-2 (C=256) self layer
    wplan = build_plans(occ[:1], 8, caps, kv_occ=occ[1:])[0]
    xc = oc.gather_windows_padded(xp[:1].contiguous(), wplan.cat_idx, 8)
    kc = oc.gather_windows_padded(xp[1:].contiguous(), wplan.cat_idx, 8)
    occ2 = torch.nn.functional.max_pool2d(occ[:, None].float(), 3, 2, 1)
    occ2 = occ2[:, 0] > 0
    plan2 = build_plans(occ2, 8, enc.sst_block_1.caps)[0]
    x2 = torch.randn(2, 234, 234, 256, generator=g, device=dev)
    x2 = torch.where(occ2[..., None], x2, 0.0).to(torch.bfloat16)
    xw2 = oc.gather_windows_padded(oc.pad_grid(x2, 8, False).contiguous(),
                                   plan2.cat_idx, 8)
    for label, layer, lplan, base, kv in (
            ('stage-1 self', enc.sst_block_0.encoder_0.EncoderLayer_0, plan,
             got.contiguous(), None),
            ('stage-1 cross', enc.wca_block_0.block_0.EncoderLayer_0, wplan,
             xc, kc),
            ('stage-2 self', enc.sst_block_1.encoder_0.EncoderLayer_0, plan2,
             xw2, None)):
        for case in layer_cases(el, layer, lplan, kv):
            rows_check(torch, label, case, base, kv is not None, entry)

    # K5 on the current frame's host voxelization
    V = model.vfe.encoder.spec.max_voxels
    Pn = batch['points'].shape[1]
    feat = torch.randn(1, Pn, 128, generator=g, device=dev)
    seg, ends, vmask = batch['pv_cur'], batch['vends_cur'], batch['vmask_cur']
    got = ss.sorted_segment_max(feat, seg, ends, vmask, V)
    want = ss.sorted_segment_max_plain(feat, seg, ends, vmask, V)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if err != 0:
        raise AssertionError(f'K5 differs from its plain version: {err}')
    seg_lib = seg.long().clamp(max=V)[0][:, None].expand(Pn, 128)
    out_lib = torch.zeros(V + 1, 128, device=dev)
    lib = lambda: out_lib.zero_().scatter_reduce_(0, seg_lib, feat[0], 'amax',
                                                  include_self=False)
    lib()
    if not torch.equal(torch.where(vmask[0, :, None], out_lib[:V], 0.0),
                       want[0]):
        raise AssertionError('K5 library yardstick computes another function')
    n_pts = int(batch['pvalid_cur'].sum())
    entry('sorted_segment_max', 'K5', 'tmae_tpu_torch/csrc/segment_max.cu',
          'tmae_tpu/ops/sorted_segments.py:87', err,
          time_ms(torch, lambda: ss.sorted_segment_max(feat, seg, ends, vmask,
                                                       V)),
          time_ms(torch, lambda: ss.sorted_segment_max_plain(
              feat, seg, ends, vmask, V), iters=5),
          n_pts * 128 * 4 + V * 128 * 4 + V * 4 + V, n_pts * 128,
          time_ms(torch, lib), peak=F32_FLOPS)
    return rows


def layer_cases(el, layer, plan, kv_all):
    """(kernel, tokens, valid windows, kernel fn, plain fn) for each bucket
    of one serving layer, each fn updating its argument in place."""
    p = layer.layer_params()
    cross = kv_all is not None
    kw = dict(nhead=layer.nhead, tau_min=layer.tau_min, cross=cross)
    cases, lo = [], 0
    for si in (plan.small, plan.mid):
        ksel, km = (si.ksel, si.kmask) if cross else (si.sel, si.qmask)
        args = (kv_all, si.sel, ksel, si.qmask, km, layer.pos, p)
        cases.append(('K4', si.sel.shape[-1], si.valid, p,
                      lambda t, a=args, lo=lo: el.encoder_layer_rows_sel(
                          t, *a, row_lo=lo, **kw),
                      lambda t, a=args, lo=lo: el.reference_encoder_layer_rows(
                          t, *a, row_lo=lo, **kw)))
        lo += si.idx.shape[1]
    fu = plan.full
    km = fu.kmask if cross else fu.qmask
    cases.append(('K3', 64, fu.valid, p,
                  lambda t: el.encoder_layer_rows_full(
                      t, kv_all, fu.qmask, km, layer.pos, p, row_lo=lo, **kw),
                  lambda t: el.reference_encoder_layer_rows(
                      t, kv_all, None, None, fu.qmask, km, layer.pos, p,
                      row_lo=lo, **kw)))
    return cases


def rows_check(torch, label, case, base, cross, entry):
    """One K3/K4 bucket call: kernel against plain version (bf16 output,
    max |diff| <= 0.15 and mean <= 2e-3: summation order can flip a bf16
    rounding of an intermediate), its time and its bound. Stage-1 self
    small (S=16) and full buckets go into the kernels line."""
    kernel, T, valid, p, fk, fp = case
    ka, pa = fk(base.clone()), fp(base.clone())
    torch.cuda.synchronize()
    d = (ka.float() - pa.float()).abs()
    err, mean = d.max().item(), d.mean().item()
    if not (err <= 0.15 and mean <= 2e-3):
        raise AssertionError(f'{kernel} {label} T={T} differs from its plain '
                             f'version: max {err} mean {mean}')
    C = base.shape[-1]
    nw = int(valid.sum())
    out_tokens = 64 if kernel == 'K3' else T
    nbytes = (nw * ((2 if cross else 1) * T + out_tokens) * C * 2
              + sum(t.numel() * t.element_size() for t in p))
    flops = nw * layer_flops(T, C, p.f1w.shape[0])
    kt = base.clone()
    ms = time_ms(torch, lambda: fk(kt), iters=10)
    b, by = bound_ms(nbytes, flops)
    log(f'  {kernel} {label} T={T}: {nw} of {valid.numel()} windows, '
        f'max_abs_err {err:.3g} (mean {mean:.2g}), kernel {ms:.4f} ms, '
        f'bound {b:.4f} ms ({by})')
    if label == 'stage-1 self' and T in (16, 64):
        name = 'encoder_rows_full' if kernel == 'K3' else 'encoder_rows_sel'
        line = ('tmae_tpu/ops/pallas_encoder.py:1680' if kernel == 'K3'
                else 'tmae_tpu/ops/pallas_encoder.py:1724')
        pt = pa.clone()
        entry(name, kernel, 'tmae_tpu_torch/csrc/encoder_layer.cu', line,
              err, ms, time_ms(torch, lambda: fp(pt), iters=3, warmup=1),
              nbytes, flops, None)


# ---------------------------------------------------------------------------
# phases 4-5: the serving path
# ---------------------------------------------------------------------------


def kernels():
    from tmae_tpu_torch.ops import encoder_layer, occ_compact, sorted_segments

    return {'K1': occ_compact.K1, 'K2': occ_compact.K2,
            'K3': encoder_layer.K3, 'K4': encoder_layer.K4,
            'K5': sorted_segments.K5}


def serve_once(torch, cfg, model, batch):
    from tmae_tpu_torch.models.detectors import centerpoint_predict, host_nms

    with torch.no_grad():
        out = model(batch)
        boxes, scores, labels, valid = centerpoint_predict(cfg, out)
        keep = host_nms(cfg, boxes, scores, labels, valid)
    return out, (boxes, scores, labels, keep)


def split_times(torch, cfg, model, batch, reps):
    """Median host ms of the parts of a serving pass: the forward's
    dispatch (host returns), the forward until the card is done, decode
    (ends in a sync), host NMS."""
    from tmae_tpu_torch.models.detectors import centerpoint_predict, host_nms

    parts = {'forward_dispatch': [], 'forward_done': [], 'decode': [],
             'host_nms': []}
    with torch.no_grad():
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(batch)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            dec = centerpoint_predict(cfg, out)
            t3 = time.perf_counter()
            host_nms(cfg, *dec)
            t4 = time.perf_counter()
            for k, v in zip(parts, (t1 - t0, t2 - t0, t3 - t2, t4 - t3)):
                parts[k].append(v * 1e3)
    return {k: statistics.median(v) for k, v in parts.items()}


def small_grid(cfg):
    """t_mae.yaml at full width on a 64x64 grid (20.48 m square) with caps
    to match, and one synthetic frame pair for it."""
    import copy

    from tmae_tpu_torch.datasets.synthetic import frame_pair_batch
    from tmae_tpu_torch.models.detectors import make_voxel_spec

    small = copy.deepcopy(cfg)
    small.DATA_CONFIG.POINT_CLOUD_RANGE = [-10.24, -10.24, -5.0, 10.24, 10.24,
                                          3.0]
    small.MODEL.DENSE_HEAD.POST_PROCESSING.POST_CENTER_LIMIT_RANGE = \
        small.DATA_CONFIG.POINT_CLOUD_RANGE
    small.RUNTIME.MAX_POINTS = 65536
    small.RUNTIME.MAX_VOXELS = [4096, 4096, 4096]
    small.RUNTIME.OCC_WINDOW_CAPS = [32, 16, 16]
    small.RUNTIME.OCC_SMALL_CAPS = [32, 16, 16]
    small.RUNTIME.OCC_MID_CAPS = [32, 16, 16]
    spec = make_voxel_spec(small.DATA_CONFIG, small.RUNTIME)
    return small, frame_pair_batch(spec, list(small.CLASS_NAMES), indices=(3,))


def card_vs_cpu(torch, cfg, np_batch, seed):
    """The detector with the same seeded weights on the card (kernels) and
    on the CPU (plain versions), same frames: every head map must be finite
    and agree to max |diff| <= 0.1 and mean <= 5e-3 of its scale (bf16
    carriers; summation order differs)."""
    from tmae_tpu_torch.models.detectors import (batch_to_device,
                                                 build_detector, init_random_)

    outs = []
    for dev in ('cuda', 'cpu'):
        model = init_random_(build_detector(cfg, dev), seed=seed)
        with torch.no_grad():
            outs.append(model(batch_to_device(np_batch, dev)))
    torch.cuda.synchronize()
    for name, a in outs[0]['pred_dicts'][0].items():
        b = outs[1]['pred_dicts'][0][name]
        d = (a.float().cpu() - b.float()).abs()
        scale = max(1.0, b.abs().max().item())
        log(f'  {name}: max_abs_err {d.max().item():.3g} (ref max '
            f'{b.abs().max().item():.3g}, mean err {d.mean().item():.2g})')
        if not torch.isfinite(a).all():
            raise AssertionError(f'{name}: non-finite values on the card')
        if d.max().item() > 0.1 * scale or d.mean().item() > 5e-3 * scale:
            raise AssertionError(f'{name}: card and CPU disagree')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--profile', action='store_true',
                    help='also profile one serving pass by kernel name')
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    if not (ROOT / 'tmae_tpu_torch').is_dir():
        print('chip_smoke: run it from a checkout of the repository',
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f'card: {card}; torch {torch.__version__} cuda {torch.version.cuda}')
    OUT_DIR.mkdir(parents=True, exist_ok=True)

    from tmae_tpu_torch.config import cfg_from_yaml_file
    from tmae_tpu_torch.datasets.synthetic import frame_pair_batch
    from tmae_tpu_torch.models.detectors import (batch_to_device,
                                                 build_detector, init_random_,
                                                 make_voxel_spec)
    from tmae_tpu_torch.utils.build import build_all

    log('phase build')
    t0 = time.perf_counter()
    built = build_all()
    with open(OUT_DIR / 'build_log.txt', 'w') as f:
        for name, info in built.items():
            f.write(f'== {name} ({info["seconds"]:.1f} s)\n{info["log"]}\n')
    for name, info in built.items():
        regs = [ln.strip() for ln in info['log'].splitlines()
                if 'registers' in ln]
        log(f'  built {name} in {info["seconds"]:.1f} s; {regs}')
    log(f'  build wall {time.perf_counter() - t0:.1f} s')

    cfg = cfg_from_yaml_file(ROOT / 'tools/cfgs/once_models/t_mae.yaml')
    spec = make_voxel_spec(cfg.DATA_CONFIG, cfg.RUNTIME)
    t0 = time.perf_counter()
    np_batch = frame_pair_batch(spec, list(cfg.CLASS_NAMES), indices=(0,))
    log(f'frames: {int(np_batch["point_mask"].sum())} / '
        f'{int(np_batch["point_mask_prev"].sum())} points, '
        f'{int(np_batch["vmask_cur"].sum())} / '
        f'{int(np_batch["vmask_prv"].sum())} pillars '
        f'({time.perf_counter() - t0:.1f} s on the host)')
    batch = batch_to_device(np_batch, 'cuda')
    model = init_random_(build_detector(cfg), seed=0)

    log('phase kernels (kernel vs plain at main-path shapes)')
    rows = check_kernels(torch, model, batch, 'cuda')

    log('phase serving (t_mae.yaml, full width, one frame pair)')
    for _ in range(2):
        serve_once(torch, cfg, model, batch)
    torch.cuda.synchronize()
    ks = kernels()
    for k in ks.values():
        k.launches = 0
    out, (boxes, scores, labels, keep) = serve_once(torch, cfg, model, batch)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in ks.items()}
    log(f'  launches per frame pair: {launches} (expected '
        f'{EXPECTED_LAUNCHES})')
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError('launch counts differ from the main path')
    for name, t in out['pred_dicts'][0].items():
        if t.shape[:3] != (1, 468, 468) or not torch.isfinite(t).all():
            raise AssertionError(f'head map {name}: bad shape or values')
    sf = out['spatial_features_2d']
    if sf.shape != (1, 468, 468, 128) or not torch.isfinite(sf.float()).all():
        raise AssertionError('spatial_features_2d: bad shape or values')
    if not torch.isfinite(boxes).all():
        raise AssertionError('decoded boxes are not finite')
    overflow = out['occ_overflow'].cpu().tolist()
    log(f'  occ_overflow [sst0, sst1, sst2, wca0, wca1, wca2]: {overflow}')
    log(f'  detections kept after NMS: {int(keep.sum())} of '
        f'{keep.shape[1]} candidates')
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve_once(torch, cfg, model, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    log(f'  ms per frame pair: median {med:.2f} (min {min(times):.2f}, max '
        f'{max(times):.2f}, {REPS} passes); {1e3 / med:.2f} frames/s')
    split = split_times(torch, cfg, model, batch, REPS)
    log('  median ms by part: ' + ', '.join(f'{k} {v:.2f}'
                                            for k, v in split.items()))
    log(f'  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}'
        ' GiB')
    for row in rows:
        row['launches'] = launches[row.pop('kernel')]

    if args.profile:
        profile_pass(torch, cfg, model, batch)

    log('phase reference: card vs CPU, full size')
    card_vs_cpu(torch, cfg, np_batch, seed=0)
    log('phase reference: card vs CPU, full width on a 64x64 grid')
    card_vs_cpu(torch, *small_grid(cfg), seed=7)

    log(f'total {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': rows, 'serving_ms_per_pair': med,
                      'frames_per_s': 1e3 / med}), flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


def profile_pass(torch, cfg, model, batch):
    """Device time by kernel name over one serving pass (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve_once(torch, cfg, model, batch)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by='self_cuda_time_total',
                                      row_limit=40)
    (OUT_DIR / 'profile.txt').write_text(table)
    log(table)


if __name__ == '__main__':
    sys.exit(main())
