#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA H100
and check them.

    python3 chip_smoke.py            # what the chip check runs
    python3 chip_smoke.py --profile  # also writes per-kernel time tables

Phases (any failure exits non-zero and prints no result line):
  1. card: fail without CUDA; print ``nvidia-smi`` name and power limit.
  2. build: compile every CUDA source of ``tmae_tpu_torch/csrc`` (one nvcc
     per source, all at once).
  3. kernels: each kernel against its plain PyTorch version at the shapes of
     the t_mae.yaml main paths (stage-1 plans of a synthetic frame pair,
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
  6. training: finetune steps of t_mae.yaml at full width and depth on two
     synthetic frame pairs (scenes 0 and 1; the config's batch is 6): the
     training kernels K6-K9 against their plain versions on the layer
     inputs one train-mode forward of this batch hands them (every bucket,
     self and cross, C=128 and C=256); launch counters set to 0, one step
     (forward in train mode, CenterPoint loss, backward through K7/K9 and
     the VJPs of K1/K2/K5, one adam_onecycle update), the counts checked
     per step; then timed steps on the same batch, whose loss must stay
     finite and fall, with occ_overflow 0.
  7. training reference: one step on the card (kernels) and on the CPU
     (plain versions) from the same weights at full width on a 64x64 grid,
     and the control (the CPU step with the encoder's weights rounded once
     to bf16): loss, every gradient (whole and per tensor, held to the
     control's level) and the batch-norm running statistics compared.
Prints the kernels line, the card line and, last, the result line.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
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
EXPECTED_LAUNCHES = {'K1': 24, 'K2': 18, 'K3': 18, 'K4': 36, 'K5': 2,
                     'K6': 0, 'K7': 0, 'K8': 0, 'K9': 0}
# One training step of t_mae.yaml: 18 encoder layers (3 stages x 2 blocks x
# 2 shifted layers of self attention, 3 WCA blocks x 2 cross layers), each
# one gather (two in cross mode), the bucket kernels (K8 on S=16 and S=48,
# K6 on T=64) and one scatter; the VFE runs K5 once per frame. Backward:
# K9 x2 and K7 per layer, one K2 per gather (its VJP) and, per scatter, a
# K1 gather of g plus a K2 scatter of zeros. Remat replays the forward of
# the 12 SST layers (their shift blocks are checkpointed) and of the VFE
# encoder (K5 x2); the WCA attention is not rematerialised.
EXPECTED_TRAIN_LAUNCHES = {
    'K1': 24 + 18 + 12, 'K2': 18 + 24 + 18 + 12, 'K3': 0, 'K4': 0,
    'K5': 2 + 2, 'K6': 18 + 12, 'K7': 18, 'K8': 36 + 24, 'K9': 36}
REPS = 20                      # timed serving passes
TRAIN_STEPS = 6                # step 0 counted, steps 1-5 timed
TRAIN_PAIRS = (0, 1)           # synthetic scenes of the training batch


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


def add_row(rows, name, kernel, source, replaces, err, ms, plain_ms, nbytes,
            flops, library_ms, peak=BF16_FLOPS):
    """One kernel's entry of the kernels line (its launches are filled in
    after the main path's run)."""
    b, by = bound_ms(nbytes, flops, peak)
    rows.append({'name': name, 'route': 'cuda', 'source': source,
                 'replaces': replaces, 'kernel': kernel,
                 'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                 'bound_ms': b, 'bound_by': by, 'library_ms': library_ms})
    log(f'  {name}: max_abs_err {err:.3g}  kernel {ms:.4f} ms  plain '
        f'{plain_ms:.4f} ms  bound {b:.4f} ms ({by})  library '
        f'{library_ms if library_ms is None else round(library_ms, 4)}')


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

    entry = functools.partial(add_row, rows)

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


def train_layer_calls(torch, model, batch):
    """The inputs of the training layer (K6 / K8 forward, K7 / K9 backward)
    as one train-mode forward of ``batch`` hands them over: for each width,
    mode and token count (T = 16, 48, 64) the first call, i.e. at C=128 a
    stage-1 self layer and a WCA block-0 cross layer, at C=256 a stage-2
    self layer and a WCA block-1 cross layer. The model's running
    statistics are left as they were."""
    from tmae_tpu_torch.ops import encoder_layer as el

    calls = {}
    real = el._FusedEncoderLayer

    class Capture:
        @staticmethod
        def apply(*args):
            xw, sel_q, (_, _, cross) = args[0], args[2], args[7]
            key = (xw.shape[-1], cross, 64 if sel_q is None
                   else sel_q.shape[-1])
            calls.setdefault(key, args)
            return real.apply(*args)

    bufs = {n: b.clone() for n, b in model.named_buffers()}
    el._FusedEncoderLayer = Capture
    try:
        with torch.no_grad():
            model.train()(batch)
    finally:
        el._FusedEncoderLayer = real
        with torch.no_grad():
            for n, b in model.named_buffers():
                b.copy_(bufs[n])
    return calls


def train_check(torch, el, call, gen, entry):
    """K6 / K8 and K7 / K9 on one bucket against their plain versions on
    the same card. Forward: bf16 output, max |diff| <= 0.15 and mean <=
    2e-3 (as K3/K4). Backward, each of dx, dkv, the 17 parameter gradients
    and (K7) dpos: max |diff| <= 5e-2 and mean <= 5e-3 of the output's
    scale (the kernels round the backward's matmul operands to bf16 as the
    TPU kernel does; the plain version is autograd in f32); dtau, one sum
    over all windows and heads, within 10% of its value. The C=128 self
    (stage-1) small (S=16) and full buckets go into the kernels line."""
    x, kvw, sq, sk, qm, km, pos, (nhead, tau_min, cross), p, *weights = call
    S = None if sq is None else sq.shape[-1]
    weights = [w.detach() for w in weights]
    label = f'C={x.shape[-1]} {"cross" if cross else "self"}'
    kw = dict(nhead=nhead, tau_min=tau_min, cross=cross)
    args = (x, kvw, sq, sk, qm, km, pos)
    fk = lambda: el.encoder_layer_fwd(*args, p, **kw)
    fp = lambda: el.reference_encoder_layer(*args, p, nhead, tau_min, cross)
    ka, pa = fk(), fp()
    torch.cuda.synchronize()
    d = (ka.float() - pa.float()).abs()
    ferr, fmean = d.max().item(), d.mean().item()
    kname = ('K6', 'K7') if S is None else ('K8', 'K9')
    T = S or 64
    if not (ferr <= 0.15 and fmean <= 2e-3):
        raise AssertionError(f'{kname[0]} {label} T={T} differs from its '
                             f'plain version: max {ferr} mean {fmean}')
    g = torch.randn(x.shape, generator=gen, device=x.device).to(torch.bfloat16)
    dpos = S is None
    bk = lambda: el.encoder_layer_bwd(*args, weights, g, want_dpos=dpos, **kw)
    bp = lambda: el.reference_encoder_layer_bwd(*args, weights, g,
                                                want_dpos=dpos, **kw)
    rk, rp = bk(), bp()
    torch.cuda.synchronize()
    names = ['dx', 'dkv'] + list(el.LayerParams._fields) + ['dpos']
    worst = (0.0, '')
    for name, a, b in zip(names, [rk[0], rk[1], *rk[2], rk[3]],
                          [rp[0], rp[1], *rp[2], rp[3]]):
        if (a is None) != (b is None):
            raise AssertionError(f'{kname[1]} {label}: {name} missing')
        if a is None:
            continue
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            raise AssertionError(f'{kname[1]} {label}: {name} not finite')
        scale = b.abs().max().item()
        e = (a - b).abs()
        if name == 'tau':
            ok = e.item() <= 0.1 * scale
        else:
            ok = (e.max().item() <= 5e-2 * scale
                  and e.mean().item() <= 5e-3 * scale)
        if not ok:
            raise AssertionError(
                f'{kname[1]} {label} T={T}: {name} differs from its plain '
                f'version: max {e.max().item()} mean {e.mean().item()} '
                f'scale {scale}')
        worst = max(worst, (e.max().item() / max(scale, 1e-30), name))
    berr = (rk[0].float() - rp[0].float()).abs().max().item()
    C, Fd, N = x.shape[-1], p.f1w.shape[0], x.shape[0]
    nw = int((qm > 0).any(-1).sum())
    win = 64 * C * 2
    wbytes = sum(t.numel() * t.element_size() for t in p)
    kv_bytes = nw * T * C * 2 if cross else 0
    x_bytes = nw * win if S is None else N * win  # K8 copies the rest through
    fwd_bytes = x_bytes + kv_bytes + N * win + wbytes
    fwd_flops = nw * layer_flops(T, C, Fd)
    # backward: x, kv, g and the weights in; dx, dkv and f32 weight
    # gradients out; forward recompute plus two products per matmul
    bwd_bytes = (nw * T * C * 2 + kv_bytes + 2 * N * win
                 + (N * win if cross else 0) + wbytes
                 + 4 * sum(t.numel() for t in p))
    bwd_flops = 3 * fwd_flops
    ms_f = time_ms(torch, fk, iters=10)
    ms_b = time_ms(torch, bk, iters=5)
    bf, byf = bound_ms(fwd_bytes, fwd_flops)
    bb, byb = bound_ms(bwd_bytes, bwd_flops)
    log(f'  {kname[0]}/{kname[1]} {label} T={T}: {nw} of {N} windows; '
        f'forward max_abs_err {ferr:.3g} (mean {fmean:.2g}), {ms_f:.4f} ms, '
        f'bound {bf:.4f} ms ({byf}); backward dx max_abs_err {berr:.3g}, '
        f'worst relative {worst[0]:.3g} ({worst[1]}), {ms_b:.4f} ms, bound '
        f'{bb:.4f} ms ({byb})')
    if label == 'C=128 self' and T in (16, 64):
        full = S is None
        fsrc = 'tmae_tpu_torch/csrc/encoder_layer.cu'
        bsrc = 'tmae_tpu_torch/csrc/encoder_layer_bwd.cu'
        site = 'tmae_tpu/ops/pallas_encoder.py:'
        entry('encoder_train_fwd_full' if full else 'encoder_train_fwd_sel',
              kname[0], fsrc, site + ('346' if full else '1038'), ferr, ms_f,
              time_ms(torch, fp, iters=3, warmup=1), fwd_bytes, fwd_flops,
              None)
        entry('encoder_train_bwd_full' if full else 'encoder_train_bwd_sel',
              kname[1], bsrc, site + ('752' if full else '1403'), berr, ms_b,
              time_ms(torch, bp, iters=2, warmup=1), bwd_bytes, bwd_flops,
              None)


# ---------------------------------------------------------------------------
# phases 4-5: the serving path
# ---------------------------------------------------------------------------


def kernels():
    from tmae_tpu_torch.ops import encoder_layer, occ_compact, sorted_segments

    return {'K1': occ_compact.K1, 'K2': occ_compact.K2,
            'K3': encoder_layer.K3, 'K4': encoder_layer.K4,
            'K5': sorted_segments.K5, 'K6': encoder_layer.K6,
            'K7': encoder_layer.K7, 'K8': encoder_layer.K8,
            'K9': encoder_layer.K9}


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
    return small, frame_pair_batch(spec, list(small.CLASS_NAMES), indices=(3,),
                                   max_gt=int(small.RUNTIME.MAX_GT))


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


# ---------------------------------------------------------------------------
# phases 6-7: the training path
# ---------------------------------------------------------------------------


def make_trainer(cfg, model):
    """adam_onecycle over a one-cycle run of NUM_EPOCHS steps (one step per
    epoch), and the training step with the CenterPoint loss."""
    from tmae_tpu_torch.models.detectors import centerpoint_loss
    from tmae_tpu_torch.train.optimization import build_optimizer
    from tmae_tpu_torch.train.trainer import make_train_step

    opt, sched = build_optimizer(model.parameters(), cfg.OPTIMIZATION, 1)
    return make_train_step(model, lambda o, b: centerpoint_loss(cfg, o, b),
                           opt, sched)


def train_phase(torch, cfg, spec, rows, profile=False):
    """Full-width, full-depth finetune steps on TRAIN_PAIRS frame pairs:
    K6-K9 against their plain versions on the layer inputs of this batch
    (their kernels-line entries go into ``rows``); step 0 with the launch
    counters set to 0 before it and read after it; then timed steps on the
    same batch; with ``profile``, the median forward and backward times of
    three more passes (no update) and a profiled step. Returns the launch
    counts and the phase's numbers."""
    from tmae_tpu_torch.datasets.synthetic import frame_pair_batch
    from tmae_tpu_torch.models.detectors import (batch_to_device,
                                                 build_detector, init_random_)
    from tmae_tpu_torch.ops import encoder_layer as el

    t0 = time.perf_counter()
    np_batch = frame_pair_batch(spec, list(cfg.CLASS_NAMES),
                                indices=TRAIN_PAIRS,
                                max_gt=int(cfg.RUNTIME.MAX_GT))
    log(f'  batch: {len(TRAIN_PAIRS)} frame pairs, '
        f'{int(np_batch["point_mask"].sum())} current-frame points, '
        f'{int(np_batch["gt_mask"].sum())} boxes '
        f'({time.perf_counter() - t0:.1f} s on the host)')
    batch = batch_to_device(np_batch, 'cuda')
    model = init_random_(build_detector(cfg), seed=0)
    calls = train_layer_calls(torch, model, batch)
    log('  K6-K9 against their plain versions on the layer inputs of this '
        f'batch ({len(calls)} calls)')
    gen = torch.Generator(device='cuda').manual_seed(2)
    for key in sorted(calls):
        train_check(torch, el, calls[key], gen,
                    functools.partial(add_row, rows))
    del calls
    step = make_trainer(cfg, model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ks = kernels()
    for k in ks.values():
        k.launches = 0
    t0 = time.perf_counter()
    metrics = [step(batch)]
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {name: k.launches for name, k in ks.items()}
    log(f'  launches per training step: {launches} (expected '
        f'{EXPECTED_TRAIN_LAUNCHES})')
    if launches != EXPECTED_TRAIN_LAUNCHES:
        raise AssertionError('launch counts differ from the training path')
    times = []
    for _ in range(TRAIN_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(step(batch))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    steps = [{k: float(v) for k, v in m.items()} for m in metrics]
    for i, r in enumerate(steps):
        log(f'  step {i}: ' + ', '.join(f'{k} {v:.5g}' for k, v in r.items()))
    losses = [r['loss'] for r in steps]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError('training loss is not finite')
    if not losses[-1] < losses[0]:
        raise AssertionError(f'training loss did not fall: {losses}')
    if any(r['occ_overflow'] != 0 for r in steps):
        raise AssertionError('occupied windows overflowed a bucket cap')
    for name, prm in model.named_parameters():
        if not torch.isfinite(prm).all():
            raise AssertionError(f'parameter {name} is not finite')
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    pairs_s = len(TRAIN_PAIRS) * 1e3 / med
    log(f'  ms per training step: median {med:.2f} (min {min(times):.2f}, '
        f'max {max(times):.2f}, {len(times)} steps; step 0 {first_ms:.1f}); '
        f'{pairs_s:.3f} frame pairs/s; peak device memory {peak:.2f} GiB')
    if profile:
        split = train_split_times(torch, cfg, model, batch)
        log('  median ms by part (separate passes): '
            + ', '.join(f'{k} {v:.2f}' for k, v in split.items()))
        profile_train_step(torch, step, batch)
    return launches, {'train_ms_per_step': med, 'train_pairs_per_s': pairs_s,
                      'train_peak_gib': peak, 'train_loss': losses}


def train_split_times(torch, cfg, model, batch, reps=3):
    """Median ms of the training forward with the loss and of the
    backward, each ending in a sync; the gradients are dropped, the weights
    are not updated."""
    from tmae_tpu_torch.models.detectors import centerpoint_loss

    parts = {'forward_and_loss': [], 'backward': []}
    model.train()
    for _ in range(reps):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = centerpoint_loss(cfg, model(batch), batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        parts['forward_and_loss'].append((t1 - t0) * 1e3)
        parts['backward'].append((t2 - t1) * 1e3)
    model.zero_grad(set_to_none=True)
    return {k: statistics.median(v) for k, v in parts.items()}


def profile_train_step(torch, step, batch):
    """Device time by kernel name over one training step (torch.profiler);
    the table ends with the step's self CPU and device time totals."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    (OUT_DIR / 'profile_train.txt').write_text(
        avg.table(sort_by='self_cuda_time_total', row_limit=-1))
    log(avg.table(sort_by='self_cuda_time_total', row_limit=50))


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def _rel(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float((a - b).norm() / (b.norm() + 1e-30))


def train_step_once(torch, cfg, np_batch, seed, dev, round_encoder=False):
    """One training step from the seeded weights on ``dev``, with the
    encoder's weights rounded once to bf16 if asked. Returns (metrics,
    gradients, state before, state after), on the CPU."""
    from tmae_tpu_torch.models.detectors import (batch_to_device,
                                                 build_detector, init_random_)

    model = init_random_(build_detector(cfg, dev), seed=seed)
    if round_encoder:
        with torch.no_grad():
            for n, prm in model.named_parameters():
                if n.startswith('backbone_3d.encoder.'):
                    prm.copy_(prm.to(torch.bfloat16).float())
    before = {k: t.detach().cpu().clone()
              for k, t in model.state_dict().items()}
    step = make_trainer(cfg, model)
    m = {k: float(v) for k, v in step(batch_to_device(np_batch, dev)).items()}
    grads = {n: prm.grad.detach().float().cpu()
             for n, prm in model.named_parameters()}
    after = {k: t.detach().cpu() for k, t in model.state_dict().items()}
    return m, grads, before, after


def grad_agreement(torch, got, want, names):
    """(relative L2 error, cosine) over ``names`` together, and per tensor
    with a nonzero gradient the worst relative L2 error and the range of
    the norm ratio |got| / |want|."""
    a = torch.cat([got[n].flatten() for n in names])
    b = torch.cat([want[n].flatten() for n in names])
    live = [n for n in names if want[n].numel() > 1 and want[n].any()]
    per = max((_rel(got[n], want[n]), n) for n in live)
    ratio = sorted((float(got[n].double().norm() / want[n].double().norm()),
                    n) for n in live)
    return _rel(a, b), _cos(a, b), per, (ratio[0], ratio[-1]), len(live)


def train_card_vs_cpu(torch, cfg, np_batch, seed):
    """One training step with the same seeded weights on the card (kernels)
    and on the CPU (plain versions), and the control: the CPU step from the
    same weights with the encoder's rounded once to bf16, which shows how
    far one bf16 rounding moves this network's gradient at random weights
    (both sides round activations to bf16 at the same places, but not to
    the same values). Loss within 1% and grad_norm within 5%. Gradients,
    over all parameters but the biases of the convolutions before a batch
    norm (their gradient is 0 up to rounding): the card's relative L2
    error against the CPU at most 1.25 times the control's, its cosine at
    least the control's less 0.02; per tensor with a nonzero gradient,
    relative L2 error <= 0.75 and norm ratio within [2/3, 3/2] (a zero, a
    foreign or a doubled gradient reads 1 or more, a halved one 0.5 with
    its ratio outside). Batch-norm running statistics: the VFE's (f32, two
    updates per step) change by the same amounts to 1e-3 of the change,
    every other statistic's change agrees in cosine >= 0.9."""
    mk, gk, bk, ak = train_step_once(torch, cfg, np_batch, seed, 'cuda')
    mp, gp, bp, ap = train_step_once(torch, cfg, np_batch, seed, 'cpu')
    mc, gc, _, _ = train_step_once(torch, cfg, np_batch, seed, 'cpu',
                                   round_encoder=True)
    log('  card:    ' + ', '.join(f'{k} {v:.5g}' for k, v in mk.items()))
    log('  cpu:     ' + ', '.join(f'{k} {v:.5g}' for k, v in mp.items()))
    log('  control: ' + ', '.join(f'{k} {v:.5g}' for k, v in mc.items()))
    if abs(mk['loss'] - mp['loss']) > 0.01 * abs(mp['loss']):
        raise AssertionError('training loss: card and CPU disagree')
    if abs(mk['grad_norm'] - mp['grad_norm']) > 0.05 * mp['grad_norm']:
        raise AssertionError('grad_norm: card and CPU disagree')
    names = [n for n in gp if not (n.endswith('conv.bias')
                                   or n == 'dense_head.shared_conv.bias')]
    for n in gk:
        if not torch.isfinite(gk[n]).all():
            raise AssertionError(f'gradient {n} is not finite on the card')
    control = grad_agreement(torch, gc, gp, names)
    card = grad_agreement(torch, gk, gp, names)
    for label, (rel, cos, per, ratio, n_live) in (('control vs cpu', control),
                                                  ('card vs cpu', card)):
        log(f'  gradients, {label}: relative L2 error {rel:.4f}, cosine '
            f'{cos:.5f} over {len(names)} tensors; per tensor ({n_live} '
            f'nonzero) worst relative L2 error {per[0]:.4f} ({per[1]}), '
            f'norm ratio {ratio[0][0]:.4f} ({ratio[0][1]}) to '
            f'{ratio[1][0]:.4f} ({ratio[1][1]})')
    rel, cos, per, ratio, _ = card
    if not (rel <= 1.25 * control[0] and cos >= control[1] - 0.02):
        raise AssertionError('gradients: card and CPU disagree by more than '
                             'one bf16 rounding of the weights moves them')
    if not (per[0] <= 0.75 and 2 / 3 <= ratio[0][0]
            and ratio[1][0] <= 1.5):
        raise AssertionError('a gradient tensor: card and CPU disagree')
    stats = [k for k in bp if 'running' in k]
    worst_stat = (1.0, '')
    for k in stats:
        dk, dp = ak[k] - bk[k], ap[k] - bp[k]
        if k.startswith('vfe.'):
            scale = dp.abs().max().item()
            if (dk - dp).abs().max().item() > 1e-3 * scale:
                raise AssertionError(f'{k}: card and CPU disagree')
        else:
            c = _cos(dk, dp)
            worst_stat = min(worst_stat, (c, k))
            if c < 0.9:
                raise AssertionError(f'{k}: card and CPU disagree ({c})')
    log(f'  batch-norm statistics: {len(stats)} tensors agree; lowest '
        f'cosine of a change {worst_stat[0]:.4f} ({worst_stat[1]})')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--profile', action='store_true',
                    help='also profile one serving pass and one training '
                    'step by kernel name')
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
    peak_start = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
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
    log(f'  peak device memory of the serving passes '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (of the '
        f'process before them, kernels phase included, {peak_start:.2f} GiB)')
    for row in rows:
        if not row['name'].startswith('encoder_train'):
            row['launches'] = launches[row.pop('kernel')]

    if args.profile:
        profile_pass(torch, cfg, model, batch)

    log('phase reference: card vs CPU, full size')
    card_vs_cpu(torch, cfg, np_batch, seed=0)
    log('phase reference: card vs CPU, full width on a 64x64 grid')
    card_vs_cpu(torch, *small_grid(cfg), seed=7)

    log('phase training (t_mae.yaml, full width and depth, '
        f'{len(TRAIN_PAIRS)} frame pairs)')
    del model, batch, out
    torch.cuda.empty_cache()
    train_launches, train = train_phase(torch, cfg, spec, rows, args.profile)
    for row in rows:
        if row['name'].startswith('encoder_train'):
            row['launches'] = train_launches[row.pop('kernel')]

    log('phase training reference: one step, card vs CPU, full width on a '
        '64x64 grid')
    train_card_vs_cpu(torch, *small_grid(cfg), seed=7)

    log(f'total {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': rows, 'serving_ms_per_pair': med,
                      'frames_per_s': 1e3 / med, **train}), flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


def profile_pass(torch, cfg, model, batch):
    """Device time by kernel name over one serving pass (torch.profiler):
    the top rows logged, every row in the file."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve_once(torch, cfg, model, batch)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    (OUT_DIR / 'profile.txt').write_text(
        avg.table(sort_by='self_cuda_time_total', row_limit=-1))
    log(avg.table(sort_by='self_cuda_time_total', row_limit=40))


if __name__ == '__main__':
    sys.exit(main())
