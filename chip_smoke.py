#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, pretraining and evaluation
paths on one NVIDIA H100 and check them.

    python3 chip_smoke.py            # what the chip check runs
    python3 chip_smoke.py --profile  # also writes per-kernel time tables
    python3 chip_smoke.py --nms-parent PATH  # phase 16 also runs PATH's
                                             # iou_nms.cu (a parent's)

Phases (any failure exits non-zero and prints no result line):
  1. card: fail without CUDA; print ``nvidia-smi`` name and power limit.
  2. build: compile every CUDA source of ``tmae_tpu_torch/csrc`` (one nvcc
     per source, all at once).
  3. kernels: each kernel against its plain PyTorch version at the shapes of
     the t_mae.yaml main paths (stage-1 plans of a synthetic frame pair,
     131072 points; K3, K4 and K12 also on stage 2 and in cross mode, with
     the layer's weights prepared once as a served forward prepares them,
     and timed also with weights prepared in the call; K3, K4 and K12 also
     exactly: rows and cells outside their range or plan (the dummy window
     row too), windows without a query and cells they do not select keep
     their bits or are 0 as the layer makes them, the same bits twice, no
     leak between the windows of a tile, a prefix with a partial last tile
     gives the whole call's bits; the weight panels of a served layer bit
     for bit against their plain version; K5 bit for bit also on int64
     slots and on a skewed case of two frames: a 551-row pillar over nine
     slices, pillars ending on a slice edge, negative rows, absent slots,
     out-of-range rows, twice for the same bits), with its time, the plain
     version's time, one PyTorch library call's time where one computes the
     same function, and the least time the card could take (bytes / 3.35
     TB/s or FLOPs / 989 TFLOP/s bf16, counting the windows and points this
     run's data needs).
  4. serving: the full-width t_mae.yaml detector with seeded random weights
     on a synthetic LiDAR frame pair (density 1.5, ~100k points per frame):
     launch counters set to 0, one pass (forward, decode, host NMS: the
     native host ops, ``utils/native.py``), the counts checked per frame
     pair; host NMS timed on that pass's candidates by the native and by
     the numpy path (and so in 5a, 5b and 12); then warm timed passes.
  5. reference: the same detector run on the card (kernels) and on the CPU
     (plain versions) with the same weights and frames, head maps compared:
     at full size, and at full width on a 64x64 grid.
  5a. fused serving: the same detector with the fused in-place layer path
     (K12, as TMAE_FUSED_INPLACE=1 selects it): counters set to 0, one
     pass, the counts checked; warm timed passes; head maps held to the
     default path's on the same weights and frames.
  5b. streaming serving, on the default and on the fused path: the
     previous frame encoded alone (``return_hidden``), then the pair served
     from its cached pyramid (``cached_prev``): counters set to 0, one
     pass, the counts checked (K5 once: the previous frame's VFE and SST
     stages are skipped); warm timed passes; the device time of one
     streaming and one stateless pass; head maps held to the stateless
     pass's; and the streaming pass on the card against the CPU at full
     width on a 64x64 grid.
  5c. windowed SubM conv and attention only: the conv_out inputs of one
     serving forward (3 SST stages, 3 WCA blocks) and the stage-1 and
     stage-2 grids; launch counters set to 0, then the path of the
     unpadded window API (gather, scatter, scatter-into and their VJPs:
     K1, K2 as K13b, K13c) on the stage-1 plans of every occupied window,
     SubMConvBlock with such a plan (K15, K13b) forward and backward in
     train mode on the 6 inputs, DenseWindowAttention (K16, seeded
     weights) on 4 cases; the counts checked; what came out held to the
     plain versions (window API exactly; the planned conv to the dense
     block; attention at K3's limits); each kernel against its plain
     version; K16 also exactly (bo to the bit on windows without a key,
     the same bits twice, no leak between windows, a prefix of the
     windows, the windows with a key and no query cell of the cross case)
     and its panels bit for bit; K15 also exactly (dummy and query-less
     slots zero, the same bits twice, permuted slots, a partial last tile,
     the windows on all four grid edges against the same windows in a
     zero-padded grid);
     K13b and K13c bit for bit against their plain versions and
     index_put, shifted and not, K13c also with occupied windows left out
     of the plan, its VJP and a contiguous output; K13b, K13c, K15 (stage
     1 and 2) and K16 timed, with cuDNN's dense conv2d and index_put as
     the yardsticks.
  6. training: finetune steps of t_mae.yaml at full width and depth on two
     synthetic frame pairs (scenes 0 and 1; the config's batch is 6): the
     training kernels K6-K9 against their plain versions on the layer
     inputs one train-mode forward of this batch hands them (every bucket,
     self and cross, C=128 and C=256; K6 and K8 also exactly; K7/K9 also on
     cotangents with half the windows zeroed, which they skip, and twice
     for the same bits);
     launch counters set to 0, one step
     (forward in train mode, CenterPoint loss, backward through K7/K9 and
     the VJPs of K1/K2/K5, one adam_onecycle update), the counts checked
     per step; then timed steps on the same batch, whose loss must stay
     finite and fall, with occ_overflow 0.
  7. training reference: one step on the card (kernels) and on the CPU
     (plain versions) from the same weights at full width on a 64x64 grid,
     and the control (the CPU step with the encoder's weights rounded once
     to bf16): loss, every gradient (whole and per tensor, held to the
     control's level) and the batch-norm running statistics compared.
  8. grid layer: K10 (the grid-native layer of the configs without bucket
     caps) against its plain version on the layer inputs one train-mode
     forward of the t_mae_ssl_waymo.yaml pretraining batch hands it (C=128
     self at shift 0 and 1, C=256 self, C=128 and C=256 cross; captured
     under deterministic algorithms, so every run checks the same inputs),
     and its backward (K7 on the windows with an occupied query cell)
     against autograd through the plain version at C=128 self, C=256 self
     and C=128 cross, each run twice for the same bits.
  9. pretraining, t_mae_ssl_waymo.yaml (no caps: every encoder layer is
     K10, its backward K7), full width and depth, two synthetic frame pairs
     (the config's batch is 8), device voxelization, a mask from a seeded
     generator each step: launch counters set to 0, one step, the counts
     checked; then timed steps, whose Chamfer loss must stay finite and
     fall.
 10. pretraining, t_mae_ssl.yaml (bucketed path, K1/K2/K6-K9): the same for
     a few steps, with occ_overflow reported.
 11. pretraining reference: one t_mae_ssl_waymo.yaml step on the card and
     on the CPU at full width on a 64x64 grid, with one mask drawn on the
     CPU and given to both, held to the control as in phase 7.
 12. Waymo serving: the full-width t_mae_waymo.yaml detector (device
     voxelization, K10 in eval mode) on one frame pair: counters set to 0,
     one pass, the counts checked, then timed passes; the same detector on
     the card and on the CPU at full width on a 64x64 grid, as in phase 5.
 13. ONCE evaluation: seeded random weights of the full-width
     t_mae_synth.yaml detector (t_mae.yaml's MODEL, batch 1) saved by
     ``save_checkpoint``; ``python -m tmae_tpu_torch.tools.test``'s ``main``
     run in this process on the card over 4 synthetic lidar frame pairs
     (the loader, host voxelization, forward, decode, native host NMS,
     ONCE AP, result.pkl): launch counters set to 0, the counts checked (4
     x a served pair's); the native library built from the repository's
     source; each batch's kept mask equal to the numpy NMS on the same
     candidates; the AP dict equal to its numpy recomputation; result.pkl
     with the 4 frame ids in order; every AP finite; occ_overflow 0;
     sec_per_sample, loader ms per batch and host NMS ms per pair (native
     and numpy) printed.
 14. training through the CLIs (``python -m tmae_tpu_torch.tools.train``'s
     ``main`` in this process, on the card; everything written to a
     temporary directory).
     14a. full width: a ONCE-layout tree of 12 synthetic LiDAR sweeps
     (~97k points each) with their boxes; the port's ``create_once_infos``
     (infos, GT database); t_mae_ssl.yaml pretraining 1 epoch; t_mae.yaml
     finetuning 1 epoch from that checkpoint (every transferred entry equal
     to the checkpoint's, the BEV backbone and head at their initial
     values), with gt_sampling, flip, rotation and scaling; the same command
     with --epochs 2 --max_ckpt_save_num 1 --num_epochs_to_eval 1: resumed
     from the newest checkpoint (the step continues, the first lr is the
     schedule's at that step, ckpt/ pruned to one file), then evaluated.
     Only DATA_PATH and the batch (2) differ from the configs. Each run with
     the launch counters set to 0 just before it and read just after, each
     step's launches against phase 6's or 10's; loss finite; occ_overflow,
     metrics.jsonl, every AP finite, result.pkl's frame ids in order; ms
     per step (data and step), peak memory and sec_per_sample printed.
     14b. the overfit oracle of tests/test_overfit_ap.py
     (``tests/test_torch_port_overfit_ap.run_overfit``): its 6-frame raw
     fixture, 2 pretraining and 250 finetune epochs of its config (with a
     small bucket beside its full one, caps that hold every window),
     ``tools.test``; max score > 0.3, Vehicle AP > 30, occ_overflow 0.
 15. Waymo through the CLIs (everything in a temporary directory).
     15a. full width: one TFRecord of 8 frames of the port's synthetic top
     LiDAR (``datasets/synthetic.waymo_sequence``: 64 x 2650 range
     images with range, intensity, elongation and NLZ, pixel poses, the
     calibration, a moving vehicle's poses, labelled boxes; 100k-131072
     points in range a frame), named by the train and val splits; the
     port's ``create_waymo_infos`` (decode, infos, point files, GT
     database); t_mae_ssl_waymo.yaml pretraining 1 epoch; t_mae_waymo.yaml
     finetuning 1 epoch from that checkpoint (the transfer checked), then
     resumed for a second epoch; ``tools.test`` over the val split's 4
     pairs. Only DATA_PATH and the batch (2) differ from the configs. Each
     run with the launch counters set to 0 just before it and read just
     after: each pretraining step's launches against phase 9's, each
     finetune step's against EXPECTED_FINETUNE_GRID, the evaluation's
     against a served Waymo pair's per batch; losses finite, occ_overflow
     0, result.pkl's frame ids in order, the prediction file written,
     boxes kept, every AP and APH at LEVEL_1 / LEVEL_2 finite and equal
     to its recomputation with the numpy IoU; decode ms a frame, infos s,
     loader and step ms, peak memory, sec_per_sample printed.
     15b. one t_mae_waymo.yaml finetune step on the card and on the CPU at
     full width on a 64x64 grid, on a loader batch of that tree (5 point
     features), held to the control as in phase 7.
 16. device IoU and NMS, the IoU head, the asymmetric encoder and the
     remaining evaluation options (``csrc/iou_nms.cu``).
     16a. IOU_PAIRS (BEV and 3D), IOU_ALIGNED, NMS_MASK and NMS_SCAN
     against their plain versions on the 500 candidates of phase 4's pair
     (served again in 16b) and on 500 crowded synthetic boxes: IoU to
     1e-5; the mask bit for bit, a flipped bit printed with its IoU's
     distance from the threshold (under 1e-5 or the run fails); the scan
     exactly on the kernel's mask; the keep mask against the plain greedy
     NMS, for nms_gpu at 0.5 and multi_class_nms at [0.7, 0.6, 0.55,
     0.55, 0.55]; the NMS checks also on crowded sets of K = 1, 77 and
     2100 with B = 2, for nms_gpu and for those thresholds with per-class
     caps [120, 40, 10, 3, 0]; their times, plain times, bounds and host
     native NMS's. NMS_MASK's and NMS_SCAN's device ms by launch and host
     enqueue ms come from ``python3 -m tmae_tpu_torch.utils.nms_phases``
     in a process of its own on the served candidates (late in this
     script this process's profiler loses device records: PERF.md
     section 7); with ``--nms-parent``
     it also builds and runs the given iou_nms.cu on every set (parent,
     this, this, parent) and fails unless the bits are the same.
     16b. t_mae.yaml served with ``centerpoint_predict(nms_on_device=
     True)``: counters set to 0, one pass (phase 4's launches plus one
     NMS_MASK and one NMS_SCAN); the kept set equal to native host NMS on
     the same candidates; ms a pair with device and with host NMS in turns
     (with ``--nms-parent``, also with the parent's NMS kernels), the NMS
     kernels' device ms on the pair's candidates (the fresh process's).
     16c. a t_mae.yaml variant with the IoU head and multi_class_nms
     (IoU-rectified scores): one finetune step at phase 6's batch (phase
     6's launches plus one IOU_ALIGNED, iou_loss_head_0 finite), then one
     served pair whose device and host multi-class NMS keep the same set.
     16d. one t_mae.yaml finetune step each with ASYMMETRIC {ENABLED} and
     {ENABLED, SimSiam}: launches against phase 6's (EXPECTED_ASYM,
     EXPECTED_SIMSIAM), every loss part finite.
     16e. phase 13's checkpoint through ``tools.test``, ``tools.eval_asym``
     (the same detections) and ``tools.test --fuse_conv_bn`` (the same
     kept boxes but for overlapping pairs that NMS decided the other way
     and boxes within 0.01 of the other run's lowest kept score, counted;
     the folded head maps on one batch within (0.1, 5e-3) of the
     unfused).
Prints the kernels line, the card line and, last, the result line; the
log lines also go to chiprun_out/chip_smoke/log.txt.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / 'chiprun_out' / 'chip_smoke'
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # dense bf16 tensor cores
F32_FLOPS = 67e12              # f32 outside the tensor cores
# One served t_mae.yaml pair: 18 encoder layers, each one gather (two in
# cross mode), K4 on the small and mid buckets, K3 on the full bucket and
# one scatter, after one pack of the layer's weight panels (PACK: not a TPU
# kernel's port, the panels K3, K4 and K12 read); the VFE runs K5 once per
# frame.
EXPECTED_LAUNCHES = {'K1': 24, 'K2': 18, 'K3': 18, 'K4': 36, 'K5': 2,
                     'K6': 0, 'K7': 0, 'K8': 0, 'K9': 0, 'K10': 0, 'K12': 0,
                     'K13b': 0, 'K13c': 0, 'K15': 0, 'K16': 0, 'PACK': 18,
                     'IOU_PAIRS': 0, 'IOU_ALIGNED': 0, 'NMS_MASK': 0,
                     'NMS_SCAN': 0}
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
    'K5': 2 + 2, 'K6': 18 + 12, 'K7': 18, 'K8': 36 + 24, 'K9': 36,
    'K10': 0, 'K12': 0, 'K13b': 0, 'K13c': 0, 'K15': 0, 'K16': 0,
    'PACK': 0, 'IOU_PAIRS': 0, 'IOU_ALIGNED': 0, 'NMS_MASK': 0, 'NMS_SCAN': 0}
NO_LAUNCHES = dict.fromkeys(EXPECTED_LAUNCHES, 0)
# The fused in-place serving path: each of the 18 layers is one pack of its
# panels and one K12 call per bucket (small, mid, full), and nothing else
# of the encoder.
EXPECTED_FUSED = {**NO_LAUNCHES, 'K5': 2, 'K12': 18 * 3, 'PACK': 18}
# A streaming pass skips the previous frame's VFE (one K5) and SST stages;
# the encoder's launches are those of its path, on a batch of one frame.
EXPECTED_STREAM = {**EXPECTED_LAUNCHES, 'K5': 1}
EXPECTED_STREAM_FUSED = {**EXPECTED_FUSED, 'K5': 1}
# One pretraining step of t_mae_ssl_waymo.yaml (no caps): each of the 18
# encoder layers is one K10 forward and one K7 backward, and remat replays
# the 12 SST layers' forward.
EXPECTED_PRETRAIN_GRID = {**NO_LAUNCHES, 'K10': 18 + 12, 'K7': 18}
# t_mae_ssl.yaml runs the finetune step's encoder; without host
# voxelization the VFE takes the scatter path instead of K5.
EXPECTED_PRETRAIN_BUCKETED = {**EXPECTED_TRAIN_LAUNCHES, 'K5': 0}
EXPECTED_WAYMO_SERVING = {**NO_LAUNCHES, 'K10': 18}
# One finetune step of t_mae_waymo.yaml (no caps, no host voxelization):
# the pretraining step's encoder, K10 for each of the 18 layers and for the
# 12 SST layers remat replays, K7 for each layer's backward; the VFE takes
# the scatter path (no K5).
EXPECTED_FINETUNE_GRID = {**NO_LAUNCHES, 'K10': 18 + 12, 'K7': 18}
# Phase 5c's path. Window API, per plan (2): one gather (K1) and its VJP, a
# zero-fill scatter (K2 as K13b); one zero-fill scatter (K13b) and its VJP,
# a gather; one scatter-into (K13c, its own kernel) and its VJP, a gather
# and a scatter-into. SubMConvBlock(plan) on the 6 conv_out inputs: K15 and
# a zero-fill scatter forward, the plan's cell mask (a zero-fill scatter)
# backward. DenseWindowAttention: one K16 per call (4), which packs its
# four weight panels itself.
# One t_mae.yaml finetune step with ASYMMETRIC.ENABLED: the 12 SST layers
# run twice (each frame's pass on the batch of one frame), forward, remat
# replay and backward; the 6 WCA layers and the VFE as in phase 6.
EXPECTED_ASYM = {**EXPECTED_TRAIN_LAUNCHES, 'K1': 36 + 30 + 24,
                 'K2': 30 + 36 + 30 + 24, 'K6': 30 + 24, 'K7': 30,
                 'K8': 60 + 48, 'K9': 60}
# With SimSiam the previous frame's pyramid is detached: its 12 SST layers
# and its VFE run forward only (no backward, no remat replay), and the WCA
# layers' gather of the previous frame's windows needs no VJP (K2 18, not
# 24, for the gathers' VJPs).
EXPECTED_SIMSIAM = {**EXPECTED_TRAIN_LAUNCHES, 'K1': 36 + 18 + 12,
                    'K2': 30 + 18 + 18 + 12, 'K5': 2 + 1, 'K6': 30 + 12,
                    'K8': 60 + 24}
EXPECTED_SPARSE_ATTN = {**NO_LAUNCHES, 'K1': 2 * 3, 'K2': 2 * 2 + 6 * 2,
                        'K13b': 2 * 2 + 6 * 2, 'K13c': 2 * 2, 'K15': 6,
                        'K16': 4}
REPS = 20                      # timed serving passes
ONCE_EVAL_SAMPLES = 4          # frame pairs of phase 13 (the config has 32)
ONCE_TREE_FRAMES = 12          # phase 14a's sweeps: 4 intervals of 3 frames
CLI_BATCH = 2                  # phase 14a's batch (t_mae.yaml 6, _ssl 8)
WAYMO_SEQ_FRAMES = 8           # phase 15's frames: 4 pairs at SCAN_WINDOW 2
TRAIN_STEPS = 6                # step 0 counted, steps 1-5 timed
TRAIN_PAIRS = (0, 1)           # synthetic scenes of the training batch
SSL_STEPS = 3                  # t_mae_ssl.yaml pretraining steps
WAYMO_REPS = 5                 # timed t_mae_waymo.yaml serving passes
BWD_DRAWS = 16                 # random cotangents per backward check
# the kernels of K7 / K9 (csrc/encoder_layer_bwd.cu) in a profiler table
BWD_KERNELS = ('(anonymous namespace)::window_bwd_kernel',
               '(anonymous namespace)::wgrad_kernel',
               '(anonymous namespace)::reduce_kernel')
# the launches of K3 / K4 / K6 / K8 / K10 / K12 / K16
# (csrc/encoder_layer_tiled.cu) in a profiler table
TILED_SRC = 'tmae_tpu_torch/csrc/encoder_layer_tiled.cu'
FWD_KERNELS = ('(anonymous namespace)::tiled_kernel',
               '(anonymous namespace)::sel_prepass_kernel',
               '(anonymous namespace)::grid_prepass_kernel',
               '(anonymous namespace)::mask_prepass_kernel',
               '(anonymous namespace)::plan_prepass_kernel',
               '(anonymous namespace)::attn_prepass_kernel',
               '(anonymous namespace)::compact_kernel',
               '(anonymous namespace)::pack_kernel')


def log(*a):
    """Print a line, and append it to the output directory's log.txt once
    the run has made that directory, so that the whole log survives where
    only the end of the standard output is kept."""
    print(*a, flush=True)
    if OUT_DIR.is_dir():
        with open(OUT_DIR / 'log.txt', 'a') as f:
            print(*a, file=f)


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
            flops, library_ms, peak=BF16_FLOPS, **extra):
    """One kernel's entry of the kernels line (its launches are filled in
    after the run of the path that launches it); ``extra`` keys are added
    as they are."""
    b, by = bound_ms(nbytes, flops, peak)
    rows.append({'name': name, 'route': 'cuda', 'source': source,
                 'replaces': replaces, 'kernel': kernel,
                 'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                 'bound_ms': b, 'bound_by': by, 'library_ms': library_ms,
                 **extra})
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
    # line), a stage-1 cross (WCA) layer and a stage-2 (C=256) self layer,
    # each with the layer's weights prepared once (TiledWeights)
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
            rows_check(torch, el, label, case, base, kv is not None, entry)

    # K12: every bucket of the same three layers, straight in the carrier;
    # the dummy window row holds random values, which must stay
    xp2 = oc.pad_grid(x2, 8, False).contiguous()
    for label, layer, lplan, carrier, kvp in (
            ('stage-1 self', enc.sst_block_0.encoder_0.EncoderLayer_0, plan,
             xp, None),
            ('stage-1 cross', enc.wca_block_0.block_0.EncoderLayer_0, wplan,
             xp[:1].clone(), xp[1:].clone()),
            ('stage-2 self', enc.sst_block_1.encoder_0.EncoderLayer_0, plan2,
             xp2, None)):
        carrier = carrier.clone()
        carrier[:, -8:] = torch.randn(carrier[:, -8:].shape, generator=g,
                                      device=dev).to(torch.bfloat16)
        for name, ci in (('small', lplan.small), ('mid', lplan.mid),
                         ('full', lplan.full)):
            fused_check(torch, el, oc, f'{label} {name}', layer, ci,
                        carrier, kvp, name != 'full', entry)

    # the panels a served layer packs once per forward (PACK, from the f32
    # master weights) against their plain version bit for bit: the six
    # matrices rounded to bf16 to nearest even, in the tiled kernel's layout
    for layer in (enc.sst_block_0.encoder_0.EncoderLayer_0,
                  enc.sst_block_1.encoder_0.EncoderLayer_0):
        tw = layer.tiled_weights()
        want = el.pack_panels_plain(el.LayerParams(*layer.layer_weights()))
        if not torch.equal(tw.panels, want):
            raise AssertionError(f'PACK C={tw.width} differs from its plain '
                                 'version')
        log(f'  PACK C={tw.width}: {want.numel()} bf16 values equal to the '
            'plain panels bit for bit; '
            f'{time_ms(torch, layer.tiled_weights):.4f} ms to prepare a '
            'layer\'s weights')

    # K5 on the current frame's host voxelization
    V = model.vfe.encoder.spec.max_voxels
    Pn = batch['points'].shape[1]
    feat = torch.randn(1, Pn, 128, generator=g, device=dev)
    seg, ends, vmask = batch['pv_cur'], batch['vends_cur'], batch['vmask_cur']
    got = ss.sorted_segment_max(feat, seg, ends, vmask, V)
    want = ss.sorted_segment_max_plain(feat, seg, ends, vmask, V)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if err != 0 or not same_bits(torch, got, want):
        raise AssertionError(f'K5 differs from its plain version: {err}')
    # the VFE hands K5 its slots as int64
    if not same_bits(torch, ss.sorted_segment_max(feat, seg.long(), ends,
                                                  vmask, V), got):
        raise AssertionError('K5 on int64 slots differs from int32')
    segmax_skewed_check(torch, ss, g, Pn, V)
    seg_lib = seg.long().clamp(max=V)[0][:, None].expand(Pn, 128)
    out_lib = torch.zeros(V + 1, 128, device=dev)
    lib = lambda: out_lib.zero_().scatter_reduce_(0, seg_lib, feat[0], 'amax',
                                                  include_self=False)
    lib()
    if not torch.equal(torch.where(vmask[0, :, None], out_lib[:V], 0.0),
                       want[0]):
        raise AssertionError('K5 library yardstick computes another function')
    n_pts = int(batch['pvalid_cur'].sum())
    call = lambda: ss.sorted_segment_max(feat, seg, ends, vmask, V)
    entry('sorted_segment_max', 'K5', 'tmae_tpu_torch/csrc/segment_max.cu',
          'tmae_tpu/ops/sorted_segments.py:87', err, time_ms(torch, call),
          time_ms(torch, lambda: ss.sorted_segment_max_plain(
              feat, seg, ends, vmask, V), iters=5),
          n_pts * 128 * 4 + V * 128 * 4 + V * 4 + V, n_pts * 128,
          time_ms(torch, lib), peak=F32_FLOPS,
          **launch_times(torch, 'K5', call))
    return rows


def launch_times(torch, name, call):
    """One call's device ms by launch (profiler, CUDA activity only, the
    mean of 5 calls) and its host ms to enqueue (the median of 7 rounds of
    20 calls), logged; returned as the ``device_ms`` (the launches summed),
    ``by_launch`` and ``host_ms`` of its kernels-line row."""
    from tmae_tpu_torch.utils.fwd_phases import by_launch, host_ms

    stats = {}
    launches = by_launch(torch, call, calls=5, stats=stats)
    dev = sum(ms for _, ms in launches) or None
    host = host_ms(torch, call)
    log(f'  {name}: {dev} ms of device time a call (' + ', '.join(
        f'{k} {v:.4f}' for k, v in launches) + f'); {host:.4f} ms of host '
        f'time to enqueue it; {stats.get("empty", 0)} profiler sessions saw '
        'no device activity and were run again')
    return dict(device_ms=dev, host_ms=host,
                by_launch={k: v for k, v in launches})


def segmax_skewed_check(torch, ss, g, Pn, V, C=128):
    """K5 on a skewed synthetic case at the main path's sizes (B = 2, Pn
    rows, V slots, C = 128), bit for bit against its plain version and
    twice for the same bits: batch row 0 holds a 551-row pillar over nine
    slices, pillars that end exactly on a slice edge and geometric sizes
    (median 3); every value of batch row 1 is negative; absent slots follow
    the present ones and out-of-range rows (slot V) the last pillar."""
    R = ss.SLICE_ROWS
    dev = g.device
    segs, ends, masks = [], [], []
    for b in range(2):
        u = torch.rand(V // 2, generator=torch.Generator().manual_seed(7 + b))
        sizes = (torch.log(u) / math.log(0.75)).long().clamp(max=300) + 1
        sizes[:6] = torch.tensor([551, 41, R, 2 * R, 1, 3 * R - 1])
        sizes = sizes[sizes.cumsum(0) <= Pn - 1000 - b * 7000]
        n = len(sizes)
        seg = torch.full((Pn,), V, dtype=torch.int32)
        seg[:int(sizes.sum())] = torch.repeat_interleave(
            torch.arange(n, dtype=torch.int32), sizes)
        end = torch.zeros(V, dtype=torch.int32)
        end[:n] = (sizes.cumsum(0) - 1).int()
        mask = torch.zeros(V, dtype=torch.bool)
        mask[:n] = True
        segs.append(seg), ends.append(end), masks.append(mask)
    seg, end, mask = (torch.stack(a).to(dev) for a in (segs, ends, masks))
    feat = torch.randn(2, Pn, C, generator=g, device=dev)
    feat[1] = -feat[1].abs() - 0.5
    first = torch.cat([torch.zeros_like(end[:, :1]), end[:, :-1] + 1], 1)
    spans = (end // R - first // R)[mask]
    on_edge = ((end + 1) % R == 0)[mask]
    if spans.max() < 2 or not on_edge.any():
        raise AssertionError('the skewed K5 case lost its premises')
    got = ss.sorted_segment_max(feat, seg, end, mask, V)
    want = ss.sorted_segment_max_plain(feat, seg, end, mask, V)
    again = ss.sorted_segment_max(feat, seg, end, mask, V)
    torch.cuda.synchronize()
    if not same_bits(torch, got, want):
        err = (got - want).abs().max().item()
        raise AssertionError(f'K5 skewed case differs from its plain '
                             f'version: {err}')
    if not same_bits(torch, again, got):
        raise AssertionError('K5 skewed case: two runs differ')
    if not (got[1][mask[1]] < 0).all():
        raise AssertionError('K5 skewed case: a negative pillar read 0')
    log(f'  K5 skewed case: B=2, {int(mask.sum())} pillars '
        f'({int((spans > 0).sum())} over two slices or more, the longest '
        f'over {int(spans.max()) + 1}; {int(on_edge.sum())} ending on a '
        f'slice edge), {int((seg == V).sum())} out-of-range rows, '
        f'{int((~mask).sum())} absent slots: equal to the plain version bit '
        'for bit, the same bits twice')


def layer_cases(el, layer, plan, kv_all):
    """(kernel, tokens, valid windows, plain weights, kernel fn, plain fn,
    call) for each bucket of one serving layer, each fn updating its
    argument in place: the kernel fn takes the layer's weights prepared once
    for all its buckets (``TiledWeights``, as a served forward prepares
    them) unless it is given others; the plain fn ``kernel_params`` of
    them. ``call`` is (the kernel's arguments after the window tensor, the
    prepared weights last, row_lo, keywords)."""
    tw = layer.tiled_weights()
    p = el.kernel_params(layer.layer_weights())
    cross = kv_all is not None
    kw = dict(nhead=layer.nhead, tau_min=layer.tau_min, cross=cross)
    cases, lo = [], 0
    for si in (plan.small, plan.mid):
        ksel, km = (si.ksel, si.kmask) if cross else (si.sel, si.qmask)
        args = (kv_all, si.sel, ksel, si.qmask, km, layer.pos)
        cases.append(('K4', si.sel.shape[-1], si.valid, p,
                      lambda t, w=tw, a=args, lo=lo:
                          el.encoder_layer_rows_sel(t, *a, w, row_lo=lo,
                                                    **kw),
                      lambda t, a=args, lo=lo: el.reference_encoder_layer_rows(
                          t, *a, p, row_lo=lo, **kw),
                      (args + (tw,), lo, kw)))
        lo += si.idx.shape[1]
    fu = plan.full
    km = fu.kmask if cross else fu.qmask
    args = (kv_all, fu.qmask, km, layer.pos)
    cases.append(('K3', 64, fu.valid, p,
                  lambda t, w=tw, lo=lo: el.encoder_layer_rows_full(
                      t, *args, w, row_lo=lo, **kw),
                  lambda t, lo=lo: el.reference_encoder_layer_rows(
                      t, kv_all, None, None, fu.qmask, km, layer.pos, p,
                      row_lo=lo, **kw), (args + (tw,), lo, kw)))
    return cases


def rows_check(torch, el, label, case, base, cross, entry):
    """One K3/K4 bucket call: kernel against plain version (bf16 output,
    max |diff| <= 0.15 and mean <= 2e-3: summation order can flip a bf16
    rounding of an intermediate), the exact checks (:func:`rows_bits_check`
    for K4, :func:`full_rows_bits_check` for K3), its time with the layer's
    prepared weights and with weights prepared in the call (a pack launch
    more), and its bound. Stage-1 self small (S=16) and full buckets go into
    the kernels line."""
    kernel, T, valid, p, fk, fp, call = case
    ka, pa = fk(base.clone()), fp(base.clone())
    torch.cuda.synchronize()
    d = (ka.float() - pa.float()).abs()
    err, mean = d.max().item(), d.mean().item()
    if not (err <= 0.15 and mean <= 2e-3):
        raise AssertionError(f'{kernel} {label} T={T} differs from its plain '
                             f'version: max {err} mean {mean}')
    if kernel == 'K4':
        rows_bits_check(torch, el, call, fk, base, ka, f'{label} S={T}')
    else:
        full_rows_bits_check(torch, call, fk, base, ka, label)
    C = base.shape[-1]
    nw = int(valid.sum())
    out_tokens = 64 if kernel == 'K3' else T
    nbytes = (nw * ((2 if cross else 1) * T + out_tokens) * C * 2
              + sum(t.numel() * t.element_size() for t in p))
    flops = nw * layer_flops(T, C, p.f1w.shape[0])
    kt = base.clone()
    ms = time_ms(torch, lambda: fk(kt), iters=10)
    ms_unprep = time_ms(torch, lambda: fk(kt, p), iters=10)
    b, by = bound_ms(nbytes, flops)
    log(f'  {kernel} {label} T={T}: {nw} of {valid.numel()} windows, '
        f'max_abs_err {err:.3g} (mean {mean:.2g}), kernel {ms:.4f} ms '
        f'({ms_unprep:.4f} ms with its weights prepared in the call), bound '
        f'{b:.4f} ms ({by})')
    if label == 'stage-1 self' and T in (16, 64):
        full = kernel == 'K3'
        pt = pa.clone()
        dev_ms = device_ms(torch, lambda: fk(kt))
        log(f'  {kernel} {label} T={T}: {dev_ms} ms of device time a call, '
            'its launches summed (profiler)')
        entry('encoder_rows_full' if full else 'encoder_rows_sel', kernel,
              TILED_SRC,
              'tmae_tpu/ops/pallas_encoder.py:' + ('1680' if full else '1724'),
              err, ms, time_ms(torch, lambda: fp(pt), iters=3, warmup=1),
              nbytes, flops, None, ms_unprepared=ms_unprep,
              device_ms=dev_ms)


def rows_bits_check(torch, el, call, fk, base, out, label):
    """K4's exact checks on one bucket call ``fk`` (in place on a copy of
    ``base``) whose output is ``out``: the rows outside [row_lo, row_lo +
    cap), the windows without an occupied query cell and every cell that is
    not an occupied selected one keep their bits; a second run gives the
    same bits; nothing leaks between the windows of a tile (the first live
    window's tokens negated: every other row keeps its bits, its written
    cells change); and the first windows of sample 0 (a prefix of the
    call's windows w = b cap + j) up to a live count that leaves a partial
    last tile give the bits of the whole call."""
    (kv_all, sq, sk, qm, km, pos, p), lo, kw = call
    B, cap, S = qm.shape
    live = (qm > 0).any(-1)
    written = torch.zeros(B, cap, 64, device=qm.device).scatter_add_(
        -1, sq.long(), (qm > 0).float()) > 0
    kept = torch.ones(base.shape[:3], dtype=torch.bool, device=qm.device)
    kept[:, lo:lo + cap] = ~written
    if not torch.equal(out[kept], base[kept]):
        raise AssertionError(f'K4 {label}: a cell it does not write changed')
    if not torch.equal(fk(base.clone()), out):
        raise AssertionError(f'K4 {label}: two runs differ')
    if not live[0].any():
        raise AssertionError(f'K4 {label}: no live window in sample 0 to '
                             'check the tiles with')
    b0, j0 = (int(v) for v in live.nonzero()[0])
    x2 = base.clone()
    x2[b0, lo + j0] = -x2[b0, lo + j0]
    moved = fk(x2)
    rest = torch.ones(base.shape[:2], dtype=torch.bool, device=qm.device)
    rest[b0, lo + j0] = False
    if not torch.equal(moved[rest], out[rest]):
        raise AssertionError(f'K4 {label}: changing window ({b0}, {j0}) '
                             'moved another window\'s row')
    cells = written[b0, j0]
    if torch.equal(moved[b0, lo + j0][cells], out[b0, lo + j0][cells]):
        raise AssertionError(f'K4 {label}: window ({b0}, {j0}) did not '
                             'change')
    per = 4 if S == 16 else 1
    n = prefix_slots(torch, live[0], cap)
    cut = lambda a: None if a is None else a[:1, :n]
    part = el.encoder_layer_rows_sel(
        base[:1].clone(), None if kv_all is None else kv_all[:1], cut(sq),
        cut(sk), cut(qm), cut(km), pos, p, row_lo=lo, **kw)
    if not (torch.equal(part[:, lo:lo + n], out[:1, lo:lo + n])
            and torch.equal(part[:, :lo], base[:1, :lo])
            and torch.equal(part[:, lo + n:], base[:1, lo + n:])):
        raise AssertionError(f'K4 {label}: the first {n} windows of sample 0 '
                             'differ from the whole call')
    n_live = int(live[0, :n].sum())
    log(f'  K4 {label}: {int((~live).sum())} windows without a query and '
        f'{int(kept.sum())} cells it does not write keep their bits; the '
        f'same bits twice; window ({b0}, {j0}) changed, the other '
        f'{int(rest.sum())} rows kept their bits; the first {n} windows of '
        f'sample 0 ({n_live} live, {n_live // per} full tiles of {per} and '
        f'{n_live % per} in the last) give the bits of the whole call')


def prefix_slots(torch, live, cap):
    """The length of a prefix of one sample's slots (``live`` [cap] bool)
    that leaves a partial last tile of four live windows (S = 16), the
    first such prefix with more than one full tile where there is one; the
    whole sample where no prefix does."""
    counts = live.int().cumsum(0)
    ends = torch.cat([((counts % 4 == 2) & (counts > 4)).nonzero(),
                      (counts % 4 != 0).nonzero()])
    return int(ends[0, 0]) + 1 if len(ends) else cap


def full_rows_bits_check(torch, call, fk, base, out, label):
    """K3's exact checks on one bucket call ``fk`` (in place on a copy of
    ``base``) whose output is ``out``: the rows outside [row_lo, row_lo +
    cap) keep their bits; every cell of a window without an occupied query
    cell, and every unoccupied cell of the others, is exactly 0 (the
    pre-pass writes the zeros of the first; the layer never runs on them); a
    second run gives the same bits; the first live window's tokens negated:
    every other row keeps its bits, its own changes."""
    (kv_all, qm, km, pos, tw), lo, kw = call
    cap = qm.shape[1]
    live = (qm > 0).any(-1)
    rows = torch.zeros(base.shape[:2], dtype=torch.bool, device=qm.device)
    rows[:, lo:lo + cap] = True
    if not torch.equal(out[~rows], base[~rows]):
        raise AssertionError(f'K3 {label}: a row outside its range changed')
    mine = out[:, lo:lo + cap]
    if (mine[~live] != 0).any() or (mine[qm == 0] != 0).any():
        raise AssertionError(f'K3 {label}: a window or cell without a query '
                             'is not 0')
    if not torch.equal(fk(base.clone()), out):
        raise AssertionError(f'K3 {label}: two runs differ')
    msg = (f'  K3 {label}: the {int((~rows).sum())} rows outside its range '
           f'keep their bits; {int((~live).sum())} windows without a query '
           f'and the {int((qm[live] == 0).sum())} unoccupied cells of the '
           'others exactly 0; the same bits twice')
    if not live.any():
        log(msg + '; no live window')
        return
    b0, j0 = (int(v) for v in live.nonzero()[0])
    x2 = base.clone()
    x2[b0, lo + j0] = -x2[b0, lo + j0]
    moved = fk(x2)
    rest = torch.ones(base.shape[:2], dtype=torch.bool, device=qm.device)
    rest[b0, lo + j0] = False
    if not torch.equal(moved[rest], out[rest]):
        raise AssertionError(f'K3 {label}: changing window ({b0}, {j0}) '
                             'moved another window\'s row')
    if torch.equal(moved[b0, lo + j0], out[b0, lo + j0]):
        raise AssertionError(f'K3 {label}: window ({b0}, {j0}) did not '
                             'change')
    log(msg + f'; window ({b0}, {j0}) changed, the other {int(rest.sum())} '
        'rows kept their bits')


def fused_check(torch, el, oc, label, layer, ci, xp, kvp, sel, entry):
    """K12 on one bucket plan ``ci`` of the padded carrier ``xp`` (``kvp``
    the other frame's carrier in cross mode) against its plain version on
    the same card: on the cells of the plan's windows bf16 outputs within
    K3/K4's limits (max |diff| <= 0.15, mean <= 2e-3); every other cell of
    the carrier, the dummy window row with it, exactly as it was; the exact
    checks of :func:`plan_bits_check`. Its time with the layer's prepared
    weights and with weights prepared in the call, the plain version's and
    its bound (the plan's windows read and written, kv read in cross mode,
    the weights); the stage-1 self full bucket goes into the kernels line,
    as K12 and as K11, which K12 closes."""
    tw = layer.tiled_weights()
    p = el.kernel_params(layer.layer_weights())
    cross = kvp is not None
    kw = dict(nhead=layer.nhead, tau_min=layer.tau_min, cross=cross,
              window=8, sel=sel)
    fk = lambda t, w=tw, c=ci, kv=kvp: el.encoder_layer_fused_pipelined(
        t, kv, c, layer.pos, w, **kw)
    fp = lambda t: el.reference_encoder_layer_fused(t, kvp, ci, layer.pos, p,
                                                    **kw)
    ka, pa = fk(xp.clone()), fp(xp.clone())
    torch.cuda.synchronize()
    B, _, _, C = xp.shape
    cap = ci.idx.shape[1]
    ones = torch.ones(B, cap, 64, 1, dtype=torch.bfloat16, device=xp.device)
    inside = oc.scatter_windows_into_padded_plain(
        ones, ci.idx, torch.zeros_like(xp[..., :1]), 8)[..., 0] > 0
    d = (ka.float() - pa.float()).abs()[inside]
    err, mean = (d.max().item(), d.mean().item()) if d.numel() else (0., 0.)
    T = ci.sel.shape[-1] if sel else 64
    if not (err <= 0.15 and mean <= 2e-3):
        raise AssertionError(f'K12 {label} T={T} differs from its plain '
                             f'version: max {err} mean {mean}')
    if not (torch.equal(ka[~inside], xp[~inside])
            and torch.equal(pa[~inside], xp[~inside])):
        raise AssertionError(f'K12 {label}: a cell outside the plan\'s '
                             'windows changed')
    plan_bits_check(torch, el, ci, fk, xp, kvp, ka, f'{label} T={T}', T)
    nw = int(ci.valid.sum())
    nbytes = (nw * ((3 if cross else 2) * T) * C * 2
              + sum(t.numel() * t.element_size() for t in p))
    flops = nw * layer_flops(T, C, p.f1w.shape[0])
    kt = xp.clone()
    ms = time_ms(torch, lambda: fk(kt), iters=10)
    ms_unprep = time_ms(torch, lambda: fk(kt, p), iters=10)
    pt = xp.clone()
    plain_ms = time_ms(torch, lambda: fp(pt), iters=3, warmup=1)
    b, by = bound_ms(nbytes, flops)
    log(f'  K12 {label} T={T}: {nw} of {ci.valid.numel()} windows, '
        f'max_abs_err {err:.3g} (mean {mean:.2g}), {int(inside.sum())} cells '
        f'inside, the other {int((~inside).sum())} unchanged; kernel '
        f'{ms:.4f} ms ({ms_unprep:.4f} ms with its weights prepared in the '
        f'call), plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by})')
    if label == 'stage-1 self full':
        site = 'tmae_tpu/ops/pallas_encoder.py:'
        dev_ms = device_ms(torch, lambda: fk(kt))
        log(f'  K12 {label}: {dev_ms} ms of device time a call, its '
            'launches summed (profiler)')
        entry('encoder_fused_pipelined', 'K12', TILED_SRC, site + '2121', err,
              ms, plain_ms, nbytes, flops, None, ms_unprepared=ms_unprep,
              device_ms=dev_ms)
        entry('encoder_fused_inplace', 'K12', TILED_SRC, site + '1933', err,
              ms, plain_ms, nbytes, flops, None, closed_by='K12',
              ms_unprepared=ms_unprep, device_ms=dev_ms)


def plan_bits_check(torch, el, ci, fk, xp, kvp, out, label, T):
    """K12's exact checks on one bucket call ``fk`` (in place on a copy of
    the carrier ``xp``) whose output is ``out`` (the caller checks that the
    cells outside the plan's real windows, the dummy row with them, keep
    their bits): at T = 64 every unoccupied cell of a real window is exactly
    0, at S = 16, 48 every cell of a real window that is not an occupied
    selected one keeps its bits; a second run gives the same bits; the last
    live slot made non-live (its query mask zeroed, as no plan of the path
    holds one) gets zeros on its 64 cells at T = 64 and keeps its bits at
    S = 16, 48, while every other cell keeps the whole call's bits; the
    first live window's tokens negated move no cell outside it and change
    its written cells (no leak between the windows of a tile); the first
    slots of sample 0 up to a live count that leaves a partial last tile
    give the whole call's bits on their windows and leave every other cell
    as it was."""
    B, Hp2, Wp, C = xp.shape
    cap = ci.idx.shape[1]
    dev = xp.device
    flat = lambda a: a.reshape(-1, C)
    real = el.plan_real_plain(ci.idx, Hp2, Wp)
    occ = (ci.qmask > 0) & real[..., None]
    live = occ.any(-1)
    every = torch.arange(64, device=dev).expand(B, cap, 64)
    cells = el.plan_cells_plain(ci.idx, every, Hp2, Wp)
    toks = el.plan_cells_plain(ci.idx, every if T == 64 else ci.sel, Hp2, Wp)
    n_cells = B * Hp2 * Wp
    written = torch.zeros(n_cells, dtype=torch.bool, device=dev)
    written[toks[occ]] = True
    inside = torch.zeros(n_cells, dtype=torch.bool, device=dev)
    inside[cells[real].reshape(-1)] = True
    rest = inside & ~written
    if T == 64 and (flat(out)[rest] != 0).any():
        raise AssertionError(f'K12 {label}: an unoccupied cell of a real '
                             'window is not 0')
    if T != 64 and not torch.equal(flat(out)[rest], flat(xp)[rest]):
        raise AssertionError(f'K12 {label}: a cell it does not write changed')
    if not torch.equal(fk(xp.clone()), out):
        raise AssertionError(f'K12 {label}: two runs differ')
    msg = (f'  K12 {label}: {int(rest.sum())} cells of real windows it does '
           f'not write {"exactly 0" if T == 64 else "keep their bits"}; the '
           'same bits twice; the dummy row and the cells outside the plan\'s '
           f'{int(real.sum())} real windows keep their bits')
    if not live.any():
        log(msg + '; no live slot')
        return
    lv = live.nonzero()
    b1, j1 = (int(v) for v in lv[-1])
    qm2 = ci.qmask.clone()
    qm2[b1, j1] = 0
    dead = fk(xp.clone(), c=type(ci)(**{**vars(ci), 'qmask': qm2}))
    win1 = cells[b1, j1]
    other = torch.ones(n_cells, dtype=torch.bool, device=dev)
    other[win1] = False
    kept = (not flat(dead)[win1].any() if T == 64
            else torch.equal(flat(dead)[win1], flat(xp)[win1]))
    if not (kept and torch.equal(flat(dead)[other], flat(out)[other])):
        raise AssertionError(f'K12 {label}: slot ({b1}, {j1}) made non-live '
                             'is not its pre-pass output, or moved another '
                             'cell')
    b0, j0 = (int(v) for v in lv[0])
    win0 = cells[b0, j0]
    x2 = xp.clone()
    flat(x2)[win0] = -flat(x2)[win0]
    moved = fk(x2)
    other = torch.ones(n_cells, dtype=torch.bool, device=dev)
    other[win0] = False
    if not torch.equal(flat(moved)[other], flat(out)[other]):
        raise AssertionError(f'K12 {label}: changing window ({b0}, {j0}) '
                             'moved a cell outside it')
    w0 = toks[b0, j0][occ[b0, j0]]
    if torch.equal(flat(moved)[w0], flat(out)[w0]):
        raise AssertionError(f'K12 {label}: window ({b0}, {j0}) did not '
                             'change')
    # a prefix of the slots of sample b0 (the first with a live slot),
    # called alone on that frame
    n = prefix_slots(torch, live[b0], cap)
    one = slice(b0, b0 + 1)
    cut = lambda a: a if a is None else (a[one, :n] if a.dim() > 1
                                         else a[one])
    part = fk(xp[one].clone(), c=type(ci)(**{k: cut(v)
                                               for k, v in vars(ci).items()}),
              kv=None if kvp is None else kvp[one])
    mine = torch.zeros(n_cells, dtype=torch.bool, device=dev)
    mine[cells[b0, :n][real[b0, :n]].reshape(-1)] = True
    mine = mine.reshape(B, -1)[b0]
    if not (torch.equal(flat(part)[mine], flat(out[one])[mine])
            and torch.equal(flat(part)[~mine], flat(xp[one])[~mine])):
        raise AssertionError(f'K12 {label}: the first {n} slots of sample '
                             f'{b0} differ from the whole call')
    per = 4 if T == 16 else 1
    n_live = int(live[b0, :n].sum())
    log(msg + f'; slot ({b1}, {j1}) made non-live '
        f'{"zeros" if T == 64 else "keeps its bits"}, no other cell moves; '
        f'window ({b0}, {j0}) changed and no cell outside it; the first {n} '
        f'slots of sample {b0} ({n_live} live, {n_live // per} full tiles '
        f'of {per} and {n_live % per} in the last) give the bits of the '
        'whole call')


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

    def capture(*args):
        xw, sel_q, (_, _, cross) = args[0], args[2], args[7]
        key = (xw.shape[-1], cross, 64 if sel_q is None else sel_q.shape[-1])
        calls.setdefault(key, args)
        return real.apply(*args)

    bufs = {n: b.clone() for n, b in model.named_buffers()}
    # a namespace, not a class: a class is its own reference cycle and
    # would keep the captured tensors alive until the cyclic collector runs
    el._FusedEncoderLayer = types.SimpleNamespace(apply=capture)
    try:
        with torch.no_grad():
            model.train()(batch)
    finally:
        el._FusedEncoderLayer = real
        with torch.no_grad():
            for n, b in model.named_buffers():
                b.copy_(bufs[n])
    return calls


def train_check(torch, el, call, gen, entry, profile=False):
    """K6 / K8 and K7 / K9 on one bucket against their plain versions on
    the same card. Forward: bf16 output, max |diff| <= 0.15 and mean <=
    2e-3 (as K3/K4). Backward, for each of BWD_DRAWS random cotangents,
    each of dx, dkv, the 17 parameter gradients but tau and (K7) dpos: max
    |diff| <= 5e-2 and mean <= 5e-3 of the output's scale (the kernels
    round the backward's matmul operands to bf16 as the TPU kernel does;
    the plain version is autograd in f32). dtau, one sum over all windows
    and heads, is linear in the cotangent and zero on average over random
    ones, so one draw's error over its value has no bounded spread (see
    :func:`grid_check`): its error is held within 10% of its value in root
    mean square over the draws. Every other draw zeroes the cotangent of a
    random half of the windows (the kernel skips a window whose cotangent
    is 0 on its query cells), and the kernel run twice on draw 0's
    cotangent (nonzero on every window, as the path hands it over; the
    times are taken on it too) must give the same bits. The C=128 self
    (stage-1) small (S=16) and
    full buckets go into the kernels line; with ``profile``, their
    backward's device time by kernel name too."""
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
    if S is None:
        full_bits_check(torch, el, args, p, kw, ka, label)
    else:
        sel_bits_check(torch, el, args, p, kw, ka, f'{label} S={S}')
    dpos = S is None
    names = ['dx', 'dkv'] + list(el.LayerParams._fields) + ['dpos']
    worst, berr, errs, refs, live = (0.0, ''), 0.0, [], [], set()
    qcell = qm > 0
    for i in range(BWD_DRAWS):
        g = torch.randn(x.shape, generator=gen, device=x.device).to(
            torch.bfloat16)
        if i % 2:
            keep = torch.rand(x.shape[0], generator=gen, device=x.device)
            g = g * (keep < 0.5)[:, None, None].to(g.dtype)
        gq = g if S is None else el._take(g, sq)
        live.add(int(((gq != 0).any(-1) & qcell).any(-1).sum()))
        bk = lambda: el.encoder_layer_bwd(*args, weights, g, want_dpos=dpos,
                                          **kw)
        bp = lambda: el.reference_encoder_layer_bwd(*args, weights, g,
                                                    want_dpos=dpos, **kw)
        rk, rp = bk(), bp()
        torch.cuda.synchronize()
        for name, a, b in zip(names, [rk[0], rk[1], *rk[2], rk[3]],
                              [rp[0], rp[1], *rp[2], rp[3]]):
            if (a is None) != (b is None):
                raise AssertionError(f'{kname[1]} {label}: {name} missing')
            if a is None:
                continue
            a, b = a.float(), b.float()
            if not torch.isfinite(a).all():
                raise AssertionError(f'{kname[1]} {label}: {name} not '
                                     'finite')
            if name == 'tau':
                errs.append((a - b).item())
                refs.append(b.item())
                continue
            scale = b.abs().max().item()
            e = (a - b).abs()
            if not (e.max().item() <= 5e-2 * scale
                    and e.mean().item() <= 5e-3 * scale):
                raise AssertionError(
                    f'{kname[1]} {label} T={T}: {name} differs from its '
                    f'plain version: max {e.max().item()} mean '
                    f'{e.mean().item()} scale {scale}')
            worst = max(worst, (e.max().item() / max(scale, 1e-30), name))
        berr = max(berr, (rk[0].float() - rp[0].float()).abs().max().item())
        if i == 0:  # a cotangent on every window, as the path hands it over
            g0, rk0 = g, rk
    rms = lambda v: math.sqrt(sum(t * t for t in v) / len(v))
    dtau = rms(errs) / max(rms(refs), 1e-30)
    if not dtau <= 0.1:
        raise AssertionError(
            f'{kname[1]} {label} T={T}: dtau differs from its plain version '
            f'by {dtau:.3g} in root mean square over {BWD_DRAWS} draws')
    # the same bits again, and the times, on draw 0's full cotangent
    bk = lambda: el.encoder_layer_bwd(*args, weights, g0, want_dpos=dpos,
                                      **kw)
    bp = lambda: el.reference_encoder_layer_bwd(*args, weights, g0,
                                                want_dpos=dpos, **kw)
    again = bk()
    for name, a, b in zip(names, [rk0[0], rk0[1], *rk0[2], rk0[3]],
                          [again[0], again[1], *again[2], again[3]]):
        if a is not None and not torch.equal(a, b):
            raise AssertionError(f'{kname[1]} {label} T={T}: two runs on one '
                                 f'cotangent differ in {name}')
    del again
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
        f'windows with a nonzero cotangent on a query cell: '
        f'{sorted(live)} (half the windows zeroed in every other draw); '
        f'forward max_abs_err {ferr:.3g} (mean {fmean:.2g}), {ms_f:.4f} ms, '
        f'bound {bf:.4f} ms ({byf}); backward over {BWD_DRAWS} cotangents: '
        f'dx max_abs_err {berr:.3g}, worst relative {worst[0]:.3g} '
        f'({worst[1]}), dtau relative error {dtau:.3g} in root mean square '
        '(each draw: ' + ', '.join(f'{e / max(abs(r), 1e-30):.3g}'
                                   for e, r in zip(errs, refs))
        + f'), {ms_b:.4f} ms, bound {bb:.4f} ms ({byb})')
    if label == 'C=128 self' and T in (16, 64):
        full = S is None
        bsrc = 'tmae_tpu_torch/csrc/encoder_layer_bwd.cu'
        site = 'tmae_tpu/ops/pallas_encoder.py:'
        entry('encoder_train_fwd_full' if full else 'encoder_train_fwd_sel',
              kname[0], TILED_SRC, site + ('346' if full else '1038'), ferr,
              ms_f,
              time_ms(torch, fp, iters=3, warmup=1), fwd_bytes, fwd_flops,
              None)
        entry('encoder_train_bwd_full' if full else 'encoder_train_bwd_sel',
              kname[1], bsrc, site + ('752' if full else '1403'), berr, ms_b,
              time_ms(torch, bp, iters=2, warmup=1), bwd_bytes, bwd_flops,
              None)
        if profile:
            pass_breakdown(torch, bk, f'profile_bwd_{kname[1]}.txt')


def full_bits_check(torch, el, args, p, kw, out, label):
    """K6's exact checks on one captured call whose kernel output is
    ``out``: every cell of a window without an occupied query cell, and
    every unoccupied cell of the others, is exactly 0 (the pre-pass writes
    the zeros of the first; the layer never runs on them); a second run
    gives the same bits; the first live window's tokens changed, every other
    window's output keeps its bits and its own changes."""
    x, kvw, sq, sk, qm, km, pos = args
    live = (qm > 0).any(-1)
    if (out[~live] != 0).any() or (out[qm == 0] != 0).any():
        raise AssertionError(f'K6 {label}: a window or cell without a query '
                             'is not 0')
    if not torch.equal(el.encoder_layer_fwd(*args, p, **kw), out):
        raise AssertionError(f'K6 {label}: two runs differ')
    msg = (f'  K6 {label}: {int((~live).sum())} windows without a query and '
           f'the {int((qm[live] == 0).sum())} unoccupied cells of the others '
           'exactly 0; the same bits twice')
    if not live.any():
        log(msg + '; no live window')
        return
    w0 = int(live.nonzero()[0, 0])
    x2 = x.clone()
    x2[w0] = -x2[w0]
    moved = el.encoder_layer_fwd(x2, *args[1:], p, **kw)
    rest = torch.ones_like(live)
    rest[w0] = False
    if not torch.equal(moved[rest], out[rest]):
        raise AssertionError(f'K6 {label}: changing window {w0} moved the '
                             'output of another window')
    if torch.equal(moved[w0], out[w0]):
        raise AssertionError(f'K6 {label}: window {w0} did not change')
    log(msg + f'; window {w0} changed, the other {x.shape[0] - 1} windows '
        'kept their bits')


def sel_bits_check(torch, el, args, p, kw, out, label):
    """K8's exact checks on one captured call whose kernel output is
    ``out``: every slot without an occupied query cell is x to the bit (the
    pre-pass copies it; the layer never runs on it); a second run gives the
    same bits; nothing leaks between the windows of a packed tile (the
    first live window's tokens changed, every other window's output keeps
    its bits); and the first windows up to a live count that leaves a
    partial last tile give the same bits as in the whole call."""
    x, kvw, sq, sk, qm, km, pos = args
    live = (qm > 0).any(-1)
    if not torch.equal(out[~live], x[~live]):
        raise AssertionError(f'K8 {label}: a slot without a query is not x')
    if not torch.equal(el.encoder_layer_fwd(*args, p, **kw), out):
        raise AssertionError(f'K8 {label}: two runs differ')
    w0 = int(live.nonzero()[0, 0])
    x2 = x.clone()
    x2[w0] = -x2[w0]
    moved = el.encoder_layer_fwd(x2, *args[1:], p, **kw)
    rest = torch.ones_like(live)
    rest[w0] = False
    if not torch.equal(moved[rest], out[rest]):
        raise AssertionError(f'K8 {label}: changing window {w0} moved the '
                             'output of another window')
    if torch.equal(moved[w0], out[w0]):
        raise AssertionError(f'K8 {label}: window {w0} did not change')
    per = 4 if sq.shape[-1] == 16 else 1
    counts = live.int().cumsum(0)
    ends = torch.cat([((counts % 4 == 2) & (counts > 4)).nonzero(),
                      (counts % 4 != 0).nonzero()])
    n = int(ends[0, 0]) + 1 if len(ends) else x.shape[0]
    cut = lambda a: None if a is None else a[:n]
    part = el.encoder_layer_fwd(*map(cut, args[:-1]), pos, p, **kw)
    if not torch.equal(part, out[:n]):
        raise AssertionError(f'K8 {label}: the first {n} windows differ from '
                             'the whole call')
    n_live = int(counts[n - 1])
    log(f'  K8 {label}: {int((~live).sum())} slots without a query equal x '
        f'to the bit; the same bits twice; window {w0} changed, the other '
        f'{x.shape[0] - 1} windows kept their bits; the first {n} windows '
        f'({n_live} live, {n_live // per} full tiles of {per} and '
        f'{n_live % per} in the last) give the bits of the whole call')


def grid_bits_check(torch, el, call, out, label):
    """K10's exact checks on one captured call whose kernel output is
    ``out``: every in-grid cell of a window without an occupied query cell
    is exactly 0; a second run gives the same bits; the first live window's
    tokens changed, every cell outside it keeps its bits."""
    xg, kvg, qocc, kocc, pos, cfg, p, *_ = call
    nhead, tau_min, cross, window, shift = cfg
    kw = dict(nhead=nhead, tau_min=tau_min, cross=cross, window=window,
              shift=shift)
    fw = lambda a: el._flat_windows(a, window, shift)
    live = fw(qocc.float()).any(-1)
    on_grid = fw(torch.ones_like(qocc, dtype=torch.float32)) > 0
    ov = fw(out)
    if (ov[~live][on_grid[~live]] != 0).any():
        raise AssertionError(f'K10 {label}: a window without a query is not '
                             'zero')
    if not torch.equal(el.encoder_layer_grid(xg, kvg, qocc, kocc, pos, p,
                                             **kw), out):
        raise AssertionError(f'K10 {label}: two runs differ')
    w0 = int(live.nonzero()[0, 0])
    one = torch.zeros(live.shape[0], window * window, 1, device=xg.device)
    one[w0] = 1.0
    cells = el._unflat_windows(one, xg.shape[0], xg.shape[1:3], window,
                               shift)[..., 0] > 0
    x2 = torch.where(cells[..., None], -xg, xg)
    moved = el.encoder_layer_grid(x2, kvg, qocc, kocc, pos, p, **kw)
    if not torch.equal(moved[~cells], out[~cells]):
        raise AssertionError(f'K10 {label}: changing window {w0} moved the '
                             'output of another window')
    if torch.equal(moved[cells], out[cells]):
        raise AssertionError(f'K10 {label}: window {w0} did not change')
    return (f'; {int((~live).sum())} windows without a query exactly 0, the '
            f'same bits twice, window {w0} changed and no other cell')


# ---------------------------------------------------------------------------
# phases 4-5: the serving path
# ---------------------------------------------------------------------------


def kernels():
    from tmae_tpu_torch.ops import (encoder_layer, geometry, occ_compact,
                                    sorted_segments, sparse_conv,
                                    window_attention)

    return {'K1': occ_compact.K1, 'K2': occ_compact.K2,
            'K3': encoder_layer.K3, 'K4': encoder_layer.K4,
            'K5': sorted_segments.K5, 'K6': encoder_layer.K6,
            'K7': encoder_layer.K7, 'K8': encoder_layer.K8,
            'K9': encoder_layer.K9, 'K10': encoder_layer.K10,
            'K12': encoder_layer.K12, 'K13b': occ_compact.K13B,
            'K13c': occ_compact.K13C, 'K15': sparse_conv.K15,
            'K16': window_attention.K16, 'PACK': encoder_layer.PACK,
            'IOU_PAIRS': geometry.IOU_PAIRS,
            'IOU_ALIGNED': geometry.IOU_ALIGNED,
            'NMS_MASK': geometry.NMS_MASK, 'NMS_SCAN': geometry.NMS_SCAN}


def fill_launches(rows, launches, names):
    """The launch counts of the path that runs kernels ``names`` into their
    rows of the kernels line."""
    for row in rows:
        if row['kernel'] in names:
            row['launches'] = launches[row['kernel']]


def counted(torch, fn):
    """``fn()`` with every launch counter set to 0 just before it; returns
    (its result, the counts read just after it)."""
    ks = kernels()
    for k in ks.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: k.launches for name, k in ks.items()}


def serve_once(torch, cfg, model, batch, **fwd):
    """One serving pass: the forward (``fwd``: its streaming arguments),
    decode and host NMS (native, as serving runs it). Returns (the
    forward's outputs, (boxes, scores, labels, valid before NMS, kept))."""
    from tmae_tpu_torch.models.detectors import centerpoint_predict, host_nms

    with torch.no_grad():
        out = model(batch, **fwd)
        boxes, scores, labels, valid = centerpoint_predict(
            cfg, out, nms_on_device=False)
        keep = host_nms(cfg, boxes, scores, labels, valid)
    return out, (boxes, scores, labels, valid, keep)


def nms_split(cfg, cands, reps=5):
    """Host NMS of one pass's candidates (``cands``: boxes, scores, labels,
    valid as numpy or tensors) by the native path, which serving runs, and
    by the numpy path: (median ms of each over ``reps`` calls, their kept
    masks)."""
    from tmae_tpu_torch.models.detectors import host_nms

    cands = [a.cpu().numpy() if hasattr(a, 'cpu') else a for a in cands]
    ms, kept = {}, {}
    for path, native in (('native', True), ('numpy', False)):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            kept[path] = host_nms(cfg, *cands, native=native)
            times.append((time.perf_counter() - t0) * 1e3)
        ms[path] = statistics.median(times)
    return ms, kept


def split_times(torch, cfg, model, batch, reps):
    """Median host ms of the parts of a serving pass: the forward's
    dispatch (host returns), the forward until the card is done, decode
    (ends in a sync), host NMS (the native path)."""
    from tmae_tpu_torch.models.detectors import centerpoint_predict, host_nms

    parts = {'forward_dispatch': [], 'forward_done': [], 'decode': [],
             'host_nms_native': []}
    with torch.no_grad():
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(batch)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            dec = centerpoint_predict(cfg, out, nms_on_device=False)
            t3 = time.perf_counter()
            host_nms(cfg, *dec)
            t4 = time.perf_counter()
            for k, v in zip(parts, (t1 - t0, t2 - t0, t3 - t2, t4 - t3)):
                parts[k].append(v * 1e3)
    return {k: statistics.median(v) for k, v in parts.items()}


def small_grid(cfg):
    """A config at full width on a 64x64 grid (20.48 m square, the
    config's z range) with caps to match where it has caps, and one
    synthetic frame pair for it (host-voxelized where the config says)."""
    import copy

    from tmae_tpu_torch.datasets.synthetic import frame_pair_batch
    from tmae_tpu_torch.models.detectors import (make_voxel_spec,
                                                 num_point_features)

    small = copy.deepcopy(cfg)
    z0, z1 = cfg.DATA_CONFIG.POINT_CLOUD_RANGE[2::3]
    small.DATA_CONFIG.POINT_CLOUD_RANGE = [-10.24, -10.24, z0, 10.24, 10.24,
                                          z1]
    if 'DENSE_HEAD' in small.MODEL:
        small.MODEL.DENSE_HEAD.POST_PROCESSING.POST_CENTER_LIMIT_RANGE = \
            small.DATA_CONFIG.POINT_CLOUD_RANGE
    small.RUNTIME.MAX_POINTS = 65536
    small.RUNTIME.MAX_VOXELS = [4096, 4096, 4096]
    if small.RUNTIME.get('OCC_WINDOW_CAPS'):
        small.RUNTIME.OCC_WINDOW_CAPS = [32, 16, 16]
        small.RUNTIME.OCC_SMALL_CAPS = [32, 16, 16]
        small.RUNTIME.OCC_MID_CAPS = [32, 16, 16]
    spec = make_voxel_spec(small.DATA_CONFIG, small.RUNTIME)
    return small, frame_pair_batch(
        spec, list(small.CLASS_NAMES), indices=(3,),
        max_gt=int(small.RUNTIME.MAX_GT),
        host_voxelize=bool(small.RUNTIME.get('HOST_VOXELIZE')),
        num_point_features=num_point_features(small))


def stream_cache(torch, model, batch):
    """The first step of a stream: the previous frame of ``batch`` encoded
    alone (``return_hidden``); returns its pyramid, which a streaming pass
    of the pair takes as ``cached_prev``."""
    from tmae_tpu_torch.models.detectors import previous_frame_batch

    with torch.no_grad():
        return model(previous_frame_batch(batch),
                     return_hidden=True)['hidden_cur']


def compare_maps(torch, what, got, want):
    """Every head map of ``got`` finite and within max |diff| <= 0.1 and
    mean <= 5e-3 of its scale of ``want``'s (bf16 carriers; summation
    order differs)."""
    for name, a in got['pred_dicts'][0].items():
        b = want['pred_dicts'][0][name]
        d = (a.float().cpu() - b.float().cpu()).abs()
        scale = max(1.0, b.abs().max().item())
        log(f'  {name}: max_abs_err {d.max().item():.3g} (ref max '
            f'{b.abs().max().item():.3g}, mean err {d.mean().item():.2g})')
        if not torch.isfinite(a).all():
            raise AssertionError(f'{name}: non-finite values')
        if d.max().item() > 0.1 * scale or d.mean().item() > 5e-3 * scale:
            raise AssertionError(f'{name}: {what} disagree')


def card_vs_cpu(torch, cfg, np_batch, seed, stream=False):
    """The detector with the same seeded weights on the card (kernels) and
    on the CPU (plain versions), same frames, head maps compared by
    :func:`compare_maps`; with ``stream``, the streaming pass of the pair
    on both."""
    from tmae_tpu_torch.models.detectors import (batch_to_device,
                                                 build_detector, init_random_)

    outs = []
    for dev in ('cuda', 'cpu'):
        model = init_random_(build_detector(cfg, dev), seed=seed)
        batch = batch_to_device(np_batch, dev)
        hid = stream_cache(torch, model, batch) if stream else None
        with torch.no_grad():
            outs.append(model(batch, cached_prev=hid))
    torch.cuda.synchronize()
    compare_maps(torch, 'card and CPU', *outs)


# ---------------------------------------------------------------------------
# phases 6-7: the training path
# ---------------------------------------------------------------------------


def make_trainer(cfg, model, mask_seed=None):
    """adam_onecycle over a one-cycle run of NUM_EPOCHS steps (one step per
    epoch), and the training step with the config's loss: CenterPoint's, or
    the Chamfer loss of a TMAE config (whose mask each step draws from a
    generator seeded from ``mask_seed`` and the step)."""
    from tmae_tpu_torch.models.detectors import centerpoint_loss, tmae_loss
    from tmae_tpu_torch.train.optimization import build_optimizer
    from tmae_tpu_torch.train.trainer import make_train_step

    loss = tmae_loss if cfg.MODEL.NAME == 'TMAE' else centerpoint_loss
    opt, sched = build_optimizer(model.parameters(), cfg.OPTIMIZATION, 1)
    return make_train_step(model, lambda o, b: loss(cfg, o, b), opt, sched,
                           mask_seed=mask_seed)


def run_steps(torch, model, step, batch, steps, expected, what):
    """Step 0 with the launch counters set to 0 just before it and read just
    after it (they must equal ``expected``), then ``steps - 1`` timed steps.
    The loss must stay finite and fall, and the parameters finite. Returns
    (launches, per-step metrics, median ms of the timed steps, peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first, launches = counted(torch, lambda: step(batch))
    first_ms = (time.perf_counter() - t0) * 1e3
    log(f'  launches per {what} step: {launches} (expected {expected})')
    if launches != expected:
        raise AssertionError(f'launch counts differ from the {what} path')
    metrics, times = [first], []
    for _ in range(steps - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(step(batch))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    rs = [{k: float(v) for k, v in m.items()} for m in metrics]
    for i, r in enumerate(rs):
        log(f'  step {i}: ' + ', '.join(f'{k} {v:.5g}' for k, v in r.items()))
    losses = [r['loss'] for r in rs]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f'{what} loss is not finite')
    if not losses[-1] < losses[0]:
        raise AssertionError(f'{what} loss did not fall: {losses}')
    for name, prm in model.named_parameters():
        if not torch.isfinite(prm).all():
            raise AssertionError(f'parameter {name} is not finite')
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f'  ms per {what} step: median {med:.2f} (min {min(times):.2f}, '
        f'max {max(times):.2f}, {len(times)} steps; step 0 {first_ms:.1f}); '
        f'{len(TRAIN_PAIRS) * 1e3 / med:.3f} frame pairs/s; peak device '
        f'memory {peak:.2f} GiB')
    return launches, rs, med, peak


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
                    functools.partial(add_row, rows), profile)
    del calls
    step = make_trainer(cfg, model)
    launches, steps, med, peak = run_steps(torch, model, step, batch,
                                           TRAIN_STEPS,
                                           EXPECTED_TRAIN_LAUNCHES, 'training')
    if any(r['occ_overflow'] != 0 for r in steps):
        raise AssertionError('occupied windows overflowed a bucket cap')
    losses = [r['loss'] for r in steps]
    pairs_s = len(TRAIN_PAIRS) * 1e3 / med
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


def profile_train_step(torch, step, batch, name='profile_train.txt'):
    """Device time by kernel name over one training step (torch.profiler),
    into ``name`` under the output directory; the table ends with the
    step's self CPU and device time totals."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    (OUT_DIR / name).write_text(
        avg.table(sort_by='self_cuda_time_total', row_limit=-1))
    log(avg.table(sort_by='self_cuda_time_total', row_limit=50))
    (bwd, fwd), total = device_sums(avg, BWD_KERNELS, FWD_KERNELS)
    log(f'  {name}: K7/K9 (csrc/encoder_layer_bwd.cu) {bwd:.3f} ms, '
        f'the tiled kernel (csrc/encoder_layer_tiled.cu) {fwd:.3f} ms of '
        f'{total:.3f} ms of device time in the step')


def device_sums(avg, *groups):
    """From a profiler's ``key_averages()``: the device ms of the kernels
    whose names hold one of each group's names, and the device ms of all
    kernels."""
    from torch.autograd import DeviceType

    dev = [e for e in avg if e.device_type == DeviceType.CUDA
           and not getattr(e, 'is_user_annotation', False)]
    sums = [sum(e.self_device_time_total for e in dev
                if any(k in e.key for k in names)) / 1e3 for names in groups]
    return sums, sum(e.self_device_time_total for e in dev) / 1e3


def pass_breakdown(torch, fn, name):
    """Device time of one call of ``fn`` by kernel name (torch.profiler,
    after one warm call): the whole table into ``name`` under the output
    directory, and one log line of ms and calls per name, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):  # the first profile can miss the early kernels
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    avg = prof.key_averages()
    (OUT_DIR / name).write_text(
        avg.table(sort_by='self_cuda_time_total', row_limit=-1))
    short = lambda k: k.replace('void ', '').replace(
        '(anonymous namespace)::', '').split('(')[0][:60]
    ev = sorted(((e.self_device_time_total / 1e3, e.count, short(e.key))
                 for e in avg if e.device_type == DeviceType.CUDA
                 and e.self_device_time_total > 0), reverse=True)
    log(f'  {name}: {sum(t for t, _, _ in ev):.4f} ms of device time: '
        + ', '.join(f'{k} {t:.4f} ms x{c}' for t, c, k in ev))


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def _rel(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float((a - b).norm() / (b.norm() + 1e-30))


def train_step_once(torch, cfg, np_batch, seed, dev, round_encoder=False,
                    mae_mask=None):
    """One training step from the seeded weights on ``dev``, with the
    encoder's weights rounded once to bf16 if asked (and, for a TMAE
    config, the given mask). Returns (metrics, gradients, state before,
    state after), on the CPU."""
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
    kw = {} if mae_mask is None else {'mae_mask': mae_mask.to(dev)}
    m = {k: float(v) for k, v in step(batch_to_device(np_batch, dev),
                                      **kw).items()}
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


def train_card_vs_cpu(torch, cfg, np_batch, seed, mae_mask=None):
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
    kw = dict(mae_mask=mae_mask)
    mk, gk, bk, ak = train_step_once(torch, cfg, np_batch, seed, 'cuda', **kw)
    mp, gp, bp, ap = train_step_once(torch, cfg, np_batch, seed, 'cpu', **kw)
    mc, gc, _, _ = train_step_once(torch, cfg, np_batch, seed, 'cpu',
                                   round_encoder=True, **kw)
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


# ---------------------------------------------------------------------------
# phases 8-12: the grid layer, pretraining and Waymo serving
# ---------------------------------------------------------------------------


def grid_layer_calls(torch, model, batch, seed, deterministic=True,
                     train=True):
    """The inputs of the grid layer (K10 forward, K7 over its windows
    backward) as one train-mode forward of ``batch`` hands them over, with
    the mask drawn from a card generator seeded with ``seed`` (with
    ``train`` False: as one eval-mode forward, the serving path, hands them
    over; the model stays in eval mode): the first call per (width, mode,
    shift). With ``deterministic`` the forward runs
    under ``torch.use_deterministic_algorithms``: the VFE's segment sums
    (``scatter_add_``) then add in a fixed order, so every run captures the
    same inputs bit for bit (with atomics their f32 sums differ in the last
    bits from run to run). The model's running statistics are left as they
    were."""
    from tmae_tpu_torch.ops import encoder_layer as el

    calls = {}
    real = el._FusedEncoderLayerGrid

    def capture(*args):
        xg, (_, _, cross, _, shift) = args[0], args[5]
        calls.setdefault((xg.shape[-1], cross, shift), args)
        return real.apply(*args)

    bufs = {n: b.clone() for n, b in model.named_buffers()}
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    el._FusedEncoderLayerGrid = types.SimpleNamespace(apply=capture)
    try:
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        with torch.no_grad():
            if train:
                model.train()(batch, generator=torch.Generator(
                    device=batch['points'].device).manual_seed(seed))
            else:
                model.eval()(batch)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        el._FusedEncoderLayerGrid = real
        with torch.no_grad():
            for n, b in model.named_buffers():
                b.copy_(bufs[n])
    return calls


def capture_spread(torch, model, batch, seed, first):
    """How far the captured layer inputs move between two captures, with
    and without deterministic algorithms: per mode the largest |diff| of
    the captured tensors against ``first`` (a deterministic capture),
    logged; the deterministic captures must be equal."""
    for det in (True, False):
        a = first if det else grid_layer_calls(torch, model, batch, seed, det)
        b = grid_layer_calls(torch, model, batch, seed, det)
        diffs = {}
        for key in sorted(a):
            diffs[key] = max(
                (x.float() - y.float()).abs().max().item()
                for x, y in zip(a[key][:5], b[key][:5])
                if isinstance(x, torch.Tensor) and x.is_floating_point())
        log(f'  capture twice, deterministic={det}: largest |diff| of the '
            'layer inputs (C, cross, shift) '
            + ', '.join(f'{k}: {v:.3g}' for k, v in diffs.items()))
        if det and any(diffs.values()):
            raise AssertionError('two deterministic captures differ')


def grid_check(torch, el, call, gen, entry, backward, profile=False):
    """K10 on one captured call against its plain version on the same card
    (bf16 output over the occupied query cells, max |diff| <= 0.15 and mean
    <= 2e-3, as K3/K6; every other cell exactly 0), the exact checks of
    :func:`grid_bits_check`, its time and its bound;
    with ``backward``, the kernel path of its gradient (K7 on the windows
    with an occupied query cell) for BWD_DRAWS random cotangents against
    autograd through the plain version over every window, each output but
    dtau within K7's limits (5e-2 max and 5e-3 mean of its scale) for every
    cotangent, and the kernel path run twice giving the same bits. dtau is
    one sum over every window, head and key pair; it is linear in the
    cotangent and zero on average over random ones, so its error over its
    value in one draw is a ratio of two zero-mean sums, with no bounded
    spread (a draw whose dtau lands near 0 reads any ratio). Its error is
    held within 10% of its value in root mean square over them. With
    ``entry``, the C=128 self shift-0 call goes into the kernels line; with
    ``profile``, its backward's device time by kernel name too."""
    xg, kvg, qocc, kocc, pos, cfg, p, *weights = call
    nhead, tau_min, cross, window, shift = cfg
    kw = dict(nhead=nhead, tau_min=tau_min, cross=cross, window=window,
              shift=shift)
    label = (f'C={xg.shape[-1]} {"cross" if cross else "self"} '
             f'shift{int(shift)}')
    fk = lambda: el.encoder_layer_grid(xg, kvg, qocc, kocc, pos, p, **kw)
    fp = lambda: el.reference_encoder_layer_grid(
        xg, kvg, qocc, kocc, pos, p, nhead, tau_min, cross, window, shift)
    ka, pa = fk(), fp()
    torch.cuda.synchronize()
    d = (ka.float() - pa.float()).abs()[qocc]
    err, mean = d.max().item(), d.mean().item()
    if not (err <= 0.15 and mean <= 2e-3):
        raise AssertionError(f'K10 {label} differs from its plain version: '
                             f'max {err} mean {mean}')
    if (ka[~qocc] != 0).any():
        raise AssertionError(f'K10 {label}: an unoccupied cell is not 0')
    exact = grid_bits_check(torch, el, call, ka, label)
    B, H, W, C = xg.shape
    Fd = p.f1w.shape[0]
    qw = el._flat_windows(qocc.float(), window, shift).any(-1)
    nw, n_all = int(qw.sum()), qw.numel()
    # the bytes the function needs: the whole output grid written, the
    # query occupancy read (it decides which windows are empty), and x (kv
    # and the key occupancy in cross mode) read only on the grid cells of
    # the windows with an occupied query cell; the weights and pos once
    on_grid = el._flat_windows(torch.ones_like(qocc, dtype=torch.float32),
                               window, shift)
    cells = int(on_grid[qw].sum())
    wbytes = sum(t.numel() * t.element_size() for t in (*p, pos))
    nbytes = (B * H * W * C * 2 + B * H * W
              + (2 if cross else 1) * cells * C * 2 + (cells if cross else 0)
              + wbytes)
    flops = nw * layer_flops(64, C, Fd)
    ms = time_ms(torch, fk, iters=10)
    b, by = bound_ms(nbytes, flops)
    msg = (f'  K10 {label}: {B}x{H}x{W}, {nw} of {n_all} windows with a '
           f'query ({d.shape[0]} occupied cells); max_abs_err {err:.3g} '
           f'(mean {mean:.2g}), kernel {ms:.4f} ms, bound {b:.4f} ms ({by})'
           + exact)
    if backward:
        t0 = time.perf_counter()
        errs, refs, worst, peak = [], [], (0.0, ''), 0.0
        for _ in range(BWD_DRAWS):
            g = torch.randn(xg.shape, generator=gen, device=xg.device).to(
                torch.bfloat16)
            w, (e, r), pk = grid_bwd_check(torch, el, call, g, label)
            worst, peak = max(worst, w), max(peak, pk)
            errs.append(e)
            refs.append(r)
        rms = lambda v: math.sqrt(sum(x * x for x in v) / len(v))
        dtau = rms(errs) / max(rms(refs), 1e-30)
        if not dtau <= 0.1:
            raise AssertionError(
                f'K10/K7 {label}: dtau differs from autograd through the '
                f'plain version by {dtau:.3g} in root mean square')
        bk = lambda: el.encoder_layer_grid_bwd(xg, kvg, qocc, kocc, pos, p,
                                               g, **kw)
        ms_b = time_ms(torch, bk, iters=3, warmup=1)
        if profile and (xg.shape[-1], cross, shift) == (128, False, False):
            pass_breakdown(torch, bk, 'profile_bwd_grid.txt')
        msg += (f'; backward (views + K7 on {nw} windows) over {BWD_DRAWS} '
                f'cotangents: worst relative {worst[0]:.3g} ({worst[1]}), '
                f'dtau relative error {dtau:.3g} in root mean square (each '
                'draw: ' + ', '.join(f'{e / max(abs(r), 1e-30):.3g}'
                                     for e, r in zip(errs, refs))
                + f'); {ms_b:.3f} ms, peak {peak:.3f} GiB above its inputs; '
                f'{time.perf_counter() - t0:.1f} s')
    log(msg)
    if entry is not None and (xg.shape[-1], cross, shift) == (128, False,
                                                              False):
        entry('encoder_grid', 'K10', TILED_SRC,
              'tmae_tpu/ops/pallas_encoder.py:1483', err, ms,
              time_ms(torch, fp, iters=3, warmup=1), nbytes, flops, None)


def grid_bwd_check(torch, el, call, g, label):
    """The kernel path of the grid layer's gradient for cotangent ``g``
    against autograd through the plain version in f32, each output but
    dtau within K7's limits; a second run of the kernel path must give the
    same bits (K7 sums in a fixed order). Returns ((worst max |diff| /
    scale, output), (dtau's error, the plain version's dtau), peak GiB above
    the inputs)."""
    xg, kvg, qocc, kocc, pos, cfg, p, *weights = call
    nhead, tau_min, cross, window, shift = cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    bk = lambda: el.encoder_layer_grid_bwd(
        xg, kvg, qocc, kocc, pos, p, g, nhead=nhead, tau_min=tau_min,
        cross=cross, window=window, shift=shift)
    dx, dkv, grads = bk()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    again = bk()
    for a, b in zip([dx, dkv, *grads], [again[0], again[1], *again[2]]):
        if a is not None and not torch.equal(a, b):
            raise AssertionError(f'K10/K7 {label}: two runs of the kernel '
                                 'path differ')
    del again
    with torch.enable_grad():
        xr = xg.detach().float().requires_grad_()
        kr = kvg.detach().float().requires_grad_() if cross else None
        wr = [w.detach().float().requires_grad_() for w in p]
        out = el.reference_encoder_layer_grid(
            xr, kr, qocc, kocc, pos, el.LayerParams(*wr), nhead, tau_min,
            cross, window, shift)
        out.backward(g.float())
    names = ['dx', 'dkv'] + list(el.LayerParams._fields)
    worst, dtau = (0.0, ''), None
    for name, a, r in zip(names, [dx, dkv, *grads],
                          [xr.grad, kr.grad if cross else None,
                           *[w.grad for w in wr]]):
        if (a is None) != (r is None):
            raise AssertionError(f'K10/K7 {label}: {name} missing')
        if a is None:
            continue
        a, r = a.float(), r.float()
        if not torch.isfinite(a).all():
            raise AssertionError(f'K10/K7 {label}: {name} not finite')
        if name == 'tau':
            dtau = ((a - r).item(), r.item())
            continue
        scale = r.abs().max().item()
        e = (a - r).abs()
        if not (e.max().item() <= 5e-2 * scale
                and e.mean().item() <= 5e-3 * scale):
            raise AssertionError(
                f'K10/K7 {label}: {name} differs from autograd through '
                f'the plain version: max {e.max().item()} mean '
                f'{e.mean().item()} scale {scale}')
        worst = max(worst, (e.max().item() / max(scale, 1e-30), name))
    return worst, dtau, peak


def pretrain_phase(torch, cfg, steps, expected, rows=None, profile=None):
    """Pretraining steps of a TMAE config at full width and depth on
    TRAIN_PAIRS synthetic frame pairs (voxelized on the device unless the
    config says HOST_VOXELIZE), the mask drawn each step from one seeded
    generator on the card. With ``rows``, first K10 and its backward
    against their plain versions on the layer inputs of this batch, and how
    far those inputs move between captures. Step 0 runs with the launch
    counters set to 0 just before it and read just after it; then timed
    steps. The loss must stay finite and fall. With ``profile`` (a file
    name), a profiled step after them. Returns the launch counts and the
    phase's numbers."""
    from tmae_tpu_torch.datasets.synthetic import frame_pair_batch
    from tmae_tpu_torch.models.detectors import (batch_to_device,
                                                 build_detector, init_random_,
                                                 make_voxel_spec,
                                                 num_point_features)
    from tmae_tpu_torch.ops import encoder_layer as el

    spec = make_voxel_spec(cfg.DATA_CONFIG, cfg.RUNTIME)
    t0 = time.perf_counter()
    np_batch = frame_pair_batch(
        spec, list(cfg.CLASS_NAMES), indices=TRAIN_PAIRS,
        max_gt=int(cfg.RUNTIME.MAX_GT),
        host_voxelize=bool(cfg.RUNTIME.get('HOST_VOXELIZE')),
        num_point_features=num_point_features(cfg))
    log(f'  batch: {len(TRAIN_PAIRS)} frame pairs, '
        f'{int(np_batch["point_mask"].sum())} current-frame points '
        f'({time.perf_counter() - t0:.1f} s on the host)')
    batch = batch_to_device(np_batch, 'cuda')
    model = init_random_(build_detector(cfg), seed=0)
    if rows is not None:
        calls = grid_layer_calls(torch, model, batch, seed=0)
        log(f'  K10 against its plain version on the layer inputs of this '
            f'batch ({len(calls)} calls captured)')
        capture_spread(torch, model, batch, 0, calls)
        check_gen = torch.Generator(device='cuda').manual_seed(2)
        backward = {(128, False, False), (256, False, False),
                    (128, True, False)}
        for key in sorted(calls):
            grid_check(torch, el, calls[key], check_gen,
                       functools.partial(add_row, rows), key in backward,
                       bool(profile))
        del calls
        torch.cuda.empty_cache()
    step = make_trainer(cfg, model, mask_seed=0)
    launches, rs, med, peak = run_steps(torch, model, step, batch, steps,
                                        expected, 'pretraining')
    overflow = [r['occ_overflow'] for r in rs]
    log(f'  occ_overflow per step {overflow}')
    if profile:
        profile_train_step(torch, step, batch, profile)
    losses = [r['loss'] for r in rs]
    pairs_s = len(TRAIN_PAIRS) * 1e3 / med
    return launches, {'ms_per_step': med, 'pairs_per_s': pairs_s,
                      'peak_gib': peak, 'loss': losses,
                      'occ_overflow': overflow}


def pretrain_card_vs_cpu(torch, cfg, np_batch, seed):
    """One pretraining step on the card and on the CPU from the same
    weights, and the control, as :func:`train_card_vs_cpu` holds them, on
    one mask for all three: drawn on the CPU from a seeded generator over
    the voxels of this batch (the card's and the CPU's generators give
    other numbers from one seed)."""
    from tmae_tpu_torch.models.detectors import (batch_to_device,
                                                 make_voxel_spec)
    from tmae_tpu_torch.models.siamwca import random_voxel_mask
    from tmae_tpu_torch.ops.voxelize import voxelize

    b = batch_to_device(np_batch, 'cpu')
    vmask = voxelize(b['points'], b['point_mask'],
                     make_voxel_spec(cfg.DATA_CONFIG, cfg.RUNTIME))[
                         'voxel_mask']
    ratio = float(cfg.MODEL.BACKBONE_3D.MASK_CONFIG.RATIO)
    mask = random_voxel_mask(vmask, vmask.sum(1), ratio,
                             torch.Generator().manual_seed(seed))
    log(f'  mask: {int(mask.sum())} of {int(vmask.sum())} voxels masked')
    train_card_vs_cpu(torch, cfg, np_batch, seed, mae_mask=mask)


def serve_phase(torch, cfg, model, batch, expected, reps, profile=None,
                **fwd):
    """Serving passes of one frame pair at full width (``fwd``: the
    forward's streaming arguments): two warm-up passes; launch counters set
    to 0, one pass (forward, decode, host NMS), the counts checked against
    ``expected``; head maps and BEV features of the config's full grid
    finite, boxes finite; then ``reps`` timed passes and, with ``profile``
    (a file name), a profiled one. Returns (launches, median ms per frame
    pair, the counted pass's outputs)."""
    from tmae_tpu_torch.models.detectors import make_voxel_spec

    for _ in range(2):
        serve_once(torch, cfg, model, batch, **fwd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (out, cands), launches = counted(
        torch, lambda: serve_once(torch, cfg, model, batch, **fwd))
    boxes, keep = cands[0], cands[4]
    log(f'  launches per frame pair: {launches} (expected {expected})')
    if launches != expected:
        raise AssertionError('launch counts differ from the serving path')
    nx, ny, _ = make_voxel_spec(cfg.DATA_CONFIG, cfg.RUNTIME).grid_size
    for name, t in out['pred_dicts'][0].items():
        if t.shape[:3] != (1, ny, nx) or not torch.isfinite(t).all():
            raise AssertionError(f'head map {name}: bad shape or values')
    sf = out['spatial_features_2d']
    if sf.shape[:3] != (1, ny, nx) or not torch.isfinite(sf.float()).all():
        raise AssertionError('spatial_features_2d: bad shape or values')
    if not torch.isfinite(boxes).all():
        raise AssertionError('decoded boxes are not finite')
    log(f'  occ_overflow [sst0, sst1, sst2, wca0, wca1, wca2]: '
        f'{out["occ_overflow"].cpu().tolist()}')
    log(f'  detections kept after NMS: {int(keep.sum())} of '
        f'{keep.shape[1]} candidates (native host NMS)')
    nms_ms, kept = nms_split(cfg, cands[:4])
    log(f'  host NMS ms per frame pair on these candidates: native (the '
        f'path served) {nms_ms["native"]:.3f}, numpy {nms_ms["numpy"]:.3f}; '
        f'same kept set: {bool((kept["native"] == kept["numpy"]).all())}')
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve_once(torch, cfg, model, batch, **fwd)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    log(f'  ms per frame pair: median {med:.2f} (min {min(times):.2f}, max '
        f'{max(times):.2f}, {reps} passes); {1e3 / med:.2f} frames/s; peak '
        'device memory of the serving passes '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    if profile:
        profile_pass(torch, cfg, model, batch, profile, **fwd)
    return launches, med, out


def device_ms(torch, fn):
    """The device time of one call of ``fn`` in ms: the self device time of
    the profiler's device events (kernels, copies, sets), summed as its
    table's "Self CUDA time total" sums them; None where the profiler saw
    no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, 'is_user_annotation', False)) / 1e3
    return total or None


def fused_serving(torch, cfg, model, batch, stateless, profile=False):
    """The serving pass on the fused in-place layer path (K12), as
    TMAE_FUSED_INPLACE=1 selects it: served as :func:`serve_phase` serves,
    head maps held to ``stateless`` (the default path's, same weights and
    frames) by :func:`compare_maps`. Returns (launches, median ms, the
    counted pass's outputs)."""
    from tmae_tpu_torch.models import sst

    sst._FUSED_INPLACE = True
    try:
        launches, med, out = serve_phase(
            torch, cfg, model, batch, EXPECTED_FUSED, REPS,
            profile and 'profile_fused.txt')
        log('  head maps, fused path vs default path')
        compare_maps(torch, 'fused and default paths', out, stateless)
    finally:
        sst._FUSED_INPLACE = False
    return launches, med, out


def streaming_serving(torch, cfg, model, batch, stateless, fused):
    """Streaming serving on the default or (``fused``) the fused path: the
    previous frame encoded alone, then served as :func:`serve_phase`
    serves with ``cached_prev`` (counts: K5 once); head maps held to
    ``stateless`` (the stateless pass of the same path) by
    :func:`compare_maps` (the current frame runs alone at batch 1, where
    the stateless pass batches both frames, so the card may pick other
    convolution algorithms); the device time of one streaming and one
    stateless forward; the streaming pass card vs CPU on a 64x64 grid.
    Returns (median ms per frame, the two device times)."""
    from tmae_tpu_torch.models import sst

    sst._FUSED_INPLACE = fused
    try:
        hid = stream_cache(torch, model, batch)
        _, med, counted_out = serve_phase(
            torch, cfg, model, batch,
            EXPECTED_STREAM_FUSED if fused else EXPECTED_STREAM, REPS,
            cached_prev=hid)
        log('  head maps, streaming vs stateless pass')
        compare_maps(torch, 'streaming and stateless passes', counted_out,
                     stateless)
        with torch.no_grad():
            dev = (device_ms(torch, lambda: model(batch, cached_prev=hid)),
                   device_ms(torch, lambda: model(batch)))
        log(f'  device ms per forward: streaming {dev[0]}, stateless '
            f'{dev[1]}')
        del hid, counted_out
        log('  streaming card vs CPU, full width on a 64x64 grid')
        card_vs_cpu(torch, *small_grid(cfg), seed=7, stream=True)
    finally:
        sst._FUSED_INPLACE = False
    return med, dev


# ---------------------------------------------------------------------------
# phase 5c: the windowed SubM conv (K15), the attention-only window layer
# (K16) and the unpadded window API (K13b / K13c, served by K2)
# ---------------------------------------------------------------------------


def conv_out_inputs(torch, model, batch):
    """``[(name, block, y, occ)]``: what reaches each SubMConvBlock
    ``conv_out`` (the 3 SST stages, then the 3 WCA blocks) in one eval-mode
    serving forward, taken by forward pre-hooks."""
    enc = model.backbone_3d.encoder
    blocks = ([(f'sst{i}', b.conv_out) for i, b in enumerate(enc.sst_blocks)]
              + [(f'wca{i}', b.conv_out)
                 for i, b in enumerate(enc.wca_blocks)])
    caught = {}
    hooks = [blk.register_forward_pre_hook(
        lambda m, args, name=name: caught.setdefault(
            name, (args[0].detach().clone(), args[1].clone())))
        for name, blk in blocks]
    try:
        with torch.no_grad():
            model(batch)
    finally:
        for h in hooks:
            h.remove()
    return [(name, blk, *caught[name]) for name, blk in blocks]


def full_plan(oc, occ, shift):
    """The plan of every occupied window of the shift's partition: cap =
    round_cap(the most occupied windows of a sample)."""
    n = (oc.window_cell_counts(occ, 8, shift) > 0).sum((1, 2))
    plan = oc.build_compact_info(occ, 8, shift, oc.round_cap(int(n.max())),
                                 (occ.shape[1], occ.shape[2]))
    if int(plan.overflow().sum()):
        raise AssertionError('the plan drops an occupied window')
    return plan


def rel_err(torch, what, got, want, max_rel, mean_rel):
    """max and mean |got - want|, both finite, held to ``max_rel`` and
    ``mean_rel`` of the scale max(1, max |want|); returns the max."""
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f'{what}: non-finite values')
    d = (got - want).abs()
    scale = max(1.0, want.abs().max().item())
    err, mean = d.max().item(), d.mean().item()
    log(f'  {what}: max_abs_err {err:.3g} mean {mean:.2g} (scale '
        f'{scale:.3g})')
    if err > max_rel * scale or mean > mean_rel * scale:
        raise AssertionError(f'{what}: beyond max {max_rel} / mean '
                             f'{mean_rel} of the scale')
    return err


def bf16_err(torch, what, got, want, live, spread=2 ** -7):
    """``got`` against ``want``, two bf16 results of one function that
    round differently: bit-equal where the boolean ``live`` (over their
    leading dims) is False; where it is True each |diff| within
    2^-6 |want| + ``spread`` rms and the mean |diff| within 2^-7 rms (one
    bf16 step per element on average), rms the root mean square of
    ``want`` there. Returns the max |diff|."""
    if not torch.equal(got[~live], want[~live]):
        raise AssertionError(f'{what}: differs where it must be exact')
    g, w = got[live].float(), want[live].float()
    if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
        raise AssertionError(f'{what}: non-finite values')
    d = (g - w).abs()
    rms = w.square().mean().sqrt().item()
    worst = (d / (2 ** -6 * w.abs() + spread * rms)).max().item()
    err, mean = d.max().item(), d.mean().item()
    log(f'  {what}: max_abs_err {err:.3g} mean {mean:.3g} on {g.shape[0]} '
        f'live rows (rms {rms:.3g}); worst |diff| / limit {worst:.3g}, '
        f'mean / limit {mean / (2 ** -7 * rms):.3g}')
    if worst > 1 or mean > 2 ** -7 * rms:
        raise AssertionError(f'{what}: beyond the bf16-step limits')
    return err


def k16_rounded(torch, args, zero_head=False, scale_mult=1.0):
    """K16's function with the kernel's own bf16 roundings, in torch ops:
    x + pos, the weights, the normalised and scaled q, the normalised k, v,
    p and the attention output rounded to bf16, every sum in f32. It
    differs from the kernel only where an f32 value rounds the other way.
    ``zero_head`` and ``scale_mult`` plant faults (head 0 zeroed, the
    softmax scale multiplied)."""
    (xw, kvw, kmask, pos, wq, bq, wk, bk, wv, bv, wo, bo, tau, nhead,
     tau_min, cross) = args
    b, f = torch.bfloat16, torch.float32
    r = lambda t: t.to(b).to(f)
    N, T, C = xw.shape
    H, D = nhead, C // nhead
    kv = kvw if cross else xw
    xp = xw + pos.to(b)[None]
    kvp = kv + pos.to(b)[None] if cross else xp

    def heads(a, w, bias, mult):
        y = (a.to(f) @ r(w) + bias).reshape(N, T, H, D)
        return r(y * torch.rsqrt(y.square().sum(-1, keepdim=True) + 1e-24)
                 * mult)

    scale = scale_mult / torch.clamp(tau[0], min=tau_min)
    q, k = heads(xp, wq, bq, scale), heads(kvp, wk, bk, 1.0)
    v = r(kv.to(f) @ r(wv) + bv).reshape(N, T, H, D)
    logits = torch.einsum('wthd,wshd->whts', q, k)
    logits = torch.where(kmask[:, None, None, :] > 0, logits, -30000.0)
    p = r(torch.softmax(logits, dim=-1))
    p = torch.where((kmask > 0).any(-1)[:, None, None, None], p, 0.0)
    att = torch.einsum('whts,wshd->wthd', p, v)
    if zero_head:
        att[:, :, 0] = 0
    return (r(att.reshape(N, T, C)) @ r(wo) + bo).to(b)


def window_api_run(torch, oc, x, init, plans, cots, plain=False):
    """Per (shift, plan): gather the planned windows of ``x``, scatter them
    into zeros and into ``init``, backward with the seeded cotangents.
    Returns every output and gradient; ``plain`` runs the plain versions."""
    gather = oc.gather_windows_plain if plain else oc.gather_windows
    scatter = oc.scatter_windows_plain if plain else functools.partial(
        oc.scatter_windows, zero_fill=True)
    into = oc.scatter_windows_into_plain if plain else oc.scatter_windows_into
    hw = (x.shape[1], x.shape[2])
    res = []
    for (shift, plan), (g1, g2) in zip(plans, cots):
        xs = x.clone().requires_grad_()
        ini = init.clone().requires_grad_()
        xw = gather(xs, plan.idx, hw, 8, shift)
        ys = scatter(xw, plan.idx, hw, 8, shift)
        zs = into(xw, plan.idx, ini, hw, 8, shift)
        torch.autograd.backward([ys, zs], [g1, g2])
        res += [xw.detach(), ys.detach(), zs.detach(), xs.grad, ini.grad]
    return res


def block_forward(blk, y, occ, plan):
    """SubMConvBlock forward (``plan``, or the dense conv for None) of a
    copy of ``y`` that wants a gradient: (that copy, the output, the
    conv's masked output, which the batch norm takes)."""
    seen = []
    hook = blk.bn.register_forward_pre_hook(lambda m, args: seen.append(
        args[0]))
    try:
        a = y.clone().requires_grad_()
        out = blk(a, occ, plan)
    finally:
        hook.remove()
    return a, out, seen[0]


def conv_block_run(torch, blk, y, occ, plan, g):
    """A train-mode SubMConvBlock forward and its backward with cotangent
    ``g``: (output, the gradient at the conv's masked output)."""
    _, out, conv = block_forward(blk, y, occ, plan)
    conv.retain_grad()
    (out.float() * g).sum().backward()
    return out.detach(), conv.grad


def conv_grads(torch, blk, y, occ, plan, gy):
    """dx and dW of the block's conv alone (planned or dense) from one
    upstream gradient ``gy`` at its masked output."""
    a, _, conv = block_forward(blk, y, occ, plan)
    return torch.autograd.grad(conv, (a, blk.conv.weight), gy)


def attention_cases(torch, sst, caught, dev):
    """(label, module, grid, kv grid) of the K16 cases: C=128, 8 heads on
    the stage-1 grid, self at shift 0 and 1 and cross against the previous
    frame; C=256 self on stage 2. Seeded weights."""
    from tmae_tpu_torch.models.detectors import init_random_

    (_, _, y1, o1), (_, _, y2, o2) = caught[:2]
    g1, g2 = sst.DenseGrid(y1, o1), sst.DenseGrid(y2, o2)
    mk = lambda C, shift, cross, seed: init_random_(
        sst.DenseWindowAttention(C, 8, 8, shift, cross=cross),
        seed=seed).to(dev)
    return [('C=128 self shift 0', mk(128, False, False, 11), g1, None),
            ('C=128 self shift 1', mk(128, True, False, 12), g1, None),
            ('C=128 cross', mk(128, False, True, 13),
             sst.DenseGrid(y1[:1], o1[:1]), sst.DenseGrid(y1[1:], o1[1:])),
            ('C=256 self', mk(256, False, False, 14), g2, None)]


@contextlib.contextmanager
def plain_attention(sst, wa):
    """DenseWindowAttention runs the plain version of K16 inside (the
    module is otherwise unchanged)."""
    saved = sst.fused_window_attention
    sst.fused_window_attention = wa.reference_forward
    try:
        yield
    finally:
        sst.fused_window_attention = saved


def grid_cells(torch, idx, valid, hw, dilate):
    """Grid cells [B, H, W] covered by the real windows of an unshifted
    plan, grown by one cell with ``dilate`` (a 3x3 conv's halo)."""
    B = idx.shape[0]
    H, W = hw
    nwy, nwx = (H + 7) // 8 + 1, (W + 7) // 8 + 1
    m = torch.zeros(B, nwy + 1, nwx, dtype=torch.bool, device=idx.device)
    bi = torch.arange(B, device=idx.device)[:, None].expand_as(valid)
    m[bi[valid], idx[..., 0][valid].long(), idx[..., 1][valid].long()] = True
    m = m.repeat_interleave(8, 1).repeat_interleave(8, 2)[:, 8:8 + H, 8:8 + W]
    if dilate:
        m = torch.nn.functional.max_pool2d(m[:, None].float(), 3, 1, 1)[:, 0]
    return m > 0


def flat_attention_args(sst, mod, gr, kv):
    """The flat K16 arguments of one DenseWindowAttention call."""
    cross = kv is not None
    view = lambda t: sst.window_view(t, 8, mod.shift)
    xw = view(gr.x.to(mod.pos.dtype))
    T, C = xw.shape[2:]
    xw = xw.reshape(-1, T, C)
    kvw = view(kv.x.to(mod.pos.dtype)).reshape(-1, T, C) if cross else xw
    km = view((kv if cross else gr).occ[..., None].float())[..., 0]
    return (xw, kvw, km.reshape(-1, T), mod.pos, mod.q.weight.t(),
            mod.q.bias, mod.k.weight.t(), mod.k.bias, mod.v.weight.t(),
            mod.v.bias, mod.out.weight.t(), mod.out.bias, mod.tau,
            mod.nhead, mod.tau_min, cross)


def window_api_check(torch, oc, y1, wplans, api, init, cots):
    """The path's window API outputs and VJPs, and the scatter without zero
    fill, equal to the plain versions."""
    hw = (y1.shape[1], y1.shape[2])
    want = window_api_run(torch, oc, y1, init, wplans, cots, plain=True)
    names = ('gather', 'scatter (zero fill)', 'scatter_into', 'd x',
             'd init')
    for i, (a, b) in enumerate(zip(api, want)):
        if not torch.equal(a, b):
            raise AssertionError(f'window API {names[i % 5]} (shift '
                                 f'{i // 5}) differs from its plain version')
    for shift, plan in wplans:
        xw = oc.gather_windows(y1, plan.idx, hw, 8, shift)
        if not torch.equal(oc.scatter_windows(xw, plan.idx, hw, 8, shift),
                           oc.scatter_windows_plain(xw, plan.idx, hw, 8,
                                                    shift)):
            raise AssertionError('scatter_windows without zero fill differs')
    log(f'  window API (stage 1, caps '
        f'{[p.idx.shape[1] for _, p in wplans]}): gather, scatter, '
        'scatter_into and their VJPs equal the plain versions')


def conv_check(torch, sc, caught, cplans, biases, train_blocks, conv, conv_g,
               entry):
    """K15 on each captured conv_out input against its plain version (max
    1e-2, mean 1e-3 of the scale: 9*Cin-term f32 sums in another order, one
    bf16 rounding); the planned block against the dense one in eval mode
    (same limits) and in train mode: the path's output (K7's limits, 5e-2
    and 5e-3) and the conv's dx and dW from one upstream gradient (the
    dense block's) at K7's limits. The whole block's dx and dW are not
    compared: the two forwards round differently, so a ReLU or batch-norm
    gate can flip at a cell and send the cotangent there down one path
    only, and the rest of the block's backward is the same code on both.
    Stage 1 and stage 2 timed into the kernels line, with cuDNN's dense
    conv2d as the yardstick."""
    import copy

    for (name, blk, y, o), p, bias, (out_p, _), g in zip(
            caught, cplans, biases, conv, conv_g):
        wmat = blk.conv.weight.detach().permute(2, 3, 1, 0).to(
            torch.bfloat16).contiguous()
        args = (y, p.idx, p.qmask, wmat, bias, 8)
        got = sc.subm_conv_windows(*args)
        want = sc.subm_conv_windows_plain(*args)
        torch.cuda.synchronize()
        err = rel_err(torch, f'K15 {name} {tuple(y.shape)} -> '
                      f'{wmat.shape[3]}, cap {p.idx.shape[1]}', got, want,
                      1e-2, 1e-3)
        with torch.no_grad():
            rel_err(torch, f'  SubMConvBlock(plan) vs dense, eval, {name}',
                    blk(y, o, (p.idx, p.qmask, 8)), blk(y, o), 1e-2, 1e-3)
        out_d, gy = conv_block_run(
            torch, copy.deepcopy(blk).train(), y, o, None, g)
        conv_bits_check(torch, sc, name, y, p, wmat, bias, got)
        rel_err(torch, f'  train forward, {name}', out_p, out_d, 5e-2, 5e-3)
        same = [conv_grads(torch, blk, y, o, plan, gy)
                for plan in ((p.idx, p.qmask, 8), None)]
        for what, a, b in zip(('dx', 'dW'), *same):
            s = b.float().abs().max().item()
            rel_err(torch, f'  conv {what} / {s:.3g} from one upstream '
                    f'gradient, {name}', a.float() / s, b.float() / s, 5e-2,
                    5e-3)
        if name not in ('sst0', 'sst1'):
            continue
        conv_edge_check(torch, sc, name, y.shape, wmat, bias)
        Cin, Cout = wmat.shape[2:]
        n_real = int(p.valid.sum())
        halo = int(grid_cells(torch, p.idx, p.valid, y.shape[1:3],
                              True).sum())
        nbytes = (halo * Cin * 2 + wmat.numel() * 2 + n_real * 64 * 4
                  + got.numel() * 2 + p.idx.numel() * 4)
        xn = y.permute(0, 3, 1, 2)
        wo = blk.conv.weight.detach().to(torch.bfloat16)
        with torch.no_grad():
            op_ms = time_ms(torch, lambda: sc.subm_conv3x3(
                y, p.idx, p.qmask, wmat, bias, y.shape[1:3], 8), iters=10)
            call = lambda: sc.subm_conv_windows(*args)
            entry(f'subm_conv_{"stage1" if name == "sst0" else "stage2"}',
                  'K15', 'tmae_tpu_torch/csrc/subm_conv.cu',
                  'tmae_tpu/ops/sparse_conv.py:101', err,
                  time_ms(torch, call, iters=10),
                  time_ms(torch, lambda: sc.subm_conv_windows_plain(*args),
                          iters=3, warmup=1),
                  nbytes, 2 * n_real * 64 * 9 * Cin * Cout,
                  time_ms(torch, lambda: torch.nn.functional.conv2d(
                      xn, wo, padding=1), iters=10),
                  op_ms=op_ms, windows=n_real, cap=p.idx.shape[1],
                  device_ms=device_ms(torch, call))
        log(f'    {name}: {n_real} windows, halo {halo} cells; '
            f'subm_conv3x3 forward (K15 + K13b) {op_ms:.4f} ms')


def same_bits(torch, a, b):
    """True when two tensors hold the same bits (0.0 and -0.0 differ)."""
    kind = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(kind), b.view(kind)))


def conv_bits_check(torch, sc, name, y, plan, wmat, bias, got):
    """K15's exact checks on one plan call whose output is ``got``: dummy
    slots and real slots without a query (every third real slot's qmask
    zeroed) are all zero, and that leaves every other slot's bits; the same
    bits twice; the plan's slots permuted in each sample (other windows
    share the tiles) give the same rows, permuted, bit for bit; the first
    slots of sample 0 up to an odd number of live windows (a partial last
    tile) give the whole call's rows."""
    idx, qm = plan.idx, plan.qmask
    B, cap = idx.shape[:2]
    k15 = lambda i, q: sc.subm_conv_windows(y, i, q, wmat, bias, 8)
    if not same_bits(torch, k15(idx, qm), got):
        raise AssertionError(f'K15 {name}: two runs differ')
    if got[~plan.valid].any():
        raise AssertionError(f'K15 {name}: a dummy slot is not zero')
    ar = torch.arange(cap, device=y.device)
    drop = plan.valid & (ar % 3 == 0)
    out = k15(idx, qm.masked_fill(drop[..., None], 0.0))
    if out[drop].any() or not same_bits(torch, out[~drop], got[~drop]):
        raise AssertionError(f'K15 {name}: a query-less real slot is not '
                             'zero, or another slot moved')
    gen = torch.Generator(device='cpu').manual_seed(cap)
    perm = torch.stack([torch.randperm(cap, generator=gen)
                        for _ in range(B)]).to(y.device)
    take = lambda a: a.gather(1, perm.reshape(
        B, cap, *([1] * (a.dim() - 2))).expand(a.shape))
    if not same_bits(torch, k15(take(idx), take(qm)), take(got)):
        raise AssertionError(f'K15 {name}: permuted slots give other rows')
    live = plan.valid & (qm != 0).any(-1)
    odd = (live[0].int().cumsum(0) % 2 == 1).nonzero()
    if not len(odd):
        raise AssertionError(f'K15 {name}: no live slot in sample 0')
    n = int(odd[-1, 0]) + 1
    part = sc.subm_conv_windows(y[:1], idx[:1, :n].contiguous(),
                                qm[:1, :n].contiguous(), wmat, bias, 8)
    if not same_bits(torch, part, got[:1, :n].contiguous()):
        raise AssertionError(f'K15 {name}: the first {n} slots of sample 0 '
                             'differ from the whole call')
    log(f'    K15 {name} exactly: {int((~plan.valid).sum())} dummy slots and '
        f'{int(drop.sum())} query-less real slots zero, the others kept; the '
        f'same bits twice; permuted slots the same rows; the first {n} slots '
        f'of sample 0 ({int(live[0, :n].sum())} live: a partial last tile) '
        "the whole call's rows")


def conv_edge_check(torch, sc, name, shape, wmat, bias):
    """K15 on every window along the four edges of a seeded random grid of
    ``shape`` (half their cells with a query, and a dummy slot), exactly
    against the same windows one window inwards in that grid padded with 8
    zero cells on every side, where the halo's cells off the grid are real
    zeros (the kernel's zero fill); and against the plain version (1e-2 /
    1e-3 of the scale)."""
    B, H, W, C = shape
    dev = wmat.device
    gen = torch.Generator(device=dev).manual_seed(C)
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    nwy, nwx = (H + 7) // 8 + 1, (W + 7) // 8 + 1
    edge = [(wy, wx) for wy in range(1, nwy) for wx in range(1, nwx)
            if wy in (1, nwy - 1) or wx in (1, nwx - 1)]
    idx = torch.tensor(edge + [(nwy, 0)], dtype=torch.int32, device=dev)
    idx = idx[None].expand(B, -1, -1).contiguous()
    qm = (torch.rand(idx.shape[:2] + (64,), generator=gen, device=dev)
          < 0.5).float()
    qm[:, :, 0] = 1.0
    qm[:, -1] = 0.0
    got = sc.subm_conv_windows(x, idx, qm, wmat, bias, 8)
    xp = torch.nn.functional.pad(x, (0, 0, 8, 8, 8, 8))
    inner = idx + 1
    inner[:, -1] = torch.tensor([(H + 16 + 7) // 8 + 1, 0],  # its dummy row
                                dtype=torch.int32)
    moved = sc.subm_conv_windows(xp, inner, qm, wmat, bias, 8)
    if not same_bits(torch, moved[:, :-1], got[:, :-1]) or got[:, -1].any():
        raise AssertionError(f'K15 {name}: edge windows differ from the '
                             'same windows inside a zero-padded grid, or '
                             'the dummy slot is not zero')
    rel_err(torch, f'    K15 {name} on {len(edge)} edge windows of a '
            f'random {tuple(shape)} grid, exactly as inside a zero-padded '
            'grid; vs plain', got,
            sc.subm_conv_windows_plain(x, idx, qm, wmat, bias, 8), 1e-2, 1e-3)


def planted_faults(torch, args, got, live):
    """K16's output ``got`` against :func:`k16_rounded` with a fault
    planted (head 0 zeroed; the softmax scale halved): :func:`bf16_err`
    must refuse each."""
    for fault, kw in (('head 0 zeroed', dict(zero_head=True)),
                      ('softmax scale halved', dict(scale_mult=0.5))):
        try:
            bf16_err(torch, f'  planted fault ({fault})', got,
                     k16_rounded(torch, args, **kw), live)
        except AssertionError:
            log('    refused, as it must be')
            continue
        raise AssertionError(f'the K16 limits let a fault pass: {fault}')


def k16_bits_check(torch, wa, args, got, rounded, label):
    """K16's exact checks on one call ``args`` whose output is ``got``
    (``rounded``: :func:`k16_rounded` of the same call): every token of a
    window without a key is bf16(bo) to the bit (the writer warp); a
    second run gives the same bits; nothing leaks between windows (the
    first window with a key and a query cell negated: every other window
    keeps its bits, its own change); a prefix of the windows whose count
    of windows with a key is odd and not a multiple of the SM count (a
    partial last round of tiles) gives the whole call's bits on them; the
    windows with a key and no occupied query cell (x zero there: cross
    mode) are run, held to ``rounded`` as the others are, and are not
    bo."""
    xw, kvw, kmask = args[:3]
    cross = args[-1]
    live = (kmask > 0).any(-1)
    bo = args[11].detach().to(torch.bfloat16)
    if not torch.equal(got[~live], bo.expand(int((~live).sum()), 64, -1)):
        raise AssertionError(f'K16 {label}: a window without a key is not '
                             'bo')
    if not same_bits(torch, wa.window_attention_fwd(*args), got):
        raise AssertionError(f'K16 {label}: two runs differ')
    has_x = (xw != 0).flatten(1).any(-1)
    w0 = int((live & has_x).nonzero()[0, 0])
    x2 = xw.clone()
    x2[w0] = -x2[w0]
    moved = wa.window_attention_fwd(x2, kvw if cross else x2, *args[2:])
    rest = torch.ones(len(xw), dtype=torch.bool, device=xw.device)
    rest[w0] = False
    if not same_bits(torch, moved[rest], got[rest]):
        raise AssertionError(f'K16 {label}: changing window {w0} moved '
                             'another window')
    if torch.equal(moved[w0], got[w0]):
        raise AssertionError(f'K16 {label}: window {w0} did not change')
    counts = live.int().cumsum(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    odd = ((counts % 2 == 1) & (counts % sms != 0) & (counts > sms))
    n = int(odd.nonzero()[0, 0]) + 1 if odd.any() else len(xw)
    part = wa.window_attention_fwd(xw[:n], kvw[:n] if cross else None,
                                   kmask[:n], *args[3:])
    if not same_bits(torch, part, got[:n]):
        raise AssertionError(f'K16 {label}: the first {n} windows differ '
                             'from the whole call')
    noq = live & ~has_x
    if cross:
        if not noq.any():
            raise AssertionError(f'K16 {label}: no window with a key and no '
                                 'query cell to check')
        bf16_err(torch, f'  K16 {label} on the {int(noq.sum())} windows with '
                 'a key and no query cell, vs its own roundings', got[noq],
                 rounded[noq], torch.ones(int(noq.sum()), dtype=torch.bool,
                                          device=xw.device))
        if (got[noq] == bo).all(-1).all(-1).any():
            raise AssertionError(f'K16 {label}: a window with a key and no '
                                 'query cell is bo')
    log(f'  K16 {label}: {int((~live).sum())} windows without a key bo to '
        f'the bit, the same bits twice, no leak from window {w0}, the first '
        f'{n} windows ({int(counts[n - 1])} with a key) as in the whole '
        f'call; {int(noq.sum())} windows with a key and no query cell')


def panels_check(torch, wa, args, got):
    """The panels a K16 call packs for itself, read from its workspace
    after the call, bit for bit against their plain version (q, k, v and o
    rounded to bf16 to nearest even, in the tiled kernel's layout); and
    the call's output ``got`` (weights as DenseWindowAttention passes them:
    transposed views of f32 Linear weights) the same bits from the same
    weights handed as contiguous f32 [C_in, C_out] (the wrapper copies
    them), as a mix of one bf16 and three f32 (all packed from f32) and as
    bf16 (packed from bf16), each call's panels equal to the first's."""
    from tmae_tpu_torch.ops.encoder_layer import panels_plain

    xw, C = args[0], args[0].shape[-1]
    ws = args[4:12:2]
    want = panels_plain([w.t() for w in ws])
    jax_layout = [w.detach().contiguous() for w in ws]
    forms = (('transposed Linear views', list(ws)),
             ('contiguous f32 [C_in, C_out]', jax_layout),
             ('one bf16, three f32', [jax_layout[0].to(torch.bfloat16)]
              + jax_layout[1:]),
             ('bf16', [w.to(torch.bfloat16) for w in jax_layout]))
    for form, mats in forms:
        a = list(args)
        a[4:12:2] = mats
        work = wa.workspace(len(xw), C, xw.device)
        out = wa.window_attention_fwd(*a, ws=work)
        panels = work[:8 * C * C].view(torch.bfloat16)
        if not same_bits(torch, panels, want):
            raise AssertionError(f'K16 panels from {form} differ from their '
                                 'plain version')
        if not same_bits(torch, out, got):
            raise AssertionError(f'K16 from {form} weights differs from the '
                                 'transposed views\' output')
    log(f'  K16 panels C={C}: {want.numel()} bf16 values from its workspace '
        'equal to the plain panels bit for bit, and the same output bits, '
        'from ' + ', '.join(f for f, _ in forms) + ' weights')


def attention_check(torch, sst, wa, attn, att, gen, entry):
    """K16 on each case's flat windows, by :func:`bf16_err` on the windows
    with a key (a window without one is bo on both sides, to the bit):
    against its plain version (f32 but for the output; each |diff| within
    2^-6 |want| + 2^-4 rms, the kernel rounding its weights and six
    intermediates to bf16) and against :func:`k16_rounded` (the kernel's
    roundings; 2^-6 |want| + 2^-7 rms), with the mean within 2^-7 rms for
    both; the module's path output against the plain module's on the
    occupied query cells (zero elsewhere on both sides), as against the
    plain version; on the stage-1 self case the rounded comparison must
    refuse a planted fault (:func:`planted_faults`); the exact checks of
    :func:`k16_bits_check` on every case; gradients through the Function
    against plain autograd (finite, max 0.15 and mean 2e-3 of their scale)
    for the stage-1 self and cross cases; the stage-1 self call timed into
    the kernels line, with its device time."""
    for (label, mod, gr, kv), out in zip(attn, att):
        args = flat_attention_args(sst, mod, gr, kv)
        live = (args[2] > 0).any(-1)
        with torch.no_grad():
            got = wa.window_attention_fwd(*args)
            want = wa.reference_forward(*args)
            rounded = k16_rounded(torch, args)
            torch.cuda.synchronize()
            err = bf16_err(torch, f'K16 {label} {list(args[0].shape)}', got,
                           want, live, spread=2 ** -4)
            bf16_err(torch, f'  K16 {label} vs its own roundings', got,
                     rounded, live)
            if label == 'C=128 self shift 0':
                planted_faults(torch, args, got, live)
            k16_bits_check(torch, wa, args, got, rounded, label)
            if label in ('C=128 self shift 0', 'C=256 self'):
                panels_check(torch, wa, args, got)
            with plain_attention(sst, wa):
                bf16_err(torch, f'  DenseWindowAttention vs plain module, '
                         f'{label}', out, mod(gr, kv), gr.occ,
                         spread=2 ** -4)
        if label in ('C=128 self shift 0', 'C=128 cross'):
            g = torch.randn(gr.x.shape, generator=gen, device=gr.x.device)
            grads = []
            for plain in (False, True):
                mod.zero_grad()
                x = gr.x.clone().requires_grad_()
                with (plain_attention(sst, wa) if plain
                      else contextlib.nullcontext()):
                    o = mod(sst.DenseGrid(x, gr.occ), kv)
                (o * g).sum().backward()
                grads.append([x.grad] + [q.grad.clone()
                                         for q in mod.parameters()])
            for i, (a, b) in enumerate(zip(*grads)):
                s = max(b.float().abs().max().item(), 1e-12)
                rel_err(torch, f'  gradient {i} / {s:.3g} through the '
                        f'Function, {label}', a.float() / s, b.float() / s,
                        0.15, 2e-3)
        if label != 'C=128 self shift 0':
            continue
        xw, km = args[0], args[2]
        N, T, C = xw.shape
        n_key = int((km > 0).any(-1).sum())
        nbytes = (n_key * T * C * 2 + N * T * 4 + N * T * C * 2
                  + 4 * C * C * 2 + 5 * C * 4 + T * C * 2)
        with torch.no_grad():
            call = lambda: wa.window_attention_fwd(*args)
            entry('window_attention', 'K16', TILED_SRC,
                  'tmae_tpu/ops/pallas_attn.py:120', err,
                  time_ms(torch, call, iters=10),
                  time_ms(torch, lambda: wa.reference_forward(*args),
                          iters=3, warmup=1),
                  nbytes, n_key * (2 * T * C * C * 4 + 2 * T * T * C * 2),
                  None, windows=N, windows_with_key=n_key,
                  **launch_times(torch, f'K16 {label}', call))


def scatter_rows(torch, oc, y1, init, wplans, entry):
    """K13b (K2 into a zero carrier) and K13c (its own kernel) on the
    stage-1 plans of every occupied window, unshifted and shifted, against
    their plain versions and ``torch.index_put`` on the in-grid cells of the
    real windows, bit for bit; K13c's output contiguous; K13c with every
    other real slot of the unshifted plan made a dummy slot (the windows it
    leaves out keep ``init``'s bits); K13c's VJP (``dinit``, contiguous,
    and ``dxw``) against the plain version's, bit for bit. The unshifted
    calls are timed into the kernels line with ``torch.index_put`` as the
    yardstick."""
    B, H, W, C = y1.shape
    hw = (H, W)
    iy = torch.arange(8, device=y1.device)
    zeros = torch.zeros_like(y1)
    for shift, plan in wplans:
        idx, valid = plan.idx, plan.valid
        cap = idx.shape[1]
        off = 4 if shift else 8
        xw = oc.gather_windows(y1, idx, hw, 8, shift)
        r = (idx[..., 0].long()[..., None, None] * 8 - off
             + iy[:, None]).expand(B, cap, 8, 8)
        c = (idx[..., 1].long()[..., None, None] * 8 - off
             + iy[None, :]).expand(B, cap, 8, 8)
        keep = (valid[..., None, None] & (r >= 0) & (r < H) & (c >= 0)
                & (c < W))
        bi = torch.arange(B, device=y1.device)[:, None, None, None]
        ind = (bi.expand_as(r)[keep], r[keep], c[keep])
        sv = xw.reshape(B, cap, 8, 8, C)[keep]
        uncovered = B * H * W - int(keep.sum())
        n_real = int(valid.sum())
        for name, kern, line, fn, plain_fn, lib, init_read, src in (
                ('window_scatter_grid', 'K13b', '407',
                 lambda: oc.scatter_windows(xw, idx, hw, 8, shift,
                                            zero_fill=True),
                 lambda: oc.scatter_windows_plain(xw, idx, hw, 8, shift),
                 lambda: torch.index_put(zeros, ind, sv), 0,
                 dict(closed_by='K2')),
                ('window_scatter_grid_into', 'K13c', '549',
                 lambda: oc.scatter_windows_into(xw, idx, init, hw, 8,
                                                 shift),
                 lambda: oc.scatter_windows_into_plain(xw, idx, init, hw, 8,
                                                       shift),
                 lambda: torch.index_put(init, ind, sv), uncovered, {})):
            got, want = fn(), plain_fn()
            torch.cuda.synchronize()
            if not same_bits(torch, got, want):
                raise AssertionError(f'{kern} (shift {shift}) differs from '
                                     'its plain version')
            if not same_bits(torch, lib(), want):
                raise AssertionError(f'{kern} library yardstick computes '
                                     'another function')
            if kern == 'K13c' and got.is_cuda and not got.is_contiguous():
                raise AssertionError('K13c gives a non-contiguous grid')
            if shift:
                continue
            entry(name, kern, 'tmae_tpu_torch/csrc/windows.cu',
                  f'tmae_tpu/ops/occ_compact.py:{line}', 0.0,
                  time_ms(torch, fn), time_ms(torch, plain_fn, iters=5),
                  n_real * 64 * C * 2 + (init_read + B * H * W) * C * 2
                  + idx.numel() * 4, 0, time_ms(torch, lib),
                  device_ms=device_ms(torch, fn), **src)
        g = torch.randn(y1.shape, device=y1.device).to(y1.dtype)
        grads = []
        for into in (oc.scatter_windows_into, oc.scatter_windows_into_plain):
            a, b = xw.clone().requires_grad_(), init.clone().requires_grad_()
            into(a, idx, b, hw, 8, shift).backward(g)
            grads.append((a.grad, b.grad))
        if not ((grads[0][1].is_contiguous() or not g.is_cuda)
                and all(same_bits(torch, u, v) for u, v in zip(*grads))):
            raise AssertionError(f'K13c VJP (shift {shift}) differs from the '
                                 'plain version\'s')
        msg = (f'  K13b, K13c (shift {shift}, cap {cap}, {n_real} real '
               'windows): bit-equal to their plain versions and to '
               'index_put, K13c contiguous, its VJP bit-equal')
        if not shift:
            drop = valid & (torch.arange(cap, device=y1.device) % 2 == 0)
            idx_d = idx.clone()
            idx_d[drop] = torch.tensor([(H + 7) // 8 + 1, 0],
                                       dtype=torch.int32, device=y1.device)
            got = oc.scatter_windows_into(xw, idx_d, init, hw, 8, shift)
            left = grid_cells(torch, idx, drop, hw, False)
            if not (same_bits(torch, got, oc.scatter_windows_into_plain(
                    xw, idx_d, init, hw, 8, shift))
                    and same_bits(torch, got[left], init[left])):
                raise AssertionError('K13c with windows left out of the plan '
                                     'differs, or moved their init')
            msg += (f'; {int(drop.sum())} occupied windows left out of the '
                    f'plan keep init\'s bits on their {int(left.sum())} cells')
        log(msg)


def sparse_attn_phase(torch, model, batch, rows):
    """Phase 5c on the served model and frame pair. Launch counters set to
    0, then the slice's path: the unpadded window API (gather, zero-fill
    scatter, scatter-into and their VJPs) on the stage-1 grid with the
    unshifted and shifted plans of every occupied window; SubMConvBlock
    with such an unshifted plan (K15, then K2 as K13b) in train mode,
    forward and backward, on the 6 captured conv_out inputs with each
    block's weights; DenseWindowAttention (K16) on the 4 cases of
    :func:`attention_cases`. The counts are held to
    ``EXPECTED_SPARSE_ATTN``, what came out to the plain versions, and the
    times of K13b, K13c, K15 and K16 go into the kernels line. Returns the
    counts."""
    import copy

    from tmae_tpu_torch.models import sst
    from tmae_tpu_torch.ops import occ_compact as oc
    from tmae_tpu_torch.ops import sparse_conv as sc
    from tmae_tpu_torch.ops import window_attention as wa

    dev = batch['points'].device
    entry = functools.partial(add_row, rows)
    caught = conv_out_inputs(torch, model, batch)
    log('  conv_out inputs: ' + ', '.join(
        f'{n} {tuple(y.shape)} ({int(o.sum())} occupied)'
        for n, _, y, o in caught))
    gen = torch.Generator(device=dev).manual_seed(5)
    randn = lambda *s, dt=torch.bfloat16: torch.randn(
        *s, generator=gen, device=dev).to(dt)
    y1, occ1 = caught[0][2:]
    wplans = [(shift, full_plan(oc, occ1, shift)) for shift in (False, True)]
    init = randn(*y1.shape)
    cots = [(randn(*y1.shape), randn(*y1.shape)) for _ in wplans]
    cplans = [full_plan(oc, o, False) for _, _, _, o in caught]
    biases = [0.1 * randn(blk.conv.weight.shape[0], dt=torch.float32)
              for _, blk, _, _ in caught]
    conv_g = [randn(*y.shape[:3], blk.conv.weight.shape[0], dt=torch.float32)
              for _, blk, y, _ in caught]
    train_blocks = [copy.deepcopy(blk).train() for _, blk, _, _ in caught]
    attn = attention_cases(torch, sst, caught, dev)

    def path():
        api = window_api_run(torch, oc, y1, init, wplans, cots)
        conv = [conv_block_run(torch, tb, y, o, (p.idx, p.qmask, 8), g)
                for tb, (_, _, y, o), p, g in zip(train_blocks, caught,
                                                  cplans, conv_g)]
        with torch.no_grad():
            att = [m(gr, kv) for _, m, gr, kv in attn]
        return api, conv, att

    (api, conv, att), launches = counted(torch, path)
    log(f'  launches on the path: {launches} (expected '
        f'{EXPECTED_SPARSE_ATTN})')
    if launches != EXPECTED_SPARSE_ATTN:
        raise AssertionError('launch counts differ from the slice path')
    window_api_check(torch, oc, y1, wplans, api, init, cots)
    del api
    conv_check(torch, sc, caught, cplans, biases, train_blocks, conv, conv_g,
               entry)
    del conv, train_blocks
    attention_check(torch, sst, wa, attn, att, gen, entry)
    scatter_rows(torch, oc, y1, init, wplans, entry)
    return launches


def waymo_serving(torch, cfg, profile=False):
    """t_mae_waymo.yaml served at full width on one synthetic frame pair
    (device voxelization, K10 in eval mode): first K10 against its plain
    version on the layer inputs an eval-mode forward of the pair hands it
    (every width, mode and shift; :func:`grid_check` without the backward);
    then served as :func:`serve_phase` serves it; then the detector on the
    card against the CPU at full width on a 64x64 grid. Returns the median
    ms per frame pair."""
    from tmae_tpu_torch.datasets.synthetic import frame_pair_batch
    from tmae_tpu_torch.models.detectors import (batch_to_device,
                                                 build_detector, init_random_,
                                                 make_voxel_spec,
                                                 num_point_features)

    spec = make_voxel_spec(cfg.DATA_CONFIG, cfg.RUNTIME)
    batch = batch_to_device(frame_pair_batch(
        spec, list(cfg.CLASS_NAMES), indices=(0,), host_voxelize=False,
        num_point_features=num_point_features(cfg)), 'cuda')
    model = init_random_(build_detector(cfg), seed=0)
    from tmae_tpu_torch.ops import encoder_layer as el

    calls = grid_layer_calls(torch, model, batch, 0, train=False)
    log(f'  K10 against its plain version on the eval-mode layer inputs of '
        f'this pair at full grid ({len(calls)} calls captured)')
    for key in sorted(calls):
        grid_check(torch, el, calls[key], None, None, False)
    del calls
    torch.cuda.empty_cache()
    _, med, _ = serve_phase(torch, cfg, model, batch, EXPECTED_WAYMO_SERVING,
                            WAYMO_REPS,
                            profile and 'profile_waymo_serving.txt')
    del model, batch
    log('  card vs CPU, full width on a 64x64 grid')
    card_vs_cpu(torch, *small_grid(cfg), seed=7)
    return med


def once_eval_phase(torch):
    """ONCE evaluation through the port's own entry point: the full-width
    t_mae_synth.yaml detector (t_mae.yaml's MODEL, batch 1) with seeded
    random weights saved by ``save_checkpoint``; ``tools/test.py``'s
    ``main`` on the card over ONCE_EVAL_SAMPLES synthetic frame pairs
    (``build_dataloader``, host voxelization in the prefetch thread),
    launch counters set to 0 just before it and read just after; then the
    checks: the native host ops built from the repository's source and
    loaded, the launch counts (ONCE_EVAL_SAMPLES x EXPECTED_LAUNCHES), each
    batch's native kept mask equal to the numpy NMS on the same candidates,
    the AP dict equal to the one recomputed with the numpy IoU and
    accumulators, result.pkl with one dict per frame in the dataset's
    order, every AP finite, occ_overflow 0. Returns its numbers."""
    import pickle

    import numpy as np

    from tmae_tpu_torch.config import cfg_from_yaml_file
    from tmae_tpu_torch.datasets.dataset import build_dataloader
    from tmae_tpu_torch.models.detectors import build_detector, init_random_
    from tmae_tpu_torch.tools import test as test_cli
    from tmae_tpu_torch.train import evaluator
    from tmae_tpu_torch.train.checkpoint import save_checkpoint
    from tmae_tpu_torch.utils import native

    cfg_file = ROOT / 'tools/cfgs/once_models/t_mae_synth.yaml'
    cfg = cfg_from_yaml_file(cfg_file)
    n_cfg = cfg.DATA_CONFIG.NUM_SYNTHETIC_SAMPLES
    log(f'  NUM_SYNTHETIC_SAMPLES cut from {n_cfg} to {ONCE_EVAL_SAMPLES} '
        'for time')
    cfg.DATA_CONFIG.NUM_SYNTHETIC_SAMPLES = ONCE_EVAL_SAMPLES
    # the checkpoint (~50 MB) goes to a temporary directory, result.pkl
    # and the config log to the output directory
    tmp = tempfile.TemporaryDirectory()
    ckpt = save_checkpoint(
        Path(tmp.name), init_random_(build_detector(cfg, 'cpu'), seed=0),
        None, 0)
    captured = []
    served_nms = evaluator.host_nms

    def recording(cfg, boxes, scores, labels, valid):
        keep = served_nms(cfg, boxes, scores, labels, valid)
        captured.append((boxes, scores, labels, valid, keep))
        return keep

    evaluator.host_nms = recording
    test_cli.OUTPUT_ROOT = OUT_DIR / 'once_eval'
    argv = ['--cfg_file', str(cfg_file), '--ckpt', str(ckpt), '--set',
            'DATA_CONFIG.NUM_SYNTHETIC_SAMPLES', str(ONCE_EVAL_SAMPLES)]
    log(f'  python -m tmae_tpu_torch.tools.test {" ".join(argv)}')
    t0 = time.perf_counter()
    try:
        results, launches = counted(torch, lambda: test_cli.main(argv))
    finally:
        evaluator.host_nms = served_nms
        tmp.cleanup()
    log(f'  main: {time.perf_counter() - t0:.1f} s')

    lib, targets = native.library_path(), native.build_targets()
    log(f'  native host ops: {lib.relative_to(ROOT)} built from '
        f'{native.SRC.relative_to(ROOT)} with g++ '
        f'{" ".join(targets.get(lib, ()))}')
    if (native.SRC != ROOT / 'tmae_tpu_torch/csrc/host_ops.cpp'
            or lib not in targets):
        raise AssertionError('the native host ops were not built from the '
                             'repository\'s source')

    want = {k: ONCE_EVAL_SAMPLES * v for k, v in EXPECTED_LAUNCHES.items()}
    log(f'  launches: {launches} (expected {want})')
    if launches != want:
        raise AssertionError('launch counts differ from the evaluation path')

    if len(captured) != ONCE_EVAL_SAMPLES:
        raise AssertionError(f'{len(captured)} batches went through host NMS')
    times = {'native': [], 'numpy': []}
    for i, (*cands, keep) in enumerate(captured):
        ms, kept = nms_split(cfg, cands)
        for path in times:
            times[path].append(ms[path])
        if not (np.array_equal(kept['native'], keep)
                and np.array_equal(kept['numpy'], keep)):
            raise AssertionError(f'batch {i}: native and numpy NMS keep '
                                 'different boxes')
        log(f'  batch {i}: {int(cands[3].sum())} candidates, '
            f'{int(keep.sum())} kept by both paths; host NMS native '
            f'{ms["native"]:.3f} ms, numpy {ms["numpy"]:.3f} ms')

    (result_dir, ap), = results.items()
    annos = pickle.loads((result_dir / 'result.pkl').read_bytes())
    ids = [a['frame_id'] for a in annos]
    dataset, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 1,
                                  False, runtime_cfg=cfg.RUNTIME)
    if ids != [f'synth_{i:06d}' for i in range(ONCE_EVAL_SAMPLES)]:
        raise AssertionError(f'result.pkl frame ids {ids}')
    ap_table, ap_numpy = dataset.evaluation(annos, cfg.CLASS_NAMES,
                                            native=False)
    log('  ' + ap_table.strip().replace('\n', '\n  '))
    aps = {k: v for k, v in ap.items() if k.startswith('AP_')}
    if aps != ap_numpy:
        raise AssertionError('AP differs from its numpy recomputation')
    if not all(math.isfinite(v) for v in aps.values()):
        raise AssertionError('an AP is not finite')
    if ap['occ_overflow'] != 0:
        raise AssertionError(f'occ_overflow {ap["occ_overflow"]}')
    out = {'once_eval_sec_per_sample': ap['sec_per_sample'],
           'once_eval_loader_ms_per_batch': ap['loader_ms_per_batch'],
           'once_eval_host_nms_ms_per_batch': ap['host_nms_ms_per_batch'],
           'host_nms_native_ms_per_pair': statistics.median(times['native']),
           'host_nms_numpy_ms_per_pair': statistics.median(times['numpy'])}
    log(f'  {len(annos)} frames in result.pkl, AP dict equal to the numpy '
        f'recomputation, occ_overflow 0; ' + ', '.join(
            f'{k} {v:.4f}' for k, v in out.items()))
    return out


def write_once_tree(root, cfg, n_frames):
    """A ONCE-layout tree of one sequence, ``000000``: ``n_frames`` sweeps
    of the port's synthetic LiDAR (density 1.5, ~97k points a frame; one
    scene per interval of SCAN_WINDOW frames, each frame its own sweep,
    identity poses) with the scene's labelled boxes, and the split files
    ``train``, ``val`` and ``raw_large`` (t_mae_ssl.yaml's) naming it.
    Returns the points of each frame."""
    import numpy as np

    from tmae_tpu_torch.datasets.synthetic import make_scene, render_lidar

    seq = '000000'
    lidar = root / 'data' / seq / 'lidar_roof'
    lidar.mkdir(parents=True)
    (root / 'ImageSets').mkdir()
    pc = list(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    window = int(cfg.DATA_CONFIG.SCAN_WINDOW)
    frames, n_points = [], []
    for fi in range(n_frames):
        scene = make_scene(fi // window, pc, list(cfg.CLASS_NAMES))
        pts = render_lidar(scene, np.random.RandomState(5000 + fi), pc)
        frame_id = f'{1000 + fi}'
        pts.astype(np.float32).tofile(lidar / f'{frame_id}.bin')
        n_points.append(len(pts))
        frames.append({'frame_id': frame_id, 'timestamp': fi,
                       'pose': [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0],
                       'annos': {'names': scene['names'].tolist(),
                                 'boxes_3d': scene['boxes'][:, :7].tolist()}})
    (root / 'data' / seq / f'{seq}.json').write_text(
        json.dumps({'frames': frames}))
    for split in ('train', 'val', 'raw_large'):
        (root / 'ImageSets' / f'{split}.txt').write_text(seq + '\n')
    return n_points


@contextlib.contextmanager
def cli_hooks(torch, record):
    """While open: each training step's launches (counter deltas, the
    counters are not reset) appended to ``record['steps']``, each
    post-train evaluation's to ``record['eval']``, and each pretrained
    transfer of the training CLI checked: every entry it copied equals the
    pretraining checkpoint's, every entry it kept (the BEV backbone and the
    head among them) kept its initial value, and only the VFE and the 3D
    backbone were copied."""
    from tmae_tpu_torch.tools import train as train_cli
    from tmae_tpu_torch.train import trainer

    def deltas(fn):
        ks = kernels()
        before = {n: k.launches for n, k in ks.items()}
        out = fn()
        return out, {n: k.launches - before[n] for n, k in ks.items()}

    step_call, eval_fn = trainer.TrainStep.__call__, train_cli.eval_one_epoch
    transfer = train_cli.load_pretrained_params

    def counted_step(self, batch, **kw):
        out, d = deltas(lambda: step_call(self, batch, **kw))
        record['steps'].append(d)
        return out

    def counted_eval(*a, **kw):
        out, d = deltas(lambda: eval_fn(*a, **kw))
        record['eval'].append(d)
        return out

    def checked_transfer(path, model):
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        copied, kept = transfer(path, model)
        src = torch.load(path, map_location='cpu', weights_only=True)['model']
        now = model.state_dict()
        differ = [k for k in copied if not torch.equal(now[k].cpu(), src[k])]
        moved = [k for k in kept if not torch.equal(now[k], init[k])]
        head = [k for k in now if k.startswith(('dense_head.',
                                                'backbone_2d.'))]
        log(f'  pretrained transfer: {len(copied)} entries copied (VFE and 3D '
            f'backbone), {len(kept)} kept at init ({len(head)} of the BEV '
            f'backbone and head); {len(differ)} copied entries differ from '
            f'the checkpoint, {len(moved)} kept entries moved')
        if (differ or moved or not copied or not set(head) <= set(kept)
                or not all(k.startswith(('vfe.', 'backbone_3d.'))
                           for k in copied)):
            raise AssertionError('the pretrained transfer copied or kept the '
                                 'wrong entries')
        record['transfers'].append((copied, kept))
        return copied, kept

    trainer.TrainStep.__call__ = counted_step
    train_cli.eval_one_epoch = counted_eval
    train_cli.load_pretrained_params = checked_transfer
    try:
        yield record
    finally:
        trainer.TrainStep.__call__ = step_call
        train_cli.eval_one_epoch = eval_fn
        train_cli.load_pretrained_params = transfer


def cli_run(torch, argv, expected, what, ref="phase 6/10's"):
    """``python -m tmae_tpu_torch.tools.train`` with ``argv`` in this
    process, launch counters set to 0 just before it and read just after;
    each step's launches against ``expected`` (those of ``ref``); the loss
    finite. Returns
    (the CLI's summary, the launches of the run, each step's, each
    evaluation's, the peak device memory in GiB)."""
    from tmae_tpu_torch.tools import train as train_cli

    log(f'  python -m tmae_tpu_torch.tools.train {" ".join(argv)}')
    record = {'steps': [], 'eval': [], 'transfers': []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with cli_hooks(torch, record):
        res, launches = counted(torch, lambda: train_cli.main(argv))
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = res['steps']
    log(f'  {what}: {time.perf_counter() - t0:.1f} s, {len(steps)} steps '
        f'from step {res["start_step"]} ({res["steps_per_epoch"]} a epoch); '
        f'launches {launches}')
    path_kernels = [k for k, v in expected.items() if v]
    for s, d in zip(steps, record['steps']):
        log(f'  step {s["step"]}: loss {s["loss"]:.5g}, grad_norm '
            f'{s["grad_norm"]:.5g}, lr {s["lr"]:.6g}, occ_overflow '
            f'{s["occ_overflow"]}, data {s["data_s"] * 1e3:.1f} ms, step '
            f'{s["step_s"] * 1e3:.1f} ms')
        if d == expected:
            log(f'    launches equal to {ref} {what} step')
        else:
            log(f'    launches {d}, not the synthetic batch\'s {expected}')
            if not all(d[k] > 0 for k in path_kernels):
                raise AssertionError(f'a kernel of the {what} path was not '
                                     'launched')
        if not math.isfinite(s['loss']):
            raise AssertionError(f'{what} loss is not finite')
    for e in res['epochs']:
        log(f'  epoch {e["epoch"]}: {e["steps"]} steps in '
            f'{e["seconds"] * 1e3:.1f} ms of wall time '
            f'({e["seconds"] * 1e3 / e["steps"]:.1f} ms a step, data '
            f'{e["data_s"] * 1e3:.1f} ms, fwd {e["fwd_s"] * 1e3:.1f} ms)')
    if len(record['steps']) != len(steps):
        raise AssertionError('steps ran outside the CLI\'s loop')
    return res, launches, record, peak


def cli_training_phase(torch):
    """Phase 14a: training through the port's CLIs at full width, on a
    ONCE-layout tree written here (ONCE_TREE_FRAMES synthetic LiDAR
    sweeps), everything written to a temporary directory: the port's
    ``create_once_infos`` (train, val, raw_large, the GT database);
    t_mae_ssl.yaml pretraining for 1 epoch; t_mae.yaml finetuning for 1
    epoch from the pretraining checkpoint (``--pretrained_model``, the
    transfer checked), with gt_sampling, flip, rotation and scaling; the
    same command with ``--epochs 2 --max_ckpt_save_num 1
    --num_epochs_to_eval 1``, which resumes from the newest checkpoint (the
    step continues, the first lr is the schedule's at that step, ``ckpt/``
    pruned to one file) and evaluates the trained model. Only DATA_PATH
    (``--set``) and the batch (``--batch_size``) differ from the configs.
    Returns its numbers."""
    import pickle

    import numpy as np

    from tmae_tpu_torch.config import cfg_from_yaml_file
    from tmae_tpu_torch.tools import create_once_infos as coi
    from tmae_tpu_torch.tools import train as train_cli
    from tmae_tpu_torch.train.optimization import build_optimizer

    cfgs = ROOT / 'tools/cfgs/once_models'
    ssl_file, ft_file = cfgs / 't_mae_ssl.yaml', cfgs / 't_mae.yaml'
    ft_cfg = cfg_from_yaml_file(ft_file)
    for f in (ssl_file, ft_file):
        n = cfg_from_yaml_file(f).OPTIMIZATION.BATCH_SIZE_PER_GPU
        log(f'  {f.name}: batch cut from {n} to {CLI_BATCH} for time')
    tmp = tempfile.TemporaryDirectory()
    saved_root = train_cli.OUTPUT_ROOT
    try:
        root = Path(tmp.name) / 'once'
        t0 = time.perf_counter()
        n_points = write_once_tree(root, ft_cfg, ONCE_TREE_FRAMES)
        log(f'  ONCE tree: {ONCE_TREE_FRAMES} frames of one sequence, '
            f'{min(n_points)}-{max(n_points)} points a frame '
            f'({time.perf_counter() - t0:.1f} s)')
        t0 = time.perf_counter()
        coi.main(['--data_path', str(root), '--splits', 'train', 'val',
                  'raw_large'])
        db = pickle.loads((root / 'once_dbinfos_train.pkl').read_bytes())
        log(f'  create_once_infos: {time.perf_counter() - t0:.1f} s; GT '
            'database ' + ', '.join(f'{k} {len(v)}' for k, v in db.items()))
        train_cli.OUTPUT_ROOT = Path(tmp.name) / 'output'
        common = ['--set', 'DATA_CONFIG.DATA_PATH', str(root),
                  '--batch_size', str(CLI_BATCH), '--fix_random_seed',
                  '--extra_tag', 'chip_smoke']

        pre, _, _, pre_peak = cli_run(
            torch, ['--cfg_file', str(ssl_file), '--epochs', '1'] + common,
            EXPECTED_PRETRAIN_BUCKETED, 'pretraining')
        pre_ckpt = pre['checkpoints'][-1]
        ft_argv = ['--cfg_file', str(ft_file), '--pretrained_model',
                   str(pre_ckpt)] + common
        ft, _, ft_rec, ft_peak = cli_run(
            torch, ft_argv + ['--epochs', '1'], EXPECTED_TRAIN_LAUNCHES,
            'training')
        if len(ft_rec['transfers']) != 1:
            raise AssertionError('the finetune run made no transfer')
        res, _, res_rec, res_peak = cli_run(
            torch, ft_argv + ['--epochs', '2', '--max_ckpt_save_num', '1',
                              '--num_epochs_to_eval', '1',
                              '--fixed_gap_eval', '1'],
            EXPECTED_TRAIN_LAUNCHES, 'training')

        spe = res['steps_per_epoch']
        lr_fn = build_optimizer([torch.zeros(1, requires_grad=True)],
                                dict(ft_cfg.OPTIMIZATION, NUM_EPOCHS=2),
                                spe)[1].lr
        first = res['steps'][0]
        names = [p.name for p in res['checkpoints']]
        log(f'  resumed at step {res["start_step"]}: first lr '
            f'{first["lr"]:.9g}, schedule {lr_fn(spe):.9g}; ckpt/ holds '
            f'{names}')
        if (res['start_step'] != spe or first['step'] != spe + 1
                or first['lr'] != lr_fn(spe)
                or names != [f'checkpoint_{2 * spe}.pth']):
            raise AssertionError('the run did not resume where the first '
                                 'finetune epoch ended')
        for r in (pre, ft, res):
            jsonl = r['out_dir'] / 'metrics.jsonl'
            if not jsonl.is_file() or not jsonl.read_text().strip():
                raise AssertionError(f'no metrics.jsonl in {r["out_dir"]}')

        ap = res['eval']
        (eval_launches,) = res_rec['eval']
        infos = pickle.loads((root / 'once_infos_val.pkl').read_bytes())
        window = int(ft_cfg.DATA_CONFIG.SCAN_WINDOW)
        want_ids = [i['frame_id'] for i in infos[window - 1::window]]
        annos = pickle.loads((res['out_dir'] / 'eval' / 'result.pkl')
                             .read_bytes())
        n_batches = math.ceil(len(want_ids) / CLI_BATCH)
        want = {k: n_batches * v for k, v in EXPECTED_LAUNCHES.items()}
        log(f'  evaluation: {len(annos)} frames, launches {eval_launches} '
            f'(expected {want}), occ_overflow {ap["occ_overflow"]}, '
            f'{ap["sec_per_sample"]:.4f} sec/sample, loader '
            f'{ap["loader_ms_per_batch"]:.1f} ms a batch')
        if [a['frame_id'] for a in annos] != want_ids:
            raise AssertionError(f'result.pkl frame ids '
                                 f'{[a["frame_id"] for a in annos]}')
        if eval_launches != want:
            raise AssertionError('launch counts differ from the evaluation '
                                 'path')
        aps = {k: v for k, v in ap.items() if k.startswith('AP_')}
        if not aps or not all(math.isfinite(v) for v in aps.values()):
            raise AssertionError('an AP is not finite')
    finally:
        train_cli.OUTPUT_ROOT = saved_root
        tmp.cleanup()

    def med(runs, key):
        return statistics.median(s[key] * 1e3 for r in runs
                                 for s in r['steps'])

    def wall(runs):
        es = [e for r in runs for e in r['epochs']]
        return sum(e['seconds'] for e in es) * 1e3 / sum(e['steps']
                                                         for e in es)

    out = {'cli_pretrain_ms_per_step': med([pre], 'step_s'),
           'cli_train_ms_per_step': med([ft, res], 'step_s'),
           'cli_pretrain_wall_ms_per_step': wall([pre]),
           'cli_train_wall_ms_per_step': wall([ft, res]),
           'cli_loader_ms_per_step': med([pre, ft, res], 'data_s'),
           'cli_peak_gib': max(pre_peak, ft_peak, res_peak),
           'cli_eval_sec_per_sample': ap['sec_per_sample'],
           'cli_occ_overflow': [s['occ_overflow'] for r in (pre, ft, res)
                                for s in r['steps']]}
    log(f'  {card_line()}: ' + ', '.join(f'{k} {v}' for k, v in out.items()))
    return out


def check_no_foreign_modules(what):
    """Of the repository, only the port and the two test modules of phase
    14b may be loaded: nothing of the JAX package, none of its tests."""
    foreign = sorted(m for m in sys.modules
                     if m.split('.')[0] == 'tmae_tpu' or (
                         m.startswith('tests.') and m not in (
                             'tests.once_fixture',
                             'tests.test_torch_port_overfit_ap')))
    if foreign:
        raise AssertionError(f'{what} loaded {foreign}')


def overfit_phase(torch):
    """Phase 14b: the overfit oracle of tests/test_overfit_ap.py through the
    port's CLIs on the card (``tests/test_torch_port_overfit_ap.run_overfit``:
    the raw fixture, pretraining, finetuning from it, ``tools.test``),
    launch counters set to 0 just before it and read just after; passes
    only if the max score and the Vehicle AP clear the oracle's thresholds
    and no window overflowed a cap. Returns its numbers."""
    # the repository's tests/ as the package ``tests``: a package of that
    # name installed on the machine would take the import before the
    # namespace package of tests/
    pkg = types.ModuleType('tests')
    pkg.__path__ = [str(ROOT / 'tests')]
    sys.modules['tests'] = pkg
    from tests.test_torch_port_overfit_ap import (SCORE_MIN, VEHICLE_AP_MIN,
                                                  run_overfit)
    check_no_foreign_modules('the overfit phase')

    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    try:
        res, launches = counted(torch, lambda: run_overfit(
            Path(tmp.name), log=lambda s: log(f'  {s}')))
    finally:
        tmp.cleanup()
    secs = time.perf_counter() - t0
    ft_steps = res['finetune']['steps']
    log('  ' + res['ap_str'].strip().replace('\n', '\n  '))
    log(f'  {secs:.1f} s; launches {launches}; finetune step median '
        f'{statistics.median(s["step_s"] for s in ft_steps) * 1e3:.1f} ms; '
        f'max score {res["max_score"]:.4f} (> {SCORE_MIN}), Vehicle AP '
        f'{res["vehicle_ap"]:.2f} (> {VEHICLE_AP_MIN}); occ_overflow '
        f'{max(res["occ_overflow"])} in training, '
        f'{res["eval"]["occ_overflow"]} in evaluation')
    if any(res['occ_overflow']) or res['eval']['occ_overflow']:
        raise AssertionError('an occupied window overflowed a cap')
    if not all(launches[k] > 0 for k in ('K1', 'K2', 'K3', 'K4', 'K6', 'K7',
                                         'K8', 'K9')):
        raise AssertionError('a kernel of the path was not launched')
    if not (res['max_score'] > SCORE_MIN
            and res['vehicle_ap'] > VEHICLE_AP_MIN):
        raise AssertionError('the overfit oracle did not reach its '
                             'thresholds')
    return {'overfit_max_score': res['max_score'],
            'overfit_vehicle_ap': res['vehicle_ap'],
            'overfit_seconds': secs,
            'overfit_ms_per_finetune_step': statistics.median(
                s['step_s'] * 1e3 for s in ft_steps)}


def waymo_tree(root, cfg):
    """A Waymo-layout tree of one sequence, ``seq_waymo``: WAYMO_SEQ_FRAMES
    frames of the port's synthetic top LiDAR (``synthetic.waymo_sequence``:
    64 x 2650 range images with pixel poses, a moving vehicle, labelled
    boxes) in ``raw/seq_waymo.tfrecord``, and the split files ``train`` and
    ``val`` naming it. Returns (the frames' in-range point counts, seconds
    to render and write them)."""
    from tmae_tpu_torch.datasets.synthetic import waymo_sequence
    from tmae_tpu_torch.datasets.waymo_decode import write_tfrecord

    (root / 'raw').mkdir(parents=True)
    (root / 'ImageSets').mkdir()
    for split in ('train', 'val'):
        (root / 'ImageSets' / f'{split}.txt').write_text('seq_waymo\n')
    t0 = time.perf_counter()
    frames, counts = waymo_sequence(
        0, WAYMO_SEQ_FRAMES, list(cfg.DATA_CONFIG.POINT_CLOUD_RANGE),
        list(cfg.CLASS_NAMES), 'seq_waymo')
    write_tfrecord(root / 'raw' / 'seq_waymo.tfrecord', frames)
    return counts, time.perf_counter() - t0


def labelled_detections(ds, seed=0):
    """One detection for each labelled box of each of ``ds``'s intervals
    (the last frame's labels, 'unknown' dropped), the centre moved by
    N(0, 0.1) m and a score drawn from U(0.2, 1): a result the evaluation
    must score above 0."""
    import numpy as np

    rng = np.random.RandomState(seed)
    det = []
    for itv in ds.intervals:
        annos = ds.infos[itv[1] - 1]['annos']
        keep = np.asarray(annos['name']) != 'unknown'
        boxes = np.asarray(annos['gt_boxes_lidar'])[keep][:, :7].astype(
            np.float64)
        boxes[:, :3] += rng.normal(0, 0.1, (len(boxes), 3))
        det.append({'name': np.asarray(annos['name'])[keep],
                    'score': rng.uniform(0.2, 1, len(boxes)),
                    'boxes_3d': boxes})
    return det


def waymo_cli_phase(torch):
    """Phase 15: Waymo through the port's CLIs, everything written to a
    temporary directory. 15a at full width: a synthetic Waymo TFRecord
    (``waymo_tree``); the port's ``create_waymo_infos`` (decode, infos,
    point files, GT database); t_mae_ssl_waymo.yaml pretraining for 1 epoch;
    t_mae_waymo.yaml finetuning for 1 epoch from that checkpoint (the
    transfer checked), then the same command with ``--epochs 2
    --max_ckpt_save_num 1``, which resumes; ``tools.test`` over the val
    split's pairs. Only DATA_PATH and the batch (CLI_BATCH) differ from the
    configs. Each run with the launch counters set to 0 just before it and
    read just after: each pretraining step's launches against phase 9's,
    each finetune step's against EXPECTED_FINETUNE_GRID, the evaluation's
    against a served Waymo pair's per batch; losses finite; occ_overflow
    0; result.pkl's frame ids in order; boxes kept, and every AP and APH
    finite and equal to its recomputation with the numpy IoU; then, since
    random weights after a few steps score 0 everywhere, detections made
    from the val pairs' own labels (centres moved by N(0, 0.1) m) through
    the dataset's evaluation, native and numpy alike: equal, every class's
    AP above 0; the prediction file of ``create_prediction_files`` written
    and equal to result.pkl.
    15b: one t_mae_waymo.yaml finetune step on the card and on the CPU at
    full width on a 64x64 grid, on a batch of the loader over the same
    tree, held to the control as phase 7 holds it. Returns its numbers."""
    import copy
    import pickle

    import numpy as np

    from tmae_tpu_torch.config import cfg_from_yaml_file
    from tmae_tpu_torch.datasets.dataset import build_dataloader
    from tmae_tpu_torch.tools import create_waymo_infos as cwi
    from tmae_tpu_torch.tools import test as test_cli
    from tmae_tpu_torch.tools import train as train_cli
    from tmae_tpu_torch.train.optimization import build_optimizer

    cfgs = ROOT / 'tools/cfgs/waymo_models'
    ssl_file, ft_file = cfgs / 't_mae_ssl_waymo.yaml', cfgs / 't_mae_waymo.yaml'
    ft_cfg = cfg_from_yaml_file(ft_file)
    for f in (ssl_file, ft_file):
        n = cfg_from_yaml_file(f).OPTIMIZATION.BATCH_SIZE_PER_GPU
        log(f'  {f.name}: batch cut from {n} to {CLI_BATCH} for time')
    tmp = tempfile.TemporaryDirectory()
    saved = train_cli.OUTPUT_ROOT, test_cli.OUTPUT_ROOT
    decode = cwi.decode_tfrecord_sequence
    try:
        root = Path(tmp.name) / 'waymo'
        counts, write_s = waymo_tree(root, ft_cfg)
        log(f'  Waymo TFRecord: {WAYMO_SEQ_FRAMES} frames of one sequence, '
            f'{min(counts)}-{max(counts)} points in range a frame (the '
            f'range image 64 x 2650); rendered and written in {write_s:.1f} '
            f's ({write_s * 1e3 / WAYMO_SEQ_FRAMES:.0f} ms a frame)')
        if not all(100000 <= n < int(ft_cfg.RUNTIME.MAX_POINTS)
                   for n in counts):
            raise AssertionError('a frame is outside 100k points to '
                                 'RUNTIME.MAX_POINTS')
        decoded = []

        def timed_decode(path, backend='native'):
            t0 = time.perf_counter()
            frames = decode(path, backend)
            decoded.append((len(frames), time.perf_counter() - t0))
            return frames

        cwi.decode_tfrecord_sequence = timed_decode
        t0 = time.perf_counter()
        written = cwi.main(['--raw_dir', str(root / 'raw'), '--out_dir',
                            str(root / 'waymo_processed_data'), '--splits',
                            'train', 'val', '--with_gt_database'])
        infos_s = time.perf_counter() - t0
        cwi.decode_tfrecord_sequence = decode
        decode_ms = (sum(s for _, s in decoded) * 1e3
                     / sum(n for n, _ in decoded))
        db = pickle.loads((root / 'waymo_dbinfos_train.pkl').read_bytes())
        log(f'  create_waymo_infos: {infos_s:.1f} s ({len(written["train"])} '
            f'train, {len(written["val"])} val frame infos); decode '
            f'{decode_ms:.1f} ms a frame; GT database '
            + ', '.join(f'{k} {len(v)}' for k, v in db.items()))

        out_root = Path(tmp.name) / 'output'
        train_cli.OUTPUT_ROOT = test_cli.OUTPUT_ROOT = out_root
        common = ['--set', 'DATA_CONFIG.DATA_PATH', str(root),
                  '--batch_size', str(CLI_BATCH), '--fix_random_seed',
                  '--extra_tag', 'chip_smoke']
        pre, _, _, pre_peak = cli_run(
            torch, ['--cfg_file', str(ssl_file), '--epochs', '1'] + common,
            EXPECTED_PRETRAIN_GRID, 'pretraining', "phase 9's")
        ft_argv = ['--cfg_file', str(ft_file), '--pretrained_model',
                   str(pre['checkpoints'][-1])] + common
        ft, _, ft_rec, ft_peak = cli_run(
            torch, ft_argv + ['--epochs', '1'], EXPECTED_FINETUNE_GRID,
            'finetuning', 'the expected')
        if len(ft_rec['transfers']) != 1:
            raise AssertionError('the finetune run made no transfer')
        res, _, _, res_peak = cli_run(
            torch, ft_argv + ['--epochs', '2', '--max_ckpt_save_num', '1'],
            EXPECTED_FINETUNE_GRID, 'finetuning', 'the expected')
        spe = res['steps_per_epoch']
        lr_fn = build_optimizer([torch.zeros(1, requires_grad=True)],
                                dict(ft_cfg.OPTIMIZATION, NUM_EPOCHS=2),
                                spe)[1].lr
        names = [p.name for p in res['checkpoints']]
        log(f'  resumed at step {res["start_step"]}: first lr '
            f'{res["steps"][0]["lr"]:.9g}, schedule {lr_fn(spe):.9g}; '
            f'ckpt/ holds {names}')
        if (res['start_step'] != spe or res['steps'][0]['step'] != spe + 1
                or res['steps'][0]['lr'] != lr_fn(spe)
                or names != [f'checkpoint_{2 * spe}.pth']):
            raise AssertionError('the run did not resume where the first '
                                 'finetune epoch ended')

        keys = [f'{c}/L{lv}/{m}' for c in ft_cfg.CLASS_NAMES
                for lv in (1, 2) for m in ('AP', 'APH')]
        eval_cfg = copy.deepcopy(ft_cfg.DATA_CONFIG)
        eval_cfg.DATA_PATH = str(root)
        ds, _ = build_dataloader(eval_cfg, ft_cfg.CLASS_NAMES, CLI_BATCH,
                                 training=False)
        window = int(ft_cfg.DATA_CONFIG.SCAN_WINDOW)
        want_ids = [i['frame_id'] for i in written['val'][window - 1::window]]
        n_batches = math.ceil(len(want_ids) / CLI_BATCH)
        want = {k: n_batches * v for k, v in EXPECTED_WAYMO_SERVING.items()}
        argv = ['--cfg_file', str(ft_file), '--set', 'DATA_CONFIG.DATA_PATH',
                str(root), '--batch_size', str(CLI_BATCH), '--extra_tag',
                'chip_smoke', '--ckpt', str(res['checkpoints'][-1])]
        log(f'  python -m tmae_tpu_torch.tools.test {" ".join(argv)}')
        t0 = time.perf_counter()
        results, launches = counted(torch, lambda: test_cli.main(argv))
        eval_s = time.perf_counter() - t0
        (result_dir, ap), = results.items()
        annos = pickle.loads((result_dir / 'result.pkl').read_bytes())
        kept = sum(len(a['name']) for a in annos)
        log(f'  evaluation: {len(annos)} frames in {eval_s:.1f} s, launches '
            f'{launches} (expected {want}), occ_overflow '
            f'{ap["occ_overflow"]}, {ap["sec_per_sample"]:.4f} sec/sample, '
            f'loader {ap["loader_ms_per_batch"]:.1f} ms a batch, {kept} '
            'boxes kept')
        if [a['frame_id'] for a in annos] != want_ids:
            raise AssertionError(f'result.pkl frame ids '
                                 f'{[a["frame_id"] for a in annos]}')
        if launches != want:
            raise AssertionError('launch counts differ from the Waymo '
                                 'serving path')
        pred_file = ds.create_prediction_files(annos, result_dir / 'waymo')
        dumped = pickle.loads(pred_file.read_bytes())
        if len(dumped) != len(annos) or any(
                a.keys() != b.keys()
                or not all(np.array_equal(a[k], b[k]) for k in a)
                for a, b in zip(dumped, annos)):
            raise AssertionError('the Waymo prediction file differs from '
                                 'result.pkl')
        if not kept:  # the recomputation below must match boxes
            raise AssertionError('the evaluation kept no box')
        t0 = time.perf_counter()
        table, again = ds.evaluation(annos, list(ft_cfg.CLASS_NAMES),
                                     native=False)
        log(f'  AP/APH recomputed with the numpy IoU in '
            f'{time.perf_counter() - t0:.1f} s:'
            + table.rstrip().replace('\n', '\n  '))
        if not all(math.isfinite(ap[k]) for k in keys):
            raise AssertionError('an AP or APH is not finite')
        if any(again[k] != ap[k] for k in keys):
            raise AssertionError('AP/APH differ from the numpy '
                                 'recomputation')
        if ap['occ_overflow'] or any(s['occ_overflow'] for r in (pre, ft, res)
                                     for s in r['steps']):
            raise AssertionError('an occupied window overflowed')
        labelled = labelled_detections(ds)
        t0 = time.perf_counter()
        label_ap = ds.evaluation(copy.deepcopy(labelled),
                                 list(ft_cfg.CLASS_NAMES))[1]
        label_s = time.perf_counter() - t0
        label_np = ds.evaluation(labelled, list(ft_cfg.CLASS_NAMES),
                                 native=False)[1]
        present = sorted({str(n) for d in labelled for n in d['name']})
        log(f'  AP/APH of the val pairs\' labels, centres moved by '
            f'N(0, 0.1) m ({sum(len(d["name"]) for d in labelled)} boxes '
            f'of {present}), native in {label_s:.1f} s: '
            + ', '.join(f'{k} {label_ap[k]:.4f}' for k in keys))
        if any(label_np[k] != label_ap[k] for k in keys):
            raise AssertionError('AP/APH of the labelled detections differ '
                                 'between the native and numpy IoU')
        if not present or any(not label_ap[f'{c}/L1/AP'] > 0
                               for c in present):
            raise AssertionError('a class with labels scored no AP')

        log('  15b: one t_mae_waymo.yaml finetune step, card vs CPU, full '
            'width on a 64x64 grid, on a loader batch of this tree')
        small, _ = small_grid(ft_cfg)
        small.DATA_CONFIG.DATA_PATH = str(root)
        _, loader = build_dataloader(small.DATA_CONFIG, small.CLASS_NAMES,
                                     CLI_BATCH, training=True,
                                     runtime_cfg=small.RUNTIME, seed=3)
        np_batch = {k: v for k, v in next(iter(loader)).items()
                    if k != 'frame_id'}
        log(f'  batch: {int(np_batch["point_mask"].sum())} current-frame '
            f'points, {int(np_batch["gt_mask"].sum())} boxes, '
            f'{np_batch["points"].shape[-1]} point features')
        train_card_vs_cpu(torch, small, np_batch, seed=7)
    finally:
        cwi.decode_tfrecord_sequence = decode
        train_cli.OUTPUT_ROOT, test_cli.OUTPUT_ROOT = saved
        tmp.cleanup()
    check_no_foreign_modules('the Waymo phase')

    def med(runs, key):
        return statistics.median(s[key] * 1e3 for r in runs
                                 for s in r['steps'])

    out = {'waymo_points_per_frame': counts,
           'waymo_write_ms_per_frame': write_s * 1e3 / WAYMO_SEQ_FRAMES,
           'waymo_decode_ms_per_frame': decode_ms,
           'waymo_infos_s': infos_s,
           'waymo_cli_pretrain_ms_per_step': med([pre], 'step_s'),
           'waymo_cli_finetune_ms_per_step': med([ft, res], 'step_s'),
           'waymo_cli_loader_ms_per_step': med([pre, ft, res], 'data_s'),
           'waymo_cli_peak_gib': max(pre_peak, ft_peak, res_peak),
           'waymo_eval_sec_per_sample': ap['sec_per_sample'],
           'waymo_eval_loader_ms_per_batch': ap['loader_ms_per_batch'],
           'waymo_eval_s': eval_s, 'waymo_eval_boxes_kept': kept,
           'waymo_ap': {k: float(ap[k]) for k in keys},
           'waymo_label_ap': {k: float(label_ap[k]) for k in keys}}
    log(f'  {card_line()}: ' + ', '.join(f'{k} {v}' for k, v in out.items()))
    return out


# ---------------------------------------------------------------------------
# phase 16: device IoU and NMS (csrc/iou_nms.cu), the IoU head with
# multi-class NMS, the asymmetric encoder modes and the eval_asym /
# --fuse_conv_bn CLIs
# ---------------------------------------------------------------------------

GEOMETRY_SRC = 'tmae_tpu_torch/csrc/iou_nms.cu'
IOU_TOL = 1e-5                 # IoU kernel vs plain; an NMS flip's margin
MULTI_NMS = {'NMS_TYPE': 'multi_class_nms',
             'IOU_RECTIFIER': [0.68, 0.71, 0.65, 0.65, 0.68],
             'NMS_THRESH': [0.7, 0.6, 0.55, 0.55, 0.55],
             'NMS_PRE_MAXSIZE': [4096] * 5, 'NMS_POST_MAXSIZE': [500] * 5}
# folded vs unfused head maps, max and mean |diff|: the bf16 rounding of the
# scaled weights, about half of these on t_mae_synth.yaml's model (PERF.md)
FUSED_MAP_TOL = (0.1, 5e-3)
FUSED_SCORE_TOL = 0.01         # a box cut at the other run's boundary


def first_flips(torch, geo, boxes, got, want, labels, threshs, what):
    """Where two keep masks of the same score-sorted candidates differ:
    for each sample (and class, with labels), the first differing row and
    the distance of its IoU with the rows kept before it (by either mask)
    from the threshold, the smallest over those rows; later differences
    follow from the first. Prints each; fails unless every distance is
    under IOU_TOL. Returns the number of differing rows."""
    diff = (got != want).nonzero().tolist()
    firsts = {}
    for b, i in diff:
        c = int(labels[b, i]) - 1 if labels is not None else 0
        firsts.setdefault((b, c), i)
    for (b, c), i in sorted(firsts.items()):
        before = (got[b, :i] | want[b, :i])
        if labels is not None:
            before &= labels[b, :i] == c + 1
        th = threshs[c]
        if before.any():
            iou = geo.boxes_iou_bev_plain(boxes[b, i:i + 1, :7],
                                          boxes[b, :i][before][:, :7])[0]
            dist = float((iou - th).abs().min())
        else:
            dist = float('inf')
        log(f'    {what}: sample {b} class {c + 1} row {i} flips; its IoU '
            f'is {dist:.3g} from the threshold {th}')
        if dist >= IOU_TOL:
            raise AssertionError(f'{what}: a flip {dist:.3g} from the '
                                 'threshold')
    return len(diff)


def mask_flips(torch, geo, boxes, valid, labels, threshs, what):
    """``NMS_MASK`` against :func:`nms_mask_plain`: each flipped bit with
    its IoU's distance from the threshold (must be under IOU_TOL). Returns
    the kernel's packed mask."""
    K = valid.shape[1]
    bits = geo.nms_mask_bits(boxes, valid, threshs, labels)
    got = geo.unpack_mask(bits, K)
    want = geo.nms_mask_plain(boxes, valid, labels, threshs)
    flips = (got != want).nonzero().tolist()
    worst = 0.0
    for b, i, j in flips:
        c = int(labels[b, i]) - 1 if labels is not None else 0
        iou = float(geo.boxes_iou_bev_plain(boxes[b, i:i + 1, :7],
                                            boxes[b, j:j + 1, :7])[0, 0])
        worst = max(worst, abs(iou - threshs[c]))
        log(f'    {what}: bit ({i}, {j}) flips, IoU {iou:.7f} against '
            f'{threshs[c]}')
    log(f'  {what}: NMS_MASK {int(want.sum())} bits set of '
        f'{want.numel()}, {len(flips)} flipped (worst {worst:.3g} from the '
        'threshold)')
    if worst >= IOU_TOL:
        raise AssertionError(f'{what}: NMS_MASK flips a bit {worst:.3g} from '
                             'the threshold')
    return bits


def greedy_plain(torch, geo, boxes, valid, labels, threshs, posts):
    """The JAX package's greedy NMS per sample (per class: on the class's
    own candidates, in order), on the plain IoU."""
    keep = torch.zeros_like(valid)
    for b in range(valid.shape[0]):
        for c, (th, po) in enumerate(zip(threshs, posts)):
            sel = valid[b] if labels is None else valid[b] & (
                labels[b] == c + 1)
            idx = sel.nonzero()[:, 0]
            if len(idx):
                keep[b, idx] = geo.nms_bev_mask_plain(
                    boxes[b, idx, :7], torch.ones_like(idx, dtype=torch.bool),
                    th, po)
    return keep


def nms_case(torch, geo, boxes, valid, labels, threshs, posts, what):
    """NMS_MASK and NMS_SCAN on one candidate set: the mask bit for bit
    against the plain relation (flips only within IOU_TOL of the
    threshold), the scan exactly against the plain scan of the kernel's
    own mask, the keep mask against the plain greedy NMS (equal, or flips
    explained by the mask's). Returns the kernel's packed mask."""
    bits = mask_flips(torch, geo, boxes, valid, labels, threshs, what)
    K = valid.shape[1]
    keep = geo.nms_keep(boxes, valid, threshs if labels is not None
                        else threshs[0], posts if labels is not None
                        else posts[0], labels=labels)
    scan = geo.nms_scan_bits(bits, valid, posts, labels)
    plain_scan = geo.nms_scan_plain(geo.unpack_mask(bits, K), valid, labels,
                                    posts)
    if not (torch.equal(scan, plain_scan) and torch.equal(scan, keep)):
        raise AssertionError(f'{what}: NMS_SCAN differs from its plain '
                             'version on the kernel\'s mask')
    want = greedy_plain(torch, geo, boxes, valid, labels, threshs, posts)
    n = first_flips(torch, geo, boxes, keep, want, labels, threshs, what)
    log(f'  {what}: kept {int(keep.sum())} of {int(valid.sum())} valid; '
        f'NMS_SCAN equal to its plain version on the same mask; {n} rows '
        'differ from the plain greedy NMS')
    return bits


def scan_random_check(torch, geo):
    """NMS_SCAN on arbitrary masks (bits anywhere, classes mixed), K = 65,
    2100 and 5000 (one, two and three removed words a lane), B = 2, five
    classes with caps [120, 40, 10, 3, 0], a tenth of the rows invalid and
    labels -1, 0 and 6 among them: the keep mask equal to nms_scan_plain's
    exactly."""
    g = torch.Generator().manual_seed(16)
    caps = [120, 40, 10, 3, 0]
    for K in (65, 2100, 5000):
        sup = (torch.rand(2, K, K, generator=g) < 6.0 / K).cuda()
        W = -(-K // 64)
        pad = torch.zeros(2, K, W * 64, dtype=torch.int64, device='cuda')
        pad[..., :K] = sup.long()
        bit = torch.arange(64, device='cuda')
        words = (pad.view(2, K, W, 64) << bit).sum(-1)  # wraps as uint64
        valid = (torch.rand(2, K, generator=g) > 0.1).cuda()
        labels = torch.where(torch.rand(2, K, generator=g) < 0.85,
                             torch.randint(1, 6, (2, K), generator=g),
                             torch.randint(-1, 7, (2, K), generator=g))
        labels = labels.int().cuda()
        if not torch.equal(geo.unpack_mask(words, K), sup):
            raise AssertionError('scan check: the packed mask is wrong')
        got = geo.nms_scan_bits(words, valid, caps, labels)
        want = geo.nms_scan_plain(sup, valid, labels, caps)
        if not torch.equal(got, want):
            raise AssertionError(f'NMS_SCAN differs from nms_scan_plain on '
                                 f'an arbitrary mask, K = {K}')
        log(f'  NMS_SCAN on an arbitrary mask, K = {K}, B = 2, five '
            f'classes with caps {caps}: {int(want.sum())} of '
            f'{int(valid.sum())} kept, equal to nms_scan_plain')


def clips_needed(torch, geo, boxes, valid, labels, threshs):
    """The pairs j > i that NMS_MASK clips: both take part, one class, and
    circumscribed circles that may meet (the kernel's test, in f32 torch
    ops; a negative threshold clips every pair of its class). Summed over
    the samples."""
    n = 0
    ncls = len(threshs)
    th = torch.tensor(threshs, device=boxes.device)
    for b in range(valid.shape[0]):
        x = boxes[b, :, :7].float()
        if labels is None:
            cls = torch.where(valid[b], 0, -1)
        else:
            lab = labels[b].long()
            cls = torch.where(valid[b] & (lab >= 1) & (lab <= ncls), lab - 1,
                              -1)
        rad = 0.5 * torch.sqrt(x[:, 3] * x[:, 3] + x[:, 4] * x[:, 4])
        dx = x[:, None, 0] - x[None, :, 0]
        dy = x[:, None, 1] - x[None, :, 1]
        scale = (x[:, None, 0].abs() + x[:, None, 1].abs()
                 + x[None, :, 0].abs() + x[None, :, 1].abs() + rad[:, None]
                 + rad[None, :])
        reach = (rad[:, None] + rad[None, :] + geo.SKIP_ABS
                 + geo.SKIP_REL * scale)
        apart = (dx * dx + dy * dy > reach * reach) & (
            th[cls.clamp(min=0)] >= 0)[:, None]
        same = (cls[:, None] == cls[None, :]) & (cls[:, None] >= 0)
        n += int((same & ~apart).triu(1).sum())
    return n


def nms_fresh_process(torch, cfg, served, parent):
    """``python3 -m tmae_tpu_torch.utils.nms_phases`` in a process of its
    own, on the served candidates (written to the output directory) with
    the config's nms_gpu threshold and cap, and with ``parent``'s
    iou_nms.cu beside this one when given. Logs its lines; returns its
    readings by set."""
    nms = cfg.MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG
    boxes, _, valid = served
    cands = OUT_DIR / 'served_candidates.pt'
    torch.save({'boxes': boxes[..., :7].float().cpu(), 'valid': valid.cpu(),
                'thresh': float(nms['NMS_THRESH']),
                'post': int(nms['NMS_POST_MAXSIZE'])}, cands)
    out = OUT_DIR / 'nms_phases.json'
    cmd = [sys.executable, '-m', 'tmae_tpu_torch.utils.nms_phases',
           '--candidates', str(cands), '--json', str(out)]
    if parent:
        cmd += ['--parent', str(parent)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    for line in proc.stdout.splitlines()[:-1]:
        log(line)
    if proc.returncode != 0:
        raise AssertionError('nms_phases failed:\n' + proc.stdout[-4000:]
                             + proc.stderr[-4000:])
    log(f'  nms_phases in its own process: {time.perf_counter() - t0:.1f} s')
    return json.loads(out.read_text())


def fresh_row_keys(fresh, kernel):
    """A kernels-line row's readings of ``kernel`` from the fresh process:
    the served candidates' device ms by launch, host enqueue ms and events
    ms, every set's device ms, and the parent's where it ran."""
    served = fresh['served K=500']
    out = {}
    for v in ('change', 'parent'):
        if v not in served:
            continue
        r = served[v][kernel]
        pre = '' if v == 'change' else 'parent_'
        out.update({f'{pre}device_ms': r['device_ms'],
                    f'{pre}by_launch': r['by_launch'],
                    f'{pre}host_ms': r['host_ms'],
                    f'{pre}events_ms_fresh': r['ms'],
                    f'{pre}device_ms_by_set': {
                        name: rs[v][kernel]['device_ms']
                        for name, rs in fresh.items() if v in rs}})
    return out


def geometry_phase(torch, served, host_ms, rows, fresh):
    """16a: IOU_PAIRS, IOU_ALIGNED, NMS_MASK and NMS_SCAN against their
    plain versions on the served pair's 500 candidates (``served``: boxes,
    labels, valid) and on a crowded synthetic set, for nms_gpu at 0.5 and
    multi_class_nms at MULTI_NMS's thresholds; NMS_MASK and NMS_SCAN also
    on nms_phases' sets of K = 1, 77 and 2100 (B = 2, with and without
    classes and caps); their times and bounds (``host_ms``: native host
    NMS of the served candidates; ``fresh``: nms_phases' readings).
    Returns the launches of IOU_PAIRS's path (one BEV and one 3D call)."""
    from tmae_tpu_torch.ops import geometry as geo
    from tmae_tpu_torch.utils import nms_phases

    cases = {'served pair': served,
             'crowded set': nms_phases.crowded_boxes(torch)}
    th_multi = [float(t) for t in MULTI_NMS['NMS_THRESH']]
    posts_multi = [int(p) for p in MULTI_NMS['NMS_POST_MAXSIZE']]
    for what, (boxes, labels, valid) in cases.items():
        b = boxes[0, :, :7].contiguous()
        for fn in ('boxes_iou_bev', 'boxes_iou3d'):
            err = float((getattr(geo, fn)(b, b) - getattr(
                geo, f'{fn}_plain')(b, b)).abs().max())
            log(f'  {what}: {fn} {b.shape[0]}x{b.shape[0]} max |kernel - '
                f'plain| {err:.3g}')
            if not err <= IOU_TOL:
                raise AssertionError(f'{what}: {fn} differs from its plain '
                                     'version')
        shifted = b + torch.tensor([0.4, -0.3, 0.2, 0.3, -0.2, 0.1, 0.5],
                                   device=b.device)
        err = float((geo.boxes_iou3d_aligned(b, shifted)
                     - geo.boxes_iou3d_aligned_plain(b, shifted)).abs().max())
        log(f'  {what}: boxes_iou3d_aligned max |kernel - plain| {err:.3g}')
        if not err <= IOU_TOL:
            raise AssertionError(f'{what}: boxes_iou3d_aligned differs')
        nms_case(torch, geo, boxes, valid, None, [0.5], [500],
                 f'{what}, nms_gpu 0.5')
        nms_case(torch, geo, boxes, valid, labels, th_multi, posts_multi,
                 f'{what}, multi_class_nms')
    for what, (boxes, labels, valid, threshs, posts) in nms_phases.cases(
            torch).items():
        if what.startswith('K='):
            nms_case(torch, geo, boxes, valid, labels, threshs, posts, what)
            clips = clips_needed(torch, geo, boxes, valid, labels, threshs)
            log(f'  {what}: NMS_MASK clips {clips} pairs')

    scan_random_check(torch, geo)

    boxes, labels, valid = served
    b = boxes[0, :, :7].contiguous()
    K = valid.shape[1]
    bits = geo.nms_mask_bits(boxes, valid, [0.5])
    mask_err = float((geo.unpack_mask(bits, K) != geo.nms_mask_plain(
        boxes, valid, None, [0.5])).any())
    scan_err = float((geo.nms_scan_bits(bits, valid, [500])
                      != geo.nms_scan_plain(geo.unpack_mask(bits, K), valid,
                                            None, [500])).any())
    _, launches = counted(torch, lambda: (geo.boxes_iou_bev(b, b),
                                          geo.boxes_iou3d(b, b)))
    log(f'  IOU_PAIRS path (one BEV, one 3D call): {launches["IOU_PAIRS"]} '
        'launches')
    live = valid[0]
    n = int(live.sum())
    pairs = n * (n - 1) // 2
    clips = clips_needed(torch, geo, boxes, valid, None, [0.5])
    log(f'  served pair, nms_gpu 0.5: NMS_MASK clips {clips} of {pairs} '
        'pairs')
    box_bytes = K * 7 * 4
    mask_bytes = K * (-(-K // 64)) * 8
    shifted = b + 0.3
    timed = {name: launch_times(torch, name, call) for name, call in (
        ('IOU_PAIRS', lambda: geo.boxes_iou_bev(b, b)),
        ('IOU_ALIGNED', lambda: geo.boxes_iou3d_aligned(b, shifted)))}
    add_row(rows, 'iou_pairs', 'IOU_PAIRS', GEOMETRY_SRC,
            'tmae_tpu/ops/geometry.py:159 boxes_iou_bev (plain JAX)',
            float((geo.boxes_iou_bev(b, b)
                   - geo.boxes_iou_bev_plain(b, b)).abs().max()),
            time_ms(torch, lambda: geo.boxes_iou_bev(b, b)),
            time_ms(torch, lambda: geo.boxes_iou_bev_plain(b, b), iters=5),
            2 * box_bytes + K * K * 4, K * K * geo.PAIR_CLIP_FLOPS, None,
            peak=F32_FLOPS, **timed['IOU_PAIRS'])
    add_row(rows, 'iou_aligned', 'IOU_ALIGNED', GEOMETRY_SRC,
            'tmae_tpu/ops/geometry.py:179 boxes_iou3d_aligned (plain JAX)',
            float((geo.boxes_iou3d_aligned(b, shifted)
                   - geo.boxes_iou3d_aligned_plain(b, shifted)).abs().max()),
            time_ms(torch, lambda: geo.boxes_iou3d_aligned(b, shifted)),
            time_ms(torch, lambda: geo.boxes_iou3d_aligned_plain(b, shifted),
                    iters=5),
            2 * box_bytes + K * 4, K * geo.PAIR_CLIP_FLOPS, None,
            peak=F32_FLOPS, **timed['IOU_ALIGNED'])
    # the bound counts the clips this data needs (pairs whose circles may
    # meet); bound_all_pairs_ms, every pair of valid boxes
    add_row(rows, 'nms_mask', 'NMS_MASK', GEOMETRY_SRC,
            'tmae_tpu/ops/geometry.py:199 nms_bev_mask (plain JAX)', mask_err,
            time_ms(torch, lambda: geo.nms_mask_bits(boxes, valid, [0.5])),
            time_ms(torch, lambda: geo.nms_mask_plain(boxes, valid, None,
                                                      [0.5]), iters=3),
            box_bytes + K + mask_bytes, clips * geo.PAIR_CLIP_FLOPS, None,
            peak=F32_FLOPS, host_native_ms=host_ms, valid=n, clips=clips,
            pairs=pairs, bound_all_pairs_ms=bound_ms(
                box_bytes + K + mask_bytes, pairs * geo.PAIR_CLIP_FLOPS,
                F32_FLOPS)[0], **fresh_row_keys(fresh, 'NMS_MASK'))
    add_row(rows, 'nms_scan', 'NMS_SCAN', GEOMETRY_SRC,
            'tmae_tpu/ops/geometry.py:199 nms_bev_mask (plain JAX)', scan_err,
            time_ms(torch, lambda: geo.nms_scan_bits(bits, valid, [500])),
            time_ms(torch, lambda: geo.nms_scan_plain(
                geo.unpack_mask(bits, K), valid, None, [500]), iters=3),
            mask_bytes + 2 * K, 0, None, peak=F32_FLOPS,
            host_native_ms=host_ms, **fresh_row_keys(fresh, 'NMS_SCAN'))
    return launches


def serve_device_nms(torch, cfg, model, batch):
    """One served pair with device NMS: forward, decode and NMS on the
    card, the kept boxes copied to the host."""
    from tmae_tpu_torch.models.detectors import centerpoint_predict

    with torch.no_grad():
        out = model(batch)
        boxes, scores, labels, valid = centerpoint_predict(cfg, out)
        return out, (boxes, scores, labels, valid, valid.cpu())


def device_vs_host(torch, cfg, out, dev_valid, what):
    """The device NMS's kept set against the native host NMS on the same
    candidates (flips only within IOU_TOL of the threshold). Returns the
    candidates (on the card) and the host's kept mask."""
    from tmae_tpu_torch.models.detectors import centerpoint_predict, host_nms
    from tmae_tpu_torch.ops import geometry as geo

    cands = centerpoint_predict(cfg, out, nms_on_device=False)
    host = torch.from_numpy(host_nms(cfg, *cands)).to(dev_valid.device)
    nms = cfg.MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG
    multi = nms['NMS_TYPE'] == 'multi_class_nms'
    threshs = ([float(t) for t in nms['NMS_THRESH']] if multi
               else [float(nms['NMS_THRESH'])])
    n = first_flips(torch, geo, cands[0], dev_valid, host,
                    cands[2] if multi else None, threshs, what)
    log(f'  {what}: device NMS kept {int(dev_valid.sum())}, host NMS '
        f'(native) {int(host.sum())}; {n} rows differ')
    return cands, host


def device_nms_serving(torch, cfg, np_batch, parent=None):
    """16b: t_mae.yaml pairs served with ``centerpoint_predict(
    nms_on_device=True)``: one counted pass (phase 4's launches plus one
    NMS_MASK and one NMS_SCAN), its kept set against native host NMS on the
    same candidates, then ms a pair with device and host NMS in turns (and
    with ``parent``'s NMS kernels, nms_phases.parent_kernels, when given),
    the NMS kernels' device ms a pair as this process's profiler reads it.
    Returns (launches, numbers, the served candidates as (boxes, labels,
    valid), host NMS ms)."""
    from tmae_tpu_torch.models.detectors import (batch_to_device,
                                                 build_detector,
                                                 centerpoint_predict,
                                                 init_random_)
    from tmae_tpu_torch.ops import geometry as geo
    from tmae_tpu_torch.utils.nms_phases import using

    model = init_random_(build_detector(cfg), seed=0)
    batch = batch_to_device(np_batch, 'cuda')
    for _ in range(2):
        serve_device_nms(torch, cfg, model, batch)
    (out, dec), launches = counted(
        torch, lambda: serve_device_nms(torch, cfg, model, batch))
    want = {**EXPECTED_LAUNCHES, 'NMS_MASK': 1, 'NMS_SCAN': 1}
    log(f'  launches per frame pair: {launches} (expected {want})')
    if launches != want:
        raise AssertionError('launch counts differ from the device-NMS '
                             'serving path')
    if not torch.isfinite(dec[0]).all():
        raise AssertionError('decoded boxes are not finite')
    cands, _ = device_vs_host(torch, cfg, out, dec[3], 'served pair')
    host_ms, _ = nms_split(cfg, cands)
    times = {'device_nms': [], 'host_nms': []}
    if parent:
        times['device_nms_parent'] = []
    for _ in range(REPS):
        for path in times:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if path == 'host_nms':
                serve_once(torch, cfg, model, batch)
            else:
                with using(parent if path == 'device_nms_parent' else None):
                    serve_device_nms(torch, cfg, model, batch)
            torch.cuda.synchronize()
            times[path].append((time.perf_counter() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in times.items()}
    boxes, _, labels, valid = cands
    log(f'  ms per frame pair (median of {REPS}, in turns): device NMS '
        f'{med["device_nms"]:.2f}, host NMS {med["host_nms"]:.2f}'
        + (f', device NMS with the parent\'s kernels '
           f'{med["device_nms_parent"]:.2f}' if parent else '')
        + f'; host NMS alone (native) {host_ms["native"]:.3f} ms')
    nms_dev = launch_times(torch, 'the NMS kernels a pair, this process',
                           lambda: geo.nms_keep(boxes, valid, 0.5, 500))
    del model, batch, out
    return launches, {
        'device_nms_ms_per_pair': med['device_nms'],
        'host_nms_ms_per_pair': med['host_nms'],
        **({'device_nms_parent_ms_per_pair': med['device_nms_parent']}
           if parent else {}),
        'nms_kernels_device_ms_in_process': nms_dev['device_ms']}, \
        (boxes, labels, valid), host_ms['native']


def iou_head_cfg(cfg):
    """t_mae.yaml with the IoU head (``iou`` in HEAD_DICT, iou_weight 1)
    and multi_class_nms with IoU-rectified scores, as
    tests/test_center_head_iou.py builds its variant."""
    import copy

    var = copy.deepcopy(cfg)
    hd = var.MODEL.DENSE_HEAD
    hd.SEPARATE_HEAD_CFG.HEAD_DICT['iou'] = {'out_channels': 1,
                                             'num_conv': 2}
    hd.LOSS_CONFIG.LOSS_WEIGHTS['iou_weight'] = 1.0
    hd.POST_PROCESSING.NMS_CONFIG = copy.deepcopy(MULTI_NMS)
    return var


def train_batch(cfg):
    from tmae_tpu_torch.datasets.synthetic import frame_pair_batch
    from tmae_tpu_torch.models.detectors import (batch_to_device,
                                                 make_voxel_spec)

    spec = make_voxel_spec(cfg.DATA_CONFIG, cfg.RUNTIME)
    return batch_to_device(frame_pair_batch(
        spec, list(cfg.CLASS_NAMES), indices=TRAIN_PAIRS,
        max_gt=int(cfg.RUNTIME.MAX_GT)), 'cuda')


def one_counted_step(torch, cfg, batch, expected, what):
    """A seeded full-width model's first training step on ``batch`` with
    the launch counters set to 0 just before it and read just after it
    (they must equal ``expected``); every loss part finite. Returns (the
    model, its metrics, the launches)."""
    from tmae_tpu_torch.models.detectors import build_detector, init_random_

    model = init_random_(build_detector(cfg), seed=0).train()
    step = make_trainer(cfg, model)
    metrics, launches = counted(torch, lambda: step(batch))
    metrics = {k: float(v) for k, v in metrics.items()}
    log(f'  {what}: ' + ', '.join(f'{k} {v:.5g}' for k, v in metrics.items()))
    log(f'  {what}: launches {launches}')
    log(f'  {what}: expected {expected}; phase 6\'s '
        f'{EXPECTED_TRAIN_LAUNCHES}')
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f'{what}: a loss part is not finite')
    if launches != expected:
        raise AssertionError(f'{what}: launch counts differ from the '
                             'expected')
    return model, metrics, launches


def iou_head_phase(torch, cfg, np_batch):
    """16c: the IoU-head variant of t_mae.yaml: one finetune step at phase
    6's batch (phase 6's launches plus one IOU_ALIGNED; iou_loss_head_0
    present and finite), then one served pair with multi-class NMS on the
    card against the host's."""
    from tmae_tpu_torch.models.detectors import batch_to_device

    var = iou_head_cfg(cfg)
    model, metrics, launches = one_counted_step(
        torch, var, train_batch(var),
        {**EXPECTED_TRAIN_LAUNCHES, 'IOU_ALIGNED': 1}, 'IoU-head step')
    if 'iou_loss_head_0' not in metrics:
        raise AssertionError('the IoU loss term is missing')
    model.eval()
    out, dec = serve_device_nms(torch, var, model,
                                batch_to_device(np_batch, 'cuda'))
    device_vs_host(torch, var, out, dec[3], 'IoU head, multi_class_nms')
    return launches, {'iou_loss_head_0': metrics['iou_loss_head_0']}


def asymmetric_phase(torch, cfg):
    """16d: one t_mae.yaml finetune step each with ASYMMETRIC {ENABLED} and
    {ENABLED, SimSiam} at phase 6's batch: launches against phase 6's
    (EXPECTED_ASYM, EXPECTED_SIMSIAM), every loss part finite."""
    import copy

    out = {}
    batch = None
    for name, asym, want in (
            ('ENABLED', {'ENABLED': True}, EXPECTED_ASYM),
            ('SimSiam', {'ENABLED': True, 'SimSiam': True},
             EXPECTED_SIMSIAM)):
        var = copy.deepcopy(cfg)
        var.MODEL.BACKBONE_3D['ASYMMETRIC'] = asym
        batch = batch if batch is not None else train_batch(var)
        _, metrics, _ = one_counted_step(torch, var, batch, want,
                                         f'ASYMMETRIC {name} step')
        out[f'asym_{name.lower()}_loss'] = metrics['loss']
        torch.cuda.empty_cache()
    return out


def unmatched_boxes(np, a, b, tol=0.05):
    """Indices of the boxes of one frame's prediction dict ``a`` with no box
    of the same class in ``b`` whose centre lies within ``tol`` m."""
    out = []
    for i, (box, n) in enumerate(zip(a['boxes_3d'], a['name'])):
        same = b['boxes_3d'][b['name'] == n]
        if not len(same) or np.hypot(*(same[:, :2] - box[:2]).T).min() > tol:
            out.append(i)
    return out


def swapped_boxes(np, a, b, thresh):
    """The boxes kept by only one of two runs on the same frame (``a``,
    ``b``: prediction dicts). Each must be explained: it overlaps (BEV IoU
    above 0.8 x the NMS threshold, the same class) a box the other run
    keeps (NMS decided that pair the other way: the boxes and scores
    moved a little), or its score is at most FUSED_SCORE_TOL above the
    other run's lowest kept score (the other run cut it at its top-K or
    its cap). Returns the counts of both kinds; fails on a box that is
    neither."""
    from tmae_tpu_torch.ops.geometry_np import boxes_iou_bev

    ia, ib = unmatched_boxes(np, a, b), unmatched_boxes(np, b, a)
    pairs = edge = 0
    for (x, i_x), (y, i_y) in (((a, ia), (b, ib)), ((b, ib), (a, ia))):
        if not i_x:
            continue
        iou = boxes_iou_bev(x['boxes_3d'][i_x, :7].astype(np.float64),
                            y['boxes_3d'][:, :7].astype(np.float64))
        floor = float(y['score'].min()) if len(y['score']) else 1.0
        for r, i in enumerate(i_x):
            if ((iou[r] > 0.8 * thresh) & (y['name'] == x['name'][i])).any():
                pairs += 1
            elif x['score'][i] <= floor + FUSED_SCORE_TOL:
                edge += 1
            else:
                raise AssertionError(
                    f'{x["frame_id"]}: a {x["name"][i]} of score '
                    f'{x["score"][i]:.4f} kept by one run only, with no '
                    'overlapping partner, above the other run\'s lowest '
                    f'kept score {floor:.4f}')
    return pairs, edge


def eval_cli_phase(torch):
    """16e: phase 13's seeded checkpoint of t_mae_synth.yaml over
    ONCE_EVAL_SAMPLES pairs through ``tools.test``, ``tools.eval_asym``
    (the same detections: the model is symmetric) and ``tools.test
    --fuse_conv_bn`` (the same kept boxes but for those that
    :func:`swapped_boxes` explains), and the
    folded model's head maps on one loader batch against the unfused
    model's (FUSED_MAP_TOL)."""
    import pickle

    import numpy as np

    from tmae_tpu_torch.config import cfg_from_yaml_file
    from tmae_tpu_torch.datasets.dataset import build_dataloader
    from tmae_tpu_torch.models.detectors import (batch_to_device,
                                                 build_detector, init_random_)
    from tmae_tpu_torch.tools import eval_asym
    from tmae_tpu_torch.tools import test as test_cli
    from tmae_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
    from tmae_tpu_torch.utils.fuse import fuse_conv_bn

    cfg_file = ROOT / 'tools/cfgs/once_models/t_mae_synth.yaml'
    cfg = cfg_from_yaml_file(cfg_file)
    cfg.DATA_CONFIG.NUM_SYNTHETIC_SAMPLES = ONCE_EVAL_SAMPLES
    tmp = tempfile.TemporaryDirectory()
    try:
        ckpt = save_checkpoint(
            Path(tmp.name), init_random_(build_detector(cfg, 'cpu'), seed=0),
            None, 0)
        test_cli.OUTPUT_ROOT = OUT_DIR / 'eval_cli'
        argv = ['--cfg_file', str(cfg_file), '--ckpt', str(ckpt), '--set',
                'DATA_CONFIG.NUM_SYNTHETIC_SAMPLES', str(ONCE_EVAL_SAMPLES)]
        annos, secs = {}, {}
        for name, fn, extra in (
                ('test', test_cli.main, []),
                ('eval_asym', eval_asym.main, []),
                ('fused', test_cli.main, ['--fuse_conv_bn'])):
            t0 = time.perf_counter()
            (rdir, _), = fn(argv + extra + ['--extra_tag', name]).items()
            secs[name] = time.perf_counter() - t0
            annos[name] = pickle.loads((rdir / 'result.pkl').read_bytes())
            log(f'  {name}: {secs[name]:.1f} s, '
                f'{sum(len(a["score"]) for a in annos[name])} boxes kept')

        dataset, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 1,
                                      False, runtime_cfg=cfg.RUNTIME)
        batch = batch_to_device(dataset.collate_batch([dataset[0]]), 'cuda')
        model = build_detector(cfg)
        restore_checkpoint(ckpt, model)
        with torch.no_grad():
            before = model(batch)['pred_dicts'][0]
            folded = fuse_conv_bn(model)
            after = model(batch)['pred_dicts'][0]
    finally:
        tmp.cleanup()
    for a, b in zip(annos['test'], annos['eval_asym']):
        if a['frame_id'] != b['frame_id'] or not all(
                np.array_equal(a[k], b[k]) for k in ('name', 'score',
                                                     'boxes_3d')):
            raise AssertionError('eval_asym detections differ from '
                                 'tools.test\'s')
    log('  eval_asym: the same detections as tools.test')
    worst = {}
    for name, want in before.items():
        err = (after[name] - want).abs()
        worst[name] = (float(err.max()), float(err.mean()))
    log(f'  --fuse_conv_bn: {folded} conv-BN pairs folded; head maps max / '
        f'mean |folded - unfused| {worst} (limits {FUSED_MAP_TOL})')
    if any(m > FUSED_MAP_TOL[0] or a > FUSED_MAP_TOL[1]
           for m, a in worst.values()):
        raise AssertionError('the folded head maps differ from the unfused')
    thresh = float(
        cfg.MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG.NMS_THRESH)
    pairs = edge = 0
    for a, b in zip(annos['test'], annos['fused']):
        p, e = swapped_boxes(np, a, b, thresh)
        pairs, edge = pairs + p, edge + e
    total = sum(len(a['score']) for a in annos['fused'])
    log(f'  --fuse_conv_bn: {pairs + edge} of {total} kept boxes kept by one '
        f'run only: {pairs} overlap a box the other run keeps, {edge} '
        f'score within {FUSED_SCORE_TOL} of the other run\'s lowest kept '
        'score')
    return {'eval_cli_s': secs, 'fused_only_kept': pairs + edge}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--profile', action='store_true',
                    help='also profile a serving pass, a training step, '
                    'the pretraining steps and a Waymo serving pass by '
                    'kernel name')
    ap.add_argument('--nms-parent', metavar='PATH',
                    help='phase 16 also builds and runs this iou_nms.cu (a '
                    'parent checkout\'s) beside the repo\'s')
    args = ap.parse_args(argv)
    if args.nms_parent:
        args.nms_parent = str(Path(args.nms_parent).resolve())

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
    # torch.use_deterministic_algorithms imports torch._inductor on its
    # first call, and that import keeps the calling frames (and every tensor
    # they hold) alive for the rest of the process: make that call here,
    # not from the grid-layer capture
    torch.use_deterministic_algorithms(False)
    t_start = time.perf_counter()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / 'log.txt').unlink(missing_ok=True)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f'card: {card}; torch {torch.__version__} cuda {torch.version.cuda}')

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
                if 'Used' in ln and 'registers' in ln]
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
    torch.cuda.synchronize()
    log(f'  peak device memory before it (kernels phase) '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    launches, med, stateless = serve_phase(
        torch, cfg, model, batch, EXPECTED_LAUNCHES, REPS,
        args.profile and 'profile.txt')
    split = split_times(torch, cfg, model, batch, REPS)
    log('  median ms by part: ' + ', '.join(f'{k} {v:.2f}'
                                            for k, v in split.items()))
    fill_launches(rows, launches, ('K1', 'K2', 'K3', 'K4', 'K5'))

    log('phase reference: card vs CPU, full size')
    card_vs_cpu(torch, cfg, np_batch, seed=0)
    log('phase reference: card vs CPU, full width on a 64x64 grid')
    card_vs_cpu(torch, *small_grid(cfg), seed=7)

    log('phase fused serving (t_mae.yaml, the fused in-place layer path)')
    fused_launches, fused_ms, stateless_fused = fused_serving(
        torch, cfg, model, batch, stateless, args.profile)
    fill_launches(rows, fused_launches, ('K12',))
    stream = {}
    for fused, ref in ((False, stateless), (True, stateless_fused)):
        path = 'fused' if fused else 'default'
        log(f'phase streaming serving (t_mae.yaml, {path} path)')
        stream[path] = streaming_serving(torch, cfg, model, batch, ref,
                                         fused)
    del stateless, stateless_fused

    log('phase windowed SubM conv and attention only (t_mae.yaml stage '
        'widths on the served pair\'s grids)')
    t0 = time.perf_counter()
    sparse_launches = sparse_attn_phase(torch, model, batch, rows)
    fill_launches(rows, sparse_launches, ('K13b', 'K13c', 'K15', 'K16'))
    log(f'  phase {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()

    log('phase training (t_mae.yaml, full width and depth, '
        f'{len(TRAIN_PAIRS)} frame pairs)')
    del model, batch
    torch.cuda.empty_cache()
    train_launches, train = train_phase(torch, cfg, spec, rows, args.profile)
    fill_launches(rows, train_launches, ('K6', 'K7', 'K8', 'K9'))

    log('phase training reference: one step, card vs CPU, full width on a '
        '64x64 grid')
    train_card_vs_cpu(torch, *small_grid(cfg), seed=7)
    torch.cuda.empty_cache()

    cfgs = ROOT / 'tools/cfgs'
    ssl_waymo = cfg_from_yaml_file(cfgs / 'waymo_models/t_mae_ssl_waymo.yaml')
    log('phase grid layer and pretraining (t_mae_ssl_waymo.yaml, full width '
        f'and depth, {len(TRAIN_PAIRS)} frame pairs)')
    grid_launches, pre = pretrain_phase(
        torch, ssl_waymo, TRAIN_STEPS, EXPECTED_PRETRAIN_GRID, rows,
        args.profile and 'profile_pretrain_waymo.txt')
    fill_launches(rows, grid_launches, ('K10',))
    torch.cuda.empty_cache()
    log('phase pretraining (t_mae_ssl.yaml, bucketed, full width and depth, '
        f'{len(TRAIN_PAIRS)} frame pairs)')
    _, pre_once = pretrain_phase(
        torch, cfg_from_yaml_file(cfgs / 'once_models/t_mae_ssl.yaml'),
        SSL_STEPS, EXPECTED_PRETRAIN_BUCKETED, None,
        args.profile and 'profile_pretrain_once.txt')
    torch.cuda.empty_cache()
    log('phase pretraining reference: one t_mae_ssl_waymo.yaml step, card vs '
        'CPU, full width on a 64x64 grid')
    pretrain_card_vs_cpu(torch, *small_grid(ssl_waymo), seed=7)
    torch.cuda.empty_cache()
    log('phase Waymo serving (t_mae_waymo.yaml, full width, one frame pair)')
    waymo_ms = waymo_serving(
        torch, cfg_from_yaml_file(cfgs / 'waymo_models/t_mae_waymo.yaml'),
        args.profile)

    torch.cuda.empty_cache()
    log('phase ONCE evaluation (t_mae_synth.yaml through '
        'tmae_tpu_torch.tools.test on the card)')
    once_eval = once_eval_phase(torch)

    torch.cuda.empty_cache()
    log('phase training through the CLIs (t_mae_ssl.yaml -> t_mae.yaml, full '
        'width, a ONCE-layout tree)')
    t0 = time.perf_counter()
    cli = cli_training_phase(torch)
    log(f'  phase {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()
    log('phase overfit oracle through the CLIs (tests/test_overfit_ap.py\'s '
        'config)')
    overfit = overfit_phase(torch)

    torch.cuda.empty_cache()
    log('phase Waymo through the CLIs (create_waymo_infos -> '
        't_mae_ssl_waymo.yaml -> t_mae_waymo.yaml -> tools.test, full width, '
        'a synthetic Waymo TFRecord)')
    t0 = time.perf_counter()
    waymo_cli = waymo_cli_phase(torch)
    log(f'  phase {time.perf_counter() - t0:.1f} s')

    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    log('phase 16b: serving with device NMS (t_mae.yaml, full width, phase '
        '4\'s model and frame pair)')
    parent = None
    if args.nms_parent:
        from tmae_tpu_torch.utils.nms_phases import parent_kernels
        parent = parent_kernels(args.nms_parent)
    nms_launches, dev_nms, served, host_ms = device_nms_serving(
        torch, cfg, np_batch, parent)
    log(f'  phase 16b {time.perf_counter() - t16:.1f} s')
    fresh = nms_fresh_process(torch, cfg, served, args.nms_parent)
    served_ms = [fresh['served K=500']['change'][k]['device_ms']
                 for k in ('NMS_MASK', 'NMS_SCAN')]
    if None in served_ms:
        raise AssertionError('nms_phases read no device time for the NMS '
                             'kernels on the served candidates')
    dev_nms['nms_kernels_device_ms'] = sum(served_ms)
    log(f'  the NMS kernels a pair: {dev_nms["nms_kernels_device_ms"]} ms '
        'of device time on its candidates (nms_phases, its own process)')
    log('phase 16a: the IoU and NMS kernels (csrc/iou_nms.cu) against '
        'their plain versions')
    t0 = time.perf_counter()
    iou_pairs_launches = geometry_phase(torch, served, host_ms, rows, fresh)
    log(f'  phase 16a {time.perf_counter() - t0:.1f} s')
    fill_launches(rows, nms_launches, ('NMS_MASK', 'NMS_SCAN'))
    fill_launches(rows, iou_pairs_launches, ('IOU_PAIRS',))
    del served
    torch.cuda.empty_cache()
    log('phase 16c: the IoU head and multi_class_nms (t_mae.yaml variant, '
        'full width)')
    iou_launches, iou_head = iou_head_phase(torch, cfg, np_batch)
    fill_launches(rows, iou_launches, ('IOU_ALIGNED',))
    torch.cuda.empty_cache()
    log('phase 16d: ASYMMETRIC ENABLED and SimSiam (t_mae.yaml, full width '
        'and depth)')
    asym = asymmetric_phase(torch, cfg)
    torch.cuda.empty_cache()
    log('phase 16e: tools.eval_asym and tools.test --fuse_conv_bn '
        '(t_mae_synth.yaml, phase 13\'s checkpoint)')
    eval_cli = eval_cli_phase(torch)
    log(f'  phase 16 {time.perf_counter() - t16:.1f} s')

    log(f'total {time.perf_counter() - t_start:.1f} s')
    for row in rows:
        del row['kernel']
    print(json.dumps({
        'kernels': rows, 'serving_ms_per_pair': med,
        'frames_per_s': 1e3 / med, 'fused_serving_ms_per_pair': fused_ms,
        **{f'streaming_{path}_ms_per_frame': v[0]
           for path, v in stream.items()},
        **{f'streaming_{path}_device_ms': v[1][0]
           for path, v in stream.items()},
        **{f'stateless_{path}_device_ms': v[1][1]
           for path, v in stream.items()},
        **train,
        **{f'pretrain_waymo_{k}': v for k, v in pre.items()},
        **{f'pretrain_once_{k}': v for k, v in pre_once.items()},
        'waymo_serving_ms_per_pair': waymo_ms, **once_eval, **cli,
        **overfit, **waymo_cli, **dev_nms, **iou_head, **asym,
        **eval_cli}), flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


def profile_pass(torch, cfg, model, batch, name='profile.txt', **fwd):
    """Device time by kernel name over one serving pass (torch.profiler):
    the top rows logged, every row in ``name`` under the output
    directory."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve_once(torch, cfg, model, batch, **fwd)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    (OUT_DIR / name).write_text(
        avg.table(sort_by='self_cuda_time_total', row_limit=-1))
    log(avg.table(sort_by='self_cuda_time_total', row_limit=40))
    (fwd,), total = device_sums(avg, FWD_KERNELS)
    log(f'  {name}: the tiled kernel\'s launches (csrc/encoder_layer_tiled.'
        f'cu) {fwd:.3f} ms of {total:.3f} ms of device time in the pass')


if __name__ == '__main__':
    sys.exit(main())
