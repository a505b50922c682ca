"""Build and bind the native host ops (``tmae_tpu_torch/csrc/host_ops.cpp``):
rotated BEV intersection, 3D IoU, greedy rotated NMS, points in boxes and
the ONCE AP accumulators (the port's counterpart of
``tmae_tpu/utils/native.py``, with the same ctypes signatures).

The source is compiled with g++ on first use into ``tmae_tpu_torch/_build``
(listed in ``.gitignore``), named by a hash of the source, the flags and the
CPU that ``-march=native`` resolves to, so a copy of the tree moved to
another machine builds its own library. The OpenMP build comes first; when
it fails, the same source is built without OpenMP. When both fail, or the
library does not load, the call raises with g++'s output: no caller falls
back to numpy on its own. The numpy versions (``ops/geometry_np.py``,
``datasets/once_eval.py``) are the plain versions, which a caller reaches
only by asking for them (``native=False``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SRC = PKG_DIR / 'csrc' / 'host_ops.cpp'
BUILD_DIR = PKG_DIR / '_build'
CXX = 'g++'
FLAGS = ('-O3', '-march=native', '-shared', '-fPIC', '-fopenmp')
FLAGS_NO_OPENMP = ('-O3', '-shared', '-fPIC')

_lib = None
_path = None
_lock = threading.Lock()


def _native_arch() -> str:
    """What ``-march=native`` means on this machine (g++'s resolved
    ``-march`` and ``-mtune``), or '' when g++ cannot say."""
    try:
        out = subprocess.run([CXX, '-march=native', '-Q', '--help=target'],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ''
    return ' '.join(ln.split()[-1] for ln in out.stdout.splitlines()
                    if ln.strip().startswith(('-march=', '-mtune=')))


def _target(flags, arch: str) -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(' '.join(flags).encode())
    h.update(arch.encode())
    return BUILD_DIR / f'{SRC.stem}-{h.hexdigest()[:16]}.so'


def _build(flags, out: Path):
    """Compiles ``SRC`` into ``out``; returns None, or g++'s output when it
    failed."""
    tmp = out.with_name(f'{out.stem}.{os.getpid()}.tmp.so')
    cmd = [CXX, *flags, str(SRC), '-o', str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f'{" ".join(cmd)}: {e}'
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f'{" ".join(cmd)}:\n{proc.stdout}{proc.stderr}'
    os.replace(tmp, out)
    return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_d = ctypes.POINTER(ctypes.c_double)
    c_f = ctypes.POINTER(ctypes.c_float)
    c_i64 = ctypes.POINTER(ctypes.c_int64)
    c_i32 = ctypes.POINTER(ctypes.c_int32)
    c_i8 = ctypes.POINTER(ctypes.c_int8)
    lib.tmae_intersection_area_bev.argtypes = [
        c_d, ctypes.c_int64, c_d, ctypes.c_int64, c_d]
    lib.tmae_iou3d.argtypes = [
        c_d, ctypes.c_int64, c_d, ctypes.c_int64, ctypes.c_int, c_d]
    lib.tmae_nms_bev.restype = ctypes.c_int64
    lib.tmae_nms_bev.argtypes = [
        c_d, ctypes.c_int64, ctypes.c_double, ctypes.c_int64, c_i8]
    lib.tmae_points_in_boxes.argtypes = [
        c_f, ctypes.c_int64, c_d, ctypes.c_int64, ctypes.c_double, c_i32]
    lib.tmae_accumulate_scores.restype = ctypes.c_int64
    lib.tmae_accumulate_scores.argtypes = [
        c_d, ctypes.c_int64, ctypes.c_int64, c_d, c_i64, c_i64,
        ctypes.c_double, c_d]
    lib.tmae_compute_statistics.argtypes = [
        c_d, ctypes.c_int64, ctypes.c_int64, c_d, c_i64, c_i64, c_d,
        ctypes.c_int64, ctypes.c_double, c_i64]
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first when it is missing. Raises
    ``RuntimeError`` (with g++'s output) when it cannot be built or
    loaded."""
    global _lib, _path
    with _lock:
        if _lib is not None:
            return _lib
        BUILD_DIR.mkdir(exist_ok=True)
        errors = []
        for out, flags in build_targets().items():
            if not out.exists():
                err = _build(flags, out)
                if err is not None:
                    errors.append(err)
                    continue
            try:
                _lib = _bind(ctypes.CDLL(str(out)))
            except OSError as e:
                errors.append(f'loading {out}: {e}')
                continue
            _path = out
            return _lib
        raise RuntimeError('the native host ops could not be built or '
                           'loaded:\n' + '\n'.join(errors))


def build_targets() -> dict:
    """``{library file: g++ flags}`` of the builds of the current source on
    this machine, OpenMP first: the files :func:`get_lib` may load."""
    arch = _native_arch()
    return {_target(flags, arch): flags for flags in (FLAGS, FLAGS_NO_OPENMP)}


def library_path() -> Path:
    """The file of the loaded library (built first when it is missing)."""
    get_lib()
    return _path


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def intersection_area_bev(boxes_a: np.ndarray, boxes_b: np.ndarray):
    """Pairwise BEV intersection area [N, M] of [N, 7] and [M, 7] boxes."""
    lib = get_lib()
    a = np.ascontiguousarray(boxes_a, np.float64)
    b = np.ascontiguousarray(boxes_b, np.float64)
    out = np.empty((len(a), len(b)), np.float64)
    lib.tmae_intersection_area_bev(
        _ptr(a, ctypes.c_double), len(a), _ptr(b, ctypes.c_double), len(b),
        _ptr(out, ctypes.c_double),
    )
    return out


def iou3d(boxes_a, boxes_b, with_heading=False):
    """Pairwise 3D IoU [N, M]; ``with_heading`` zeroes it where the
    headings differ by more than pi/2."""
    lib = get_lib()
    a = np.ascontiguousarray(boxes_a, np.float64)
    b = np.ascontiguousarray(boxes_b, np.float64)
    out = np.empty((len(a), len(b)), np.float64)
    lib.tmae_iou3d(_ptr(a, ctypes.c_double), len(a), _ptr(b, ctypes.c_double),
                   len(b), int(with_heading), _ptr(out, ctypes.c_double))
    return out


def nms_bev_sorted(boxes_sorted, thresh, post_max):
    """Boxes sorted by descending score → bool keep mask."""
    lib = get_lib()
    b = np.ascontiguousarray(boxes_sorted, np.float64)
    keep = np.zeros(len(b), np.int8)
    lib.tmae_nms_bev(_ptr(b, ctypes.c_double), len(b), float(thresh),
                     int(post_max), _ptr(keep, ctypes.c_int8))
    return keep.astype(bool)


def points_in_boxes(points_xyz, boxes, margin=0.0):
    """→ int32 [N] index of the first box that holds each point, or -1."""
    lib = get_lib()
    p = np.ascontiguousarray(points_xyz[:, :3], np.float32)
    b = np.ascontiguousarray(boxes, np.float64)
    out = np.empty(len(p), np.int32)
    lib.tmae_points_in_boxes(_ptr(p, ctypes.c_float), len(p),
                             _ptr(b, ctypes.c_double), len(b), float(margin),
                             _ptr(out, ctypes.c_int32))
    return out


def accumulate_scores(iou, pred_scores, gt_flag, pred_flag, iou_threshold):
    """The scores of the greedy best-score matches (ONCE AP)."""
    lib = get_lib()
    i = np.ascontiguousarray(iou, np.float64)
    ps = np.ascontiguousarray(pred_scores, np.float64)
    gf = np.ascontiguousarray(gt_flag, np.int64)
    pf = np.ascontiguousarray(pred_flag, np.int64)
    accum = np.empty(max(i.shape[0], 1), np.float64)
    n = lib.tmae_accumulate_scores(
        _ptr(i, ctypes.c_double), i.shape[0], i.shape[1],
        _ptr(ps, ctypes.c_double), _ptr(gf, ctypes.c_int64),
        _ptr(pf, ctypes.c_int64), float(iou_threshold),
        _ptr(accum, ctypes.c_double),
    )
    return accum[:n].copy()


def compute_statistics_all(iou, pred_scores, gt_flag, pred_flag, thresholds,
                           iou_threshold):
    """→ int64 [num_thresh, 3] (tp, fp, fn) rows (ONCE AP)."""
    lib = get_lib()
    i = np.ascontiguousarray(iou, np.float64)
    ps = np.ascontiguousarray(pred_scores, np.float64)
    gf = np.ascontiguousarray(gt_flag, np.int64)
    pf = np.ascontiguousarray(pred_flag, np.int64)
    th = np.ascontiguousarray(thresholds, np.float64)
    out = np.zeros((len(th), 3), np.int64)
    lib.tmae_compute_statistics(
        _ptr(i, ctypes.c_double), i.shape[0], i.shape[1],
        _ptr(ps, ctypes.c_double), _ptr(gf, ctypes.c_int64),
        _ptr(pf, ctypes.c_int64), _ptr(th, ctypes.c_double), len(th),
        float(iou_threshold), _ptr(out, ctypes.c_int64),
    )
    return out
