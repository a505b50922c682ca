"""PointNet++ primitives on batched fixed-size tensors (counterpart of
``tmae_tpu/ops/pointnet2.py``): farthest point sampling on coordinates
(D-FPS) and on a coordinate + feature distance (F-FPS), ball query with its
dilated form, the gathers, three-NN interpolation and query-and-group.

Shapes: points ``[B, N, 3]``, features ``[B, N, C]``, masks ``[B, N]``.
Sample and neighbour indices are int32, as the JAX package returns them.

The three samplers are wrappers over hand-written kernels
(``csrc/pointnet2.cu``) on CUDA tensors and take their plain versions on
CPU tensors:

* ``DFPS``: :func:`farthest_point_sample`, one thread-block cluster a
  sample under :func:`dfps_plan`;
* ``FFPS``: :func:`farthest_point_sample_ffps`, the F-FPS of
  ``calc_dist_matrix_for_sampling`` then ``farthest_point_sample_matrix``
  in one call, under :func:`ffps_plan`: a thread-block cluster a sample
  that computes the distances afresh each step, or for small samples and
  samples whose features do not fit the cluster, the distance matrix and
  a walk over its rows (without features F-FPS is D-FPS, and takes
  ``DFPS``);
* ``BALL_QUERY``: :func:`ball_query`, and :func:`ball_query_multi`, every
  radius of a multi-scale grouping in one launch under
  :func:`ball_query_plan`.

They make discrete choices from f32 sums, so the plain versions and the
kernels sum in one written-out order (the coordinates x, y, z, then the
feature channels in order, then ``xyz + gamma * feat``), with no product
and sum contracted into a fused multiply-add, and give the same indices bit
for bit. An argmax tie takes the smallest index, as ``jnp.argmax`` does.
The gathers are PyTorch indexing (autograd's scatter-add is their
backward); none of the samplers carries a gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..device import as_kernel_arg, on_card
from ..utils.build import CudaKernel, F, I, P, stream_handle

DFPS = CudaKernel('pointnet2.cu', 'launch_dfps_cluster',
                  [P, P, I, I, I, I, I, I, P, P])
FFPS = CudaKernel('pointnet2.cu', 'launch_ffps',
                  [P, P, P, I, I, I, I, F, I, I, I, I, I, P, P, P])
BALL_QUERY = CudaKernel('pointnet2.cu', 'launch_ball_query',
                        [P, P, P, P, I, I, I, I, P, P, P, I, I, P, P, P])

BIG = 1e10
FPS_MAX_POINTS = 16384   # FFPS: 16 running distances a thread of 1024
# FFPS's cluster route (csrc/pointnet2.cu): up to 512 threads a CTA (256
# when a thread holds 128 channels in registers), the first 0, 32, 64 or
# 128 channels of a thread's points in registers (at most 128 values), and
# at most this many bytes of dynamic shared memory a CTA
FFPS_MAX_THREADS = 512
FFPS_REG_CHANNELS = (128, 64, 32, 0)
FFPS_SMEM_MAX = 227 * 1024 - 2048
# FFPS with features takes the matrix route up to this many points
# (utils/pn2_phases.py on the H100: 512 x 128 0.200 ms on the matrix, 0.370
# on the cluster; 4096 x 64 0.922 and 0.718)
FFPS_MATRIX_MAX_POINTS = 2048
# DFPS: a cluster of up to 16 CTAs a sample, up to 256 threads a CTA and
# 16 points a thread (dfps_plan)
DFPS_MAX_CLUSTER = 16
DFPS_MAX_THREADS = 256
DFPS_MAX_PER = 16
DFPS_MAX_POINTS = DFPS_MAX_CLUSTER * DFPS_MAX_THREADS * DFPS_MAX_PER
# the plain ball query takes its centres in chunks of at most this many
# (centre, point) pairs, so that no [B, M, N] tensor of a large level is
# made at once
QUERY_CHUNK_PAIRS = 1 << 24
# BALL_QUERY (csrc/pointnet2.cu): up to 4 radii a call; its tiles are
# 16-byte bulk copies, so a sample's points come in multiples of 16
BQ_MAX_RADII = 4
BQ_POINT_ALIGN = 16


def square_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, N, D] x [B, M, D] → [B, N, M] squared L2 of ``a_i - b_j``,
    summed channel by channel in order (no [B, N, M, D] tensor)."""
    d = a[:, :, None, 0] - b[:, None, :, 0]
    acc = d * d
    for c in range(1, a.shape[-1]):
        d = a[:, :, None, c] - b[:, None, :, c]
        acc = acc + d * d
    return acc


def calc_dist_matrix_for_sampling(xyz, features=None, gamma: float = 1.0):
    """F-FPS's distance [B, N, N]: the coordinates' squared distance plus
    ``gamma`` times the features'."""
    dist = square_distance(xyz, xyz)
    if features is not None:
        dist = dist + square_distance(features, features) * gamma
    return dist


def _fps_walk(row_of, mask: torch.Tensor, num_samples: int) -> torch.Tensor:
    """The FPS loop: start at the first valid point; each step keeps the
    running minimum of the distances to the chosen points (``row_of(last)``
    [B, N]; invalid points at -BIG) and takes its argmax."""
    B, N = mask.shape
    dist = torch.where(mask, BIG, -BIG).to(torch.float32)
    neg = torch.tensor(-BIG, dtype=torch.float32, device=mask.device)
    last = mask.to(torch.uint8).argmax(1)
    out = torch.zeros(B, num_samples, dtype=torch.int32, device=mask.device)
    if num_samples:
        out[:, 0] = last
    for i in range(1, num_samples):
        dist = torch.minimum(dist, torch.where(mask, row_of(last), neg))
        last = dist.argmax(1)
        out[:, i] = last
    return out


def farthest_point_sample_plain(points, mask, num_samples: int):
    """D-FPS: [B, N, 3] → indices [B, S] int32."""
    rows = torch.arange(points.shape[0], device=points.device)

    def row_of(last):
        p = points[rows, last]
        d = points[..., 0] - p[:, None, 0]
        acc = d * d
        for c in (1, 2):
            d = points[..., c] - p[:, None, c]
            acc = acc + d * d
        return acc

    return _fps_walk(row_of, mask, num_samples)


def farthest_point_sample_matrix(dist_matrix, mask, num_samples: int):
    """FPS over a given distance matrix [B, N, N] → indices [B, S]
    int32."""
    rows = torch.arange(dist_matrix.shape[0], device=dist_matrix.device)
    return _fps_walk(lambda last: dist_matrix[rows, last], mask,
                     num_samples)


def farthest_point_sample_ffps_plain(xyz, features, mask, num_samples: int,
                                     gamma: float = 1.0):
    """F-FPS: ``calc_dist_matrix_for_sampling`` then the FPS walk over its
    rows."""
    return farthest_point_sample_matrix(
        calc_dist_matrix_for_sampling(xyz, features, gamma), mask,
        num_samples)


def dfps_plan(N: int) -> tuple[int, int, int]:
    """DFPS's launch for N points a sample: (R, threads, per), a cluster of
    R CTAs of ``threads`` threads, ``per`` points a thread, covering N
    (R threads per >= N). From the plans timed on the H100
    (``utils/pn2_phases.py --sweep``): 128 threads a CTA up to 1024 points,
    256 above; the cluster grows (up to 16 CTAs) until a thread holds 2
    points (up to 1024), 4 (up to 8192) or 8, then a thread takes more.
    Raises above DFPS_MAX_POINTS."""
    if not 1 <= N <= DFPS_MAX_POINTS:
        raise ValueError(f'D-FPS on the card takes 1 to {DFPS_MAX_POINTS} '
                         f'points a sample, got {N}')
    threads = 128 if N <= 1024 else DFPS_MAX_THREADS
    target = 2 if N <= 1024 else 4 if N <= 8192 else 8
    R = 1
    while R < DFPS_MAX_CLUSTER and R * threads * target < N:
        R *= 2
    per = 1
    while R * threads * per < N:
        per *= 2
    if R == 1 and per == 1:
        threads = 32 * -(-N // 32)
    return R, threads, per


FFPS_ROUTES = {'matrix': 0, 'cluster': 1}


class FfpsPlan(NamedTuple):
    """FFPS's launch: ``route`` 'cluster' (R CTAs of ``threads`` threads a
    sample, ``per`` points a thread, the first ``creg`` channels in
    registers) or 'matrix' (the other fields 0)."""

    route: str
    R: int
    threads: int
    per: int
    creg: int


def ffps_smem(C: int, threads: int, per: int) -> int:
    """Dynamic shared memory of an FFPS 'cluster' CTA: its points' features
    [C][P + 1] floats (P = threads per, padded to 4) and its points'
    coordinates [P][4]."""
    P = threads * per
    return 4 * (4 * -(-(C * (P + 1)) // 4) + 4 * P)


def ffps_cluster_plan(N: int, C: int) -> FfpsPlan | None:
    """FFPS's 'cluster' launch for N points of C > 0 channels, or None when
    no cluster's features fit: the fewest points a thread (1, 2, 4, ...),
    then the most channels in registers (128, 64, 32, 0; at most 128
    values a thread; none unless C % 4 == 0), for which a cluster of at
    most 16 CTAs covers N; R
    the smallest power of 2 that does with 128 threads a CTA up to 1024
    points and 256 above (512 where 256 does not reach and a thread holds
    fewer than 128 register values), the threads then cut to what R needs,
    and R doubled (up to 16) until its shared memory fits (FFPS_SMEM_MAX
    bytes a CTA)."""
    per = 1
    while per <= DFPS_MAX_PER:
        for creg in FFPS_REG_CHANNELS:
            # registers' channels are read 16 bytes at a time: C % 4 == 0
            if creg > C or per * creg > 128 or (creg and C % 4):
                continue
            most = 256 if per * creg >= 128 else FFPS_MAX_THREADS
            for cap in dict.fromkeys((min(most, 128 if N <= 1024 else 256),
                                      most)):
                R = 1
                while R < DFPS_MAX_CLUSTER and R * cap * per < N:
                    R *= 2
                if R * cap * per >= N:
                    break
            else:
                continue
            while R <= DFPS_MAX_CLUSTER:  # more CTAs for shared memory
                threads = 32 * -(-N // (32 * R * per))
                if ffps_smem(C, threads, per) <= FFPS_SMEM_MAX:
                    return FfpsPlan('cluster', R, threads, per, creg)
                R *= 2
        per *= 2
    return None


def ffps_plan(N: int, C: int) -> FfpsPlan:
    """FFPS's launch for N points of C >= 1 feature channels a sample
    (:func:`farthest_point_sample_ffps` sends a call without features to
    DFPS). Above FFPS_MATRIX_MAX_POINTS points, :func:`ffps_cluster_plan`
    (4096 x 64) where its features fit; up to that many points (512 x 128:
    the matrix, at most 16 MiB a sample, costs less to build than the
    cluster's longer steps) and where no cluster fits (e.g. 16384 points
    of 64 channels), 'matrix': the distance matrix [B, N, N] in device
    memory, then a one-block walk over its rows. Raises outside
    1..FPS_MAX_POINTS points or for C < 1."""
    if not 1 <= N <= FPS_MAX_POINTS:
        raise ValueError(f'F-FPS on the card takes 1 to {FPS_MAX_POINTS} '
                         f'points a sample, got {N}')
    if C < 1:
        raise ValueError(f'FFPS takes 1 or more feature channels, got {C}')
    if N > FFPS_MATRIX_MAX_POINTS:
        plan = ffps_cluster_plan(N, C)
        if plan is not None:
            return plan
    return FfpsPlan('matrix', 0, 0, 0, 0)


def _fps_args(points, mask, num_samples, limit=FPS_MAX_POINTS):
    B, N = mask.shape
    if N > limit:
        raise ValueError(f'FPS on the card takes at most {limit} points a '
                         f'sample, got {N}')
    if points.shape[:2] != (B, N) or points.shape[-1] != 3:
        raise ValueError(f'points {tuple(points.shape)} and mask '
                         f'{tuple(mask.shape)} do not match')
    return (as_kernel_arg(points, torch.float32),
            as_kernel_arg(mask, torch.bool),
            torch.empty(B, num_samples, dtype=torch.int32,
                        device=points.device))


def farthest_point_sample(points, mask, num_samples: int) -> torch.Tensor:
    """D-FPS: [B, N, 3] + mask [B, N] → indices [B, S] int32 (kernel
    ``DFPS`` on the card). Invalid points are chosen only once every valid
    one has been, or when there is none (then index 0)."""
    if not on_card(points, mask):
        return farthest_point_sample_plain(points, mask, num_samples)
    pts, m, out = _fps_args(points.detach(), mask, num_samples,
                            DFPS_MAX_POINTS)
    B, N = m.shape
    if B and N and num_samples:
        DFPS(pts.data_ptr(), m.data_ptr(), B, N, num_samples, *dfps_plan(N),
             out.data_ptr(), stream_handle())
    else:
        out.zero_()
    return out


def farthest_point_sample_ffps(xyz, features, mask, num_samples: int,
                               gamma: float = 1.0) -> torch.Tensor:
    """F-FPS: coordinates [B, N, 3] and features [B, N, C] (or None) + mask
    → indices [B, S] int32 (kernel ``FFPS`` on the card, under
    :func:`ffps_plan`: a cluster walk that needs no [B, N, N] buffer, or
    the distance matrix and the walk over its rows). Without features the
    distance is D-FPS's, summed in the same order, so the card takes
    ``DFPS`` (:func:`farthest_point_sample`) for the same indices."""
    if not on_card(xyz, features, mask):
        return farthest_point_sample_ffps_plain(xyz, features, mask,
                                                num_samples, gamma)
    if features is None:
        return farthest_point_sample(xyz, mask, num_samples)
    pts, m, out = _fps_args(xyz.detach(), mask, num_samples)
    B, N = m.shape
    feat = as_kernel_arg(features.detach(), torch.float32)
    C = feat.shape[-1]
    if feat.shape[:2] != (B, N):
        raise ValueError(f'features {tuple(feat.shape)} do not match the '
                         f'points {tuple(pts.shape)}')
    if B and N and num_samples:
        plan = ffps_plan(N, C)
        if plan.creg and feat.data_ptr() % 16:  # read 16 bytes at a time
            feat = feat.clone()
        scratch = (torch.empty(B, N, N, dtype=torch.float32, device=m.device)
                   if plan.route == 'matrix' else None)
        FFPS(pts.data_ptr(), feat.data_ptr(), m.data_ptr(), B, N, C,
             num_samples, float(gamma), FFPS_ROUTES[plan.route], plan.R, plan.threads, plan.per,
             plan.creg, 0 if scratch is None else scratch.data_ptr(),
             out.data_ptr(), stream_handle())
    else:
        out.zero_()
    return out


def _f32(x: float) -> float:
    """A Python float rounded to f32, as JAX takes a Python scalar beside an
    f32 array."""
    return float(np.float32(x))


def ball_query_plain(radius: float, nsample: int, xyz, xyz_mask, centers,
                     center_mask, min_radius: float = 0.0):
    """The first ``nsample`` point indices in ascending order within
    ``radius`` of each centre (``min_radius < d <= radius`` when
    ``min_radius > 0``), wrap-repeated to fill; 0 for an empty ball and for
    an invalid centre. ``cnt`` counts every point in the ball. Returns
    (idx [B, M, nsample], cnt [B, M]), int32."""
    B, N, _ = xyz.shape
    M = centers.shape[1]
    dev = xyz.device
    r2 = torch.tensor(_f32(radius * radius), dtype=torch.float32, device=dev)
    rmin2 = torch.tensor(_f32(min_radius * min_radius), dtype=torch.float32,
                         device=dev)
    idx = torch.zeros(B, M, nsample, dtype=torch.int32, device=dev)
    cnt = torch.zeros(B, M, dtype=torch.int32, device=dev)
    if not (B and M and N and nsample):
        return idx, cnt
    order = torch.arange(N, device=dev)
    slots = torch.arange(nsample, device=dev)
    k = min(nsample, N)
    chunk = max(1, QUERY_CHUNK_PAIRS // (B * N))
    for m0 in range(0, M, chunk):
        c = centers[:, m0:m0 + chunk]
        d2 = square_distance(c, xyz)
        inb = (d2 <= r2) & xyz_mask[:, None, :]
        if min_radius > 0.0:
            inb &= d2 > rmin2
        n_in = inb.sum(-1)
        first = torch.where(inb, order, N).topk(k, -1, largest=False).values
        n = n_in.clamp(1, k)
        got = first.gather(-1, (slots % n[..., None]))
        live = (n_in > 0) & center_mask[:, m0:m0 + chunk]
        idx[:, m0:m0 + chunk] = torch.where(live[..., None], got, 0).int()
        cnt[:, m0:m0 + chunk] = n_in.int()
    return idx, cnt


def ball_query_plan(B: int, M: int, N: int) -> tuple[int, int]:
    """BALL_QUERY's launch for B samples of M centres over N points: (CW,
    S), CW centres a warp (8 warps a CTA) and the points split into S
    index-ordered slices, one CTA of a cluster each. From the plans timed
    on the H100 (``utils/pn2_phases.py --ball --sweep``, device time at
    SSD3D's four groupings, batch 1 and 2): CW 1 up to 2^22 (centre,
    point) pairs, 2 up to 2^24, 4 up to 2^26, 8 above; 2 slices from
    4096 points, else 1 (more slices, or 1 at 16384 points, lost)."""
    pairs = B * M * N
    cw = next((c for c, top in ((1, 1 << 22), (2, 1 << 24), (4, 1 << 26))
               if pairs <= top), 8)
    return cw, 2 if N >= 4096 else 1


def _bq_points(xyz, xyz_mask):
    """The points and mask as the kernel reads them: f32 and bool, N padded
    with invalid points to a multiple of 16 (at least 16), each sample's
    rows 16-byte aligned."""
    pts = as_kernel_arg(xyz.detach(), torch.float32)
    pm = as_kernel_arg(xyz_mask, torch.bool)
    B, N, _ = pts.shape
    pad = max(BQ_POINT_ALIGN, -(-N // BQ_POINT_ALIGN) * BQ_POINT_ALIGN) - N
    if pad:
        pts = torch.cat([pts, pts.new_zeros(B, pad, 3)], 1)
        pm = torch.cat([pm, pm.new_zeros(B, pad)], 1)
    if pts.data_ptr() % 16:
        pts = pts.clone()
    if pm.data_ptr() % 16:
        pm = pm.clone()
    return pts, pm


@functools.lru_cache(maxsize=64)
def _bq_params(radii, mins, nsamples):
    """BALL_QUERY's host arrays of a radius list (r^2, the lower bound's
    square or -1 for none, the slots), kept for the next call."""
    R = len(radii)
    r2 = (ctypes.c_float * R)(*[_f32(r * r) for r in radii])
    # no lower bound: -1, below any squared distance
    min2 = (ctypes.c_float * R)(*[_f32(m * m) if m > 0.0 else -1.0
                                  for m in mins])
    ks = (ctypes.c_int * R)(*nsamples)
    return (r2, min2, ks), (ctypes.addressof(r2), ctypes.addressof(min2),
                            ctypes.addressof(ks))


def _ball_query_card(radii, mins, nsamples, xyz, xyz_mask, centers,
                     center_mask, plan=None, kernel=None):
    """One BALL_QUERY launch (``kernel``: another build of it) for every
    radius, under ``plan`` (CW, S; :func:`ball_query_plan`'s when None):
    [(idx, cnt)]."""
    B, N, _ = xyz.shape
    M = centers.shape[1]
    R = len(radii)
    if (xyz.shape[-1] != 3 or centers.shape != (B, M, 3)
            or xyz_mask.shape != (B, N) or center_mask.shape != (B, M)):
        raise ValueError(f'ball query of centres {tuple(centers.shape)} '
                         f'over points {tuple(xyz.shape)}: shapes differ')
    if not 1 <= R <= BQ_MAX_RADII or min(nsamples) < 1:
        raise ValueError(f'BALL_QUERY takes 1 to {BQ_MAX_RADII} radii of 1 '
                         f'or more samples, got {list(nsamples)}')
    pts, pm = _bq_points(xyz, xyz_mask)
    ctr = as_kernel_arg(centers.detach(), torch.float32)
    cm = as_kernel_arg(center_mask, torch.bool)
    idx = torch.empty(B * M * sum(nsamples), dtype=torch.int32,
                      device=pts.device)
    cnt = torch.empty(R, B, M, dtype=torch.int32, device=pts.device)
    if B and M:
        _, ptrs = _bq_params(tuple(radii), tuple(mins), tuple(nsamples))
        (kernel or BALL_QUERY)(
            pts.data_ptr(), pm.data_ptr(), ctr.data_ptr(), cm.data_ptr(), B,
            pts.shape[1], M, R, *ptrs, *(plan or ball_query_plan(B, M, N)),
            idx.data_ptr(), cnt.data_ptr(), stream_handle())
    out, off = [], 0
    for k, c in zip(nsamples, cnt.unbind(0)):
        out.append((idx.as_strided((B, M, k), (M * k, k, 1), off), c))
        off += B * M * k
    return out


def ball_query(radius: float, nsample: int, xyz, xyz_mask, centers,
               center_mask, min_radius: float = 0.0):
    """:func:`ball_query_plain`'s function (kernel ``BALL_QUERY`` on the
    card). Returns (idx [B, M, nsample], cnt [B, M]), int32."""
    if not on_card(xyz, xyz_mask, centers, center_mask):
        return ball_query_plain(radius, nsample, xyz, xyz_mask, centers,
                                center_mask, min_radius)
    if nsample < 1:
        B, M = center_mask.shape
        return (torch.zeros(B, M, 0, dtype=torch.int32, device=xyz.device),
                torch.zeros(B, M, dtype=torch.int32, device=xyz.device))
    return _ball_query_card([radius], [min_radius], [nsample], xyz,
                            xyz_mask, centers, center_mask)[0]


def _min_radii(radii, dilated):
    """Each radius's lower bound: the previous radius when ``dilated`` (the
    first 0), else 0."""
    return [radii[i - 1] if dilated and i else 0.0
            for i in range(len(radii))]


def ball_query_multi_plain(radii, nsamples, xyz, xyz_mask, centers,
                           center_mask, dilated: bool = False):
    """:func:`ball_query_multi`'s function: :func:`ball_query_plain` for
    each radius."""
    return [ball_query_plain(float(r), int(k), xyz, xyz_mask, centers,
                             center_mask, m)
            for r, k, m in zip(radii, nsamples, _min_radii(radii, dilated))]


def ball_query_multi(radii, nsamples, xyz, xyz_mask, centers, center_mask,
                     dilated: bool = False):
    """The ball queries of a multi-scale grouping, one (idx, cnt) a radius,
    each :func:`ball_query`'s with ``min_radius`` the previous radius when
    ``dilated`` (the first 0), else 0. On the card one ``BALL_QUERY``
    launch computes each (centre, point) distance once and tests it against
    every radius (up to 4)."""
    if not on_card(xyz, xyz_mask, centers, center_mask):
        return ball_query_multi_plain(radii, nsamples, xyz, xyz_mask,
                                      centers, center_mask, dilated)
    radii = [float(r) for r in radii]
    return _ball_query_card(radii, _min_radii(radii, dilated),
                            [int(k) for k in nsamples], xyz, xyz_mask,
                            centers, center_mask)


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features [B, N, C], idx [B, S] → [B, S, C]."""
    i = idx.long()[..., None].expand(-1, -1, features.shape[-1])
    return torch.gather(features, 1, i)


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features [B, N, C], idx [B, M, K] → [B, M, K, C]."""
    B, M, K = idx.shape
    return gather_points(features, idx.reshape(B, M * K)).reshape(
        B, M, K, features.shape[-1])


def three_nn(unknown, known, known_mask):
    """The 3 nearest valid known points of each unknown point (ties: the
    lower index first). Returns (dist [B, N, 3], idx [B, N, 3] int32)."""
    d2 = square_distance(unknown, known)
    d2 = torch.where(known_mask[:, None, :], d2,
                     torch.tensor(BIG, dtype=d2.dtype, device=d2.device))
    val, idx = d2.sort(dim=-1, stable=True)
    return val[..., :3].clamp(min=0.0).sqrt(), idx[..., :3].int()


def three_interpolate(features, idx, dist):
    """Inverse-squared-distance weighted sum of 3 neighbours' features:
    features [B, M, C], idx / dist [B, N, 3] → [B, N, C]."""
    w = 1.0 / (dist * dist).clamp(min=1e-8)
    w = w / w.sum(-1, keepdim=True)
    return (group_points(features, idx) * w[..., None]).sum(2)


def group_balls(idx, cnt, xyz, centers, center_mask, features=None,
                use_xyz: bool = True):
    """A ball query's groups: [B, M, K, 3 (+C)], the points' coordinates
    relative to their centre (then their features), zeros for an empty ball
    or an invalid centre."""
    grouped = group_points(xyz, idx) - centers[:, :, None, :]
    if features is not None:
        feats = group_points(features, idx)
        grouped = torch.cat([grouped, feats], -1) if use_xyz else feats
    empty = (cnt == 0) | ~center_mask
    return torch.where(empty[..., None, None], 0.0, grouped)


def query_and_group(radius: float, nsample: int, xyz, xyz_mask, centers,
                    center_mask, features=None, use_xyz: bool = True,
                    min_radius: float = 0.0):
    """Ball query, grouping and centre-relative coordinates: (grouped
    [B, M, K, 3 (+C)], zeros for an empty ball or invalid centre; idx;
    cnt)."""
    idx, cnt = ball_query(radius, nsample, xyz, xyz_mask, centers,
                          center_mask, min_radius)
    return (group_balls(idx, cnt, xyz, centers, center_mask, features,
                        use_xyz), idx, cnt)
