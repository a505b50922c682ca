"""Per-pillar max over points sorted by pillar slot: kernel K5 and its plain
version (counterpart of ``tmae_tpu/ops/sorted_segments.py``).

The serving path voxelizes on the host with ``sort_points=True``, so a
pillar's points are one contiguous run of rows and ``seg_ends`` names each
run's last row. The CUDA kernel (``csrc/segment_max.cu``) reduces each run
with one warp. The plain version repeats the TPU kernel's algorithm: a
segmented running max over the sorted rows, then one gather at ``seg_ends``.
"""

from __future__ import annotations

import torch

from ..device import on_card
from ..utils.build import CudaKernel, I, P, stream_handle

K5 = CudaKernel('segment_max.cu', 'launch_sorted_segment_max',
                [P, P, P, P, I, I, I, I, P])


def segmented_running_max(feat: torch.Tensor, seg: torch.Tensor):
    """Inclusive running max within runs of equal ``seg`` along dim 1.
    feat [B, P, C], seg [B, P] non-decreasing per row (log2(P) doubling
    steps, as the TPU scan kernel does inside a block)."""
    x = feat
    n = feat.shape[1]
    k = 1
    while k < n:
        same = (seg[:, k:] == seg[:, :-k])[..., None]
        tail = torch.where(same, torch.maximum(x[:, k:], x[:, :-k]), x[:, k:])
        x = torch.cat([x[:, :k], tail], dim=1)
        k *= 2
    return x


def sorted_segment_max_plain(feat, seg, seg_ends, seg_mask,
                             num_segments: int):
    """Plain PyTorch version of :func:`sorted_segment_max`."""
    B, Pn, C = feat.shape
    run = segmented_running_max(feat, seg)
    ends = seg_ends[:, :num_segments].long().clamp(0, Pn - 1)
    out = torch.gather(run, 1, ends[..., None].expand(B, num_segments, C))
    return torch.where(seg_mask[:, :num_segments, None], out, 0.0)


def sorted_segment_max(feat: torch.Tensor, seg: torch.Tensor,
                       seg_ends: torch.Tensor, seg_mask: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Per-segment max over rows sorted by segment id.

    feat [B, P, C] f32; seg [B, P] non-decreasing (invalid rows carry the
    out-of-range slot ``num_segments`` and are never gathered); seg_ends
    [B, V] index of each segment's last row; seg_mask [B, V] segment-present
    flags. Returns [B, V, C] with 0 for absent segments.

    The CUDA kernel reads only ``seg_ends`` and ``seg_mask``: it takes
    segment v to be rows ``(seg_ends[v-1], seg_ends[v]]`` (row 0 onward for
    v = 0), which holds for ``voxelize_host(..., sort_points=True)`` output,
    whose present slots are 0..n-1 in ascending order.
    """
    if not on_card(feat, seg_ends, seg_mask):
        return sorted_segment_max_plain(feat, seg, seg_ends, seg_mask,
                                        num_segments)
    B, Pn, C = feat.shape
    V = num_segments
    if feat.dtype != torch.float32 or C % 4:
        raise ValueError('sorted_segment_max kernel takes f32 with C % 4 == 0')
    feat = feat.contiguous()
    ends = seg_ends[:, :V].to(torch.int32).contiguous()
    mask = seg_mask[:, :V].to(torch.bool).contiguous()
    out = torch.empty(B, V, C, dtype=torch.float32, device=feat.device)
    K5(feat.data_ptr(), ends.data_ptr(), mask.data_ptr(), out.data_ptr(),
       B, Pn, V, C, stream_handle())
    return out
