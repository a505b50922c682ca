"""Per-pillar max over points sorted by pillar slot: kernel K5 and its plain
version (counterpart of ``tmae_tpu/ops/sorted_segments.py``).

The serving path voxelizes on the host with ``sort_points=True``, so a
pillar's points are one contiguous run of rows and ``seg_ends`` names each
run's last row. The CUDA kernel (``csrc/segment_max.cu``) splits the work by
rows: slices of ``SLICE_ROWS`` rows, each reduced by one warp, then a merge
of the pillars that span slices. The plain version repeats the TPU kernel's
algorithm: a segmented running max over the sorted rows, then one gather at
``seg_ends``. Training differentiates it through
:func:`sorted_segment_max_train`.
"""

from __future__ import annotations

import torch

from ..device import as_kernel_arg, on_card
from ..utils.build import CudaKernel, I, P, stream_handle

K5 = CudaKernel('segment_max.cu', 'launch_sorted_segment_max',
                [P, P, I, P, P, P, P, I, I, I, I, P])
SLICE_ROWS = 64  # rows a warp of the kernel's first pass (kSlice)


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

    The CUDA kernel reads ``seg`` for the slices and ``seg_ends`` and
    ``seg_mask`` for the merge: it takes segment v to be rows
    ``(seg_ends[v-1], seg_ends[v]]`` (row 0 onward for v = 0), which holds
    for ``voxelize_host(..., sort_points=True)`` output, whose present slots
    are 0..n-1 in ascending order. One call is two launches, counted once.
    """
    if not on_card(feat, seg, seg_ends, seg_mask):
        return sorted_segment_max_plain(feat, seg, seg_ends, seg_mask,
                                        num_segments)
    B, Pn, C = feat.shape
    V = num_segments
    if feat.dtype != torch.float32 or C % 4:
        raise ValueError('sorted_segment_max kernel takes f32 with C % 4 == 0')
    # no dispatch for an argument that is already as the kernel takes it
    # (a call's host time is most of its time)
    if not feat.is_contiguous():
        feat = feat.contiguous()
    if feat.data_ptr() % 16:
        raise ValueError('sorted_segment_max kernel takes 16-byte aligned '
                         'rows')
    seg = as_kernel_arg(seg, seg.dtype if seg.dtype == torch.int64
                        else torch.int32)
    ends = as_kernel_arg(seg_ends if seg_ends.shape[1] == V
                         else seg_ends[:, :V], torch.int32)
    mask = as_kernel_arg(seg_mask if seg_mask.shape[1] == V
                         else seg_mask[:, :V], torch.bool)
    # out, then the slices' head / tail maxima, in one allocation
    ns = -(-Pn // SLICE_ROWS)
    buf = torch.empty(B * (V + 2 * ns) * C, dtype=torch.float32,
                      device=feat.device)
    base = buf.data_ptr()
    K5(feat.data_ptr(), seg.data_ptr(), int(seg.dtype == torch.int64),
       ends.data_ptr(), mask.data_ptr(), base, base + 4 * B * V * C, B, Pn,
       V, C, stream_handle())
    return buf.as_strided((B, V, C), (V * C, C, 1))


def sorted_segment_max_bwd(feat, seg, seg_mask, out, g, num_segments: int):
    """Gradient of the per-segment max for upstream ``g`` [B, V, C]: split
    evenly among the rows that reach their segment's max (the tie rule of
    the JAX package's ``_ssm_bwd``, itself jnp there, so plain PyTorch is
    its port)."""
    V = num_segments
    safe = seg.long().clamp(max=V - 1)[..., None].expand_as(feat)
    eq = (feat == torch.gather(out, 1, safe)) & (seg < V)[..., None]
    idx = seg.long().clamp(max=V)[..., None].expand_as(feat)
    cnt = feat.new_zeros(feat.shape[0], V + 1, feat.shape[2]).scatter_add_(
        1, idx, eq.to(feat.dtype))[:, :V]
    g = torch.where(seg_mask[:, :V, None], g, 0.0)
    share = torch.gather(g / cnt.clamp(min=1.0), 1, safe)
    return torch.where(eq, share, 0.0).to(feat.dtype)


class _SortedSegmentMax(torch.autograd.Function):
    """Forward K5; the backward is :func:`sorted_segment_max_bwd`."""

    @staticmethod
    def forward(ctx, feat, seg, seg_ends, seg_mask, num_segments):
        out = sorted_segment_max(feat, seg, seg_ends, seg_mask, num_segments)
        ctx.num_segments = num_segments
        ctx.save_for_backward(feat, seg, seg_mask, out)
        return out

    @staticmethod
    def backward(ctx, g):
        feat, seg, seg_mask, out = ctx.saved_tensors
        return (sorted_segment_max_bwd(feat, seg, seg_mask, out, g,
                                       ctx.num_segments),
                None, None, None, None)


def sorted_segment_max_train(feat, seg, seg_ends, seg_mask,
                             num_segments: int):
    """Differentiable :func:`sorted_segment_max` (counterpart of the JAX
    package's custom VJP)."""
    return _SortedSegmentMax.apply(feat, seg, seg_ends, seg_mask,
                                   num_segments)
