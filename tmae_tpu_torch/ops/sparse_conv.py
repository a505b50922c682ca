"""Occupancy-aware 3x3 submanifold convolution on the dense BEV carrier
(counterpart of ``tmae_tpu/ops/sparse_conv.py``).

The conv is computed only on the occupied 8x8 windows that an unshifted
plan names (``build_compact_info(occ, 8, False, ...)``): kernel K15 writes
each planned window's conv output, masked per cell by the plan's ``qmask``,
into a compact ``[B, cap, 64, Cout]`` tensor, and the unpadded scatter
(K2 into a zero carrier, the JAX package's K13b) lays it out on the grid
with zeros elsewhere. K15 (``csrc/subm_conv.cu``) packs the weights into
wgmma panels, flags the live slots, compacts them into a device-side list
and runs persistent tiles of two live windows, each window's 3x3 taps read
straight out of its 10x10 halo in shared memory (the addressing that
:func:`subm_conv_tiles_plain` spells out in torch ops). The backward is
the JAX package's: the dense transposed conv of the cotangent masked to
the plan's cells, the conv for the weight gradient and the sum for the
bias gradient, in f32 (cuDNN on the card, as XLA's dense convolutions on
the TPU).

Layouts are the JAX package's: NHWC grids and HWIO weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import on_card
from ..utils.build import CudaKernel, I, P, stream_handle
from .dense_windows import window_geometry
from .occ_compact import scatter_windows, scatter_windows_plain

K15 = CudaKernel('subm_conv.cu', 'launch_subm_conv',
                 [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P])
WIDTHS = (128, 256)  # the widths K15 is compiled for (Cin = Cout)


def _halos(xg, idx, window: int):
    """The (w+2) x (w+2) neighbourhoods of the planned windows, in f32:
    [B * cap, Cin, w+2, w+2], zeros off the grid (SAME padding) and for
    dummy slots. Window (wy, wx) of the unshifted plan covers grid rows
    w(wy-1) .. w wy - 1; its halo starts one row and one column before."""
    B, H, W, C = xg.shape
    nwy, nwx, Hp, Wp = window_geometry((H, W), window)
    w, h = window, window + 2
    # padded row r holds grid row r - w - 1: the halo of window wy starts at
    # padded row w wy, the dummy window row (wy = nwy) included
    x = F.pad(xg.float(), (0, 0, w + 1, Wp + h - W - w - 1,
                           w + 1, Hp + h - H - w - 1))
    x = x.unfold(1, h, w).unfold(2, h, w)          # [B, nwy+1, nwx+1, C, h, h]
    wy = idx[..., 0].long().clamp(0, nwy)
    wx = idx[..., 1].long().clamp(0, nwx)
    bi = torch.arange(B, device=xg.device)[:, None]
    return x[bi, wy, wx].reshape(-1, C, h, h)


def subm_conv_windows_plain(xg, idx, qmask, wmat, bias, window: int):
    """Plain version of :func:`subm_conv_windows`."""
    B, cap = idx.shape[:2]
    cout = wmat.shape[-1]
    w = window
    out = F.conv2d(_halos(xg, idx, w), wmat.float().permute(3, 2, 0, 1))
    out = out + bias.float()[:, None, None]
    out = out.reshape(B, cap, cout, w * w).transpose(2, 3)
    return (out * qmask.float()[..., None]).to(xg.dtype)


def _check(xg, idx, qmask, wmat, bias, window):
    B, H, W, C = xg.shape
    if window != 8:
        raise ValueError('the SubM conv kernel takes 8x8 windows')
    if xg.dtype != torch.bfloat16 or wmat.dtype != torch.bfloat16:
        raise ValueError('the SubM conv kernel takes bf16 grids and weights')
    if C not in WIDTHS or wmat.shape != (3, 3, C, C):
        raise ValueError(f'the SubM conv kernel is compiled for Cin = Cout '
                         f'in {WIDTHS} only, not weights '
                         f'{tuple(wmat.shape)}')
    if idx.dtype != torch.int32 or idx.dim() != 3 or idx.shape[0] != B or \
            idx.shape[2] != 2:
        raise ValueError('window plan must be int32 [B, cap, 2]')
    if qmask.shape != (B, idx.shape[1], 64):
        raise ValueError('qmask must be [B, cap, 64]')
    if bias.shape != (wmat.shape[3],):
        raise ValueError('bias must be [Cout]')


def subm_conv_windows(xg, idx, qmask, wmat, bias, window: int):
    """The 3x3 SAME conv of ``xg`` [B, H, W, Cin] with ``wmat``
    [3, 3, Cin, Cout] plus ``bias``, on the windows of the unshifted plan
    ``idx`` [B, cap, 2], each cell times its ``qmask`` [B, cap, 64]:
    [B, cap, 64, Cout] in ``xg``'s dtype (zeros for dummy slots and slots
    without a query). Kernel K15 on the card (Cin = Cout = 128 or 256): four
    launches on the current stream, no host synchronisation."""
    if not on_card(xg, idx, qmask, wmat, bias):
        return subm_conv_windows_plain(xg, idx, qmask, wmat, bias, window)
    _check(xg, idx, qmask, wmat, bias, window)
    B, H, W, C = xg.shape
    cap = idx.shape[1]
    nwy, nwx, _, _ = window_geometry((H, W), window)
    xg, idx, wmat = xg.contiguous(), idx.contiguous(), wmat.contiguous()
    if xg.data_ptr() % 16:
        raise ValueError('the SubM conv kernel takes a 16-byte aligned grid')
    qmask = qmask.float().contiguous()
    bias = bias.float().contiguous()
    if bias.data_ptr() % 8:
        bias = bias.clone()
    dev = xg.device
    out = torch.empty(B, cap, 64, C, dtype=xg.dtype, device=dev)
    panels = torch.empty(9 * C * C, dtype=torch.bfloat16, device=dev)
    ints = torch.empty(2 * B * cap + 2, dtype=torch.int32, device=dev)
    K15(xg.data_ptr(), idx.data_ptr(), qmask.data_ptr(), wmat.data_ptr(),
        bias.data_ptr(), out.data_ptr(), panels.data_ptr(), ints.data_ptr(),
        B, H, W, C, cap, nwy, nwx, stream_handle())
    return out


def subm_panels_plain(wmat):
    """Plain version of K15's weight pack: ``wmat`` [3, 3, Cin, Cout] as the
    wgmma panels the kernel streams, in its order (pass of 128 output
    columns, tap, chunk of 64 input channels), each panel's element (n, k)
    = wmat[tap, 64 chunk + k, 128 pass + n] at ((n // 8) * 8 + k // 8) * 64
    + (n % 8) * 8 + k % 8. Returns the flat panels [9 Cin Cout] in
    ``wmat``'s dtype."""
    cin, cout = wmat.shape[2:]
    w = wmat.reshape(9, cin // 64, 8, 8, cout // 128, 16, 8)
    return w.permute(4, 0, 1, 5, 2, 6, 3).reshape(-1)


def subm_conv_tiles_plain(xg, idx, qmask, wmat, bias, window: int):
    """K15's schedule and addressing in torch ops (f32 sums): the live
    slots (a window of the partition with a query cell; every other slot
    zero), each one's halo in core-matrix order [Cin / 8][100 cells][8],
    and for tap (ky, kx) and chunk kq of 64 channels the A operand read out
    of the halo at cell offset ky 10 + kx + 800 kq with window-row stride
    10 cells, cell stride 1 and 8-channel stride 100 cells, against the
    panel of :func:`subm_panels_plain` unpacked to W_t [128, 64]; then
    (sum + bias) * qmask rounded to ``xg``'s dtype. Same function as
    :func:`subm_conv_windows_plain`, summed in the kernel's order of taps
    and chunks."""
    B, cap = idx.shape[:2]
    H, W, cin = xg.shape[1:]
    cout = wmat.shape[3]
    nwy, nwx, _, _ = window_geometry((H, W), window)
    wy, wx = idx[..., 0], idx[..., 1]
    real = (wy >= 0) & (wy < nwy) & (wx >= 0) & (wx < nwx)
    live = (real & (qmask != 0).any(-1)).reshape(-1).nonzero()[:, 0]
    out = torch.zeros(B * cap, 64, cout, dtype=xg.dtype, device=xg.device)
    if len(live) == 0:
        return out.reshape(B, cap, 64, cout)
    halo = _halos(xg, idx, window)[live]              # [N, Cin, 10, 10]
    core = halo.reshape(len(live), cin // 8, 8, 100).transpose(2, 3)
    core = core.contiguous().reshape(len(live), -1)   # [N, Cin / 8 100 8]
    panels = subm_panels_plain(wmat).float().reshape(
        cout // 128, 9, cin // 64, 16, 8, 8, 8)       # n16, kc, n8, k8
    qm = qmask.reshape(B * cap, 64)[live].float()
    for p in range(cout // 128):
        acc = torch.zeros(len(live), 64, 128, device=xg.device)
        for tap in range(9):
            for kq in range(cin // 64):
                base = (tap // 3) * 10 + tap % 3 + kq * 8 * 100
                a = core.as_strided(
                    (len(live), 8, 8, 8, 8),
                    (core.shape[1], 10 * 8, 8, 100 * 8, 1),
                    core.storage_offset() + base * 8).reshape(-1, 64, 64)
                wt = panels[p, tap, kq].permute(0, 2, 1, 3).reshape(128, 64)
                acc = acc + a @ wt.t()
        y = (acc + bias.float()[128 * p:128 * (p + 1)]) * qm[..., None]
        out[live, :, 128 * p:128 * (p + 1)] = y.to(xg.dtype)
    return out.reshape(B, cap, 64, cout)


def plan_cells(idx, qmask, grid_hw, window: int):
    """[B, H, W, 1] bool: the cells that the plan's qmask sets (the conv's
    output support). The mask goes through the unpadded scatter, as the
    JAX package's goes through ``_scatter_out`` (there in f32 with 8
    channels; here in bf16, which holds 0 and 1 exactly)."""
    m = qmask.to(torch.bfloat16)[..., None].expand(*qmask.shape, 8)
    return scatter_windows(m.contiguous(), idx, grid_hw, window, False,
                           zero_fill=True)[..., :1] > 0


def subm_conv3x3_plain(xg, idx, qmask, wmat, bias, grid_hw, window: int):
    """Plain version of :func:`subm_conv3x3` (``_subm_conv_ref``): the dense
    SAME conv in f32 plus bias, zero outside the plan's occupied cells."""
    out = F.conv2d(xg.float().permute(0, 3, 1, 2),
                   wmat.float().permute(3, 2, 0, 1), padding=1)
    out = out.permute(0, 2, 3, 1) + bias.float()
    m = qmask.float()[..., None].expand(*qmask.shape, 8)
    mask = scatter_windows_plain(m, idx, grid_hw, window, False)[..., :1] > 0
    return (out * mask).to(xg.dtype)


class _SubMConv3x3(torch.autograd.Function):
    """Forward K15 then the zero-fill scatter (K13b); backward dense convs
    of the masked cotangent in f32."""

    @staticmethod
    def forward(ctx, xg, idx, qmask, wmat, bias, grid_hw, window):
        ctx.geom = (grid_hw, window)
        ctx.save_for_backward(xg, idx, qmask, wmat, bias)
        out_w = subm_conv_windows(xg, idx, qmask, wmat, bias, window)
        return scatter_windows(out_w, idx, grid_hw, window, False,
                               zero_fill=True)

    @staticmethod
    def backward(ctx, g):
        xg, idx, qmask, wmat, bias = ctx.saved_tensors
        grid_hw, window = ctx.geom
        gm = (g.float() * plan_cells(idx, qmask, grid_hw, window))
        gm = gm.permute(0, 3, 1, 2)
        wf = wmat.float().permute(3, 2, 0, 1)            # OIHW
        xf = xg.float().permute(0, 3, 1, 2)
        dx = torch.nn.grad.conv2d_input(xf.shape, wf, gm, padding=1)
        dw = torch.nn.grad.conv2d_weight(xf, wf.shape, gm, padding=1)
        db = gm.sum((0, 2, 3))
        return (dx.permute(0, 2, 3, 1).to(xg.dtype), None, None,
                dw.permute(2, 3, 1, 0).to(wmat.dtype), db.to(bias.dtype),
                None, None)


def subm_conv3x3(xg, idx, qmask, wmat, bias, grid_hw, window: int):
    """Occupancy-aware 3x3 SubM conv: ``xg`` [B, H, W, Cin] →
    [B, H, W, Cout], computed only on the occupied windows of the unshifted
    plan ``idx`` (cells masked per ``qmask``), zeros elsewhere. K15 and K2
    on the card (Cin = Cout = 128 or 256)."""
    return _SubMConv3x3.apply(xg, idx, qmask, wmat, bias, tuple(grid_hw),
                              window)
