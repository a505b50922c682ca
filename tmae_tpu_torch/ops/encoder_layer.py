"""The cosine-attention SST encoder layer on gathered window rows: kernels K3
(all 64 cells) and K4 (S selected cells) and their plain version
(counterpart of ``tmae_tpu/ops/pallas_encoder.py:encoder_layer_rows_full``,
``encoder_layer_rows_sel``, ``reference_encoder_layer`` and
``reference_encoder_layer_sel``).

Both entry points update rows ``[row_lo, row_lo + cap)`` of the window
tensor ``xw_all [B, total, 64, C]`` in place and return it. The plain version
follows the kernels' numerics: bf16 matmul inputs with f32 accumulation,
bf16 where the TPU kernel casts, f32 LayerNorm residual.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import on_card
from ..utils.build import CudaKernel, F as CF, I, P, stream_handle

_W = ctypes.POINTER(ctypes.c_void_p)
K3 = CudaKernel('encoder_layer.cu', 'launch_encoder_rows_full',
                [P, P, P, P, P, _W, I, I, I, I, I, I, I, I, CF, P])
K4 = CudaKernel('encoder_layer.cu', 'launch_encoder_rows_sel',
                [P, P, P, P, P, P, P, _W, I, I, I, I, I, I, I, I, I, CF, P])


class LayerParams(NamedTuple):
    """Weights of one layer as the kernels take them: Linear weights
    ``[out, in]`` in bf16, everything else f32."""

    wq: torch.Tensor
    bq: torch.Tensor
    wk: torch.Tensor
    bk: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor
    tau: torch.Tensor
    ln1s: torch.Tensor
    ln1b: torch.Tensor
    f1w: torch.Tensor
    f1b: torch.Tensor
    f2w: torch.Tensor
    f2b: torch.Tensor
    ln2s: torch.Tensor
    ln2b: torch.Tensor


def _bf(x):
    return x.to(torch.bfloat16).float()


def _mm(a, w):
    """a (f32 holding bf16 values) @ w.T with w a bf16 Linear weight."""
    return a @ w.float().t()


def _ln(x, scale, bias, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _take(rows, sel):
    """rows [B, cap, 64, C], sel [B, cap, S] → [B, cap, S, C]."""
    C = rows.shape[-1]
    return torch.gather(rows, 2, sel.long()[..., None].expand(-1, -1, -1, C))


def reference_encoder_layer_rows(xw_all, kv_all, sel_q, sel_k, qmask, kmask,
                                 pos, p: LayerParams, nhead: int,
                                 tau_min: float, cross: bool, row_lo: int):
    """Plain version of K3 (``sel_q is None``) and K4. In self mode the keys
    are the query cells: ``kv_all``, ``sel_k`` and ``kmask`` are ignored."""
    B, total, T64, C = xw_all.shape
    cap = qmask.shape[1]
    rows = xw_all[:, row_lo:row_lo + cap]
    posf = pos.float()
    if sel_q is None:
        x = rows.float()
        pq = posf
    else:
        x = _take(rows, sel_q).float()
        pq = posf[sel_q.long()]
    qm = qmask > 0
    if cross:
        kvr = kv_all[:, row_lo:row_lo + cap]
        if sel_q is None:
            kv, pk = kvr.float(), posf
        else:
            kv, pk = _take(kvr, sel_k).float(), posf[sel_k.long()]
        km = kmask > 0
    else:
        kv, pk, km = x, pq, qm
    q = _mm(_bf(x + pq), p.wq) + p.bq
    k = _mm(_bf(kv + pk), p.wk) + p.bk
    v = _mm(kv, p.wv) + p.bv
    T = x.shape[2]
    H, D = nhead, C // nhead
    qh = q.reshape(B, cap, T, H, D)
    kh = k.reshape(B, cap, T, H, D)
    vh = _bf(v.reshape(B, cap, T, H, D))
    scale = 1.0 / torch.clamp(p.tau.float(), min=tau_min)
    qn = _bf(qh * torch.rsqrt(qh.square().sum(-1, keepdim=True) + 1e-24)
             * scale)
    kn = _bf(kh * torch.rsqrt(kh.square().sum(-1, keepdim=True) + 1e-24))
    logits = torch.einsum('bwthd,bwshd->bwhts', qn, kn)
    logits = torch.where(km[:, :, None, None, :], logits, -30000.0)
    prob = torch.softmax(logits, dim=-1)
    prob = torch.where(km.any(-1)[:, :, None, None, None], prob, 0.0)
    attn = torch.einsum('bwhts,bwshd->bwthd', _bf(prob), vh)
    o = _mm(_bf(attn.reshape(B, cap, T, C)), p.wo) + p.bo
    qmc = qm[..., None]
    h = _ln(x + torch.where(qmc, o, 0.0), p.ln1s, p.ln1b)
    h = torch.where(qmc, h, 0.0)
    ff = F.gelu(_mm(_bf(h), p.f1w) + p.f1b)
    ff = _mm(_bf(ff), p.f2w) + p.f2b
    out = _ln(h + ff, p.ln2s, p.ln2b)
    if sel_q is None:
        new = torch.where(qmc, out, 0.0).to(xw_all.dtype)
    else:
        delta = _bf(torch.where(qmc, out - x, 0.0))
        vals = (x + delta).to(xw_all.dtype)
        new = rows.scatter(2, sel_q.long()[..., None].expand(-1, -1, -1, C),
                           vals)
    xw_all[:, row_lo:row_lo + cap] = new
    return xw_all


def _weight_ptrs(p: LayerParams):
    for name, t in zip(p._fields, p):
        want = torch.bfloat16 if name in ('wq', 'wk', 'wv', 'wo', 'f1w',
                                          'f2w') else torch.float32
        if t.dtype != want or not t.is_contiguous() or not t.is_cuda:
            raise ValueError(f'layer parameter {name} must be a contiguous '
                             f'CUDA {want} tensor')
    return (ctypes.c_void_p * len(p))(*[t.data_ptr() for t in p])


def _check_rows(xw_all, kv_all, qmask, kmask, cross, row_lo, p, nhead,
                sel_q=None):
    """What the kernel takes: C a multiple of 32 up to 256, head width 16
    or 32, FFN width a multiple of 128, T (the mask width) 16, 48 or 64."""
    if xw_all.dtype != torch.bfloat16 or not xw_all.is_contiguous():
        raise ValueError('xw_all must be a contiguous bf16 tensor')
    B, total, cells, C = xw_all.shape
    if cells != 64:
        raise ValueError('window rows hold 64 cells')
    if C % 32 or C > 256 or C % nhead or C // nhead not in (16, 32):
        raise ValueError(f'kernel takes C % 32 == 0, C <= 256 and head width '
                         f'16 or 32, not C={C}, nhead={nhead}')
    if p.f1w.shape[0] % 128:
        raise ValueError('kernel takes an FFN width that is a multiple of 128')
    if qmask.shape[0] != B or qmask.shape[2] not in (16, 48, 64):
        raise ValueError(f'mask shape {tuple(qmask.shape)} does not fit')
    if sel_q is not None and sel_q.shape != qmask.shape:
        raise ValueError('sel_q and qmask differ in shape')
    cap = qmask.shape[1]
    if row_lo < 0 or row_lo + cap > total:
        raise ValueError('row range outside xw_all')
    if cross and (kv_all is None or kv_all.shape != xw_all.shape
                  or not kv_all.is_contiguous() or kmask is None):
        raise ValueError('cross mode needs kv_all shaped like xw_all and kmask')


def _f32(t):
    return None if t is None else t.to(torch.float32).contiguous()


def _i32(t):
    return None if t is None else t.to(torch.int32).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def encoder_layer_rows_full(xw_all, kv_all, qmask, kmask, pos,
                            p: LayerParams, *, nhead: int, tau_min: float,
                            cross: bool, row_lo: int):
    """Full-window layer over rows [row_lo, row_lo + cap) of ``xw_all``, in
    place; ``qmask``/``kmask`` [B, cap, 64]. Kernel K3 on the card."""
    if not on_card(xw_all, qmask):
        return reference_encoder_layer_rows(
            xw_all, kv_all, None, None, qmask, kmask, pos, p, nhead, tau_min,
            cross, row_lo)
    _check_rows(xw_all, kv_all, qmask, kmask, cross, row_lo, p, nhead)
    if qmask.shape[2] != 64:
        raise ValueError('the full-window kernel takes [B, cap, 64] masks')
    B, total, _, C = xw_all.shape
    qmask, kmask = _f32(qmask), _f32(kmask if cross else None)
    pos = pos.to(torch.bfloat16).contiguous()
    ws = _weight_ptrs(p)
    K3(xw_all.data_ptr(), _ptr(kv_all) if cross else None, qmask.data_ptr(),
       _ptr(kmask), pos.data_ptr(), ws, B, total, qmask.shape[1], row_lo, C,
       p.f1w.shape[0], nhead, int(cross), float(tau_min), stream_handle())
    return xw_all


def encoder_layer_rows_sel(xw_all, kv_all, sel_q, sel_k, qmask, kmask, pos,
                           p: LayerParams, *, nhead: int, tau_min: float,
                           cross: bool, row_lo: int):
    """Packed layer on the S selected cells of rows [row_lo, row_lo + cap),
    in place; ``sel_q``/``qmask`` [B, cap, S]. Kernel K4 on the card."""
    if not on_card(xw_all, qmask):
        return reference_encoder_layer_rows(
            xw_all, kv_all, sel_q, sel_k, qmask, kmask, pos, p, nhead,
            tau_min, cross, row_lo)
    _check_rows(xw_all, kv_all, qmask, kmask, cross, row_lo, p, nhead, sel_q)
    B, total, _, C = xw_all.shape
    S = qmask.shape[2]
    sel_q = _i32(sel_q)
    sel_k = _i32(sel_k if cross else None)
    qmask, kmask = _f32(qmask), _f32(kmask if cross else None)
    pos = pos.to(torch.bfloat16).contiguous()
    ws = _weight_ptrs(p)
    K4(xw_all.data_ptr(), _ptr(kv_all) if cross else None, sel_q.data_ptr(),
       _ptr(sel_k), qmask.data_ptr(), _ptr(kmask), pos.data_ptr(), ws, B,
       total, qmask.shape[1], row_lo, C, p.f1w.shape[0], nhead, S,
       int(cross), float(tau_min), stream_handle())
    return xw_all
