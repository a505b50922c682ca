"""Cosine window attention alone, without LayerNorm, FFN or residual
(counterpart of ``tmae_tpu/ops/pallas_attn.py``).

Per window of T = 64 tokens: q = (x + pos) Wq + bq, k = (kv + pos) Wk + bk,
v = kv Wv + bv (kv = x in self mode), per-head L2 normalisation, logits
scaled by 1 / max(tau, tau_min), -30000 on masked keys, softmax, p = 0 for
a window with no key, then attn Wo + bo on every token. Weights are in the
JAX package's layout, ``[C_in, C_out]``.

:func:`fused_window_attention` is an autograd Function: its forward is
kernel K16 on the card and :func:`reference_forward` on the CPU; its
backward is autograd through :func:`reference_forward` on the saved
inputs, as the JAX package's ``_bwd`` takes ``jax.vjp`` of
``_reference_forward``.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import on_card
from ..utils.build import CudaKernel, F as CF, I, P, stream_handle

_W = ctypes.POINTER(ctypes.c_void_p)
K16 = CudaKernel('encoder_layer.cu', 'launch_window_attention',
                 [P, P, P, P, P, _W, I, I, I, I, CF, P])


def attention_math(q, k, v, kmask, tau, nhead: int, tau_min: float):
    """The attention of f32 ``q``/``k``/``v`` [W, T, C] with key mask
    ``kmask`` [W, T]: [W, T, C] (``_attention_math``)."""
    W, T, C = q.shape
    H, D = nhead, C // nhead
    qh, kh, vh = (a.reshape(W, T, H, D) for a in (q, k, v))
    qh = qh * torch.rsqrt(qh.square().sum(-1, keepdim=True) + 1e-24)
    kh = kh * torch.rsqrt(kh.square().sum(-1, keepdim=True) + 1e-24)
    scale = 1.0 / torch.clamp(tau, min=tau_min)
    logits = torch.einsum('wthd,wshd->whts', qh * scale, kh)
    logits = torch.where(kmask[:, None, None, :] > 0, logits, -30000.0)
    p = torch.softmax(logits, dim=-1)
    p = torch.where((kmask > 0).any(-1)[:, None, None, None], p, 0.0)
    return torch.einsum('whts,wshd->wthd', p, vh).reshape(W, T, C)


def reference_forward(xw, kvw, kmask, pos, wq, bq, wk, bk, wv, bv, wo, bo,
                      tau, nhead: int, tau_min: float, cross: bool):
    """Plain version of K16 (``_reference_forward``): f32 projections and
    attention, output in ``xw``'s dtype."""
    f = torch.float32
    kv = kvw if cross else xw
    xp = xw + pos[None]
    q = xp.to(f) @ wq.to(f) + bq
    kvp = (kv + pos[None]) if cross else xp
    k = kvp.to(f) @ wk.to(f) + bk
    v = kv.to(f) @ wv.to(f) + bv
    out = attention_math(q, k, v, kmask, tau[0], nhead, tau_min)
    return (out @ wo.to(f) + bo).to(xw.dtype)


def _linear(w):
    """A ``[C_in, C_out]`` weight as the kernel takes it: ``[out, in]``
    bf16."""
    return w.detach().t().to(torch.bfloat16).contiguous()


def window_attention_fwd(xw, kvw, kmask, pos, wq, bq, wk, bk, wv, bv, wo, bo,
                         tau, nhead: int, tau_min: float, cross: bool):
    """The attention of ``xw`` [N, 64, C] (keys and values from ``kvw`` in
    cross mode) under ``kmask`` [N, 64]: [N, 64, C] in ``xw``'s dtype.
    Kernel K16 on the card, which takes bf16 windows, C a multiple of 32 up
    to 256 and head width 16 or 32."""
    if not on_card(xw, kvw if cross else None, kmask, pos, wq, bq, wk, bk,
                   wv, bv, wo, bo, tau):
        return reference_forward(xw, kvw, kmask, pos, wq, bq, wk, bk, wv, bv,
                                 wo, bo, tau, nhead, tau_min, cross)
    N, T, C = xw.shape
    if xw.dtype != torch.bfloat16 or T != 64:
        raise ValueError('the attention kernel takes bf16 windows [N, 64, C]')
    if C % 32 or C > 256 or C % nhead or C // nhead not in (16, 32):
        raise ValueError(f'the attention kernel takes C % 32 == 0, C <= 256 '
                         f'and head width 16 or 32, not C={C}, '
                         f'nhead={nhead}')
    if kmask.shape != (N, T):
        raise ValueError('kmask must be [N, 64]')
    if cross and (kvw is None or kvw.shape != xw.shape
                  or kvw.dtype != xw.dtype):
        raise ValueError('cross mode needs kv windows shaped like xw')
    xw = xw.contiguous()
    kvw = kvw.contiguous() if cross else None
    kmask = kmask.float().contiguous()
    pos = pos.detach().to(torch.bfloat16).contiguous()
    vec = lambda t: t.detach().float().contiguous()
    ws = [_linear(wq), vec(bq), _linear(wk), vec(bk), _linear(wv), vec(bv),
          _linear(wo), vec(bo), vec(tau)]
    out = torch.empty_like(xw)
    K16(xw.data_ptr(), None if kvw is None else kvw.data_ptr(),
        out.data_ptr(), kmask.data_ptr(), pos.data_ptr(),
        (ctypes.c_void_p * len(ws))(*[t.data_ptr() for t in ws]), N, C,
        nhead, int(cross), float(tau_min), stream_handle())
    return out


class _FusedWindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, nhead, tau_min, cross, *args):
        ctx.cfg = (nhead, tau_min, cross)
        ctx.save_for_backward(*args)
        return window_attention_fwd(*args, nhead, tau_min, cross)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if a is None
                      else a.detach().requires_grad_(a.is_floating_point())
                      for a in args]
            out = reference_forward(*leaves, *ctx.cfg)
            wrt = [a for a, n in zip(leaves, ctx.needs_input_grad[3:])
                   if n]
            grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
        return (None, None, None, *[next(grads) if n else None
                                    for n in ctx.needs_input_grad[3:]])


def fused_window_attention(xw, kvw, kmask, pos, wq, bq, wk, bk, wv, bv, wo,
                           bo, tau, nhead: int, tau_min: float, cross: bool):
    """``xw``/``kvw`` [N, 64, C], ``kmask`` [N, 64] (0/1 float), ``pos``
    [64, C], weights [C, C], biases [C], ``tau`` [1]: [N, 64, C]."""
    return _FusedWindowAttention.apply(nhead, tau_min, cross, xw, kvw, kmask,
                                       pos, wq, bq, wk, bk, wv, bv, wo, bo,
                                       tau)
