"""Cosine window attention alone, without LayerNorm, FFN or residual
(counterpart of ``tmae_tpu/ops/pallas_attn.py``).

Per window of T = 64 tokens: q = (x + pos) Wq + bq, k = (kv + pos) Wk + bk,
v = kv Wv + bv (kv = x in self mode), per-head L2 normalisation, logits
scaled by 1 / max(tau, tau_min), -30000 on masked keys, softmax, p = 0 for
a window with no key, then attn Wo + bo on every token. Weights are in the
JAX package's layout, ``[C_in, C_out]``. On the card this is the
attention-only mode of the persistent tiled kernel
(``csrc/encoder_layer_tiled.cu``): a pre-pass flags the windows with a
key, the tiles run them, and an extra warp of each block writes ``bo`` on
the others meanwhile.

:func:`fused_window_attention` is an autograd Function: its forward is
kernel K16 on the card and :func:`reference_forward` on the CPU; its
backward is autograd through :func:`reference_forward` on the saved
inputs, as the JAX package's ``_bwd`` takes ``jax.vjp`` of
``_reference_forward``.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import as_kernel_arg, on_card
from ..utils.build import CudaKernel, F as CF, I, P, stream_handle

_W = ctypes.POINTER(ctypes.c_void_p)
K16 = CudaKernel('encoder_layer_tiled.cu', 'launch_window_attention',
                 [P, P, P, P, P, _W, I, P, I, I, I, I, CF, P])


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


def _out_in(w):
    """A ``[C_in, C_out]`` weight ``w`` as the pack reads it: an ``[in,
    out]`` tensor whose transpose, ``[out, in]``, is contiguous. The
    transpose of a Linear weight (as :class:`DenseWindowAttention` passes
    it) is that already (no dispatch); any other is copied once."""
    if w.stride() == (1, w.shape[0]):
        return w
    return w.detach().t().contiguous().t()


def _panel_mats(wq, wk, wv, wo):
    """The four weights as the pack reads them (:func:`_out_in`) and
    whether they are f32 (else all bf16)."""
    C = wq.shape[0]
    ws = (wq, wk, wv, wo)
    if C not in (128, 256) or any(w.shape != (C, C) for w in ws):
        raise ValueError(f'the attention panels take [C, C] weights with C = '
                         f'128 or 256, not {[tuple(w.shape) for w in ws]}')
    mats = [_out_in(w) for w in ws]
    f32 = any(m.dtype != torch.bfloat16 for m in mats)
    if f32:  # .float() keeps the strides of these dense tensors
        mats = [m if m.dtype == torch.float32 else m.float() for m in mats]
    return mats, f32


def workspace(N: int, C: int, device) -> torch.Tensor:
    """A K16 call's workspace for ``N`` windows at width ``C`` (bytes): the
    q, k, v and o panels its launcher packs (8 C^2 bytes: 4 C^2 bf16 in
    the tiled kernel's layout, ``encoder_layer.panels_plain``), then int32
    [2 N + 2]: the windows' live flags, the list of live windows, their
    count, the tile counter."""
    return torch.empty(8 * C * C + 4 * (2 * N + 2), dtype=torch.uint8,
                       device=device)


def window_attention_fwd(xw, kvw, kmask, pos, wq, bq, wk, bk, wv, bv, wo, bo,
                         tau, nhead: int, tau_min: float, cross: bool,
                         ws=None):
    """The attention of ``xw`` [N, 64, C] (keys and values from ``kvw`` in
    cross mode) under ``kmask`` [N, 64]: [N, 64, C] in ``xw``'s dtype.
    Kernel K16 on the card (the attention-only mode of the tiled kernel; its
    launcher packs the four weights first), which takes bf16 windows and
    C = 128 or 256 with 8 heads, into ``ws`` (:func:`workspace`; a new one
    when None)."""
    if not on_card(xw, kvw if cross else None, kmask, pos, wq, bq, wk, bk,
                   wv, bv, wo, bo, tau):
        return reference_forward(xw, kvw, kmask, pos, wq, bq, wk, bk, wv, bv,
                                 wo, bo, tau, nhead, tau_min, cross)
    N, T, C = xw.shape
    if xw.dtype != torch.bfloat16 or T != 64:
        raise ValueError('the attention kernel takes bf16 windows [N, 64, C]')
    if C not in (128, 256) or nhead != 8:
        raise ValueError(f'the attention kernel is compiled for C = 128 or '
                         f'256 with 8 heads, not C={C}, nhead={nhead}')
    if kmask.shape != (N, T):
        raise ValueError('kmask must be [N, 64]')
    if cross and (kvw is None or kvw.shape != xw.shape
                  or kvw.dtype != xw.dtype):
        raise ValueError('cross mode needs kv windows shaped like xw')
    # no dispatch for an argument that is already as the kernel takes it
    # (a call's host time is as long as its device time)
    if not xw.is_contiguous():
        xw = xw.contiguous()
    if cross and not kvw.is_contiguous():
        kvw = kvw.contiguous()
    pos = as_kernel_arg(pos, torch.bfloat16)
    kmask = as_kernel_arg(kmask, torch.float32)
    mats, f32 = _panel_mats(wq, wk, wv, wo)
    vecs = [as_kernel_arg(t, torch.float32)  # alive to the launch
            for t in (bq, bk, bv, bo, tau)]
    if ws is None:
        ws = workspace(N, C, xw.device)
    elif ws.nbytes < 8 * C * C + 4 * (2 * N + 2) or not ws.is_cuda:
        raise ValueError('the K16 workspace is too small or not on the card')
    out = torch.empty_like(xw)
    K16(xw.data_ptr(), kvw.data_ptr() if cross else None, out.data_ptr(),
        kmask.data_ptr(), pos.data_ptr(),
        (ctypes.c_void_p * 9)(*[t.data_ptr() for t in mats + vecs]),
        int(f32), ws.data_ptr(), N, C, nhead, int(cross), float(tau_min),
        stream_handle())
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
