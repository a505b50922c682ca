"""The cosine-attention SST encoder layer on gathered windows, as kernels
and their plain versions (counterpart of
``tmae_tpu/ops/pallas_encoder.py``):

* serving, in place on rows ``[row_lo, row_lo + cap)`` of the window tensor
  ``xw_all [B, total, 64, C]``: K3 (all 64 cells,
  ``encoder_layer_rows_full``) and K4 (S selected cells,
  ``encoder_layer_rows_sel``);
* training, out of place on a flat ``[N, 64, C]`` window tensor:
  :func:`fused_encoder_layer`, an autograd Function whose forward is K6 (all
  cells, ``_pallas_forward``) or K8 (selected cells, ``_pallas_forward_sel``)
  and whose backward is K7 (``_pallas_backward``) or K9
  (``_pallas_backward_sel``);
* on the dense grid, for configs without bucket caps: K10
  (``_grid_forward``), the full-window layer on every window of a shift's
  partition of ``[B, H, W, C]``, and :func:`fused_encoder_layer_grid`, whose
  backward runs K7 on the windows, as ``_grid_bwd`` does;
* serving straight against the padded carrier, in place over the windows of
  one bucket plan: K12 (``encoder_layer_fused_pipelined``, which also closes
  ``encoder_layer_fused_inplace``), the gather, the K3 / K4 layer and the
  scatter in one call.

K3, K4, K6, K8, K10 and K12 are one persistent kernel over tiles of the
windows with an occupied query cell (``csrc/encoder_layer_tiled.cu``,
compiled for C = 128 / 256 with 8 heads); at the narrow widths (C = 32 / 64
with 4 or 8 heads: the mini configs and ``ASYMMETRIC.HALF_CHANNELS``) every
one of those calls is NARROW_FWD and the backward NARROW_BWD
(``csrc/encoder_layer_narrow.cu``). :func:`layer_family` names the family
of a width and refuses any other;
:func:`live_windows_plain`, :func:`tile_plan_plain`,
:func:`window_rows_plain`, :func:`plan_cells_plain` and
:func:`pack_panels_plain` are the plain versions of its window plan, of
K3's / K4's row addressing, of K12's carrier addressing and of its weight
panels. A served layer prepares its weights once per forward
(:class:`TiledWeights`: validated once, panels packed by one launch) and
hands them to each of its bucket calls.

The plain forward follows the kernels' numerics: bf16 matmul inputs with f32
accumulation, bf16 where the TPU kernel casts, f32 LayerNorm residual. Its
bf16 roundings pass gradients straight through, so the plain backward is
autograd through the plain forward with f32 gradients, as the TPU kernel's
backward keeps its gradients in f32 between bf16 matmul operands.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import as_kernel_arg, on_card
from ..utils.build import CudaKernel, F as CF, I, P, library, stream_handle
from .dense_windows import window_geometry, window_unview, window_view
from .occ_compact import (gather_windows_padded_plain,
                          scatter_windows_into_padded_plain)

_W = ctypes.POINTER(ctypes.c_void_p)
_INTS = ctypes.POINTER(ctypes.c_int)
PACK = CudaKernel('encoder_layer_tiled.cu', 'launch_pack_panels',
                  [_W, I, P, I, P])
K3 = CudaKernel('encoder_layer_tiled.cu', 'launch_encoder_rows_full',
                [P, P, P, P, P, _W, P, I, I, I, I, I, I, I, I, CF, P])
K4 = CudaKernel('encoder_layer_tiled.cu', 'launch_encoder_rows_sel',
                [P, P, P, P, P, P, P, _W, P, I, I, I, I, I, I, I, I, I, CF,
                 P])
K6 = CudaKernel('encoder_layer_tiled.cu', 'launch_encoder_fwd_full',
                [P, P, P, P, P, P, _W, I, I, I, I, I, CF, P])
K8 = CudaKernel('encoder_layer_tiled.cu', 'launch_encoder_fwd_sel',
                [P, P, P, P, P, P, P, P, _W, I, I, I, I, I, I, CF, P])
K7 = CudaKernel('encoder_layer_bwd.cu', 'launch_encoder_bwd_full',
                [_W, _W, _W, _W, I, I, I, I, I, CF, I, P])
K9 = CudaKernel('encoder_layer_bwd.cu', 'launch_encoder_bwd_sel',
                [_W, _W, _W, _W, I, I, I, I, I, I, CF, I, P])
K10 = CudaKernel('encoder_layer_tiled.cu', 'launch_encoder_grid',
                 [P, P, P, P, P, P, _W, I, I, I, I, I, I, I, I, CF, P])
K12 = CudaKernel('encoder_layer_tiled.cu', 'launch_encoder_inplace',
                 [P, P, P, P, P, P, P, P, _W, P, I, I, I, I, I, I, I, I, I,
                  CF, P])
NARROW_FWD = CudaKernel('encoder_layer_narrow.cu', 'launch_narrow_fwd',
                        [I, _W, _W, P, _INTS, CF, P])
NARROW_BWD = CudaKernel('encoder_layer_narrow.cu', 'launch_narrow_bwd',
                        [_W, _W, _W, _W, _INTS, CF, P])
MATRICES = ('wq', 'wk', 'wv', 'wo', 'f1w', 'f2w')
# (C, heads) of each kernel family; the FFN width is 2C in both
TILED_WIDTHS = ((128, 8), (256, 8))
NARROW_WIDTHS = ((32, 4), (64, 4), (64, 8))
# NARROW_FWD's modes (Mode in csrc/encoder_fwd_plan.cuh): the calls of K8,
# K4, K6, K3, K10 and K12
_SEL_OUT, _SEL_IN_PLACE, _FULL_OUT, _FULL_IN_PLACE, _GRID_OUT, _PLAN = range(6)
# NARROW_BWD's weight-gradient chunks: at least this many rows (4 tiles)
# a chunk, and at most this many chunks
_NARROW_CHUNK_ROWS = 256
_NARROW_MAX_CHUNKS = 64


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
    """Round f32 values to bf16 (kept in f32). Under autograd the rounding
    passes the gradient through unchanged."""
    r = x.to(torch.bfloat16).float()
    return r if not x.requires_grad else x + (r - x).detach()


def _mm(a, w):
    """a (f32 holding bf16 values) @ bf16(w).T with w a Linear weight."""
    return a @ _bf(w.float()).t()


def _ln(x, scale, bias, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _take(rows, sel):
    """rows [..., 64, C], sel [..., S] → [..., S, C]."""
    C = rows.shape[-1]
    return torch.gather(rows, -2, sel.long()[..., None].expand(*sel.shape, C))


def reference_encoder_layer(xw, kvw, sel_q, sel_k, qmask, kmask, pos,
                            p: LayerParams, nhead: int, tau_min: float,
                            cross: bool):
    """Plain version of K6 (``sel_q is None``) and K8, out of place:
    ``xw``/``kvw`` [..., 64, C], masks and selections [..., T]. Returns the
    new window content in ``xw.dtype``: the masked layer output (full), or
    ``xw`` plus the masked delta on the selected cells. In self mode the keys
    are the query cells: ``kvw``, ``sel_k`` and ``kmask`` are ignored."""
    C = xw.shape[-1]
    posf = pos.float()
    if sel_q is None:
        x, pq = xw.float(), posf
    else:
        x, pq = _take(xw, sel_q).float(), posf[sel_q.long()]
    qm = qmask > 0
    if cross:
        if sel_q is None:
            kv, pk = kvw.float(), posf
        else:
            kv, pk = _take(kvw, sel_k).float(), posf[sel_k.long()]
        km = kmask > 0
    else:
        kv, pk, km = x, pq, qm
    q = _mm(_bf(x + pq), p.wq) + p.bq
    k = _mm(_bf(kv + pk), p.wk) + p.bk
    v = _mm(kv, p.wv) + p.bv
    lead, T = x.shape[:-2], x.shape[-2]
    H, D = nhead, C // nhead
    qh = q.reshape(*lead, T, H, D)
    kh = k.reshape(*lead, T, H, D)
    vh = _bf(v.reshape(*lead, T, H, D))
    scale = 1.0 / torch.clamp(p.tau.float(), min=tau_min)
    qn = _bf(qh * torch.rsqrt(qh.square().sum(-1, keepdim=True) + 1e-24)
             * scale)
    kn = _bf(kh * torch.rsqrt(kh.square().sum(-1, keepdim=True) + 1e-24))
    logits = torch.einsum('...thd,...shd->...hts', qn, kn)
    logits = torch.where(km[..., None, None, :], logits, -30000.0)
    prob = torch.softmax(logits, dim=-1)
    prob = torch.where(km.any(-1)[..., None, None, None], prob, 0.0)
    attn = torch.einsum('...hts,...shd->...thd', _bf(prob), vh)
    o = _mm(_bf(attn.reshape(*lead, T, C)), p.wo) + p.bo
    qmc = qm[..., None]
    h = _ln(x + torch.where(qmc, o, 0.0), p.ln1s, p.ln1b)
    h = torch.where(qmc, h, 0.0)
    ff = F.gelu(_mm(_bf(h), p.f1w) + p.f1b)
    ff = _mm(_bf(ff), p.f2w) + p.f2b
    out = _ln(h + ff, p.ln2s, p.ln2b)
    if sel_q is None:
        return torch.where(qmc, out, 0.0).to(xw.dtype)
    delta = _bf(torch.where(qmc, out - x, 0.0))
    idx = sel_q.long()[..., None].expand(*delta.shape)
    delta64 = torch.zeros(xw.shape, dtype=delta.dtype,
                          device=delta.device).scatter_add(-2, idx, delta)
    return (xw.float() + delta64).to(xw.dtype)


def reference_encoder_layer_rows(xw_all, kv_all, sel_q, sel_k, qmask, kmask,
                                 pos, p: LayerParams, nhead: int,
                                 tau_min: float, cross: bool, row_lo: int):
    """Plain version of K3 (``sel_q is None``) and K4: the layer on rows
    [row_lo, row_lo + cap) of ``xw_all``, in place."""
    cap = qmask.shape[1]
    sl = slice(row_lo, row_lo + cap)
    xw_all[:, sl] = reference_encoder_layer(
        xw_all[:, sl], kv_all[:, sl] if cross else None, sel_q, sel_k, qmask,
        kmask, pos, p, nhead, tau_min, cross)
    return xw_all


_WANT = tuple(torch.bfloat16 if name in MATRICES else torch.float32
              for name in LayerParams._fields)


def _weight_ptrs(p: LayerParams, extra=()):
    """The 17 layer tensors' pointers, then ``extra``, as a ctypes array."""
    for name, t, want in zip(p._fields, p, _WANT):
        if t.dtype != want or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f'layer parameter {name} must be a contiguous '
                             f'CUDA {want} tensor')
    ptrs = [t.data_ptr() for t in p] + list(extra)
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _check_rows(xw_all, kv_all, qmask, kmask, cross, row_lo, T, sel_q=None):
    """The window tensor, masks and row range K3 (T = 64) and K4 (T = S =
    16 or 48) take."""
    if xw_all.dtype != torch.bfloat16 or not xw_all.is_contiguous():
        raise ValueError('xw_all must be a contiguous bf16 tensor')
    B, total, cells, C = xw_all.shape
    if cells != 64:
        raise ValueError('window rows hold 64 cells')
    if qmask.dim() != 3 or qmask.shape[0] != B or qmask.shape[2] not in T:
        raise ValueError(f'mask shape {tuple(qmask.shape)} does not fit')
    if sel_q is not None and sel_q.shape != qmask.shape:
        raise ValueError('sel_q and qmask differ in shape')
    cap = qmask.shape[1]
    if row_lo < 0 or row_lo + cap > total:
        raise ValueError('row range outside xw_all')
    if cross and (kv_all is None or kv_all.shape != xw_all.shape
                  or not kv_all.is_contiguous() or kmask is None):
        raise ValueError('cross mode needs kv_all shaped like xw_all and kmask')
    if cross and _shares_memory(kv_all, xw_all):
        raise ValueError('kv_all shares memory with the rows the layer '
                         'updates')


def _shares_memory(a, b):
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _f32(t):
    return as_kernel_arg(t, torch.float32)


def _i32(t):
    return as_kernel_arg(t, torch.int32)


def _ptr(t):
    return None if t is None else t.data_ptr()


def layer_family(C: int, nhead: int, ffn: int) -> str:
    """The kernel family of a layer width on the card: ``'tiled'`` (K3, K4,
    K6-K10, K12: C = 128 or 256 with 8 heads) or ``'narrow'`` (NARROW_FWD,
    NARROW_BWD: C = 32 with 4 heads, C = 64 with 4 or 8), each with an FFN
    width of 2C. Any other width raises."""
    if ffn == 2 * C and (C, nhead) in TILED_WIDTHS:
        return 'tiled'
    if ffn == 2 * C and (C, nhead) in NARROW_WIDTHS:
        return 'narrow'
    raise ValueError(
        'the encoder kernels are compiled for (C, heads) in '
        f'{TILED_WIDTHS} (K3, K4, K6-K12) and {NARROW_WIDTHS} (NARROW_FWD, '
        f'NARROW_BWD), each with an FFN width of 2C, not C={C}, '
        f'nhead={nhead}, FFN {ffn}')


def _ints(*vals):
    return (ctypes.c_int * len(vals))(*vals)


def _narrow_fwd(mode, io, ptrs, nwin, dims, tau_min):
    """One NARROW_FWD launch: ``io`` the 11 tensors or None (x kv out pos
    selq selk qmask kmask qocc kocc widx), ``ptrs`` the 17 layer tensors'
    pointers (bf16 matrices), ``dims`` (C F H T cross B total cap row_lo gh
    gw shift)."""
    work = _work(nwin, io[0].device)
    NARROW_FWD(mode, _ptrs(io), ptrs, work.data_ptr(), _ints(*dims),
               float(tau_min), stream_handle())


def _tiled_ptrs(p: LayerParams, nwin: int):
    """The pointer array K6 / K8 / K10 take: the 17 layer tensors, then
    their workspace (see csrc/encoder_layer_tiled.cu): the weights packed into
    panels (8 C^2 bf16) and int32 [2 nwin + 2] (the windows' live flags,
    the list of live windows, their count, the tile counter), both in one
    allocation. Returns (array, workspace tensor); the tensor must outlive
    the launch."""
    panel_bytes = 16 * p.wq.shape[0] ** 2
    ws = torch.empty(panel_bytes + 4 * (2 * nwin + 2), dtype=torch.uint8,
                     device=p.wq.device)
    return _weight_ptrs(p, (ws.data_ptr(), ws.data_ptr() + panel_bytes)), ws


class TiledWeights:
    """A served layer's weights, prepared once for all its bucket calls of
    one forward (K3, K4, K12, or NARROW_FWD at the narrow widths): on the
    card, validated once and behind one pointer array, at the tiled widths
    the six Linear weights packed into the tiled kernel's panels by one
    launch (``PACK``, from f32 master weights rounded to bf16 to nearest
    even, as :func:`kernel_params` rounds them; bf16 weights are copied) and
    the 11 vectors in f32; at the narrow widths the six matrices in bf16
    (f32 master weights rounded once, as :func:`kernel_params` rounds them,
    into one buffer by torch's cat and cast: no launch of the port's; bf16
    ones as they are) and the 11 vectors as they are, which NARROW_FWD
    copies into shared memory once a block (``panels`` None). On the CPU,
    ``params``: the :class:`LayerParams` the plain versions take.
    ``weights``: the 17 layer tensors in :class:`LayerParams` order, Linear
    weights ``[out, in]``."""

    def __init__(self, weights, nhead: int):
        p = LayerParams(*[w.detach() for w in weights])
        self.nhead, self.width, self.ffn = nhead, p.wq.shape[0], p.f1w.shape[0]
        if not on_card(*p):
            self.params, self.panels, self.ptrs = kernel_params(p), None, None
            return
        C, Fd = self.width, self.ffn
        self.family = layer_family(C, nhead, Fd)
        mats = [getattr(p, name) for name in MATRICES]
        f32 = mats[0].dtype == torch.float32
        mat_dtype = torch.float32 if f32 else torch.bfloat16
        shapes = dict(wq=(C, C), wk=(C, C), wv=(C, C), wo=(C, C),
                      f1w=(Fd, C), f2w=(C, Fd), f1b=(Fd,), tau=(1,))
        for name, t in zip(p._fields, p):
            want = mat_dtype if name in MATRICES else torch.float32
            shape = shapes.get(name, (C,))
            if (t.dtype != want or not t.is_contiguous()
                    or tuple(t.shape) != shape):
                raise ValueError(f'layer parameter {name} must be a '
                                 f'contiguous {want} tensor of shape {shape}')
        self.params = None
        if self.family == 'narrow':
            self.panels = None
            if f32:
                mats = narrow_mats(mats)
            bf = dict(zip(MATRICES, mats))
            # ptrs points into these
            self.tensors = [bf.get(name, t) for name, t in zip(p._fields, p)]
            self.ptrs = (ctypes.c_void_p * 17)(
                *[t.data_ptr() for t in self.tensors])
            return
        # ptrs points into these: they live as long as the prepared weights
        self.vectors = [t for name, t in zip(p._fields, p)
                        if name not in MATRICES]
        self.panels = torch.empty(8 * C * C, dtype=torch.bfloat16,
                                  device=p.wq.device)
        PACK((ctypes.c_void_p * 6)(*[m.data_ptr() for m in mats]), int(f32),
             self.panels.data_ptr(), C, stream_handle())
        ptrs = [None if name in MATRICES else t.data_ptr()
                for name, t in zip(p._fields, p)]
        self.ptrs = (ctypes.c_void_p * 18)(*ptrs, self.panels.data_ptr())


def narrow_mats(mats) -> list:
    """A served narrow layer's six f32 matrices in bf16, rounded to nearest
    even as :func:`kernel_params` rounds them, as views of one buffer (two
    launches: torch's cat and cast)."""
    flat = torch.cat([m.reshape(-1) for m in mats]).to(torch.bfloat16)
    return [v.view(m.shape) for v, m in
            zip(flat.split([m.numel() for m in mats]), mats)]


def _prepared(p, C: int, nhead: int) -> TiledWeights:
    """The prepared weights of a call on the card: ``p`` itself when it is
    :class:`TiledWeights` for this width, else prepared from the
    :class:`LayerParams` ``p`` for this call alone (validation and one pack
    launch)."""
    if not isinstance(p, TiledWeights):
        return TiledWeights(p, nhead)
    if p.ptrs is None:
        raise ValueError('weights prepared on the CPU for a call on the card')
    if p.width != C or p.nhead != nhead:
        raise ValueError(f'weights prepared for C={p.width}, nhead='
                         f'{p.nhead}, not C={C}, nhead={nhead}')
    return p


def _plain_params(p) -> LayerParams:
    """The :class:`LayerParams` the plain versions take."""
    return p.params if isinstance(p, TiledWeights) else p


def panels_plain(mats) -> torch.Tensor:
    """Plain version of the weight pack of the Linear weights ``mats``
    ([out, in], in stream order): each rounded to bf16, pass by pass of 128
    output rows, the panels of 64 input columns along the input, each
    panel's element (n, k) at ((n // 8) * 8 + k // 8) * 64 + (n % 8) * 8 +
    k % 8. Returns the flat bf16 panels."""
    out = []
    for w in mats:
        w = w.detach().to(torch.bfloat16)
        o, i = w.shape
        blocks = w.reshape(o // 128, 16, 8, i // 64, 8, 8)
        out.append(blocks.permute(0, 3, 1, 4, 2, 5).reshape(-1))
    return torch.cat(out)


def pack_panels_plain(p: LayerParams) -> torch.Tensor:
    """Plain version of a layer's weight pack: its six Linear weights in
    the order the tiled kernel streams them (q, k, v, o, then the FFN's two
    products), by :func:`panels_plain`: the flat bf16 panels (8 C^2
    values)."""
    return panels_plain([getattr(p, name) for name in MATRICES])


def live_windows_plain(qmask):
    """Plain version of the tiled kernel's pre-pass and compaction: the
    indices of the windows with an occupied query cell, in window order,
    from a query mask [N, T] (K3, K4, K12: [B, cap, T] flattened to
    [B cap, T]; for K10 the window view of the occupancy)."""
    return (qmask > 0).any(-1).nonzero()[:, 0]


def tile_plan_plain(live, T):
    """The tiles of 64 rows the tiled kernel runs, as lists of window
    indices: four live windows a tile at T = 16, one at T = 48 (padded to 64
    rows) and T = 64, in the order of ``live``; the last tile may be
    partial."""
    per = 4 if T == 16 else 1
    live = [int(w) for w in live]
    return [live[i:i + per] for i in range(0, len(live), per)]


def window_rows_plain(w, cap, total, row_lo):
    """Plain version of K3's and K4's row addressing: window ``w`` = b cap +
    j of a call on rows [row_lo, row_lo + cap) of ``xw_all`` [B, total, 64,
    C] is row b total + row_lo + j of ``xw_all`` viewed as [B total, 64, C].
    K6 and K8 address their flat windows with cap = total = N and row_lo =
    0, where window w is row w."""
    return (w // cap) * total + row_lo + w % cap


def plan_real_plain(idx, Hp2: int, Wp: int):
    """Plain version of K12's slot test: slot (b, j) of a plan ``idx`` [B,
    cap, 2] names a window (wy, wx) of the padded carrier [B, Hp2, Wp, C]
    when 0 <= wy < Hp2 / 8 - 1 and 0 <= wx, 8 wx + 8 <= Wp; a dummy slot
    (wy = Hp2 / 8 - 1, the window row below the grid) does not. [B, cap]
    bool."""
    wy, wx = idx[..., 0].long(), idx[..., 1].long()
    return (wy >= 0) & (wy < Hp2 // 8 - 1) & (wx >= 0) & (8 * wx + 8 <= Wp)


def plan_cells_plain(idx, cells, Hp2: int, Wp: int):
    """Plain version of K12's carrier addressing: cell ``cells[b, j, i]``
    (c = i at T = 64, the selection at S = 16 or 48) of the window (wy, wx)
    = ``idx[b, j]`` is carrier cell (8 wy + c // 8, 8 wx + c % 8) of frame
    b, i.e. row (b Hp2 + 8 wy + c // 8) Wp + 8 wx + c % 8 of the carrier
    viewed as [B Hp2 Wp, C]; -1 for every cell of a dummy slot. Returns
    int64 [B, cap, T]."""
    B = idx.shape[0]
    wy = idx[..., 0].long()[..., None]
    wx = idx[..., 1].long()[..., None]
    c = cells.long()
    b = torch.arange(B, device=idx.device).reshape(B, 1, 1)
    rows = ((b * Hp2 + 8 * wy + c // 8) * Wp + 8 * wx + c % 8)
    return torch.where(plan_real_plain(idx, Hp2, Wp)[..., None], rows, -1)


def _work(nwin: int, device):
    """The int32 workspace of a serving call: the windows' live flags, the
    list of live windows, their count and the tile counter."""
    return torch.empty(2 * nwin + 2, dtype=torch.int32, device=device)


def encoder_layer_rows_full(xw_all, kv_all, qmask, kmask, pos, p, *,
                            nhead: int, tau_min: float, cross: bool,
                            row_lo: int):
    """Full-window layer over rows [row_lo, row_lo + cap) of ``xw_all``, in
    place; ``qmask``/``kmask`` [B, cap, 64]; a window without an occupied
    query cell gets zeros. ``p``: :class:`TiledWeights`, or
    :class:`LayerParams` (prepared for this call). Kernel K3 on the card,
    NARROW_FWD at the narrow widths (:func:`layer_family`); in cross mode
    ``kv_all`` must not share memory with ``xw_all``."""
    if not on_card(xw_all, qmask):
        return reference_encoder_layer_rows(
            xw_all, kv_all, None, None, qmask, kmask, pos, _plain_params(p),
            nhead, tau_min, cross, row_lo)
    _check_rows(xw_all, kv_all, qmask, kmask, cross, row_lo, (64,))
    B, total, _, C = xw_all.shape
    tw = _prepared(p, C, nhead)
    cap = qmask.shape[1]
    qmask, kmask = _f32(qmask), _f32(kmask if cross else None)
    pos = as_kernel_arg(pos, torch.bfloat16)
    if tw.family == 'narrow':
        _narrow_fwd(_FULL_IN_PLACE, [xw_all, kv_all if cross else None, None,
                                     pos, None, None, qmask, kmask, None,
                                     None, None],
                    tw.ptrs, B * cap,
                    (C, tw.ffn, nhead, 64, int(cross), B, total, cap, row_lo,
                     0, 0, 0), tau_min)
        return xw_all
    work = _work(B * cap, xw_all.device)
    K3(xw_all.data_ptr(), _ptr(kv_all) if cross else None, qmask.data_ptr(),
       _ptr(kmask), pos.data_ptr(), tw.ptrs, work.data_ptr(), B, total, cap,
       row_lo, C, tw.ffn, nhead, int(cross), float(tau_min), stream_handle())
    return xw_all


def encoder_layer_rows_sel(xw_all, kv_all, sel_q, sel_k, qmask, kmask, pos,
                           p, *, nhead: int, tau_min: float, cross: bool,
                           row_lo: int):
    """Packed layer on the S selected cells of rows [row_lo, row_lo + cap),
    in place; ``sel_q``/``qmask`` [B, cap, S]. ``p`` as for
    :func:`encoder_layer_rows_full`. Kernel K4 on the card, NARROW_FWD at
    the narrow widths; in cross mode ``kv_all`` must not share memory with
    ``xw_all``."""
    if not on_card(xw_all, qmask):
        return reference_encoder_layer_rows(
            xw_all, kv_all, sel_q, sel_k, qmask, kmask, pos,
            _plain_params(p), nhead, tau_min, cross, row_lo)
    _check_rows(xw_all, kv_all, qmask, kmask, cross, row_lo, (16, 48), sel_q)
    B, total, _, C = xw_all.shape
    tw = _prepared(p, C, nhead)
    cap, S = qmask.shape[1:]
    sel_q = _i32(sel_q)
    sel_k = _i32(sel_k if cross else None)
    qmask, kmask = _f32(qmask), _f32(kmask if cross else None)
    pos = as_kernel_arg(pos, torch.bfloat16)
    if tw.family == 'narrow':
        _narrow_fwd(_SEL_IN_PLACE, [xw_all, kv_all if cross else None, None,
                                    pos, sel_q, sel_k, qmask, kmask, None,
                                    None, None],
                    tw.ptrs, B * cap,
                    (C, tw.ffn, nhead, S, int(cross), B, total, cap, row_lo,
                     0, 0, 0), tau_min)
        return xw_all
    work = _work(B * cap, xw_all.device)
    K4(xw_all.data_ptr(), _ptr(kv_all) if cross else None, sel_q.data_ptr(),
       _ptr(sel_k), qmask.data_ptr(), _ptr(kmask), pos.data_ptr(), tw.ptrs,
       work.data_ptr(), B, total, cap, row_lo, C, tw.ffn, nhead, S,
       int(cross), float(tau_min), stream_handle())
    return xw_all


# ---------------------------------------------------------------------------
# Training: K6 / K8 forward, K7 / K9 backward, joined by an autograd Function
# ---------------------------------------------------------------------------


def kernel_params(weights) -> LayerParams:
    """The 17 layer tensors (f32 master weights, Linear layout [out, in]) as
    the kernels take them: matrices in bf16, the rest in f32. Tensors that
    are already so are returned as they are, without a copy."""
    return LayerParams(*[
        (w.detach().to(torch.bfloat16) if name in MATRICES
         else w.detach().float()).contiguous()
        for name, w in zip(LayerParams._fields, weights)])


def _check_flat(xw, kv, sel_q, qmask, cross, p, nhead) -> str:
    """The checks of the flat training calls; returns the width's
    family."""
    if xw.dtype != torch.bfloat16 or xw.dim() != 3 or xw.shape[1] != 64:
        raise ValueError('the training kernels take bf16 windows [N, 64, C]')
    N, _, C = xw.shape
    family = layer_family(C, nhead, p.f1w.shape[0])
    T = 64 if sel_q is None else sel_q.shape[-1]
    if qmask.shape != (N, T) or (sel_q is not None and T not in (16, 48)):
        raise ValueError(f'mask / selection shape {tuple(qmask.shape)} does '
                         'not fit')
    if cross and (kv is None or kv.shape != xw.shape):
        raise ValueError('cross mode needs kv windows shaped like xw')
    return family


def encoder_layer_fwd(xw, kvw, sel_q, sel_k, qmask, kmask, pos,
                      p: LayerParams, *, nhead: int, tau_min: float,
                      cross: bool):
    """The training forward on flat windows ``xw`` [N, 64, C], out of place:
    K6 (``sel_q is None``, masks [N, 64]) or K8 (``sel_q`` [N, S]) on the
    card, NARROW_FWD at the narrow widths."""
    if not on_card(xw, qmask):
        return reference_encoder_layer(xw, kvw, sel_q, sel_k, qmask, kmask,
                                       pos, p, nhead, tau_min, cross)
    xw = xw.contiguous()
    kvw = kvw.contiguous() if cross else None
    family = _check_flat(xw, kvw, sel_q, qmask, cross, p, nhead)
    N, _, C = xw.shape
    out = torch.empty_like(xw)
    qmask, kmask = _f32(qmask), _f32(kmask if cross else None)
    pos = pos.to(torch.bfloat16).contiguous()
    if family == 'narrow':
        T = 64 if sel_q is None else sel_q.shape[-1]
        _narrow_fwd(_FULL_OUT if sel_q is None else _SEL_OUT,
                    [xw, kvw, out, pos, _i32(sel_q),
                     _i32(sel_k if cross else None), qmask, kmask, None,
                     None, None],
                    _weight_ptrs(p), N,
                    (C, p.f1w.shape[0], nhead, T, int(cross), N, N, N, 0, 0,
                     0, 0), tau_min)
        return out
    ws, _work = _tiled_ptrs(p, N)
    if sel_q is None:
        K6(xw.data_ptr(), _ptr(kvw), out.data_ptr(), qmask.data_ptr(),
           _ptr(kmask), pos.data_ptr(), ws, N, C, p.f1w.shape[0], nhead,
           int(cross), float(tau_min), stream_handle())
    else:
        sel_q, sel_k = _i32(sel_q), _i32(sel_k if cross else None)
        K8(xw.data_ptr(), _ptr(kvw), out.data_ptr(), sel_q.data_ptr(),
           _ptr(sel_k), qmask.data_ptr(), _ptr(kmask), pos.data_ptr(), ws, N,
           C, p.f1w.shape[0], nhead, sel_q.shape[-1], int(cross),
           float(tau_min), stream_handle())
    return out


def reference_encoder_layer_bwd(xw, kvw, sel_q, sel_k, qmask, kmask, pos,
                                weights, g, *, nhead: int, tau_min: float,
                                cross: bool, want_dpos: bool = False):
    """Plain version of K7 / K9: autograd through the plain forward. Returns
    (dx, dkv or None, [17 weight gradients], dpos or None), in f32."""
    with torch.enable_grad():
        x = xw.detach().float().requires_grad_()
        kv = kvw.detach().float().requires_grad_() if cross else None
        ws = [w.detach().float().requires_grad_() for w in weights]
        ps = pos.detach().float().requires_grad_(want_dpos)
        out = reference_encoder_layer(x, kv, sel_q, sel_k, qmask, kmask, ps,
                                      LayerParams(*ws), nhead, tau_min, cross)
        wrt = [x] + ([kv] if cross else []) + ws + ([ps] if want_dpos else [])
        grads = list(torch.autograd.grad(out, wrt, g.float()))
    dx = grads.pop(0)
    dkv = grads.pop(0) if cross else None
    dpos = grads.pop() if want_dpos else None
    return dx, dkv, grads, dpos


@functools.lru_cache(maxsize=None)
def _bwd_sizes(N, T, C, F, H, dpos):
    """(per-tile partials bytes, scratch bytes, ints of the flags and tile
    counter) of a K7 / K9 call, from the library (they depend on the card's
    SM count and on what fits in shared memory)."""
    fn = library('encoder_layer_bwd.cu').encoder_bwd_sizes
    fn.argtypes = [I] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 3)()
    if fn(N, T, C, F, H, int(dpos), out):
        raise ValueError(f'K7/K9 take no T={T}, C={C}, nhead={H}')
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _bwd_workspace(N, T, C, F, H, cross, dpos, dev):
    """Workspace of K7 / K9 (see csrc/encoder_layer_bwd.cu): the bf16
    operands of the six weight-gradient products (rows of live windows
    only are written and read), the live-window flags with the tile
    counter, the per-tile partials, the blocks' scratch and the
    weight-gradient chunks. Returns (tensors, splits)."""
    R = N * T
    bf = lambda w: torch.empty(R, w, dtype=torch.bfloat16, device=dev)
    ops = [bf(C), bf(C) if cross else None, bf(C), bf(C), bf(C), bf(F),
           bf(C), bf(C), bf(C), bf(C), bf(F), bf(C)]
    part_bytes, scratch_bytes, flags = _bwd_sizes(N, T, C, F, H, dpos)
    # row chunks of the weight-gradient launch: about two blocks per SM over
    # its 64 x 128 output tiles, and at most 4096 windows a chunk
    tiles = (4 * (C // 64) * (C // 128) + (F // 64) * (C // 128)
             + (C // 64) * (F // 128))
    splits = max(-(-N // 4096), min(N, -(-2 * _sm_count(dev) // tiles)))
    ws = ops + [
        torch.empty(flags, dtype=torch.int32, device=dev),
        torch.empty(part_bytes // 4, dtype=torch.float32, device=dev),
        torch.empty(scratch_bytes, dtype=torch.uint8, device=dev),
        torch.empty(splits * (4 * C * C + 2 * C * F), dtype=torch.float32,
                    device=dev)]
    return ws, splits


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[_ptr(t) for t in ts])


def _narrow_chunks(rows):
    """NARROW_BWD's weight-gradient chunks over ``rows`` workspace rows:
    (rows a chunk, a multiple of 64; chunks), at least _NARROW_CHUNK_ROWS
    rows a chunk and at most _NARROW_MAX_CHUNKS chunks."""
    tiles = -(-rows // 64)
    chunk = 64 * max(_NARROW_CHUNK_ROWS // 64,
                     -(-tiles // _NARROW_MAX_CHUNKS))
    return chunk, max(1, -(-rows // chunk))


def _narrow_bwd_layout(N, T, C, F, cross, dpos):
    """Workspace of NARROW_BWD (see csrc/encoder_layer_narrow.cu) in one
    buffer, each region 256 bytes aligned: the bf16 operand rows of the six
    weight-gradient products (64 a tile of 4 windows at S = 16, of one
    window otherwise; KP only in cross mode), the int32 flags, list, count
    and counter, and the f32 per-tile sums, per-tile dpos (when wanted) and
    chunk partials. Returns (the 16 regions' (byte offset, shape, dtype),
    None for a missing one; total bytes; chunks; rows a chunk)."""
    tiles = -(-N // (4 if T == 16 else 1))
    rows = 64 * tiles
    chunk, nchunks = _narrow_chunks(rows)
    bf, i32, f32 = torch.bfloat16, torch.int32, torch.float32
    regions = [None if w is None else ((rows, w), bf)
               for w in (C, C if cross else None, C, C, C, F, C, C, C, C, F,
                         C)]
    regions += [((2 * N + 2,), i32), ((tiles, 9 * C + F + 1), f32),
                ((tiles, 64 * C), f32) if dpos else None,
                ((nchunks, 8 * C * C), f32)]
    out, at = [], 0
    for r in regions:
        if r is None:
            out.append(None)
            continue
        (shape, dtype) = r
        out.append((at, shape, dtype))
        at += -(-math.prod(shape) * dtype.itemsize // 256) * 256
    return out, at, nchunks, chunk


def encoder_layer_bwd(xw, kvw, sel_q, sel_k, qmask, kmask, pos, weights, g,
                      *, nhead: int, tau_min: float, cross: bool,
                      want_dpos: bool = False):
    """Gradients of :func:`encoder_layer_fwd` for upstream ``g`` [N, 64, C]:
    (dx [N, 64, C], dkv or None, [17 weight gradients f32 in the layout of
    ``weights``], dpos [64, C] or None). ``weights``: the 17 layer tensors,
    f32 or as :func:`kernel_params` gives them. dx and dkv are bf16 on the card, as
    the TPU kernel returns them in the window dtype. K7 / K9 on the card,
    NARROW_BWD at the narrow widths."""
    if not on_card(xw, qmask, g):
        return reference_encoder_layer_bwd(
            xw, kvw, sel_q, sel_k, qmask, kmask, pos, weights, g,
            nhead=nhead, tau_min=tau_min, cross=cross, want_dpos=want_dpos)
    p = kernel_params(weights)
    xw, g = xw.contiguous(), g.to(torch.bfloat16).contiguous()
    kvw = kvw.contiguous() if cross else None
    family = _check_flat(xw, kvw, sel_q, qmask, cross, p, nhead)
    if g.shape != xw.shape:
        raise ValueError('g must be shaped like xw')
    sel = sel_q is not None
    if sel and want_dpos:
        raise ValueError('the selected-cells backward has no dpos output')
    N, _, C = xw.shape
    Fd, T = p.f1w.shape[0], (sel_q.shape[-1] if sel else 64)
    dev = xw.device
    qmask, kmask = _f32(qmask), _f32(kmask if cross else None)
    sel_q, sel_k = _i32(sel_q), _i32(sel_k if cross else None)
    pos = pos.to(torch.bfloat16).contiguous()
    dx = torch.empty_like(xw)
    dkv = torch.empty_like(xw) if cross else None
    ins = _ptrs([xw, kvw, g, pos, sel_q, sel_k, qmask, kmask])
    if family == 'narrow':
        # the 17 gradients and dpos as views of one buffer, the workspace as
        # one more
        sizes = [w.numel() for w in p] + [64 * C if want_dpos else 0]
        *grads, dpos = torch.empty(sum(sizes), dtype=torch.float32,
                                   device=dev).split(sizes)
        grads = [t.view(w.shape) for t, w in zip(grads, p)]
        dpos = dpos.view(64, C) if want_dpos else None
        layout, nbytes, nchunks, chunk = _narrow_bwd_layout(
            N, T, C, Fd, cross, want_dpos)
        base = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        work = base.data_ptr()
        ws = (ctypes.c_void_p * len(layout))(
            *[None if r is None else work + r[0] for r in layout])
        NARROW_BWD(ins, _weight_ptrs(p), ws,
                   _ptrs([dx, dkv, dpos] + grads),
                   _ints(N, T, C, Fd, nhead, int(cross), int(want_dpos),
                         nchunks, chunk), float(tau_min), stream_handle())
        return dx, dkv, grads, dpos
    dpos = (torch.empty(64, C, dtype=torch.float32, device=dev) if want_dpos
            else None)
    grads = [torch.empty(w.shape, dtype=torch.float32, device=dev)
             for w in p]
    outs = _ptrs([dx, dkv, dpos] + grads)
    ws, splits = _bwd_workspace(N, T, C, Fd, nhead, cross, want_dpos, dev)
    args = (ins, _weight_ptrs(p), _ptrs(ws), outs)
    if sel:
        K9(*args, N, T, C, Fd, nhead, int(cross), float(tau_min), splits,
           stream_handle())
    else:
        K7(*args, N, C, Fd, nhead, int(cross), float(tau_min), splits,
           stream_handle())
    return dx, dkv, grads, dpos


class _FusedEncoderLayer(torch.autograd.Function):
    """Forward K6 / K8, backward K7 / K9 (plain versions on the CPU). Takes
    the layer's weights twice: as kernel-ready :class:`LayerParams`, which
    both kernels read, and as the f32 leaves that receive the gradients."""

    @staticmethod
    def forward(ctx, xw, kvw, sel_q, sel_k, qmask, kmask, pos, cfg, p,
                *weights):
        nhead, tau_min, cross = cfg
        out = encoder_layer_fwd(xw, kvw, sel_q, sel_k, qmask, kmask, pos, p,
                                nhead=nhead, tau_min=tau_min, cross=cross)
        ctx.cfg = cfg
        ctx.save_for_backward(xw, kvw, sel_q, sel_k, qmask, kmask, pos, *p)
        return out

    @staticmethod
    def backward(ctx, g):
        nhead, tau_min, cross = ctx.cfg
        xw, kvw, sel_q, sel_k, qmask, kmask, pos, *p = ctx.saved_tensors
        dx, dkv, grads, dpos = encoder_layer_bwd(
            xw, kvw, sel_q, sel_k, qmask, kmask, pos, LayerParams(*p), g,
            nhead=nhead, tau_min=tau_min, cross=cross,
            want_dpos=ctx.needs_input_grad[6] and sel_q is None)
        return (dx, dkv, None, None, None, None, dpos, None, None, *grads)


def fused_encoder_layer(xw, kvw, sel_q, sel_k, qmask, kmask, pos, weights,
                        params: LayerParams, *, nhead: int, tau_min: float,
                        cross: bool):
    """Differentiable training layer on flat windows ``xw`` [N, 64, C]
    (``kvw`` likewise in cross mode, else None): all 64 cells with masks
    [N, 64] when ``sel_q`` is None, else the S selected cells ``sel_q`` /
    ``sel_k`` [N, S]. ``weights``: the 17 f32 layer tensors in
    :class:`LayerParams` order, which receive the gradients; ``params``:
    ``kernel_params(weights)``, which the kernels read (a layer converts
    once for all its bucket calls). Counterpart of ``fused_encoder_layer``
    and ``fused_encoder_layer_sel``."""
    return _FusedEncoderLayer.apply(xw, kvw, sel_q, sel_k, qmask, kmask, pos,
                                    (nhead, tau_min, cross), params, *weights)


# ---------------------------------------------------------------------------
# Grid-native layer: K10 forward, K7 over the windows backward
# ---------------------------------------------------------------------------


def _flat_windows(a, window, shift):
    """[B, H, W, ...] → [B * NW, window * window, ...]."""
    squeeze = a.dim() == 3
    w = window_view(a[..., None] if squeeze else a, window, shift)
    w = w.reshape(-1, *w.shape[2:])
    return w[..., 0] if squeeze else w


def _unflat_windows(a, B, grid_hw, window, shift):
    return window_unview(a.reshape(B, -1, *a.shape[1:]), grid_hw, window,
                         shift)


def reference_encoder_layer_grid(xg, kvg, qocc, kocc, pos, p: LayerParams,
                                 nhead: int, tau_min: float, cross: bool,
                                 window: int, shift: bool):
    """Plain version of K10 (counterpart of ``reference_encoder_layer_grid``):
    window view of the grid and the occupancy, the plain K6 on every window,
    inverse view. ``xg``/``kvg`` [B, H, W, C], ``qocc``/``kocc`` [B, H, W]
    bool; returns [B, H, W, C] in ``xg.dtype``."""
    qm = _flat_windows(qocc.float(), window, shift)
    km = _flat_windows(kocc.float(), window, shift) if cross else None
    out = reference_encoder_layer(
        _flat_windows(xg, window, shift),
        _flat_windows(kvg, window, shift) if cross else None, None, None, qm,
        km, pos, p, nhead, tau_min, cross)
    return _unflat_windows(out, xg.shape[0], xg.shape[1:3], window, shift)


def encoder_layer_grid(xg, kvg, qocc, kocc, pos, p: LayerParams, *,
                       nhead: int, tau_min: float, cross: bool, window: int,
                       shift: bool):
    """The layer on every ``window`` x ``window`` window of the shift's
    partition of ``xg`` [B, H, W, C] (``kvg`` likewise in cross mode), with
    query / key masks from ``qocc`` / ``kocc`` [B, H, W] bool; returns a new
    [B, H, W, C] grid. Kernel K10 on the card, NARROW_FWD at the narrow
    widths."""
    if not on_card(xg, qocc):
        return reference_encoder_layer_grid(xg, kvg, qocc, kocc, pos, p,
                                            nhead, tau_min, cross, window,
                                            shift)
    xg = xg.contiguous()
    kvg = kvg.contiguous() if cross else None
    B, H, W, C = xg.shape
    if xg.dtype != torch.bfloat16 or window != 8:
        raise ValueError('the grid kernel takes bf16 grids and 8x8 windows')
    family = layer_family(C, nhead, p.f1w.shape[0])
    if qocc.shape != (B, H, W) or (cross and (
            kvg.shape != xg.shape or kocc is None
            or kocc.shape != (B, H, W))):
        raise ValueError('occupancy / kv grid shapes do not fit the grid')
    qocc = qocc.to(torch.bool).contiguous()
    kocc = kocc.to(torch.bool).contiguous() if cross else None
    pos = pos.to(torch.bfloat16).contiguous()
    out = torch.empty_like(xg)
    nwy, nwx, _, _ = window_geometry((H, W), window)
    if family == 'narrow':
        _narrow_fwd(_GRID_OUT, [xg, kvg, out, pos, None, None, None, None,
                                qocc, kocc, None],
                    _weight_ptrs(p), B * nwy * nwx,
                    (C, p.f1w.shape[0], nhead, 64, int(cross), B, 0, 0, 0, H,
                     W, int(shift)), tau_min)
        return out
    ws, _work = _tiled_ptrs(p, B * nwy * nwx)
    K10(xg.data_ptr(), _ptr(kvg), out.data_ptr(), qocc.data_ptr(),
        _ptr(kocc), pos.data_ptr(), ws, B, H, W, C, p.f1w.shape[0], nhead,
        int(cross), int(shift), float(tau_min), stream_handle())
    return out


def encoder_layer_grid_bwd(xg, kvg, qocc, kocc, pos, weights, g, *,
                           nhead: int, tau_min: float, cross: bool,
                           window: int, shift: bool):
    """Gradients of :func:`encoder_layer_grid` for upstream ``g``
    [B, H, W, C]: (dx, dkv or None, [17 weight gradients]), as ``_grid_bwd``
    computes them: window views of x, kv, the masks and g, the backward of
    the window layer (K7 on the card), inverse views. Only the windows with
    an occupied query cell go to K7: every other window's output is zero
    whatever its input, so it adds nothing to any gradient (the selection is
    one host sync)."""
    B, hw = xg.shape[0], xg.shape[1:3]
    qm = _flat_windows(qocc.float(), window, shift)
    sel = qm.any(-1).nonzero()[:, 0]
    take = lambda a: _flat_windows(a, window, shift)[sel]
    N = qm.shape[0]
    if not len(sel):
        grads = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                 for w in weights]
        zero = torch.zeros_like(xg)
        return zero, (torch.zeros_like(kvg) if cross else None), grads
    dxw, dkvw, grads, _ = encoder_layer_bwd(
        take(xg), take(kvg) if cross else None, None, None, qm[sel],
        take(kocc.float()) if cross else None, pos, weights, take(g),
        nhead=nhead, tau_min=tau_min, cross=cross)

    def unview(d, like):
        full = torch.zeros((N, *d.shape[1:]), dtype=like.dtype,
                           device=like.device)
        full[sel] = d.to(like.dtype)
        return _unflat_windows(full, B, hw, window, shift)

    return (unview(dxw, xg), unview(dkvw, kvg) if cross else None, grads)


class _FusedEncoderLayerGrid(torch.autograd.Function):
    """Forward K10, backward :func:`encoder_layer_grid_bwd` (plain versions
    on the CPU); takes the weights twice, as :class:`_FusedEncoderLayer`."""

    @staticmethod
    def forward(ctx, xg, kvg, qocc, kocc, pos, cfg, p, *weights):
        nhead, tau_min, cross, window, shift = cfg
        out = encoder_layer_grid(xg, kvg, qocc, kocc, pos, p, nhead=nhead,
                                 tau_min=tau_min, cross=cross, window=window,
                                 shift=shift)
        ctx.cfg = cfg
        ctx.save_for_backward(xg, kvg, qocc, kocc, pos, *p)
        return out

    @staticmethod
    def backward(ctx, g):
        nhead, tau_min, cross, window, shift = ctx.cfg
        xg, kvg, qocc, kocc, pos, *p = ctx.saved_tensors
        dx, dkv, grads = encoder_layer_grid_bwd(
            xg, kvg, qocc, kocc, pos, LayerParams(*p), g, nhead=nhead,
            tau_min=tau_min, cross=cross, window=window, shift=shift)
        return (dx, dkv, None, None, None, None, None, *grads)


def fused_encoder_layer_grid(xg, kvg, qocc, kocc, pos, weights,
                             params: LayerParams, *, nhead: int,
                             tau_min: float, cross: bool, window: int,
                             shift: bool):
    """Differentiable grid-native layer (counterpart of
    ``fused_encoder_layer_grid``): ``xg`` [B, H, W, C] bf16 (``kvg``
    likewise in cross mode, else None), ``qocc``/``kocc`` [B, H, W] bool;
    ``weights`` and ``params`` as :func:`fused_encoder_layer` takes them."""
    return _FusedEncoderLayerGrid.apply(
        xg, kvg, qocc, kocc, pos, (nhead, tau_min, cross, window, shift),
        params, *weights)



# ---------------------------------------------------------------------------
# Serving straight against the padded carrier: K12
# ---------------------------------------------------------------------------


def reference_encoder_layer_fused(xp, kvp, ci, pos, p: LayerParams, *,
                                  nhead: int, tau_min: float, cross: bool,
                                  window: int, sel: bool):
    """Plain version of K12: gather the plan's windows, the plain layer
    (all cells, or the selected ones), scatter them back into ``xp`` in
    place."""
    xw = gather_windows_padded_plain(xp, ci.idx, window)
    kvw = gather_windows_padded_plain(kvp, ci.idx, window) if cross else None
    if sel:
        sel_k, kmask = (ci.ksel, ci.kmask) if cross else (ci.sel, ci.qmask)
        out = reference_encoder_layer(xw, kvw, ci.sel, sel_k, ci.qmask,
                                      kmask, pos, p, nhead, tau_min, cross)
    else:
        out = reference_encoder_layer(xw, kvw, None, None, ci.qmask,
                                      ci.kmask if cross else ci.qmask, pos,
                                      p, nhead, tau_min, cross)
    return scatter_windows_into_padded_plain(out, ci.idx, xp, window)


def encoder_layer_fused_pipelined(xp, kvp, ci, pos, p, *, nhead: int,
                                  tau_min: float, cross: bool, window: int,
                                  sel: bool):
    """One serving layer over the windows of one bucket plan ``ci``, straight
    against the padded carrier ``xp`` [B, Hp + w, Wp, C] bf16, updated IN
    PLACE and returned (counterpart of ``encoder_layer_fused_pipelined``).
    A full plan (``CompactInfo``) takes ``sel=False``; a small or mid plan
    (``SmallCompactInfo``, S = 16 or 48) ``sel=True``. Cross mode reads keys
    and values from ``kvp``, the other frame's carrier, which must not share
    memory with ``xp``. Windows outside the plan and dummy slots are not
    touched. ``p``: :class:`TiledWeights`, or :class:`LayerParams`
    (prepared for this call). Forward only: it refuses inputs that require a
    gradient. Kernel K12 on the card, NARROW_FWD at the narrow widths."""
    if cross and kvp is not None and _shares_memory(kvp, xp):
        raise ValueError('kvp shares memory with the carrier it updates')
    if torch.is_grad_enabled() and (
            xp.requires_grad or (cross and kvp.requires_grad)):
        raise ValueError('the in-place serving layer has no backward: run '
                         'it in eval mode under torch.no_grad()')
    kw = dict(nhead=nhead, tau_min=tau_min, cross=cross, window=window,
              sel=sel)
    if not on_card(xp, ci.idx):
        return reference_encoder_layer_fused(xp, kvp, ci, pos,
                                             _plain_params(p), **kw)
    if xp.dtype != torch.bfloat16 or not xp.is_contiguous() or window != 8:
        raise ValueError('K12 takes a contiguous bf16 carrier and 8x8 '
                         'windows')
    B, Hp2, Wp, C = xp.shape
    if cross and (kvp is None or kvp.shape != xp.shape
                  or kvp.dtype != xp.dtype or not kvp.is_contiguous()):
        raise ValueError('cross mode needs a contiguous kvp shaped like xp')
    cap = ci.idx.shape[1]
    T = ci.sel.shape[-1] if sel else 64
    if (ci.idx.shape != (B, cap, 2) or ci.qmask.shape != (B, cap, T)
            or T not in (16, 48, 64) or Hp2 % window or Wp % window):
        raise ValueError('plan shapes do not fit the carrier')
    tw = _prepared(p, C, nhead)
    idx = _i32(ci.idx)
    sel_q = _i32(ci.sel) if sel else None
    sel_k = _i32(ci.ksel) if sel and cross else None
    qmask = _f32(ci.qmask)
    kmask = _f32(ci.kmask) if cross else None
    pos = as_kernel_arg(pos, torch.bfloat16)
    if tw.family == 'narrow':
        _narrow_fwd(_PLAN, [xp, kvp if cross else None, None, pos, sel_q,
                            sel_k, qmask, kmask, None, None, idx],
                    tw.ptrs, B * cap,
                    (C, tw.ffn, nhead, T, int(cross), B, 0, cap, 0, Hp2, Wp,
                     0), tau_min)
        return xp
    work = _work(B * cap, xp.device)
    K12(xp.data_ptr(), _ptr(kvp) if cross else None, idx.data_ptr(),
        _ptr(sel_q), _ptr(sel_k), qmask.data_ptr(), _ptr(kmask),
        pos.data_ptr(), tw.ptrs, work.data_ptr(), B, Hp2, Wp, cap, C,
        tw.ffn, nhead, T, int(cross), float(tau_min), stream_handle())
    return xp


# ``encoder_layer_fused_inplace`` (K11) computes the same function as K12
# with another DMA schedule; on the card both are the one K12 launch.
encoder_layer_fused_inplace = encoder_layer_fused_pipelined
