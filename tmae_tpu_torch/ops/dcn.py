"""Modulated deformable convolution v2 and the bilinear point gather of
GraphRCNN's camera branch (counterpart of ``tmae_tpu/ops/dcn.py`` and of
``models/point_sample.py``'s ``img_grid_sample``).

Layouts as the JAX package's: ``x`` NHWC [B, H, W, Cin], ``offset``
[B, Ho, Wo, 2 K] as (dy, dx) per tap, ``mask`` [B, Ho, Wo, K] (the
modulation, sigmoid-activated by the caller), ``weight`` [kh, kw, Cin,
Cout], K = kh kw. A bilinear sample sums its four corners in the order
(0, 0), (0, 1), (1, 0), (1, 1), each zero outside the map.

Hand-written kernels (``csrc/dcn.cu``) on CUDA tensors, their plain
versions on CPU tensors:

* ``DCN_COLS``: :func:`dcn_cols`, the modulated im2col [B, Ho, Wo, K, Cin];
* ``DCN_COORD_BWD``: :func:`dcn_coord_bwd`, d offset and d mask from
  d cols;
* ``BILINEAR_GRAD``: :func:`bilinear_grad`, the gradient of bilinear
  samples with respect to the sampled map (DCN's d x, PointSample's d
  image features), summed per target pixel in sample order after a stable
  sort of the (pixel, contribution) keys: deterministic, no float atomics;
* ``POINT_SAMPLE``: :func:`point_sample`, the gather at given coordinates
  with a validity mask.

:func:`deform_conv2d` is a ``torch.autograd.Function`` over them; its tap
contraction ``cols [B Ho Wo, K Cin] @ weight [K Cin, Cout]`` and its
weight gradient are torch matmuls, as the JAX package's einsum is an XLA
product. :func:`sample_points` is the differentiable gather of
PointSample (no gradient to the coordinates, which are data and detached
RoIs there). DCN_COLS and POINT_SAMPLE give their plain versions' bits;
the two reductions sum in another order than the plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import on_card
from ..utils.build import CudaKernel, I, L, P, stream_handle

DCN_COLS = CudaKernel('dcn.cu', 'launch_dcn_cols', [P] * 4 + [I] * 11 + [P])
DCN_COORD_BWD = CudaKernel('dcn.cu', 'launch_dcn_coord_bwd',
                           [P] * 6 + [I] * 11 + [P])
BILINEAR_GRAD = CudaKernel('dcn.cu', 'launch_bilinear_grad',
                           [P] * 7 + [L, I, L, P])
POINT_SAMPLE = CudaKernel('dcn.cu', 'launch_point_sample',
                          [P] * 5 + [I] * 5 + [P])


class Taps(NamedTuple):
    """A deformable convolution's kernel and its placement."""

    kh: int
    kw: int
    stride: int = 1
    padding: int = 1
    dilation: int = 1

    def out_hw(self, H: int, W: int) -> tuple[int, int]:
        s, p, d = self.stride, self.padding, self.dilation
        return ((H + 2 * p - d * (self.kh - 1) - 1) // s + 1,
                (W + 2 * p - d * (self.kw - 1) - 1) // s + 1)


def _weights(ys, xs):
    """Top-left corners and the four corner weights of samples at (ys,
    xs)."""
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0, xs - x0
    return y0, x0, ((1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx),
                    wy * wx)


def _corner(y0, x0, k: int, H: int, W: int):
    """Corner k's (y, x) as ints (0 where outside) and whether it lies in
    the H x W map."""
    yy, xx = y0 + (k >> 1), x0 + (k & 1)
    inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    return (torch.where(inb, yy, 0.0).long(), torch.where(inb, xx, 0.0).long(),
            inb)


def _corner_values(img, ys, xs):
    """The four corners' values [B, n, C] (0 outside) of img [B, H, W, C]
    at ys / xs [B, n], and the corner weights."""
    B, H, W, C = img.shape
    flat = img.reshape(B * H * W, C)
    base = torch.arange(B, device=img.device)[:, None] * (H * W)
    y0, x0, ws = _weights(ys, xs)
    vals = []
    for k in range(4):
        yy, xx, inb = _corner(y0, x0, k, H, W)
        vals.append(torch.where(inb[..., None], flat[base + yy * W + xx],
                                0.0))
    return vals, ws


def _gather(img, ys, xs):
    """img [B, H, W, C] at ys / xs [B, ...] → [B, ..., C]."""
    B, C = img.shape[0], img.shape[-1]
    shape = ys.shape
    vals, ws = _corner_values(img, ys.reshape(B, -1), xs.reshape(B, -1))
    out = 0.0
    for v, w in zip(vals, ws):
        out = out + v * w[..., None]
    return out.reshape(*shape, C)


def bilinear_sample(img, ys, xs):
    """The JAX package's ``_bilinear_sample``: img [H, W, C]; ys / xs [...]
    float → [..., C], zero outside."""
    return _gather(img[None], ys[None], xs[None])[0]


def tap_coords(offset, taps: Taps, Ho: int, Wo: int):
    """The sample coordinates (ys, xs) [B, Ho, Wo, K] of every tap: the
    tap's place on the grid plus its offset."""
    B = offset.shape[0]
    K = taps.kh * taps.kw
    dev = offset.device
    k = torch.arange(K, device=dev)
    oy = torch.arange(Ho, device=dev) * taps.stride - taps.padding
    ox = torch.arange(Wo, device=dev) * taps.stride - taps.padding
    base_y = (oy[:, None, None] + (k // taps.kw)[None, None] * taps.dilation
              ).float()
    base_x = (ox[None, :, None] + (k % taps.kw)[None, None] * taps.dilation
              ).float()
    off = offset.reshape(B, Ho, Wo, K, 2)
    return base_y + off[..., 0], base_x + off[..., 1]


def _geometry(x, offset, mask, taps: Taps):
    B, H, W, C = x.shape
    Ho, Wo = taps.out_hw(H, W)
    K = taps.kh * taps.kw
    if (offset.shape != (B, Ho, Wo, 2 * K) or mask.shape != (B, Ho, Wo, K)):
        raise ValueError(f'offset {tuple(offset.shape)} / mask '
                         f'{tuple(mask.shape)} do not fit x {tuple(x.shape)} '
                         f'under {taps}')
    return B, H, W, C, Ho, Wo, K


def _f32(*ts):
    for t in ts:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError('the DCN kernels take contiguous float32 '
                             f'tensors, got {t.dtype} '
                             f'(contiguous {t.is_contiguous()})')


def _launch_dims(x, Ho, Wo, taps: Taps):
    B, H, W, C = x.shape
    return (B, H, W, C, Ho, Wo, taps.kh, taps.kw, taps.stride, taps.padding,
            taps.dilation)


def dcn_cols_plain(x, offset, mask, taps: Taps):
    """cols [B, Ho, Wo, K, Cin]: each tap's bilinear sample of x times its
    mask."""
    _geometry(x, offset, mask, taps)
    ys, xs = tap_coords(offset, taps, *taps.out_hw(*x.shape[1:3]))
    return _gather(x, ys, xs) * mask[..., None]


def dcn_cols(x, offset, mask, taps: Taps):
    """DCN_COLS on the card, :func:`dcn_cols_plain` on the CPU."""
    if not on_card(x, offset, mask):
        return dcn_cols_plain(x, offset, mask, taps)
    B, H, W, C, Ho, Wo, K = _geometry(x, offset, mask, taps)
    _f32(x, offset, mask)
    cols = torch.empty(B, Ho, Wo, K, C, device=x.device)
    DCN_COLS(x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
             cols.data_ptr(), *_launch_dims(x, Ho, Wo, taps), stream_handle())
    return cols


def dcn_coord_bwd_plain(x, offset, mask, dcols, taps: Taps):
    """d offset [B, Ho, Wo, 2 K] and d mask [B, Ho, Wo, K] from dcols
    [B, Ho, Wo, K, Cin]: d mask = sum_c dcols * sample, d (dy, dx) = mask *
    sum_c dcols * d sample / d (y, x)."""
    B, H, W, C, Ho, Wo, K = _geometry(x, offset, mask, taps)
    ys, xs = tap_coords(offset, taps, Ho, Wo)
    (v0, v1, v2, v3), ws = _corner_values(x, ys.reshape(B, -1),
                                          xs.reshape(B, -1))
    w = [t[..., None] for t in ws]
    wy = (ys - torch.floor(ys)).reshape(B, -1, 1)
    wx = (xs - torch.floor(xs)).reshape(B, -1, 1)
    s = 0.0 + v0 * w[0] + v1 * w[1] + v2 * w[2] + v3 * w[3]
    dsy = (v2 - v0) * (1 - wx) + (v3 - v1) * wx
    dsx = (v1 - v0) * (1 - wy) + (v3 - v2) * wy
    d = dcols.reshape(B, -1, C)
    m = mask.reshape(B, -1)
    dmask = (d * s).sum(-1)
    doff = torch.stack([(d * dsy).sum(-1) * m, (d * dsx).sum(-1) * m], -1)
    return doff.reshape(B, Ho, Wo, 2 * K), dmask.reshape(B, Ho, Wo, K)


def dcn_coord_bwd(x, offset, mask, dcols, taps: Taps):
    """DCN_COORD_BWD on the card, :func:`dcn_coord_bwd_plain` on the
    CPU."""
    if not on_card(x, offset, mask, dcols):
        return dcn_coord_bwd_plain(x, offset, mask, dcols, taps)
    B, H, W, C, Ho, Wo, K = _geometry(x, offset, mask, taps)
    _f32(x, offset, mask, dcols)
    if dcols.shape != (B, Ho, Wo, K, C):
        raise ValueError(f'dcols {tuple(dcols.shape)} is not '
                         f'{(B, Ho, Wo, K, C)}')
    doff = torch.empty_like(offset)
    dmask = torch.empty_like(mask)
    DCN_COORD_BWD(x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                  dcols.data_ptr(), doff.data_ptr(), dmask.data_ptr(),
                  *_launch_dims(x, Ho, Wo, taps), stream_handle())
    return doff, dmask


def corner_keys(ys, xs, valid, H: int, W: int):
    """[B, n] samples → [B, n, 4] int64: each corner's flat target pixel
    ((b H + y) W + x) in a [B, H, W] map, or B H W for a corner outside it
    or a sample that is not ``valid`` (None: all are)."""
    B = ys.shape[0]
    y0, x0, _ = _weights(ys, xs)
    base = torch.arange(B, device=ys.device)[:, None] * (H * W)
    keys = []
    for k in range(4):
        yy, xx, inb = _corner(y0, x0, k, H, W)
        if valid is not None:
            inb = inb & valid
        keys.append(torch.where(inb, base + yy * W + xx, B * H * W))
    return torch.stack(keys, -1)


def bilinear_grad_plain(g, scale, ys, xs, valid, H: int, W: int):
    """The gradient of ``_gather(img, ys, xs)`` with respect to img
    [B, H, W, C] for the cotangent ``g * scale`` (g [B, n, C], scale
    [B, n] or None) at the ``valid`` samples (None: all)."""
    B, n, C = g.shape
    gs = g if scale is None else g * scale[..., None]
    _, _, ws = _weights(ys, xs)
    keys = corner_keys(ys, xs, valid, H, W)
    out = torch.zeros(B * H * W + 1, C, dtype=g.dtype, device=g.device)
    for k in range(4):
        out.index_add_(0, keys[..., k].reshape(-1),
                       (gs * ws[k][..., None]).reshape(-1, C))
    return out[:-1].reshape(B, H, W, C)


def bilinear_grad(g, scale, ys, xs, valid, H: int, W: int):
    """BILINEAR_GRAD on the card (after a stable sort of the
    :func:`corner_keys`), :func:`bilinear_grad_plain` on the CPU."""
    if not on_card(g, scale, ys, xs, valid):
        return bilinear_grad_plain(g, scale, ys, xs, valid, H, W)
    B, n, C = g.shape
    _f32(g, ys, xs, *([] if scale is None else [scale]))
    keys, order = torch.sort(
        corner_keys(ys, xs, valid, H, W).reshape(-1).int(), stable=True)
    out = torch.empty(B, H, W, C, device=g.device)
    BILINEAR_GRAD(g.data_ptr(), None if scale is None else scale.data_ptr(),
                  ys.data_ptr(), xs.data_ptr(), keys.data_ptr(),
                  order.data_ptr(), out.data_ptr(), B * H * W, C,
                  keys.numel(), stream_handle())
    return out


def point_sample_plain(feats, ys, xs, valid):
    """feats [B, H, W, C] at ys / xs [B, n] → [B, n, C], 0 where not
    ``valid``."""
    return torch.where(valid[..., None], _gather(feats, ys, xs), 0.0)


def point_sample(feats, ys, xs, valid):
    """POINT_SAMPLE on the card, :func:`point_sample_plain` on the CPU."""
    if not on_card(feats, ys, xs, valid):
        return point_sample_plain(feats, ys, xs, valid)
    B, H, W, C = feats.shape
    n = ys.shape[1]
    _f32(feats, ys, xs)
    if valid.dtype != torch.bool or not valid.is_contiguous():
        raise ValueError('POINT_SAMPLE takes a contiguous bool mask')
    out = torch.empty(B, n, C, device=feats.device)
    POINT_SAMPLE(feats.data_ptr(), ys.data_ptr(), xs.data_ptr(),
                 valid.data_ptr(), out.data_ptr(), B, n, H, W, C,
                 stream_handle())
    return out


class _PointGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, feats, ys, xs, valid):
        ctx.save_for_backward(ys, xs, valid)
        ctx.hw = feats.shape[1:3]
        return point_sample(feats, ys, xs, valid)

    @staticmethod
    def backward(ctx, g):
        ys, xs, valid = ctx.saved_tensors
        return (bilinear_grad(g.contiguous(), None, ys, xs, valid, *ctx.hw),
                None, None, None)


def sample_points(feats, ys, xs, valid):
    """:func:`point_sample` with the gradient to ``feats``
    (BILINEAR_GRAD); ys, xs and valid carry none."""
    return _PointGather.apply(feats.contiguous(), ys.contiguous(),
                              xs.contiguous(), valid.contiguous())


class _DeformConv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, taps):
        B, H, W, C, Ho, Wo, K = _geometry(x, offset, mask, taps)
        cout = weight.shape[-1]
        cols = dcn_cols(x, offset, mask, taps)
        out = cols.reshape(-1, K * C) @ weight.reshape(K * C, cout)
        if bias is not None:
            out = out + bias
        ctx.save_for_backward(x, offset, mask, weight, cols)
        ctx.taps, ctx.has_bias = taps, bias is not None
        return out.reshape(B, Ho, Wo, cout)

    @staticmethod
    def backward(ctx, gout):
        x, offset, mask, weight, cols = ctx.saved_tensors
        taps = ctx.taps
        B, H, W, C, Ho, Wo, K = _geometry(x, offset, mask, taps)
        cout = weight.shape[-1]
        need_x, need_off, need_mask, need_w, need_b = ctx.needs_input_grad[:5]
        g2 = gout.reshape(-1, cout)
        dx = doff = dmask = dw = db = None
        if need_w:
            dw = (cols.reshape(-1, K * C).t() @ g2).reshape(weight.shape)
        if need_b and ctx.has_bias:
            db = g2.sum(0)
        if need_x or need_off or need_mask:
            dcols = (g2 @ weight.reshape(K * C, cout).t()).reshape(
                B, Ho, Wo, K, C)
            if need_off or need_mask:
                doff, dmask = dcn_coord_bwd(x, offset, mask, dcols, taps)
            if need_x:
                ys, xs = tap_coords(offset, taps, Ho, Wo)
                dx = bilinear_grad(dcols.reshape(B, -1, C),
                                   mask.reshape(B, -1), ys.reshape(B, -1),
                                   xs.reshape(B, -1), None, H, W)
        return dx, doff, dmask, dw, db, None


def deform_conv2d(x, offset, mask, weight, bias=None, stride: int = 1,
                  padding: int = 1, dilation: int = 1):
    """DCNv2: x [B, H, W, Cin], offset [B, Ho, Wo, 2 K] ((dy, dx) per tap),
    mask [B, Ho, Wo, K], weight [kh, kw, Cin, Cout] → [B, Ho, Wo, Cout]."""
    kh, kw = weight.shape[:2]
    return _DeformConv.apply(x.contiguous(), offset.contiguous(),
                             mask.contiguous(), weight, bias,
                             Taps(kh, kw, stride, padding, dilation))
