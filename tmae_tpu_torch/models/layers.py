"""Building blocks on NHWC carriers (counterpart of
``tmae_tpu/models/layers.py``): batch norms, the masked dense formulation of
the sparse convolutions, the MLP block, the modulated deformable
convolution block of the camera branch, and rematerialisation.

Dtypes follow the JAX package: convolutions take bf16 inputs and weights and
give bf16 (the carrier); batch-norm statistics and normalisation run in f32.
Plain convolutions are ``torch.nn.functional.conv2d``; the pyramid fuse's
deconvolutions are one matmul per cell.
In train mode (``module.train()``) the batch norms normalise with the
statistics of the batch and update their running statistics with torch's
momentum convention (``running = (1 - m) * running + m * batch``). Under
data parallelism the batch is the global batch: the statistics' sums and
counts go through ``parallel/dist.global_sum`` (in the remat replay too),
so they, and the running statistics, are equal on every rank.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.dcn import deform_conv2d
from ..ops.sparse_conv import subm_conv3x3
from ..parallel.dist import global_mean, global_sum

BN_EPS = 1e-3
BN_MOMENTUM = 0.01   # torch momentum of the sparse-conv and BEV batch norms
CONV_DTYPE = torch.bfloat16
CARRIER_DTYPE = torch.bfloat16

# Set while torch.utils.checkpoint replays a forward in the backward, in the
# thread that replays it (the autograd engine's thread for CUDA tensors).
_remat = threading.local()


@contextlib.contextmanager
def _replay():
    before = getattr(_remat, 'replaying', False)
    _remat.replaying = True
    try:
        yield
    finally:
        _remat.replaying = before


def remat(fn, *args, enabled: bool = True):
    """``fn(*args)``, its activations recomputed in the backward instead of
    kept (``nn.remat`` of the JAX package) when ``enabled`` and autograd is
    recording. The replay is the whole forward of ``fn``; batch norms do not
    update their running statistics a second time during it."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, early_stop=False,
                      context_fn=lambda: (contextlib.nullcontext(), _replay()))


class _Norm(nn.Module):
    """Affine parameters plus running statistics of one batch norm."""

    def __init__(self, channels: int, eps: float, momentum: float):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def _update(self, mean, var):
        if getattr(_remat, 'replaying', False):
            return
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)


class MaskedBatchNorm(_Norm):
    """Batch norm over the valid cells of ``x [..., C]``; invalid cells give
    0. Train mode: statistics over the valid cells only, in f32; the running
    variance takes the unbiased ``var * cnt / max(cnt - 1, 1)``."""

    def __init__(self, channels: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__(channels, eps, momentum)

    def forward(self, x, mask):
        xf = x.float()
        if self.training:
            m = mask.float()[..., None]
            red = tuple(range(x.dim() - 1))
            # sums and count over every rank's batch (one all-reduce), then
            # the squared deviations from that mean (another)
            s = global_sum(torch.cat([(xf * m).sum(red), m.sum().reshape(1)]))
            cnt = s[-1].clamp(min=1.0)
            mean = s[:-1] / cnt
            var = global_sum(((xf - mean).square() * m).sum(red)) / cnt
            self._update(mean, var * cnt / (cnt - 1.0).clamp(min=1.0))
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return torch.where(mask[..., None], y, 0.0).to(x.dtype)


class BatchNorm2d(_Norm):
    """Dense batch norm over NHWC maps. Train mode: statistics over every
    cell as flax's ``nn.BatchNorm`` takes them (f32, var = E[x^2] - E[x]^2
    clipped at 0), and the running variance takes that biased variance."""

    def __init__(self, channels: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__(channels, eps, momentum)

    def forward(self, x):
        xf = x.float()
        if self.training:
            red = tuple(range(x.dim() - 1))
            mean, sq = global_mean(xf, red, squares=True)
            var = (sq - mean * mean).clamp(min=0.0)
            self._update(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


def conv2d_nhwc(x, weight, stride=1, padding=0, dilation=1, bias=None,
                dtype=CONV_DTYPE):
    """NHWC convolution through ``F.conv2d``; ``weight`` is OIHW. Inputs and
    weights are cast to ``dtype`` and so is the result."""
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), weight.to(dtype),
                 None if bias is None else bias.to(dtype), stride, padding,
                 dilation)
    return y.permute(0, 2, 3, 1)


class ConvBNReLU(nn.Module):
    """Conv2d + BN + ReLU on dense NHWC maps."""

    def __init__(self, cin, cout, kernel=3, stride=1, dilation=1, padding=None,
                 eps=BN_EPS, use_bias=False, momentum=BN_MOMENTUM):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.padding = (padding if padding is not None
                        else dilation * (kernel // 2))
        self.conv = nn.Conv2d(cin, cout, kernel, bias=use_bias)
        self.bn = BatchNorm2d(cout, eps, momentum)

    def forward(self, x):
        x = conv2d_nhwc(x, self.conv.weight, self.stride, self.padding,
                        self.dilation, self.conv.bias).to(CARRIER_DTYPE)
        return F.relu(self.bn(x))


class DeconvBNReLU(nn.Module):
    """ConvTranspose2d(kernel = stride, no bias) + BN + ReLU. The weight is
    ``[cin, cout, s, s]``; the JAX package's kernel ``K [s, s, cin, cout]``
    maps to ``W[c, o, i, j] = K[s-1-i, s-1-j, c, o]`` (utils/from_jax.py).

    With kernel == stride every output cell takes exactly one tap, so the
    deconv runs as the JAX package runs it: one matmul per input cell
    ``[.., cin] @ [cin, s*s*cout]`` and a depth-to-space reshape. (PyTorch's
    CPU ``conv_transpose2d`` gives a wrong input gradient in bf16 at
    stride 4.)"""

    def __init__(self, cin, cout, stride):
        super().__init__()
        self.stride = stride
        self.deconv = nn.ConvTranspose2d(cin, cout, stride, stride=stride,
                                         bias=False)
        self.bn = BatchNorm2d(cout)

    def forward(self, x):
        s = self.stride
        B, H, W, cin = x.shape
        w = self.deconv.weight
        kmat = w.permute(0, 2, 3, 1).reshape(cin, -1).to(CONV_DTYPE)
        y = (x.to(CONV_DTYPE) @ kmat).reshape(B, H, W, s, s, w.shape[1])
        y = y.transpose(2, 3).reshape(B, H * s, W * s, w.shape[1])
        return F.relu(self.bn(y.to(CARRIER_DTYPE)))


class LinearBNReLU(nn.Module):
    """Linear(no bias) + masked BN (torch default eps 1e-5 and momentum 0.1)
    + ReLU over point lists, in f32."""

    def __init__(self, cin, cout, eps=1e-5):
        super().__init__()
        self.linear = nn.Linear(cin, cout, bias=False)
        self.bn = MaskedBatchNorm(cout, eps, momentum=0.1)

    def forward(self, x, mask):
        return F.relu(self.bn(self.linear(x), mask))


class SubMConvBlock(nn.Module):
    """Submanifold 3x3 conv as a dense masked conv: outputs masked to the
    input active set, + masked BN + ReLU.

    With a compaction ``plan`` (idx [B, cap, 2] windows of the unshifted
    partition, qmask [B, cap, w*w], window), the conv runs only on the
    plan's windows (``ops/sparse_conv.py``: K15 on the card) with the same
    weight; occupied windows beyond the plan's cap give zeros."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, bias=False)
        self.bn = MaskedBatchNorm(cout)

    def forward(self, grid, occ, plan=None):
        if plan is not None:
            idx, qmask, window = plan
            w = self.conv.weight
            x = subm_conv3x3(
                grid.to(CONV_DTYPE), idx, qmask,
                w.permute(2, 3, 1, 0).to(CONV_DTYPE),
                torch.zeros(w.shape[0], device=w.device),
                (grid.shape[1], grid.shape[2]), window).to(CARRIER_DTYPE)
        else:
            x = conv2d_nhwc(grid, self.conv.weight, 1, 1).to(CARRIER_DTYPE)
            x = torch.where(occ[..., None], x,
                            torch.zeros((), dtype=x.dtype, device=x.device))
        return F.relu(self.bn(x, occ))


class StridedSparseConvBlock(nn.Module):
    """SparseConv2d(k=3, s=2, p=1) + BN + ReLU in the masked dense form; the
    caller gives the output active set."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, bias=False)
        self.bn = MaskedBatchNorm(cout)

    def forward(self, grid, occ_out):
        x = conv2d_nhwc(grid, self.conv.weight, 2, 1).to(CARRIER_DTYPE)
        x = torch.where(occ_out[..., None], x,
                        torch.zeros((), dtype=x.dtype, device=x.device))
        return F.relu(self.bn(x, occ_out))


class DeformConvBNReLU(nn.Module):
    """DCNv2 block of the DLA image backbone (stride 1, f32): a 3x3 conv
    ``conv_offset_mask`` (zero-initialised, 'SAME' padding, with bias)
    predicts each tap's offset (the first 2 K channels, (dy, dx) per tap)
    and its modulation (the last K, through a sigmoid: 0.5 at the start);
    ``ops/dcn.deform_conv2d`` samples and contracts with ``weight`` (OIHW,
    the JAX package's HWIO ``kernel`` transposed); then a dense batch norm
    (eps 1e-5, torch momentum 0.1: flax's 0.9) and ReLU."""

    def __init__(self, cin, features, kernel=3):
        super().__init__()
        self.kernel = kernel
        self.conv_offset_mask = nn.Conv2d(cin, 3 * kernel * kernel, kernel)
        nn.init.zeros_(self.conv_offset_mask.weight)
        nn.init.zeros_(self.conv_offset_mask.bias)
        self.weight = nn.Parameter(torch.empty(features, cin, kernel,
                                               kernel))
        nn.init.kaiming_normal_(self.weight)
        self.bn = BatchNorm2d(features, eps=1e-5, momentum=0.1)

    def forward(self, x):
        K = self.kernel * self.kernel
        pad = (self.kernel - 1) // 2
        pred = conv2d_nhwc(x, self.conv_offset_mask.weight, 1, pad,
                           bias=self.conv_offset_mask.bias,
                           dtype=torch.float32)
        y = deform_conv2d(x, pred[..., :2 * K],
                          torch.sigmoid(pred[..., 2 * K:]),
                          self.weight.permute(2, 3, 1, 0), padding=pad)
        return F.relu(self.bn(y))
