"""Eval-mode building blocks on NHWC carriers (counterpart of
``tmae_tpu/models/layers.py``): batch norms with running statistics, the
masked dense formulation of the sparse convolutions, and the MLP block.

Dtypes follow the JAX package: convolutions take bf16 inputs and weights and
give bf16 (the carrier); batch-norm statistics and normalisation run in f32.
Plain convolutions are ``torch.nn.functional.conv2d``/``conv_transpose2d``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
CONV_DTYPE = torch.bfloat16
CARRIER_DTYPE = torch.bfloat16


class _Norm(nn.Module):
    """Affine parameters plus running statistics of one batch norm."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))


class MaskedBatchNorm(_Norm):
    """Batch norm over the valid cells of ``x [..., C]`` with running
    statistics (eval mode); invalid cells give 0."""

    def __init__(self, channels: int, eps: float = BN_EPS):
        super().__init__(channels, eps)

    def forward(self, x, mask):
        y = ((x.float() - self.running_mean)
             * torch.rsqrt(self.running_var + self.eps)
             * self.weight + self.bias)
        return torch.where(mask[..., None], y, 0.0).to(x.dtype)


class BatchNorm2d(_Norm):
    """Dense batch norm over NHWC maps with running statistics."""

    def __init__(self, channels: int, eps: float = BN_EPS):
        super().__init__(channels, eps)

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean) * mul + self.bias
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
                 eps=BN_EPS, use_bias=False):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.padding = (padding if padding is not None
                        else dilation * (kernel // 2))
        self.conv = nn.Conv2d(cin, cout, kernel, bias=use_bias)
        self.bn = BatchNorm2d(cout, eps)

    def forward(self, x):
        x = conv2d_nhwc(x, self.conv.weight, self.stride, self.padding,
                        self.dilation, self.conv.bias).to(CARRIER_DTYPE)
        return F.relu(self.bn(x))


class DeconvBNReLU(nn.Module):
    """ConvTranspose2d(kernel = stride, no bias) + BN + ReLU. The weight is
    ``[cin, cout, s, s]``; the JAX package's kernel ``K [s, s, cin, cout]``
    maps to ``W[c, o, i, j] = K[s-1-i, s-1-j, c, o]`` (utils/from_jax.py)."""

    def __init__(self, cin, cout, stride):
        super().__init__()
        self.stride = stride
        self.deconv = nn.ConvTranspose2d(cin, cout, stride, stride=stride,
                                         bias=False)
        self.bn = BatchNorm2d(cout)

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(CONV_DTYPE),
                               self.deconv.weight.to(CONV_DTYPE),
                               stride=self.stride)
        return F.relu(self.bn(y.permute(0, 2, 3, 1).to(CARRIER_DTYPE)))


class LinearBNReLU(nn.Module):
    """Linear(no bias) + masked BN (torch default eps 1e-5) + ReLU over
    point lists, in f32."""

    def __init__(self, cin, cout, eps=1e-5):
        super().__init__()
        self.linear = nn.Linear(cin, cout, bias=False)
        self.bn = MaskedBatchNorm(cout, eps)

    def forward(self, x, mask):
        return F.relu(self.bn(self.linear(x), mask))


class SubMConvBlock(nn.Module):
    """Submanifold 3x3 conv as a dense masked conv: outputs masked to the
    input active set, + masked BN + ReLU."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, bias=False)
        self.bn = MaskedBatchNorm(cout)

    def forward(self, grid, occ):
        x = conv2d_nhwc(grid, self.conv.weight, 1, 1).to(CARRIER_DTYPE)
        x = torch.where(occ[..., None], x, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))
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
