"""Conv–BatchNorm folding (counterpart of ``tmae_tpu/utils/fuse.py``,
applied by ``tools/test.py --fuse_conv_bn``).

The pairs folded are the JAX package's: every module that holds one
convolution-like child (``conv``, ``deconv`` or ``linear``; flax's
``Conv_*``, ``ConvTranspose_*``, ``Dense_*``) beside one batch norm
(``bn``; ``BatchNorm2d_*`` or ``MaskedBatchNorm_*``). The head's
``shared_conv`` / ``shared_bn`` are not such a pair there, and are not
here. Folding rule for y = BN(conv(x)), with s = scale / sqrt(var + eps):

    weight' = weight * s           (on the output-channel axis)
    BN bias' = bias - mean * s     (+ conv bias * s, the conv bias then 0)

after which the BN is the identity plus bias' (scale 1, mean 0,
var 1 - eps). Each BN's own epsilon is used. (The JAX package's default
``eps_fn`` takes 1e-3 for every ``BatchNorm2d``, also for the head's
convolutions, whose BN has 1e-5, and keeps a folded conv's bias, so that
bias counts twice; the tests hand it each BN's epsilon and compare the
rest.)

The port's convolutions compute in bf16, so a folded model's outputs move
by the bf16 rounding of the scaled weights.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.layers import BatchNorm2d, MaskedBatchNorm

_CONV_CHILDREN = ('conv', 'deconv', 'linear')
_NORMS = (BatchNorm2d, MaskedBatchNorm)


@torch.no_grad()
def fuse_conv_bn(model: nn.Module) -> int:
    """Folds every conv–BN pair of ``model`` in place. Returns the number of
    pairs folded."""
    folded = 0
    for mod in model.modules():
        bn = getattr(mod, 'bn', None)
        convs = [getattr(mod, n) for n in _CONV_CHILDREN
                 if isinstance(getattr(mod, n, None), nn.Module)]
        if not isinstance(bn, _NORMS) or len(convs) != 1:
            continue
        conv = convs[0]
        s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        # the output channels: dim 1 of a transposed conv's weight
        # [cin, cout, k, k], dim 0 of a conv's or a linear layer's
        axis = 1 if isinstance(conv, nn.ConvTranspose2d) else 0
        shape = [1] * conv.weight.dim()
        shape[axis] = -1
        conv.weight.mul_(s.reshape(shape))
        bias = bn.bias - bn.running_mean * s
        if conv.bias is not None:
            bias = bias + conv.bias * s
            conv.bias.zero_()
        bn.bias.copy_(bias)
        bn.weight.fill_(1.0)
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0 - bn.eps)
        folded += 1
    return folded
