"""Carry weights across from the JAX package: its flax ``params`` and
``batch_stats`` (as numpy arrays) → this package's ``state_dict``.

Module paths keep the flax names, with flax's auto-named sub-modules
renamed (``Conv_0`` → ``conv``, ``MaskedBatchNorm_0``/``BatchNorm2d_0/
BatchNorm_0`` → ``bn``, ``Dense_0`` → ``linear``, ``ConvTranspose_0`` →
``deconv``). Tensor rules:

* Dense kernel ``[in, out]`` → Linear weight ``[out, in]`` (transpose).
* Conv kernel HWIO → OIHW; a 3D sparse conv's kernel ``[k^3, Cin, Cout]``
  stays as it is.
* Transposed-conv kernel ``K [s, s, cin, cout]`` (the JAX deconv flips it
  spatially, as ``nn.ConvTranspose`` does) → ``W [cin, cout, s, s]`` with
  ``W[c, o, i, j] = K[s-1-i, s-1-j, c, o]``: flip both spatial axes, then
  move them last.
* BN ``scale``/``bias``/``mean``/``var`` → ``weight``/``bias``/
  ``running_mean``/``running_var``; a flax ``LayerNorm_i``'s ``scale`` →
  ``weight``.
* Encoder layers: the fused self-attention ``qk_kernel [C, 2C]`` splits into
  ``q`` (first C columns) and ``k`` (last C), as ``models/sst.py`` of the JAX
  package splits it; ``*_kernel``/``*_bias`` → ``*.weight``/``*.bias``,
  ``ln*_scale`` → ``ln*.weight``, ``tau`` stays.

Every rule is linear (a transpose, a split, a flip), so a tree with the
params' structure that holds gradients or optimizer moments converts with
the same rules: :func:`tree_from_jax`.
"""

from __future__ import annotations

import numpy as np
import torch

_MODULE_RENAME = {
    'Conv_0': 'conv',
    'MaskedBatchNorm_0': 'bn',
    'BatchNorm2d_0': 'bn',
    'Dense_0': 'linear',
    'ConvTranspose_0': 'deconv',
}
_BN_LEAF = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
            'var': 'running_var'}
# batch norms by owner: flax's auto-named ones, the named masked BN of a
# half-width stage (SSTBlock.conv_down_bn) and GraphRCNN's ShortcutLayer's
_BN_OWNERS = ('MaskedBatchNorm_0', 'BatchNorm_0', 'conv_down_bn', 'norm1',
              'norm2')
_LAYER_LINEAR = ('q', 'k', 'v', 'out', 'ffn1', 'ffn2')


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _module_path(parts):
    out = []
    for i, p in enumerate(parts):
        if p == 'BatchNorm_0' and i and parts[i - 1] in ('BatchNorm2d_0',
                                                        'shared_bn'):
            continue  # flax nn.BatchNorm nested inside the BN wrapper
        out.append(_MODULE_RENAME.get(p, p))
    return out


def _convert(parts, a):
    """One flax leaf → [(torch key parts, array)]."""
    *mods, leaf = parts
    owner = parts[-2] if len(parts) > 1 else ''
    path = _module_path(mods)
    if leaf == 'qk_kernel':
        C = a.shape[0]
        return [(path + ['q', 'weight'], a[:, :C].T),
                (path + ['k', 'weight'], a[:, C:].T)]
    if leaf == 'qk_bias':
        C = a.shape[0] // 2
        return [(path + ['q', 'bias'], a[:C]), (path + ['k', 'bias'], a[C:])]
    for name in _LAYER_LINEAR:
        if leaf == f'{name}_kernel':
            return [(path + [name, 'weight'], a.T)]
        if leaf == f'{name}_bias':
            return [(path + [name, 'bias'], a)]
    if leaf in ('ln1_scale', 'ln2_scale'):
        return [(path + [leaf[:3], 'weight'], a)]
    if leaf in ('ln1_bias', 'ln2_bias'):
        return [(path + [leaf[:3], 'bias'], a)]
    if leaf == 'tau':
        return [(path + ['tau'], a)]
    if leaf == 'kernel':
        if owner == 'ConvTranspose_0':
            return [(path + ['weight'],
                     a[::-1, ::-1].transpose(2, 3, 0, 1))]
        if a.ndim == 4:
            return [(path + ['weight'], a.transpose(3, 2, 0, 1))]
        if a.ndim == 3:  # a 3D sparse conv's [k^3, Cin, Cout], kept
            return [(path + ['weight'], a)]
        return [(path + ['weight'], a.T)]
    if owner.startswith('LayerNorm_') and leaf == 'scale':
        return [(path + ['weight'], a)]
    if owner in _BN_OWNERS and leaf in _BN_LEAF:
        return [(path + [_BN_LEAF[leaf]], a)]
    if leaf == 'bias':
        return [(path + ['bias'], a)]
    raise KeyError(f'no rule for flax leaf {"/".join(parts)}')


def params_from_jax(variables) -> dict:
    """``variables``: ``{'params': ..., 'batch_stats': ...}`` nested dicts
    of numpy arrays from the JAX package. Returns a ``state_dict`` for
    :class:`tmae_tpu_torch.models.detectors.CenterPoint` (or for the module
    whose flax sub-tree is given)."""
    out = {}
    for col in ('params', 'batch_stats'):
        for parts, a in _flatten(variables.get(col, {})):
            for key, arr in _convert(list(parts), a):
                out['.'.join(key)] = torch.from_numpy(
                    np.array(arr, dtype=np.float32, order='C', copy=True))
    return out


def tree_from_jax(tree) -> dict:
    """A tree with the structure of ``params`` (gradients, Adam moments) →
    the same keys as the ``state_dict``'s parameters."""
    return params_from_jax({'params': tree})
