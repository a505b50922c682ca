"""Reference checkpoints into the port (counterpart of
``tmae_tpu/utils/torch_convert.py`` and ``utils/from_jax.py`` together): a
state dict of the reference T-MAE / CenterPoint implementation (flat
``a.b.c`` names, e.g. ``vfe.dvfe_mlps.0.0.weight``,
``*.win_attn.self_attn.in_proj_weight``) → this package's ``state_dict``
and the reference keys that no rule takes.

The names go through the JAX package's module tree, whose names this
package keeps: the reference name map of the JAX converter (copied here:
VFE MLPs, SST blocks' conv_down / encoder layers / conv_out, WCA blocks,
deblocks and fusion conv, the MAE decoder, the BEV backbone, the
CenterHead), then the layout rules of :mod:`.from_jax`. Layouts on the way:

* Linear ``[out, in]``, Conv2d OIHW, spconv 2.x ``[out, kh, kw, in]`` (or
  1.x ``[kh, kw, in, out]``), ConvTranspose2d ``[in, out, kh, kw]`` (with
  the spatial flip of the JAX convention, undone by ``from_jax``);
* BatchNorm weight / bias / running statistics;
* MultiheadAttention's packed ``in_proj [3C, C]`` → q, k, v;
* the cosine attention's tau ``[1, 1, 1]`` → ``[1]``.

Callers load the state dict with ``torch.load``.
"""

from __future__ import annotations

import numpy as np
import torch

from .from_jax import params_from_jax


def linear(w, b=None):
    out = {'kernel': np.asarray(w).T}
    if b is not None:
        out['bias'] = np.asarray(b)
    return out


def conv2d(w, b=None):
    out = {'kernel': np.transpose(np.asarray(w), (2, 3, 1, 0))}  # OIHW → HWIO
    if b is not None:
        out['bias'] = np.asarray(b)
    return out


def conv_transpose2d(w, b=None):
    # torch [in, out, kh, kw] → flax [kh, kw, in, out]; flax.ConvTranspose applies
    # the kernel unflipped (it is the transpose of a correlation), while torch's
    # ConvTranspose2d scatters the kernel as stored — equivalence requires a
    # spatial flip.
    k = np.transpose(np.asarray(w), (2, 3, 0, 1))[::-1, ::-1]
    out = {'kernel': np.ascontiguousarray(k)}
    if b is not None:
        out['bias'] = np.asarray(b)
    return out


def batchnorm(weight, bias, running_mean, running_var):
    return (
        {'scale': np.asarray(weight), 'bias': np.asarray(bias)},
        {'mean': np.asarray(running_mean), 'var': np.asarray(running_var)},
    )


def mha_in_proj(in_proj_weight, in_proj_bias=None):
    """Packed torch MHA in_proj → q/k/v Dense params."""
    w = np.asarray(in_proj_weight)
    C = w.shape[0] // 3
    outs = {}
    for i, name in enumerate(('q_proj', 'k_proj', 'v_proj')):
        outs[name] = {'kernel': w[i * C:(i + 1) * C].T}
        if in_proj_bias is not None:
            outs[name]['bias'] = np.asarray(in_proj_bias)[i * C:(i + 1) * C]
    return outs


def tau(t):
    return np.asarray(t).reshape(-1)[:1]


def _set(tree, path, value):
    d = tree
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


def _flax_trees(sd: dict) -> tuple:
    """A reference state dict → (params, batch_stats) in the JAX package's
    flax layout, and the keys no rule took."""
    params: dict = {}
    stats: dict = {}
    unmatched = []

    def get(name):
        return np.asarray(sd[name])

    def bn_at(prefix_t, path, nested=False):
        # nested=True → the BatchNorm2d wrapper (inner flax BatchNorm scope);
        # nested=False → MaskedBatchNorm (flat scale/bias at module level)
        p, s = batchnorm(get(prefix_t + '.weight'), get(prefix_t + '.bias'),
                         get(prefix_t + '.running_mean'),
                         get(prefix_t + '.running_var'))
        if nested:
            path = path + ['BatchNorm_0']
        _set(params, path, p)
        _set(stats, path, s)

    def encoder_layer(tsrc, path, cross):
        """torch EncoderLayer → the fused DenseEncoderLayer's flat params."""
        attn = 'cross_attn' if cross else 'self_attn'
        proj = mha_in_proj(get(f'{tsrc}.win_attn.{attn}.in_proj_weight'),
                           sd.get(f'{tsrc}.win_attn.{attn}.in_proj_bias'))
        base = path
        if cross:
            _set(params, base + ['q_kernel'], proj['q_proj']['kernel'])
            _set(params, base + ['k_kernel'], proj['k_proj']['kernel'])
            if 'bias' in proj['q_proj']:
                _set(params, base + ['q_bias'], proj['q_proj']['bias'])
                _set(params, base + ['k_bias'], proj['k_proj']['bias'])
        else:
            # dense self-attn path fuses q/k into one [C, 2C] projection
            _set(params, base + ['qk_kernel'], np.concatenate(
                [proj['q_proj']['kernel'], proj['k_proj']['kernel']], axis=1))
            if 'bias' in proj['q_proj']:
                _set(params, base + ['qk_bias'], np.concatenate(
                    [proj['q_proj']['bias'], proj['k_proj']['bias']]))
        _set(params, base + ['v_kernel'], proj['v_proj']['kernel'])
        if 'bias' in proj['v_proj']:
            _set(params, base + ['v_bias'], proj['v_proj']['bias'])
        out_lin = linear(get(f'{tsrc}.win_attn.{attn}.out_proj.weight'),
                         get(f'{tsrc}.win_attn.{attn}.out_proj.bias'))
        _set(params, base + ['out_kernel'], out_lin['kernel'])
        _set(params, base + ['out_bias'], out_lin['bias'])
        if f'{tsrc}.win_attn.{attn}.tau' in sd:
            _set(params, base + ['tau'], tau(get(f'{tsrc}.win_attn.{attn}.tau')))
        f1 = linear(get(f'{tsrc}.linear1.weight'), get(f'{tsrc}.linear1.bias'))
        f2 = linear(get(f'{tsrc}.linear2.weight'), get(f'{tsrc}.linear2.bias'))
        _set(params, base + ['ffn1_kernel'], f1['kernel'])
        _set(params, base + ['ffn1_bias'], f1['bias'])
        _set(params, base + ['ffn2_kernel'], f2['kernel'])
        _set(params, base + ['ffn2_bias'], f2['bias'])
        _set(params, base + ['ln1_scale'], get(f'{tsrc}.norm1.weight'))
        _set(params, base + ['ln1_bias'], get(f'{tsrc}.norm1.bias'))
        _set(params, base + ['ln2_scale'], get(f'{tsrc}.norm2.weight'))
        _set(params, base + ['ln2_bias'], get(f'{tsrc}.norm2.bias'))

    keys = list(sd.keys())
    consumed = set()

    def mark(prefix):
        for k in keys:
            if k.startswith(prefix):
                consumed.add(k)

    # --- VFE ---
    for k in keys:
        if k.startswith('vfe.dvfe_mlps.'):
            consumed.add(k)
    mi = 0
    while f'vfe.dvfe_mlps.{mi}.0.weight' in sd:
        # Sequential: [Linear, BN, ReLU] * len(widths)
        li = 0
        widths = []
        while f'vfe.dvfe_mlps.{mi}.{li}.weight' in sd:
            w = get(f'vfe.dvfe_mlps.{mi}.{li}.weight')
            widths.append(w.shape[0])
            base = ['vfe', 'encoder', f'mlp{mi}_{w.shape[0]}']
            _set(params, base + ['Dense_0'], linear(w))
            bn_at(f'vfe.dvfe_mlps.{mi}.{li + 1}',
                  base + ['MaskedBatchNorm_0'])
            li += 3
        mi += 1

    # --- backbone_3d ---
    def sst_block(tsrc, path, has_down):
        if has_down and f'{tsrc}.conv_down.0.weight' in sd:
            w = get(f'{tsrc}.conv_down.0.weight')  # spconv KKIO or OIKK?
            _set(params, path + ['conv_down', 'Conv_0'], spconv2d(w))
            bn_at(f'{tsrc}.conv_down.1', path + ['conv_down', 'MaskedBatchNorm_0'])
        bi = 0
        while f'{tsrc}.encoder_blocks.{bi}.encoder_list.0.linear1.weight' in sd:
            for li in range(2):
                encoder_layer(
                    f'{tsrc}.encoder_blocks.{bi}.encoder_list.{li}',
                    path + [f'encoder_{bi}', f'EncoderLayer_{li}'], cross=False,
                )
            bi += 1
        if f'{tsrc}.conv_out.0.weight' in sd:
            _set(params, path + ['conv_out', 'Conv_0'],
                 spconv2d(get(f'{tsrc}.conv_out.0.weight')))
            bn_at(f'{tsrc}.conv_out.1', path + ['conv_out', 'MaskedBatchNorm_0'])
        mark(tsrc + '.')

    def wca_block(tsrc, path):
        for li in range(2):
            encoder_layer(
                f'{tsrc}.encoder_blocks.0.encoder_list.{li}',
                path + ['block_0', f'EncoderLayer_{li}'], cross=True,
            )
        if f'{tsrc}.conv_out.0.weight' in sd:
            _set(params, path + ['conv_out', 'Conv_0'],
                 spconv2d(get(f'{tsrc}.conv_out.0.weight')))
            bn_at(f'{tsrc}.conv_out.1', path + ['conv_out', 'MaskedBatchNorm_0'])
        mark(tsrc + '.')

    i = 0
    while f'backbone_3d.sst_blocks.{i}.conv_out.0.weight' in sd:
        sst_block(f'backbone_3d.sst_blocks.{i}',
                  ['backbone_3d', 'encoder', f'sst_block_{i}'], has_down=True)
        i += 1
    i = 0
    while f'backbone_3d.wca_blocks.{i}.conv_out.0.weight' in sd:
        wca_block(f'backbone_3d.wca_blocks.{i}',
                  ['backbone_3d', 'encoder', f'wca_block_{i}'])
        i += 1
    # deblocks + fusion conv (finetune: 'fuse'; MAE decoder: 'decoder_fuse')
    fuse_name = ('decoder_fuse'
                 if 'backbone_3d.decoder_deblocks.0.0.weight' in sd else 'fuse')
    tprefix = ('backbone_3d.decoder_deblocks'
               if fuse_name == 'decoder_fuse' else 'backbone_3d.deblocks')
    i = 0
    while f'{tprefix}.{i}.0.weight' in sd:
        _set(params, ['backbone_3d', fuse_name, f'deblock_{i}', 'ConvTranspose_0'],
             conv_transpose2d(get(f'{tprefix}.{i}.0.weight')))
        bn_at(f'{tprefix}.{i}.1',
              ['backbone_3d', fuse_name, f'deblock_{i}', 'BatchNorm2d_0'],
              nested=True)
        mark(f'{tprefix}.{i}.')
        i += 1
    cname = ('backbone_3d.decoder_conv_out'
             if fuse_name == 'decoder_fuse' else 'backbone_3d.conv_out')
    if f'{cname}.0.weight' in sd:
        _set(params, ['backbone_3d', fuse_name, 'conv_out', 'Conv_0'],
             conv2d(get(f'{cname}.0.weight')))
        bn_at(f'{cname}.1',
              ['backbone_3d', fuse_name, 'conv_out', 'BatchNorm2d_0'],
              nested=True)
        mark(cname + '.')
    if 'backbone_3d.decoder_pred.weight' in sd:
        _set(params, ['backbone_3d', 'decoder_pred'],
             linear(get('backbone_3d.decoder_pred.weight'),
                    get('backbone_3d.decoder_pred.bias')))
        mark('backbone_3d.decoder_pred.')

    # --- backbone_2d (SSTBEVBackbone.conv_layer ModuleList) ---
    i = 0
    while f'backbone_2d.conv_layer.{i}.0.weight' in sd:
        _set(params, ['backbone_2d', f'conv_{i}', 'Conv_0'],
             conv2d(get(f'backbone_2d.conv_layer.{i}.0.weight')))
        bn_at(f'backbone_2d.conv_layer.{i}.1',
              ['backbone_2d', f'conv_{i}', 'BatchNorm2d_0'], nested=True)
        mark(f'backbone_2d.conv_layer.{i}.')
        i += 1

    # --- dense_head ---
    if 'dense_head.shared_conv.0.weight' in sd:
        _set(params, ['dense_head', 'shared_conv'],
             conv2d(get('dense_head.shared_conv.0.weight'),
                    sd.get('dense_head.shared_conv.0.bias')))
        bn_at('dense_head.shared_conv.1', ['dense_head', 'shared_bn'],
              nested=True)
        mark('dense_head.shared_conv.')
    hi = 0
    while any(k.startswith(f'dense_head.heads_list.{hi}.') for k in keys):
        for head in ('center', 'center_z', 'dim', 'rot', 'hm', 'iou', 'vel'):
            base_t = f'dense_head.heads_list.{hi}.{head}'
            if f'{base_t}.0.0.weight' not in sd:
                continue
            k = 0
            while f'{base_t}.{k}.0.weight' in sd:
                _set(params,
                     ['dense_head', f'head_{hi}', f'{head}_conv{k}', 'Conv_0'],
                     conv2d(get(f'{base_t}.{k}.0.weight'),
                            sd.get(f'{base_t}.{k}.0.bias')))
                bn_at(f'{base_t}.{k}.1',
                      ['dense_head', f'head_{hi}', f'{head}_conv{k}',
                       'BatchNorm2d_0'], nested=True)
                k += 1
            _set(params, ['dense_head', f'head_{hi}', f'{head}_out'],
                 conv2d(get(f'{base_t}.{k}.weight'), get(f'{base_t}.{k}.bias')))
            mark(base_t + '.')
        hi += 1

    unmatched = [k for k in keys if k not in consumed
                 and not k.startswith('vfe.dvfe_mlps.')
                 and 'num_batches_tracked' not in k]
    return params, stats, unmatched


def spconv2d(w):
    """spconv 2.x SubM/SparseConv2d weight [out, kh, kw, in] (or 1.x
    [kh, kw, in, out]) → flax HWIO [kh, kw, in, out]."""
    w = np.asarray(w)
    if w.ndim != 4:
        raise ValueError(f'unexpected spconv weight shape {w.shape}')
    # spconv 2.x: (out, kh, kw, in); spconv 1.x already (kh, kw, in, out)
    if w.shape[1] == w.shape[2]:  # (O, K, K, I)
        return {'kernel': np.transpose(w, (1, 2, 3, 0))}
    return {'kernel': w}


def convert_state_dict(sd: dict) -> tuple:
    """Reference state dict (name → array or tensor) → (this package's
    ``state_dict`` of the modules it names, the reference keys that no rule
    took; ``num_batches_tracked`` is not reported)."""
    def as_array(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            return (v.float() if v.is_floating_point() else v).numpy()
        return np.asarray(v)

    sd = {k: as_array(v) for k, v in sd.items()}
    params, stats, unmatched = _flax_trees(sd)
    return params_from_jax({'params': params, 'batch_stats': stats}), \
        unmatched
