"""Config refusals of the PyTorch port that match the JAX package, and the
premise of the training backward's window skip, on the CPU.

* ``MODEL.BACKBONE_3D.ASYMMETRIC.ENABLED`` (alone or with ``SimSiam``) is
  refused: the port encodes both frames in one pass, where JAX encodes them
  in separate passes.
* A ``PREPROCESS.DROP_INFO.train`` maximum other than window² is refused,
  as JAX's ``SSTBlock`` refuses it on the same config; every shipped
  ``t_mae*.yaml`` still builds.
* K7 / K9 (``encoder_layer_bwd``) do no work for a window whose cotangent
  is 0 on its query cells: the plain version over all windows equals its
  sum over the other windows (dx on a skipped window is g for the packed
  layer and 0 for the full one), and on the training path every cotangent
  that reaches the layer is exactly 0 on a bucket's padding slots.
"""

import copy
import glob
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_port_train import _train_cfg_and_batch
from tests.tiny_cfg import synth_batch, tiny_cfg
from tmae_tpu.models import detectors as jdet
from tmae_tpu_torch.config import cfg_from_yaml_file
from tmae_tpu_torch.models import detectors as tdet
from tmae_tpu_torch.ops import encoder_layer as el
from tmae_tpu_torch.ops.encoder_layer import (LayerParams,
                                              reference_encoder_layer_bwd)
from tmae_tpu_torch.train.optimization import build_optimizer
from tmae_tpu_torch.train.trainer import make_train_step

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize('asym', [{'ENABLED': True},
                                  {'ENABLED': True, 'SimSiam': True}],
                         ids=['enabled', 'simsiam'])
def test_asymmetric_encoder_refused(asym):
    cfg = copy.deepcopy(tiny_cfg())
    cfg.MODEL.BACKBONE_3D['ASYMMETRIC'] = asym
    with pytest.raises(NotImplementedError, match='ASYMMETRIC'):
        tdet.build_detector(cfg, 'cpu')
    cfg.MODEL.BACKBONE_3D['ASYMMETRIC'] = {**asym, 'ENABLED': False}
    tdet.build_detector(cfg, 'cpu')


def test_max_tokens_below_window_area_refused_as_jax():
    """A stage whose DROP_INFO.train maximum is 32 (not 8 x 8): JAX's
    SSTBlock raises while the model is traced, the port while it is
    built."""
    cfg = copy.deepcopy(tiny_cfg())
    drop = cfg.MODEL.BACKBONE_3D.SST_BLOCK_LIST[1]['PREPROCESS']['DROP_INFO']
    drop['train'] = {k: v for k, v in drop['train'].items()
                     if int(v['max_tokens']) <= 32}
    batch = synth_batch(np.random.RandomState(0))
    jmodel = jdet.build_detector(cfg)
    with pytest.raises(NotImplementedError, match='max_tokens'):
        jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b,
                                             train=False), batch)
    with pytest.raises(NotImplementedError, match='max_tokens'):
        tdet.build_detector(cfg, 'cpu')


@pytest.mark.parametrize('path', sorted(
    str(Path(p).relative_to(ROOT))
    for p in glob.glob(str(ROOT / 'tools/cfgs/*/t_mae*.yaml'))))
def test_shipped_tmae_configs_build(path):
    cfg = cfg_from_yaml_file(ROOT / path)
    for blk in cfg.MODEL.BACKBONE_3D.SST_BLOCK_LIST:
        drop = blk['PREPROCESS']['DROP_INFO']['train']
        assert max(int(v['max_tokens']) for v in drop.values()) == 64
    tdet.build_detector(cfg, 'cpu')


# ---------------------------------------------------------------------------
# the window skip of K7 / K9: its premise on the plain version
# ---------------------------------------------------------------------------

C, F, H = 64, 128, 4


def _layer_case(seed, N, S, cross):
    """Windows with zeros at unoccupied cells, every fifth with no query
    cell, occupied-first cell selections (S) and seeded weights in the
    port's layout ``[out, in]``."""
    rng = np.random.RandomState(seed)
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16)
    occ = rng.rand(N, 64) < rng.uniform(0.1, 0.6, (N, 1))
    occ[::5] = False
    kocc = rng.rand(N, 64) < 0.3
    xw = bf(np.where(occ[..., None], rng.normal(0, 1, (N, 64, C)), 0))
    kv = bf(np.where(kocc[..., None], rng.normal(0, 1, (N, 64, C)), 0))
    lin = lambda o, i: (rng.normal(0, 1, (o, i)) / np.sqrt(i)).astype(
        np.float32)
    vec = lambda n, m=0.0: (m + 0.1 * rng.normal(size=(n,))).astype(
        np.float32)
    w = [lin(C, C), vec(C), lin(C, C), vec(C), lin(C, C), vec(C), lin(C, C),
         vec(C), np.asarray([0.3], np.float32), vec(C, 1.0), vec(C),
         lin(F, C), vec(F), lin(C, F), vec(C), vec(C, 1.0), vec(C)]
    weights = [torch.from_numpy(a) for a in w]
    pos = bf(rng.normal(0, 0.5, (64, C)))
    if S is None:
        sq = sk = None
        qm, km = occ, kocc
    else:
        def select(o):
            s = np.argsort(-(o * (64 - np.arange(64))), -1, kind='stable')
            s = s[:, :S].astype(np.int32)
            return torch.from_numpy(s), np.take_along_axis(o, s, -1)

        sq, qm = select(occ)
        sk, km = select(kocc)
    qm = torch.from_numpy(qm.astype(np.float32))
    km = torch.from_numpy(km.astype(np.float32))
    g = bf(rng.normal(0, 1, (N, 64, C)))
    return (xw, kv if cross else None, sq, sk if cross else None, qm,
            km if cross else None, pos), weights, g


def _query_cells(sq, qm):
    """[N, 64] bool: the cells whose cotangent the layer reads."""
    cells = torch.zeros(qm.shape[0], 64, dtype=torch.bool)
    if sq is None:
        return qm > 0
    return cells.scatter(1, sq.long(), qm > 0)


@pytest.mark.parametrize('S', [None, 16, 48], ids=['T64', 'S16', 'S48'])
@pytest.mark.parametrize('cross', [False, True], ids=['self', 'cross'])
def test_backward_adds_nothing_for_windows_with_zero_cotangent(S, cross):
    """Windows 1, 4, 6, 7 get a cotangent that is 0 on their query cells
    (random elsewhere). The plain backward over all 12 windows against the
    same over the 8 live windows alone: dx and dkv equal on the live
    windows to 1e-5 of their scale (f32 summation order), dx on a skipped
    window is g bit for bit (packed layer) or 0 (full layer), dkv there 0,
    the 17 parameter gradients (dtau too) and dpos equal to 1e-5 of their
    largest magnitude."""
    N = 12
    args, weights, g = _layer_case(3 + (S or 0) + int(cross), N, S, cross)
    xw, kv, sq, sk, qm, km, pos = args
    dead = torch.tensor([1, 4, 6, 7])
    live = torch.tensor([n for n in range(N) if n not in dead.tolist()])
    q = _query_cells(sq, qm)
    assert q[dead].any(), 'the skipped windows must have query cells'
    g = g.clone()
    g[dead] = torch.where(q[dead][..., None], 0.0,
                          g[dead].float()).to(g.dtype)
    kw = dict(nhead=H, tau_min=0.05, cross=cross, want_dpos=S is None)
    dx, dkv, grads, dpos = reference_encoder_layer_bwd(*args, weights, g,
                                                       **kw)
    sub = lambda t: None if t is None else t[live]
    sx, skv, sgrads, sdpos = reference_encoder_layer_bwd(
        *[sub(t) for t in args[:6]], pos, weights, g[live], **kw)

    def close(a, b, what):
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 1e-5 * scale, what

    close(dx[live], sx, 'dx')
    if S is None:
        assert not dx[dead].any()
    else:
        assert torch.equal(dx[dead], g[dead].float())
    if cross:
        close(dkv[live], skv, 'dkv')
        assert not dkv[dead].any()
    for name, a, b in zip(LayerParams._fields, grads, sgrads):
        assert b.abs().max() > 0, name
        close(a, b, name)
    if S is None:
        close(dpos, sdpos, 'dpos')


def test_training_cotangent_is_zero_on_padding_slots():
    """One adam_onecycle step of the tiny config with bucket caps on the
    CPU: every cotangent that reaches the fused layer's backward is exactly
    0 on the bucket's padding slots (the windows with no query cell), so
    the kernel's skip covers them."""
    cfg, batch = _train_cfg_and_batch()
    model = tdet.init_random_(tdet.build_detector(cfg, 'cpu'), seed=0)
    seen = []
    real = el._FusedEncoderLayer

    class Capture(real):
        @staticmethod
        def forward(ctx, *args):
            ctx.qmask = args[4].detach().clone()
            return real.forward(ctx, *args)

        @staticmethod
        def backward(ctx, g):
            seen.append((g.detach().clone(), ctx.qmask))
            return real.backward(ctx, g)

    opt, sched = build_optimizer(model.parameters(), cfg.OPTIMIZATION, 10)
    step = make_train_step(model, lambda o, b: tdet.centerpoint_loss(
        cfg, o, b), opt, sched)
    el._FusedEncoderLayer = Capture
    try:
        step(tdet.batch_to_device(batch, 'cpu'))
    finally:
        el._FusedEncoderLayer = real
    assert len(seen) >= 18
    padding = 0
    for g, qmask in seen:
        pad = ~(qmask > 0).any(-1)
        padding += int(pad.sum())
        assert not g[pad].any()
    assert padding > 0, 'no bucket had a padding slot'
