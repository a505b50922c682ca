"""The port's training workflow against the JAX package's on the CPU.

* ``create_once_infos``: on the raw-ONCE fixture (6 frames), the port's
  ``once_infos_{train,val}.pkl``, ``once_dbinfos_train.pkl`` and every
  ``gt_database_train/*.bin`` equal the JAX tool's, byte for byte.
* ``adam`` and ``sgd``: ``decay_step_schedule`` equals JAX's (f32) at every
  step of a 3-epoch run, with and without warmup, to f32 rounding; three
  updates of ``build_optimizer`` on equal gradients equal the optax chain
  of JAX's ``build_optimizer`` to 1e-6, with the clip active.
* ``load_pretrained_params`` from the tiny TMAE into the tiny CenterPoint:
  the entries it copies are exactly the leaves JAX's transfers (mapped by
  ``params_from_jax``), and the merged ``state_dict`` equals JAX's merged
  tree's, value for value.
* Checkpoint retention keeps the newest ``max_keep`` by step.
* The reference-checkpoint converter on ``make_reference_state_dict``: the
  same ``state_dict`` as ``params_from_jax`` of JAX's ``convert_state_dict``
  and the same unmatched keys; a strict load into the tiny detector; the
  CLI's file read by ``restore_checkpoint``. (The head maps on the
  converted weights are held against JAX's in
  ``tests/test_torch_port_model.py``, beside the compiled JAX forward.)
* The training CLI on the tiny config over the fixture, ``--device cpu``:
  two epochs write ``metrics.jsonl`` and prune ``ckpt/`` to
  ``--max_ckpt_save_num``; a run stopped after epoch 1 and started again
  resumes at its step with the schedule's lr and ends with the weights and
  optimizer state of the uninterrupted run, bit for bit (pretraining, with
  the MAE mask drawn per step, and finetuning; no random augmentation, no
  point shuffle, a fixed previous-frame gap); the refusals.
"""

import copy
import json
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util as tu

from tests.once_fixture import make_raw_once
from tests.test_convert_mapping import make_reference_state_dict
from tests.test_torch_port_model import random_variables
from tests.tiny_cfg import tiny_cfg, synth_batch
from tests.torch_dist_ranks import TORCHRUN_VARS, free_port, torchrun_env
from tmae_tpu.models import detectors as jdet
from tmae_tpu.train import checkpoint as jckpt
from tmae_tpu.train import optimization as jopt
from tmae_tpu.utils.torch_convert import convert_state_dict as j_convert
from tmae_tpu_torch.models import detectors as tdet
from tmae_tpu_torch.tools import convert_torch_ckpt as convert_cli
from tmae_tpu_torch.tools import create_once_infos as t_coi
from tmae_tpu_torch.tools import train as train_cli
from tmae_tpu_torch.train.checkpoint import (latest_checkpoint,
                                             load_pretrained_params,
                                             restore_checkpoint,
                                             save_checkpoint)
from tmae_tpu_torch.train.optimization import (build_optimizer,
                                               decay_step_schedule)
from tmae_tpu_torch.utils.from_jax import params_from_jax
from tmae_tpu_torch.utils.metrics import MetricsLogger
from tmae_tpu_torch.utils.torch_convert import convert_state_dict

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / 'tools'))


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run shares the CPU among its
    workers, and a step of the tiny model gains nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_create_once_infos_equal_jax_bytes(tmp_path):
    import create_once_infos as j_coi

    jroot = make_raw_once(tmp_path / 'jax', n_frames=6)
    troot = make_raw_once(tmp_path / 'torch', n_frames=6)
    for split in ('train', 'val'):
        infos = j_coi.create_infos(jroot, split)
    j_coi.create_gt_database(jroot, infos, 'train')
    t_coi.main(['--data_path', str(troot), '--splits', 'train', 'val'])
    names = ['once_infos_train.pkl', 'once_infos_val.pkl',
             'once_dbinfos_train.pkl']
    bins = sorted(p.name for p in (jroot / 'gt_database_train').iterdir())
    assert len(bins) == 6
    assert sorted(p.name for p in (troot / 'gt_database_train')
                  .iterdir()) == bins
    for name in names + [f'gt_database_train/{b}' for b in bins]:
        assert (troot / name).read_bytes() == (jroot / name).read_bytes(), \
            name
    infos = pickle.loads((troot / 'once_infos_train.pkl').read_bytes())
    assert all(i['annos']['num_points_in_gt'][0] >= 30 for i in infos)


OPTIM = {'LR': 0.003, 'WEIGHT_DECAY': 0.01, 'MOMENTUM': 0.9,
         'DECAY_STEP_LIST': [1, 2], 'LR_DECAY': 0.1, 'LR_CLIP': 5e-5,
         'WARMUP_EPOCH': 1, 'GRAD_NORM_CLIP': 10, 'NUM_EPOCHS': 3}


@pytest.mark.parametrize('warmup', [False, True], ids=['plain', 'warmup'])
def test_decay_step_schedule_matches_jax(warmup):
    """Every step of a 3-epoch run of 4 steps an epoch and one past it: the
    decays at epochs 1 and 2, LR_CLIP binding after the second, the warmup
    over epoch 0 (its floor of 1e-3 at step 0); JAX computes in f32."""
    args = (4, OPTIM['LR'], OPTIM['DECAY_STEP_LIST'], OPTIM['LR_DECAY'],
            OPTIM['LR_CLIP'], OPTIM['WARMUP_EPOCH'], warmup)
    lr, jlr = decay_step_schedule(*args), jopt.decay_step_schedule(*args)
    for step in range(13):
        np.testing.assert_allclose(lr(step), float(jlr(step)), rtol=1e-6,
                                   atol=0)
    assert lr(12) == OPTIM['LR_CLIP']
    assert lr(0) == pytest.approx(OPTIM['LR'] * (1e-3 if warmup else 1))


@pytest.mark.parametrize('warmup', [False, True], ids=['plain', 'warmup'])
@pytest.mark.parametrize('name', ['adam', 'sgd'])
def test_adam_sgd_match_optax_on_equal_gradients(name, warmup):
    """Three updates from equal parameters on equal gradients (the clip
    active on the second): ``build_optimizer`` (AdamW / SGD with the lr set
    per step, global-norm clipping first) against the optax chain of JAX's
    ``build_optimizer``, within 1e-6."""
    cfg = dict(OPTIM, OPTIMIZER=name, LR_WARMUP=warmup)
    rng = np.random.RandomState(5)
    shapes = {'a': (5, 3), 'b': (7,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * (0.5 + 8 * (i == 1))).astype(
        np.float32) for k, s in shapes.items()} for i in range(3)]
    tx, _ = jopt.build_optimizer(cfg, 2)
    jp = {k: jnp.asarray(a) for k, a in params.items()}
    js = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(a.copy()))
          for k, a in params.items()}
    opt, sched = build_optimizer(list(tp.values()), cfg, 2)
    assert sched.beta1 is None
    assert isinstance(opt, torch.optim.AdamW if name == 'adam'
                      else torch.optim.SGD)
    for i, g in enumerate(grads):
        up, js = tx.update({k: jnp.asarray(a) for k, a in g.items()}, js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, up)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        torch.nn.utils.clip_grad_norm_(list(tp.values()), sched.grad_clip)
        for group in opt.param_groups:
            group['lr'] = sched.lr(i)
        opt.step()
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), atol=1e-6, rtol=0)


def test_unknown_optimizer_refused():
    with pytest.raises(NotImplementedError, match='lamb'):
        build_optimizer([torch.nn.Parameter(torch.zeros(1))],
                        dict(OPTIM, OPTIMIZER='lamb'), 2)


def _jax_shapes(cfg):
    model = jdet.build_detector(cfg)
    rngs = {'params': jax.random.PRNGKey(0)}
    if cfg.MODEL.NAME == 'TMAE':
        rngs['mae_mask'] = jax.random.PRNGKey(1)
    return jax.eval_shape(lambda b: model.init(rngs, b, train=False),
                          synth_batch(np.random.RandomState(0)))


def test_load_pretrained_params_matches_jax(tmp_path):
    """Tiny TMAE → tiny CenterPoint, each side from the same random
    weights: JAX's ``load_pretrained_params`` on an orbax checkpoint of the
    TMAE's variables, the port's on a ``save_checkpoint`` of the same
    weights. The copied names are ``params_from_jax``'s names of the leaves
    JAX replaced; every entry of the merged model equals JAX's merged
    tree."""
    import orbax.checkpoint as ocp

    vm = random_variables(_jax_shapes(tiny_cfg(mae=True)), 1)
    vc = random_variables(_jax_shapes(tiny_cfg()), 2)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save((tmp_path / 'jax').resolve(), vm)
    ckptr.wait_until_finished()
    jparams, jstats = jckpt.load_pretrained_params(
        tmp_path / 'jax', vc['params'], vc['batch_stats'])

    mae = tdet.build_detector(tiny_cfg(mae=True), 'cpu')
    mae.load_state_dict(params_from_jax(vm), strict=True)
    path = save_checkpoint(tmp_path / 'torch', mae, None, 0)
    model = tdet.build_detector(tiny_cfg(), 'cpu')
    model.load_state_dict(params_from_jax(vc), strict=True)
    copied, kept = load_pretrained_params(path, model)

    replaced = {}
    for col, tree in (('params', jparams), ('batch_stats', jstats)):
        init = tu.flatten_dict(vc[col])
        flat = {k: v for k, v in tu.flatten_dict(tree).items()
                if not np.array_equal(np.asarray(v), init[k])}
        replaced[col] = tu.unflatten_dict(flat)
    assert sorted(copied) == sorted(params_from_jax(replaced))
    assert 0 < len(copied) < len(model.state_dict())
    assert all(k.startswith(('vfe.', 'backbone_3d.')) for k in copied)
    assert all(k in kept for k in model.state_dict()
               if k.startswith(('dense_head.', 'backbone_2d.')))
    want = params_from_jax({'params': jparams, 'batch_stats': jstats})
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_init_training_is_flax_defaults():
    """The CLI's initial values: LeCun-normal kernels (standard deviation
    1 / sqrt(fan_in), fan_in over the input channels and the window, a
    normal cut at 2 and rescaled, as flax's), zero biases but the heatmap
    outputs' -2.19, unit norm scales and tau, BN statistics 0 / 1; the same
    seed gives the same model."""
    model = tdet.init_training_(tdet.build_detector(tiny_cfg(), 'cpu'), 3)
    sd = model.state_dict()
    w = sd['backbone_3d.fuse.conv_out.conv.weight']  # [16, 48, 3, 3]
    assert abs(float(w.std()) * np.sqrt(48 * 9) - 1) < 0.05
    # the cut is at 2 of the unit normal's, before flax rescales the cut
    # normal to its standard deviation (by 1 / 0.8796...)
    assert float(w.abs().max()) <= 2 / 0.87962566 / np.sqrt(48 * 9) + 1e-6
    d = sd['backbone_3d.fuse.deblock_2.deconv.weight']  # [32, 16, 4, 4]
    assert abs(float(d.std()) * np.sqrt(32 * 16) - 1) < 0.1
    for k, v in sd.items():
        leaf = k.rsplit('.', 1)[-1]
        if k == 'dense_head.head_0.hm_out.bias':
            assert torch.all(v == -2.19), k
        elif leaf in ('bias', 'running_mean'):
            assert torch.all(v == 0), k
        elif leaf in ('running_var', 'tau') or (leaf == 'weight'
                                                and v.dim() == 1):
            assert torch.all(v == 1), k
    again = tdet.init_training_(tdet.build_detector(tiny_cfg(), 'cpu'), 3)
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in sd.items())


def test_checkpoint_retention_keeps_newest(tmp_path):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    for step in (10, 2, 30, 4, 20):
        save_checkpoint(tmp_path, model, opt, step, max_keep=3)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        'checkpoint_10.pth', 'checkpoint_20.pth', 'checkpoint_30.pth']
    latest = latest_checkpoint(tmp_path)
    assert latest.name == 'checkpoint_30.pth'
    assert restore_checkpoint(latest, torch.nn.Linear(3, 2),
                              torch.optim.SGD(model.parameters(), lr=1)) == 30
    save_checkpoint(tmp_path, model, None, 40)  # no max_keep: nothing goes
    assert len(list(tmp_path.iterdir())) == 4


def test_converter_matches_jax_and_loads(tmp_path):
    """The tiny finetune model's reference-named state dict with one stray
    key and a ``num_batches_tracked``; the converted ``state_dict`` loads
    strictly, and the CLI's checkpoint restores to the same values."""
    sd = make_reference_state_dict(np.random.RandomState(0))
    sd['backbone_3d.extra.weight'] = np.ones(3, np.float32)
    sd['dense_head.shared_conv.1.num_batches_tracked'] = np.int64(7)
    jparams, jstats, junmatched = j_convert(copy.deepcopy(sd))
    want = params_from_jax({'params': jparams, 'batch_stats': jstats})
    got, unmatched = convert_state_dict(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    assert unmatched == junmatched == ['backbone_3d.extra.weight']
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    model = tdet.build_detector(tiny_cfg(), 'cpu')
    model.load_state_dict(got, strict=True)

    torch.save({'model_state': {k: torch.from_numpy(np.asarray(v))
                                for k, v in sd.items()}},
               tmp_path / 'ref.pth')
    cfg_file = write_yaml(json.loads(json.dumps(tiny_cfg())),
                          tmp_path / 'tiny.yaml')
    report = convert_cli.main(['--torch_ckpt', str(tmp_path / 'ref.pth'),
                               '--cfg_file', str(cfg_file),
                               '--out', str(tmp_path / 'out.pth')])
    assert report['kept'] == [] and report['shape_mismatch'] == []
    assert report['unmatched'] == ['backbone_3d.extra.weight']
    fresh = tdet.build_detector(tiny_cfg(), 'cpu')
    assert restore_checkpoint(tmp_path / 'out.pth', fresh) == 0
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, got[k]), k


def write_yaml(cfg: dict, path: Path) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope='module')
def raw_once(tmp_path_factory):
    """8 frames of one sequence (4 intervals of 2: 2 steps an epoch at batch
    2), infos and GT database by the port's tool."""
    root = make_raw_once(tmp_path_factory.mktemp('once'), n_frames=8)
    t_coi.main(['--data_path', str(root), '--splits', 'train', 'val'])
    return root


def cli_cfg(root, mae, tmp) -> Path:
    """The tiny model over the fixture on a 32x32 grid of 1.28 m pillars:
    previous frame at a fixed gap of 1, no augmentation, no point
    shuffle, so that no draw of the dataset's random state changes a
    batch."""
    cfg = json.loads(json.dumps(tiny_cfg(mae)))
    cfg['DATA_CONFIG'].update(
        DATASET='ONCETemporalDataset', DATA_PATH=str(root),
        POINT_CLOUD_RANGE=[-20.48, -20.48, -5.0, 20.48, 20.48, 3.0],
        SCAN_WINDOW=2, FIXED_GAP=1, ALIGN_TWO_FRAMES=True,
        DATA_SPLIT={'train': 'train', 'test': 'val'},
        DATA_PROCESSOR=[
            {'NAME': 'mask_points_and_boxes_outside_range',
             'REMOVE_OUTSIDE_BOXES': True},
            {'NAME': 'calculate_grid_size', 'VOXEL_SIZE': [1.28, 1.28, 8.0]}])
    cfg['RUNTIME'].update(MAX_POINTS=512, MAX_VOXELS=[256, 256, 128])
    if not mae:
        cfg['MODEL']['DENSE_HEAD']['POST_PROCESSING'][
            'POST_CENTER_LIMIT_RANGE'] = [-25, -25, -10, 25, 25, 10]
    name = 'tiny_ssl' if mae else 'tiny_ft'
    return write_yaml(cfg, tmp / 'cfgs' / 'once_models' / f'{name}.yaml')


class Stop(Exception):
    pass


def stop_after_first_save(path, model, opt, step, max_keep=None):
    save_checkpoint(path, model, opt, step, max_keep)
    raise Stop


@pytest.mark.parametrize('mae', [True, False], ids=['pretrain', 'finetune'])
def test_cli_resume_equals_uninterrupted_run(raw_once, tmp_path,
                                             monkeypatch, mae):
    monkeypatch.setattr(train_cli, 'OUTPUT_ROOT', tmp_path / 'output')
    # no TensorBoard sink, as on the card machine: its import fails
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    base = ['--cfg_file', str(cli_cfg(raw_once, mae, tmp_path)),
            '--device', 'cpu', '--fix_random_seed', '--epochs', '2']
    full = train_cli.main(base + ['--extra_tag', 'full',
                                  '--max_ckpt_save_num', '1'])
    assert full['steps_per_epoch'] == 2 and full['start_step'] == 0
    assert [s['step'] for s in full['steps']] == [1, 2, 3, 4]
    assert all(np.isfinite(s['loss']) and s['occ_overflow'] == 0
               for s in full['steps'])  # unlogged steps are read too
    assert [(e['epoch'], e['steps']) for e in full['epochs']] == [(0, 2),
                                                                  (1, 2)]
    assert [p.name for p in full['checkpoints']] == ['checkpoint_4.pth']
    lines = [json.loads(ln) for ln in (full['out_dir'] / 'metrics.jsonl')
             .read_text().splitlines()]
    assert [r['step'] for r in lines] == [1, 3]  # it 0 of each epoch
    assert all(np.isfinite(r['train/loss']) for r in lines)
    assert list(full['out_dir'].glob('log_train_*.txt'))

    with monkeypatch.context() as m:
        m.setattr(train_cli, 'save_checkpoint', stop_after_first_save)
        with pytest.raises(Stop):
            train_cli.main(base + ['--extra_tag', 'cut'])
    again = train_cli.main(base + ['--extra_tag', 'cut'])
    assert again['start_step'] == 2
    assert [s['step'] for s in again['steps']] == [3, 4]
    assert [s['lr'] for s in again['steps']] == [
        s['lr'] for s in full['steps'][2:]]
    assert [p.name for p in again['checkpoints']] == [
        'checkpoint_2.pth', 'checkpoint_4.pth']
    a = torch.load(full['checkpoints'][-1], weights_only=True)
    b = torch.load(again['checkpoints'][-1], weights_only=True)
    assert a['step'] == b['step'] == 4
    for k, v in a['model'].items():
        assert torch.equal(b['model'][k], v), k
    for i, st in a['optimizer']['state'].items():
        for k, v in st.items():
            assert torch.equal(b['optimizer']['state'][i][k], v), (i, k)


def test_metrics_logger_jsonl_without_tensorboard(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    log = MetricsLogger(tmp_path / 'run')
    assert log.sinks == ['jsonl']
    log.log(3, {'train/loss': torch.tensor(0.5), 'lr': 1e-3, 'tag': 'x'})
    log.log(4, {'train/loss': 0.25})
    log.close()
    lines = [json.loads(ln) for ln in
             (tmp_path / 'run' / 'metrics.jsonl').read_text().splitlines()]
    assert lines == [{'step': 3, 'train/loss': 0.5, 'lr': 1e-3},
                     {'step': 4, 'train/loss': 0.25}]
    assert MetricsLogger(None).sinks == []


def test_overfit_config_copy_equals_the_jax_oracle():
    """chip_smoke.py's overfit phase uses the port test's copy of the
    oracle's config; it must stay equal to tests/test_overfit_ap.py's."""
    from tests import test_overfit_ap as oracle
    from tests import test_torch_port_overfit_ap as port

    assert port.BASE == oracle.BASE
    for mae in (True, False):
        assert port.mini_model(mae) == oracle._mini_model(mae), mae


@pytest.mark.parametrize('flags,match', [
    (['--set', 'MODEL.NAME', 'NoSuchNet'], 'an unknown detector'),
    (['--set', 'MODEL.NAME', 'GraphRCNN', 'MODEL.IMG_BACKBONE', 'DLASeg'],
     'camera')],
    ids=['detector', 'gdmae'])
def test_cli_refuses_what_is_not_ported(raw_once, tmp_path, monkeypatch,
                                        flags, match):
    # the ids keep the names of the cases that refused SECONDNet and GDMAE,
    # then SSD3D and GraphRCNN, before those were ported; GraphRCNN's
    # camera branch is still refused
    monkeypatch.setattr(train_cli, 'OUTPUT_ROOT', tmp_path / 'output')
    with pytest.raises(NotImplementedError, match=match):
        train_cli.main(['--cfg_file', str(cli_cfg(raw_once, False, tmp_path)),
                        '--device', 'cpu', *flags])


def test_cli_launcher_one_rank_equals_no_launcher(raw_once, tmp_path,
                                                   monkeypatch):
    """``--launcher pytorch`` with torchrun's environment for one rank (a
    gloo group of one on the CPU): the same steps, losses and final
    checkpoint as the run without a launcher, bit for bit, and no group
    left after it. (Two ranks: ``tests/test_torch_port_dist.py``.)"""
    monkeypatch.setattr(train_cli, 'OUTPUT_ROOT', tmp_path / 'output')
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    for k, v in torchrun_env(1, 0, free_port()).items():
        monkeypatch.setenv(k, v)
    base = ['--cfg_file', str(cli_cfg(raw_once, False, tmp_path)),
            '--device', 'cpu', '--fix_random_seed', '--epochs', '1']
    runs = [train_cli.main(base + flags) for flags in (
        ['--extra_tag', 'none'],
        ['--extra_tag', 'launched', '--launcher', 'pytorch'])]
    assert not torch.distributed.is_initialized()
    (a, b) = runs
    assert [s['loss'] for s in a['steps']] == [s['loss'] for s in b['steps']]
    assert [p.name for p in a['checkpoints']] == [
        p.name for p in b['checkpoints']]
    ca, cb = (torch.load(r['checkpoints'][-1], weights_only=True)
              for r in runs)
    for k, v in ca['model'].items():
        assert torch.equal(cb['model'][k], v), k


@pytest.mark.parametrize('env,flags,error,match', [
    ({}, [], RuntimeError, 'WORLD_SIZE, RANK'),
    ({'WORLD_SIZE': '2'}, ['--batch_size', '3'], ValueError,
     'global batch 3 not divisible by 2 ranks')],
    ids=['no-environment', 'batch-does-not-divide'])
def test_cli_refuses_a_bad_launch(raw_once, tmp_path, monkeypatch, env,
                                  flags, error, match):
    """Refused before any process group is made: a launcher without its
    environment, a global batch that the ranks do not divide."""
    monkeypatch.setattr(train_cli, 'OUTPUT_ROOT', tmp_path / 'output')
    for k in TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)
    if env:
        for k, v in {**torchrun_env(2, 0, free_port()), **env}.items():
            monkeypatch.setenv(k, v)
    with pytest.raises(error, match=match):
        train_cli.main(['--cfg_file', str(cli_cfg(raw_once, False, tmp_path)),
                        '--device', 'cpu', '--launcher', 'pytorch', *flags])
    assert not torch.distributed.is_initialized()
