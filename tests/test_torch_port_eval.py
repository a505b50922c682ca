"""The port's ONCE evaluation against the JAX package's on the CPU.

* ``get_evaluation_results`` equal to JAX's, table and dict, exactly, with
  the native and the numpy accumulators, on the annotations of
  ``tests/test_eval_and_optim.py`` (perfect, empty, half detected,
  superclass) and on a crowded case of noisy detections at every distance.
* The slice as a whole: ``eval_one_epoch`` of the tiny config
  (``tests/tiny_cfg.py``, synthetic uniform scenes, host voxelization) with
  JAX's weights carried across by ``params_from_jax``, against JAX's
  ``eval_one_epoch`` on the same batches (each side its own loader, which
  ``tests/test_torch_port_once_data.py`` holds equal). The frame ids and
  their order are equal. The candidates before NMS agree within the head-map
  tolerance of ``tests/test_torch_port_model.py`` (0.03 on the maps, bf16
  weights on the port's side), carried to the boxes: valid counts equal;
  the sorted scores within 0.0075 (the sigmoid's slope is at most 1/4);
  each JAX candidate whose score clears the last valid score of both sides
  by that much has a port candidate of its label with x, y within 0.0096 m
  (0.03 cells of 0.32 m), z within 0.03, log dims within 0.03 and heading
  within 0.3 rad (atan2 of two maps, each within 0.03, on vectors of norm
  0.1 or more). The port's post-processing (host NMS, prediction dicts,
  evaluation) of JAX's own candidates gives JAX's kept masks, prediction
  dicts and AP dict exactly; so it does on candidates planted near the
  ground truth, where the AP is not 0.
* The CLI ``main`` (``python -m tmae_tpu_torch.tools.test``) on a checkpoint
  saved by the port, ``--device cpu``: ``result.pkl``, ``--eval_all`` with
  its polling cut short by ``--max_waiting_mins 0``, ``--fuse_conv_bn``,
  and the refusals.
"""

import copy
import json
import pickle

import jax
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_port_model import random_variables
from tests.tiny_cfg import CLASS_NAMES, tiny_cfg
from tests.torch_dist_ranks import TORCHRUN_VARS, free_port, torchrun_env
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.datasets.dataset import build_dataloader as j_build
from tmae_tpu.datasets.once_eval import \
    get_evaluation_results as j_get_evaluation_results
from tmae_tpu.models import detectors as jdet
from tmae_tpu.train import evaluator as jev
from tmae_tpu_torch.datasets.dataset import build_dataloader as t_build
from tmae_tpu_torch.datasets.once_eval import get_evaluation_results
from tmae_tpu_torch.models import detectors as tdet
from tmae_tpu_torch.tools import test as cli
from tmae_tpu_torch.train import evaluator as tev
from tmae_tpu_torch.train.checkpoint import save_checkpoint
from tmae_tpu_torch.utils.from_jax import params_from_jax

SCORE_TOL = 0.0075
XY_TOL, Z_TOL, LOG_DIM_TOL, HEADING_TOL = 0.0096, 0.03, 0.03, 0.3


def _anno(names, boxes, scores=None):
    d = {'name': np.asarray(names),
         'boxes_3d': np.asarray(boxes, np.float64).reshape(-1, 7)}
    if scores is not None:
        d['score'] = np.asarray(scores, np.float64)
    return d


def _perfect():
    gt, pred = [], []
    rng = np.random.RandomState(0)
    for _ in range(6):
        boxes = [[rng.uniform(-20, 20), rng.uniform(-20, 20), 0.0, 4.0, 2.0,
                  1.6, rng.uniform(-np.pi, np.pi)] for _ in range(5)]
        names = [CLASS_NAMES[i % 5] for i in range(5)]
        gt.append(_anno(names, boxes))
        pred.append(_anno(names, boxes, scores=rng.uniform(0.5, 1.0, 5)))
    return gt, pred


def _empty():
    return ([_anno(['Car'], [[0, 0, 0, 4, 2, 1.6, 0]])],
            [_anno([], np.zeros((0, 7)), scores=np.zeros(0))])


def _half():
    return ([_anno(['Car', 'Car'], [[0, 0, 0, 4, 2, 1.6, 0],
                                    [20, 0, 0, 4, 2, 1.6, 0]])],
            [_anno(['Car'], [[0, 0, 0, 4, 2, 1.6, 0]], scores=[0.9])])


def _superclass():
    return ([_anno(['Truck'], [[0, 0, 0, 6, 2.5, 3, 0]])],
            [_anno(['Bus'], [[0, 0, 0, 6, 2.5, 3, 0]], scores=[0.9])])


def _crowded():
    """Ten frames of 30 objects out to 70 m, detected with noise in
    position, size and heading, some missed, some false, labels mixed."""
    rng = np.random.RandomState(7)
    gt, pred = [], []
    for _ in range(10):
        n = 30
        r, a = rng.uniform(2, 70, n), rng.uniform(-np.pi, np.pi, n)
        boxes = np.c_[r * np.cos(a), r * np.sin(a), rng.uniform(-1, 1, n),
                      rng.uniform(0.6, 8, (n, 3)), rng.uniform(-np.pi, np.pi, n)]
        names = np.asarray(CLASS_NAMES)[rng.randint(0, 5, n)]
        gt.append(_anno(names, boxes))
        hit = rng.rand(n) < 0.8
        det = boxes[hit] + np.c_[rng.normal(0, 0.3, (hit.sum(), 3)),
                                 rng.normal(0, 0.1, (hit.sum(), 3)),
                                 rng.normal(0, 0.3, hit.sum())]
        det[:, 3:6] = np.abs(det[:, 3:6]) + 0.1
        dnames = names[hit].copy()
        swap = rng.rand(len(dnames)) < 0.1
        dnames[swap] = np.asarray(CLASS_NAMES)[rng.randint(0, 5, swap.sum())]
        fp = np.c_[rng.uniform(-60, 60, (8, 2)), rng.uniform(-1, 1, 8),
                   rng.uniform(0.6, 8, (8, 3)), rng.uniform(-np.pi, np.pi, 8)]
        pred.append(_anno(
            np.r_[dnames, np.asarray(CLASS_NAMES)[rng.randint(0, 5, 8)]],
            np.r_[det, fp], scores=rng.uniform(0.1, 1, len(det) + 8)))
    return gt, pred


@pytest.mark.parametrize('native', [True, False], ids=['native', 'numpy'])
@pytest.mark.parametrize('case', [_perfect, _empty, _half, _superclass,
                                  _crowded], ids=lambda f: f.__name__[1:])
def test_get_evaluation_results_equal_jax(case, native):
    gt, pred = case()
    want_str, want = j_get_evaluation_results(copy.deepcopy(gt),
                                              copy.deepcopy(pred),
                                              CLASS_NAMES)
    got_str, got = get_evaluation_results(gt, pred, CLASS_NAMES,
                                          native=native)
    assert got_str == want_str
    assert got == want
    if case is _crowded:
        assert 5 < got['AP_mean/overall'] < 95
        assert got['AP_Vehicle/50m-inf'] > 0


def eval_cfg():
    cfg = copy.deepcopy(tiny_cfg())
    cfg.RUNTIME.OCC_MID_CAPS = [16, 16, 16]
    cfg.RUNTIME.HOST_VOXELIZE = True
    cfg.DATA_CONFIG.update(
        DATASET='SyntheticONCEDataset', NUM_SYNTHETIC_SAMPLES=4,
        SYNTHETIC_POINTS=256, SYNTHETIC_BOXES=3,
        DATA_SPLIT={'train': 'train', 'test': 'val'})
    return cfg


def recording(captured, fn):
    """``fn`` (a host_nms) that also records its inputs and kept mask."""
    def host_nms(cfg, boxes, scores, labels, valid):
        keep = fn(cfg, boxes, scores, labels, valid)
        captured.append(tuple(np.array(a) for a in
                              (boxes, scores, labels, valid, keep)))
        return keep
    return host_nms


@pytest.fixture(scope='module')
def slice_run(tmp_path_factory):
    """JAX's and the port's eval_one_epoch on the tiny config, the port with
    JAX's weights; the candidates each handed to host NMS."""
    out = tmp_path_factory.mktemp('eval')
    cfg = eval_cfg()
    args = (cfg.DATA_CONFIG, CLASS_NAMES, 2, False)
    jds, jloader = j_build(*args, runtime_cfg=cfg.RUNTIME, seed=1024)
    tds, tloader = t_build(*args, runtime_cfg=cfg.RUNTIME, seed=1024)
    jmodel = jdet.build_detector(cfg)
    inputs = {k: v for k, v in next(iter(jloader)).items()
              if k in tev.MODEL_INPUTS}
    shapes = jax.eval_shape(lambda b: jmodel.init(
        jax.random.PRNGKey(0), b, train=False), inputs)
    variables = random_variables(shapes, 0)
    tmodel = tdet.build_detector(cfg, 'cpu')
    tmodel.load_state_dict(params_from_jax(variables), strict=True)
    cap = {'jax': [], 'torch': []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jev, 'host_nms', recording(cap['jax'], jdet.host_nms))
        mp.setattr(tev, 'host_nms', recording(cap['torch'], tdet.host_nms))
        jres = jev.eval_one_epoch(cfg, jmodel, variables, jloader, jds,
                                  CLASS_NAMES, result_dir=out / 'jax')
        tres = tev.eval_one_epoch(cfg, tmodel, tloader, tds, CLASS_NAMES,
                                  result_dir=out / 'torch')
    annos = {side: pickle.loads((out / side / 'result.pkl').read_bytes())
             for side in ('jax', 'torch')}
    return dict(cfg=cfg, jds=jds, tds=tds, jres=jres, tres=tres, cap=cap,
                annos=annos)


def test_eval_slice_frames_and_candidates(slice_run):
    annos, cap = slice_run['annos'], slice_run['cap']
    ids = [a['frame_id'] for a in annos['torch']]
    assert ids == [a['frame_id'] for a in annos['jax']]
    assert ids == [f'synth_{i:06d}' for i in range(4)]
    assert len(cap['jax']) == len(cap['torch']) == 2
    checked = 0
    for (jb, js, jl, jv, _), (tb, ts, tl, tv, _) in zip(cap['jax'],
                                                        cap['torch']):
        assert tb.shape == jb.shape and tb.dtype == np.float32
        np.testing.assert_array_equal(tv.sum(1), jv.sum(1))
        for b in range(jb.shape[0]):
            n = int(jv[b].sum())
            assert n > 0
            np.testing.assert_allclose(np.sort(ts[b, :n]), np.sort(js[b, :n]),
                                       rtol=0, atol=SCORE_TOL)
            cut = max(js[b, n - 1], ts[b, n - 1]) + SCORE_TOL
            for i in np.nonzero(js[b, :n] > cut)[0]:
                same = np.nonzero((tl[b, :n] == jl[b, i]))[0]
                d = tb[b, same] - jb[b, i]
                k = np.argmin(np.abs(d[:, :2]).max(1))
                assert np.abs(d[k, :2]).max() <= XY_TOL, (b, i)
                assert abs(d[k, 2]) <= Z_TOL, (b, i)
                assert np.abs(np.log(tb[b, same[k], 3:6]
                                     / jb[b, i, 3:6])).max() <= LOG_DIM_TOL
                assert abs((d[k, 6] + np.pi) % (2 * np.pi) - np.pi) \
                    <= HEADING_TOL, (b, i)
                assert abs(ts[b, same[k]] - js[b, i]) <= SCORE_TOL
                checked += 1
    assert checked >= 40
    jap, tap = slice_run['jres'][1], slice_run['tres'][1]
    assert tap['occ_overflow'] == jap['occ_overflow']
    for key in ('sec_per_sample', 'loader_ms_per_batch',
                'host_nms_ms_per_batch'):
        assert np.isfinite(tap[key]) and tap[key] > 0


def _annos_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and g['frame_id'] == w['frame_id']
        for k in ('name', 'score', 'boxes_3d'):
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])


def post_process(host_nms, ds, cfg, batches, ids):
    """Host NMS, prediction dicts and ONCE AP of candidate batches."""
    annos, kept = [], []
    for (boxes, scores, labels, valid), fids in zip(batches, ids):
        keep = host_nms(cfg, boxes, scores, labels, valid)
        kept.append(keep)
        annos += ds.generate_prediction_dicts(fids, boxes, scores, labels,
                                              keep, CLASS_NAMES)
    return kept, annos, ds.evaluation(annos, CLASS_NAMES)


def test_post_processing_of_jax_candidates_equals_jax(slice_run):
    cfg, cap = slice_run['cfg'], slice_run['cap']
    batches = [c[:4] for c in cap['jax']]
    ids = [['synth_000000', 'synth_000001'], ['synth_000002', 'synth_000003']]
    kept, annos, (ap_str, ap) = post_process(tdet.host_nms, slice_run['tds'],
                                             cfg, batches, ids)
    for k, c in zip(kept, cap['jax']):
        np.testing.assert_array_equal(k, c[4])
    _annos_equal(annos, slice_run['annos']['jax'])
    jstr, jap = slice_run['jres']
    assert ap_str == jstr
    assert ap == {k: v for k, v in jap.items() if k.startswith('AP_')}


def test_post_processing_of_planted_candidates_equals_jax(slice_run):
    """Candidates near each scene's ground truth (jittered, some with the
    wrong label, duplicates NMS removes) and false ones: the port's host
    NMS, dicts and AP (native and numpy) equal JAX's, and the AP is not
    0."""
    cfg, jds, tds = slice_run['cfg'], slice_run['jds'], slice_run['tds']
    rng = np.random.RandomState(11)
    batches, ids = [], []
    for first in (0, 2):
        B, K = 2, 40
        boxes = np.zeros((B, K, 7), np.float32)
        labels = np.ones((B, K), np.int32)
        for b in range(B):
            scene = jds._scene(first + b)
            gt = np.repeat(scene['boxes'], 4, axis=0)
            boxes[b, :len(gt)] = gt + rng.normal(0, 0.05, gt.shape)
            boxes[b, len(gt):, :2] = rng.uniform(-5, 5, (K - len(gt), 2))
            boxes[b, len(gt):, 3:6] = rng.uniform(0.5, 4, (K - len(gt), 3))
            lab = np.repeat([CLASS_NAMES.index(n) + 1
                             for n in scene['names']], 4)
            lab[rng.rand(len(lab)) < 0.2] = rng.randint(1, 6)
            labels[b, :len(gt)] = lab
            labels[b, len(gt):] = rng.randint(1, 6, K - len(gt))
        order = np.argsort(-rng.rand(B, K), axis=1)
        boxes = np.take_along_axis(boxes, order[..., None], 1)
        labels = np.take_along_axis(labels, order, 1)
        scores = -np.sort(-rng.uniform(0.1, 1, (B, K)), 1).astype(np.float32)
        valid = np.arange(K)[None] < np.array([[K], [K - 5]])
        batches.append((boxes, scores, labels, valid))
        ids.append([f'synth_{first + b:06d}' for b in range(B)])
    jkept, jannos, (jstr, jap) = post_process(jdet.host_nms, jds, cfg,
                                              batches, ids)
    kept, annos, (ap_str, ap) = post_process(tdet.host_nms, tds, cfg,
                                             batches, ids)
    for k, jk in zip(kept, jkept):
        np.testing.assert_array_equal(k, jk)
    _annos_equal(annos, jannos)
    assert (ap_str, ap) == (jstr, jap)
    assert tds.evaluation(annos, CLASS_NAMES, native=False) == (jstr, jap)
    assert jap['AP_mean/overall'] > 10


def write_cfg(cfg, path):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    return path


def test_cli_main_evaluates_a_port_checkpoint(tmp_path, monkeypatch):
    """One checkpoint, then --eval_all over the checkpoint directory: each
    writes result.pkl with one dict per synthetic frame, in order."""
    monkeypatch.setattr(cli, 'OUTPUT_ROOT', tmp_path / 'output')
    cfg_file = write_cfg(eval_cfg(), tmp_path / 'cfgs' / 'once_models'
                         / 'tiny_eval.yaml')
    model = tdet.init_random_(tdet.build_detector(eval_cfg(), 'cpu'), seed=3)
    ckpt = save_checkpoint(tmp_path / 'weights.pth', model, None, 7)
    base = ['--cfg_file', str(cfg_file), '--device', 'cpu',
            '--set', 'DATA_CONFIG.NUM_SYNTHETIC_SAMPLES', '3']
    res = cli.main(base + ['--ckpt', str(ckpt), '--batch_size', '2'])
    out = tmp_path / 'output' / 'once_models' / 'tiny_eval' / 'default'
    assert list(res) == [out / 'eval' / 'single']
    annos = pickle.loads((out / 'eval' / 'single' / 'result.pkl')
                         .read_bytes())
    assert [a['frame_id'] for a in annos] == [f'synth_{i:06d}'
                                              for i in range(3)]
    ap = res[out / 'eval' / 'single']
    assert all(np.isfinite(v) for k, v in ap.items() if k.startswith('AP_'))
    assert ap['occ_overflow'] == 0
    assert list((out / 'eval').glob('log_eval_*.txt'))

    (out / 'ckpt').mkdir()
    (out / 'ckpt' / 'checkpoint_7.pth').write_bytes(ckpt.read_bytes())
    res = cli.main(base + ['--eval_all', '--max_waiting_mins', '0'])
    assert list(res) == [out / 'eval' / 'checkpoint_7.pth']
    again = pickle.loads((out / 'eval' / 'checkpoint_7.pth' / 'result.pkl')
                         .read_bytes())
    _annos_equal(again, annos)
    assert (out / 'eval' / 'eval_list.txt').read_text().split() == [
        str(out / 'ckpt' / 'checkpoint_7.pth')]


@pytest.mark.parametrize('flags,match', [
    (['--set', 'MODEL.NAME', 'GraphRCNN', 'MODEL.IMG_BACKBONE', 'DLASeg'],
     'camera')],
    ids=['detector'])
def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, flags, match):
    monkeypatch.setattr(cli, 'OUTPUT_ROOT', tmp_path / 'output')
    cfg_file = write_cfg(eval_cfg(), tmp_path / 'once_models' / 'tiny.yaml')
    with pytest.raises(NotImplementedError, match=match):
        cli.main(['--cfg_file', str(cfg_file), '--device', 'cpu',
                  '--ckpt', str(tmp_path / 'none.pth'), *flags])


def test_cli_launcher_one_rank_equals_one_process(tmp_path, monkeypatch):
    """``--launcher pytorch`` with torchrun's environment for one rank: a
    process group of one gloo rank on the CPU, the same result.pkl and AP
    as the run without a launcher, and no group left after it. (Two ranks:
    ``tests/test_torch_port_dist.py``.)"""
    monkeypatch.setattr(cli, 'OUTPUT_ROOT', tmp_path / 'output')
    for k, v in torchrun_env(1, 0, free_port()).items():
        monkeypatch.setenv(k, v)
    cfg_file = write_cfg(eval_cfg(), tmp_path / 'cfgs' / 'once_models'
                         / 'tiny_eval.yaml')
    model = tdet.init_random_(tdet.build_detector(eval_cfg(), 'cpu'), seed=3)
    ckpt = save_checkpoint(tmp_path / 'weights', model, None, 7)
    base = ['--cfg_file', str(cfg_file), '--device', 'cpu', '--ckpt',
            str(ckpt), '--set', 'DATA_CONFIG.NUM_SYNTHETIC_SAMPLES', '3']
    runs = []
    for flags in (['--extra_tag', 'none'],
                  ['--extra_tag', 'launched', '--launcher', 'pytorch']):
        (rdir, ap), = cli.main(base + flags).items()
        runs.append((pickle.loads((rdir / 'result.pkl').read_bytes()), ap))
        assert not torch.distributed.is_initialized()
    (annos, ap), (annos1, ap1) = runs
    _annos_equal(annos1, annos)
    assert [a['frame_id'] for a in annos1] == [f'synth_{i:06d}'
                                               for i in range(3)]
    assert {k: v for k, v in ap1.items() if k.startswith('AP')} == {
        k: v for k, v in ap.items() if k.startswith('AP')}


def test_cli_refuses_a_launch_without_its_environment(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(cli, 'OUTPUT_ROOT', tmp_path / 'output')
    for k in TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)
    cfg_file = write_cfg(eval_cfg(), tmp_path / 'once_models' / 'tiny.yaml')
    with pytest.raises(RuntimeError, match='WORLD_SIZE, RANK'):
        cli.main(['--cfg_file', str(cfg_file), '--device', 'cpu', '--ckpt',
                  str(tmp_path / 'none.pth'), '--launcher', 'pytorch'])


def test_cli_fuse_conv_bn_folds_after_loading(tmp_path, monkeypatch):
    """``--fuse_conv_bn``: the checkpoint loads, every conv–BN pair is folded
    (each folded BN is then the identity plus a bias), and the evaluation
    writes result.pkl with the same frames as the unfused run, whose
    candidates it keeps within the bf16 rounding of the folded weights
    (scores of the boxes both keep within 0.01)."""
    from tmae_tpu_torch.utils import fuse

    monkeypatch.setattr(cli, 'OUTPUT_ROOT', tmp_path / 'output')
    cfg_file = write_cfg(eval_cfg(), tmp_path / 'once_models' / 'tiny.yaml')
    model = tdet.init_random_(tdet.build_detector(eval_cfg(), 'cpu'), seed=3)
    ckpt = save_checkpoint(tmp_path / 'weights.pth', model, None, 7)
    folded = []
    monkeypatch.setattr(cli, 'fuse_conv_bn', lambda m: folded.append(
        m) or fuse.fuse_conv_bn(m))
    base = ['--cfg_file', str(cfg_file), '--device', 'cpu', '--ckpt',
            str(ckpt), '--set', 'DATA_CONFIG.NUM_SYNTHETIC_SAMPLES', '2']
    (fdir, _), = cli.main(base + ['--fuse_conv_bn', '--extra_tag',
                                  'fused']).items()
    (udir, _), = cli.main(base + ['--extra_tag', 'plain']).items()
    bns = [m.bn for m in folded[0].modules() if hasattr(m, 'bn')]
    assert bns and all(bool((b.running_mean == 0).all()) for b in bns)
    fa = pickle.loads((fdir / 'result.pkl').read_bytes())
    ua = pickle.loads((udir / 'result.pkl').read_bytes())
    assert [a['frame_id'] for a in fa] == [a['frame_id'] for a in ua]
    for f, u in zip(fa, ua):
        both = min(len(f['score']), len(u['score']))
        assert both > 0
        np.testing.assert_allclose(np.sort(f['score'])[::-1][:both],
                                   np.sort(u['score'])[::-1][:both],
                                   atol=0.01)
