"""Evaluation loop (counterpart of ``tmae_tpu/train/evaluator.py``): per
batch the forward and decode on the model's device (CenterPoint's decode,
the anchor families' top K of each anchor's best class score, or SSD3D's
votes or GraphRCNN's refined RoIs cut by score and sorted), one copy of the
candidates to the host,
native host NMS, prediction dicts and the recall bookkeeping; then ``result.pkl`` and the dataset's AP: ONCE AP, or
Waymo AP and APH at LEVEL_1 / LEVEL_2.

Under data parallelism each rank evaluates its shard of the dataset
(padded to equal length); the ranks' prediction dicts and recall counts
are gathered (``parallel/dist.all_gather_objects``), put back in dataset
order and cut to the dataset's length, as the JAX evaluator merges them;
rank 0 writes ``result.pkl`` and computes the AP, which every rank
returns.
"""

from __future__ import annotations

import logging
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from ..models.detectors import (ANCHOR_DETECTORS, anchor_predict,
                                batch_to_device, centerpoint_predict,
                                host_nms)
from ..models.graph_rcnn import graph_rcnn_candidates
from ..models.ssd3d import ssd3d_candidates
from ..ops.geometry_np import boxes_iou3d
from ..parallel import dist
from ..utils import native
from .trainer import collect_occ_overflow

log = logging.getLogger(__name__)

# the batch keys the model reads (the rest, frame ids and boxes, stay on
# the host)
MODEL_INPUTS = ('points', 'point_mask', 'points_prev', 'point_mask_prev',
                'voxels', 'voxel_num_points', 'voxel_coords',
                'voxel_coords_zyx', 'voxel_mask',
                # the host voxelization (RUNTIME.HOST_VOXELIZE)
                'pv_cur', 'pvalid_cur', 'vcoords_cur', 'vmask_cur',
                'pv_prv', 'pvalid_prv', 'vcoords_prv', 'vmask_prv',
                'vmean_cur', 'vends_cur', 'vmean_prv', 'vends_prv')


def make_eval_step(model, cfg):
    """``eval_step(batch) -> (boxes [B, K, 7], scores, labels, valid,
    occ_overflow)`` as numpy, NMS not applied: the forward, the family's
    candidates (``centerpoint_predict`` or ``anchor_predict``) and the
    overflow count under ``no_grad`` on the model's device, then one copy
    of all of it to the host (the only synchronisation of the step).
    SSD3D's candidates are its votes of score >= ``SCORE_THRESH``, sorted by
    score with the valid ones first, the top ``NMS_PRE_MAXSIZE``
    (``ssd3d_candidates``); GraphRCNN's its refined RoIs, cut and sorted
    the same way (``graph_rcnn_candidates``). ``batch``: tensors on the
    model's device."""
    name = cfg['MODEL']['NAME']
    if name not in ('CenterPoint', 'SSD3D', 'GraphRCNN') + ANCHOR_DETECTORS:
        raise NotImplementedError(f'{name} has no evaluation: it is not a '
                                  'detector')
    model.eval()

    def candidates(out):
        if name in ANCHOR_DETECTORS:
            return anchor_predict(cfg, model.dense_head, out)
        if name == 'SSD3D':
            return ssd3d_candidates(cfg, out)
        if name == 'GraphRCNN':
            return graph_rcnn_candidates(cfg, out)
        return centerpoint_predict(cfg, out, nms_on_device=False)

    @torch.no_grad()
    def eval_step(batch):
        out = model(batch)
        boxes, scores, labels, valid = candidates(out)
        # one f32 buffer: labels, validity and the count are small integers,
        # exact in f32
        B, K = scores.shape
        packed = torch.cat([
            torch.cat([boxes.float(), scores[..., None].float(),
                       labels[..., None].float(),
                       valid[..., None].float()], -1).reshape(-1),
            collect_occ_overflow(out).reshape(1).float()]).cpu().numpy()
        cand = packed[:-1].reshape(B, K, 10)
        return (cand[..., :7], cand[..., 7], cand[..., 8].astype(np.int64),
                cand[..., 9] > 0, int(packed[-1]))

    return eval_step


def eval_one_epoch(cfg, model, loader, dataset, class_names,
                   result_dir=None, logger=None):
    """Runs ``model`` over ``loader``; writes ``result_dir/result.pkl`` (the
    prediction dicts) when given. Returns (AP table, AP dict with
    ``sec_per_sample``, ``occ_overflow``, ``loader_ms_per_batch`` and
    ``host_nms_ms_per_batch``; the times are rank 0's, ``occ_overflow``
    the ranks' sum)."""
    logger = logger or log
    eval_step = make_eval_step(model, cfg)
    device = next(model.parameters()).device
    native.get_lib()  # built or loaded here, not in the first batch's time
    det_annos, hits = [], []  # hits: (gt boxes, recalled per thresh)
    infer_time = loader_time = nms_time = 0.0
    n_samples = n_batches = 0
    recall_threshs = list(
        cfg['MODEL'].get('POST_PROCESSING', {}).get('RECALL_THRESH_LIST',
                                                    [0.3, 0.5, 0.7])
    )
    occ_overflow_total = 0
    batches = iter(loader)
    while True:
        t_wait = time.perf_counter()
        batch = next(batches, None)
        loader_time += time.perf_counter() - t_wait
        if batch is None:
            break
        dev_batch = batch_to_device(
            {k: v for k, v in batch.items() if k in MODEL_INPUTS}, device)
        t0 = time.perf_counter()
        boxes, scores, labels, valid, overflow = eval_step(dev_batch)
        occ_overflow_total += overflow
        t_nms = time.perf_counter()
        valid = host_nms(cfg, boxes, scores, labels, valid)
        t1 = time.perf_counter()
        infer_time += t1 - t0
        nms_time += t1 - t_nms
        n_batches += 1
        n_samples += len(batch['frame_id'])
        det_annos += dataset.generate_prediction_dicts(
            batch['frame_id'], boxes, scores, labels, valid, class_names)
        for b in range(len(batch['frame_id'])):
            hits.append(_recall_hits(batch, b, boxes[b][valid[b]],
                                     recall_threshs))
    if dist.grouped():
        gathered = dist.all_gather_objects(
            (det_annos, hits, occ_overflow_total))
        det_annos = dist.merge_ranked([g[0] for g in gathered], len(dataset))
        hits = dist.merge_ranked([g[1] for g in gathered], len(dataset))
        occ_overflow_total = sum(g[2] for g in gathered)
    total_gt = sum(h[0] for h in hits)
    recall = {t: sum(h[1][i] for h in hits)
              for i, t in enumerate(recall_threshs)}
    sec_per_sample = infer_time / max(n_samples, 1)
    logger.info('eval: %.4f sec/sample (%d samples)', sec_per_sample,
                n_samples)
    if occ_overflow_total > 0:
        logger.warning(
            'eval: occ_overflow=%d occupied windows exceeded the compaction '
            'caps and ran as identity — raise RUNTIME.OCC_*_CAPS '
            '(accuracy is silently degraded otherwise)', occ_overflow_total)
    for t in recall_threshs:
        logger.info('recall_rcnn_%.1f: %.4f', t,
                    recall[t] / max(total_gt, 1))
    result = None
    if dist.rank() == 0:
        if result_dir is not None:
            result_dir = Path(result_dir)
            result_dir.mkdir(parents=True, exist_ok=True)
            with open(result_dir / 'result.pkl', 'wb') as f:
                pickle.dump(det_annos, f)
        ap_str, ap_dict = dataset.evaluation(det_annos, class_names)
        ap_dict['sec_per_sample'] = sec_per_sample
        ap_dict['occ_overflow'] = occ_overflow_total
        ap_dict['loader_ms_per_batch'] = (loader_time * 1e3
                                          / max(n_batches, 1))
        ap_dict['host_nms_ms_per_batch'] = nms_time * 1e3 / max(n_batches, 1)
        result = ap_str, ap_dict
    return dist.all_gather_objects(result)[0]


def _recall_hits(batch, b, pred, recall_threshs) -> tuple:
    """(gt boxes of sample ``b``, how many of them a kept box ``pred``
    overlaps by more than each threshold): the sample's share of the
    recall."""
    if 'gt_boxes' not in batch:
        return 0, [0] * len(recall_threshs)
    gm = np.asarray(batch['gt_mask'][b])
    gt = np.asarray(batch['gt_boxes'][b])[gm][:, :7]
    if len(gt) == 0 or len(pred) == 0:
        return len(gt), [0] * len(recall_threshs)
    best = boxes_iou3d(gt.astype(np.float64),
                       np.asarray(pred)[:, :7].astype(np.float64)).max(axis=1)
    return len(gt), [int((best > t).sum()) for t in recall_threshs]
