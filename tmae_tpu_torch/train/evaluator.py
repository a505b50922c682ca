"""Evaluation loop (counterpart of ``tmae_tpu/train/evaluator.py``): per
batch the forward and decode on the model's device, one copy of the
candidates to the host, native host NMS, prediction dicts and the recall
bookkeeping; then ``result.pkl`` and the dataset's AP: ONCE AP, or Waymo AP
and APH at LEVEL_1 / LEVEL_2.
"""

from __future__ import annotations

import logging
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from ..models.detectors import batch_to_device, centerpoint_predict, host_nms
from ..ops.geometry_np import boxes_iou3d
from ..utils import native
from .trainer import collect_occ_overflow

log = logging.getLogger(__name__)

# the batch keys the model reads (the rest, frame ids and boxes, stay on
# the host)
MODEL_INPUTS = ('points', 'point_mask', 'points_prev', 'point_mask_prev',
                'voxels', 'voxel_num_points', 'voxel_coords_zyx',
                'voxel_mask',
                # the host voxelization (RUNTIME.HOST_VOXELIZE)
                'pv_cur', 'pvalid_cur', 'vcoords_cur', 'vmask_cur',
                'pv_prv', 'pvalid_prv', 'vcoords_prv', 'vmask_prv',
                'vmean_cur', 'vends_cur', 'vmean_prv', 'vends_prv')


def make_eval_step(model, cfg):
    """``eval_step(batch) -> (boxes [B, K, 7], scores, labels, valid,
    occ_overflow)`` as numpy, NMS not applied: the forward,
    ``centerpoint_predict`` and the overflow count under ``no_grad`` on the
    model's device, then one copy of all of it to the host (the only
    synchronisation of the step). ``batch``: tensors on the model's
    device."""
    name = cfg['MODEL']['NAME']
    if name != 'CenterPoint':
        raise NotImplementedError(
            f'evaluation of {name} is not ported yet (ROADMAP.md, module 10: '
            'other detector families)')
    model.eval()

    @torch.no_grad()
    def eval_step(batch):
        out = model(batch)
        boxes, scores, labels, valid = centerpoint_predict(
            cfg, out, nms_on_device=False)
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
    ``host_nms_ms_per_batch``)."""
    logger = logger or log
    if loader.process_count > 1:
        raise NotImplementedError('multi-process evaluation is not ported '
                                  'yet (ROADMAP.md, module 8)')
    eval_step = make_eval_step(model, cfg)
    device = next(model.parameters()).device
    native.get_lib()  # built or loaded here, not in the first batch's time
    det_annos = []
    infer_time = loader_time = nms_time = 0.0
    n_samples = n_batches = 0
    recall_threshs = list(
        cfg['MODEL'].get('POST_PROCESSING', {}).get('RECALL_THRESH_LIST',
                                                    [0.3, 0.5, 0.7])
    )
    recall = {t: 0 for t in recall_threshs}
    total_gt = 0
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
        if 'gt_boxes' in batch:
            for b in range(len(batch['frame_id'])):
                gm = np.asarray(batch['gt_mask'][b])
                gt = np.asarray(batch['gt_boxes'][b])[gm][:, :7]
                total_gt += len(gt)
                if len(gt) == 0:
                    continue
                pred = np.asarray(boxes[b])[valid[b]][:, :7]
                if len(pred) == 0:
                    continue
                best = boxes_iou3d(gt.astype(np.float64),
                                   pred.astype(np.float64)).max(axis=1)
                for t in recall_threshs:
                    recall[t] += int((best > t).sum())
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
    if result_dir is not None:
        result_dir = Path(result_dir)
        result_dir.mkdir(parents=True, exist_ok=True)
        with open(result_dir / 'result.pkl', 'wb') as f:
            pickle.dump(det_annos, f)
    ap_str, ap_dict = dataset.evaluation(det_annos, class_names)
    ap_dict['sec_per_sample'] = sec_per_sample
    ap_dict['occ_overflow'] = occ_overflow_total
    ap_dict['loader_ms_per_batch'] = loader_time * 1e3 / max(n_batches, 1)
    ap_dict['host_nms_ms_per_batch'] = nms_time * 1e3 / max(n_batches, 1)
    return ap_str, ap_dict
