"""Self-contained Waymo-style detection metrics: AP and APH at LEVEL_1 /
LEVEL_2 (the port's copy of ``tmae_tpu/datasets/waymo_eval.py``; on the
host).

The reference delegates to the TF ``waymo_open_dataset`` metrics module and the
external C++ ``compute_detection_metrics_main`` binary (``pcdet/datasets/
waymo_temporal/waymo_eval.py:9-12``, ``README.md:46``). This module
reimplements the metric semantics:

  * IoU thresholds: Vehicle 0.7, Pedestrian 0.5, Cyclist 0.5 (3D IoU: the
    native host ops by default, numpy with ``native=False``; both give the
    same AP).
  * LEVEL_1 = gt with > 5 lidar points; LEVEL_2 = all gt (L1 ⊆ L2).
  * AP: precision–recall curve from greedy best-score matching, sampled at the
    score thresholds that step recall uniformly (same sampler as the ONCE
    server), interendpoint max-interpolated.
  * APH: each true positive is weighted by its heading accuracy
    ``1 − |Δθ|/π`` (Δθ wrapped to [0, π]) — the official definition.

Exact numeric parity with the official binary requires the official tooling
(offline, via ``WaymoTemporalDataset.create_prediction_files``); this module is a
faithful reimplementation for in-framework evaluation.
"""

from __future__ import annotations

import numpy as np

from ..ops.geometry_np import boxes_iou3d
from .once_eval import get_thresholds

IOU_THRESH = {'Vehicle': 0.7, 'Pedestrian': 0.5, 'Cyclist': 0.5}
NUM_PR_POINTS = 50


def _heading_accuracy(h_gt, h_pred):
    d = np.abs(h_gt - h_pred) % (2 * np.pi)
    d = np.where(d > np.pi, 2 * np.pi - d, d)
    return 1.0 - d / np.pi


def _match_sample(iou, scores, gt_sel, pred_sel, h_gt, h_pred, iou_th,
                  score_th):
    """Greedy match at one score threshold → (tp, tp_heading_weight, fp, fn)."""
    num_gt, num_pred = iou.shape
    assigned = np.zeros(num_pred, bool)
    tp = fp = fn = 0
    tph = 0.0
    order = np.argsort(-scores)
    for i in range(num_gt):
        if not gt_sel[i]:
            continue
        best_j, best_iou = -1, iou_th
        for j in range(num_pred):
            if not pred_sel[j] or assigned[j] or scores[j] < score_th:
                continue
            if iou[i, j] > best_iou:
                best_iou = iou[i, j]
                best_j = j
        if best_j >= 0:
            assigned[best_j] = True
            tp += 1
            tph += _heading_accuracy(h_gt[i], h_pred[best_j])
        else:
            fn += 1
    for j in range(num_pred):
        if pred_sel[j] and not assigned[j] and scores[j] >= score_th:
            fp += 1
    return tp, tph, fp, fn


def waymo_evaluation(gt_annos, pred_annos, classes=('Vehicle', 'Pedestrian',
                                                    'Cyclist'),
                     native: bool = True):
    """gt_annos: per-frame {'name', 'boxes_3d' [N,7], optional
    'num_points_in_gt'}; pred_annos: {'name', 'score', 'boxes_3d'}.
    Returns (report string, {metric: value}); ``native=False`` computes the
    IoU in numpy."""
    assert len(gt_annos) == len(pred_annos)
    ious = []
    for g, p in zip(gt_annos, pred_annos):
        gb = np.asarray(g['boxes_3d'], np.float64).reshape(-1, 7)
        pb = np.asarray(p['boxes_3d'], np.float64).reshape(-1, 7)
        ious.append(
            boxes_iou3d(gb, pb, native=native) if len(gb) and len(pb)
            else np.zeros((len(gb), len(pb)))
        )

    results = {}
    lines = ['\n|Waymo AP/APH|LEVEL_1            |LEVEL_2            |',
             '|class       |AP      APH        |AP      APH        |']
    for cls in classes:
        row = [f'|{cls:<12}|']
        for level in (1, 2):
            # collect matched scores for threshold sampling
            accum_scores = []
            num_valid_gt = 0
            sels = []
            for si, (g, p) in enumerate(zip(gt_annos, pred_annos)):
                gname = np.asarray(g['name'])
                pname = np.asarray(p['name'])
                npts = np.asarray(
                    g.get('num_points_in_gt', np.full(len(gname), 100))
                )
                gt_sel = gname == cls
                if level == 1:
                    gt_sel = gt_sel & (npts > 5)
                pred_sel = pname == cls
                sels.append((gt_sel, pred_sel))
                num_valid_gt += int(gt_sel.sum())
                iou = ious[si]
                scores = np.asarray(p['score'], np.float64)
                # greedy best-score matching for threshold sampling
                assigned = np.zeros(len(pname), bool)
                for i in np.nonzero(gt_sel)[0]:
                    cand = [
                        (scores[j], j) for j in np.nonzero(pred_sel)[0]
                        if not assigned[j] and iou[i, j] > IOU_THRESH[cls]
                    ]
                    if cand:
                        s, j = max(cand)
                        assigned[j] = True
                        accum_scores.append(s)
            if num_valid_gt == 0:
                results[f'{cls}/L{level}/AP'] = 0.0
                results[f'{cls}/L{level}/APH'] = 0.0
                row.append('0.00    0.00       |')
                continue
            thresholds = get_thresholds(
                np.asarray(accum_scores), num_valid_gt, NUM_PR_POINTS
            )
            prec = np.zeros(NUM_PR_POINTS + 1)
            prec_h = np.zeros(NUM_PR_POINTS + 1)
            for ti, th in enumerate(thresholds[:NUM_PR_POINTS + 1]):
                TP = TPH = FP = FN = 0.0
                for si, (g, p) in enumerate(zip(gt_annos, pred_annos)):
                    gt_sel, pred_sel = sels[si]
                    gb = np.asarray(g['boxes_3d']).reshape(-1, 7)
                    pb = np.asarray(p['boxes_3d']).reshape(-1, 7)
                    tp, tph, fp, fn = _match_sample(
                        ious[si], np.asarray(p['score'], np.float64),
                        gt_sel, pred_sel,
                        gb[:, 6] if len(gb) else np.zeros(0),
                        pb[:, 6] if len(pb) else np.zeros(0),
                        IOU_THRESH[cls], th,
                    )
                    TP += tp
                    TPH += tph
                    FP += fp
                    FN += fn
                prec[ti] = TP / max(TP + FP, 1e-9)
                prec_h[ti] = TPH / max(TP + FP, 1e-9)
            for ti in range(len(prec)):
                prec[ti] = prec[ti:].max()
                prec_h[ti] = prec_h[ti:].max()
            ap = prec[1:].sum() / NUM_PR_POINTS * 100
            aph = prec_h[1:].sum() / NUM_PR_POINTS * 100
            results[f'{cls}/L{level}/AP'] = ap
            results[f'{cls}/L{level}/APH'] = aph
            row.append(f'{ap:<8.2f}{aph:<11.2f}|')
        lines.append(''.join(row))
    for level in (1, 2):
        results[f'mAP/L{level}'] = float(np.mean(
            [results[f'{c}/L{level}/AP'] for c in classes]))
        results[f'mAPH/L{level}'] = float(np.mean(
            [results[f'{c}/L{level}/APH'] for c in classes]))
    lines.append(
        f"|{'mAP/mAPH':<12}|{results['mAP/L1']:<8.2f}"
        f"{results['mAPH/L1']:<11.2f}|{results['mAP/L2']:<8.2f}"
        f"{results['mAPH/L2']:<11.2f}|"
    )
    return '\n'.join(lines) + '\n', results
