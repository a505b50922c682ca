"""ONCE benchmark AP evaluation (the port's copy of
``tmae_tpu/datasets/once_eval.py``; on the host).

The official ONCE protocol: superclass merge (Car/Bus/Truck → Vehicle),
per-class IoU thresholds 0.7/0.3/0.5, heading-aware 3D IoU, 50-point PR
sampling, difficulties overall / 0-30m / 30-50m / 50m-inf. The IoU and the
two matching loops run in the native host ops by default; the numpy loops
``accumulate_scores`` / ``compute_statistics`` and the numpy IoU are the
plain versions (``native=False``).

Annotation dicts: {'name': [N] str array, 'score': [N] (preds only),
'boxes_3d': [N, 7]}.
"""

from __future__ import annotations

import numpy as np

from ..ops.geometry_np import boxes_iou3d, boxes_iou3d_with_heading
from ..utils import native as host

IOU_THRESHOLD_DICT = {
    'Car': 0.7, 'Bus': 0.7, 'Truck': 0.7, 'Pedestrian': 0.3, 'Cyclist': 0.5,
}
SUPERCLASS_IOU_THRESHOLD_DICT = {
    'Vehicle': 0.7, 'Pedestrian': 0.3, 'Cyclist': 0.5,
}


def get_thresholds(scores: np.ndarray, num_gt: int, num_pr_points: int):
    """Score thresholds at ~uniform recall steps."""
    eps = 1e-6
    scores = np.sort(scores)[::-1]
    recall_level = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if (r_recall + l_recall < 2 * recall_level) and i < len(scores) - 1:
            continue
        thresholds.append(score)
        recall_level += 1 / num_pr_points
        while r_recall + l_recall + eps > 2 * recall_level:
            thresholds.append(score)
            recall_level += 1 / num_pr_points
    return thresholds


def accumulate_scores(iou, pred_scores, gt_flag, pred_flag, iou_threshold):
    """Greedy best-score matching per GT (numpy; the plain version of
    ``utils/native.accumulate_scores``)."""
    num_gt, num_pred = iou.shape
    assigned = np.zeros(num_pred, bool)
    accum = []
    for i in range(num_gt):
        if gt_flag[i] == -1:
            continue
        det_idx = -1
        detected_score = -1.0
        for j in range(num_pred):
            if pred_flag[j] == -1 or assigned[j]:
                continue
            if iou[i, j] > iou_threshold and pred_scores[j] > detected_score:
                det_idx = j
                detected_score = pred_scores[j]
        if detected_score == -1 and gt_flag[i] == 0:
            pass
        elif detected_score != -1 and (gt_flag[i] == 1 or pred_flag[det_idx] == 1):
            assigned[det_idx] = True
        elif detected_score != -1:
            accum.append(pred_scores[det_idx])
            assigned[det_idx] = True
    return np.asarray(accum)


def compute_statistics(iou, pred_scores, gt_flag, pred_flag, score_threshold,
                       iou_threshold):
    """TP/FP/FN at one score threshold (numpy; the plain version of
    ``utils/native.compute_statistics_all``)."""
    num_gt, num_pred = iou.shape
    assigned = np.zeros(num_pred, bool)
    under = pred_scores < score_threshold
    tp = fp = fn = 0
    for i in range(num_gt):
        if gt_flag[i] == -1:
            continue
        det_idx = -1
        detected = False
        best_iou = 0.0
        gt_to_ignore = False
        for j in range(num_pred):
            if pred_flag[j] == -1 or assigned[j] or under[j]:
                continue
            iou_ij = iou[i, j]
            if iou_ij > iou_threshold and (
                iou_ij > best_iou or gt_to_ignore
            ) and pred_flag[j] == 0:
                best_iou = iou_ij
                det_idx = j
                detected = True
                gt_to_ignore = False
            elif iou_ij > iou_threshold and (not detected) and pred_flag[j] == 1:
                det_idx = j
                detected = True
                gt_to_ignore = True
        if (not detected) and gt_flag[i] == 0:
            fn += 1
        elif detected and (gt_flag[i] == 1 or pred_flag[det_idx] == 1):
            assigned[det_idx] = True
        elif detected:
            tp += 1
            assigned[det_idx] = True
    for j in range(num_pred):
        if not (assigned[j] or pred_flag[j] == -1 or pred_flag[j] == 1 or under[j]):
            fp += 1
    return tp, fp, fn


def _class_flags(names, boxes, class_name, use_superclass, difficulty_mode,
                 difficulty_level):
    n = len(names)
    flag = np.zeros(n, np.int64)
    if use_superclass and class_name == 'Vehicle':
        reject = np.logical_or(names == 'Pedestrian', names == 'Cyclist')
    else:
        reject = names != class_name
    flag[reject] = -1
    # difficulty filters (eval_utils.py:13-49)
    if len(boxes):
        dist = np.sqrt(np.sum(boxes[:, 0:3] ** 2, axis=1))
    else:
        dist = np.zeros((0,))
    if difficulty_mode == 'Overall&Distance':
        ignore = np.ones(n, bool)
        if difficulty_level == 0:
            ignore[:] = False
        elif difficulty_level == 1:
            ignore[dist < 30] = False
        elif difficulty_level == 2:
            ignore[(dist >= 30) & (dist < 50)] = False
        else:
            ignore[dist >= 50] = False
        flag[ignore & (flag == 0)] = 1
    return flag


def get_evaluation_results(gt_annos, pred_annos, classes, use_superclass=True,
                           iou_thresholds=None, num_pr_points=50,
                           difficulty_mode='Overall&Distance',
                           ap_with_heading=True, native: bool = True):
    """Returns (result string, {AP_<cls>/<difficulty>: value} dict).
    ``native=False`` runs the IoU and the matching loops in numpy."""
    if iou_thresholds is None:
        iou_thresholds = (
            SUPERCLASS_IOU_THRESHOLD_DICT if use_superclass else IOU_THRESHOLD_DICT
        )
    assert len(gt_annos) == len(pred_annos)
    classes = list(classes)
    if use_superclass:
        if ('Car' in classes) or ('Bus' in classes) or ('Truck' in classes):
            assert {'Car', 'Bus', 'Truck'} <= set(classes)
        classes = [c for c in classes if c not in ('Car', 'Bus', 'Truck')]
        classes.insert(0, 'Vehicle')

    num_samples = len(gt_annos)
    iou_fn = boxes_iou3d_with_heading if ap_with_heading else boxes_iou3d
    ious = []
    for g, p in zip(gt_annos, pred_annos):
        gb = np.asarray(g['boxes_3d'], np.float64).reshape(-1, 7)
        pb = np.asarray(p['boxes_3d'], np.float64).reshape(-1, 7)
        ious.append(iou_fn(gb, pb, native=native) if len(gb) and len(pb)
                    else np.zeros((len(gb), len(pb))))

    if difficulty_mode == 'Overall&Distance':
        difficulty_types = ['overall', '0-30m', '30-50m', '50m-inf']
    elif difficulty_mode == 'Overall':
        difficulty_types = ['overall']
    else:
        difficulty_types = ['0-30m', '30-50m', '50m-inf']
    num_difficulties = len(difficulty_types)

    num_classes = len(classes)
    precision = np.zeros([num_classes, num_difficulties, num_pr_points + 1])
    recall = np.zeros([num_classes, num_difficulties, num_pr_points + 1])

    for ci, cls in enumerate(classes):
        iou_th = iou_thresholds[cls]
        for di in range(num_difficulties):
            gt_flags, pred_flags, accum_all = [], [], []
            num_valid_gt = 0
            for si in range(num_samples):
                g, p = gt_annos[si], pred_annos[si]
                gname = np.asarray(g['name'])
                pname = np.asarray(p['name'])
                gflag = _class_flags(gname, np.asarray(g['boxes_3d']).reshape(-1, 7),
                                     cls, use_superclass, difficulty_mode, di)
                pflag = _class_flags(pname, np.asarray(p['boxes_3d']).reshape(-1, 7),
                                     cls, use_superclass, difficulty_mode, di)
                gt_flags.append(gflag)
                pred_flags.append(pflag)
                num_valid_gt += int((gflag == 0).sum())
                scores_si = np.asarray(p['score'], np.float64)
                acc = (host.accumulate_scores if native
                       else accumulate_scores)
                accum_all.append(acc(ious[si], scores_si, gflag, pflag,
                                     iou_th))
            all_scores = np.concatenate(accum_all) if accum_all else np.zeros(0)
            if num_valid_gt == 0:
                continue
            thresholds = get_thresholds(all_scores.copy(), num_valid_gt,
                                        num_pr_points)
            confusion = np.zeros([len(thresholds), 3])
            th_arr = np.asarray(thresholds, np.float64)
            for si in range(num_samples):
                p = pred_annos[si]
                scores_si = np.asarray(p['score'], np.float64)
                if native:
                    confusion += host.compute_statistics_all(
                        ious[si], scores_si, gt_flags[si], pred_flags[si],
                        th_arr, iou_th,
                    )
                    continue
                for ti, th in enumerate(thresholds):
                    tp, fp, fn = compute_statistics(
                        ious[si], scores_si, gt_flags[si],
                        pred_flags[si], score_threshold=th, iou_threshold=iou_th,
                    )
                    confusion[ti, 0] += tp
                    confusion[ti, 1] += fp
                    confusion[ti, 2] += fn
            for ti in range(len(thresholds)):
                rec = confusion[ti, 0] / max(confusion[ti, 0] + confusion[ti, 2], 1e-9)
                prec = confusion[ti, 0] / max(confusion[ti, 0] + confusion[ti, 1], 1e-9)
                recall[ci, di, ti] = rec
                precision[ci, di, ti] = prec
            for ti in range(len(thresholds)):
                precision[ci, di, ti] = np.max(precision[ci, di, ti:], axis=-1)
                recall[ci, di, ti] = np.max(recall[ci, di, ti:], axis=-1)

    AP = precision[..., 1:].sum(-1) / num_pr_points * 100

    ret_dict = {}
    ret_str = "\n|AP@%-9s|" % (str(num_pr_points))
    for dt in difficulty_types:
        ret_str += '%-12s|' % dt
    ret_str += '\n'
    for ci, cls in enumerate(classes):
        ret_str += "|%-12s|" % cls
        for di, dt in enumerate(difficulty_types):
            ret_dict[f'AP_{cls}/{dt}'] = AP[ci, di]
            ret_str += "%-12.2f|" % AP[ci, di]
        ret_str += "\n"
    mAP = np.mean(AP, axis=0)
    ret_str += "|%-12s|" % 'mAP'
    for di, dt in enumerate(difficulty_types):
        ret_dict[f'AP_mean/{dt}'] = mAP[di]
        ret_str += "%-12.2f|" % mAP[di]
    ret_str += "\n"
    return ret_str, ret_dict
