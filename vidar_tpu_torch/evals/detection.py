"""nuScenes-protocol detection metrics: mAP (center-distance) + TP errors + NDS
(the port's own copy of vidar_tpu/evals/detection.py: plain numpy, so the
port imports nothing of the JAX package).

Devkit-free but devkit-faithful implementation of the evaluation the
reference runs through ``NuScenesEval_custom`` (reference
datasets/nuscnes_eval.py:507, a thin subclass of the official nuScenes
eval).  Protocol semantics reproduced from the official devkit:

* per-class AP at center-distance thresholds {0.5, 1, 2, 4} m with the
  101-point recall interpolation, clipped at min recall 0.1 / min
  precision 0.1 (devkit ``calc_ap``);
* true-positive errors (ATE/ASE/AOE/AVE/AAE) at the 2 m threshold as
  *cumulative means interpolated on the recall grid*, averaged over the
  [0.1, max_recall] band (devkit ``accumulate``+``calc_tp``), NOT a plain
  mean over matches;
* class exclusions: traffic_cone has no AOE/AVE/AAE, barrier no AVE/AAE;
  barrier orientation error uses period pi (devkit ``yaw_diff`` period);
* AAE = 1 - attribute classification accuracy; ground-truth boxes without
  an attribute are skipped (devkit ``attr_acc`` returns nan);
* NDS = (5*mAP + sum_5 (1 - min(1, tp_err))) / 10 with the raw
  (un-normalized) errors — orientation error in radians is clamped by the
  min, not divided by pi.

Operates on plain numpy dicts:
  prediction: {sample_token: {boxes [N,9], scores [N], labels [N],
               (optional) attrs [N] attribute-name strings}}
  ground truth: {sample_token: {boxes [M,9], labels [M], (optional)
                 attrs [M] attribute-name strings ('' = none)}}
Box layout: (cx, cy, cz, w, l, h, yaw, vx, vy).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
N_RECALL = 101
_FIRST_IND = int(round(100 * MIN_RECALL)) + 1  # devkit calc_tp first index

# devkit-style per-class TP-metric exclusions
_NO_ORIENT = ('traffic_cone',)
_NO_VEL = ('traffic_cone', 'barrier')
_NO_ATTR = ('traffic_cone', 'barrier')

# mmdet3d NuScenesDataset.DefaultAttribute (reference
# UniAD/projects/mmdet3d_plugin/datasets/nuscenes_e2e_dataset.py:770-791
# uses it via the speed heuristic reimplemented in infer_attributes)
DEFAULT_ATTRIBUTE = {
    'car': 'vehicle.parked',
    'pedestrian': 'pedestrian.moving',
    'trailer': 'vehicle.parked',
    'truck': 'vehicle.parked',
    'bus': 'vehicle.moving',
    'motorcycle': 'cycle.without_rider',
    'construction_vehicle': 'vehicle.parked',
    'bicycle': 'cycle.without_rider',
    'barrier': '',
    'traffic_cone': '',
}


def infer_attributes(boxes: np.ndarray, labels: np.ndarray,
                     class_names: Sequence[str]) -> np.ndarray:
    """Predicted attribute names from class + speed (the reference's
    submission heuristic, nuscenes_e2e_dataset.py:770-791)."""
    boxes = np.asarray(boxes)
    labels = np.asarray(labels)
    out = []
    for box, lab in zip(boxes.reshape(-1, boxes.shape[-1]), labels.reshape(-1)):
        name = class_names[int(lab)] if 0 <= int(lab) < len(class_names) \
            else ''
        speed = float(np.hypot(box[7], box[8])) if box.shape[0] >= 9 else 0.0
        if speed > 0.2:
            if name in ('car', 'construction_vehicle', 'bus', 'truck',
                        'trailer'):
                attr = 'vehicle.moving'
            elif name in ('bicycle', 'motorcycle'):
                attr = 'cycle.with_rider'
            else:
                attr = DEFAULT_ATTRIBUTE.get(name, '')
        else:
            if name == 'pedestrian':
                attr = 'pedestrian.standing'
            elif name == 'bus':
                attr = 'vehicle.stopped'
            else:
                attr = DEFAULT_ATTRIBUTE.get(name, '')
        out.append(attr)
    return np.asarray(out)


def _yaw_diff(a, b, period=2 * np.pi):
    d = np.abs(a - b) % period
    return min(d, period - d)


def _scale_iou(pred, gt):
    """devkit scale_iou: IoU after aligning translation and yaw —
    reduces to the size-only intersection of the aligned boxes."""
    inter = np.prod(np.minimum(pred[3:6], gt[3:6]))
    union = np.prod(pred[3:6]) + np.prod(gt[3:6]) - inter
    return inter / max(union, 1e-12)


def _cummean(x: np.ndarray) -> np.ndarray:
    """Cumulative mean ignoring NaNs (devkit common.utils.cummean:
    all-nan input -> ones; zero before the first valid value)."""
    if len(x) and np.isnan(x).all():
        return np.ones(len(x))
    ok = ~np.isnan(x)
    cnt = np.cumsum(ok)
    s = np.cumsum(np.where(ok, x, 0.0))
    return np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0)


def _accumulate_class(preds, gts, gt_attrs, dist_th: float, period: float):
    """Match one class at one distance threshold (devkit ``accumulate``).

    preds: list of (score, box, attr, token); gts: {token: [boxes]};
    gt_attrs: {token: [attr or None]}.
    Returns (tp flags sorted by score desc, confs, n_pos, per-TP error
    dict with parallel 'rec' recall-at-match positions).
    """
    n_pos = sum(len(v) for v in gts.values())
    order = sorted(range(len(preds)), key=lambda i: -preds[i][0])
    taken = defaultdict(set)
    tp = np.zeros(len(order), bool)
    conf = np.zeros(len(order))
    errs = dict(trans=[], scale=[], orient=[], vel=[], attr=[])
    for rank, i in enumerate(order):
        score, box, attr, token = preds[i]
        conf[rank] = score
        gt_boxes = gts.get(token, [])
        best, best_d = -1, dist_th
        for gi, gb in enumerate(gt_boxes):
            if gi in taken[token]:
                continue
            d = np.linalg.norm(box[:2] - gb[:2])
            if d < best_d:
                best, best_d = gi, d
        if best >= 0:
            taken[token].add(best)
            tp[rank] = True
            gb = gt_boxes[best]
            errs['trans'].append(best_d)
            errs['scale'].append(1.0 - _scale_iou(box, gb))
            errs['orient'].append(_yaw_diff(box[6], gb[6], period))
            errs['vel'].append(float(np.linalg.norm(box[7:9] - gb[7:9])))
            ga = gt_attrs.get(token)
            ga = ga[best] if ga is not None and best < len(ga) else None
            if ga is None or attr is None or ga == '':
                errs['attr'].append(np.nan)  # devkit attr_acc -> nan
            else:
                errs['attr'].append(0.0 if ga == attr else 1.0)
    return tp, conf, n_pos, errs


def _interp_metrics(tp, conf, n_pos, errs):
    """Devkit ``accumulate`` tail: precision/recall + cummean'd TP errors
    interpolated on the 101-point recall grid."""
    rec_interp = np.linspace(0, 1, N_RECALL)
    if n_pos == 0 or len(tp) == 0 or not tp.any():
        zeros = np.zeros(N_RECALL)
        ones = np.ones(N_RECALL)
        return dict(precision=zeros, last_ind=-1,
                    trans=ones, scale=ones, orient=ones, vel=ones,
                    attr=ones)
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    prec = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    rec = cum_tp / n_pos
    out = dict(precision=np.interp(rec_interp, rec, prec, right=0),
               last_ind=int(np.floor(100 * rec.max())))
    # devkit interpolates each cummean'd error as a function of recall
    # (via the confidence grid; monotone conf<->recall makes recall the
    # equivalent abscissa)
    tp_rec = rec[tp]
    for k in ('trans', 'scale', 'orient', 'vel', 'attr'):
        cm = _cummean(np.asarray(errs[k], dtype=float))
        out[k] = np.interp(rec_interp, tp_rec, cm,
                           left=cm[0] if len(cm) else 1.0,
                           right=cm[-1] if len(cm) else 1.0)
    return out


def _calc_ap(md) -> float:
    prec = md['precision'][_FIRST_IND:].copy()
    prec -= MIN_PRECISION
    np.clip(prec, 0, None, out=prec)
    return float(np.mean(prec)) / (1.0 - MIN_PRECISION)


def _calc_tp(md, key) -> float:
    last = md['last_ind']
    if last < _FIRST_IND:
        return 1.0
    return float(np.mean(md[key][_FIRST_IND:last + 1]))


def evaluate_detection(predictions: Dict, ground_truth: Dict,
                       class_names: Sequence[str]) -> Dict[str, float]:
    """Compute per-class AP, TP errors, mAP and NDS (devkit protocol)."""
    metrics: Dict[str, float] = {}
    aps = []
    tp_errs = {k: [] for k in ('trans', 'scale', 'orient', 'vel', 'attr')}
    has_attrs = any('attrs' in g for g in ground_truth.values())
    for ci, cname in enumerate(class_names):
        preds = []
        for token, p in predictions.items():
            sel = np.asarray(p['labels']) == ci
            attrs = np.asarray(p['attrs'])[sel] if 'attrs' in p else \
                [None] * int(sel.sum())
            for b, s, a in zip(np.asarray(p['boxes'])[sel],
                               np.asarray(p['scores'])[sel], attrs):
                preds.append((float(s), b, a, token))
        gts, gattrs = {}, {}
        for token, g in ground_truth.items():
            sel = np.asarray(g['labels']) == ci
            gts[token] = list(np.asarray(g['boxes'])[sel])
            if 'attrs' in g:
                gattrs[token] = list(np.asarray(g['attrs'])[sel])

        period = np.pi if cname == 'barrier' else 2 * np.pi
        class_aps = []
        for th in DIST_THRESHOLDS:
            tp, conf, n_pos, errs = _accumulate_class(
                preds, gts, gattrs, th, period)
            md = _interp_metrics(tp, conf, n_pos, errs)
            class_aps.append(_calc_ap(md))
            if th == TP_THRESHOLD:
                if cname not in _NO_ORIENT:
                    tp_errs['orient'].append(_calc_tp(md, 'orient'))
                if cname not in _NO_VEL:
                    tp_errs['vel'].append(_calc_tp(md, 'vel'))
                if cname not in _NO_ATTR and has_attrs:
                    tp_errs['attr'].append(_calc_tp(md, 'attr'))
                tp_errs['trans'].append(_calc_tp(md, 'trans'))
                tp_errs['scale'].append(_calc_tp(md, 'scale'))
        ap = float(np.mean(class_aps))
        metrics[f'AP_{cname}'] = ap
        aps.append(ap)

    m_ap = float(np.mean(aps)) if aps else 0.0
    metrics['mAP'] = m_ap
    tp_scores = []
    for k, name in (('trans', 'mATE'), ('scale', 'mASE'),
                    ('orient', 'mAOE'), ('vel', 'mAVE'), ('attr', 'mAAE')):
        err = float(np.mean(tp_errs[k])) if tp_errs[k] else 1.0
        metrics[name] = err
        tp_scores.append(max(0.0, 1.0 - min(1.0, err)))
    nds = (5.0 * m_ap + sum(tp_scores)) / 10.0
    metrics['NDS'] = float(nds)
    return metrics
