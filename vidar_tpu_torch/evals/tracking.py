"""Devkit-free nuScenes tracking evaluation (AMOTA / AMOTP family).

Capability match for the reference's ``TrackingEval`` call (reference
UniAD/projects/mmdet3d_plugin/datasets/nuscenes_e2e_dataset.py:1161-1181,
which shells out to the nuScenes devkit's ``tracking_nips_2019`` protocol).
Re-implemented on numpy/scipy following the published protocol
(Weng & Kitani AB3DMOT metrics as adopted by nuScenes):

* per class, sweep ``num_thresholds`` recall points; at each point pick the
  score threshold achieving that recall, run a full MOT pass and compute
    MOTAR = max(0, 1 - (IDS + FP + FN - (1 - r) * P) / (r * P))
    MOTP  = mean matched center distance
* AMOTA / AMOTP = mean over achieved recall points;
* frame-level matching defaults to ``'motmetrics'``: the py-motmetrics
  ``MOTAccumulator.update`` convention the devkit tracking eval actually
  runs (nuscenes-devkit ``tracking/algo.py`` feeds a gated distance matrix
  into motmetrics) — correspondences from the previous frame are re-used
  first when still inside the gate (match-continuity preference), then the
  remaining pairs get an optimal LAP assignment. ``matcher='greedy'``
  (score-ordered, the devkit DETECTION eval convention from
  ``detection/algo.py``) and ``matcher='hungarian'`` (plain LAP, no
  continuity preference) are available for comparison.

Inputs mirror ``evals.detection``: dicts keyed by sample token, samples
ordered in time, each with a ``scene`` key so tracks reset per scene.

The port's own copy of ``vidar_tpu/evals/tracking.py``
(numpy only), which the port may not import.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _frame_match_hungarian(pred_xy, gt_xy, dist_th):
    """Hungarian match under a distance gate -> list of (pi, gi, dist)."""
    if not len(pred_xy) or not len(gt_xy):
        return []
    cost = np.linalg.norm(pred_xy[:, None] - gt_xy[None], axis=-1)
    try:
        from scipy.optimize import linear_sum_assignment
        ri, ci = linear_sum_assignment(np.minimum(cost, dist_th * 10))
    except Exception:                                   # pragma: no cover
        ri = np.arange(min(len(pred_xy), len(gt_xy)))
        ci = cost[ri].argmin(axis=1)
    return [(int(i), int(j), float(cost[i, j]))
            for i, j in zip(ri, ci) if cost[i, j] <= dist_th]


def _frame_match_greedy(pred_xy, gt_xy, pred_score, dist_th):
    """Devkit-style greedy match: predictions in descending score order,
    each taking its nearest still-unmatched gt within the gate."""
    if not len(pred_xy) or not len(gt_xy):
        return []
    cost = np.linalg.norm(pred_xy[:, None] - gt_xy[None], axis=-1)
    taken = np.zeros(len(gt_xy), bool)
    out = []
    for pi in np.argsort(-np.asarray(pred_score), kind='stable'):
        row = np.where(taken, np.inf, cost[pi])
        gi = int(row.argmin())
        if row[gi] <= dist_th:
            taken[gi] = True
            out.append((int(pi), gi, float(cost[pi, gi])))
    return out


def _frame_match_motmetrics(pred_xy, gt_xy, pred_tid, gt_tid, last_tid,
                            dist_th):
    """py-motmetrics ``MOTAccumulator.update`` matching order: re-establish
    previous-frame correspondences still inside the gate, then LAP-assign
    the rest. ``last_tid``: gt track id -> last matched pred track id
    (persistent across frames, like the accumulator's ``self.m``)."""
    if not len(pred_xy) or not len(gt_xy):
        return []
    cost = np.linalg.norm(pred_xy[:, None] - gt_xy[None], axis=-1)
    p_used = np.zeros(len(pred_xy), bool)
    g_used = np.zeros(len(gt_xy), bool)
    out = []
    pid_of = {int(t): i for i, t in enumerate(pred_tid)}
    for gi, gt in enumerate(gt_tid):
        prev = last_tid.get(int(gt))
        if prev is None or prev not in pid_of:
            continue
        pi = pid_of[prev]
        if not p_used[pi] and cost[pi, gi] <= dist_th:
            p_used[pi] = True
            g_used[gi] = True
            out.append((pi, gi, float(cost[pi, gi])))
    pr = np.where(~p_used)[0]
    gr = np.where(~g_used)[0]
    if len(pr) and len(gr):
        for pi, gi, d in _frame_match_hungarian(pred_xy[pr], gt_xy[gr],
                                                dist_th):
            out.append((int(pr[pi]), int(gr[gi]), d))
    return out


def _frame_match(pred_xy, gt_xy, pred_score, dist_th, matcher,
                 pred_tid=None, gt_tid=None, last_tid=None):
    if matcher == 'motmetrics':
        return _frame_match_motmetrics(pred_xy, gt_xy, pred_tid, gt_tid,
                                       last_tid or {}, dist_th)
    if matcher == 'greedy':
        return _frame_match_greedy(pred_xy, gt_xy, pred_score, dist_th)
    assert matcher == 'hungarian', matcher
    return _frame_match_hungarian(pred_xy, gt_xy, dist_th)


def _mot_pass(frames: List[dict], score_th: float, dist_th: float,
              matcher: str = 'motmetrics'):
    """One MOT accounting pass at a fixed score threshold.

    frames: per-frame dicts with pred_xy/pred_score/pred_tid and
    gt_xy/gt_tid (already class-filtered, scene-segmented).
    Returns dict(tp, fp, fn, ids, dist_sum).
    """
    tp = fp = fn = ids = 0
    dist_sum = 0.0
    last_tid: Dict[int, int] = {}    # gt track id -> last matched pred tid
    for fr in frames:
        keep = fr['pred_score'] >= score_th
        p_xy = fr['pred_xy'][keep]
        p_tid = fr['pred_tid'][keep]
        matches = _frame_match(p_xy, fr['gt_xy'], fr['pred_score'][keep],
                               dist_th, matcher, pred_tid=p_tid,
                               gt_tid=fr['gt_tid'], last_tid=last_tid)
        matched_p = {m[0] for m in matches}
        matched_g = {m[1] for m in matches}
        tp += len(matches)
        fp += len(p_xy) - len(matched_p)
        fn += len(fr['gt_xy']) - len(matched_g)
        for pi, gi, d in matches:
            dist_sum += d
            g = int(fr['gt_tid'][gi])
            p = int(p_tid[pi])
            if g in last_tid and last_tid[g] != p:
                ids += 1
            last_tid[g] = p
    return dict(tp=tp, fp=fp, fn=fn, ids=ids, dist_sum=dist_sum)


def evaluate_tracking(predictions: Dict[str, dict],
                      ground_truth: Dict[str, dict],
                      classes: Sequence[str],
                      dist_th: float = 2.0,
                      num_thresholds: int = 40,
                      matcher: str = 'motmetrics') -> Dict[str, float]:
    """AMOTA/AMOTP over per-sample tracked boxes.

    predictions[token]: dict(boxes [N,>=2] (xy first), scores [N],
      labels [N], track_ids [N]).
    ground_truth[token]: dict(boxes [M,>=2], labels [M], track_ids [M],
      scene (str)).
    Tokens must iterate in temporal order (python dicts preserve it).
    matcher: 'motmetrics' (devkit tracking-eval parity: continuity-
    preferred optimal assignment, default), 'greedy' (detection-eval
    convention) or 'hungarian' (plain LAP).
    """
    per_class_amota, per_class_amotp, per_class_recall = {}, {}, {}
    totals = dict(tp=0, fp=0, fn=0, ids=0)

    for ci, cname in enumerate(classes):
        # scene-segmented frame lists
        frames_by_scene: Dict[str, List[dict]] = {}
        all_scores = []
        total_gt = 0
        for tok, gt in ground_truth.items():
            pred = predictions.get(tok, dict(
                boxes=np.zeros((0, 2)), scores=np.zeros((0,)),
                labels=np.zeros((0,), np.int64),
                track_ids=np.zeros((0,), np.int64)))
            pm = np.asarray(pred['labels']) == ci
            gm = np.asarray(gt['labels']) == ci
            fr = dict(
                pred_xy=np.asarray(pred['boxes'])[pm][:, :2],
                pred_score=np.asarray(pred['scores'])[pm],
                pred_tid=np.asarray(pred['track_ids'])[pm],
                gt_xy=np.asarray(gt['boxes'])[gm][:, :2],
                gt_tid=np.asarray(gt['track_ids'])[gm])
            frames_by_scene.setdefault(gt.get('scene', 's0'), []).append(fr)
            all_scores.extend(fr['pred_score'].tolist())
            total_gt += int(gm.sum())
        if total_gt == 0:
            continue

        # recall sweep (nuScenes: thresholds from the sorted score list
        # hitting each recall level)
        motar_list, motp_list, recall_list = [], [], []
        best = None
        for r in np.linspace(0.1, 1.0, num_thresholds):
            # find score threshold reaching recall r (match-based recall
            # requires a pass; use score-quantile seeding like AB3DMOT)
            if not all_scores:
                break
            th = float(np.quantile(all_scores, 1.0 - r)) \
                if len(all_scores) else 0.0
            stats = dict(tp=0, fp=0, fn=0, ids=0, dist_sum=0.0)
            for frames in frames_by_scene.values():
                s = _mot_pass(frames, th, dist_th, matcher)
                for k in stats:
                    stats[k] += s[k]
            recall = stats['tp'] / max(total_gt, 1)
            if recall <= 0:
                continue
            motar = max(0.0, 1.0 - (stats['ids'] + stats['fp'] +
                                    stats['fn'] - (1 - recall) * total_gt)
                        / max(recall * total_gt, 1e-9))
            motar_list.append(motar)
            motp_list.append(stats['dist_sum'] / max(stats['tp'], 1))
            recall_list.append(recall)
            if best is None or recall > best[0]:
                best = (recall, stats)

        if motar_list:
            per_class_amota[cname] = float(np.mean(motar_list))
            per_class_amotp[cname] = float(np.mean(motp_list))
            per_class_recall[cname] = float(np.max(recall_list))
        else:
            per_class_amota[cname] = 0.0
            per_class_amotp[cname] = dist_th
            per_class_recall[cname] = 0.0
        if best is not None:
            for k in totals:
                totals[k] += best[1][k]

    if not per_class_amota:
        return dict(amota=0.0, amotp=float(dist_th), recall=0.0,
                    tp=0, fp=0, fn=0, ids=0)
    out = dict(
        amota=float(np.mean(list(per_class_amota.values()))),
        amotp=float(np.mean(list(per_class_amotp.values()))),
        recall=float(np.mean(list(per_class_recall.values()))),
        **{k: int(v) for k, v in totals.items()})
    for c in per_class_amota:
        out[f'amota_{c}'] = per_class_amota[c]
    return out
