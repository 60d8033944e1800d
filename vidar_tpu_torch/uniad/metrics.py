"""UniAD evaluation metrics (host-side numpy accumulators).

Counterparts of the reference metric classes:
  * ``IntersectionOverUnion`` / ``PanopticMetric`` —
    UniAD/projects/mmdet3d_plugin/uniad/dense_heads/occ_head_plugin/
    metrics.py:14-260 (IoU and VPQ for occupancy flow).
  * ``PlanningMetric`` — planning_head_plugin/planning_metrics.py:15-160
    (L2 @ horizon + object / box collision rates on gt occupancy).
  * ``MotionMetric`` — motion minADE / minFDE / miss-rate / EPA
    aggregation (eval protocol of the UniAD paper; per-frame batched
    update mirrors motion_head.get_trajs + nuscenes eval).

These run on eval hosts over decoded predictions; no jit involvement, so
plain numpy keeps them simple and exact.

The port's own copy of ``vidar_tpu/uniad/metrics.py``
(numpy only), which the port may not import.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class IntersectionOverUnion:
    """Per-class IoU over binary/semantic occupancy (metrics.py:14-70)."""

    def __init__(self, n_classes: int, ignore_index: int = 255,
                 absent_score: float = 0.0):
        self.n_classes = n_classes
        self.ignore_index = ignore_index
        self.absent_score = absent_score
        self.tp = np.zeros(n_classes, np.float64)
        self.fp = np.zeros(n_classes, np.float64)
        self.fn = np.zeros(n_classes, np.float64)
        self.support = np.zeros(n_classes, np.float64)

    def update(self, pred: np.ndarray, target: np.ndarray):
        keep = target != self.ignore_index
        pred, target = pred[keep], target[keep]
        for c in range(self.n_classes):
            p = pred == c
            t = target == c
            self.tp[c] += np.logical_and(p, t).sum()
            self.fp[c] += np.logical_and(p, ~t).sum()
            self.fn[c] += np.logical_and(~p, t).sum()
            self.support[c] += t.sum()

    def compute(self) -> np.ndarray:
        denom = self.tp + self.fp + self.fn
        scores = np.where(denom > 0, self.tp / np.maximum(denom, 1),
                          self.absent_score)
        return scores


class PanopticMetric:
    """Video panoptic quality over instance occupancy
    (metrics.py:73-260)."""

    def __init__(self, n_classes: int = 2, temporally_consistent: bool = True):
        self.n_classes = n_classes
        self.temporally_consistent = temporally_consistent
        self.iou = np.zeros(n_classes, np.float64)
        self.tp = np.zeros(n_classes, np.float64)
        self.fp = np.zeros(n_classes, np.float64)
        self.fn = np.zeros(n_classes, np.float64)

    def update(self, pred_instance: np.ndarray, gt_instance: np.ndarray):
        """[T, H, W] int instance ids (0 = background) for one sample."""
        t = pred_instance.shape[0]
        consistent = {}
        for ti in range(t):
            self._update_frame(pred_instance[ti], gt_instance[ti],
                               consistent)

    def _update_frame(self, pred, gt, consistent):
        pred_ids = [i for i in np.unique(pred) if i != 0]
        gt_ids = [i for i in np.unique(gt) if i != 0]
        matched_gt = set()
        matched_pred = set()
        for pid in pred_ids:
            pm = pred == pid
            best_iou, best_gt = 0.0, None
            for gid in gt_ids:
                gm = gt == gid
                inter = np.logical_and(pm, gm).sum()
                union = np.logical_or(pm, gm).sum()
                iou = inter / max(union, 1)
                if iou > best_iou:
                    best_iou, best_gt = iou, gid
            ok = best_iou > 0.5 and best_gt is not None
            if ok and self.temporally_consistent:
                prev = consistent.get(best_gt)
                if prev is not None and prev != pid:
                    ok = False  # id switch counts as FP + FN
            if ok:
                consistent[best_gt] = pid
                self.tp[1] += 1
                self.iou[1] += best_iou
                matched_gt.add(best_gt)
                matched_pred.add(pid)
        self.fp[1] += len(pred_ids) - len(matched_pred)
        self.fn[1] += len(gt_ids) - len(matched_gt)
        # class 0: background IoU bookkeeping
        bg_inter = np.logical_and(pred == 0, gt == 0).sum()
        bg_union = np.logical_or(pred == 0, gt == 0).sum()
        self.iou[0] += bg_inter / max(bg_union, 1)
        self.tp[0] += 1

    def compute(self) -> Dict[str, np.ndarray]:
        denom = self.tp + 0.5 * self.fp + 0.5 * self.fn
        pq = np.where(denom > 0, self.iou / np.maximum(denom, 1e-9), 0.0)
        sq = np.where(self.tp > 0, self.iou / np.maximum(self.tp, 1e-9), 0.0)
        rq = np.where(denom > 0, self.tp / np.maximum(denom, 1e-9), 0.0)
        return dict(pq=pq, sq=sq, rq=rq, denominator=denom)


class PlanningMetric:
    """L2 + collision rates vs gt occupancy
    (planning_metrics.py:15-160, grid [-50, 50] x 0.5 m)."""

    W = 1.85
    H = 4.084

    def __init__(self, n_future: int = 6):
        self.n_future = n_future
        self.obj_col = np.zeros(n_future, np.float64)
        self.obj_box_col = np.zeros(n_future, np.float64)
        self.l2 = np.zeros(n_future, np.float64)
        self.total = 0
        self.dx = np.array([0.5, 0.5])
        self.bx = np.array([-50.0 + 0.25, -50.0 + 0.25])
        self.dim = (200, 200)

    def _box_pixels(self) -> np.ndarray:
        pts = np.array([
            [-self.H / 2.0 + 0.5, self.W / 2.0],
            [self.H / 2.0 + 0.5, self.W / 2.0],
            [self.H / 2.0 + 0.5, -self.W / 2.0],
            [-self.H / 2.0 + 0.5, -self.W / 2.0]])
        pts = (pts - self.bx) / self.dx
        pts = pts[:, ::-1]
        # integer raster of the convex quad (skimage.draw.polygon equivalent)
        rmin, rmax = int(pts[:, 1].min()), int(np.ceil(pts[:, 1].max()))
        cmin, cmax = int(pts[:, 0].min()), int(np.ceil(pts[:, 0].max()))
        rr, cc = np.meshgrid(np.arange(rmin, rmax + 1),
                             np.arange(cmin, cmax + 1), indexing='ij')
        return np.stack([rr.ravel(), cc.ravel()], -1)

    def _single_coll(self, traj: np.ndarray, seg: np.ndarray) -> np.ndarray:
        rc = self._box_pixels()
        t = traj.shape[0]
        tr = traj[:, ::-1] / self.dx
        pix = tr[:, None, :] + rc[None]
        r = np.clip(pix[..., 0].astype(np.int32), 0, self.dim[0] - 1)
        c = np.clip(pix[..., 1].astype(np.int32), 0, self.dim[1] - 1)
        out = np.zeros(t, bool)
        for ti in range(t):
            out[ti] = bool(seg[ti, r[ti], c[ti]].any())
        return out

    def update(self, trajs: np.ndarray, gt_trajs: np.ndarray,
               gt_mask: np.ndarray, segmentation: np.ndarray):
        """trajs/gt_trajs: [B, T, >=2]; segmentation: [B, T, H, W]."""
        trajs = trajs.copy()
        gt_trajs = gt_trajs.copy()
        trajs[..., 0] *= -1
        gt_trajs[..., 0] *= -1
        l2 = np.sqrt((((trajs[..., :2] - gt_trajs[..., :2]) ** 2) *
                      gt_mask[..., None]).sum(-1))
        self.l2 += l2.sum(0)
        b = trajs.shape[0]
        for i in range(b):
            gt_coll = self._single_coll(gt_trajs[i, :, :2], segmentation[i])
            yi = ((trajs[i, :, 1] - self.bx[0]) / self.dx[0]).astype(int)
            xi = ((trajs[i, :, 0] - self.bx[1]) / self.dx[1]).astype(int)
            ok = ((yi >= 0) & (yi < self.dim[0]) & (xi >= 0) &
                  (xi < self.dim[1]) & ~gt_coll)
            ti = np.arange(self.n_future)
            self.obj_col[ti[ok]] += segmentation[
                i, ti[ok], yi[ok], xi[ok]].astype(np.int64)
            box_coll = self._single_coll(trajs[i, :, :2], segmentation[i])
            m2 = ~gt_coll
            self.obj_box_col[ti[m2]] += box_coll[ti[m2]].astype(np.int64)
        self.total += b

    def compute(self) -> Dict[str, np.ndarray]:
        t = max(self.total, 1)
        return dict(obj_col=self.obj_col / t,
                    obj_box_col=self.obj_box_col / t,
                    L2=self.l2 / t)


class MotionMetric:
    """minADE / minFDE / miss rate / EPA accumulation over agents."""

    def __init__(self, dist_thresh: float = 2.0):
        self.dist_thresh = dist_thresh
        self.ade_sum = 0.0
        self.fde_sum = 0.0
        self.miss = 0.0
        self.hit = 0.0
        self.n_gt = 0.0
        self.n_pred = 0.0
        self.count = 0

    def update(self, trajs: np.ndarray, scores: np.ndarray,
               gt: np.ndarray, gt_valid: np.ndarray,
               agent_mask: Optional[np.ndarray] = None):
        """trajs [A, P, T, 2], scores [A, P], gt [A, T, 2], gt_valid [A, T]."""
        a = trajs.shape[0]
        mask = np.ones(a, bool) if agent_mask is None else agent_mask > 0
        for i in range(a):
            if not mask[i] or gt_valid[i].sum() == 0:
                continue
            v = gt_valid[i] > 0
            err = np.linalg.norm(trajs[i][:, v] - gt[i][v][None], axis=-1)
            ade = err.mean(-1).min()
            last = np.where(v)[0][-1]
            fde = np.linalg.norm(trajs[i][:, last] - gt[i][last],
                                 axis=-1).min()
            self.ade_sum += ade
            self.fde_sum += fde
            missed = fde > self.dist_thresh
            self.miss += float(missed)
            self.hit += float(not missed)
            self.n_gt += 1.0
            self.count += 1
        self.n_pred += float(mask.sum())

    def compute(self) -> Dict[str, float]:
        n = max(self.count, 1)
        fp = max(self.n_pred - self.n_gt, 0.0)
        epa = max(self.hit - 0.5 * fp, 0.0) / max(self.n_gt, 1.0)
        return dict(minADE=self.ade_sum / n, minFDE=self.fde_sum / n,
                    MR=self.miss / n, EPA=epa)
