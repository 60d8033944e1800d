"""UniAD end-to-end training dataset (nuScenes).

The reference generates UniAD's multi-task ground truth with its own
converter (`UniAD/tools/uniad_create_data.sh`: track ids, future agent
trajectories, occupancy flows, planning trajectories). Here the same
targets are derived on the fly from the standard infos pkl:

- track/detection gt: the DetDataset arrays (+ stable track slots);
- motion gt: per-instance future centers, matched across scene frames by
  ``gt_instance_tokens`` (written by our converter; reference pkls without
  tokens fall back to nearest-center matching under 2 m/frame);
- occupancy gt: future agent boxes rasterized to BEV instance masks;
- planning gt: ego future positions/yaw in the current lidar frame, with
  the driving command derived from the lateral displacement at horizon
  (reference command convention: 0=right, 1=left, 2=straight);
- map gt: the reference extracts lane elements from the nuScenes map
  expansion; pass ``map_ann_file`` (pkl: token -> {boxes[N,4] cxcywh,
  labels[N]}) to supervise the seg head, else map targets are empty and
  the map loss sees zero valid gt.

Each sample is ``(frames, UniADTargets, command)``: the tuple that
``train.step.UniADTrainStep`` consumes, its tensors built from numpy on the
CPU. The port of vidar_tpu/data/uniad_data.py.
"""

from __future__ import annotations

import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from ..uniad.loss import UniADTargets
from .nuscenes import NuScenesDetDataset
from .geometry import transform_matrix


class UniADDataset(NuScenesDetDataset):
    def __init__(self, ann_file: str, predict_steps: int = 12,
                 planning_steps: int = 6, occ_n_future: int = 4,
                 occ_size: Optional[Tuple[int, int]] = None,
                 max_map_gt: int = 32, map_ann_file: Optional[str] = None,
                 **kwargs):
        # clip training replays the image window frame-by-frame; a random
        # temporal stride would desync the recomputed per-frame gt below
        kwargs['rand_frame_interval'] = (1,)
        super().__init__(ann_file, **kwargs)
        self._inst_ids: dict = {}
        self.predict_steps = predict_steps
        self.planning_steps = planning_steps
        self.occ_n_future = occ_n_future
        # OccHead emits instance logits on the full encoder BEV grid
        # ([B, Q, T, bev_h, bev_w]); the gt raster must match or the
        # fiery/dice losses fail to broadcast.
        self.occ_size = tuple(occ_size) if occ_size else tuple(self.bev_size)
        self.max_map_gt = max_map_gt
        self.map_anns = None
        if map_ann_file:
            with open(map_ann_file, 'rb') as f:
                self.map_anns = pickle.load(f)

    # -- helpers ----------------------------------------------------------

    def _future_frame_indices(self, idx0: int, n: int):
        """Up to n following data_infos indices within the same scene."""
        scene = self.data_infos[idx0]['scene_token']
        out = []
        j = idx0
        while len(out) < n and j + 1 < len(self.data_infos):
            j += 1
            if self.data_infos[j]['scene_token'] != scene:
                break
            out.append(j)
        return out

    def _to_cur(self, idx_from: int, idx_cur: int) -> np.ndarray:
        """4x4 column-vector transform: frame idx_from lidar -> current."""
        a = self.data_infos[idx_from]
        c = self.data_infos[idx_cur]
        l2g = (transform_matrix(a['ego2global_translation'],
                                a['ego2global_rotation']) @
               transform_matrix(a['lidar2ego_translation'],
                                a['lidar2ego_rotation']))
        g2l = (transform_matrix(c['lidar2ego_translation'],
                                c['lidar2ego_rotation'], inverse=True) @
               transform_matrix(c['ego2global_translation'],
                                c['ego2global_rotation'], inverse=True))
        return g2l @ l2g

    def _match_ids(self, info, kept):
        toks = info.get('gt_instance_tokens')
        if toks is None:
            return None
        return [str(toks[k]) for k in kept]

    def _boxes_with_tokens(self, info):
        """(boxes [N,9], labels [N], tokens or None) after the det filters."""
        boxes = np.asarray(info.get('gt_boxes', np.zeros((0, 7))),
                           np.float64)
        names = np.asarray(info.get('gt_names', np.zeros((0,), object)))
        vel = np.nan_to_num(np.asarray(info.get('gt_velocity',
                                                np.zeros((0, 2))),
                                       np.float64))
        kept = np.arange(len(boxes))
        if self.use_valid_flag and 'valid_flag' in info:
            m = np.asarray(info['valid_flag'], bool)
            boxes, names, vel, kept = boxes[m], names[m], vel[m], kept[m]
        labels = np.array([self.class_to_id.get(str(n), -1) for n in names],
                          np.int64)
        m = labels >= 0
        boxes, vel, labels, kept = boxes[m], vel[m], labels[m], kept[m]
        if len(boxes):
            m = ((boxes[:, 0] >= self.pc_range[0]) &
                 (boxes[:, 0] <= self.pc_range[3]) &
                 (boxes[:, 1] >= self.pc_range[1]) &
                 (boxes[:, 1] <= self.pc_range[4]))
            boxes, vel, labels, kept = boxes[m], vel[m], labels[m], kept[m]
        out = np.zeros((len(boxes), 9))
        if len(boxes):
            out[:, :7] = boxes[:, :7]
            out[:, 2] = boxes[:, 2] + boxes[:, 5] * 0.5
            out[:, 7:9] = vel
        return out, labels, self._match_ids(info, kept)

    def _instance_id(self, token: str) -> int:
        """Stable int id per instance token (reference gt_inds)."""
        if token not in self._inst_ids:
            self._inst_ids[token] = len(self._inst_ids)
        return self._inst_ids[token]

    @staticmethod
    def _normalize_np(boxes9: np.ndarray) -> np.ndarray:
        """numpy twin of core.bbox.normalize_bbox ([N,9] -> [N,10])."""
        out = np.zeros((len(boxes9), 10), np.float32)
        if not len(boxes9):
            return out
        out[:, 0:2] = boxes9[:, 0:2]
        out[:, 2] = np.log(np.maximum(boxes9[:, 3], 1e-6))
        out[:, 3] = np.log(np.maximum(boxes9[:, 4], 1e-6))
        out[:, 4] = boxes9[:, 2]
        out[:, 5] = np.log(np.maximum(boxes9[:, 5], 1e-6))
        out[:, 6] = np.sin(boxes9[:, 6])
        out[:, 7] = np.cos(boxes9[:, 6])
        out[:, 8:10] = boxes9[:, 7:9]
        return out

    def _clip_track_gt(self, idx0: int, g_cap: int):
        """Per-window-frame track gt with clip-consistent instance ids.

        The reference converter materialises gt_inds per frame
        (uniad_track.py:571 ``gt_instances.obj_ids = gt_inds``); here the
        same ids come from the instance tokens. Boxes of non-current
        frames are expressed in THEIR OWN frame's lidar coordinates —
        each clip frame is matched against its own-frame detections.
        """
        prev_idx, _ = self._window_indices(idx0, 1)
        clip_idx = list(prev_idx) + [idx0]
        tc = len(clip_idx)
        tb = np.zeros((tc, g_cap, 10), np.float32)
        tl = np.zeros((tc, g_cap), np.int32)
        tid = np.full((tc, g_cap), -1, np.int32)
        tnum = np.zeros((tc,), np.int32)
        l2g_r = np.zeros((tc, 3, 3), np.float32)
        l2g_t = np.zeros((tc, 3), np.float32)
        ts = np.zeros((tc,), np.float32)
        for k, j in enumerate(clip_idx):
            jinfo = self.data_infos[j]
            jb, jl, jtok = self._boxes_with_tokens(jinfo)
            n = min(len(jb), g_cap)
            tb[k, :n] = self._normalize_np(jb[:n])
            tl[k, :n] = jl[:n]
            if jtok is not None:
                tid[k, :n] = [self._instance_id(t) for t in jtok[:n]]
            tnum[k] = n
            m = (transform_matrix(jinfo['ego2global_translation'],
                                  jinfo['ego2global_rotation']) @
                 transform_matrix(jinfo['lidar2ego_translation'],
                                  jinfo['lidar2ego_rotation']))
            l2g_r[k] = m[:3, :3]
            l2g_t[k] = m[:3, 3]
            ts[k] = jinfo['timestamp'] / 1e6
        return tb, tl, tid, tnum, l2g_r, l2g_t, ts

    def _rasterize(self, centers_xy, dims_wl, yaws):
        """BEV occupancy of boxes on the occ grid (one mask per box)."""
        hh, ww = self.occ_size
        pc = self.pc_range
        ys = np.linspace(pc[1], pc[4], hh, endpoint=False) + \
            (pc[4] - pc[1]) / hh / 2
        xs = np.linspace(pc[0], pc[3], ww, endpoint=False) + \
            (pc[3] - pc[0]) / ww / 2
        gx, gy = np.meshgrid(xs, ys)            # [hh, ww]
        masks = np.zeros((len(centers_xy), hh, ww), np.float32)
        for i, (c, wl, yaw) in enumerate(zip(centers_xy, dims_wl, yaws)):
            dx = gx - c[0]
            dy = gy - c[1]
            ca, sa = np.cos(-yaw), np.sin(-yaw)
            lx = dx * ca - dy * sa
            ly = dx * sa + dy * ca
            masks[i] = ((np.abs(lx) <= wl[1] / 2) &
                        (np.abs(ly) <= wl[0] / 2)).astype(np.float32)
        return masks

    # -- sample -----------------------------------------------------------

    def __getitem__(self, i: int):
        det = super().__getitem__(i)
        idx0 = self.usable_index[i]
        info = self.data_infos[idx0]
        boxes, labels, tokens = self._boxes_with_tokens(info)
        g_cap = self.max_gt
        g = min(len(boxes), g_cap)

        horizon = max(self.predict_steps, self.occ_n_future,
                      self.planning_steps)
        fut_idx = self._future_frame_indices(idx0, horizon)

        # --- agent futures (motion + occupancy) ---
        t_m = self.predict_steps
        gt_traj = np.zeros((g_cap, t_m, 2), np.float32)
        gt_valid = np.zeros((g_cap, t_m), np.float32)
        to_ = self.occ_n_future
        hh, ww = self.occ_size
        gt_occ = np.zeros((g_cap, to_, hh, ww), np.float32)

        prev_centers = {ti: boxes[ti, :2] for ti in range(g)}
        for t, jf in enumerate(fut_idx):
            finfo = self.data_infos[jf]
            fboxes, flabels, ftokens = self._boxes_with_tokens(finfo)
            if not len(fboxes):
                continue
            m = self._to_cur(jf, idx0)
            cent = np.concatenate(
                [fboxes[:, :3], np.ones((len(fboxes), 1))], axis=1) @ m.T
            for ti in range(g):
                if tokens is not None and ftokens is not None:
                    hits = [k for k, tk in enumerate(ftokens)
                            if tk == tokens[ti]]
                    k = hits[0] if hits else None
                else:
                    # nearest-center fallback (<= 2 m/frame drift)
                    d = np.linalg.norm(fboxes[:, :2] -
                                       prev_centers[ti][None], axis=1)
                    k = int(d.argmin()) if d.min() < 2.0 else None
                if k is None:
                    continue
                prev_centers[ti] = fboxes[k, :2]
                if t < t_m:
                    gt_traj[ti, t] = cent[k, :2]
                    gt_valid[ti, t] = 1.0
                if t < to_:
                    yaw = fboxes[k, 6] + np.arctan2(m[1, 0], m[0, 0])
                    gt_occ[ti, t] = self._rasterize(
                        cent[k:k + 1, :2], fboxes[k:k + 1, [3, 4]],
                        np.asarray([yaw]))[0]

        # --- planning gt + command ---
        tp = self.planning_steps
        sdc = np.zeros((tp, 3), np.float32)
        sdc_mask = np.zeros((tp,), np.float32)
        for t, jf in enumerate(fut_idx[:tp]):
            m = self._to_cur(jf, idx0)
            sdc[t, :2] = m[:2, 3]
            sdc[t, 2] = np.arctan2(m[1, 0], m[0, 0])
            sdc_mask[t] = 1.0
        lateral = sdc[int(sdc_mask.sum()) - 1, 1] if sdc_mask.any() else 0.0
        command = 1 if lateral > 2.0 else (0 if lateral < -2.0 else 2)

        # --- map gt (optional precomputed anns) ---
        gm = self.max_map_gt
        bh, bw = self.bev_size
        map_boxes = np.zeros((gm, 4), np.float32)
        map_labels = np.zeros((gm,), np.int32)
        map_masks = np.zeros((gm, bh, bw), np.float32)
        n_map = 0
        if self.map_anns is not None:
            ann = self.map_anns.get(info['token'])
            if ann:
                mb = np.asarray(ann['boxes'], np.float32)
                ml = np.asarray(ann['labels'], np.int32)
                n_map = min(len(mb), gm)
                map_boxes[:n_map] = mb[:n_map]
                map_labels[:n_map] = ml[:n_map]
                from .rasterize import fill_polygon, draw_polyline
                closed = np.asarray(
                    ann.get('closed', np.zeros(len(mb), bool)))
                for k, pts in enumerate(ann.get('polylines', [])[:n_map]):
                    if k < len(closed) and closed[k] and ml[k] == 1:
                        # ped crossings: filled polygon (reference map gt
                        # fills crossing/drivable polygons; thin strokes
                        # skew IoU — UniAD nuscenes_e2e_dataset.py)
                        map_masks[k] = fill_polygon(pts, bh, bw)
                    else:
                        # dividers/boundaries: stroked lines (closed rings
                        # get their closing segment drawn)
                        map_masks[k] = draw_polyline(
                            pts, bh, bw,
                            closed=bool(k < len(closed) and closed[k]))

        tb, tl, tid, tnum, l2g_r, l2g_t, ts = self._clip_track_gt(
            idx0, g_cap)

        targets = UniADTargets(
            track_boxes=torch.from_numpy(tb[None]),
            track_labels=torch.from_numpy(tl[None]),
            track_ids=torch.from_numpy(tid[None]),
            track_num=torch.from_numpy(tnum[None]),
            l2g_r=torch.from_numpy(l2g_r[None]),
            l2g_t=torch.from_numpy(l2g_t[None]),
            timestamp=torch.from_numpy(ts[None]),
            gt_boxes=det.gt_bboxes,
            gt_labels=det.gt_labels,
            num_valid_gt=det.num_valid_gt,
            map_boxes=torch.from_numpy(map_boxes[None]),
            map_labels=torch.from_numpy(map_labels[None]),
            num_valid_map=torch.from_numpy(np.array([n_map], np.int32)),
            map_masks=torch.from_numpy(map_masks[None]),
            gt_traj=torch.from_numpy(gt_traj[None]),
            gt_traj_valid=torch.from_numpy(gt_valid[None]),
            sdc_traj=torch.from_numpy(sdc[None]),
            sdc_mask=torch.from_numpy(sdc_mask[None]),
            gt_occ=torch.from_numpy(gt_occ[None]),
        )
        return det.frames, targets, torch.from_numpy(
            np.array([command], np.int32))
