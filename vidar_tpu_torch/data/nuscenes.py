"""nuScenes ViDAR dataset: reference-pkl in, ``ViDARBatch`` out (the port's
copy of vidar_tpu/data/nuscenes.py; the samples are CPU torch tensors of
the port's batch structures, with the JAX package's dtypes, and one seed
gives the same samples as there).

Reads the exact pkl schema the reference's converter produces
(``nuscenes_infos_temporal_{train,val,test}.pkl``; fields per
reference tools/data_converter/nuscenes_converter.py:219-226 and consumed at
datasets/nuscenes_dataset.py:134-227), assembles the temporal window
(4 history + current + F futures; usable-index scan per
datasets/nuscenes_vidar_dataset_template.py:43-69), rebases can_bus deltas per
scene, computes the full cur<->ref transform chains (row-vector convention,
datasets/nuscenes_vidar_dataset_v1.py:38-203), and precomputes everything the
model needs as fixed-shape arrays — including the BEV ego-motion ``shift``
that the reference computes with numpy inside the transformer forward
(modules/transformer.py:120-134).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import pipeline as pl
from .geometry import (patch_angle_deg, quat_to_rot, transform_matrix)
from .. import native
from ..evals.streaming import compute_bev_shift
from .structures import DetBatch, ViDARBatch


def _tensor(a: np.ndarray, dtype=None) -> torch.Tensor:
    """A CPU tensor of ``a`` cast to ``dtype`` (numpy's), as the JAX
    package's ``jnp.asarray(a, dtype)``."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype))


class NuScenesViDARDataset:
    """Iterable over ViDAR pretrain samples.

    Args mirror the reference dataset config leaves
    (projects/configs/.../vidar_1_8_nusc_3future.py:332-377).
    """

    def __init__(self, ann_file: str, data_root: str = '',
                 queue_length: int = 4, future_length: int = 3,
                 rand_frame_interval: Sequence[int] = (1,),
                 ego_mask: Optional[Sequence[float]] = (-0.8, -1.5, 0.8, 2.5),
                 load_frame_interval: Optional[int] = None,
                 test_mode: bool = False,
                 bev_size=(200, 200),
                 pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                 ida_aug_conf: Optional[Dict] = None,
                 random_aug_conf: Optional[Dict] = None,
                 max_points: int = 163840,
                 img_norm_mean=(103.530, 116.280, 123.675),
                 img_norm_std=(1.0, 1.0, 1.0),
                 seed: int = 0):
        self.data_root = data_root
        self.queue_length = queue_length
        self.future_length = future_length
        self.rand_frame_interval = tuple(rand_frame_interval)
        self.ego_mask = ego_mask
        self.test_mode = test_mode
        self.bev_size = bev_size
        self.pc_range = pc_range
        self.ida_aug_conf = ida_aug_conf
        # RandomCropResizeFlipImage (reference augmentation.py:204; the
        # mem-efficient config's aug) — mutually exclusive with ida_aug_conf
        self.random_aug_conf = random_aug_conf
        # OpenScene/nuPlan image scaling; set by NuPlanViDARDataset
        self.image_scale: Optional[float] = None
        self.max_points = max_points
        self.img_norm_mean = img_norm_mean
        self.img_norm_std = img_norm_std
        self.seed = seed
        self.rng = np.random.default_rng(seed)

        with open(ann_file, 'rb') as f:
            data = pickle.load(f)
        infos = data['infos'] if isinstance(data, dict) else data
        self.data_infos = sorted(infos, key=lambda e: e['timestamp'])

        # usable-index scan: needs future_length futures in-scene; in test
        # also queue_length full history (template.py:43-69).
        usable = []
        last_scene = None
        frame_in_scene = -1
        need_prev = queue_length if test_mode else 0
        for idx, info in enumerate(self.data_infos):
            if info['scene_token'] != last_scene:
                last_scene = info['scene_token']
                frame_in_scene = -1
            frame_in_scene += 1
            if frame_in_scene < need_prev:
                continue
            tgt = idx + future_length
            if tgt >= len(self.data_infos):
                break
            if self.data_infos[tgt]['scene_token'] != last_scene:
                continue
            usable.append(idx)
        if load_frame_interval is not None:
            usable = usable[::load_frame_interval]
        self.usable_index = usable

    def __len__(self):
        return len(self.usable_index)

    def _load_frame_points(self, info) -> np.ndarray:
        """Keyframe + sweeps point loading; overridden by the nuPlan variant."""
        return pl.load_multi_sweeps(info, ego_mask=self.ego_mask)

    # ------------------------------------------------------------- framemeta

    def _frame_meta(self, index: int) -> Dict:
        info = self.data_infos[index]
        e2g = transform_matrix(info['ego2global_translation'],
                               info['ego2global_rotation'])
        g2e = transform_matrix(info['ego2global_translation'],
                               info['ego2global_rotation'], inverse=True)
        l2e = transform_matrix(info['lidar2ego_translation'],
                               info['lidar2ego_rotation'])
        e2l = transform_matrix(info['lidar2ego_translation'],
                               info['lidar2ego_rotation'], inverse=True)
        l2g_rot = e2g[:3, :3] @ l2e[:3, :3]

        can_bus = np.array(info['can_bus'], np.float64).copy()
        can_bus[:3] = info['ego2global_translation']
        can_bus[3:7] = info['ego2global_rotation']
        pa = patch_angle_deg(info['ego2global_rotation'])
        can_bus[-2] = pa / 180.0 * np.pi
        can_bus[-1] = pa

        # camera projections
        lidar2img = []
        cam_paths = []
        intrinsics = []
        for cam_info in info['cams'].values():
            s2l_r = np.asarray(cam_info['sensor2lidar_rotation'])
            s2l_t = np.asarray(cam_info['sensor2lidar_translation'])
            l2c = np.eye(4)
            l2c[:3, :3] = s2l_r.T
            l2c[:3, 3] = s2l_r.T @ (-s2l_t)
            viewpad = np.eye(4)
            intr = np.asarray(cam_info['cam_intrinsic'])
            viewpad[:intr.shape[0], :intr.shape[1]] = intr
            lidar2img.append(viewpad @ l2c)
            intrinsics.append(viewpad)
            cam_paths.append(os.path.join(self.data_root,
                                          cam_info['data_path'])
                             if self.data_root and not os.path.isabs(
                                 cam_info['data_path'])
                             else cam_info['data_path'])
        return dict(
            info=info, e2g=e2g, g2e=g2e, l2e=l2e, e2l=e2l,
            l2g_rot=l2g_rot, can_bus=can_bus,
            lidar2img=np.stack(lidar2img), cam_paths=cam_paths,
            intrinsics=np.stack(intrinsics),
            scene_token=info['scene_token'])

    def streaming_meta(self, i: int) -> Dict:
        """Raw (un-rebased) current-frame meta for streaming evaluation.

        The streaming rebase (reference bevformer.py:291-324) needs the raw
        global can_bus pos/angle of each streamed frame — the per-sample
        window rebase in ``__getitem__`` zeroes them for the first frame of
        the window, so they must be re-read here.
        """
        m = self._frame_meta(self.usable_index[i])
        return dict(scene_token=m['scene_token'],
                    can_bus=m['can_bus'].copy(),
                    l2g_rot=m['l2g_rot'].copy())

    # ------------------------------------------------------------- assembly

    def _window_indices(self, index: int, rand_interval: int):
        # Range-clamp only, NO scene filter — matching the reference
        # (nuscenes_vidar_dataset_template.py:116-117 clamps to the dataset
        # range; scene changes are handled downstream by the per-scene
        # can_bus rebase + prev_bev_exists reset, dataset_v1.py:109-137).
        prev = sorted(range(index - self.queue_length * rand_interval, index,
                            rand_interval))
        if rand_interval < 0:
            prev = prev[::-1]
        prev = prev + [index]
        fut = sorted(range(index,
                           index + (self.future_length + 1) * rand_interval,
                           rand_interval))
        if rand_interval < 0:
            fut = fut[::-1]
        clamp = lambda i: min(max(0, i), len(self.data_infos) - 1)
        return [clamp(i) for i in prev], [clamp(i) for i in fut]

    def __getitem__(self, i: int) -> ViDARBatch:
        index = self.usable_index[i]
        rand_interval = int(self.rng.choice(self.rand_frame_interval))
        prev_idx, fut_idx = self._window_indices(index, rand_interval)
        metas = {j: self._frame_meta(j) for j in set(prev_idx + fut_idx)}
        ref = metas[prev_idx[-1]]

        # window = history frames + [current + futures]
        window_idx = prev_idx[:-1] + fut_idx
        tq = len(window_idx)

        # cur<->ref chains, row-vector convention (p_ref = p_cur @ M)
        cur2ref = np.zeros((tq, 4, 4))
        ref2cur = np.zeros((tq, 4, 4))
        for k, j in enumerate(window_idx):
            m = metas[j]
            cur2ref[k] = (m['l2e'].T @ m['e2g'].T @ ref['g2e'].T @
                          ref['e2l'].T)
            ref2cur[k] = (ref['l2e'].T @ ref['e2g'].T @ m['g2e'].T @
                          m['e2l'].T)

        # per-scene can_bus rebase over camera frames (dataset_v1.py:109-137)
        t = len(prev_idx)
        can_bus = np.zeros((t, 18))
        prev_exists = np.zeros((t,), bool)
        prev_scene = None
        prev_pos = prev_angle = None
        for k, j in enumerate(prev_idx):
            m = metas[j]
            cb = m['can_bus'].copy()
            if m['scene_token'] != prev_scene:
                prev_exists[k] = False
                prev_scene = m['scene_token']
                prev_pos = cb[:3].copy()
                prev_angle = cb[-1]
                cb[:3] = 0
                cb[-1] = 0
            else:
                prev_exists[k] = True
                tmp_pos = cb[:3].copy()
                tmp_angle = cb[-1]
                cb[:3] = tmp_pos - prev_pos
                cb[-1] = tmp_angle - prev_angle
                prev_pos, prev_angle = tmp_pos, tmp_angle
            can_bus[k] = cb

        # ego-motion shift for TSA (transformer.py:120-134, precomputed here)
        shift = np.zeros((t, 2), np.float32)
        rotate_angle = np.zeros((t,), np.float32)
        for k, j in enumerate(prev_idx):
            m = metas[j]
            shift[k] = compute_bev_shift(can_bus[k], m['l2g_rot'],
                                         self.bev_size, self.pc_range)
            rotate_angle[k] = can_bus[k, -1]

        # future chain (dataset_v1.py:143-181)
        f1 = self.future_length + 1
        future_can_bus = np.zeros((f1, 18))
        future2ref = np.zeros((f1, 4, 4))
        ref2future = np.zeros((f1, 4, 4))
        ref_scene = ref['scene_token']
        ref_cb = None
        for k, j in enumerate(fut_idx):
            m = metas[j]
            if m['scene_token'] != ref_scene:
                raise ValueError('future crosses scene boundary '
                                 '(filtered by usable_index)')
            w_idx = self.queue_length + k  # position in window chains
            future2ref[k] = cur2ref[w_idx]
            ref2future[k] = ref2cur[w_idx]
            cb = m['can_bus'].copy()
            if k == 0:
                cb[:3] = 0
                cb[-1] = 0
            else:
                pos = np.array([0.0, 0.0, 0.0, 1.0])[None]
                pos = pos @ future2ref[k] @ ref2future[k - 1]
                angle = cb[-1] - ref_cb[-1]
                cb[:3] = pos[0, :3]
                cb[-1] = angle
            ref_cb = m['can_bus'].copy()
            future_can_bus[k] = cb

        # images over camera frames (shared aug across the queue)
        imgs_all = []
        lidar2img = []
        aug = None
        rcrf = None
        for k, j in enumerate(prev_idx):
            m = metas[j]
            imgs = pl.load_multiview_images(m['cam_paths'])
            l2i = m['lidar2img'].copy()
            if self.ida_aug_conf is not None:
                if aug is None:
                    aug = pl.sample_crop_resize_flip(
                        self.rng, self.ida_aug_conf, not self.test_mode)
                # intrinsic update folds into lidar2img directly
                imgs, viewpad = pl.crop_resize_flip(
                    imgs, m['intrinsics'].copy(), aug)
                l2i = np.einsum('cij,cjk->cik',
                                viewpad @ np.linalg.inv(m['intrinsics']),
                                l2i)
            if self.random_aug_conf is not None:
                # shared across the queue (reference aug_param contract,
                # augmentation.py:272-276)
                if rcrf is None:
                    rcrf = pl.sample_random_crop_resize_flip(
                        self.rng, self.random_aug_conf, not self.test_mode)
                imgs, l2i = pl.random_crop_resize_flip(imgs, l2i, rcrf)
            if self.image_scale:
                # OpenScene 2/3 scaling (reference transform_3d.py:294)
                imgs, l2i = pl.scale_images(imgs, l2i, self.image_scale)
            if not self.test_mode:
                imgs = pl.photometric_distortion(imgs, self.rng)
            if native.available():
                # fused C++ normalize+pad (GIL-free; vidar_tpu_torch.native)
                ch, cw = imgs.shape[1:3]
                ph = -(-ch // 32) * 32
                pw = -(-cw // 32) * 32
                imgs = np.stack([
                    native.normalize_pad(im, ph, pw, self.img_norm_mean,
                                         self.img_norm_std)
                    for im in imgs])
            else:
                imgs = pl.normalize_images(imgs, self.img_norm_mean,
                                           self.img_norm_std)
                imgs = pl.pad_images(imgs)
            imgs_all.append(imgs)
            lidar2img.append(l2i)
        images = np.stack(imgs_all)  # [T, cams, H, W, 3]

        # lidar over the whole window
        pts_list = []
        tindex_list = []
        for k, j in enumerate(window_idx):
            m = metas[j]
            pts = self._load_frame_points(m['info'])
            if not self.test_mode:
                pts = (native.voxel_downsample_points(pts, self.pc_range)
                       if native.available()
                       else pl.voxel_downsample_points(pts, self.pc_range))
            pts_list.append(pts[:, :3])
            tindex_list.append(np.full(len(pts), k, np.int32))
        pts = np.concatenate(pts_list)
        tindex = np.concatenate(tindex_list)
        if len(pts) > self.max_points:
            # the train split draws from the dataset's stream, as JAX does;
            # the test split's draw is a function of (seed, the sample's
            # frame index) alone, so a sample's GT points do not depend on
            # the samples loaded before it or on the loader threads' order
            # (JAX draws both from the stream: a departure, ROADMAP.md)
            rng = (np.random.default_rng([self.seed, index])
                   if self.test_mode else self.rng)
            sel = rng.choice(len(pts), self.max_points, replace=False)
            pts, tindex = pts[sel], tindex[sel]
        pad = self.max_points - len(pts)
        pts = np.pad(pts, ((0, pad), (0, 0)))
        tindex = np.pad(tindex, (0, pad), constant_values=-1)

        f32 = np.float32
        return ViDARBatch(
            images=_tensor(images[None], f32),
            lidar2img=_tensor(np.stack(lidar2img)[None], f32),
            can_bus=_tensor(can_bus[None], f32),
            shift=_tensor(shift[None]),
            rotate_angle=_tensor(rotate_angle[None]),
            prev_bev_exists=_tensor(prev_exists[None]),
            future_can_bus=_tensor(future_can_bus[None], f32),
            future2ref=_tensor(future2ref[None], f32),
            ref2future=_tensor(ref2future[None], f32),
            cur2ref=_tensor(cur2ref[None], f32),
            ref2cur=_tensor(ref2cur[None], f32),
            gt_points=_tensor(pts[None], f32),
            gt_tindex=_tensor(tindex[None], np.int32),
        )


DET_CLASS_NAMES = ('car', 'truck', 'construction_vehicle', 'bus', 'trailer',
                   'barrier', 'motorcycle', 'bicycle', 'pedestrian',
                   'traffic_cone')


class NuScenesDetDataset(NuScenesViDARDataset):
    """Fine-tune detection dataset (reference ``CustomNuScenesDataset``,
    datasets/nuscenes_dataset.py): BEVFormer-style history queue + statically
    padded 3D gt boxes for the current frame, with the
    ``use_pretrain_data`` index filter (:43-69 — align the fine-tune data to
    the samples the pretrain stage could use, then stride 4 ≈ 25%).

    gt boxes come out as [G, 9] (cx cy cz_gravity w l h rot vx vy) — the
    gravity-center + velocity form the reference head's loss consumes
    (dense_heads/bevformer_head.py:342: cat(gravity_center, tensor[:, 3:])).
    """

    def __init__(self, ann_file: str, classes=DET_CLASS_NAMES,
                 use_valid_flag: bool = True,
                 use_pretrain_data: bool = False,
                 max_gt: int = 128, **kwargs):
        kwargs.setdefault('future_length', 0)
        super().__init__(ann_file, **kwargs)
        self.classes = tuple(classes)
        self.class_to_id = {c: i for i, c in enumerate(self.classes)}
        self.use_valid_flag = use_valid_flag
        self.max_gt = max_gt
        if use_pretrain_data:
            usable = []
            last_scene = None
            frame_in_scene = 0
            valid_future_length = 3
            for idx, info in enumerate(self.data_infos):
                if info['scene_token'] != last_scene:
                    last_scene = info['scene_token']
                    frame_in_scene = 0
                    continue
                frame_in_scene += 1
                if frame_in_scene >= self.queue_length:
                    tgt = idx + valid_future_length
                    if tgt >= len(self.data_infos):
                        break
                    if self.data_infos[tgt]['scene_token'] != last_scene:
                        continue
                    usable.append(idx)
            self.usable_index = usable[::4]

    def _gt_arrays(self, info):
        boxes = np.asarray(info.get('gt_boxes',
                                    np.zeros((0, 7))), np.float64)
        names = np.asarray(info.get('gt_names', np.zeros((0,), object)))
        vel = np.asarray(info.get('gt_velocity',
                                  np.zeros((0, 2))), np.float64)
        vel = np.nan_to_num(vel)
        attrs = np.asarray(info['gt_attrs']) if 'gt_attrs' in info else \
            np.full((len(boxes),), '', object)
        if self.use_valid_flag and 'valid_flag' in info:
            keep = np.asarray(info['valid_flag'], bool)
            boxes, names, vel = boxes[keep], names[keep], vel[keep]
            attrs = attrs[keep]
        # class filter (ObjectNameFilter)
        labels = np.array([self.class_to_id.get(str(n), -1) for n in names],
                          np.int64)
        keep = labels >= 0
        boxes, vel, labels = boxes[keep], vel[keep], labels[keep]
        attrs = attrs[keep]
        # BEV range filter (ObjectRangeFilter on pc_range)
        if len(boxes):
            keep = ((boxes[:, 0] >= self.pc_range[0]) &
                    (boxes[:, 0] <= self.pc_range[3]) &
                    (boxes[:, 1] >= self.pc_range[1]) &
                    (boxes[:, 1] <= self.pc_range[4]))
            boxes, vel, labels = boxes[keep], vel[keep], labels[keep]
            attrs = attrs[keep]
        # bottom-center z -> gravity center (LiDARInstance3DBoxes convention)
        out = np.zeros((len(boxes), 9))
        if len(boxes):
            out[:, :7] = boxes[:, :7]
            out[:, 2] = boxes[:, 2] + boxes[:, 5] * 0.5
            out[:, 7:9] = vel
        return out, labels, attrs

    def det_gt_attrs(self, i: int) -> np.ndarray:
        """Attribute names aligned with sample i's (filtered, capped) gt —
        host-side strings for the devkit-protocol mAAE (attributes cannot
        ride the fixed-shape DetBatch)."""
        info = self.data_infos[self.usable_index[i]]
        _, _, attrs = self._gt_arrays(info)
        return attrs[:self.max_gt]

    def __getitem__(self, i: int):
        frames = super().__getitem__(i)
        info = self.data_infos[self.usable_index[i]]
        boxes, labels, _ = self._gt_arrays(info)
        g = min(len(boxes), self.max_gt)
        gt = np.zeros((self.max_gt, 9), np.float32)
        lb = np.zeros((self.max_gt,), np.int32)
        gt[:g] = boxes[:g]
        lb[:g] = labels[:g]
        return DetBatch(
            frames=frames,
            gt_bboxes=_tensor(gt[None]),
            gt_labels=_tensor(lb[None]),
            num_valid_gt=_tensor(np.array([g], np.int32)),
        )
