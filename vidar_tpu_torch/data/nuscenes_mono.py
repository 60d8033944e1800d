"""Per-camera monocular detection samples for DD3D co-training (port of
vidar_tpu/data/nuscenes_mono.py; reference dd3d/datasets/nuscenes.py:
99-359, consumed by ``CustomNuScenesDatasetV2.mono_cfg``).

The targets come from the converter's infos pkl: each GT box is moved from
the lidar frame into each camera's vision frame (quaternion, projected
centre, depth, size: DD3D's box parameters), its 2D box is the clipped
bounding box of the projected corners, and everything is padded to a fixed
capacity for ``models.dd3d.NuScenesDD3D.loss``. Geometry runs in float64
on the host, as in the JAX package; ``load_image`` reads a sample's
camera with the port's own JPEG decoder.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Sequence

import numpy as np

from .nuscenes import DET_CLASS_NAMES
from .pipeline import load_multiview_images

CAMERA_NAMES = ('CAM_FRONT', 'CAM_FRONT_RIGHT', 'CAM_BACK_RIGHT',
                'CAM_BACK', 'CAM_BACK_LEFT', 'CAM_FRONT_LEFT')

_CORNER_SIGNS = np.array(
    [[1, 1, 1], [1, -1, 1], [1, -1, -1], [1, 1, -1],
     [-1, 1, 1], [-1, -1, 1], [-1, -1, -1], [-1, 1, -1]], np.float64)


def _rot_z(yaw: np.ndarray) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    zero, one = np.zeros_like(c), np.ones_like(c)
    return np.stack([
        np.stack([c, -s, zero], -1),
        np.stack([s, c, zero], -1),
        np.stack([zero, zero, one], -1)], -2)


def _matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """[..., 3, 3] -> [..., 4] (w, x, y, z), the trace form, normalised."""
    t = np.trace(m, axis1=-2, axis2=-1)
    w = np.sqrt(np.clip(1.0 + t, 1e-9, None)) / 2.0
    x = (m[..., 2, 1] - m[..., 1, 2]) / np.clip(4 * w, 1e-9, None)
    y = (m[..., 0, 2] - m[..., 2, 0]) / np.clip(4 * w, 1e-9, None)
    z = (m[..., 1, 0] - m[..., 0, 1]) / np.clip(4 * w, 1e-9, None)
    q = np.stack([w, x, y, z], -1)
    return q / np.clip(np.linalg.norm(q, axis=-1, keepdims=True), 1e-9, None)


class NuScenesMonoDataset:
    """Per-camera mono samples with fixed-capacity DD3D targets: item
    ``index * num_cams + cam`` is camera ``cam`` of the ``index``-th sample
    in timestamp order; ``getitem_by_sample_cam`` addresses one by sample
    and camera name, as the reference's ``getitem_by_datumtoken``
    (dd3d/datasets/nuscenes.py:328-359)."""

    def __init__(self, ann_file: str, data_root: str = '',
                 classes: Sequence[str] = DET_CLASS_NAMES,
                 cam_names: Sequence[str] = CAMERA_NAMES,
                 max_gt: int = 64, min_depth: float = 0.5,
                 min_box_pixels: float = 4.0, img_hw=(900, 1600)):
        with open(ann_file, 'rb') as f:
            data = pickle.load(f)
        infos = data['infos'] if isinstance(data, dict) else data
        self.data_infos = sorted(infos, key=lambda e: e['timestamp'])
        self.data_root = data_root
        self.classes = tuple(classes)
        self.class_to_id = {c: i for i, c in enumerate(self.classes)}
        self.cam_names = tuple(cam_names)
        self.max_gt = max_gt
        self.min_depth = min_depth
        self.min_box_pixels = min_box_pixels
        self.img_hw = tuple(img_hw)

    def __len__(self) -> int:
        return len(self.data_infos) * len(self.cam_names)

    def _cam_geometry(self, info, cam: str):
        ci = info['cams'][cam]
        s2l_r = np.asarray(ci['sensor2lidar_rotation'], np.float64)
        s2l_t = np.asarray(ci['sensor2lidar_translation'], np.float64)
        l2c_r = s2l_r.T
        l2c_t = l2c_r @ (-s2l_t)
        k = np.asarray(ci['cam_intrinsic'], np.float64)
        path = ci['data_path']
        if self.data_root and not os.path.isabs(path):
            path = os.path.join(self.data_root, path)
        return l2c_r, l2c_t, k, path

    def _mono_targets(self, info, cam: str) -> Dict[str, np.ndarray]:
        l2c_r, l2c_t, k, path = self._cam_geometry(info, cam)
        h_img, w_img = self.img_hw
        boxes = np.asarray(info.get('gt_boxes', np.zeros((0, 7))),
                           np.float64)
        names = np.asarray(info.get('gt_names', np.zeros((0,), object)))
        labels = np.array([self.class_to_id.get(str(n), -1) for n in names],
                          np.int64)
        keep = labels >= 0
        boxes, labels = boxes[keep], labels[keep]
        out = dict(
            boxes2d=np.zeros((self.max_gt, 4), np.float32),
            labels=np.zeros((self.max_gt,), np.int32),
            quat=np.tile(np.array([1, 0, 0, 0], np.float32),
                         (self.max_gt, 1)),
            proj_ctr=np.zeros((self.max_gt, 2), np.float32),
            depth=np.ones((self.max_gt, 1), np.float32),
            size=np.ones((self.max_gt, 3), np.float32),
            num_valid=np.int32(0),
            image_path=path, intrinsics=k.astype(np.float32))
        if not len(boxes):
            return out

        ctr = boxes[:, :3].copy()
        ctr[:, 2] += boxes[:, 5] * 0.5          # bottom -> gravity centre
        ctr_cam = ctr @ l2c_r.T + l2c_t
        # the object's rotation in the camera frame: R_l2c @ Rz(yaw)
        r_cam = l2c_r[None] @ _rot_z(boxes[:, 6])
        quat = _matrix_to_quat(r_cam)

        # the 3D corners in the camera frame -> their 2D bounding box
        wlh = boxes[:, 3:6]
        lwh = wlh[:, [1, 0, 2]]
        corners_obj = 0.5 * lwh[:, None, :] * _CORNER_SIGNS[None]
        corners_cam = np.einsum('nij,nkj->nki', r_cam, corners_obj) + \
            ctr_cam[:, None, :]
        z = np.clip(corners_cam[..., 2], 1e-3, None)
        u = k[0, 0] * corners_cam[..., 0] / z + k[0, 2]
        v = k[1, 1] * corners_cam[..., 1] / z + k[1, 2]
        x1 = np.clip(u.min(-1), 0, w_img - 1)
        y1 = np.clip(v.min(-1), 0, h_img - 1)
        x2 = np.clip(u.max(-1), 0, w_img - 1)
        y2 = np.clip(v.max(-1), 0, h_img - 1)

        depth = ctr_cam[:, 2]
        visible = ((depth > self.min_depth) &
                   ((x2 - x1) > self.min_box_pixels) &
                   ((y2 - y1) > self.min_box_pixels) &
                   (corners_cam[..., 2].min(-1) > 0))
        idx = np.where(visible)[0][:self.max_gt]
        g = len(idx)
        if g == 0:
            return out

        pcx = k[0, 0] * ctr_cam[idx, 0] / depth[idx] + k[0, 2]
        pcy = k[1, 1] * ctr_cam[idx, 1] / depth[idx] + k[1, 2]
        out['boxes2d'][:g] = np.stack([x1[idx], y1[idx], x2[idx], y2[idx]],
                                      -1)
        out['labels'][:g] = labels[idx]
        out['quat'][:g] = quat[idx]
        out['proj_ctr'][:g] = np.stack([pcx, pcy], -1)
        out['depth'][:g, 0] = depth[idx]
        out['size'][:g] = wlh[idx]
        out['num_valid'] = np.int32(g)
        return out

    def getitem_by_sample_cam(self, index: int, cam: str):
        return self._mono_targets(self.data_infos[index], cam)

    def __getitem__(self, i: int):
        index, cam_i = divmod(i, len(self.cam_names))
        return self._mono_targets(self.data_infos[index],
                                  self.cam_names[cam_i])

    @staticmethod
    def load_image(item) -> np.ndarray:
        """An item's camera image, [H, W, 3] f32 RGB (JPEG through the
        port's own decoder, or PNG)."""
        return load_multiview_images([item['image_path']])[0]
