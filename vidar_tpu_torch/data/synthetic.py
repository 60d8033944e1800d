"""Synthetic forecast and detection batches (port of
vidar_tpu/data/synthetic.py, and of the detection batch of
tests/e2e/test_finetune_smoke.py:33-48).

The numpy generator is consumed in the same order as the JAX package's, so
one seed gives identical arrays in both.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .structures import DetBatch, ViDARBatch


def _ring_lidar2img(num_cams: int, img_h: int, img_w: int) -> np.ndarray:
    """Pinhole cameras in a yaw ring, roughly nuScenes-like geometry."""
    mats = []
    f = img_w * 0.8
    intr = np.array([[f, 0, img_w / 2, 0],
                     [0, f, img_h / 2, 0],
                     [0, 0, 1, 0],
                     [0, 0, 0, 1]], np.float64)
    for c in range(num_cams):
        yaw = 2 * np.pi * c / num_cams
        rot_yaw = np.array([
            [np.cos(-yaw), -np.sin(-yaw), 0],
            [np.sin(-yaw), np.cos(-yaw), 0],
            [0, 0, 1]], np.float64)
        # x_fwd -> z_cam, y_left -> -x_cam, z_up -> -y_cam
        axes = np.array([[0, -1, 0],
                         [0, 0, -1],
                         [1, 0, 0]], np.float64)
        l2c = np.eye(4)
        l2c[:3, :3] = axes @ rot_yaw
        l2c[2, 3] = 0.5
        mats.append(intr @ l2c)
    return np.stack(mats)


def make_synthetic_batch(rng: np.random.Generator, *, bs=1, queue_length=4,
                         future_length=3, num_cams=6, img_h=96, img_w=160,
                         max_points=512, speed=2.0, device='cuda'
                         ) -> ViDARBatch:
    """A self-consistent batch: a forward-moving ego, cameras in a ring and
    GT points on random obstacles, placed on ``device`` (the card unless
    the caller asks for the CPU)."""
    device = resolve_device(device)
    t = queue_length + 1
    tq = queue_length + 1 + future_length

    images = rng.standard_normal(
        (bs, t, num_cams, img_h, img_w, 3)).astype(np.float32)
    l2i = _ring_lidar2img(num_cams, img_h, img_w)
    lidar2img = np.broadcast_to(l2i[None, None], (bs, t, num_cams, 4, 4))

    def cur2ref_mat(k_rel):
        # row-vector convention: p_ref = p_cur @ M
        m = np.eye(4)
        m[3, 0] = speed * k_rel
        return m

    ref_idx = queue_length
    cur2ref = np.stack([[cur2ref_mat(k - ref_idx) for k in range(tq)]
                        for _ in range(bs)])
    ref2cur = np.stack([[np.linalg.inv(cur2ref[b, k]) for k in range(tq)]
                        for b in range(bs)])

    can_bus = np.zeros((bs, t, 18), np.float32)
    can_bus[:, 1:, 0] = speed
    prev_exists = np.ones((bs, t), bool)
    prev_exists[:, 0] = False

    shift = np.zeros((bs, t, 2), np.float32)
    shift[:, 1:, 0] = speed / 102.4
    rotate_angle = np.zeros((bs, t), np.float32)

    fc = np.zeros((bs, future_length + 1, 18), np.float32)
    fc[:, 1:, 0] = speed
    future2ref = cur2ref[:, ref_idx:ref_idx + future_length + 1]
    ref2future = ref2cur[:, ref_idx:ref_idx + future_length + 1]

    pts, tindex = [], []
    per_frame = max_points // tq
    for k in range(tq):
        ang = rng.uniform(0, 2 * np.pi, per_frame)
        rad = rng.uniform(3.0, 45.0, per_frame)
        z = rng.uniform(-2.0, 1.5, per_frame)
        pts.append(np.stack([rad * np.cos(ang), rad * np.sin(ang), z], -1))
        tindex.append(np.full(per_frame, k))
    pts = np.concatenate(pts)
    tindex = np.concatenate(tindex)
    pad = max_points - pts.shape[0]
    pts = np.pad(pts, ((0, pad), (0, 0)))
    tindex = np.pad(tindex, (0, pad), constant_values=-1)
    gt_points = np.broadcast_to(pts[None], (bs, max_points, 3))
    gt_tindex = np.broadcast_to(tindex[None], (bs, max_points))

    def tensor(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return ViDARBatch(
        images=tensor(images, np.float32),
        lidar2img=tensor(lidar2img, np.float32),
        can_bus=tensor(can_bus, np.float32),
        shift=tensor(shift, np.float32),
        rotate_angle=tensor(rotate_angle, np.float32),
        prev_bev_exists=tensor(prev_exists, bool),
        future_can_bus=tensor(fc, np.float32),
        future2ref=tensor(future2ref, np.float32),
        ref2future=tensor(ref2future, np.float32),
        cur2ref=tensor(cur2ref, np.float32),
        ref2cur=tensor(ref2cur, np.float32),
        gt_points=tensor(gt_points, np.float32),
        gt_tindex=tensor(gt_tindex, np.int32),
    )


def make_synthetic_det_batch(rng: np.random.Generator, *, bs=1,
                             queue_length=2, num_cams=3, img_h=64, img_w=64,
                             max_points=64, max_gt=8, num_gt=3,
                             device='cuda') -> DetBatch:
    """A detection batch: ``make_synthetic_batch`` without futures, then
    ``num_gt`` random boxes per sample (centres within 30 m, sizes 1-4 m,
    any yaw, no velocity) and their labels among the 10 nuScenes classes,
    padded to ``max_gt``; frames first, then each sample's boxes and
    labels, in that order."""
    frames = make_synthetic_batch(rng, bs=bs, queue_length=queue_length,
                                  future_length=0, num_cams=num_cams,
                                  img_h=img_h, img_w=img_w,
                                  max_points=max_points, device=device)
    g = num_gt
    gt = np.zeros((bs, max_gt, 9), np.float32)
    labels = np.zeros((bs, max_gt), np.int32)
    for b in range(bs):
        gt[b, :g, :2] = rng.uniform(-30, 30, (g, 2))
        gt[b, :g, 2] = rng.uniform(-1, 1, g)
        gt[b, :g, 3:6] = rng.uniform(1, 4, (g, 3))
        gt[b, :g, 6] = rng.uniform(-np.pi, np.pi, g)
        labels[b, :g] = rng.integers(0, 10, g)
    dev = frames.images.device
    return DetBatch(frames=frames,
                    gt_bboxes=torch.from_numpy(gt).to(dev),
                    gt_labels=torch.from_numpy(labels).to(dev),
                    num_valid_gt=torch.full((bs,), g, dtype=torch.int32,
                                            device=dev))
