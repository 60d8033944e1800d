"""The forecast batch and the detection batch (port of
vidar_tpu/data/structures.py: ViDARBatch, DetBatch): plain dataclasses of
tensors, every meta precomputed on the host.

Frame window: history frames 0..Hq-1, current frame Hq, futures Hq+1..;
camera frames cover T = Hq + 1 frames.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ViDARBatch:
    # camera stream (T = history_queue_length + 1 frames)
    images: torch.Tensor          # [bs, T, cams, H, W, 3] f32
    lidar2img: torch.Tensor       # [bs, T, cams, 4, 4] f32
    can_bus: torch.Tensor         # [bs, T, 18]
    shift: torch.Tensor           # [bs, T, 2] BEV grid fractions
    rotate_angle: torch.Tensor    # [bs, T] yaw delta (deg)
    prev_bev_exists: torch.Tensor  # [bs, T] bool
    # future chain (F + 1 entries, index 0 = current frame)
    future_can_bus: torch.Tensor  # [bs, F+1, 18]
    future2ref: torch.Tensor      # [bs, F+1, 4, 4]
    ref2future: torch.Tensor      # [bs, F+1, 4, 4]
    # full window chains (Hq + 1 + F frames)
    cur2ref: torch.Tensor         # [bs, TQ, 4, 4]
    ref2cur: torch.Tensor         # [bs, TQ, 4, 4]
    # lidar supervision
    gt_points: torch.Tensor       # [bs, P, 3] metric xyz in their own frame
    gt_tindex: torch.Tensor       # [bs, P] int32 window tindex; -1 = padding

    def to(self, device) -> 'ViDARBatch':
        return ViDARBatch(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})


@dataclasses.dataclass
class DetBatch:
    """Fine-tune detection sample: the camera-stream batch plus statically
    padded 3D GT boxes."""
    frames: ViDARBatch
    gt_bboxes: torch.Tensor       # [bs, G, 9] (cx cy cz w l h rot vx vy)
    gt_labels: torch.Tensor       # [bs, G] int32; padding entries arbitrary
    num_valid_gt: torch.Tensor    # [bs] int32

    def to(self, device) -> 'DetBatch':
        return DetBatch(frames=self.frames.to(device),
                        gt_bboxes=self.gt_bboxes.to(device),
                        gt_labels=self.gt_labels.to(device),
                        num_valid_gt=self.num_valid_gt.to(device))


def collate_samples(items):
    """Concatenate bs=1 samples along the batch axis into one batch (the
    port of vidar_tpu/data/structures.py:59, the train CLI's batch
    assembly): ``ViDARBatch``, ``DetBatch``, a UniAD sample's ``(frames,
    UniADTargets, command)`` tuple, field by field (a field None in every
    sample stays None)."""
    if len(items) == 1:
        return items[0]
    first = items[0]
    if first is None:
        return None
    if torch.is_tensor(first):
        return torch.cat(items)
    if isinstance(first, tuple):
        return tuple(collate_samples(list(x)) for x in zip(*items))
    return type(first)(**{
        f.name: collate_samples([getattr(x, f.name) for x in items])
        for f in dataclasses.fields(first)})
