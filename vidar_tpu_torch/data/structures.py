"""The forecast batch (port of vidar_tpu/data/structures.py:ViDARBatch): a
plain dataclass of tensors, every meta precomputed on the host.

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
