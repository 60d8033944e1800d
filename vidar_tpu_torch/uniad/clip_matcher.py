"""Clip-level track matching and its losses (port of
vidar_tpu/uniad/clip_matcher.py; reference ClipMatcher, track_loss.py:
62-556, and uniad_track.py:238-286 ``velo_update``).

Per frame and sample: a slot bound to a gt instance id keeps that gt
(identity inheritance), the free slots are Hungarian-matched to the
untracked gts (scipy on the host, ``core.bbox.hungarian_assign``), and the
focal + L1 losses of every decoder layer follow that one assignment,
normalised by the gt count plus the disappeared tracks. ``velo_update``
moves the [0, 1] reference points to the next frame.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from ..core import bbox as bbox_core

BIG = 1e8


@dataclasses.dataclass
class FrameGT:
    """Per-frame track gt of one sample, or with leading [B, T] dims."""
    boxes: torch.Tensor       # [G, 10] normalised code
    labels: torch.Tensor      # [G] int
    ids: torch.Tensor         # [G] int instance ids, -1 = pad
    num_valid: torch.Tensor   # [] int

    def index(self, *idx) -> 'FrameGT':
        return FrameGT(**{f.name: getattr(self, f.name)[idx]
                          for f in dataclasses.fields(self)})


def inherit_matches(obj_idxes: torch.Tensor, gt: FrameGT) -> torch.Tensor:
    """[cap] gt row of each slot's bound instance this frame, -1 where the
    slot is free or its instance is absent (the first row where ids
    repeat)."""
    g = gt.ids.shape[0]
    gt_valid = ((torch.arange(g, device=gt.ids.device) < gt.num_valid) &
                (gt.ids >= 0))
    eq = (obj_idxes[:, None] == gt.ids[None, :]) & gt_valid[None, :]
    found = eq.any(1)
    row = torch.argmax(eq.to(torch.int8), 1)
    return torch.where((obj_idxes >= 0) & found, row,
                       torch.full_like(row, -1))


def match_new_tracks(cls_logits, box_preds, obj_idxes, matched_gt,
                     gt: FrameGT, slot_mask, cls_weight: float = 2.0,
                     reg_weight: float = 0.25):
    """Hungarian match of the free eligible slots to the untracked gts ->
    updated (obj_idxes, matched_gt)."""
    g = gt.ids.shape[0]
    dev = cls_logits.device
    gt_valid = torch.arange(g, device=dev) < gt.num_valid
    tracked_gt = torch.zeros(g + 1, dtype=torch.bool, device=dev)
    tracked_gt[torch.where(matched_gt >= 0, matched_gt,
                           torch.full_like(matched_gt, g))] = True
    tracked_gt = tracked_gt[:g]
    free_slot = (obj_idxes == -1) & slot_mask
    cost = (bbox_core.focal_loss_cost(cls_logits, gt.labels,
                                      weight=cls_weight) +
            bbox_core.bbox3d_l1_cost(box_preds, gt.boxes, weight=reg_weight))
    cost = cost.detach()
    big = torch.full_like(cost, BIG)
    cost = torch.where(free_slot[:, None], cost, big)
    cost = torch.where((gt_valid & ~tracked_gt)[None, :], cost, big)
    assigned = bbox_core.hungarian_assign(cost, gt.num_valid)
    # a forced assignment onto a masked row or column is not a match
    a_safe = assigned.clamp(0, g - 1)
    real = (assigned >= 0) & (torch.gather(cost, 1, a_safe[:, None])[:, 0]
                              < BIG / 2)
    obj_idxes = torch.where(real, gt.ids.long()[a_safe], obj_idxes)
    matched_gt = torch.where(real, a_safe, matched_gt)
    return obj_idxes, matched_gt


def frame_track_loss(cls_logits, box_preds, matched_gt, obj_idxes,
                     gt: FrameGT, slot_mask, num_classes: int,
                     cls_weight: float = 2.0, reg_weight: float = 0.25,
                     code_weights: Sequence[float] = (
                         1, 1, 1, 1, 1, 1, 1, 1, 0.2, 0.2)
                     ) -> Dict[str, torch.Tensor]:
    """Focal loss over every eligible slot and L1 on the matched ones,
    normalised by gt count + disappeared tracks (track_loss.py:509)."""
    g = gt.ids.shape[0]
    pos = (matched_gt >= 0) & slot_mask
    a_safe = matched_gt.clamp(0, g - 1)
    labels = torch.where(pos, gt.labels.long()[a_safe],
                         torch.full_like(a_safe, num_classes))
    cls_l = bbox_core.sigmoid_focal_loss(cls_logits, labels, num_classes)
    cls_l = (cls_l * slot_mask[:, None]).sum()
    targets = gt.boxes[a_safe]
    cw = torch.tensor(code_weights, dtype=box_preds.dtype,
                      device=box_preds.device)
    isfin = torch.isfinite(targets).all(-1) & pos
    targets = torch.where(isfin[:, None], targets, torch.zeros_like(targets))
    l1 = ((box_preds - targets).abs() * cw).sum(-1)
    l1 = (l1 * isfin.to(l1.dtype)).sum()
    disappeared = ((obj_idxes >= 0) & (matched_gt < 0) & slot_mask).sum()
    num_samples = (gt.num_valid + disappeared).float().clamp(min=1.0)
    return dict(loss_cls=cls_weight * cls_l / num_samples,
                loss_bbox=reg_weight * torch.nan_to_num(l1) / num_samples)


def match_frame(all_cls, all_box, obj_idxes, gt: FrameGT, slot_mask,
                num_classes: int):
    """One frame of one sample: inherit + fresh match on the last decoder
    layer, every layer supervised under that assignment. all_cls [L, cap,
    C], all_box [L, cap, 10], obj_idxes [cap] -> (new obj_idxes,
    matched_gt [cap], the losses summed over the layers)."""
    matched = inherit_matches(obj_idxes, gt)
    obj_idxes, matched = match_new_tracks(all_cls[-1], all_box[-1],
                                          obj_idxes, matched, gt, slot_mask)
    losses = None
    for lid in range(all_cls.shape[0]):
        fl = frame_track_loss(all_cls[lid], all_box[lid], matched,
                              obj_idxes, gt, slot_mask, num_classes)
        losses = fl if losses is None else {k: losses[k] + fl[k]
                                            for k in losses}
    return obj_idxes, matched, losses


def bev_iou_aligned(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                    ) -> torch.Tensor:
    """Axis-aligned BEV IoU of paired denormalised boxes [..., >=5]
    (cx cy cz w l ...), rotation ignored: a gate of which tracks feed the
    heads, not a metric."""
    ax, ay, aw, al = (boxes_a[..., 0], boxes_a[..., 1], boxes_a[..., 3],
                      boxes_a[..., 4])
    bx, by, bw, bl = (boxes_b[..., 0], boxes_b[..., 1], boxes_b[..., 3],
                      boxes_b[..., 4])
    ix = (torch.minimum(ax + aw / 2, bx + bw / 2) -
          torch.maximum(ax - aw / 2, bx - bw / 2)).clamp(min=0.0)
    iy = (torch.minimum(ay + al / 2, by + bl / 2) -
          torch.maximum(ay - al / 2, by - bl / 2)).clamp(min=0.0)
    inter = ix * iy
    union = aw * al + bw * bl - inter
    return inter / union.clamp(min=1e-6)


def velo_update(ref_pts, velocity, l2g_r1, l2g_t1, l2g_r2, l2g_t2,
                time_delta, pc_range: Sequence[float]) -> torch.Tensor:
    """[..., cap, 3] sigmoid-space refs moved to the next frame: into
    metres, advanced by velocity x dt, through lidar->global of this frame
    and the inverse of the next one's, back to [0, 1]. Leading dims of the
    poses ([..., 3, 3], [..., 3]) and ``time_delta`` [...] match the
    refs'."""
    pc = torch.tensor(pc_range, dtype=torch.float32, device=ref_pts.device)
    span = pc[3:6] - pc[0:3]
    pts = ref_pts * span + pc[0:3]
    velo = torch.cat([velocity, torch.zeros_like(velocity[..., :1])], -1)
    pts = pts + velo * time_delta[..., None, None]
    pts = pts @ l2g_r1 + l2g_t1[..., None, :] - l2g_t2[..., None, :]
    pts = pts @ torch.linalg.inv(l2g_r2)
    return ((pts - pc[0:3]) / span).clamp(0.0, 1.0)
