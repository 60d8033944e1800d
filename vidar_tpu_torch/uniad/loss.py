"""UniAD's weighted multi-task loss (port of vidar_tpu/uniad/loss.py;
reference uniad_e2e.py:27-47, 231).

The heads return raw predictions; this module assembles the
``task_loss_weight``-weighted total from the per-head losses with
fixed-capacity targets. The motion and occupancy targets follow the
track assignment: the Hungarian match of the single-frame step, or the
clip matcher's last-frame match.

Across processes each rank computes its share of the global batch's
loss: every batch-dependent normaliser (the single-frame step's positive
count, the map loss's mean over samples, the supervised agents, slots and
plan steps) is summed over the ranks here, in the loss assembly, where
every rank reaches it in the same order (``parallel.mesh.global_sum``:
the value itself in one process). Per-sample normalisers (the map
matcher's gt count, the clip matcher's) stay local, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..core import bbox as bbox_core
from ..parallel.mesh import global_sum
from ..parallel.multihost import world_size
from .motion_head import supervised_agents, traj_loss
from .occ_head import dice_loss_with_masks, fiery_binary_seg_loss
from .panseg_head import panseg_loss_single
from .planning_head import planning_loss


@dataclasses.dataclass
class UniADTargets:
    """Fixed-capacity ground truth of a UniAD training batch. G / Gm cap
    the detection / map counts; T / To / Tp are the motion / occupancy /
    planning horizons. The ``track_*`` clip fields ([B, Tc, ...], Tc the
    clip length) carry per-frame gt with clip-consistent instance ids;
    without them the step trains the single frame."""
    gt_boxes: torch.Tensor        # [B, G, 9] cx cy cz w l h rot vx vy
    gt_labels: torch.Tensor       # [B, G] int
    num_valid_gt: torch.Tensor    # [B] int
    map_boxes: torch.Tensor       # [B, Gm, 4] cxcywh in [0, 1]
    map_labels: torch.Tensor      # [B, Gm] int
    num_valid_map: torch.Tensor   # [B] int
    gt_traj: torch.Tensor         # [B, G, T, 2] future agent xy
    gt_traj_valid: torch.Tensor   # [B, G, T] {0, 1}
    sdc_traj: torch.Tensor        # [B, Tp, 3] x y yaw
    sdc_mask: torch.Tensor        # [B, Tp] {0, 1}
    gt_occ: torch.Tensor          # [B, G, To, H, W] instance occupancy
    map_masks: torch.Tensor       # [B, Gm, Hb, Wb] map element masks
    track_boxes: Optional[torch.Tensor] = None   # [B, Tc, G, 10]
    track_labels: Optional[torch.Tensor] = None  # [B, Tc, G] int
    track_ids: Optional[torch.Tensor] = None     # [B, Tc, G] int, -1 pad
    track_num: Optional[torch.Tensor] = None     # [B, Tc] int
    l2g_r: Optional[torch.Tensor] = None         # [B, Tc, 3, 3]
    l2g_t: Optional[torch.Tensor] = None         # [B, Tc, 3]
    timestamp: Optional[torch.Tensor] = None     # [B, Tc] seconds

    def to(self, device) -> 'UniADTargets':
        return UniADTargets(**{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name).to(device))
            for f in dataclasses.fields(self)})


DEFAULT_TASK_WEIGHTS = dict(track=1.0, map=1.0, motion=1.0, occ=1.0,
                            planning=1.0)


@torch.no_grad()
def _track_assign(cls_scores, bbox_preds, gt_norm, gt_labels, num_valid_gt,
                  cls_weight: float = 2.0, bbox_weight: float = 0.25):
    """Per-sample Hungarian assignment -> [B, Q] gt row or -1."""
    g = gt_norm.shape[1]
    out = []
    for i in range(cls_scores.shape[0]):
        cost = (bbox_core.focal_loss_cost(cls_scores[i], gt_labels[i],
                                          weight=cls_weight) +
                bbox_core.bbox3d_l1_cost(bbox_preds[i], gt_norm[i],
                                         weight=bbox_weight))
        pad = torch.arange(g, device=cost.device) >= num_valid_gt[i]
        out.append(bbox_core.hungarian_assign(
            cost.masked_fill(pad[None, :], 1e8), num_valid_gt[i]))
    return torch.stack(out)


def _detr_losses(cls_scores, bbox_preds, assigned, gt_norm, gt_labels,
                 num_classes, cls_weight: float = 2.0,
                 bbox_weight: float = 0.25):
    g = gt_norm.shape[1]
    pos = assigned >= 0
    a_safe = assigned.clamp(0, g - 1)
    labels = torch.where(pos, torch.gather(gt_labels.long(), 1, a_safe),
                         torch.full_like(a_safe, num_classes))
    targets = torch.gather(gt_norm, 1, a_safe[..., None].expand(
        -1, -1, gt_norm.shape[-1]))
    num_pos = global_sum(pos.sum().float()).clamp(min=1.0)
    cls_l = bbox_core.sigmoid_focal_loss(
        cls_scores, labels, num_classes).sum() * cls_weight / num_pos
    isfin = (torch.isfinite(targets).all(-1) & pos)[..., None]
    # a padding box normalises to -inf: selected away, not multiplied by
    # 0, so that its NaN cannot zero the batch's loss (as the detection
    # head's loss, models/detection.py)
    targets = torch.where(isfin, targets, torch.zeros_like(targets))
    l1 = ((bbox_preds - targets).abs() * isfin.to(bbox_preds.dtype)).sum()
    return (torch.nan_to_num(cls_l),
            torch.nan_to_num(l1 * bbox_weight / num_pos))


def uniad_loss(out, targets: UniADTargets,
               task_loss_weight: Optional[dict] = None,
               num_det_classes: int = 10, num_map_things: int = 3):
    """The single-frame step's weighted loss of ``UniAD.forward``'s dict
    -> (total, dict of per-term losses)."""
    w = dict(DEFAULT_TASK_WEIGHTS, **(task_loss_weight or {}))
    all_cls = out['det']['all_cls_scores']
    all_box = out['det']['all_bbox_preds']
    gt_norm = bbox_core.normalize_bbox(targets.gt_boxes)
    track_total = 0.0
    assigned = None
    for lid in range(all_cls.shape[0]):
        assigned = _track_assign(all_cls[lid], all_box[lid], gt_norm,
                                 targets.gt_labels, targets.num_valid_gt)
        cls_l, box_l = _detr_losses(all_cls[lid], all_box[lid], assigned,
                                    gt_norm, targets.gt_labels,
                                    num_det_classes)
        track_total = track_total + cls_l + box_l
    return _downstream_losses(out, targets, assigned, w,
                              {'track.loss': track_total}, num_map_things)


def uniad_clip_loss(track_losses, out, targets: UniADTargets, matched_last,
                    task_loss_weight: Optional[dict] = None,
                    num_map_things: int = 3):
    """The clip step's weighted loss: ``track_losses`` from
    ``UniAD.clip_forward``, the heads aligned to gt by ``matched_last``
    [B, cap], the last frame's match -> (total, dict of per-term
    losses)."""
    w = dict(DEFAULT_TASK_WEIGHTS, **(task_loss_weight or {}))
    losses = {'track.loss': track_losses['loss_cls'] +
              track_losses['loss_bbox']}
    return _downstream_losses(out, targets, matched_last, w, losses,
                              num_map_things)


def occ_loss(occ_logits, gt_occ, a_safe, pos):
    """Focal plus dice loss of [B, A, To, H, W] instance-occupancy logits
    against the [B, G, Tg, H, W] gt rows ``a_safe`` [B, A'] selects
    (slots with ``pos`` false count nothing), each a mean over the global
    batch's ``pos`` slots (every rank calls it, from
    ``_downstream_losses``). Block 0 of the logits is
    the present and block k the k-th future frame; the dataset's gt
    holds future frames only, gt[k] at time k + 1. Where Tg is To or 1
    the blocks pair with the gt as in the JAX package (which fails to
    broadcast any other Tg); else, as with the released configs' 5
    blocks against 4 gt frames, block k + 1 is held to gt[k] and the
    present block is left unsupervised."""
    gt_occ = gt_occ[:, :, :occ_logits.shape[2]]
    gt_occ = torch.gather(gt_occ, 1, a_safe[..., None, None, None].expand(
        -1, -1, *gt_occ.shape[2:]))
    occ_a = occ_logits[:, :gt_occ.shape[1]]
    t_gt = gt_occ.shape[2]
    if t_gt not in (1, occ_a.shape[2]):
        occ_a = occ_a[:, :, 1:1 + t_gt]
    valid = pos[..., None, None, None].float()
    num_pos = global_sum(pos.sum().float())
    return (fiery_binary_seg_loss(occ_a, gt_occ, valid, num_pos) +
            dice_loss_with_masks(occ_a, gt_occ, valid, num_pos))


def _downstream_losses(out, targets: UniADTargets, assigned_last, w, losses,
                       num_map_things: int = 3):
    # ---- map: the last seg layer's DETR loss, averaged over the global
    # batch's samples ----
    seg_cls = out['seg']['outputs_classes'][-1]
    seg_box = out['seg']['outputs_coords'][-1]
    per = [panseg_loss_single(seg_cls[i], seg_box[i], targets.map_labels[i],
                              targets.map_boxes[i], targets.num_valid_map[i],
                              num_things_classes=num_map_things)
           for i in range(seg_cls.shape[0])]
    map_assign = torch.stack([p.pop('assign') for p in per])
    global_bs = seg_cls.shape[0] * world_size()
    map_total = sum(torch.stack([p[k] for p in per]).sum() / global_bs
                    for k in per[0])
    # the thing masks (reference DiceLoss weight 2.0, panseg_head.py:64):
    # the gt masks follow the Hungarian assignment through the top-k
    seg_masks = out['seg'].get('masks')
    if seg_masks is not None:
        top = seg_masks['thing_index']                        # [B, K]
        gm = targets.map_masks.shape[1]
        a_top = torch.gather(map_assign, 1, top)
        safe_m = a_top.clamp(0, gm - 1)
        hb, wb = targets.map_masks.shape[2:]
        gt_m = torch.gather(targets.map_masks, 1, safe_m[..., None, None]
                            .expand(-1, -1, hb, wb))
        valid_m = (a_top >= 0)[..., None, None].float()
        map_total = map_total + 2.0 * dice_loss_with_masks(
            seg_masks['thing_masks'], gt_m, valid_m,
            global_sum(valid_m.sum()))
    losses['map.loss'] = map_total

    # ---- motion: the MTP loss on the slots the track assignment aligns --
    g = targets.gt_boxes.shape[1]
    pos = assigned_last >= 0
    a_safe = assigned_last.clamp(0, g - 1)
    t_m = targets.gt_traj.shape[2]
    agent_traj = torch.gather(targets.gt_traj, 1, a_safe[..., None, None]
                              .expand(-1, -1, t_m, 2))
    agent_valid = torch.gather(targets.gt_traj_valid, 1, a_safe[..., None]
                               .expand(-1, -1, t_m))
    # the ego's slot, the last, supervised with the plan gt; a plan
    # shorter than the motion horizon (6 of 12 steps in the released
    # configs, where the JAX package's concatenation fails) is padded with
    # steps marked invalid
    pad = max(t_m - targets.sdc_traj.shape[1], 0)
    sdc_xy = F.pad(targets.sdc_traj[:, :t_m, :2], (0, 0, 0, pad))[:, None]
    sdc_valid = F.pad(targets.sdc_mask[:, :t_m], (0, pad))[:, None]
    traj_valid = torch.cat([agent_valid.float(), sdc_valid.float()], 1)
    agent_mask = torch.cat([pos.float(),
                            torch.ones_like(pos[:, :1]).float()], 1)
    motion = traj_loss(
        out['motion']['all_traj_scores'][-1],
        out['motion']['all_traj_preds'][-1],
        torch.cat([agent_traj, sdc_xy], 1), traj_valid, agent_mask,
        global_sum(supervised_agents(traj_valid, agent_mask).sum()))
    losses['motion.loss'] = motion['loss_traj']

    # ---- occupancy, aligned by the same assignment ----
    losses['occ.loss'] = occ_loss(out['occ']['ins_occ_logits'],
                                  targets.gt_occ, a_safe, pos)

    # ---- planning ----
    tp = out['plan']['sdc_traj'].shape[1]
    plan_mask = targets.sdc_mask[:, :tp]
    losses['planning.loss'] = planning_loss(
        out['plan']['sdc_traj'], targets.sdc_traj[:, :tp, :2], plan_mask,
        global_sum(plan_mask.float().sum()))
    total = (w['track'] * losses['track.loss'] +
             w['map'] * losses['map.loss'] +
             w['motion'] * losses['motion.loss'] +
             w['occ'] * losses['occ.loss'] +
             w['planning'] * losses['planning.loss'])
    return total, losses
