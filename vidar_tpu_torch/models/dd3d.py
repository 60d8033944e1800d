"""DD3D: FCOS-style monocular 3D detection (port of
vidar_tpu/models/dd3d.py; reference projects/mmdet3d_plugin/dd3d/).

The FCOS2D head (class logits, l/t/r/b box distances, centerness), the
FCOS3D head (allocentric quaternion, projected-centre offset, depth, size,
confidence), the nuScenes attribute and speed extension, the dense target
assignment (every location picks its smallest matching GT; padded GT are
inert), the focal, GIoU and disentangled smooth-L1 corner losses, and the
decode with a fixed-shape class-wise NMS (no torchvision). Per-level maps
are NHWC in and out, as in the JAX package, whose flattening order the
losses and the decode follow; the convs run NCHW inside. The tower norms
are GroupNorm, flax's epsilon. Every top-k breaks ties towards the lower
index, as ``jax.lax.top_k``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.bbox import stable_topk
from ..device import resolve_device
from .layers import Conv2d, GroupNorm

EPS = 1e-7
INF = 1e8

# canonical box sizes per nuScenes class (w, l, h), the dd3d configs'
NUSCENES_CANON_SIZES = (
    (1.97, 4.63, 1.74),   # car
    (2.51, 6.93, 2.84),   # truck
    (2.85, 6.37, 3.19),   # construction_vehicle
    (2.93, 10.5, 3.47),   # bus
    (2.90, 12.29, 3.87),  # trailer
    (0.50, 2.53, 0.98),   # barrier
    (0.77, 2.11, 1.47),   # motorcycle
    (0.60, 1.70, 1.28),   # bicycle
    (0.67, 0.73, 1.77),   # pedestrian
    (0.41, 0.41, 1.07),   # traffic_cone
)

# BOX3D_CORNER_MAPPING (structures/boxes3d.py:10-14): xyz signs of the 8
# corners in the object frame, scaled by (l, w, h) / 2
_CORNER_SIGNS = np.array([
    [1, 1, 1], [1, -1, 1], [1, -1, -1], [1, 1, -1],
    [-1, 1, 1], [-1, -1, 1], [-1, -1, -1], [-1, 1, -1]], np.float32)


# ---------------------------------------------------------------------------
# Quaternion / projection geometry (utils/geometry.py)
# ---------------------------------------------------------------------------

def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) -> [..., 3, 3] (geometry.py:78-118)."""
    r, i, j, k = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_s = 2.0 / torch.clamp((q * q).sum(-1), min=EPS)
    o = torch.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j)], -1)
    return o.reshape(q.shape[:-1] + (3, 3))


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a zero gradient where x <= 0 (the reference's
    pytorch3d helper): sqrt(clamp(x, 0)) has the gradient 0 x inf = NaN
    there, which a rotation's rounding reaches (ROADMAP.md §3)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4], the best-conditioned of four candidates
    (geometry.py:24-76)."""
    f = m.reshape(m.shape[:-2] + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = f.unbind(-1)
    q_abs2 = torch.stack([1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    q_abs = _sqrt_positive_part(q_abs2)
    cand = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01],
                    -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20],
                    -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21],
                    -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2],
                    -1),
    ], -2)
    cand = cand / torch.clamp(2.0 * q_abs[..., None], min=0.2)
    best = q_abs.argmax(-1)
    return torch.gather(cand, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]


def unproject_points2d(pts: torch.Tensor, inv_k: torch.Tensor
                       ) -> torch.Tensor:
    """[N, 2] pixels x [N, 3, 3] inverse intrinsics -> [N, 3] rays
    (geometry.py:179-204)."""
    homo = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    return torch.einsum('nij,nj->ni', inv_k, homo)


def _unit(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=EPS)


def allocentric_to_egocentric(quat: torch.Tensor, proj_ctr: torch.Tensor,
                              inv_k: torch.Tensor) -> torch.Tensor:
    """The allocentric quaternion rotated by the viewing ray's frame
    (geometry.py:118-148)."""
    r_obj = quaternion_to_matrix(quat)
    z = _unit(unproject_points2d(proj_ctr, inv_k))
    y = _unit(z.new_tensor([0.0, 1.0, 0.0]) - z[:, 1:2] * z)
    x = torch.linalg.cross(y, z)
    r_glob = torch.stack([x, y, z], -1) @ r_obj
    return _unit(matrix_to_quaternion(r_glob))


def boxes3d_corners(quat, proj_ctr, depth, size, inv_k) -> torch.Tensor:
    """Vision-frame 3D box corners [N, 8, 3] (structures/boxes3d.py:76-96,
    189-206): the (l, w, h)-scaled sign template rotated, then moved to
    the ray through the projected centre at ``depth``."""
    tvec = unproject_points2d(proj_ctr, inv_k) * depth
    r = quaternion_to_matrix(quat)
    lwh = size[:, [1, 0, 2]]
    base = 0.5 * lwh[:, None, :] * torch.from_numpy(_CORNER_SIGNS).to(
        size.device)[None]
    return torch.einsum('nij,nkj->nki', r, base) + tvec[:, None, :]


def predictions_to_boxes3d(quat, proj_ctr, depth, size, locations, inv_k,
                           canon_sizes, min_depth=0.1, max_depth=80.0,
                           scale_depth_factor=500.0,
                           quat_is_allocentric=True):
    """Raw head outputs -> box parameters (fcos3d.py:17-54), all [N, ...]."""
    quat = _unit(quat)
    pixel = torch.linalg.norm(torch.stack([inv_k[:, 0, 0], inv_k[:, 1, 1]],
                                          -1), dim=-1)
    depth = depth / (pixel * scale_depth_factor)
    depth = depth.reshape(-1, 1).clamp(min_depth, max_depth)
    proj_ctr = proj_ctr + locations
    if quat_is_allocentric:
        quat = allocentric_to_egocentric(quat, proj_ctr, inv_k)
    size = (torch.tanh(size) + 1.0) * canon_sizes  # at most 2x canonical
    return quat, proj_ctr, depth, size


# ---------------------------------------------------------------------------
# Heads
# ---------------------------------------------------------------------------

def _gn(ch: int) -> int:
    g = 32
    while ch % g:
        g //= 2
    return max(g, 1)


class _Scale(nn.Module):
    """A learned scalar multiplier (layers/normalization.py Scale)."""

    def __init__(self, init_value: float = 1.0, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value),
                                               device=device))

    def forward(self, x):
        return x * self.scale


class _Offset(nn.Module):
    """A learned scalar offset (layers/normalization.py Offset)."""

    def __init__(self, init_value: float = 0.0, device=None):
        super().__init__()
        self.offset = nn.Parameter(torch.tensor(float(init_value),
                                                device=device))

    def forward(self, x):
        return x + self.offset


class _Tower(nn.Module):
    """num_convs x (conv3x3 + GroupNorm + relu), shared by the levels
    (fcos2d.py:53-93, fcos3d.py:92-113). NCHW."""

    def __init__(self, channels: int, num_convs: int = 4, dtype=None,
                 device=None):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f'conv{i}', Conv2d(
                channels, channels, 3, padding=1, use_bias=False,
                dtype=dtype, device=device))
            self.add_module(f'norm{i}', GroupNorm(
                _gn(channels), channels, eps=1e-6, device=device))

    def forward(self, x):
        for i in range(self.num_convs):
            x = torch.relu(getattr(self, f'norm{i}')(
                getattr(self, f'conv{i}')(x)))
        return x


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class FCOS2DHead(nn.Module):
    """Per-level class logits [B, H, W, K], box distances [B, H, W, 4]
    (l, t, r, b: scaled, exp, times the stride) and centerness [B, H, W, 1]
    (fcos2d.py:31-165); also the box tower's NCHW features."""

    def __init__(self, channels: int = 256, num_classes: int = 10,
                 in_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 num_cls_convs: int = 4, num_box_convs: int = 4,
                 use_scale: bool = True, dtype=None, device=None):
        super().__init__()
        self.in_strides = tuple(in_strides)
        self.use_scale = use_scale
        kw = dict(dtype=dtype, device=device)
        self.cls_tower = _Tower(channels, num_cls_convs, **kw)
        self.box2d_tower = _Tower(channels, num_box_convs, **kw)
        self.cls_logits = Conv2d(channels, num_classes, 3, padding=1, **kw)
        self.box2d_reg = Conv2d(channels, 4, 3, padding=1, **kw)
        self.centerness = Conv2d(channels, 1, 3, padding=1, **kw)
        if use_scale:
            for lvl in range(len(self.in_strides)):
                self.add_module(f'scales_reg_{lvl}', _Scale(1.0, device))

    def forward(self, feats):
        """feats: per-level NCHW maps."""
        logits, boxes, ctr, box_feats = [], [], [], []
        for lvl, f in enumerate(feats):
            b = self.box2d_tower(f)
            logits.append(_nhwc(self.cls_logits(self.cls_tower(f))))
            reg = self.box2d_reg(b)
            if self.use_scale:
                reg = getattr(self, f'scales_reg_{lvl}')(reg)
            boxes.append(_nhwc(torch.exp(reg) * self.in_strides[lvl]))
            ctr.append(_nhwc(self.centerness(b)))
            box_feats.append(b)
        return logits, boxes, ctr, box_feats


class FCOS3DHead(nn.Module):
    """Per-level quaternion, projected-centre offset, depth, size and
    confidence maps, NHWC (fcos3d.py:57-203)."""

    def __init__(self, channels: int = 256, num_classes: int = 10,
                 in_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 num_convs: int = 4, depth_scale_init_factor: float = 0.3,
                 proj_ctr_scale_init_factor: float = 1.0,
                 mean_depth_per_level: Sequence[float] = (44.9, 20.3, 27.8,
                                                          34.9, 44.4),
                 std_depth_per_level: Sequence[float] = (27.7, 16.4, 15.4,
                                                         15.6, 14.5),
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_levels = len(in_strides)
        self.box3d_tower = _Tower(channels, num_convs, **kw)
        self.box3d_quat = Conv2d(channels, 4, 3, padding=1, **kw)
        self.box3d_ctr = Conv2d(channels, 2, 3, padding=1, **kw)
        self.box3d_depth = Conv2d(channels, 1, 3, padding=1, use_bias=False,
                                  **kw)
        self.box3d_size = Conv2d(channels, 3, 3, padding=1, **kw)
        self.box3d_conf = Conv2d(channels, 1, 3, padding=1, **kw)
        for lvl, s in enumerate(in_strides):
            self.add_module(f'scales_proj_ctr_{lvl}', _Scale(
                s * proj_ctr_scale_init_factor, device))
            self.add_module(f'scales_depth_{lvl}', _Scale(
                std_depth_per_level[lvl] * depth_scale_init_factor, device))
            self.add_module(f'offsets_depth_{lvl}', _Offset(
                mean_depth_per_level[lvl], device))
            self.add_module(f'scales_size_{lvl}', _Scale(1.0, device))
            self.add_module(f'scales_conf_{lvl}', _Scale(1.0, device))

    def forward(self, feats):
        quat, ctr, depth, size, conf = [], [], [], [], []
        for lvl, f in enumerate(feats):
            t = self.box3d_tower(f)
            quat.append(_nhwc(self.box3d_quat(t)))
            ctr.append(_nhwc(getattr(self, f'scales_proj_ctr_{lvl}')(
                self.box3d_ctr(t))))
            dp = getattr(self, f'scales_depth_{lvl}')(self.box3d_depth(t))
            depth.append(_nhwc(getattr(self, f'offsets_depth_{lvl}')(dp)))
            size.append(_nhwc(getattr(self, f'scales_size_{lvl}')(
                self.box3d_size(t))))
            conf.append(_nhwc(getattr(self, f'scales_conf_{lvl}')(
                self.box3d_conf(t))))
        return quat, ctr, depth, size, conf


# ---------------------------------------------------------------------------
# Locations + target assignment (prepare_targets.py:12-242)
# ---------------------------------------------------------------------------

def compute_locations(shapes: Sequence[Tuple[int, int]],
                      strides: Sequence[int], device=None
                      ) -> List[torch.Tensor]:
    """Pixel-centre locations per level: [H*W, 2] (x, y)."""
    out = []
    for (h, w), s in zip(shapes, strides):
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * s
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * s
        gy, gx = torch.meshgrid(ys, xs, indexing='ij')
        out.append(torch.stack([gx, gy], -1).reshape(-1, 2))
    return out


DEFAULT_SIZES_OF_INTEREST = ((-1, 64), (64, 128), (128, 256), (256, 512),
                             (512, INF))


def prepare_targets(locations: List[torch.Tensor], strides: Sequence[int],
                    gt_boxes2d: torch.Tensor, gt_labels: torch.Tensor,
                    num_valid_gt, num_classes: int,
                    sizes_of_interest=DEFAULT_SIZES_OF_INTEREST,
                    center_sample: bool = True, radius: float = 1.5):
    """Dense FCOS assignment for ONE image: gt_boxes2d [G, 4] xyxy
    (padded), gt_labels [G], num_valid_gt [] -> dict(labels [L], box2d_reg
    [L, 4], matched_idx [L], pos [L]), L the locations of all levels."""
    loc = torch.cat(locations, 0)
    dev = loc.device
    size_lo = torch.cat([torch.full((l.shape[0],), float(sizes_of_interest[
        i][0]), device=dev) for i, l in enumerate(locations)])
    size_hi = torch.cat([torch.full((l.shape[0],), float(sizes_of_interest[
        i][1]), device=dev) for i, l in enumerate(locations)])
    stride_per_loc = torch.cat([torch.full((l.shape[0],), float(strides[i]),
                                           device=dev)
                                for i, l in enumerate(locations)])
    g = gt_boxes2d.shape[0]
    x, y = loc[:, 0:1], loc[:, 1:2]
    reg = torch.stack([x - gt_boxes2d[None, :, 0], y - gt_boxes2d[None, :, 1],
                       gt_boxes2d[None, :, 2] - x,
                       gt_boxes2d[None, :, 3] - y], -1)          # [L, G, 4]
    inside = reg.amin(-1) > 0
    if center_sample:
        cx = (gt_boxes2d[:, 0] + gt_boxes2d[:, 2]) / 2
        cy = (gt_boxes2d[:, 1] + gt_boxes2d[:, 3]) / 2
        rad = radius * stride_per_loc[:, None]
        inside = inside & ((x - cx[None]).abs() < rad) & (
            (y - cy[None]).abs() < rad)
    max_reg = reg.amax(-1)
    fits = (max_reg >= size_lo[:, None]) & (max_reg <= size_hi[:, None])
    valid = torch.arange(g, device=dev)[None, :] < num_valid_gt
    cand = inside & fits & valid
    area = ((gt_boxes2d[:, 2] - gt_boxes2d[:, 0]) *
            (gt_boxes2d[:, 3] - gt_boxes2d[:, 1]))
    matched = torch.where(cand, area[None, :], INF).argmin(-1)   # [L]
    pos = cand.any(-1)
    labels = torch.where(pos, gt_labels.long()[matched], num_classes)
    box2d_reg = reg[torch.arange(reg.shape[0], device=dev), matched]
    return dict(labels=labels, box2d_reg=box2d_reg, matched_idx=matched,
                pos=pos)


def compute_ctrness_targets(reg: torch.Tensor) -> torch.Tensor:
    """sqrt((min_lr / max_lr) * (min_tb / max_tb)) (fcos2d.py:21-29)."""
    lr = reg[..., [0, 2]]
    tb = reg[..., [1, 3]]
    ctr = (lr.amin(-1) / lr.amax(-1).clamp(min=EPS)) * \
        (tb.amin(-1) / tb.amax(-1).clamp(min=EPS))
    return torch.sqrt(ctr.clamp(min=0.0))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _focal(logits, labels, num_classes, alpha=0.25, gamma=2.0):
    """Sigmoid focal loss per (location, class); label ``num_classes`` is
    background (no class on)."""
    onehot = F.one_hot(labels, num_classes + 1)[..., :num_classes].float()
    p = torch.sigmoid(logits)
    ce = (-onehot * F.logsigmoid(logits) -
          (1 - onehot) * F.logsigmoid(-logits))
    pt = p * onehot + (1 - p) * (1 - onehot)
    at = alpha * onehot + (1 - alpha) * (1 - onehot)
    return at * (1 - pt) ** gamma * ce


def _ltrb_overlap(pred, target):
    """-> (intersection, union) of (l, t, r, b) boxes at one location."""
    p_area = (pred[..., 0] + pred[..., 2]) * (pred[..., 1] + pred[..., 3])
    t_area = (target[..., 0] + target[..., 2]) * \
        (target[..., 1] + target[..., 3])
    iw = torch.minimum(pred[..., 0], target[..., 0]) + \
        torch.minimum(pred[..., 2], target[..., 2])
    ih = torch.minimum(pred[..., 1], target[..., 1]) + \
        torch.minimum(pred[..., 3], target[..., 3])
    inter = iw.clamp(min=0) * ih.clamp(min=0)
    return inter, p_area + t_area - inter


def iou_ltrb(pred, target):
    """IoU of (l, t, r, b) distance boxes at the same location
    (layers/iou_loss.py)."""
    inter, union = _ltrb_overlap(pred, target)
    return inter / union.clamp(min=EPS)


def smooth_l1(x, y, beta: float):
    d = (x - y).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def _bce_logits(x, t):
    return x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def fcos2d_loss(logits, box2d_reg, centerness, targets, num_classes,
                loc_loss: str = 'giou'):
    """Per-image FCOS2D loss (fcos2d.py:166-256); inputs flattened
    [L, ...]."""
    pos = targets['pos'].float()
    num_pos = pos.sum().clamp(min=1.0)
    cls_l = _focal(logits, targets['labels'], num_classes).sum() / num_pos
    tgt = targets['box2d_reg']
    ctr_t = compute_ctrness_targets(tgt)
    denom = (ctr_t * pos).sum().clamp(min=1e-6)
    if loc_loss == 'giou':
        # the enclosing box of two ltrb boxes at one anchor: max per side
        ew = torch.maximum(box2d_reg[..., 0], tgt[..., 0]) + \
            torch.maximum(box2d_reg[..., 2], tgt[..., 2])
        eh = torch.maximum(box2d_reg[..., 1], tgt[..., 1]) + \
            torch.maximum(box2d_reg[..., 3], tgt[..., 3])
        earea = (ew * eh).clamp(min=EPS)
        inter, union = _ltrb_overlap(box2d_reg, tgt)
        loc_term = 1.0 - (inter / union.clamp(min=EPS) -
                          (earea - union) / earea)
    else:
        loc_term = -torch.log(iou_ltrb(box2d_reg, tgt).clamp(min=EPS))
    loc_l = (loc_term * ctr_t * pos).sum() / denom
    ctr_l = (_bce_logits(centerness[..., 0], ctr_t) * pos).sum() / num_pos
    return dict(loss_cls=cls_l, loss_box2d_reg=loc_l, loss_centerness=ctr_l)


def fcos3d_loss(quat, ctr, depth, size, conf, targets, locations, inv_k,
                gt_boxes3d: Dict[str, torch.Tensor], canon_sizes,
                num_classes: int, smooth_l1_beta: float = 0.05,
                max_loss_per_group: float = 20.0,
                conf_3d_temperature: float = 1.0,
                box3d_loss_weight: float = 2.0,
                conf3d_loss_weight: float = 1.0):
    """Per-image disentangled 3D loss (fcos3d.py:204-330,
    disentangled_box3d_loss.py:12-46); inputs flattened [L, ...];
    ``gt_boxes3d`` holds quat [G, 4], proj_ctr [G, 2], depth [G, 1] and
    size [G, 3] in the vision frame."""
    pos = targets['pos'].float()
    m = targets['matched_idx']
    num_pos = pos.sum().clamp(min=1.0)
    canon = canon_sizes[targets['labels'].clamp(0, num_classes - 1)]
    inv_k_l = inv_k[None].expand(quat.shape[0], 3, 3)
    pq, pc, pd, ps = predictions_to_boxes3d(quat, ctr, depth[..., 0], size,
                                            locations, inv_k_l, canon)
    tq, tc = gt_boxes3d['quat'][m], gt_boxes3d['proj_ctr'][m]
    td, ts = gt_boxes3d['depth'][m], gt_boxes3d['size'][m]
    tgt_corners = boxes3d_corners(tq, tc, td, ts, inv_k_l)
    losses = {}
    components = dict(quat=(pq, tq), proj_ctr=(pc, tc), depth=(pd, td),
                      size=(ps, ts))
    for key in ('quat', 'proj_ctr', 'depth', 'size'):
        parts = {k: v[0] if k == key else v[1]
                 for k, v in components.items()}
        pred_c = boxes3d_corners(parts['quat'], parts['proj_ctr'],
                                 parts['depth'], parts['size'], inv_k_l)
        l = smooth_l1(pred_c, tgt_corners, smooth_l1_beta)
        l = l.reshape(-1, 24).mean(-1).clamp(max=max_loss_per_group)
        losses[f'loss_box3d_{key}'] = \
            box3d_loss_weight * (l * pos).sum() / num_pos
    pred_c = boxes3d_corners(pq, pc, pd, ps, inv_k_l)
    l1_dist = (tgt_corners - pred_c).abs().reshape(-1, 24).mean(-1).detach()
    conf_target = torch.exp(-l1_dist / conf_3d_temperature)
    losses['loss_conf3d'] = conf3d_loss_weight * (
        _bce_logits(conf[..., 0], conf_target) * pos).sum() / num_pos
    return losses


# ---------------------------------------------------------------------------
# NuScenes DD3D detector
# ---------------------------------------------------------------------------

def _flat(maps, c):
    return torch.cat([m.reshape(-1, c) for m in maps], 0)


class NuScenesDD3D(nn.Module):
    """FCOS2D + FCOS3D + nuScenes attribute and speed heads over FPN maps
    (modeling/nuscenes_dd3d.py:204-522, core.py:24-216). ``forward`` takes
    a list of per-level NHWC maps of ``channels`` channels and returns the
    per-level NHWC predictions; ``loss`` and ``inference`` take one
    image's. Entry point: builds on the card unless the caller passes
    ``device='cpu'``."""

    def __init__(self, num_classes: int = 10, num_attributes: int = 8,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 canon_box_sizes: Sequence[Sequence[float]] = (
                     NUSCENES_CANON_SIZES),
                 nms_thresh: float = 0.75, pre_nms_topk: int = 1000,
                 post_nms_topk: int = 100, score_thresh: float = 0.05,
                 channels: int = 256, dtype=None, device='cuda'):
        super().__init__()
        device = resolve_device(device)
        self.num_classes, self.num_attributes = num_classes, num_attributes
        self.strides = tuple(strides)
        self.register_buffer('canon_box_sizes', torch.tensor(
            canon_box_sizes, dtype=torch.float32, device=device),
                             persistent=False)
        self.nms_thresh, self.pre_nms_topk = nms_thresh, pre_nms_topk
        self.post_nms_topk, self.score_thresh = post_nms_topk, score_thresh
        kw = dict(dtype=dtype, device=device)
        self.fcos2d_head = FCOS2DHead(channels, num_classes, self.strides,
                                      **kw)
        self.fcos3d_head = FCOS3DHead(channels, num_classes, self.strides,
                                      **kw)
        self.attr_logits = Conv2d(channels, num_attributes, 3, padding=1,
                                  **kw)
        self.speed = Conv2d(channels, 1, 3, padding=1, **kw)

    def forward(self, feats: Sequence[torch.Tensor]):
        feats = [f.permute(0, 3, 1, 2) for f in feats]
        logits, box2d, ctrness, box_feats = self.fcos2d_head(feats)
        quat, ctr, depth, size, conf = self.fcos3d_head(feats)
        attrs = [_nhwc(self.attr_logits(f)) for f in box_feats]
        speeds = [torch.relu(self.speed(f))[:, 0] for f in box_feats]
        return dict(logits=logits, box2d_reg=box2d, centerness=ctrness,
                    quat=quat, proj_ctr=ctr, depth=depth, size=size,
                    conf=conf, attr_logits=attrs, speeds=speeds)

    def _locations(self, preds):
        shapes = [tuple(p.shape[1:3]) for p in preds['logits']]
        return compute_locations(shapes, self.strides,
                                 preds['logits'][0].device)

    def loss(self, preds, gt, inv_k):
        """FCOS2D + FCOS3D losses of one image. gt: dict(boxes2d [G, 4],
        labels [G], num_valid [], quat, proj_ctr, depth, size as
        ``fcos3d_loss`` takes them); inv_k [3, 3]."""
        locs = self._locations(preds)
        tgt = prepare_targets(locs, self.strides, gt['boxes2d'],
                              gt['labels'], gt['num_valid'],
                              self.num_classes)
        losses = fcos2d_loss(_flat(preds['logits'], self.num_classes),
                             _flat(preds['box2d_reg'], 4),
                             _flat(preds['centerness'], 1), tgt,
                             self.num_classes)
        losses.update(fcos3d_loss(
            _flat(preds['quat'], 4), _flat(preds['proj_ctr'], 2),
            _flat(preds['depth'], 1), _flat(preds['size'], 3),
            _flat(preds['conf'], 1), tgt, torch.cat(locs, 0), inv_k,
            {k: gt[k] for k in ('quat', 'proj_ctr', 'depth', 'size')},
            self.canon_box_sizes, self.num_classes))
        return losses

    def inference(self, preds, inv_k):
        """The top-k 3D detections of one image -> dict(scores [K], labels
        [K], boxes2d [K, 4], corners3d [K, 8, 3], depth [K], attrs [K],
        speeds [K]), K = min(post_nms_topk, pre-NMS k); a slot no
        detection fills has score 0."""
        loc_cat = torch.cat(self._locations(preds), 0)
        logits = _flat(preds['logits'], self.num_classes)
        box2d = _flat(preds['box2d_reg'], 4)
        ctrness = _flat(preds['centerness'], 1)[:, 0]
        conf3d = torch.sigmoid(_flat(preds['conf'], 1)[:, 0])
        # score fusion (nuscenes_dd3d inference): cls x ctrness x conf3d
        scores_all = (torch.sigmoid(logits) *
                      torch.sigmoid(ctrness)[:, None] * conf3d[:, None])
        best = scores_all.amax(-1)
        labels = scores_all.argmax(-1)
        k = min(self.pre_nms_topk, best.shape[0])
        top_i = stable_topk(best, k)
        top_s = best[top_i]
        keep = top_s > self.score_thresh
        loc_k, reg_k = loc_cat[top_i], box2d[top_i]
        boxes = torch.stack([
            loc_k[:, 0] - reg_k[:, 0], loc_k[:, 1] - reg_k[:, 1],
            loc_k[:, 0] + reg_k[:, 2], loc_k[:, 1] + reg_k[:, 3]], -1)
        lab_k = labels[top_i]
        inv_k_b = inv_k[None].expand(k, 3, 3)
        pq, pc, pd, ps = predictions_to_boxes3d(
            _flat(preds['quat'], 4)[top_i], _flat(preds['proj_ctr'],
                                                  2)[top_i],
            _flat(preds['depth'], 1)[top_i][:, 0],
            _flat(preds['size'], 3)[top_i], loc_k, inv_k_b,
            self.canon_box_sizes[lab_k])
        corners = boxes3d_corners(pq, pc, pd, ps, inv_k_b)
        attrs = _flat(preds['attr_logits'], self.num_attributes)[top_i]
        speeds = torch.cat([s.reshape(-1) for s in preds['speeds']])[top_i]
        keep = keep & _classwise_nms(boxes, top_s, lab_k, self.nms_thresh)
        scores = torch.where(keep, top_s, 0.0)
        fin_i = stable_topk(scores, min(self.post_nms_topk, k))
        return dict(scores=scores[fin_i], labels=lab_k[fin_i],
                    boxes2d=boxes[fin_i], corners3d=corners[fin_i],
                    depth=pd[fin_i, 0], attrs=attrs[fin_i].argmax(-1),
                    speeds=speeds[fin_i])


def _classwise_nms(boxes, scores, labels, thresh: float) -> torch.Tensor:
    """O(K^2) masked NMS over candidates (fixed shapes): a box is dropped
    where a higher-scoring box of its class overlaps it by more than
    ``thresh`` and is itself kept; two passes, as the JAX package."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    iw = (torch.minimum(x2[:, None], x2[None]) -
          torch.maximum(x1[:, None], x1[None])).clamp(min=0)
    ih = (torch.minimum(y2[:, None], y2[None]) -
          torch.maximum(y1[:, None], y1[None])).clamp(min=0)
    inter = iw * ih
    iou = inter / (area[:, None] + area[None] - inter).clamp(min=EPS)
    suppressed_by = ((iou > thresh) & (labels[:, None] == labels[None]) &
                     (scores[None, :] > scores[:, None]))
    keep = torch.ones(boxes.shape[0], dtype=torch.bool, device=boxes.device)
    for _ in range(2):
        keep = ~(suppressed_by & keep[None, :]).any(1)
    return keep
