"""BEVHead: a single-frame BEV encode and a dense anchor-based 3D head (port
of vidar_tpu/models/bev_head.py; reference dense_heads/bev_head.py:28-131,
which delegates the dense head to mmdet3d's FreeAnchor3DHead).

``Anchor3DHead`` puts ``sizes x rotations`` anchors on every BEV cell (that
order within a cell) and predicts class logits, 7-dof deltas plus velocity
and a 2-bin direction with 3x3 and 1x1 convs. Its loss is the FreeAnchor
bag likelihood (``assigner='free_anchor'``: static top-k bags, padded GT
masked, the per-class image-level box probability as a scatter max) or a
center-nearest assignment (``assigner='nearest'``). Every top-k breaks ties
towards the lower index, as ``jax.lax.top_k``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.bbox import stable_topk
from .layers import Conv2d
from .transformer import BEVEncoderHead


def _smooth_l1(diff):
    return torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5)


def _aa_iou(b1, b2):
    """Axis-aligned BEV IoU: [G, 4] x [N, 4] -> [G, N]."""
    lt = torch.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = torch.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = ((b1[:, 2] - b1[:, 0]) * (b1[:, 3] - b1[:, 1]))[:, None]
    a2 = ((b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1]))[None, :]
    return inter / torch.clamp(a1 + a2 - inter, min=1e-6)


def _to_aa(xy, dx, dy):
    half = torch.stack([dx, dy], -1) / 2
    return torch.cat([xy - half, xy + half], -1)


class Anchor3DHead(nn.Module):
    """Dense anchors on the BEV grid: cls + 7-dof reg (+vel) + dir.
    ``embed_dims`` is both the BEV map's channel count and the shared
    conv's width."""

    def __init__(self, num_classes: int = 10, embed_dims: int = 256,
                 anchor_sizes: Tuple[Tuple[float, float, float], ...] = (
                     (4.6, 1.95, 1.72),),
                 anchor_rotations: Tuple[float, ...] = (0.0, 1.5707963),
                 anchor_z: float = -1.0,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2,
                                              3.0),
                 assigner: str = 'free_anchor', pre_anchor_topk: int = 25,
                 bbox_thr: float = 0.6, fa_gamma: float = 2.0,
                 fa_alpha: float = 0.5, dtype=None, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.anchor_sizes = tuple(tuple(s) for s in anchor_sizes)
        self.anchor_rotations = tuple(anchor_rotations)
        self.anchor_z = anchor_z
        self.pc_range = tuple(pc_range)
        self.assigner = assigner
        self.pre_anchor_topk = pre_anchor_topk
        self.bbox_thr, self.fa_gamma, self.fa_alpha = (bbox_thr, fa_gamma,
                                                       fa_alpha)
        a = self.num_anchors
        self.shared_conv = Conv2d(embed_dims, embed_dims, 3, padding=1,
                                  dtype=dtype, device=device)
        self.conv_cls = Conv2d(embed_dims, a * num_classes, 1, device=device)
        self.conv_reg = Conv2d(embed_dims, a * 9, 1, device=device)
        self.conv_dir_cls = Conv2d(embed_dims, a * 2, 1, device=device)

    @property
    def num_anchors(self):
        return len(self.anchor_sizes) * len(self.anchor_rotations)

    def anchors(self, h: int, w: int, device=None) -> torch.Tensor:
        """[h, w, A, 7] (cx cy cz l w h yaw), A = sizes x rotations."""
        kw = dict(dtype=torch.float32, device=device)
        xs = torch.linspace(self.pc_range[0], self.pc_range[3], w + 1,
                            **kw)[:-1]
        ys = torch.linspace(self.pc_range[1], self.pc_range[4], h + 1,
                            **kw)[:-1]
        xs = xs + (xs[1] - xs[0]) / 2
        ys = ys + (ys[1] - ys[0]) / 2
        gy, gx = torch.meshgrid(ys, xs, indexing='ij')
        cells = torch.stack([gx, gy], -1)
        out = []
        for (l, wd, ht) in self.anchor_sizes:
            for r in self.anchor_rotations:
                const = torch.tensor([self.anchor_z, l, wd, ht, r], **kw)
                out.append(torch.cat([cells, const.expand(h, w, 5)], -1))
        return torch.stack(out, 2)

    def forward(self, bev_map):
        """bev_map [bs, H, W, C] -> (cls [bs, HWA, K], reg [bs, HWA, 9],
        dir [bs, HWA, 2], (H, W))."""
        x = torch.relu(self.shared_conv(bev_map.permute(0, 3, 1, 2)))
        bs, _, h, w = x.shape
        n = h * w * self.num_anchors

        def flat(conv, c):
            return conv(x).permute(0, 2, 3, 1).reshape(bs, n, c)
        return (flat(self.conv_cls, self.num_classes),
                flat(self.conv_reg, 9), flat(self.conv_dir_cls, 2), (h, w))

    # ------------------------------------------------------------- training

    @staticmethod
    def _encode(gt, a_sel):
        """Delta targets: gt [.., 9] (cx cy cz w l h yaw vx vy) against
        a_sel [.., 7] (cx cy cz l w h yaw) -> [.., 9], ``get_bboxes``'
        decode inverted."""
        diag = torch.sqrt(a_sel[..., 3] ** 2 + a_sel[..., 4] ** 2)
        t_xyz = (gt[..., :3] - a_sel[..., :3]) / diag.clamp(
            min=1e-3)[..., None]
        # gt dims order (w l h) -> anchor (l w h)
        t_dim = torch.log(torch.clamp(gt[..., [4, 3, 5]] / a_sel[..., 3:6],
                                      min=1e-3))
        t_yaw = (gt[..., 6] - a_sel[..., 6])[..., None]
        t_vel = gt[..., 7:9].expand(*t_yaw.shape[:-1], 2)
        return torch.cat([t_xyz, t_dim, t_yaw, t_vel], -1)

    def loss(self, preds, gt_bboxes, gt_labels, num_valid_gt):
        """gt_bboxes [bs, G, 9] zero-padded, gt_labels [bs, G],
        num_valid_gt [bs] -> dict of scalar losses."""
        if self.assigner == 'free_anchor':
            return self._loss_free_anchor(preds, gt_bboxes, gt_labels,
                                          num_valid_gt)
        return self._loss_nearest(preds, gt_bboxes, gt_labels, num_valid_gt)

    def _loss_free_anchor(self, preds, gt_bboxes, gt_labels, num_valid_gt):
        """FreeAnchor's detection-customised likelihood (mmdet3d
        free_anchor3d_head.py): per GT a bag of its ``pre_anchor_topk``
        anchors by axis-aligned BEV IoU, the mean-max bag likelihood of
        P(cls) x exp(-(box loss + dir loss)) as the positive term, a focal
        term on P(cls) x (1 - P(anchor | object)) as the negative."""
        cls_logits, reg_preds, dir_logits, (h, w) = preds
        anchors = self.anchors(h, w, cls_logits.device).reshape(-1, 7)
        _, n, k = cls_logits.shape
        g = gt_bboxes.shape[1]
        topk = min(self.pre_anchor_topk, n)
        a_diag = torch.sqrt(anchors[:, 3] ** 2 + anchors[:, 4] ** 2)
        anchor_aa = _to_aa(anchors[:, :2], anchors[:, 3], anchors[:, 4])
        pos_l, neg_l = [], []
        for cls_l, reg_p, dir_l, gt, labels, nv in zip(
                cls_logits.float(), reg_preds.float(), dir_logits.float(),
                gt_bboxes.float(), gt_labels, num_valid_gt):
            valid = torch.arange(g, device=gt.device) < nv
            cls_prob = torch.sigmoid(cls_l)                        # [N, K]
            gt_aa = _to_aa(gt[:, :2], gt[:, 4], gt[:, 3])          # l->x w->y

            # P(anchor | object): decoded-box IoU saturated per GT
            pred_xy = anchors[:, :2] + reg_p[:, :2] * a_diag[:, None]
            pred_lw = anchors[:, 3:5] * torch.exp(reg_p[:, 3:5])
            iou = _aa_iou(gt_aa, _to_aa(pred_xy, pred_lw[:, 0],
                                        pred_lw[:, 1]))            # [G, N]
            t1 = self.bbox_thr
            t2 = torch.clamp(iou.amax(1), min=t1 + 1e-6)[:, None]
            obj_box_prob = torch.clamp(
                (iou - t1) / torch.clamp(t2 - t1, min=1e-6), 0.0, 1.0)
            obj_box_prob = obj_box_prob * valid[:, None]
            # per (class, anchor): the max over that class's GT
            seg = torch.where(valid, labels.long(), k)
            box_prob = torch.full((k + 1, n), float('-inf'),
                                  device=gt.device).scatter_reduce(
                0, seg[:, None].expand(g, n), obj_box_prob, 'amax')
            box_prob = box_prob[:k].clamp(0.0, 1.0).T              # [N, K]

            # positive bags: the top-k anchors per GT by anchor IoU
            matched = stable_topk(_aa_iou(gt_aa, anchor_aa), topk)  # [G, tk]
            lab = labels.long().clamp(0, k - 1)
            m_cls = cls_prob[matched, lab[:, None]]                # [G, tk]
            tgt = self._encode(gt[:, None, :], anchors[matched])
            loss_bbox = _smooth_l1((reg_p[matched] - tgt).abs()).sum(-1)
            dir_tgt = (gt[:, 6] > 0).long()
            ce_dir = -torch.gather(
                F.log_softmax(dir_l[matched], -1), -1,
                dir_tgt[:, None, None].expand(g, topk, 1))[..., 0]
            m_prob = m_cls * torch.exp(-(loss_bbox + ce_dir))
            # mean-max: weights 1/(1-p), normalised over the bag
            wgt = 1.0 / torch.clamp(1.0 - m_prob, min=1e-12)
            wgt = wgt / wgt.sum(-1, keepdim=True)
            bag_prob = (wgt * m_prob).sum(-1)                      # [G]
            pos = -self.fa_alpha * torch.log(bag_prob.clamp(1e-12, 1.0))
            pos_l.append((pos * valid).sum() / torch.clamp(nv, min=1))

            # negatives: focal on P(cls) * (1 - P(a | obj))
            neg_prob = cls_prob * (1.0 - box_prob)
            neg = ((1.0 - self.fa_alpha) * neg_prob ** self.fa_gamma *
                   -torch.log(torch.clamp(1.0 - neg_prob, 1e-12, 1.0)))
            neg_l.append(neg.sum() / torch.clamp(nv * topk, min=1))
        return dict(positive_bag_loss=torch.stack(pos_l).mean(),
                    negative_bag_loss=torch.stack(neg_l).mean())

    def _loss_nearest(self, preds, gt_bboxes, gt_labels, num_valid_gt):
        """Center-nearest anchor assignment, then focal / smooth-L1 /
        direction losses."""
        cls_logits, reg_preds, dir_logits, (h, w) = preds
        anchors = self.anchors(h, w, cls_logits.device).reshape(-1, 7)
        _, n, k = cls_logits.shape
        g = gt_bboxes.shape[1]
        lc, lr, ld = [], [], []
        for cls_l, reg_p, dir_l, gt, labels, nv in zip(
                cls_logits.float(), reg_preds.float(), dir_logits.float(),
                gt_bboxes.float(), gt_labels, num_valid_gt):
            valid = torch.arange(g, device=gt.device) < nv
            d = torch.linalg.norm(anchors[None, :, :2] - gt[:, None, :2],
                                  dim=-1)
            d = torch.where(valid[:, None], d, float('inf'))
            pos_anchor = d.argmin(1)                               # [G]
            tgt_cls = torch.full((n,), -1, dtype=torch.long,
                                 device=gt.device)
            # padding GT write nothing, never clobbering a real assignment
            tgt_cls[pos_anchor[valid]] = labels.long()[valid]
            onehot = F.one_hot(tgt_cls.clamp(min=0), k).float() * (
                tgt_cls >= 0)[:, None]
            p = torch.sigmoid(cls_l)
            pt = p * onehot + (1 - p) * (1 - onehot)
            alpha = 0.25 * onehot + 0.75 * (1 - onehot)
            focal = -alpha * (1 - pt) ** 2 * torch.log(pt.clamp(min=1e-8))
            norm = torch.clamp(nv, min=1)
            lc.append(focal.sum() / norm)
            a_sel = anchors[pos_anchor]
            tgt = self._encode(gt, a_sel)
            sl1 = _smooth_l1((reg_p[pos_anchor] - tgt).abs())
            lr.append((sl1.sum(-1) * valid).sum() / norm)
            dir_tgt = (gt[:, 6] > 0).long()
            ce = -F.log_softmax(dir_l[pos_anchor], -1)[torch.arange(
                g, device=gt.device), dir_tgt]
            ld.append((ce * valid).sum() / norm)
        return dict(loss_cls=torch.stack(lc).mean(),
                    loss_bbox=torch.stack(lr).mean(),
                    loss_dir=torch.stack(ld).mean())

    def get_bboxes(self, preds, *, max_num: int = 300):
        """-> dict(bboxes [bs, k, 9] (cx cy cz w l h yaw vx vy), scores,
        labels, valid), the k = min(max_num, N x K) best (anchor, class)
        scores."""
        cls_logits, reg_preds, _, (h, w) = preds
        anchors = self.anchors(h, w, cls_logits.device).reshape(-1, 7)
        bs = cls_logits.shape[0]
        scores = torch.sigmoid(cls_logits.float()).reshape(bs, -1)
        k = min(max_num, scores.shape[1])
        idx = stable_topk(scores, k)
        top = torch.gather(scores, 1, idx)
        labels = idx % self.num_classes
        aidx = idx // self.num_classes
        a = anchors[aidx]
        r = torch.gather(reg_preds.float(), 1,
                         aidx[..., None].expand(bs, k, 9))
        diag = torch.sqrt(a[..., 3] ** 2 + a[..., 4] ** 2)[..., None]
        xyz = a[..., :3] + r[..., :3] * diag
        lwh = a[..., 3:6] * torch.exp(r[..., 3:6])
        yaw = a[..., 6:7] + r[..., 6:7]
        boxes = torch.cat([xyz, lwh[..., [1, 0, 2]], yaw, r[..., 7:9]], -1)
        return dict(bboxes=boxes, scores=top, labels=labels,
                    valid=torch.ones_like(top, dtype=torch.bool))


class BEVHead(nn.Module):
    """BEV encoder + dense 3D head (reference bev_head.py:28-116)."""

    def __init__(self, embed_dims: int = 256, bev_h: int = 200,
                 bev_w: int = 200,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2,
                                              3.0),
                 num_cams: int = 6, num_classes: int = 10,
                 encoder_num_layers: int = 6, dtype=None, device=None):
        super().__init__()
        self.embed_dims, self.bev_h, self.bev_w = embed_dims, bev_h, bev_w
        self.transformer = BEVEncoderHead(
            embed_dims=embed_dims, bev_h=bev_h, bev_w=bev_w,
            pc_range=pc_range, num_cams=num_cams, latent_render_lids=(),
            latent_render_cfg=None, encoder_num_layers=encoder_num_layers,
            dtype=dtype, device=device)
        self.pts_bbox_head_3d = Anchor3DHead(
            num_classes=num_classes, embed_dims=embed_dims,
            pc_range=pc_range, dtype=dtype, device=device)

    def forward(self, mlvl_feats, can_bus, lidar2img, img_hw, *,
                prev_bev=None, only_bev: bool = False):
        """mlvl_feats: list of [bs, cams, h, w, C]; can_bus [bs, 18];
        lidar2img [bs, cams, 4, 4]; ``prev_bev`` [bs, H*W, C] or None ->
        the BEV [bs, H*W, C] (``only_bev``) or dict(pred=the head's
        outputs, bev_embed=the BEV). Dropout follows ``train()``."""
        bs = mlvl_feats[0].shape[0]
        dev = mlvl_feats[0].device
        exists = torch.full((bs,), prev_bev is not None, device=dev)
        if prev_bev is None:
            prev_bev = torch.zeros(bs, self.bev_h * self.bev_w,
                                   self.embed_dims, device=dev)
        bev = self.transformer(mlvl_feats, can_bus,
                               torch.zeros(bs, 2, device=dev),
                               torch.zeros(bs, device=dev), lidar2img,
                               img_hw, prev_bev, exists)
        if only_bev:
            return bev
        bev_map = bev.reshape(bs, self.bev_h, self.bev_w, -1)
        return dict(pred=self.pts_bbox_head_3d(bev_map), bev_embed=bev)

    def loss(self, ret, gt_bboxes, gt_labels, num_valid_gt):
        return self.pts_bbox_head_3d.loss(ret['pred'], gt_bboxes, gt_labels,
                                          num_valid_gt)

    def get_bboxes(self, ret):
        return self.pts_bbox_head_3d.get_bboxes(ret['pred'])
