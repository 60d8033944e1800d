"""DETR decoder and detection head of the fine-tune (port of
vidar_tpu/models/detection.py:31-274): ``BEVFormerHead`` runs 900 object
queries through six ``DecoderLayer``s (multi-head self-attention, then
one-level deformable cross-attention into the BEV map: K1 on the card, K5
in its backward) with iterative box refinement, and owns the
Hungarian-matched focal + L1 loss and the NMS-free decode.

GT boxes arrive padded to a static maximum with a count of valid ones.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn

from ..core import bbox as bbox_core
from ..parallel.mesh import global_sum
from .attention import PredictionMSDeformableAttention
from .layers import (DROPOUT, FFN, Dense, LayerNorm,
                     MultiHeadDotProductAttention, TorchLinear)


# the head of the released fine-tune config (vidar_tpu/models/detection.py:
# 72-88): 6 decoder layers with box refinement, 2 hidden layers per branch,
# 10 box codes, the loss and decode settings
NUM_DECODER_LAYERS = 6
NUM_REG_FCS = 2
CODE_SIZE = 10
CODE_WEIGHTS = (1, 1, 1, 1, 1, 1, 1, 1, 0.2, 0.2)
CLS_LOSS_WEIGHT = 2.0
BBOX_LOSS_WEIGHT = 0.25
MAX_NUM = 300


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


class DecoderLayer(nn.Module):
    """self_attn (MHA) -> norm -> cross_attn (deformable) -> norm -> ffn ->
    norm; the dropouts act under ``train()`` only."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 feedforward_channels: int = 512, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.self_attn = MultiHeadDotProductAttention(embed_dims, num_heads,
                                                      **kw)
        self.drop = nn.Dropout(DROPOUT)
        self.norms_0 = LayerNorm(embed_dims, device)
        self.cross_attn = PredictionMSDeformableAttention(
            embed_dims=embed_dims, num_levels=1, num_points=4, **kw)
        self.norms_1 = LayerNorm(embed_dims, device)
        self.ffns_0 = FFN(feedforward_channels, embed_dims, **kw)
        self.norms_2 = LayerNorm(embed_dims, device)

    def forward(self, query, query_pos, bev_value, reference_points,
                bev_h: int, bev_w: int):
        """query/query_pos [bs, Q, C], bev_value [bs, H*W, C],
        reference_points [bs, Q, 2] in [0, 1]."""
        q = query + query_pos
        attn_out = self.drop(self.self_attn(q, q, query))
        query = self.norms_0(query + attn_out)
        query = self.cross_attn(query, bev_value, reference_points[:, :, None],
                                ((bev_h, bev_w),), query_pos=query_pos)
        query = self.norms_1(query)
        return self.norms_2(self.ffns_0(query))


class BEVFormerHead(nn.Module):
    """DETR-style 3D detection head over the BEV features."""

    def __init__(self, num_classes: int = 10, num_query: int = 900,
                 embed_dims: int = 256, bev_h: int = 200, bev_w: int = 200,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2,
                                              3.0),
                 dtype=None, device=None):
        super().__init__()
        self.num_classes, self.num_query = num_classes, num_query
        self.bev_h, self.bev_w = bev_h, bev_w
        self.pc_range = tuple(pc_range)
        kw = dict(dtype=dtype, device=device)
        self.query_embedding = nn.Parameter(torch.empty(
            num_query, embed_dims * 2, device=device))
        self.reference_points = Dense(embed_dims, 3, **kw)
        for i in range(NUM_DECODER_LAYERS):
            self.add_module(f'layers_{i}', DecoderLayer(
                embed_dims=embed_dims, feedforward_channels=embed_dims * 2,
                **kw))
        for lid in range(NUM_DECODER_LAYERS):
            for i in range(NUM_REG_FCS):
                self.add_module(f'cls_branches_{lid}_fc{i}', TorchLinear(
                    embed_dims, embed_dims, **kw))
                self.add_module(f'cls_branches_{lid}_ln{i}',
                                LayerNorm(embed_dims, device))
            self.add_module(f'cls_branches_{lid}_out', TorchLinear(
                embed_dims, num_classes, **kw))
            for i in range(NUM_REG_FCS):
                self.add_module(f'reg_branches_{lid}_fc{i}', TorchLinear(
                    embed_dims, embed_dims, **kw))
            self.add_module(f'reg_branches_{lid}_out', TorchLinear(
                embed_dims, CODE_SIZE, **kw))

    def _cls(self, lid, x):
        for i in range(NUM_REG_FCS):
            x = torch.relu(getattr(self, f'cls_branches_{lid}_ln{i}')(
                getattr(self, f'cls_branches_{lid}_fc{i}')(x)))
        return getattr(self, f'cls_branches_{lid}_out')(x)

    def _reg(self, lid, x):
        for i in range(NUM_REG_FCS):
            x = torch.relu(getattr(self, f'reg_branches_{lid}_fc{i}')(x))
        return getattr(self, f'reg_branches_{lid}_out')(x)

    def forward(self, bev_embed: torch.Tensor, query_embeds=None,
                ref_points=None) -> Dict[str, torch.Tensor]:
        """bev_embed [bs, H*W, C] -> dict(all_cls_scores [layers, bs, Q,
        classes], all_bbox_preds [layers, bs, Q, 10], bev_embed,
        query_feats [bs, Q, C], last_ref_points [bs, Q, 3]).
        ``query_embeds`` [bs, Q, 2C] (UniAD's track queries) replace the
        learned queries, and ``ref_points`` [bs, Q, 3] (sigmoid space) the
        reference points derived from them, where given."""
        bs = bev_embed.shape[0]
        if query_embeds is None:
            query_embeds = self.query_embedding[None].expand(
                bs, *self.query_embedding.shape)
        query_pos, query = torch.split(query_embeds.to(bev_embed.dtype),
                                       query_embeds.shape[-1] // 2, dim=-1)
        ref = (torch.sigmoid(self.reference_points(query_pos))
               if ref_points is None else ref_points)         # [bs, Q, 3]
        pc = self.pc_range
        cls_out, bbox_out = [], []
        for lid in range(NUM_DECODER_LAYERS):
            query = getattr(self, f'layers_{lid}')(
                query, query_pos, bev_embed, ref[..., :2], self.bev_h,
                self.bev_w)
            cls_out.append(self._cls(lid, query))
            tmp = self._reg(lid, query)
            inv = inverse_sigmoid(ref)
            xy = torch.sigmoid(tmp[..., 0:2] + inv[..., 0:2])
            z = torch.sigmoid(tmp[..., 4:5] + inv[..., 2:3])
            bbox_out.append(torch.cat([
                xy[..., 0:1] * (pc[3] - pc[0]) + pc[0],
                xy[..., 1:2] * (pc[4] - pc[1]) + pc[1],
                tmp[..., 2:4],
                z * (pc[5] - pc[2]) + pc[2],
                tmp[..., 5:],
            ], -1))
            ref = torch.cat([xy, z], -1).detach()       # box refinement
        return dict(all_cls_scores=torch.stack(cls_out),
                    all_bbox_preds=torch.stack(bbox_out),
                    bev_embed=bev_embed, query_feats=query,
                    last_ref_points=ref)

    # ----------------------------------------------------------------- loss

    def loss(self, preds, gt_bboxes, gt_labels, num_valid_gt):
        """Hungarian-matched focal + L1 loss of every decoder layer.
        gt_bboxes [bs, G, 9] (cx cy cz w l h rot vx vy), padded; gt_labels
        [bs, G] int; num_valid_gt [bs] int."""
        all_cls = preds['all_cls_scores']
        all_box = preds['all_bbox_preds']
        last = all_cls.shape[0] - 1
        losses = {}
        for lid in range(all_cls.shape[0]):
            lc, lb = self._loss_single(all_cls[lid], all_box[lid], gt_bboxes,
                                       gt_labels, num_valid_gt)
            prefix = '' if lid == last else f'd{lid}.'
            losses[f'{prefix}loss_cls'] = lc
            losses[f'{prefix}loss_bbox'] = lb
        return losses

    @torch.no_grad()
    def assign(self, cls_scores, bbox_preds, gt_norm, gt_labels,
               num_valid_gt) -> torch.Tensor:
        """Per sample, the Hungarian match of queries to the valid GT boxes
        under the focal + L1 cost -> [bs, Q] gt index, -1 where none. No
        gradient flows through the match (bbox.py:155-157)."""
        g = gt_norm.shape[1]
        out = []
        for i in range(cls_scores.shape[0]):
            cost = (bbox_core.focal_loss_cost(cls_scores[i], gt_labels[i],
                                              weight=CLS_LOSS_WEIGHT) +
                    bbox_core.bbox3d_l1_cost(bbox_preds[i], gt_norm[i],
                                             weight=BBOX_LOSS_WEIGHT))
            pad = torch.arange(g, device=cost.device) >= num_valid_gt[i]
            cost = cost.masked_fill(pad[None, :], 1e8)
            out.append(bbox_core.hungarian_assign(cost, num_valid_gt[i]))
        return torch.stack(out)

    def _loss_single(self, cls_scores, bbox_preds, gt_bboxes, gt_labels,
                     num_valid_gt):
        g = gt_bboxes.shape[1]
        gt_norm = bbox_core.normalize_bbox(gt_bboxes)          # [bs, G, 10]
        assigned = self.assign(cls_scores, bbox_preds, gt_norm, gt_labels,
                               num_valid_gt)
        pos = assigned >= 0
        a_safe = assigned.clamp(0, g - 1)
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, a_safe),
                             torch.full_like(a_safe, self.num_classes))
        targets = torch.gather(gt_norm, 1, a_safe[..., None].expand(
            -1, -1, gt_norm.shape[-1]))
        # matched queries of the global batch (every rank's), then clamped
        num_pos = global_sum(pos.sum().float()).clamp(min=1.0)
        cls_l = bbox_core.sigmoid_focal_loss(cls_scores, labels,
                                             self.num_classes).sum()
        cls_l = cls_l * CLS_LOSS_WEIGHT / num_pos
        cw = torch.tensor(CODE_WEIGHTS, dtype=bbox_preds.dtype,
                          device=bbox_preds.device)
        isfin = (torch.isfinite(targets).all(-1) & pos)[..., None]
        # the reference takes the finite matched targets by index (its
        # loss_bbox(bbox_preds[isnotnan], ...)); a padding box, which
        # normalises to -inf, must not reach the product with the mask: its
        # NaN would zero the whole batch's loss, every sample's
        targets = torch.where(isfin, targets, torch.zeros_like(targets))
        l1 = ((bbox_preds - targets).abs() * cw * isfin.to(cw.dtype)).sum()
        bbox_l = l1 * BBOX_LOSS_WEIGHT / num_pos
        return torch.nan_to_num(cls_l), torch.nan_to_num(bbox_l)

    def get_bboxes(self, preds):
        """Per-sample NMS-free decode of the last layer -> dict of [bs, K,
        ...] tensors (bboxes, scores, labels, valid)."""
        per = [bbox_core.nms_free_decode(c, b, max_num=MAX_NUM,
                                         num_classes=self.num_classes)
            for c, b in zip(preds['all_cls_scores'][-1],
                            preds['all_bbox_preds'][-1])]
        return {k: torch.stack([d[k] for d in per]) for k in per[0]}


class BEVFormerHeadGroupDETR(BEVFormerHead):
    """Group-DETR variant (vidar_tpu/models/detection.py:277-301, reference
    bevformer_head.py:513+ BEVFormerHead_GroupDETR, registered but unused by
    the released configs): ``group_detr`` groups of ``num_query //
    group_detr`` queries share the decoder; at train time each group is
    matched to the GT on its own (one-to-many) and the loss is the mean
    over the groups; inference decodes the first group only."""

    def __init__(self, *args, group_detr: int = 1, **kwargs):
        super().__init__(*args, **kwargs)
        self.group_detr = group_detr

    def _group(self, preds, gi):
        per = self.num_query // max(self.group_detr, 1)
        sl = slice(gi * per, (gi + 1) * per)
        return dict(all_cls_scores=preds['all_cls_scores'][:, :, sl],
                    all_bbox_preds=preds['all_bbox_preds'][:, :, sl])

    def loss(self, preds, gt_bboxes, gt_labels, num_valid_gt):
        g = self.group_detr
        losses = {}
        for gi in range(g):
            for k, v in super().loss(self._group(preds, gi), gt_bboxes,
                                     gt_labels, num_valid_gt).items():
                losses[k] = losses.get(k, 0.0) + v / g
        return losses

    def get_bboxes(self, preds):
        return super().get_bboxes(self._group(preds, 0))
